"""Communication-cost accounting (rounds / bits, per phase) of the joint
simulation: a copy of ``repro/core/costs.py``, which is pure Python, so the
port needs nothing of the JAX package.

The paper's central claims are *analytic* round/communication formulas
(Tables I, II, IX, X).  Every joint-simulation protocol tallies its cost
here as it runs (costs depend on shapes only, never on values), so one run
of a model yields the exact offline/online rounds and bits the real
4-server deployment would pay on the inter-party network.

Conventions (matching the paper's "amortized" lemmas):
  * hash / commitment exchanges are amortized away (a single hash across all
    instances) and tallied as 0 bits;
  * protocols running in parallel share rounds -- wrap them in
    ``tally.parallel()`` so round counts take the max instead of the sum.
"""
from __future__ import annotations

import contextlib
import dataclasses
from collections import defaultdict

PHASES = ("offline", "online")


@dataclasses.dataclass
class PhaseCost:
    rounds: int = 0
    bits: int = 0

    def as_dict(self):
        return {"rounds": self.rounds, "bits": self.bits}


class CostTally:
    """Accumulates rounds/bits per phase and per protocol name."""

    def __init__(self):
        self.offline = PhaseCost()
        self.online = PhaseCost()
        self.by_op: dict[str, dict] = defaultdict(
            lambda: {"calls": 0, "offline_rounds": 0, "offline_bits": 0,
                     "online_rounds": 0, "online_bits": 0})
        self._par_stack: list[dict] = []
        self._scale = 1

    # ------------------------------------------------------------------
    def add(self, op: str, phase: str, rounds: int = 0, bits: int = 0,
            calls: int = 1) -> None:
        assert phase in PHASES, phase
        bits *= self._scale
        rounds *= self._scale
        calls *= self._scale
        pc = getattr(self, phase)
        pc.bits += bits
        rec = self.by_op[op]
        rec["calls"] += calls
        rec[f"{phase}_rounds"] += rounds
        rec[f"{phase}_bits"] += bits
        frame = self._capturing_frame(phase)
        if frame is None:
            pc.rounds += rounds
        elif frame["mode"] == "seq":
            frame[phase] += rounds
        else:
            frame[phase] = max(frame[phase], rounds)

    def _capturing_frame(self, phase, below=None):
        """Nearest enclosing parallel frame that captures `phase`."""
        frames = self._par_stack if below is None else \
            self._par_stack[:self._par_stack.index(below)]
        for frame in reversed(frames):
            if phase in frame["phases"]:
                return frame
        return None

    @contextlib.contextmanager
    def scaled(self, factor: int):
        """Multiply tallies inside (e.g. a loop body run once but standing
        for `factor` iterations: sequential layers => rounds and bits
        scale)."""
        prev = self._scale
        self._scale = prev * factor
        try:
            yield
        finally:
            self._scale = prev

    @contextlib.contextmanager
    def parallel(self, phases=PHASES):
        """Protocols inside this scope share rounds (max, not sum) for the
        given phases.  ``phases=("offline",)`` models the offline phase's
        data-independence: all preprocessing exchanges of the enclosed
        protocols ship together while online rounds still sequence."""
        frame = {"offline": 0, "online": 0, "phases": tuple(phases),
                 "mode": "par"}
        self._par_stack.append(frame)
        try:
            yield
        finally:
            self._par_stack.pop()
            self._fold_out(frame)

    @contextlib.contextmanager
    def branch(self):
        """One branch of an enclosing ``parallel()``: rounds inside the
        branch SEQUENCE (add); the branch total is then max'd into the
        parallel frame.  Use one branch per concurrently-running
        sub-protocol whose internal round count exceeds one."""
        frame = {"offline": 0, "online": 0, "phases": PHASES, "mode": "seq"}
        self._par_stack.append(frame)
        try:
            yield
        finally:
            self._par_stack.pop()
            self._fold_out(frame)

    def _fold_out(self, frame):
        for phase in PHASES:
            if frame[phase]:
                parent = self._capturing_frame(phase)
                if parent is None:
                    getattr(self, phase).rounds += frame[phase]
                elif parent["mode"] == "seq":
                    parent[phase] += frame[phase]
                else:
                    parent[phase] = max(parent[phase], frame[phase])

    # ------------------------------------------------------------------
    def totals(self) -> dict:
        return {"offline": self.offline.as_dict(),
                "online": self.online.as_dict()}

    def summary(self) -> str:
        lines = [f"{'op':<18} {'calls':>7} {'off.rnd':>8} {'off.bits':>14} "
                 f"{'on.rnd':>7} {'on.bits':>14}"]
        for op, r in sorted(self.by_op.items()):
            lines.append(
                f"{op:<18} {r['calls']:>7} {r['offline_rounds']:>8} "
                f"{r['offline_bits']:>14} {r['online_rounds']:>7} "
                f"{r['online_bits']:>14}")
        t = self.totals()
        lines.append(
            f"{'TOTAL':<18} {'':>7} {t['offline']['rounds']:>8} "
            f"{t['offline']['bits']:>14} {t['online']['rounds']:>7} "
            f"{t['online']['bits']:>14}")
        return "\n".join(lines)


@dataclasses.dataclass(frozen=True)
class NetworkModel:
    """Latency model: time = rounds * rtt + bits / bandwidth.

    Presets follow the paper's benchmarking environment (Section VI-a).
    """
    name: str
    rtt_s: float          # round-trip time, seconds
    bandwidth_bps: float  # bits per second

    def seconds(self, rounds: int, bits: int) -> float:
        return rounds * self.rtt_s + bits / self.bandwidth_bps


# Paper environment: LAN 1 Gbps, rtt 0.296 ms; WAN 40 Mbps, worst-pair rtt
# 274.83 ms (P0-P1).  We use the worst pair as the synchronous-round rtt.
LAN = NetworkModel("LAN", rtt_s=0.296e-3, bandwidth_bps=1e9)
WAN = NetworkModel("WAN", rtt_s=274.83e-3, bandwidth_bps=40e6)
