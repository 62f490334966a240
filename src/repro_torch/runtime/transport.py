"""Measured message transport for the party-sliced runtime
(``repro/runtime/transport.py``).

``Transport`` is the wire interface: point-to-point ``send`` / ``recv``
plus a ``round`` scope marking one synchronous communication step.
``MeasuredTransport`` keeps the accounting -- per-link / per-phase bits,
messages per link, round counting, tamper rules -- and delegates message
movement to ``_put`` / ``_get``; ``LocalTransport`` is the in-memory
backend, ``runtime.net.SocketTransport`` the TCP one, which flushes its
coalesced sends in ``_round_flush`` when the outermost round scope of a
phase closes.

Accounting conventions (the paper's amortized lemmas):

  * a payload is ``count * nbits`` bits -- boolean shares carry sub-word
    payloads, so nbits is explicit;
  * hash copies are tallied at 0 bits but carry the sender's copy, so a
    receiver can recompute-and-compare -- how tampering flips the abort
    flag;
  * nested ``round`` scopes of one phase merge into the outermost; a round
    that moves no bits counts zero rounds;
  * ``parallel`` / ``branch`` scopes make sibling branches' rounds take the
    max, not the sum.  Bits always sum.

Payloads are torch tensors of ring words; a ``TamperRule`` adds ``delta``
mod 2^ell (or XORs it) into matching payloads in flight.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from collections import defaultdict, deque

from ..core.ring import signed, width_of
from ..obs import RECV_SPAN_MIN_S, get_registry, get_tracer

PHASES = ("offline", "online")


class PhaseViolation(RuntimeError):
    """A message was sent in a phase the transport forbids."""


def _count(payload) -> int:
    shape = getattr(payload, "shape", ())
    return int(math.prod(shape)) if shape else 1


@dataclasses.dataclass
class TamperRule:
    """Corrupt payloads of messages matching (src, dst, tag substring)."""

    src: int | None = None
    dst: int | None = None
    tag: str | None = None
    delta: int = 1
    xor: bool = False
    count: int = 1          # how many matching messages to corrupt
    hit: int = 0

    def matches(self, src: int, dst: int, tag: str) -> bool:
        if self.hit >= self.count:
            return False
        if self.src is not None and src != self.src:
            return False
        if self.dst is not None and dst != self.dst:
            return False
        if self.tag is not None and self.tag not in tag:
            return False
        return True


class RoundFrames:
    """Per-phase additive accounting with parallel (max) / branch (sum)
    frames.  ``total`` maps phase -> accumulated quantity (int rounds for
    the transports, float seconds for the network model)."""

    def __init__(self):
        self.total = {p: 0 for p in PHASES}
        self._stack: list[dict] = []

    def add(self, phase: str, amount) -> None:
        frame = self._capturing_frame(phase)
        if frame is None:
            self.total[phase] += amount
        elif frame["mode"] == "seq":
            frame[phase] += amount
        else:
            frame[phase] = max(frame[phase], amount)

    def _capturing_frame(self, phase):
        for frame in reversed(self._stack):
            if phase in frame["phases"]:
                return frame
        return None

    @contextlib.contextmanager
    def parallel(self, phases=PHASES):
        frame = {"offline": 0, "online": 0, "phases": tuple(phases),
                 "mode": "par"}
        self._stack.append(frame)
        try:
            yield
        finally:
            self._stack.pop()
            self._fold_out(frame)

    @contextlib.contextmanager
    def branch(self):
        frame = {"offline": 0, "online": 0, "phases": PHASES, "mode": "seq"}
        self._stack.append(frame)
        try:
            yield
        finally:
            self._stack.pop()
            self._fold_out(frame)

    def _fold_out(self, frame):
        for phase in PHASES:
            if frame[phase]:
                self.add(phase, frame[phase])


class Transport:
    """Wire interface the party-local protocols are written against."""

    def send(self, src: int, dst: int, payload, *, tag: str, nbits: int,
             phase: str) -> None:
        raise NotImplementedError

    def recv(self, dst: int, src: int, *, tag: str):
        raise NotImplementedError

    def round(self, phase: str):
        """Context manager scoping one synchronous communication round."""
        raise NotImplementedError

    def parallel(self, phases=PHASES):
        """Scope in which sibling branches' rounds overlap (max)."""
        raise NotImplementedError

    def branch(self):
        """One concurrently-running branch of an enclosing parallel()."""
        raise NotImplementedError


class MeasuredTransport(Transport):
    """Exact per-link, per-phase accounting; subclasses implement ``_put``
    and ``_get``."""

    def __init__(self):
        self._frames = RoundFrames()
        # (src, dst) -> phase -> bits
        self.link_bits: dict[tuple, dict] = defaultdict(
            lambda: {p: 0 for p in PHASES})
        self.link_msgs: dict[tuple, int] = defaultdict(int)
        self.rounds = self._frames.total
        self.phase_bits = {p: 0 for p in PHASES}
        self._round_depth = {p: 0 for p in PHASES}
        self._round_traffic = {p: False for p in PHASES}
        self._round_index = {p: 0 for p in PHASES}
        self._tampers: list[TamperRule] = []
        self._forbidden: set[str] = set()
        self.tracer = get_tracer()
        # the registry double-books the wire: trident_wire_bits_total equals
        # per_link(); counters are cached per label set for the hot path
        self.metrics = get_registry()
        self._m_bits: dict = {}
        self._m_msgs: dict = {}
        self._m_rounds: dict = {}
        self._m_recv_wait = self.metrics.counter(
            "trident_wire_recv_wait_us_total",
            "total wall-clock blocked in recv (us)")
        self._m_slow_recv = self.metrics.counter(
            "trident_wire_slow_recvs_total",
            f"receives that blocked >= {RECV_SPAN_MIN_S * 1e3:g} ms")

    # -- measurement -------------------------------------------------------
    def bits(self, phase: str | None = None) -> int:
        if phase is None:
            return sum(self.phase_bits.values())
        return self.phase_bits[phase]

    def per_link(self) -> dict:
        """{(src, dst): {"offline": bits, "online": bits}} for active links."""
        return {k: dict(v) for k, v in sorted(self.link_bits.items())}

    def totals(self) -> dict:
        """{phase: {"rounds": r, "bits": b}}."""
        return {p: {"rounds": self.rounds[p], "bits": self.phase_bits[p]}
                for p in PHASES}

    # -- phase policing ----------------------------------------------------
    def forbid_phase(self, phase: str) -> None:
        """Make any later ``send`` in `phase` raise ``PhaseViolation``."""
        if phase not in PHASES:
            raise ValueError(phase)
        self._forbidden.add(phase)

    def allow_phase(self, phase: str) -> None:
        self._forbidden.discard(phase)

    # -- fault injection ---------------------------------------------------
    def tamper(self, *, src: int | None = None, dst: int | None = None,
               tag: str | None = None, delta: int = 1, xor: bool = False,
               count: int = 1) -> TamperRule:
        rule = TamperRule(src=src, dst=dst, tag=tag, delta=delta, xor=xor,
                          count=count)
        self._tampers.append(rule)
        return rule

    def _apply_tamper(self, src, dst, tag, payload):
        for rule in self._tampers:
            if rule.matches(src, dst, tag):
                rule.hit += 1
                delta = signed(rule.delta, width_of(payload.dtype))
                payload = payload ^ delta if rule.xor else payload + delta
        return payload

    # -- wire --------------------------------------------------------------
    @contextlib.contextmanager
    def round(self, phase: str):
        if phase not in PHASES:
            raise ValueError(phase)
        if self._round_depth[phase] == 0:
            self._round_traffic[phase] = False
        self._round_depth[phase] += 1
        try:
            yield self
        finally:
            self._round_depth[phase] -= 1
            if self._round_depth[phase] == 0:
                if self._round_traffic[phase]:
                    self._frames.add(phase, 1)
                    self._round_index[phase] += 1
                    c = self._m_rounds.get(phase)
                    if c is None:
                        c = self._m_rounds[phase] = self.metrics.counter(
                            "trident_wire_round_scopes_total",
                            "traffic-bearing outermost round scopes "
                            "(parallel-overlapped scopes each count, so "
                            ">= the analytic round tally)", phase=phase)
                    c.inc()
                self._round_flush(phase)

    def parallel(self, phases=PHASES):
        return self._frames.parallel(phases)

    def branch(self):
        return self._frames.branch()

    def send(self, src: int, dst: int, payload, *, tag: str, nbits: int,
             phase: str) -> None:
        if src == dst:
            raise ValueError(f"self-send {src} ({tag})")
        if phase in self._forbidden:
            raise PhaseViolation(
                f"{phase} send P{src}->P{dst} ({tag}) on a transport that "
                f"forbids {phase}-phase traffic")
        if self._round_depth[phase] == 0:
            raise RuntimeError(f"send outside a {phase} round scope ({tag})")
        bits = nbits * _count(payload)
        if bits:
            self._round_traffic[phase] = True
            self.phase_bits[phase] += bits
            self.link_bits[(src, dst)][phase] += bits
            c = self._m_bits.get((src, dst, phase))
            if c is None:
                c = self._m_bits[(src, dst, phase)] = self.metrics.counter(
                    "trident_wire_bits_total",
                    "measured wire bits (== per_link() exactly)",
                    src=src, dst=dst, phase=phase)
            c.inc(bits)
        self.link_msgs[(src, dst)] += 1
        c = self._m_msgs.get((src, dst))
        if c is None:
            c = self._m_msgs[(src, dst)] = self.metrics.counter(
                "trident_wire_msgs_total",
                "messages sent (zero-bit hash copies included)",
                src=src, dst=dst)
        c.inc()
        if self.tracer.enabled:
            self.tracer.wire_send(src, dst, tag, bits, phase,
                                  self._round_index[phase])
        self._put(src, dst, tag, self._apply_tamper(src, dst, tag, payload))

    def recv(self, dst: int, src: int, *, tag: str):
        t0 = time.perf_counter()
        payload = self._get(dst, src, tag)
        dt = time.perf_counter() - t0
        self._m_recv_wait.inc(dt * 1e6)
        if dt >= RECV_SPAN_MIN_S:
            self._m_slow_recv.inc()
        return payload

    # -- backend hooks -----------------------------------------------------
    def _put(self, src: int, dst: int, tag: str, payload) -> None:
        raise NotImplementedError

    def _get(self, dst: int, src: int, tag: str):
        raise NotImplementedError

    def _round_flush(self, phase: str) -> None:
        """Called when the outermost round scope of `phase` closes; a
        backend that coalesces outgoing messages flushes here."""


class LocalTransport(MeasuredTransport):
    """In-memory transport: all four parties lock-step in one process."""

    def __init__(self):
        super().__init__()
        self._queues: dict[tuple, deque] = defaultdict(deque)

    def _put(self, src: int, dst: int, tag: str, payload) -> None:
        self._queues[(src, dst, tag)].append(payload)

    def _get(self, dst: int, src: int, tag: str):
        q = self._queues[(src, dst, tag)]
        if not q:
            raise RuntimeError(f"recv on empty link P{src}->P{dst} ({tag})")
        return q.popleft()
