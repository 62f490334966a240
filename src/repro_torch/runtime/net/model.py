"""Network model: impose per-link latency/bandwidth, report modeled time
(``repro/runtime/net/model.py``).

``NetModel`` describes the inter-party network as per-directed-link
``LinkSpec`` (round-trip latency + bandwidth), with uniform defaults and
optional per-link overrides (the paper's WAN tables report *heterogeneous*
pairwise rtts; the worst pair gates a synchronous round).

``NetModelTransport`` composes over a transport backend: it forwards
every Transport call to the inner backend -- measurement, queues, tamper
rules all stay with the backend -- and accumulates *modeled wall-clock*
per phase:

    t(round) = max over links active in the round of
                   rtt(link) + bits(link) / bandwidth(link)

i.e. a synchronous round completes when its slowest link has delivered.
Parallel/branch scopes take the max of their branches' modeled time,
mirroring the round accounting, so round-overlapped protocols (sigmoid's
twin BitExts) are not double-billed.  Modeled seconds are reported per
phase via ``seconds()`` -- on a WAN profile the rtt term dominates
(round-dominated cost, the paper's central deployment observation); on a
LAN profile bandwidth does.

Presets (paper Section VI benchmarking environment):

  * ``LAN``: ~0.2 ms rtt, 10 Gbps -- same-region datacenter links;
  * ``WAN``: ~72 ms rtt, 40 Mbps -- cross-continent links.
"""
from __future__ import annotations

import contextlib
import dataclasses
from collections import defaultdict

from ..transport import PHASES, RoundFrames, Transport, _count


@dataclasses.dataclass(frozen=True)
class LinkSpec:
    """One directed link: round-trip latency (s) and bandwidth (bit/s)."""

    rtt_s: float
    bandwidth_bps: float

    def seconds(self, bits: int) -> float:
        return self.rtt_s + bits / self.bandwidth_bps


@dataclasses.dataclass(frozen=True)
class NetModel:
    """Latency/bandwidth of the 4-party network, per directed link."""

    name: str
    default: LinkSpec
    overrides: tuple = ()        # ((src, dst), LinkSpec) pairs

    def link(self, src: int, dst: int) -> LinkSpec:
        for (s, d), spec in self.overrides:
            if (s, d) == (src, dst):
                return spec
        return self.default

    def round_seconds(self, link_bits: dict) -> float:
        """One synchronous round moving ``{(src, dst): bits}``: the round
        closes when the slowest link has delivered."""
        if not link_bits:
            return 0.0
        return max(self.link(s, d).seconds(bits)
                   for (s, d), bits in link_bits.items())

    def seconds_for(self, rounds: int, bits: int) -> float:
        """Coarse analytic estimate from aggregate (rounds, bits): every
        round pays the worst rtt; bits ride the default bandwidth."""
        worst = max([self.default.rtt_s] +
                    [spec.rtt_s for _, spec in self.overrides])
        return rounds * worst + bits / self.default.bandwidth_bps


# Paper benchmarking environment (Section VI): LAN ~0.2 ms rtt at 10 Gbps,
# WAN ~72 ms rtt at 40 Mbps.  (core/costs.py keeps the coarser aggregate
# NetworkModel used by the analytic tables; these presets drive the
# wire-level model.)
LAN = NetModel("lan", LinkSpec(rtt_s=0.2e-3, bandwidth_bps=10e9))
WAN = NetModel("wan", LinkSpec(rtt_s=72e-3, bandwidth_bps=40e6))


class NetModelTransport(Transport):
    """Impose a NetModel over an existing backend.

    All Transport behavior (delivery, measurement, tamper) is the inner
    backend's; this wrapper only tracks which links moved how many bits in
    each round and integrates the modeled clock.
    """

    def __init__(self, inner: Transport, model: NetModel):
        self.inner = inner
        self.model = model
        self._sec = RoundFrames()
        self._depth = {p: 0 for p in PHASES}
        self._round_links = {p: defaultdict(int) for p in PHASES}

    # -- modeled clock -----------------------------------------------------
    def seconds(self, phase: str | None = None) -> float:
        if phase is None:
            return sum(self._sec.total.values())
        return self._sec.total[phase]

    def report(self) -> dict:
        t = self.inner.totals()
        return {
            "model": self.model.name,
            "seconds": {p: self._sec.total[p] for p in PHASES},
            "measured": t,
        }

    # -- Transport interface (forwarding + clock) --------------------------
    @contextlib.contextmanager
    def round(self, phase: str):
        if self._depth[phase] == 0:
            self._round_links[phase].clear()
        self._depth[phase] += 1
        try:
            with self.inner.round(phase):
                yield self
        finally:
            self._depth[phase] -= 1
            if self._depth[phase] == 0 and self._round_links[phase]:
                modeled = self.model.round_seconds(self._round_links[phase])
                self._sec.add(phase, modeled)
                tracer = getattr(self.inner, "tracer", None)
                if tracer is not None and tracer.enabled:
                    # the modeled twin of the measured wire.round span
                    tracer.instant(f"model.round[{phase}]", "net.model",
                                   phase=phase, model=self.model.name,
                                   modeled_ms=modeled * 1e3)

    @contextlib.contextmanager
    def parallel(self, phases=PHASES):
        with contextlib.ExitStack() as stack:
            stack.enter_context(self.inner.parallel(phases))
            stack.enter_context(self._sec.parallel(phases))
            yield

    @contextlib.contextmanager
    def branch(self):
        with contextlib.ExitStack() as stack:
            stack.enter_context(self.inner.branch())
            stack.enter_context(self._sec.branch())
            yield

    def send(self, src: int, dst: int, payload, *, tag: str, nbits: int,
             phase: str) -> None:
        self.inner.send(src, dst, payload, tag=tag, nbits=nbits, phase=phase)
        bits = nbits * _count(payload)
        if bits:
            self._round_links[phase][(src, dst)] += bits

    def recv(self, dst: int, src: int, *, tag: str):
        return self.inner.recv(dst, src, tag=tag)

    # Measurement API (totals, per_link, tamper, ...) passes through.
    def __getattr__(self, name):
        return getattr(self.inner, name)
