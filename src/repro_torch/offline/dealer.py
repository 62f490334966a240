"""The prep-ahead dealer (``repro/offline/dealer.py``): run a protocol
program's offline half ahead of time and record the per-party
preprocessing in a PrepStore.

``deal(program)`` runs ``program(rt)`` on a runtime in deal mode
(``DealPrep``): every protocol runs its offline half for real -- PRF draws
in the counter order of the inline path, offline messages moving (and
measured) on the dealer's transport -- records its material under its tag
and skips its online half, so only lambda-level data flows between
protocols.  The program therefore needs input shapes, not values: pass
zeros.

The dealer asserts the dual of the online-only contract: a deal pass moves
zero online bits.  Offline-phase checks (the truncation-pair relation, the
Bit2A/B2A/BitInj verifications, the aSh hash exchanges) run at deal time,
and an abort raises: a corrupted dealer is caught before a store is
served.  The store's tensors stay on the dealer runtime's device; on the
card the store carries the event its consumer waits on.
"""
from __future__ import annotations

import dataclasses
import time

from ..core.ring import RING64, Ring
from ..obs import get_tracer
from .store import DealPrep, PrepBank, PrepError, PrepStore


@dataclasses.dataclass
class DealReport:
    """What one dealer pass produced and moved (per-pass deltas)."""

    entries: int
    offline_rounds: int
    offline_bits: int
    wall_s: float
    abort: bool
    summary: dict


def deal(program, *, ring: Ring = RING64, seed: int = 0, transport=None,
         store: PrepStore | None = None, meta: dict | None = None,
         device=None, runtime_kwargs: dict | None = None):
    """Run ``program(rt)`` in deal mode; returns (PrepStore, DealReport).

    ``seed`` must be the seed the inline twin would use: it IS the
    preprocessing.  The runtime runs on `device` (CUDA unless the caller
    asks for the CPU).  ``wall_s`` includes the device work: the abort
    read at the end waits for the dealer's stream."""
    from ..runtime import FourPartyRuntime, LocalTransport

    if store is None:
        store = PrepStore(meta={"ring_ell": ring.ell, "seed": seed,
                                **(meta or {})})
    tp = transport if transport is not None else LocalTransport()
    rt = FourPartyRuntime(ring, seed=seed, transport=tp,
                          prep=DealPrep(store), device=device,
                          **(runtime_kwargs or {}))
    entries_before = len(store)
    before = tp.totals()                 # transports may be reused
    t0 = time.perf_counter()
    program(rt)
    store.mark_ready(rt.device)
    aborted = rt.abort_flag()
    wall = time.perf_counter() - t0
    totals = tp.totals()
    online = {k: totals["online"][k] - before["online"][k]
              for k in totals["online"]}
    if online["bits"] or online["rounds"]:
        raise PrepError(
            f"dealer pass moved online traffic ({online}): the "
            "program is not data-independent, cannot prep ahead")
    if aborted:
        raise PrepError("dealer pass aborted: offline-phase consistency "
                        "checks failed")
    offline_bits = totals["offline"]["bits"] - before["offline"]["bits"]
    tracer = get_tracer()
    if tracer.enabled:
        tracer.raw_span("deal", "prep", t0, wall, seed=seed,
                        session=store.meta.get("session"),
                        entries=len(store) - entries_before,
                        offline_bits=offline_bits)
    return store, DealReport(
        entries=len(store) - entries_before,
        offline_rounds=totals["offline"]["rounds"]
        - before["offline"]["rounds"],
        offline_bits=offline_bits,
        wall_s=wall,
        abort=False,
        summary=store.summary(),
    )


def deal_sessions(programs, *, ring: Ring = RING64, base_seed: int = 0,
                  device=None, runtime_kwargs: dict | None = None,
                  meta: dict | None = None) -> tuple:
    """Deal one PrepStore per program in ``programs`` (seeds base_seed+k)
    into a PrepBank; returns (bank, [DealReport])."""
    bank = PrepBank()
    reports = []
    for k, program in enumerate(programs):
        store, rep = deal(program, ring=ring, seed=base_seed + k,
                          device=device, runtime_kwargs=runtime_kwargs,
                          meta={"session": k, **(meta or {})})
        bank.add(store)
        reports.append(rep)
    return bank, reports
