"""The online-only executor (``repro/offline/executor.py``): run a
protocol program against a PrepStore.

``run_online(program, store)`` runs ``program(rt)`` on a runtime in online
mode (``OnlinePrep``): every protocol pops its offline material from the
store by tag and runs only its online half.  Two guarantees are enforced,
not assumed:

  * the transport forbids the offline phase -- an offline send raises
    ``PhaseViolation``, so zero offline bits online is a wire-level rule;
  * the runtime refuses PRF draws -- every random word the online run uses
    came out of the store.

The opened words are bit-identical to the inline path's (same program,
same dealer seed): the dealer drew the same streams in the same counter
order the inline protocols would have.
"""
from __future__ import annotations

import dataclasses
import time

from ..core.ring import RING64, Ring
from .store import OnlinePrep, PrepError, PrepStore


@dataclasses.dataclass
class OnlineReport:
    """What one online-only pass moved (offline is zero by construction)."""

    online_rounds: int
    online_bits: int
    offline_bits: int               # asserted 0
    leftover_entries: int
    wall_s: float
    abort: bool


def online_runtime(store: PrepStore, *, ring: Ring = RING64, transport=None,
                   device=None, runtime_kwargs: dict | None = None):
    """A consume-mode FourPartyRuntime on `device` (CUDA unless the caller
    asks for the CPU) over `transport` (default: a fresh LocalTransport)
    with the offline phase forbidden on the wire; ``allow_phase`` it
    afterwards if the transport is shared with inline runs."""
    from ..runtime import FourPartyRuntime, LocalTransport
    from ..runtime.runtime import resolve_device

    device = resolve_device(device)
    tp = transport if transport is not None else LocalTransport()
    tp.forbid_phase("offline")
    return FourPartyRuntime(ring, seed=0, transport=tp,
                            prep=OnlinePrep(store, device), device=device,
                            **(runtime_kwargs or {}))


def run_online(program, store: PrepStore, *, ring: Ring = RING64,
               transport=None, device=None,
               runtime_kwargs: dict | None = None):
    """Run ``program(rt)`` online-only from `store`; returns (program
    result, OnlineReport).

    The program must consume the store exactly: leftover entries mean it
    diverged from the dealt workload, and raise PrepError.  ``wall_s``
    includes the device work: the abort read at the end waits for the
    consuming stream."""
    rt = online_runtime(store, ring=ring, transport=transport, device=device,
                        runtime_kwargs=runtime_kwargs)
    tp = rt.transport
    before = tp.totals()
    t0 = time.perf_counter()
    try:
        result = program(rt)
        aborted = rt.abort_flag()
    finally:
        tp.allow_phase("offline")
    wall = time.perf_counter() - t0
    totals = tp.totals()
    leftover = store.remaining()
    if leftover:
        raise PrepError(
            f"online program left {leftover} prep entries unconsumed "
            f"({store.summary()}): it diverged from the dealt workload")
    report = OnlineReport(
        online_rounds=totals["online"]["rounds"]
        - before["online"]["rounds"],
        online_bits=totals["online"]["bits"] - before["online"]["bits"],
        offline_bits=totals["offline"]["bits"] - before["offline"]["bits"],
        leftover_entries=leftover,
        wall_s=wall,
        abort=aborted,
    )
    if report.offline_bits:
        raise PrepError("the online-only run moved offline bits")
    return result, report
