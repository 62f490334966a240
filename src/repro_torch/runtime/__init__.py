"""Party-sliced 4PC runtime (``repro/runtime``): four Party instances, a
measured Transport, and party-local protocol implementations on torch
tensors.

    from repro_torch.core.ring import RING64
    from repro_torch.runtime import FourPartyRuntime, protocols as RT

    rt = FourPartyRuntime(RING64, seed=0)          # CUDA; device="cpu" too
    xs = RT.share(rt, rt.encode([1.5, -2.0]))
    zs = RT.mult_tr(rt, xs, xs)
    opened = RT.reconstruct(rt, zs)          # {party: ring words}
    rt.transport.totals()                    # measured rounds/bits per phase
    rt.abort_flag()                          # OR of the parties' ledgers
"""
from . import protocols
from .party import (DistAShare, DistBShare, Party, PartyAView, PartyBView,
                    PartyKeys)
from .runtime import FourPartyRuntime, InlinePrep, make_runtime
from .transport import (LocalTransport, MeasuredTransport, PhaseViolation,
                        TamperRule, Transport)
from . import boolean       # noqa: E402  (after party/runtime; cycle-free)
from . import conversions   # noqa: E402
from . import activations   # noqa: E402

__all__ = [
    "DistAShare", "DistBShare", "FourPartyRuntime", "InlinePrep",
    "LocalTransport", "MeasuredTransport", "Party", "PartyAView",
    "PartyBView", "PartyKeys", "PhaseViolation", "TamperRule", "Transport",
    "activations", "boolean", "conversions", "make_runtime", "protocols",
]
