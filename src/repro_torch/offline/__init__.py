"""The offline preprocessing subsystem (``repro/offline``): prep-ahead
dealer, serialized PrepStore, online-only executor and offline/online
pipelining.

    dealer  -> PrepStore -> online-only executor
    (deal)     (disk)       (zero offline bits, bit-identical outputs)

  * ``store``    -- PrepStore/PrepBank: per-party, tag-keyed, use-once
                    material, saved in the JAX package's format; and the
                    DealPrep/OnlinePrep engines behind
                    ``FourPartyRuntime(prep=...)``;
  * ``dealer``   -- ``deal(program)`` runs a program's offline half ahead
                    of time (zero online bits asserted);
  * ``executor`` -- ``run_online(program, store)`` runs the online half
                    alone, with the transport forbidding offline traffic;
  * ``workload`` -- declared counts and shapes -> a canonical program;
  * ``pipeline`` -- a background dealer streaming sessions into a bounded
                    queue while the online consumer drains them;
  * ``continuous`` -- a background dealer refilling a PrepBank a window
                    ahead of a training run (session k = step k's prep);
  * ``live``     -- a dealer process streaming sessions into the running
                    daemons of a ``runtime.net.PartyCluster``.

Quick tour (on the card; pass ``device="cpu"`` on the CPU):

    from repro_torch.offline import PrepStore, Workload, deal, run_online

    wl = Workload().matmul_tr((8, 32), (32, 16)).relu((8, 16))
    store, drep = deal(wl.program(), seed=7)     # offline, ahead of time
    store.save("prep/")                          # per-party npz + manifest
    _, orep = run_online(wl.program(),           # later / elsewhere:
                         PrepStore.load("prep/"))   # 0 offline bits

The modules that import the runtime load lazily, as in the JAX package.
"""
from .store import (DealPrep, OnlinePrep, PrepBank, PrepError,
                    PrepKindError, PrepMissingError, PrepReplayError,
                    PrepStore)

_LAZY = {
    "deal": "dealer", "deal_sessions": "dealer", "DealReport": "dealer",
    "run_online": "executor", "online_runtime": "executor",
    "OnlineReport": "executor",
    "Workload": "workload", "OpSpec": "workload",
    "PrepPipeline": "pipeline",
    "ContinuousDealer": "continuous",
    "DealerDaemon": "live", "LivePrepBank": "live",
}

__all__ = [
    "ContinuousDealer", "DealPrep", "DealReport", "DealerDaemon",
    "LivePrepBank", "OnlinePrep",
    "OnlineReport", "OpSpec", "PrepBank", "PrepError", "PrepKindError",
    "PrepMissingError", "PrepPipeline", "PrepReplayError", "PrepStore",
    "Workload", "deal", "deal_sessions", "online_runtime", "run_online",
]


def __getattr__(name):
    if name in _LAZY:
        import importlib
        mod = importlib.import_module(f".{_LAZY[name]}", __name__)
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
