"""Batched secure prediction on the joint simulation (the paper's Section
VI-B scenario; ``repro/serve/engine.py``).

Clients submit queries; the server groups them into batches (padding the
tail), runs the secure prediction on a fresh ``TridentContext`` per batch
(fresh PRF counters = fresh offline material, as deployed), and reports the
per-batch online latency / throughput under the paper's network models
(LAN 1 Gbps / 0.296 ms rtt, WAN 40 Mbps / worst-pair rtt) from the
``CostTally`` -- the accounting of the paper's Tables VII/VIII.

Example -- the paper's NN at full width, on the card::

    import numpy as np
    from repro_torch.configs.paper_models import NN
    from repro_torch.core.ring import RING64
    from repro_torch.serve.engine import PredictionServer
    from repro_torch.train.paper_ml import (MLPNet, mlp_net_init,
                                            mlp_net_predict_joint,
                                            params_from_numpy)

    net = MLPNet(NN["features"], NN["layers"])
    params = params_from_numpy(
        mlp_net_init(np.random.RandomState(0), net), RING64, "cuda")
    srv = PredictionServer(
        lambda ctx, X: mlp_net_predict_joint(ctx, params, net, X),
        batch_size=128)
    for x in np.random.RandomState(1).randn(256, 784):
        srv.submit(x)
    words = srv.flush()            # opened ring words, one row per query
    srv.report()                   # modeled LAN/WAN latency and throughput
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..core.context import make_context, resolve_device
from ..core.costs import LAN, WAN, NetworkModel
from ..core.ring import RING64
from ..obs import timed


@dataclasses.dataclass
class ServeStats:
    batches: int = 0
    queries: int = 0
    online_rounds: int = 0
    online_bits: int = 0
    offline_bits: int = 0
    compute_s: float = 0.0
    aborted: bool = False

    def latency(self, net: NetworkModel) -> float:
        """Online latency of one batch (rounds*rtt + bits/bw), amortized."""
        if self.batches == 0:
            return 0.0
        return net.seconds(self.online_rounds / self.batches,
                           self.online_bits / self.batches)

    def throughput(self, net: NetworkModel, threads: int = 32) -> float:
        """Queries/second: `threads` independent batch pipelines (the
        paper runs 32 threads x 100 queries)."""
        lat = self.latency(net) + self.compute_s / max(self.batches, 1)
        if lat == 0:
            return float("inf")
        per_batch = self.queries / max(self.batches, 1)
        return threads * per_batch / lat


def form_batches(queue: list, batch_size: int) -> list:
    """Pop `queue` into (X, n) pairs of batch_size rows, zero-padding the
    tail batch (n = valid rows).  Shared by PredictionServer and
    serve.party_server."""
    out = []
    while queue:
        take = queue[:batch_size]
        del queue[:batch_size]
        n = len(take)
        X = np.stack(take)
        pad = batch_size - n
        if pad:
            X = np.concatenate([X, np.zeros((pad,) + X.shape[1:])])
        out.append((X, n))
    return out


def drain_in_batches(queue: list, batch_size: int, run_batch) -> list:
    """``run_batch(X, n)`` returns one prediction row per batch row, of
    which the first n are kept; returns the kept rows."""
    out = []
    for X, n in form_batches(queue, batch_size):
        out.extend(torch.unbind(torch.as_tensor(run_batch(X, n))[:n]))
    return out


class PredictionServer:
    """``predict_fn(ctx, X_batch)`` returns one tensor row per query; each
    batch runs on a fresh context from ``make_context(ring, seed, device)``.

    Runs on CUDA unless ``device`` says otherwise.  A batch's compute time
    ends once its opened words are on the host."""

    def __init__(self, predict_fn: Callable, batch_size: int = 100,
                 ring=RING64, seed: int = 0, device=None):
        self.predict_fn = predict_fn
        self.batch_size = batch_size
        self.ring = ring
        self.seed = seed
        self.device = resolve_device(device)
        self.stats = ServeStats()
        # each batch's tally.totals() and compute seconds, in serving order
        self.batch_totals: list = []
        self.batch_walls_s: list = []
        self._queue: list[np.ndarray] = []

    def submit(self, x: np.ndarray) -> None:
        self._queue.append(np.asarray(x))

    def _run_batch(self, X, n):
        ctx = make_context(self.ring, seed=self.seed, device=self.device)
        before = self.stats.compute_s
        with timed(self.stats, "compute_s", span="serve.batch", queries=n):
            preds = self.predict_fn(ctx, X).cpu()  # waits for the device
        self.batch_walls_s.append(self.stats.compute_s - before)
        self.stats.batches += 1
        self.stats.queries += n
        self.stats.online_rounds += ctx.tally.online.rounds
        self.stats.online_bits += ctx.tally.online.bits
        self.stats.offline_bits += ctx.tally.offline.bits
        self.stats.aborted = self.stats.aborted or ctx.abort_flag()
        self.batch_totals.append(ctx.tally.totals())
        return preds

    def flush(self) -> list:
        """Run all pending queries in batches; returns one prediction row
        each."""
        return drain_in_batches(self._queue, self.batch_size,
                                self._run_batch)

    def report(self) -> dict:
        return {
            "queries": self.stats.queries,
            "lan_latency_ms": self.stats.latency(LAN) * 1e3,
            "wan_latency_s": self.stats.latency(WAN),
            "lan_throughput_qps": self.stats.throughput(LAN),
            "wan_throughput_qpm": self.stats.throughput(WAN) * 60,
        }
