"""Batched secure prediction on the party-sliced runtime
(``repro/serve/party_server.py``).

Queries are queued by ``submit`` and served by ``flush`` in batches of
``batch_size`` (the tail batch zero-padded); each batch runs on a fresh
``FourPartyRuntime`` over a fresh ``LocalTransport``, as a deployment
provisions fresh offline material per batch, in this process.  The report
carries the measured wire traffic per batch and per link, and with
``net_model`` (a ``runtime.net.NetModel``) the modeled LAN/WAN time.

Example -- the paper's NN at full width, on the card::

    import numpy as np
    import torch
    from repro_torch.configs.paper_models import NN
    from repro_torch.core.ring import RING64
    from repro_torch.serve.party_server import PartyPredictionServer
    from repro_torch.train.paper_ml import (MLPNet, mlp_net_init,
                                            mlp_net_predict_runtime,
                                            params_from_numpy)

    net = MLPNet(NN["features"], NN["layers"])
    params = params_from_numpy(
        mlp_net_init(np.random.RandomState(0), net), RING64, "cuda")
    srv = PartyPredictionServer(
        lambda rt, X: mlp_net_predict_runtime(rt, params, net, X),
        batch_size=128)
    for x in np.random.RandomState(1).randn(256, 784):
        srv.submit(x)
    words = srv.flush()            # opened ring words, one row per query
    probs = RING64.decode(torch.stack(words))
    srv.report()                   # measured bits/rounds per batch and link

Offline/online split (``repro_torch.offline``):
``PartyPredictionServer(prep="pipelined")`` runs a background dealer (a
``PrepPipeline``, on a CUDA stream of its own) that deals one PrepStore per
batch -- batch k from seed ``seed + k`` (counted over every flush) on a
zeros batch of the same shape -- while each batch runs online-only from
its store: zero offline bits on the wire, and the report's
``online_only_ms_per_batch`` is the serving wall without the offline half.
In one process this mode is slower than inline serving, not faster: the
dealer thread and the serving thread are both host-bound (Python and
kernel dispatch) and take turns on one GIL, so a pipelined batch costs
about a deal plus an online run, each slowed by the other's contention
(PERF.md, Findings).  Use it where the offline half must leave the
critical path's wire, not for throughput.

The JAX package serves through its ``ServingGateway`` pool and has a socket
path; those come with later slices of the port: batches are drained here
in a plain loop.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable

import numpy as np
import torch

from ..core.costs import LAN, WAN, NetworkModel
from ..core.ring import RING64
from ..obs import get_registry
from ..runtime.runtime import FourPartyRuntime, resolve_device
from ..runtime.transport import LocalTransport
from .engine import form_batches


@dataclasses.dataclass
class PartyServeStats:
    batches: int = 0
    queries: int = 0
    online_rounds: int = 0
    online_bits: int = 0
    offline_bits: int = 0
    batch_walls_s: list = dataclasses.field(default_factory=list)
    online_compute_s: float = 0.0      # online-only wall (pipelined)
    offline_deal_s: float = 0.0        # dealer wall (overlapped: pipelined)
    modeled_s: dict = dataclasses.field(
        default_factory=lambda: {"offline": 0.0, "online": 0.0})
    link_online_bits: dict = dataclasses.field(default_factory=dict)
    aborted: bool = False

    def add_transport(self, tp) -> None:
        t = tp.totals()
        self.online_rounds += t["online"]["rounds"]
        self.online_bits += t["online"]["bits"]
        self.offline_bits += t["offline"]["bits"]
        for link, bits in tp.per_link().items():
            acc = self.link_online_bits.setdefault(link, 0)
            self.link_online_bits[link] = acc + bits["online"]

    def latency(self, net: NetworkModel) -> float:
        if self.batches == 0:
            return 0.0
        return net.seconds(self.online_rounds / self.batches,
                           self.online_bits / self.batches)


class PartyPredictionServer:
    """``predict_fn(rt, X_batch)`` returns one tensor row per query; each
    batch runs on a fresh ``FourPartyRuntime`` seeded with ``seed``.

    Runs on CUDA unless ``device`` says otherwise; ``kernel_backend`` is
    the runtime's ("hopper" by default).  ``prep="pipelined"`` serves each
    batch online-only from a store a background dealer made for it
    (``prep_capacity`` stores ahead at most)."""

    def __init__(self, predict_fn: Callable, batch_size: int = 32,
                 ring=RING64, seed: int = 0, net_model=None,
                 kernel_backend="hopper", device=None,
                 prep: str | None = None, prep_capacity: int = 2):
        if prep not in (None, "pipelined"):
            raise ValueError(f"unknown prep mode {prep!r}")
        self.predict_fn = predict_fn
        self.batch_size = batch_size
        self.ring = ring
        self.seed = seed
        self.net_model = net_model
        self.kernel_backend = kernel_backend
        self.device = resolve_device(device)
        self.prep = prep
        self.prep_capacity = prep_capacity
        self.stats = PartyServeStats()
        # each batch's (per_link(), totals()), in serving order
        self.batch_traffic: list = []
        self._queue: list[np.ndarray] = []
        self._batches_dealt = 0
        # the dealer thread's CUDA stream, one for every flush
        self._deal_stream = None

    def submit(self, x: np.ndarray) -> None:
        self._queue.append(np.asarray(x))

    def _transport(self):
        base = LocalTransport()
        if self.net_model is not None:
            from ..runtime.net import NetModelTransport
            return base, NetModelTransport(base, self.net_model)
        return base, base

    def _run_batch(self, X, n, pipe=None):
        """One batch: inline on a fresh runtime, or (`pipe`) online-only
        from the next dealt store."""
        base, tp = self._transport()
        t0 = time.perf_counter()
        if pipe is None:
            rt = FourPartyRuntime(self.ring, seed=self.seed, transport=tp,
                                  kernel_backend=self.kernel_backend,
                                  device=self.device)
        else:
            from ..offline import OnlinePrep
            _, store, drep = pipe.next_store()
            self.stats.offline_deal_s += drep.wall_s
            t0 = time.perf_counter()
            tp.forbid_phase("offline")
            rt = FourPartyRuntime(self.ring, transport=tp,
                                  prep=OnlinePrep(store, self.device),
                                  kernel_backend=self.kernel_backend,
                                  device=self.device)
        preds = self.predict_fn(rt, X)[:n].cpu()   # waits for the device
        aborted = rt.abort_flag()
        wall = time.perf_counter() - t0
        if pipe is not None:
            self.stats.online_compute_s += wall
            if base.totals()["offline"]["bits"]:
                raise RuntimeError("an online-only batch moved offline bits")
        self.stats.batch_walls_s.append(wall)
        self.stats.batches += 1
        self.stats.queries += n
        self.stats.add_transport(base)
        self.batch_traffic.append((base.per_link(), base.totals()))
        if self.net_model is not None:
            for phase in ("offline", "online"):
                self.stats.modeled_s[phase] += tp.seconds(phase)
        self.stats.aborted = self.stats.aborted or aborted
        reg = get_registry()
        reg.counter("trident_serve_queries_total", "queries served").inc(n)
        reg.counter("trident_serve_batches_total", "batches served").inc()
        return preds

    def _deal_program(self, X, rt):
        self.predict_fn(rt, X)

    def flush(self) -> list:
        """Serve every queued query; returns one prediction row each."""
        batches = form_batches(self._queue, self.batch_size)
        out: list = []
        if self.prep != "pipelined":
            for X, n in batches:
                out.extend(torch.unbind(self._run_batch(X, n)))
            return out
        from ..offline import PrepPipeline
        if self.device.type == "cuda" and self._deal_stream is None:
            self._deal_stream = torch.cuda.Stream(self.device)
        base_seed = self.seed + self._batches_dealt
        self._batches_dealt += len(batches)
        programs = [functools.partial(self._deal_program, np.zeros_like(X))
                    for X, _ in batches]
        with PrepPipeline(programs, ring=self.ring, base_seed=base_seed,
                          capacity=self.prep_capacity, device=self.device,
                          stream=self._deal_stream, runtime_kwargs={
                              "kernel_backend": self.kernel_backend}
                          ) as pipe:
            for X, n in batches:
                out.extend(torch.unbind(self._run_batch(X, n, pipe)))
        return out

    def report(self) -> dict:
        links = {f"P{a}->P{b}": bits for (a, b), bits
                 in sorted(self.stats.link_online_bits.items())}
        nb = max(self.stats.batches, 1)
        out = {
            "queries": self.stats.queries,
            "batches": self.stats.batches,
            "aborted": self.stats.aborted,
            "online_rounds_per_batch": self.stats.online_rounds / nb,
            "online_bits_per_batch": self.stats.online_bits / nb,
            "offline_bits_per_batch": self.stats.offline_bits / nb,
            "lan_latency_ms": self.stats.latency(LAN) * 1e3,
            "wan_latency_s": self.stats.latency(WAN),
            "link_online_bits": links,
        }
        if self.net_model is not None:
            out[f"modeled_{self.net_model.name}_online_s_per_batch"] = \
                self.stats.modeled_s["online"] / nb
            out[f"modeled_{self.net_model.name}_offline_s_per_batch"] = \
                self.stats.modeled_s["offline"] / nb
        if self.prep == "pipelined":
            out["online_only_ms_per_batch"] = \
                self.stats.online_compute_s / nb * 1e3
            out["offline_deal_s_per_batch"] = \
                self.stats.offline_deal_s / nb
        return out
