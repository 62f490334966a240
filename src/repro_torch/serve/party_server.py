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

``serve_over_sockets`` is the distributed path: four long-lived party
daemons (``runtime.net.PartyCluster``) over TCP serve the stream batch by
batch, batch k at seed ``seed + k``, inline (``prep=None``), from a bank
dealt ahead and loaded by the daemons at start-up (``prep="ahead"``), or
from sessions a dealer process streams into the running daemons
(``prep="live"``); the report carries the wire traffic all four processes
measured.  The JAX package dispatches those batches through its
``ServingGateway`` pool; until the port has the gateway, each batch is
submitted straight to the cluster, one after the other, with the same
seeds and sessions (the same words and totals).

Each batch's compute is an ``obs.timed`` interval: ``stats.compute_s``,
and with tracing on a ``serve.batch`` span (``serve.batch.online`` from a
dealt store).  ``serve_over_sockets(metrics=True)`` starts the daemons'
and the dealer's exporters and puts one health document, scraped at the
end of the stream, in the report under ``"health"``.
"""
from __future__ import annotations

import dataclasses
import functools
import shutil
import tempfile
import time
from typing import Callable

import numpy as np
import torch

from ..core.costs import LAN, WAN, NetworkModel
from ..core.ring import RING64
from ..obs import get_registry, stopwatch, timed
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
    compute_s: float = 0.0             # predict_fn, result on the host
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
        with timed(self.stats, "compute_s", queries=n,
                   span="serve.batch" if pipe is None
                   else "serve.batch.online"):
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


# ---------------------------------------------------------------------------
# Distributed serving: four long-lived party daemons over TCP.
# ---------------------------------------------------------------------------
def _serve_batch(rt, _rank, predict_fn=None, X=None):
    """Party-daemon task: one batch through predict_fn on this runtime."""
    return predict_fn(rt, X)


def _zero_deal_program(predict_fn, X, rt):
    """Module-level deal twin of ``_serve_batch`` (shapes only)."""
    predict_fn(rt, np.zeros_like(X))


def _serve_program_for_step(step, *, predict_fn, batches):
    """Picklable ``step -> deal program`` for the live dealer daemon:
    session k is batch k's offline material (shapes only)."""
    return functools.partial(_zero_deal_program, predict_fn, batches[step])


def serve_over_sockets(predict_fn: Callable, queries, batch_size: int = 32,
                       ring=RING64, seed: int = 0, net_model=None,
                       timeout: float = 300.0, cluster=None,
                       prep: str | None = None, device=None,
                       metrics: bool = False):
    """Serve a query stream across four party processes over TCP.

    ``predict_fn(rt, X_batch)`` is a module-level (picklable: the party
    processes are spawned) callable returning the batch's predictions on
    `rt` (its numpy inputs become tensors on ``rt.device`` inside).
    Returns (predictions, report): one numpy row per query, from party
    P1's copy (ring words come back as ``uint64``/``uint32`` words), and
    the per-link wire traffic all four processes agree on.

    Batches run as tasks on a ``PartyCluster`` of long-lived daemons on
    `device` (CUDA unless the caller asks for the CPU); pass ``cluster=``
    to reuse one across streams.  ``prep="ahead"`` deals every batch's
    offline phase up front (on `device`), saves the bank to a temporary
    directory (removed at the end) for the daemons to load at start-up,
    and runs each batch online-only; ``prep="live"`` starts the daemons
    with an empty live bank and a ``DealerDaemon`` streams batch k's
    session while batch k-1 is served.  Both modes move zero offline bits
    on the mesh (forbidden by the daemons' transports).  ``"ahead"``
    provisions its own cluster; ``"live"`` does too, or streams into a
    ``cluster=`` built with ``live_prep=True`` whose bank no earlier
    stream used (its sessions count from 0).

    ``metrics=True`` starts an HTTP exporter in every daemon (and the
    dealer) and puts one cluster health document, scraped at the end of
    the stream, in the report under ``"health"``; a ``cluster=`` must have
    been built with ``metrics=True`` for it.  A dealer's trace chunks
    join ``cluster.trace_chunks``.
    """
    from ..runtime.net.cluster import PartyCluster

    if prep not in (None, "ahead", "live"):
        raise ValueError(f"unknown prep mode {prep!r}")
    queries = [np.asarray(q) for q in queries]
    batches = [np.stack(queries[i:i + batch_size])
               for i in range(0, len(queries), batch_size)]

    own_cluster = cluster is None
    if not own_cluster:
        # the daemons run under the CLUSTER's configuration: refuse a
        # conflicting argument instead of mislabeling the results
        if cluster.ring is not ring:
            raise ValueError("cluster= was built for a different ring")
        if net_model is not cluster.net_model:
            raise ValueError(
                "net_model mismatch: pass the model to PartyCluster (the "
                "daemons integrate the clock), not to serve_over_sockets")
        if prep == "ahead" or (prep == "live" and not cluster.live_prep):
            raise ValueError(f"prep={prep!r} needs a cluster that loads or "
                             "streams the bank: let serve_over_sockets "
                             "provision it (or, for 'live', pass one built "
                             "with live_prep=True)")
        if metrics and not cluster.metrics:
            raise ValueError("metrics=True needs a cluster built with "
                             "PartyCluster(metrics=True)")
    prep_path = None
    deal_wall = 0.0
    if prep == "ahead":
        from ..offline import deal_sessions
        with stopwatch() as sw:
            bank, _ = deal_sessions(
                [functools.partial(_zero_deal_program, predict_fn, X)
                 for X in batches], ring=ring, base_seed=seed,
                device=device)
            prep_path = tempfile.mkdtemp(prefix="prepbank-")
            bank.save(prep_path)
            del bank    # the daemons load the saved copy: free the dealt one
        deal_wall = sw.s
    dealer = None
    try:
        if own_cluster:
            cluster = PartyCluster(ring=ring, timeout=timeout,
                                   net_model=net_model, prep_path=prep_path,
                                   live_prep=(prep == "live"), device=device,
                                   metrics=metrics)
        if prep == "live":
            from ..offline.live import DealerDaemon
            # the dealer is data-independent: it gets SHAPES (zeros), not
            # the query stream
            dealer = DealerDaemon(
                cluster,
                functools.partial(_serve_program_for_step,
                                  predict_fn=predict_fn,
                                  batches=[np.zeros_like(X)
                                           for X in batches]),
                base_seed=seed, total=len(batches))
        preds: list = []
        totals = {p: {"rounds": 0, "bits": 0}
                  for p in ("offline", "online")}
        link_bits: dict = {}
        frames, wire_bytes = [], []
        aborted = False
        wall = 0.0
        modeled = None
        for k, X in enumerate(batches):
            results = cluster.submit(
                functools.partial(_serve_batch, predict_fn=predict_fn, X=X),
                seed=seed + k, prep="bank" if prep is not None else None,
                prep_session=k if prep is not None else None,
                timeout=timeout)
            ref = results[0]
            if any(r.totals != ref.totals or r.per_link != ref.per_link
                   for r in results[1:]):
                raise RuntimeError(
                    "party processes disagree on measured traffic")
            aborted = aborted or any(r.abort for r in results)
            preds.extend(np.asarray(results[1].result))
            for p in totals:
                for kk in totals[p]:
                    totals[p][kk] += ref.totals[p][kk]
            for link, bits in ref.per_link.items():
                acc = link_bits.setdefault(link, dict.fromkeys(bits, 0))
                for phase, b in bits.items():
                    acc[phase] += b
            frames.append(sum(sum(r.frames_sent.values()) for r in results))
            wire_bytes.append(sum(sum(r.bytes_sent.values())
                                  for r in results))
            wall += max(r.wall_s for r in results)
            if ref.modeled_s is not None:
                modeled = modeled or {p: 0.0 for p in ref.modeled_s}
                for p, sec in ref.modeled_s.items():
                    modeled[p] += sec
        report = {
            "queries": len(queries),
            "batches": len(batches),
            "aborted": aborted,
            "totals": totals,
            "link_online_bits": {f"P{a}->P{b}": bits["online"] for (a, b),
                                 bits in sorted(link_bits.items())},
            "per_link": link_bits,
            # wire frames and bytes all four daemons wrote, a batch
            "frames_per_batch": frames,
            "wire_bytes_per_batch": wire_bytes,
            "party_wall_s": wall,
            "cluster_tasks": cluster.tasks_run,
        }
        if prep is not None:
            report["online_only"] = True
            report["prep"] = prep
            if totals["offline"]["bits"]:
                raise RuntimeError(
                    f"an online-only stream moved offline bits: {totals}")
        if prep == "ahead":
            report["offline_deal_s"] = deal_wall
        if prep == "live":
            report["live_sessions_streamed"] = dealer.dealt
        if modeled is not None:
            report[f"modeled_{net_model.name}_s"] = modeled
        if metrics:
            # scraped while the daemons and the dealer are up, between
            # tasks: the age-gated probes see no task in flight
            report["health"] = cluster.health(dealer=dealer)
        return preds, report
    finally:
        if dealer is not None:
            dealer.close()
            cluster.trace_chunks.extend(dealer.trace_chunks)
        if own_cluster and cluster is not None:
            cluster.close()
        if prep_path is not None:
            shutil.rmtree(prep_path, ignore_errors=True)
