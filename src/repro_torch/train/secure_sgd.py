"""Secure SGD in two execution worlds, with per-step prep
(``repro/train/secure_sgd.py``).

One engine-agnostic training step (the paper's Section VI workloads via
``paper_ml``) runs on:

  * ``world="joint"``   -- TridentEngine (joint simulation, newton
                           nonlinearities: the route with a runtime twin);
  * ``world="runtime"`` -- RuntimeEngine over a LocalTransport (or any
                           transport you pass), inline or online-only from
                           a PrepStore (``PrepAheadSGD`` over a
                           ``ContinuousDealer``);
  * ``ClusterSGD``      -- each step one ``PartyCluster`` task across the
                           four socket daemons, inline, from step-indexed
                           PrepBank sessions (``prep="bank"``), or, with
                           ``prep="live"`` and ``attach_live_dealer``, from
                           sessions STREAMED into the running daemons, so
                           the bank starts empty and training is unbounded;
                           zero offline bits on the mesh, enforced;
  * ``ShardedClusterSGD`` -- the global batch sharded over a pool of
                           clusters, the members' updates averaged.

Determinism contract: step t always runs from
``trainer.seed_for_step(base_seed, t)``; the dealer's session t uses the
same seed, so both worlds -- and a checkpoint-restored replay of any step
-- produce bit-identical ``(params, loss)`` trajectories, and the same as
the JAX package's on the same seed.

Params cross step boundaries as plaintext float64 dicts (the fixed-point
decode/encode round trip is exact for trained-weight magnitudes), so the
``Trainer`` and its checkpoints drive every world unchanged.  Entry points
run on the card unless the caller passes ``device="cpu"``.

The cluster steps ship the task, params and batch to spawned daemons as
plain data (numpy), and the JAX package's ``health()`` of the cluster
steps comes with the port's observability slice.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

from ..core.context import make_context
from ..core.ring import RING64, Ring
from ..nn.engine import Engine, TridentEngine
from ..nn.runtime_engine import RuntimeEngine
from ..runtime import FourPartyRuntime
from . import paper_ml as PML
from .trainer import seed_for_step


def engine_abort(eng: Engine) -> bool:
    """The engine's malicious-check verdict (False for PlainEngine)."""
    rt = getattr(eng, "rt", None)
    if rt is not None:
        return bool(rt.abort_flag())
    ctx = getattr(eng, "ctx", None)
    if ctx is not None:
        return bool(ctx.abort_flag())
    return False


# ---------------------------------------------------------------------------
# The training step, written once against the Engine interface.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SGDTask:
    """One secure-SGD workload: which paper_ml step to drive and how.

    kind: "linreg" | "logreg" | "nn" (MLP with ReLU hidden + smx output).
    """

    kind: str
    lr: float = 0.25
    features: int = 8
    net: PML.MLPNet | None = None

    def init_params(self, seed: int = 0) -> dict:
        rng = np.random.RandomState(seed)
        if self.kind == "nn":
            return PML.mlp_net_init(rng, self.net)
        return PML.reg_init(rng, self.features)

    def run(self, eng: Engine, params: dict, batch: tuple):
        """One forward + backward + SGD step; returns (new_params_np, loss,
        abort).  ``params`` enter and leave as plaintext float64 dicts; the
        loss is the declassified mean squared error (p - y), the same
        protocol trace in every world.  The opened values stay on the
        engine's device until the abort flag has been read."""
        sh = {k: eng.from_plain(params[k]) for k in sorted(params)}
        if self.kind == "nn":
            X, onehot = batch[0], batch[1]
            new, p = PML.mlp_net_step(eng, sh, self.net, eng.from_plain(X),
                                      onehot, lr=self.lr)
            err = eng.add_public(p, -np.asarray(onehot, np.float64))
        else:
            step = PML.logreg_step if self.kind == "logreg" \
                else PML.linreg_step
            X, y = batch[0], batch[1]
            new, err = step(eng, sh, eng.from_plain(X), eng.from_plain(y),
                            lr=self.lr)
        sq = eng.mul(err, err)
        tot = eng.sum(sq, axis=tuple(range(len(eng.shape_of(sq)))))
        n = float(np.prod(eng.shape_of(sq)))
        opened_loss = eng.to_plain(tot)
        opened = {k: eng.to_plain(new[k]) for k in sorted(new)}
        abort = engine_abort(eng)
        loss = float(opened_loss) / n
        new_np = {k: v.cpu().numpy() for k, v in opened.items()}
        return new_np, loss, abort


def logreg_task(features: int = 8, lr: float = 0.25) -> SGDTask:
    return SGDTask(kind="logreg", lr=lr, features=features)


def nn_task(net: PML.MLPNet | None = None, lr: float = 0.25) -> SGDTask:
    """The paper's NN benchmark net by default (784-128-128-10)."""
    if net is None:
        net = PML.MLPNet(features=784, layers=(128, 128, 10))
    return SGDTask(kind="nn", lr=lr, net=net)


# ---------------------------------------------------------------------------
# World runners (one step; step-indexed seeds).
# ---------------------------------------------------------------------------
def make_engine(world: str, seed: int, *, ring: Ring = RING64,
                transport=None, device=None,
                kernel_backend="hopper") -> Engine:
    """The engine of `world` on `device`.  The joint world reaches the
    kernels through ``kernels.ops`` directly, by its tensors' device, so
    `kernel_backend` is the runtime's alone."""
    if world == "joint":
        return TridentEngine(make_context(ring, seed=seed, device=device),
                             nonlinear="newton")
    if world == "runtime":
        return RuntimeEngine(FourPartyRuntime(
            ring, seed=seed, transport=transport,
            kernel_backend=kernel_backend, device=device))
    raise ValueError(f"unknown world {world!r}")


def run_step(task: SGDTask, params: dict, batch: tuple, *, step: int,
             base_seed: int = 0, world: str = "joint", ring: Ring = RING64,
             transport=None, device=None,
             kernel_backend="hopper"):
    """One training step in `world` from the step-indexed seed."""
    eng = make_engine(world, seed_for_step(base_seed, step), ring=ring,
                      transport=transport, device=device,
                      kernel_backend=kernel_backend)
    return task.run(eng, params, batch)


def step_program(task: SGDTask, params: dict, batch: tuple):
    """The step as a runtime protocol program: ``program(rt)`` runs it on
    a RuntimeEngine over rt's transport and prep.  With zeroed inputs it is
    also the deal twin: the offline half is data-independent, so the
    dealer walks the same tag sequence."""

    def program(rt):
        return task.run(RuntimeEngine(rt), params, batch)

    return program


def zero_inputs(_task: SGDTask, params: dict, batch: tuple):
    """Shape-preserving zero (params, batch) for dealing ahead of data."""
    zp = {k: np.zeros_like(np.asarray(v, np.float64))
          for k, v in params.items()}
    zb = tuple(np.zeros_like(np.asarray(b, np.float64)) for b in batch)
    return zp, zb


def deal_step_program(task: SGDTask, params: dict, batch: tuple):
    """The data-independent dealer twin of ``step_program``."""
    zp, zb = zero_inputs(task, params, batch)
    return step_program(task, zp, zb)


# ---------------------------------------------------------------------------
# Prep-ahead training: session k == step k's offline material.
# ---------------------------------------------------------------------------
def deal_training_bank(task: SGDTask, params: dict, batch: tuple,
                       steps: int, *, base_seed: int = 0,
                       ring: Ring = RING64, path: str | None = None,
                       device=None):
    """Deal one PrepStore per training step (seed = seed_for_step(base,
    k), what the online step k will run) into a PrepBank; optionally save
    it.  Returns (bank, [DealReport])."""
    from ..offline import deal_sessions
    program = deal_step_program(task, params, batch)
    bank, reports = deal_sessions([program] * steps, ring=ring,
                                  base_seed=base_seed, device=device,
                                  meta={"task": task.kind})
    if path is not None:
        bank.save(path)
    return bank, reports


class PrepAheadSGD:
    """Trainer step_fn over LocalTransport with per-step prep: each step
    pops its store (from a ContinuousDealer via ``store_for_step``) and
    runs ONLINE-ONLY on `device` -- the transport forbids offline traffic,
    so "zero offline bits per training step" is enforced on the wire, and
    the outputs are bit-identical to the inline step from the same
    seed."""

    def __init__(self, task: SGDTask, dealer, *, ring: Ring = RING64,
                 device=None):
        self.task = task
        self.dealer = dealer            # ContinuousDealer (or compatible)
        self.ring = ring
        self.device = device
        self.reports: list = []

    def step_fn(self, params, step, *batch):
        from ..offline import run_online
        store = self.dealer.store_for_step(step)
        program = step_program(self.task, params, tuple(batch))
        (new, loss, abort), report = run_online(program, store,
                                                ring=self.ring,
                                                device=self.device)
        self.reports.append(report)
        return new, loss, abort or report.abort

    __call__ = step_fn


# ---------------------------------------------------------------------------
# Distributed training: one PartyCluster task per step.
# ---------------------------------------------------------------------------
def _cluster_step_program(rt, _rank, task=None, params=None, batch=None):
    """Module-level (spawn-picklable) per-step program for the daemons."""
    new, loss, abort = task.run(RuntimeEngine(rt), params, batch)
    return {"params": new, "loss": loss, "abort": bool(abort)}


def _live_deal_program(rt, task=None, params=None, batch=None):
    """The dealer-daemon twin of ``_cluster_step_program``: the same
    protocol trace from zeroed inputs (the offline half is
    data-independent)."""
    task.run(RuntimeEngine(rt), params, batch)


def _live_program_for_step(_step, *, task, params, batch):
    """Picklable ``step -> program`` for the ContinuousDealer inside the
    dealer daemon (every step runs the same shapes)."""
    return functools.partial(_live_deal_program, task=task, params=params,
                             batch=batch)


def attach_live_dealer(cluster, task: SGDTask, params: dict, batch: tuple,
                       *, base_seed: int = 0, total: int | None = None):
    """Start a ``DealerDaemon`` streaming step-indexed prep sessions into a
    LIVE cluster (``PartyCluster(live_prep=True)``), on the cluster's
    device: session t is dealt from ``seed_for_step(base_seed, t)``, the
    seed ``ClusterSGD`` gives the online step t, and shipped to every
    daemon while earlier steps run online.  ``total=None`` streams for as
    long as training runs.  Returns the daemon handle (a context
    manager)."""
    from ..offline.live import DealerDaemon
    zp, zb = zero_inputs(task, params, batch)
    factory = functools.partial(_live_program_for_step, task=task,
                                params=zp, batch=zb)
    return DealerDaemon(cluster, factory, base_seed=base_seed, total=total)


def _member_params(results, what: str) -> dict:
    """The params P0 opened, after checking the other daemons opened the
    same."""
    ref = results[0].result
    for r in results[1:]:
        for k in ref["params"]:
            if not np.array_equal(r.result["params"][k], ref["params"][k]):
                raise RuntimeError(f"cluster divergence at {what}: "
                                   f"P{r.rank} params[{k!r}] differs from P0")
    return ref["params"]


class ClusterSGD:
    """Trainer step_fn that drives a ``PartyCluster``: step t is one task
    across the four daemons, seeded ``seed_for_step(base_seed, t)``, so a
    checkpoint-restored replay regenerates the same PRF streams in every
    party process.

    ``prep="bank"``: every step consumes its STEP-INDEXED PrepBank session
    (the daemons seek to session t, so a resumed run skips spent sessions
    and a retried step raises PrepReplayError naming it) and runs
    online-only on the mesh.  ``prep="live"``: the same against a LIVE
    bank fed by ``attach_live_dealer``; a step whose session has not
    arrived blocks in the daemons until the dealer catches up (or fails
    with the dealer's traceback).
    """

    PREPPED = ("bank", "live")

    def __init__(self, cluster, task: SGDTask, *, base_seed: int = 0,
                 prep: str | None = None, dealer=None):
        if prep not in (None, "bank", "live"):
            raise ValueError(f"unknown prep mode {prep!r}")
        if prep == "live" and not getattr(cluster, "live_prep", False):
            raise ValueError("prep='live' needs a cluster built with "
                             "PartyCluster(live_prep=True)")
        self.cluster = cluster
        self.task = task
        self.base_seed = base_seed
        self.prep = prep
        # the attach_live_dealer daemon (prep="live"): health() reads it
        self.dealer = dealer
        self.results: list = []         # per-step [PartyResult x4]

    def step_fn(self, params, step, *batch):
        program = functools.partial(
            _cluster_step_program, task=self.task,
            params={k: np.asarray(v) for k, v in params.items()},
            batch=tuple(np.asarray(b) for b in batch))
        prepped = self.prep in self.PREPPED
        results = self.cluster.submit(
            program, seed=seed_for_step(self.base_seed, step),
            prep="bank" if prepped else None,
            prep_session=step if prepped else None)
        new = _member_params(results, f"step {step}")
        self.results.append(results)
        ref = results[0].result
        abort = bool(ref["abort"]) or any(r.abort for r in results)
        return new, float(ref["loss"]), abort

    __call__ = step_fn

    def offline_bits_on_mesh(self) -> int:
        """Offline-phase bits the socket mesh carried over the recorded
        steps (0 with prep -- the acceptance check)."""
        return sum(res[0].totals["offline"]["bits"] for res in self.results)

    def health(self, **kw) -> dict:
        """One cluster health document between steps: the four party
        exporters and the attached dealer's (``PartyCluster`` built with
        ``metrics=True``); `kw` goes to ``PartyCluster.health``."""
        return self.cluster.health(dealer=self.dealer, **kw)


# ---------------------------------------------------------------------------
# Data-parallel secure SGD: the global batch sharded across a cluster pool.
# ---------------------------------------------------------------------------
def shard_batch(batch: tuple, shards: int) -> list:
    """Split every batch array into ``shards`` EQUAL row-shards: each
    member normalizes its gradient by its shard size, so the mean of the
    members' updates is the full-batch update only for equal shards."""
    arrays = tuple(np.asarray(b) for b in batch)
    n = arrays[0].shape[0]
    if n % shards:
        raise ValueError(
            f"global batch of {n} rows does not shard evenly across "
            f"{shards} pool members")
    size = n // shards
    return [tuple(a[i * size:(i + 1) * size] for a in arrays)
            for i in range(shards)]


class ShardedClusterSGD:
    """Data-parallel ``Trainer`` step_fn over a POOL of party clusters:
    step t splits the global batch into one equal shard per member, every
    member runs the step on its shard concurrently (``submit_nowait`` on
    all, then collect), and the new params are the mean over the members.

    Since each member computes ``params - lr * grad_i`` with ``grad_i``
    normalized by the (equal) shard size, the mean is ``params - lr *
    mean_i(grad_i)``: one linear combination of the members' outputs,
    free on the wire in-protocol.  This step contract opens params at
    every step boundary (as ``ClusterSGD``'s), so the mean is taken of the
    opened updates here.  Every member runs from the SAME
    ``seed_for_step(base_seed, t)``; a cluster may appear more than once
    (its tasks queue in order).
    """

    def __init__(self, clusters, task: SGDTask, *, base_seed: int = 0):
        clusters = list(clusters)
        if not clusters:
            raise ValueError("ShardedClusterSGD needs at least one cluster")
        self.clusters = clusters
        self.task = task
        self.base_seed = base_seed
        self.results: list = []   # per step: [member -> [PartyResult x4]]

    def step_fn(self, params, step, *batch):
        params_np = {k: np.asarray(v) for k, v in params.items()}
        shards = shard_batch(tuple(batch), len(self.clusters))
        seed = seed_for_step(self.base_seed, step)
        handles = [
            cluster.submit_nowait(
                functools.partial(_cluster_step_program, task=self.task,
                                  params=params_np, batch=shard),
                seed=seed)
            for cluster, shard in zip(self.clusters, shards)]
        per_member = [cluster.collect(h)
                      for cluster, h in zip(self.clusters, handles)]
        news, losses, abort = [], [], False
        for m, results in enumerate(per_member):
            news.append(_member_params(results, f"step {step}, member {m}"))
            ref = results[0].result
            losses.append(float(ref["loss"]))
            abort = abort or bool(ref["abort"]) \
                or any(r.abort for r in results)
        self.results.append(per_member)
        mean = {k: np.mean([nw[k] for nw in news], axis=0)
                for k in sorted(news[0])}
        return mean, float(np.mean(losses)), abort

    __call__ = step_fn

    def offline_bits_on_mesh(self) -> int:
        """Offline-phase bits across every member's mesh."""
        return sum(res[0].totals["offline"]["bits"]
                   for step in self.results for res in step)

    def health(self, **kw) -> dict:
        """One cluster health document a member (``PartyCluster.health``,
        `kw` passed on), keyed by member index: "0", "1", ...."""
        return {str(m): c.health(**kw)
                for m, c in enumerate(self.clusters)}
