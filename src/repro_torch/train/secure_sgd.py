"""Secure SGD in two execution worlds, with per-step prep
(``repro/train/secure_sgd.py``).

One engine-agnostic training step (the paper's Section VI workloads via
``paper_ml``) runs on:

  * ``world="joint"``   -- TridentEngine (joint simulation, newton
                           nonlinearities: the route with a runtime twin);
  * ``world="runtime"`` -- RuntimeEngine over a LocalTransport (or any
                           transport you pass), inline or online-only from
                           a PrepStore (``PrepAheadSGD`` over a
                           ``ContinuousDealer``).

Determinism contract: step t always runs from
``trainer.seed_for_step(base_seed, t)``; the dealer's session t uses the
same seed, so both worlds -- and a checkpoint-restored replay of any step
-- produce bit-identical ``(params, loss)`` trajectories, and the same as
the JAX package's on the same seed.

Params cross step boundaries as plaintext float64 dicts (the fixed-point
decode/encode round trip is exact for trained-weight magnitudes), so the
``Trainer`` and its checkpoints drive every world unchanged.  Entry points
run on the card unless the caller passes ``device="cpu"``.

The socket cluster's step functions (``ClusterSGD``,
``attach_live_dealer``, ``ShardedClusterSGD``, ``shard_batch``) come with
the port's socket cluster.
"""
from __future__ import annotations

import dataclasses

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
