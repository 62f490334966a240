"""Training loop with checkpoint/restart (``repro/train/trainer.py``).

Fault tolerance: an abort flag from the malicious checks discards the
step and resumes from the latest checkpoint; an injected crash point
stands in for a lost process.  PRF seeds are step-indexed
(``seed_for_step``), so a replayed step is bit-identical.  Restored words
go back into the params' own containers (a share around its words, on
its device), on resume and on the abort path alike.  (The JAX trainer's
abort path keeps the bare restored arrays: ROADMAP F8.)  The step
function is engine-agnostic and returns ``(new_params, loss, abort)``;
``secure_sgd.run_step`` (inline, in either world) and
``secure_sgd.PrepAheadSGD`` (online-only from a ``ContinuousDealer``)
plug in unchanged.

``split_offline_online`` runs a joint-simulation program as an offline
run, then as an online run on its materials.  The JAX trainer's unused
offline-material queue (``offline_buffer``) is not ported: the
``ContinuousDealer`` keeps the look-ahead window.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Callable

from ..core.context import make_context
from ..core.ring import RING64
from . import checkpoint as ckpt_lib


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_dir: str = dataclasses.field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "trident_ckpt"))
    ckpt_every: int = 25
    seed: int = 0
    resume: bool = True


def seed_for_step(base_seed: int, step: int) -> int:
    """The step-indexed PRF seed: every execution world (joint simulation,
    RuntimeEngine inline or online-only, the per-step dealer) derives step
    t's F_setup streams from this seed, so a resumed or replayed step t is
    bit-identical everywhere and the ContinuousDealer's session t is step
    t's preprocessing."""
    return base_seed + step


class Trainer:
    """Drives (params, batch) -> step_fn with checkpoint/restart.  step_fn
    must be engine-agnostic and return (new_params, loss, abort_flag)."""

    def __init__(self, cfg: TrainerConfig, step_fn: Callable,
                 params, batch_fn: Callable):
        self.cfg = cfg
        self.step_fn = step_fn
        self.params = params
        self.batch_fn = batch_fn
        self.start_step = 0
        self.losses: list[float] = []
        self.events: list[str] = []

    def maybe_resume(self):
        if not self.cfg.resume:
            return
        path = ckpt_lib.latest(self.cfg.ckpt_dir)
        if path is None:
            return
        restored, manifest = ckpt_lib.restore(path, self.params)
        self.params = ckpt_lib.rewrap(self.params, restored)
        self.start_step = manifest["step"] + 1
        self.events.append(f"resumed@{self.start_step}")

    def run(self, crash_at: int | None = None):
        """Train; `crash_at` injects a fault (for the restart checks)."""
        self.maybe_resume()
        step = self.start_step
        while step < self.cfg.steps:
            batch = self.batch_fn(step)
            new_params, loss, abort = self.step_fn(self.params, step, *batch)
            if bool(abort):
                # malicious check failed: discard the step, restore, retry
                self.events.append(f"abort@{step}")
                path = ckpt_lib.latest(self.cfg.ckpt_dir)
                if path is not None:
                    restored, manifest = ckpt_lib.restore(path, self.params)
                    self.params = ckpt_lib.rewrap(self.params, restored)
                    step = manifest["step"] + 1
                continue
            self.params = new_params
            self.losses.append(float(loss))
            if crash_at is not None and step == crash_at:
                self.events.append(f"crash@{step}")
                raise RuntimeError(f"injected crash at step {step}")
            if (step + 1) % self.cfg.ckpt_every == 0 \
                    or step == self.cfg.steps - 1:
                ckpt_lib.save(self.cfg.ckpt_dir, step, self.params,
                              meta={"seed": self.cfg.seed})
                self.events.append(f"ckpt@{step}")
            step += 1
        return self.params


def split_offline_online(program: Callable, ring=RING64, seed: int = 0,
                         device=None, collapse: bool = False):
    """The offline/online split of `program` (a function of a joint
    ``TridentContext``): its offline run on `device` (CUDA unless given;
    `collapse` for the component-collapsed world), then ``(materials,
    online_fn)``, where ``online_fn()`` runs the program online on those
    materials and returns ``(result, on_ctx)``.  The online run takes the
    offline run's PRF counters, so its words are the fused run's."""
    off_ctx = make_context(ring, seed=seed, mode="offline", device=device,
                           collapse=collapse)
    program(off_ctx)
    materials = off_ctx.materials

    def online_fn():
        on_ctx = make_context(ring, seed=seed, mode="online",
                              device=off_ctx.device, collapse=collapse)
        on_ctx.materials = materials
        return program(on_ctx), on_ctx

    return materials, online_fn
