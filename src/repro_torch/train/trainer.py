"""Training loop with checkpoint/restart (``repro/train/trainer.py``).

Fault tolerance: an abort flag from the malicious checks discards the
step and resumes from the latest checkpoint; an injected crash point
stands in for a lost process.  PRF seeds are step-indexed
(``seed_for_step``), so a replayed step is bit-identical.  The step
function is engine-agnostic and returns ``(new_params, loss, abort)``;
``secure_sgd.run_step`` (inline, in either world) and
``secure_sgd.PrepAheadSGD`` (online-only from a ``ContinuousDealer``)
plug in unchanged.

The joint simulation's twin-trace helper ``split_offline_online`` is not
ported: it needs the joint context's ``offline``/``online`` modes' kernel
routes, which come later.  Nor is the JAX trainer's unused
offline-material queue (``offline_buffer``): the ``ContinuousDealer``
keeps the look-ahead window.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Callable

import numpy as np

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
        self.params = {k: np.asarray(v) for k, v in restored.items()}
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
                    self.params = restored
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
