"""The LM training launcher (``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-tiny \
        [--smoke | --no-smoke] [--steps 10] [--batch 2] [--seq 8] \
        [--ckpt DIR] [--lr 0.015625] [--device cuda]

Secure train steps of an arch's SMOKE config (``--smoke``, the default)
or its full CONFIG (``--no-smoke``; the JAX launcher's ``--smoke`` can
never be turned off, ROADMAP D4) in the collapsed joint simulation with
the garbled nonlinear route, through a ``Trainer`` with checkpoints every
``max(steps // 2, 1)`` steps and restart.  The data is
``TokenStream(vocab, seed=0)``; the vlm's frontend embeddings and the
encdec's encoder inputs are ``RandomState(0)`` normals x 0.1, shared
once.  It runs on the card unless ``--device cpu`` is given; with no card
it raises.

PRF discipline (ROADMAP F7).  The context that shares the parameters and
the inputs is seeded ``SHARE_SEED`` (0, the JAX launcher's seed, so the
shared words are its words); step k runs under a context of its own,
seeded ``seed_for_step(STEP_BASE_SEED, k)`` = 1 + k, fresh counters
included.  So no two contexts of a run draw the same streams, and a step's
masks depend on its index only, never on what a process drew before it:
a run resumed from step k's checkpoint redraws step k + 1's streams over
the same restored words, the same words as an uninterrupted run, and a
resumed process's sharing context redraws the first process's streams
only over the same initial values, giving the same shares.  (The JAX
launcher keeps one context a process, its step function ignores the step
index, and a resumed process's first step draws the masks of the first
process's step 0, over other values.)

``build`` makes the run (``Launch``: config, trainer, per-step tallies);
``main`` runs it and prints the losses and the traffic.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import numpy as np

from .. import configs as CFGS
from ..core.context import make_context, resolve_device
from ..core.costs import LAN, WAN
from ..core.ring import RING64
from ..nn import model as M
from ..nn.engine import TridentEngine
from ..train import data as D
from ..train.trainer import Trainer, TrainerConfig, seed_for_step

SHARE_SEED = 0
STEP_BASE_SEED = SHARE_SEED + 1
FRONTEND_SCALE = 0.1


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=8)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "trident_lm_ckpt"))
    ap.add_argument("--lr", type=float, default=2.0 ** -6)
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def _sum_totals(totals: list) -> dict:
    out = {ph: {"rounds": 0, "bits": 0} for ph in ("offline", "online")}
    for t in totals:
        for ph, c in t.items():
            out[ph]["rounds"] += c["rounds"]
            out[ph]["bits"] += c["bits"]
    return out


@dataclasses.dataclass
class Launch:
    cfg: M.ModelConfig
    trainer: Trainer
    device: object
    inputs: dict                     # the shared frontend / encoder inputs
    step_totals: dict = dataclasses.field(default_factory=dict)
    step_aborts: dict = dataclasses.field(default_factory=dict)

    def totals(self) -> dict:
        """The traffic of the steps this process ran (a replayed step
        counted once)."""
        return _sum_totals(self.step_totals.values())


def build(args: argparse.Namespace) -> Launch:
    """The run `args` describe: the parameters shared on the device, the
    step function, the data and the trainer."""
    device = resolve_device(None if args.device == "cuda" else args.device)
    mod = CFGS.get(args.arch)
    cfg = mod.SMOKE if args.smoke else mod.CONFIG
    share_eng = TridentEngine(make_context(RING64, seed=SHARE_SEED,
                                           collapse=True, device=device))
    params = M.params_to_engine(share_eng, M.init_params(cfg, seed=0))
    stream = D.TokenStream(vocab=cfg.vocab, seed=0)
    rng = np.random.RandomState(0)
    inputs = {}
    key = {"vlm": "frontend_embs", "encdec": "enc_inputs"}.get(cfg.family)
    if key:
        inputs[key] = share_eng.from_plain(
            rng.randn(args.batch, cfg.frontend_tokens, cfg.d_model)
            * FRONTEND_SCALE)

    def step_fn(params, step, ids, labels):
        ctx = make_context(RING64, seed=seed_for_step(STEP_BASE_SEED, step),
                           collapse=True, device=device)
        new_params, loss, _ = M.train_step(TridentEngine(ctx), cfg, params,
                                           ids, labels, lr=args.lr,
                                           **inputs)
        launch.step_totals[step] = ctx.tally.totals()
        abort = ctx.abort_flag()
        launch.step_aborts[step] = abort
        return new_params, loss, abort

    trainer = Trainer(TrainerConfig(steps=args.steps, ckpt_dir=args.ckpt,
                                    ckpt_every=max(args.steps // 2, 1)),
                      step_fn, params,
                      lambda s: stream.batch(s, args.batch, args.seq))
    launch = Launch(cfg, trainer, device, inputs)
    return launch


def main(argv=None) -> Launch:
    args = parse_args(argv)
    launch = build(args)
    cfg, tr = launch.cfg, launch.trainer
    print(f"[train] {args.arch} ({'smoke' if args.smoke else 'full'}) "
          f"{cfg.n_layers}L d={cfg.d_model} family={cfg.family} on "
          f"{launch.device}")
    t0 = time.time()
    tr.run()
    print(f"[train] {args.steps} steps in {time.time() - t0:.1f}s; "
          f"losses: {['%.4f' % v for v in tr.losses[:3]]} ... "
          f"{['%.4f' % v for v in tr.losses[-3:]]}")
    online = launch.totals()["online"]
    r, b = online["rounds"], online["bits"]
    print(f"[train] cumulative online comm: {r} rounds, {b / 8e6:.1f} MB "
          f"(LAN {LAN.seconds(r, b):.2f}s / WAN {WAN.seconds(r, b):.0f}s)")
    print(f"[train] events: {tr.events}")
    return launch


if __name__ == "__main__":
    main()
