#!/usr/bin/env python3
"""Kernel wrapper calls and operand shapes of one launcher step, on the
CPU, at a narrow width.

    PYTHONPATH=src python3 tools/torch_launch_counts.py [--arch whisper_tiny]
        [--batch 2] [--seq 5] [--d-model 24] [--d-head 4] [--d-ff 40]
        [--vocab 97] [--frontend 30]

Runs one secure train step of the arch's CONFIG (its depth, heads,
kinds and flags) with the named widths narrowed, collapsed, under the
launcher's PRF discipline (``launch.train``: the parameters shared under
seed 0, the step under ``seed_for_step(1, 0)``), and prints each kernel's
wrapper calls (``Kernel.calls``: on the card each call is one launch)
and the distinct operand shapes ``ops.mpc_matmul_fused`` and
``ops.ring_matmul`` were given.  The counts do not depend on the widths,
so they predict a full-width step's launches; the shapes map onto the
full width dimension by dimension.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="whisper_tiny")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=5)
    ap.add_argument("--d-model", type=int, default=24)
    ap.add_argument("--d-head", type=int, default=4)
    ap.add_argument("--d-ff", type=int, default=40)
    ap.add_argument("--vocab", type=int, default=97)
    ap.add_argument("--frontend", type=int, default=30)
    args = ap.parse_args()
    import torch
    from repro_torch.configs import get
    from repro_torch.core.context import make_context
    from repro_torch.core.ring import RING64
    from repro_torch.kernels import ops
    from repro_torch.launch import train as LT
    from repro_torch.nn import model as M
    from repro_torch.nn.engine import TridentEngine
    from repro_torch.train.data import TokenStream
    from repro_torch.train.trainer import seed_for_step
    torch.set_num_threads(4)
    cfg = dataclasses.replace(
        get(args.arch).CONFIG, d_model=args.d_model, d_head=args.d_head,
        d_ff=args.d_ff, vocab=args.vocab,
        frontend_tokens=args.frontend if get(args.arch).CONFIG.frontend
        else 0)
    share = TridentEngine(make_context(RING64, seed=LT.SHARE_SEED,
                                       collapse=True, device="cpu"))
    params = M.params_to_engine(share, M.init_params(cfg, seed=0))
    kw = {}
    key = {"vlm": "frontend_embs", "encdec": "enc_inputs"}.get(cfg.family)
    if key:
        kw[key] = share.from_plain(np.random.RandomState(0).randn(
            args.batch, cfg.frontend_tokens, cfg.d_model)
            * LT.FRONTEND_SCALE)
    ids, labels = TokenStream(cfg.vocab, 0).batch(0, args.batch, args.seq)
    seen = {"mpc_matmul_fused": set(), "ring_matmul": set()}
    orig = {name: getattr(ops, name) for name in seen}

    def recorder(name):
        def call(*a):
            seen[name].add(tuple(tuple(x.shape) for x in a))
            return orig[name](*a)
        return call

    for name in seen:
        setattr(ops, name, recorder(name))
    ops.reset_launches()
    ctx = make_context(RING64, seed=seed_for_step(LT.STEP_BASE_SEED, 0),
                       collapse=True, device="cpu")
    try:
        M.train_step(TridentEngine(ctx), cfg, params, ids, labels,
                     lr=2.0 ** -6, **kw)
    finally:
        for name, f in orig.items():
            setattr(ops, name, f)
    print(f"{cfg}")
    print(f"wrapper calls a step: { {k.name: k.calls for k in ops.KERNELS} }")
    for name, shapes in seen.items():
        print(f"{name}: {len(shapes)} distinct operand shapes")
        for s in sorted(shapes):
            print(f"  {s}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
