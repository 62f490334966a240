#!/usr/bin/env python3
"""How far the secure LM serve lies from float64: the rehearsal behind the
logit tolerances of ``tests/test_torch_lm.py`` and ``chip_smoke.py``'s
phase lm.

    PYTHONPATH=src python3 tools/torch_lm_rehearsal.py [--device cpu]
        [--embed-scale 25] [--seeds 3]

Runs ``serve_prefill`` and decode steps through the port's
``TridentEngine`` (faithful and collapsed) and its ``PlainEngine``
(float64) from the same weights and ids, and prints, for each case, the
largest logit error, the largest logit and the error's relative L2 norm,
prefill and decode steps apart; then one JSON line.  Cases: the four
attention families' SMOKE configs cut to one layer at (2, 8) ids, one
decode step (the tests' case), and qwen3-1.7b at a middle width: qwen3's
CONFIG with d_model 256, 4 heads and 2 KV heads of 64, d_ff 768, vocab
4096, 2 layers, q_chunk 64, prefill of 128 ids and 3 decode steps (the
smoke's full-width run at a tenth of its width and an eighth of its
prefill).

The embedding table is multiplied by ``--embed-scale`` (25: entries of
scale 0.5, as the tests and the smoke serve them).  At 1 (``init_params``'
scale 0.02) the error is fixed point's (13 fractional bits): rmsnorm's
mean square of such embeddings is a few units of 2^-13, so its rsqrt is
off by tens of percent and the layers carry that on; the secure logits
then lie as far from float64 as logits of their own size.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np


def middle_width():
    from repro_torch.configs import get
    return dataclasses.replace(
        get("qwen3_1_7b").CONFIG, n_layers=2, d_model=256, n_heads=4,
        n_kv_heads=2, d_head=64, d_ff=768, vocab=4096, q_chunk=64)


def serve_run(eng, cfg, params, ids, steps: int, extra=None):
    """Logits of the prefill and of `steps` decode steps, each fed
    ids[:, -1] again."""
    from repro_torch.nn import model as M
    pe = M.params_to_engine(eng, params)
    kw = {} if extra is None else extra(eng)
    lg, caches = M.serve_prefill(eng, cfg, pe, ids, **kw)
    out = [lg]
    pos = ids.shape[1] + (cfg.frontend_tokens if cfg.family == "vlm"
                          else 0)
    for t in range(steps):
        lg, caches = M.serve_decode(eng, cfg, pe, ids[:, -1:], caches,
                                    pos + t)
        out.append(lg)
    return out


def frontend(cfg, batch: int):
    rs = np.random.RandomState(2)
    if cfg.family == "vlm":
        fe = rs.randn(batch, cfg.frontend_tokens, cfg.d_model) * 0.5
        return lambda eng: {"frontend_embs": eng.from_plain(fe)}
    if cfg.family == "encdec":
        enc = rs.randn(batch, cfg.frontend_tokens, cfg.d_model) * 0.5
        return lambda eng: {"enc_inputs": eng.from_plain(enc)}
    return None


def errors(plain: list, secure: list, eng) -> list:
    rows = []
    for p, s in zip(plain, secure):
        p = p.double().cpu().numpy()
        s = eng.to_plain(s).double().cpu().numpy()
        rows.append({"max_abs_err": float(np.abs(p - s).max()),
                     "max_abs_logit": float(np.abs(p).max()),
                     "rel_l2": float(np.linalg.norm(p - s)
                                     / np.linalg.norm(p))})
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--embed-scale", type=float, default=25.0)
    args = ap.parse_args()
    import torch
    from repro_torch.configs import get
    from repro_torch.core.context import make_context
    from repro_torch.core.ring import RING64
    from repro_torch.nn import model as M
    from repro_torch.nn.engine import PlainEngine, TridentEngine
    torch.set_num_threads(4)

    cases = []
    for arch in ("qwen3_1_7b", "mixtral_8x7b", "whisper_tiny",
                 "phi_3_vision_4_2b"):
        cfg = get(arch).SMOKE
        cfg = dataclasses.replace(cfg, n_layers=1, n_encoder_layers=min(
            cfg.n_encoder_layers, 1))
        cases.append((f"{arch} SMOKE 1 layer", cfg, (2, 8), 1))
    cases.append(("qwen3_1_7b middle width", middle_width(), (1, 128), 3))

    results = []
    for name, cfg, shape, steps in cases:
        for mode in ("faithful", "collapsed"):
            for seed in range(args.seeds):
                t0 = time.perf_counter()
                params = M.init_params(cfg, seed)
                params["embed"]["table"] *= args.embed_scale
                ids = np.random.RandomState(100 + seed).randint(
                    0, cfg.vocab, size=shape)
                extra = frontend(cfg, shape[0])
                plain = serve_run(PlainEngine(device=args.device), cfg,
                                  params, ids, steps, extra)
                ctx = make_context(RING64, seed=seed,
                                   collapse=mode == "collapsed",
                                   device=args.device)
                eng = TridentEngine(ctx)
                secure = serve_run(eng, cfg, params, ids, steps, extra)
                rows = errors(plain, secure, eng)
                r = {"case": name, "mode": mode, "seed": seed,
                     "abort": ctx.abort_flag(), "steps": rows,
                     "max_abs_err": max(x["max_abs_err"] for x in rows),
                     "max_rel_l2": max(x["rel_l2"] for x in rows),
                     "max_err_per_logit": max(x["max_abs_err"]
                                              / x["max_abs_logit"]
                                              for x in rows),
                     "s": round(time.perf_counter() - t0, 1)}
                results.append(r)
                print(f"{name} {mode} seed {seed}: max |err| "
                      f"{r['max_abs_err']:.4f} (largest logit "
                      f"{max(x['max_abs_logit'] for x in rows):.4f}, "
                      f"ratio {r['max_err_per_logit']:.5f}), "
                      f"relative L2 {r['max_rel_l2']:.4f}, abort "
                      f"{r['abort']} ({r['s']} s)", flush=True)
    print(json.dumps({"torch_lm_rehearsal": results,
                      "embed_scale": args.embed_scale,
                      "max_rel_l2": max(r["max_rel_l2"] for r in results),
                      "max_err_per_logit": max(r["max_err_per_logit"]
                                               for r in results)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
