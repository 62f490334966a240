#!/usr/bin/env python3
"""How far the secure LM serve lies from float64: the rehearsal behind the
logit tolerances of ``tests/test_torch_lm.py`` and ``chip_smoke.py``'s
phases lm and lm-recurrent.

    PYTHONPATH=src python3 tools/torch_lm_rehearsal.py [--device cpu]
        [--embed-scale 25] [--seeds 3]

Runs ``serve_prefill`` and decode steps through the port's
``TridentEngine`` (faithful and collapsed) and its ``PlainEngine``
(float64) from the same weights and ids, and prints, for each case, the
largest logit error, the largest logit and the error's relative L2 norm,
prefill and decode steps apart, and the same against a float64 run whose
mean takes 1/n as fixed point encodes it (``fixed_mean_plain``: the error
left beside ROADMAP N3); then one JSON line.  Cases: the four
attention families' SMOKE configs cut to one layer at (2, 8) ids, one
decode step (the tests' case), and qwen3-1.7b at a middle width: qwen3's
CONFIG with d_model 256, 4 heads and 2 KV heads of 64, d_ff 768, vocab
4096, 2 layers, q_chunk 64, prefill of 128 ids and 3 decode steps (the
smoke's full-width run at a tenth of its width and an eighth of its
prefill); the recurrent families' SMOKE configs uncut at (2, 16) ids (two
chunks) and two decode steps, zamba2's also with ``long_ctx`` and
long_window 12; and both at a middle width (``recurrent_middle``):
their CONFIGs at d_model 256, 4 heads of 64, ssm_state 64, vocab 4096,
seq_chunk and q_chunk 64, zamba2 2 layers (d_ff 1024) and xlstm 4 (two
pairs), prefill of 128 ids (two chunks) and 3 decode steps, zamba2's
also with ``long_ctx`` and long_window 64.

``--cases recurrent`` runs only the recurrent families' cases;
``--widths 256,512,1024`` runs their middle-width cases at each d_model
(zamba2 with d_model / 128 heads past 512) and ``--prefill 1024`` with
the smoke's 1,024 ids (long_window half the prefill).  ``--cases full
--device cuda`` runs only chip_smoke.py's full-width main paths of them
(``full_cases``: a card's size, 17 GB of zamba2 shares).  It prints first
how far the secure rmsnorm's output lies from float64 at d_model 1,024,
2,048 and 3,584 (``rmsnorm_scale``, ROADMAP N3).

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


def recurrent_middle(arch: str, d_model: int = 256):
    """zamba2-7b's or xlstm-350m's CONFIG at `d_model` (zamba2: heads of
    at most 128, d_ff 4 x d_model; xlstm: its 4 heads)."""
    from repro_torch.configs import get
    heads = max(4, d_model // 128) if arch == "zamba2_7b" else 4
    return dataclasses.replace(
        get(arch).CONFIG, n_layers=2 if arch == "zamba2_7b" else 4,
        d_model=d_model, n_heads=heads, n_kv_heads=heads, ssm_state=64,
        d_ff=4 * d_model if arch == "zamba2_7b" else 0, vocab=4096,
        seq_chunk=64, q_chunk=64)


def recurrent_cases(get, widths: str, prefill: int) -> list:
    """The recurrent families' SMOKE cases and their middle widths."""
    zamba2 = get("zamba2_7b").SMOKE
    cases = [("zamba2_7b SMOKE", zamba2, (2, 16), 2, False),
             ("zamba2_7b SMOKE long_ctx",
              dataclasses.replace(zamba2, long_window=12), (2, 16), 2, True),
             ("xlstm_350m SMOKE", get("xlstm_350m").SMOKE, (2, 16), 2, False)]
    for d in map(int, widths.split(",")):
        z, x = recurrent_middle("zamba2_7b", d), recurrent_middle(
            "xlstm_350m", d)
        cases += [(f"zamba2_7b d_model {d}", z, (1, prefill), 3, False),
                  (f"zamba2_7b d_model {d} long_ctx",
                   dataclasses.replace(z, long_window=prefill // 2),
                   (1, prefill), 3, True),
                  (f"xlstm_350m d_model {d}", x, (1, prefill), 3, False)]
    return cases


def full_cases(get, prefill: int) -> list:
    """chip_smoke.py phase lm-recurrent's main paths (a card's size, not
    this machine's): zamba2-7b's CONFIG at 2 of 81 layers (also with
    long_ctx and long_window 512) and xlstm-350m's at 4 of 24, full width,
    `prefill` ids and 3 decode steps."""
    z = dataclasses.replace(get("zamba2_7b").CONFIG, n_layers=2)
    return [("zamba2_7b full width, 2 layers", z, (1, prefill), 3, False),
            ("zamba2_7b full width, 2 layers, long_ctx",
             dataclasses.replace(z, long_window=512), (1, prefill), 3, True),
            ("xlstm_350m full width, 4 layers", dataclasses.replace(
                get("xlstm_350m").CONFIG, n_layers=4), (1, prefill), 3,
             False)]


def fixed_mean_plain(device: str):
    """A float64 PlainEngine whose mean multiplies the sum by 1/n as fixed
    point encodes it, round(2^13 / n) units of 2^-13 (as the secure
    engines do, ROADMAP N3): the error left beside it is the rest of fixed
    point's."""
    import torch
    from repro_torch.core.ring import RING64
    from repro_torch.nn.engine import PlainEngine

    class FixedMeanPlain(PlainEngine):
        def mean(self, x, axis, keepdims=False):
            inv = round(RING64.scale / x.shape[axis]) / RING64.scale
            return torch.sum(x, dim=axis, keepdim=keepdims) * inv

    return FixedMeanPlain(device=device)


def rmsnorm_scale(d: int, device: str) -> float:
    """The secure rmsnorm's output over the float64 one (median over 4 x
    d unit-normal entries): fixed point encodes rmsnorm's 1/d as
    round(2^13 / d) units of 2^-13, exact only where d divides 2^13
    (ROADMAP N3)."""
    from repro_torch.core.context import make_context
    from repro_torch.core.ring import RING64
    from repro_torch.nn import layers as L
    from repro_torch.nn.engine import PlainEngine, TridentEngine
    x = np.random.RandomState(0).randn(1, 4, d)
    g = np.ones(d)
    te = TridentEngine(make_context(RING64, seed=0, device=device))
    pe = PlainEngine(device=device)
    ys, _ = L.rmsnorm_fwd(te, {"g": te.from_plain(g)}, te.from_plain(x))
    yp, _ = L.rmsnorm_fwd(pe, {"g": pe.from_plain(g)}, pe.from_plain(x))
    return float(np.median(te.to_plain(ys).cpu().numpy()
                           / yp.cpu().numpy()))


def serve_run(eng, cfg, params, ids, steps: int, extra=None,
              long_ctx=False):
    """Logits of the prefill and of `steps` decode steps, each fed
    ids[:, -1] again."""
    from repro_torch.nn import model as M
    pe = M.params_to_engine(eng, params)
    kw = {} if extra is None else extra(eng)
    lg, caches = M.serve_prefill(eng, cfg, pe, ids, long_ctx=long_ctx, **kw)
    out = [lg]
    pos = ids.shape[1] + (cfg.frontend_tokens if cfg.family == "vlm"
                          else 0)
    for t in range(steps):
        lg, caches = M.serve_decode(eng, cfg, pe, ids[:, -1:], caches,
                                    pos + t, long_ctx=long_ctx)
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
    ap.add_argument("--cases", default="all",
                    choices=("all", "recurrent", "full"))
    ap.add_argument("--widths", default="256")
    ap.add_argument("--prefill", type=int, default=128)
    args = ap.parse_args()
    import torch
    from repro_torch.configs import get
    from repro_torch.core.context import make_context
    from repro_torch.core.ring import RING64
    from repro_torch.nn import model as M
    from repro_torch.nn.engine import PlainEngine, TridentEngine
    torch.set_num_threads(4)

    print(json.dumps({"rmsnorm_scale": {
        d: rmsnorm_scale(d, args.device) for d in (1024, 2048, 3584)}}),
        flush=True)
    cases = []
    if args.cases == "full":
        cases = full_cases(get, args.prefill)
    elif args.cases == "all":
        for arch in ("qwen3_1_7b", "mixtral_8x7b", "whisper_tiny",
                     "phi_3_vision_4_2b"):
            cfg = get(arch).SMOKE
            cfg = dataclasses.replace(cfg, n_layers=1, n_encoder_layers=min(
                cfg.n_encoder_layers, 1))
            cases.append((f"{arch} SMOKE 1 layer", cfg, (2, 8), 1, False))
        cases.append(("qwen3_1_7b middle width", middle_width(), (1, 128), 3,
                      False))
    if args.cases != "full":
        cases += recurrent_cases(get, args.widths, args.prefill)

    results = []
    for name, cfg, shape, steps, long_ctx in cases:
        for seed in range(args.seeds):
            params = M.init_params(cfg, seed)
            params["embed"]["table"] *= args.embed_scale
            ids = np.random.RandomState(100 + seed).randint(
                0, cfg.vocab, size=shape)
            extra = frontend(cfg, shape[0])
            plain = serve_run(PlainEngine(device=args.device), cfg, params,
                              ids, steps, extra, long_ctx)
            plain_fm = serve_run(fixed_mean_plain(args.device), cfg, params,
                                 ids, steps, extra, long_ctx)
            for mode in ("faithful", "collapsed"):
                t0 = time.perf_counter()
                ctx = make_context(RING64, seed=seed,
                                   collapse=mode == "collapsed",
                                   device=args.device)
                eng = TridentEngine(ctx)
                secure = serve_run(eng, cfg, params, ids, steps, extra,
                                   long_ctx)
                rows = errors(plain, secure, eng)
                fixed = errors(plain_fm, secure, eng)
                r = {"case": name, "mode": mode, "seed": seed,
                     "abort": ctx.abort_flag(), "steps": rows,
                     "max_abs_err": max(x["max_abs_err"] for x in rows),
                     "max_rel_l2": max(x["rel_l2"] for x in rows),
                     "max_err_per_logit": max(x["max_abs_err"]
                                              / x["max_abs_logit"]
                                              for x in rows),
                     "fixed_mean_max_err_per_logit": max(
                         x["max_abs_err"] / x["max_abs_logit"]
                         for x in fixed),
                     "fixed_mean_max_rel_l2": max(x["rel_l2"]
                                                  for x in fixed),
                     "s": round(time.perf_counter() - t0, 1)}
                results.append(r)
                print(f"{name} {mode} seed {seed}: max |err| "
                      f"{r['max_abs_err']:.4f} (largest logit "
                      f"{max(x['max_abs_logit'] for x in rows):.4f}, "
                      f"ratio {r['max_err_per_logit']:.5f}), "
                      f"relative L2 {r['max_rel_l2']:.4f}; against float64 "
                      f"with fixed point's 1/n in the mean "
                      f"{r['fixed_mean_max_err_per_logit']:.5f} and "
                      f"{r['fixed_mean_max_rel_l2']:.4f}; abort "
                      f"{r['abort']} ({r['s']} s)", flush=True)
    print(json.dumps({"torch_lm_rehearsal": results,
                      "embed_scale": args.embed_scale,
                      "max_rel_l2": max(r["max_rel_l2"] for r in results),
                      "max_err_per_logit": max(r["max_err_per_logit"]
                                               for r in results)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
