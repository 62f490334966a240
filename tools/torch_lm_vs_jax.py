#!/usr/bin/env python3
"""The LM stack's serving path, port against the JAX package, bit for bit.

    PYTHONPATH=src python3 tools/torch_lm_vs_jax.py [--archs qwen3_1_7b,...]
        [--layers 1] [--modes collapsed,faithful]

For each arch's SMOKE config (by default the four attention families the
port serves), cut to ``--layers`` layers, and each mode of
the joint simulation (faithful, or collapsed), runs ``serve_prefill`` of
(2, 8) token ids and one ``serve_decode`` step through the JAX package's
``TridentEngine`` and through the port's on the CPU, from the same weights
(``init_params(cfg, 0)``), ids and context seed, and asserts equal logits
words, equal cache words (every leaf), equal ``totals()`` and equal abort
flags.  Prints one line an (arch, mode) with its walls and the digest of
the JAX run's words (``digest``), then one JSON line.  The digests of the
collapsed runs at one layer are pinned in ``tests/test_torch_lm.py``,
which holds the port's serve to them.

The JAX reference compiles every ``lax.scan`` body, so a run takes minutes
(about 85 s for qwen3 collapsed at one layer on one CPU): too slow for the
tier-1 tests, which run only the port and compare its digest.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import sys
import time

import numpy as np

SEED = 5
IDS_SHAPE = (2, 8)


def _words(x):
    import torch
    from repro_torch.core.ring import words_to_numpy
    x = getattr(x, "data", x)
    return words_to_numpy(x) if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from _leaves(t, f"{path}[{i}]")
    else:
        yield path, tree


def run_jax(cfg_name: str, layers: int, collapse: bool):
    from repro.configs import get
    from repro.core.context import make_context
    from repro.core.ring import RING64
    from repro.nn import model as JM
    from repro.nn.engine import TridentEngine
    cfg = _cut(get(cfg_name).SMOKE, layers)
    ctx = make_context(RING64, seed=SEED, collapse=collapse)
    eng = TridentEngine(ctx)
    ids, kw = _inputs(cfg, eng)
    params = JM.params_to_engine(eng, JM.init_params(cfg, 0))
    logits, caches = JM.serve_prefill(eng, cfg, params, ids, **kw)
    logits2, caches2 = JM.serve_decode(eng, cfg, params, ids[:, -1:], caches,
                                       pos=_pos(cfg))
    return (logits, caches, logits2, caches2, ctx.tally.totals(),
            bool(ctx.abort_flag()))


def run_port(cfg_name: str, layers: int, collapse: bool):
    from repro_torch.configs import get
    from repro_torch.core.context import make_context
    from repro_torch.core.ring import RING64
    from repro_torch.nn import model as TM
    from repro_torch.nn.engine import TridentEngine
    cfg = _cut(get(cfg_name).SMOKE, layers)
    ctx = make_context(RING64, seed=SEED, collapse=collapse, device="cpu")
    eng = TridentEngine(ctx)
    ids, kw = _inputs(cfg, eng)
    params = TM.params_to_engine(eng, TM.init_params(cfg, 0))
    logits, caches = TM.serve_prefill(eng, cfg, params, ids, **kw)
    logits2, caches2 = TM.serve_decode(eng, cfg, params, ids[:, -1:], caches,
                                       pos=_pos(cfg))
    return (logits, caches, logits2, caches2, ctx.tally.totals(),
            ctx.abort_flag())


def _cut(cfg, layers: int):
    return dataclasses.replace(
        cfg, n_layers=layers,
        n_encoder_layers=min(cfg.n_encoder_layers, layers))


def _pos(cfg) -> int:
    return IDS_SHAPE[1] + (cfg.frontend_tokens if cfg.family == "vlm" else 0)


def _inputs(cfg, eng):
    ids = np.random.RandomState(1).randint(0, cfg.vocab, size=IDS_SHAPE)
    rs = np.random.RandomState(2)
    kw = {}
    if cfg.family == "vlm":
        kw["frontend_embs"] = eng.from_plain(
            rs.randn(IDS_SHAPE[0], cfg.frontend_tokens, cfg.d_model) * 0.5)
    if cfg.family == "encdec":
        kw["enc_inputs"] = eng.from_plain(
            rs.randn(IDS_SHAPE[0], cfg.frontend_tokens, cfg.d_model) * 0.5)
    return ids, kw


def digest(run) -> str:
    """sha256 of a run's outputs: every leaf's path, shape and words
    (prefill logits, caches, decode logits, caches, in tree order), then
    ``totals()`` and the abort flag."""
    h = hashlib.sha256()
    for tree in run[:4]:
        for path, x in _leaves(tree):
            w = np.ascontiguousarray(_words(x))
            h.update(f"{path}{w.shape}".encode())
            h.update(w.tobytes())
    h.update(json.dumps([run[4], run[5]], sort_keys=True).encode())
    return h.hexdigest()


def compare(j, t) -> list:
    """The differences between the two runs' outputs (empty: equal)."""
    bad = []
    names = ("prefill logits", "prefill caches", "decode logits",
             "decode caches")
    for name, a, b in zip(names, j[:4], t[:4]):
        la, lb = list(_leaves(a)), list(_leaves(b))
        if [p for p, _ in la] != [p for p, _ in lb]:
            bad.append(f"{name}: tree layouts differ")
            continue
        for (path, x), (_, y) in zip(la, lb):
            wx, wy = _words(x), _words(y)
            if wx.shape != wy.shape or not np.array_equal(wx, wy):
                first = None if wx.shape != wy.shape else \
                    np.argwhere(wx != wy)[0].tolist()
                bad.append(f"{name}{path}: words differ (shapes "
                           f"{wx.shape} / {wy.shape}, first at {first})")
    if j[4] != t[4]:
        bad.append(f"totals() differ: {j[4]} / {t[4]}")
    if j[5] != t[5]:
        bad.append(f"abort flags differ: {j[5]} / {t[5]}")
    return bad


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--archs", default="qwen3_1_7b,mixtral_8x7b,"
                    "whisper_tiny,phi_3_vision_4_2b")
    ap.add_argument("--layers", type=int, default=1)
    ap.add_argument("--modes", default="collapsed,faithful")
    args = ap.parse_args()
    import torch
    torch.set_num_threads(1)
    results = []
    for arch in args.archs.split(","):
        for mode in args.modes.split(","):
            collapse = mode == "collapsed"
            t0 = time.perf_counter()
            j = run_jax(arch, args.layers, collapse)
            t1 = time.perf_counter()
            t = run_port(arch, args.layers, collapse)
            t2 = time.perf_counter()
            bad = compare(j, t)
            results.append({"arch": arch, "mode": mode,
                            "layers": args.layers, "equal": not bad,
                            "differences": bad[:10],
                            "totals": t[4], "abort": t[5],
                            "jax_digest": digest(j),
                            "jax_s": round(t1 - t0, 1),
                            "port_s": round(t2 - t1, 1)})
            print(f"{arch} {mode}: {'EQUAL' if not bad else 'DIFFER'} "
                  f"(JAX {t1 - t0:.1f} s, port {t2 - t1:.1f} s; abort "
                  f"{t[5]}; totals {t[4]}; JAX digest {digest(j)})",
                  flush=True)
            for line in bad[:10]:
                print(f"  {line}", flush=True)
    print(json.dumps({"torch_lm_vs_jax": results}))
    return 0 if all(r["equal"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
