#!/usr/bin/env python3
"""The LM stack's serving path, port against the JAX package, bit for bit.

    PYTHONPATH=src python3 tools/torch_lm_vs_jax.py [--archs qwen3_1_7b,...]
        [--layers 1] [--modes collapsed,faithful]

For each case's SMOKE config and each mode of the joint simulation
(faithful, or collapsed), runs ``serve_prefill`` and ``serve_decode``
through the JAX package's ``TridentEngine`` and through the port's on the
CPU, from the same weights (``init_params(cfg, 0)``), ids and context
seed, and asserts equal logits words, equal cache words (every leaf),
equal ``totals()`` and equal abort flags.  The cases (all by default):

  the attention families (qwen3, mixtral, whisper, phi-3-vision), cut to
      ``--layers`` layers: (2, 8) ids and one decode step;
  the recurrent families, uncut (zamba2: two retention groups of 2, the
      shared block applied twice; xlstm: one mLSTM + sLSTM pair): (2, 16)
      ids, two chunks of seq_chunk 8, and two decode steps;
  ``zamba2_7b+long_ctx``: zamba2 served with ``long_ctx=True`` and
      long_window 12, below the prefill, so the shared block's cache
      keeps its last 12 positions;
  ``mixtral_8x7b+long_ctx``: mixtral at ``--layers`` layers, served with
      ``long_ctx=True``: long_window 12 widens its SMOKE window of 4 and
      lies below the prefill.  A long_ctx case serves as the recurrent
      families do: (2, 16) ids and two decode steps.

Prints one line a (case, mode) with its walls and the digest of the JAX
run's words (``digest``), then one JSON line.  The digests of the
collapsed runs (at one layer for the attention families) are pinned in
``tests/test_torch_lm.py``, which holds the port's serve to them.

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
# the recurrent families and the long_ctx cases: two chunks of SMOKE's
# seq_chunk 8, so the state crosses a chunk boundary (and the prefill
# LONG_WINDOW), then two decode steps
RECURRENT = ("zamba2_7b", "xlstm_350m")
RECURRENT_IDS_SHAPE = (2, 16)
RECURRENT_DECODE_STEPS = 2
LONG = "+long_ctx"
LONG_WINDOW = 12
CASES = ("qwen3_1_7b", "mixtral_8x7b", "whisper_tiny", "phi_3_vision_4_2b",
         "zamba2_7b", "xlstm_350m", "zamba2_7b" + LONG,
         "mixtral_8x7b" + LONG)


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


def run_jax(case: str, layers: int, collapse: bool):
    from repro.configs import get
    from repro.core.context import make_context
    from repro.core.ring import RING64
    from repro.nn import model as JM
    from repro.nn.engine import TridentEngine
    ctx = make_context(RING64, seed=SEED, collapse=collapse)
    run = _serve(JM, get, TridentEngine(ctx), case, layers)
    return run + (ctx.tally.totals(), bool(ctx.abort_flag()))


def run_port(case: str, layers: int, collapse: bool):
    from repro_torch.configs import get
    from repro_torch.core.context import make_context
    from repro_torch.core.ring import RING64
    from repro_torch.nn import model as TM
    from repro_torch.nn.engine import TridentEngine
    ctx = make_context(RING64, seed=SEED, collapse=collapse, device="cpu")
    run = _serve(TM, get, TridentEngine(ctx), case, layers)
    return run + (ctx.tally.totals(), ctx.abort_flag())


def _serve(M, get, eng, case: str, layers: int) -> tuple:
    """One case through model module `M` on `eng`: (prefill logits, its
    caches, the last decode step's logits, its caches)."""
    cfg, long_ctx = case_config(get, case, layers)
    ids, kw = _inputs(cfg, eng, long_ctx)
    params = M.params_to_engine(eng, M.init_params(cfg, 0))
    logits, caches = M.serve_prefill(eng, cfg, params, ids, long_ctx=long_ctx,
                                     **kw)
    out = (logits, caches)
    for t in range(_steps(cfg, long_ctx)):
        out = M.serve_decode(eng, cfg, params, ids[:, -1:], out[1],
                             pos=_pos(cfg, long_ctx) + t, long_ctx=long_ctx)
    return (logits, caches) + tuple(out)


def case_config(get, case: str, layers: int) -> tuple:
    """(the case's SMOKE config, long_ctx) from a configs module's `get`."""
    arch = case[:-len(LONG)] if case.endswith(LONG) else case
    cfg = get(arch).SMOKE
    if arch not in RECURRENT:
        cfg = dataclasses.replace(
            cfg, n_layers=layers,
            n_encoder_layers=min(cfg.n_encoder_layers, layers))
    if case.endswith(LONG):
        return dataclasses.replace(cfg, long_window=LONG_WINDOW), True
    return cfg, False


def _long_run(cfg, long_ctx) -> bool:
    """A recurrent family or a long_ctx case: RECURRENT_IDS_SHAPE ids and
    RECURRENT_DECODE_STEPS decode steps."""
    return long_ctx or cfg.family in ("hybrid", "ssm")


def _ids_shape(cfg, long_ctx) -> tuple:
    return RECURRENT_IDS_SHAPE if _long_run(cfg, long_ctx) else IDS_SHAPE


def _steps(cfg, long_ctx) -> int:
    return RECURRENT_DECODE_STEPS if _long_run(cfg, long_ctx) else 1


def _pos(cfg, long_ctx) -> int:
    return _ids_shape(cfg, long_ctx)[1] + (
        cfg.frontend_tokens if cfg.family == "vlm" else 0)


def _inputs(cfg, eng, long_ctx):
    ids = np.random.RandomState(1).randint(0, cfg.vocab,
                                           size=_ids_shape(cfg, long_ctx))
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
    ap.add_argument("--archs", default=",".join(CASES),
                    help="cases: arch ids, an arch + '+long_ctx'")
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
