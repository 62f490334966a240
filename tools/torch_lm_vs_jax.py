#!/usr/bin/env python3
"""The LM stack's serving path and its train step, port against the JAX
package, bit for bit.

    PYTHONPATH=src python3 tools/torch_lm_vs_jax.py [--archs qwen3_1_7b,...]
        [--layers 1] [--modes collapsed,faithful] [--train]

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

``--train``: the train step instead (``TRAIN_CASES`` by default): each
case's SMOKE config at ``--layers`` layers (the recurrent families
uncut, as above), ``init_params(cfg, 0)``, one ``train_step`` of (2, 8)
ids and labels (the recurrent families (2, 16): two chunks; with the
frontend's embeddings) at lr 2^-6 through both packages on the same
context seed; asserts equal new params (every leaf's words), loss,
``totals()`` and abort flag.  The cases: the four attention families;
``qwen3_1_7b+remat`` (cfg.remat: the reverse loop re-runs each layer's
forward); ``mixtral_8x7b+dense`` (dense routing);
``qwen3_1_7b+microbatch`` (cfg.microbatch 2); zamba2 (the shared
block's gradient summed over its two uses) and xlstm;
``qwen3_1_7b+momentum``: two steps through each package's
``train.optim.Momentum`` (lr 2^-6, beta 0.875), the new params and the
momentum buffers compared, both losses.  The JAX
package's microbatched step scales each stacked grads leaf as a share
whose component axis is the layer axis (ROADMAP F5: its new params come
out (4, 4, ...)); for that case the JAX run's ``_tree_scale`` is replaced,
in this process only, by one that scales a stacked leaf as one (n, ...)
share, as its ``_stacked_upd`` updates it and as the port does.  The
collapsed runs' digests (``train_digest``) are pinned in
``tests/test_torch_lm_train.py``.

The JAX reference compiles every ``lax.scan`` body, so a run takes minutes
(about 85 s for qwen3 collapsed at one layer on one CPU, a train step
about 155 s): too slow for the tier-1 tests, which run only the port and
compare its digest.
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


TRAIN_CASES = ("qwen3_1_7b", "mixtral_8x7b", "whisper_tiny",
               "phi_3_vision_4_2b", "qwen3_1_7b+remat",
               "mixtral_8x7b+dense", "qwen3_1_7b+microbatch",
               "zamba2_7b", "xlstm_350m", "qwen3_1_7b+momentum")
TRAIN_LR = 2.0 ** -6
MOMENTUM_STEPS = 2


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


def train_config(get, case: str, layers: int):
    """A train case's SMOKE config at `layers` layers (the recurrent
    families uncut), with its variant ("+remat", "+dense", "+microbatch",
    "+momentum")."""
    arch, _, variant = case.partition("+")
    cfg = get(arch).SMOKE
    if arch not in RECURRENT:
        cfg = dataclasses.replace(cfg, n_layers=layers, n_encoder_layers=min(
            cfg.n_encoder_layers, layers))
    change = {"": {}, "remat": {"remat": True},
              "dense": {"moe_routing": "dense"},
              "microbatch": {"microbatch": 2}, "momentum": {}}[variant]
    return dataclasses.replace(cfg, **change)


def train_inputs(cfg, eng):
    """(ids, labels, frontend kwargs) of a train case: (2, 8) each, the
    recurrent families' (2, 16)."""
    rs = np.random.RandomState(1)
    shape = _ids_shape(cfg, False)
    ids = rs.randint(0, cfg.vocab, size=shape)
    labels = rs.randint(0, cfg.vocab, size=shape)
    return ids, labels, _inputs(cfg, eng, False)[1]


def _train(M, O, get, eng, case: str, layers: int) -> tuple:
    """One case through model module `M` (optimizer module `O`): (the new
    params, or for "+momentum" {"params": ..., "momentum": ...}, the
    loss, or the steps' losses, float32)."""
    cfg = train_config(get, case, layers)
    ids, labels, kw = train_inputs(cfg, eng)
    params = M.params_to_engine(eng, M.init_params(cfg, 0))

    def f32(loss):
        return np.float32(np.asarray(
            loss.cpu() if hasattr(loss, "cpu") else loss))

    if not case.endswith("+momentum"):
        new, loss, _ = M.train_step(eng, cfg, params, ids, labels,
                                    lr=TRAIN_LR, **kw)
        return new, f32(loss)
    opt = O.Momentum(lr=TRAIN_LR)
    state, losses = opt.init(eng, params), []
    for _ in range(MOMENTUM_STEPS):
        params, loss, state = M.train_step(eng, cfg, params, ids, labels,
                                           optimizer=opt, opt_state=state,
                                           **kw)
        losses.append(f32(loss))
    return {"params": params, "momentum": state}, np.float32(losses)


def _jax_tree_scale_f5(eng, grads, c):
    """The JAX package's ``_tree_scale`` with ROADMAP F5 fixed: a stacked
    segment leaf scaled as one (n, ...) share (its component axis moved
    first and back, as ``_stacked_upd`` does), in the same leaf order."""
    import jax
    import jax.numpy as jnp
    from repro.core.shares import AShare
    from repro.nn import model as JM

    def one(x):
        return eng.scale(x, c)

    def stacked(x):
        r = eng.scale(AShare(jnp.moveaxis(x.data, 0, 1)), c)
        return AShare(jnp.moveaxis(r.data, 0, 1))

    out = {}
    for key in sorted(grads):
        if key == "segments":
            out[key] = [None if g is None else jax.tree_util.tree_map(
                stacked, g, is_leaf=JM._is_tensor) for g in grads[key]]
        else:
            out[key] = jax.tree_util.tree_map(one, grads[key],
                                              is_leaf=JM._is_tensor)
    return out


def run_jax_train(case: str, layers: int, collapse: bool):
    from repro.configs import get
    from repro.core.context import make_context
    from repro.core.ring import RING64
    from repro.nn import model as JM
    from repro.nn.engine import TridentEngine
    from repro.train import optim as JO
    ctx = make_context(RING64, seed=SEED, collapse=collapse)
    orig = JM._tree_scale
    if case.endswith("+microbatch"):
        JM._tree_scale = _jax_tree_scale_f5
    try:
        run = _train(JM, JO, get, TridentEngine(ctx), case, layers)
    finally:
        JM._tree_scale = orig
    return run + (ctx.tally.totals(), bool(ctx.abort_flag()))


def run_port_train(case: str, layers: int, collapse: bool):
    from repro_torch.configs import get
    from repro_torch.core.context import make_context
    from repro_torch.core.ring import RING64
    from repro_torch.nn import model as TM
    from repro_torch.nn.engine import TridentEngine
    from repro_torch.train import optim as TO
    ctx = make_context(RING64, seed=SEED, collapse=collapse, device="cpu")
    run = _train(TM, TO, get, TridentEngine(ctx), case, layers)
    return run + (ctx.tally.totals(), ctx.abort_flag())


def train_digest(run) -> str:
    """sha256 of a train run: every new-params leaf's path, shape and
    words (tree order; "+momentum": the params' and the buffers'), the
    losses' float32 bytes, ``totals()`` and the abort flag."""
    h = hashlib.sha256()
    for path, x in _leaves(run[0]):
        if x is None:                    # a shared_attn segment's entry
            h.update(f"{path}None".encode())
            continue
        w = np.ascontiguousarray(_words(x))
        h.update(f"{path}{w.shape}".encode())
        h.update(w.tobytes())
    h.update(np.float32(run[1]).tobytes())
    h.update(json.dumps([run[2], run[3]], sort_keys=True).encode())
    return h.hexdigest()


def compare_train(j, t) -> list:
    """The differences between two train runs (empty: equal)."""
    bad = []
    la, lb = list(_leaves(j[0])), list(_leaves(t[0]))
    if [p for p, _ in la] != [p for p, _ in lb]:
        return ["new params: tree layouts differ"]
    for (path, x), (_, y) in zip(la, lb):
        wx, wy = _words(x), _words(y)
        if wx.shape != wy.shape or not np.array_equal(wx, wy):
            first = None if wx.shape != wy.shape else \
                np.argwhere(wx != wy)[0].tolist()
            bad.append(f"new params{path}: words differ (shapes {wx.shape} "
                       f"/ {wy.shape}, first at {first})")
    if not np.array_equal(np.float32(j[1]), np.float32(t[1])):
        bad.append(f"losses differ: {j[1]} / {t[1]}")
    if j[2] != t[2]:
        bad.append(f"totals() differ: {j[2]} / {t[2]}")
    if j[3] != t[3]:
        bad.append(f"abort flags differ: {j[3]} / {t[3]}")
    return bad


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--archs", default=None,
                    help="cases: arch ids, an arch + '+long_ctx' (with "
                         "--train: + '+remat', '+dense', '+microbatch', "
                         "'+momentum')")
    ap.add_argument("--layers", type=int, default=1)
    ap.add_argument("--modes", default="collapsed,faithful")
    ap.add_argument("--train", action="store_true",
                    help="the train step instead of the serve")
    args = ap.parse_args()
    import torch
    torch.set_num_threads(1)
    if args.train:
        runs = (run_jax_train, run_port_train, compare_train, train_digest,
                TRAIN_CASES)
    else:
        runs = (run_jax, run_port, compare, digest, CASES)
    jax_run, port_run, cmp, dig, cases = runs
    results = []
    for arch in (args.archs.split(",") if args.archs else cases):
        for mode in args.modes.split(","):
            collapse = mode == "collapsed"
            t0 = time.perf_counter()
            j = jax_run(arch, args.layers, collapse)
            t1 = time.perf_counter()
            t = port_run(arch, args.layers, collapse)
            t2 = time.perf_counter()
            bad = cmp(j, t)
            results.append({"arch": arch, "mode": mode,
                            "layers": args.layers, "equal": not bad,
                            "differences": bad[:10],
                            "totals": t[-2], "abort": t[-1],
                            "jax_digest": dig(j),
                            "jax_s": round(t1 - t0, 1),
                            "port_s": round(t2 - t1, 1)})
            print(f"{arch} {mode}: {'EQUAL' if not bad else 'DIFFER'} "
                  f"(JAX {t1 - t0:.1f} s, port {t2 - t1:.1f} s; abort "
                  f"{t[-1]}; totals {t[-2]}; JAX digest {dig(j)})",
                  flush=True)
            for line in bad[:10]:
                print(f"  {line}", flush=True)
    print(json.dumps({"torch_lm_vs_jax": results, "train": args.train}))
    return 0 if all(r["equal"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
