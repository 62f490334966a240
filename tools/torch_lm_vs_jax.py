#!/usr/bin/env python3
"""The LM stack's serving path and its train step, port against the JAX
package, bit for bit.

    PYTHONPATH=src python3 tools/torch_lm_vs_jax.py [--archs qwen3_1_7b,...]
        [--layers 1] [--modes collapsed,faithful] [--train | --launch]

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

``--launch``: the LM launcher (``repro_torch.launch.train``) against
the JAX package.  (1) Its whisper-tiny SMOKE steps (``LAUNCH_STEPS``, batch
2, seq 8, lr 2^-6, ``TokenStream(vocab, 0)``, encoder inputs
``RandomState(0)`` x 0.1), run in JAX as the port's launcher runs them:
the parameters and inputs shared under seed 0, step k under its own
context seeded ``seed_for_step(1, k)``, collapsed, garbled; prints step
k's ``train_digest`` (new params, loss, the step's ``totals()``, abort)
and holds the port's launcher on the CPU to it; the digests are pinned in
``tests/test_torch_launch.py``.  (2) ROADMAP F7 in the reference: the JAX
launcher run for 1 step (it checkpoints step 0), then for 2 from the same
directory (it resumes at step 1): the new params' lambda words (every
component but m) of step 1 equal step 0's while their m words differ, the
same masks over other values; the port's launcher run the same way draws
other lambda words at step 1.

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
import os
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


LAUNCH_ARCH = "whisper_tiny"
LAUNCH_STEPS = 2
LAUNCH_BATCH, LAUNCH_SEQ = 2, 8


def run_jax_launch(steps: int = LAUNCH_STEPS) -> list:
    """The port launcher's PRF discipline in the JAX package: [(new
    params, loss, totals(), abort)] a step."""
    from repro.configs import get
    from repro.core.context import make_context
    from repro.core.ring import RING64
    from repro.nn import model as JM
    from repro.nn.engine import TridentEngine
    from repro.train.data import TokenStream
    from repro.train.trainer import seed_for_step
    cfg = get(LAUNCH_ARCH).SMOKE
    share = TridentEngine(make_context(RING64, seed=0, collapse=True))
    params = JM.params_to_engine(share, JM.init_params(cfg, seed=0))
    stream = TokenStream(vocab=cfg.vocab, seed=0)
    enc = share.from_plain(np.random.RandomState(0).randn(
        LAUNCH_BATCH, cfg.frontend_tokens, cfg.d_model) * 0.1)
    out = []
    for step in range(steps):
        ctx = make_context(RING64, seed=seed_for_step(1, step),
                           collapse=True)
        ids, labels = stream.batch(step, LAUNCH_BATCH, LAUNCH_SEQ)
        params, loss, _ = JM.train_step(TridentEngine(ctx), cfg, params, ids,
                                        labels, lr=TRAIN_LR, enc_inputs=enc)
        out.append((params, np.float32(np.asarray(loss)),
                    ctx.tally.totals(), bool(ctx.abort_flag())))
    return out


def launch_argv(ckpt: str, steps: int = LAUNCH_STEPS) -> list:
    return ["--arch", LAUNCH_ARCH, "--steps", str(steps), "--batch",
            str(LAUNCH_BATCH), "--seq", str(LAUNCH_SEQ), "--ckpt", ckpt]


def run_port_launch(ckpt: str, steps: int = LAUNCH_STEPS,
                    crash_at: int | None = None) -> tuple:
    """The port's launcher on the CPU: (launch, [(new params, loss,
    totals(), abort)] a step this process ran)."""
    from repro_torch.launch import train as LT
    launch = LT.build(LT.parse_args(launch_argv(ckpt, steps)
                                    + ["--device", "cpu"]))
    tr, runs = launch.trainer, []
    step_fn = tr.step_fn

    def recording(params, step, *batch):
        new, loss, abort = step_fn(params, step, *batch)
        runs.append((new, np.float32(loss), launch.step_totals[step], abort))
        return new, loss, abort

    tr.step_fn = recording
    try:
        tr.run(crash_at=crash_at)
    except RuntimeError as e:
        if crash_at is None or "injected crash" not in str(e):
            raise
    return launch, runs


def _update_words(before: list, after: list, ax: list) -> list:
    """Each leaf's update t = w - w' (the step subtracts t = lr * g from
    every weight, component by component): (lambda words, m words)."""
    out = []
    for x, y, a in zip(before, after, ax):
        t = x - y                        # uint64 words wrap
        out.append((np.take(t, [1, 2, 3], axis=a), np.take(t, 0, axis=a)))
    return out


def f7_demo(tmp: str) -> dict:
    """ROADMAP F7: each launcher run for 1 step (a checkpoint of step 0),
    then for 2 from the same directory (it resumes at step 1).  Step k's
    update words are the checkpoints' differences (step 0's from the
    shared initial params, which the port's sharing under seed 0 gives as
    the JAX package's does): the JAX launcher's step 1 reuses step 0's
    lambda words over other m words; the port's draws others."""
    from repro.launch import train as JL
    from repro_torch.configs import get
    from repro_torch.core.context import make_context
    from repro_torch.core.ring import RING64
    from repro_torch.nn import model as TM
    from repro_torch.nn.engine import TridentEngine
    from repro_torch.train import checkpoint as TCK
    cfg = get(LAUNCH_ARCH).SMOKE
    eng = TridentEngine(make_context(RING64, seed=0, collapse=True,
                                     device="cpu"))
    init = TM.params_to_engine(eng, TM.init_params(cfg, seed=0))
    leaves, _ = TCK._flatten(init)
    words = [TCK._host(x) for x in leaves]
    # the leaves in sorted key order: embed, final_norm, lm_head, then the
    # segments, whose data is (n, 4, ...): their component axis is 1
    first = len(TCK._flatten([init[k] for k in ("embed", "final_norm",
                                                "lm_head")])[0])
    n_seg = len(TCK._flatten(init["segments"])[0])
    ax = [1 if first <= i < first + n_seg else 0 for i in range(len(words))]
    out = {}
    for pkg in ("jax", "port"):
        d = os.path.join(tmp, pkg)
        for steps in (1, 2):
            if pkg == "jax":
                JL.main(launch_argv(d, steps))
            else:
                run_port_launch(d, steps)
        ck = []
        for k in (0, 1):
            with np.load(os.path.join(d, f"step_{k:08d}",
                                      "shard_0.npz")) as f:
                ck.append([f[f"leaf_{i}"] for i in range(len(words))])
        t0, t1 = _update_words(words, ck[0], ax), _update_words(ck[0], ck[1],
                                                                 ax)
        lam = sum(np.array_equal(a[0], b[0]) for a, b in zip(t0, t1))
        m = sum(np.array_equal(a[1], b[1]) for a, b in zip(t0, t1))
        out[pkg] = {"leaves": len(words), "lambda_equal": int(lam),
                    "m_equal": int(m)}
        print(f"F7 {pkg}: step 1's update against step 0's, {len(words)} "
              f"leaves: lambda words equal in {lam}, m words equal in {m}",
              flush=True)
    return out


def launch_main() -> int:
    """``--launch``: the digests, the port against them, F7."""
    import tempfile
    t0 = time.perf_counter()
    jruns = run_jax_launch()
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        _, truns = run_port_launch(os.path.join(tmp, "ck"))
        ok = True
        for step, (j, t) in enumerate(zip(jruns, truns)):
            bad = compare_train(j, t)
            ok = ok and not bad
            print(f"launch step {step}: {'EQUAL' if not bad else 'DIFFER'} "
                  f"(JAX digest {train_digest(j)}; totals {t[2]})",
                  flush=True)
            for line in bad[:10]:
                print(f"  {line}", flush=True)
        print(f"JAX {t1 - t0:.1f} s, port {time.perf_counter() - t1:.1f} s")
        f7 = f7_demo(tmp)
    shown = f7["jax"]["lambda_equal"] == f7["jax"]["leaves"] \
        and f7["jax"]["m_equal"] < f7["jax"]["leaves"] \
        and f7["port"]["lambda_equal"] == 0
    print(json.dumps({"launch_digests": [train_digest(j) for j in jruns],
                      "equal": ok, "f7": f7, "f7_shown": shown}))
    return 0 if ok and shown else 1


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
    ap.add_argument("--launch", action="store_true",
                    help="the LM launcher's steps and ROADMAP F7")
    args = ap.parse_args()
    import torch
    torch.set_num_threads(1)
    if args.launch:
        return launch_main()
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
