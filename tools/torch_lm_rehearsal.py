#!/usr/bin/env python3
"""How far the secure LM serve and train step lie from float64: the
rehearsal behind the logit and gradient tolerances of
``tests/test_torch_lm.py``, ``tests/test_torch_lm_train.py`` and
``chip_smoke.py``'s phases lm, lm-recurrent and lm-train.

    PYTHONPATH=src python3 tools/torch_lm_rehearsal.py [--device cpu]
        [--embed-scale 25] [--seeds 3] [--train]

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

``--train``: the train step's ``loss_and_grads`` instead (``train_cases``:
the four attention families' SMOKE at one layer, (2, 8) ids and labels;
qwen3 at the middle width above, 2 layers, 128 ids; the recurrent
families' SMOKE uncut at (2, 16) ids (two chunks) and their middle widths
(``recurrent_middle`` at d_model 256, zamba2's shared block after each of
its 2 layers, 128 ids: two chunks); ``--cases recurrent`` only the
recurrent ones; with ``--cases full`` phi-3-vision-4.2b's CONFIG at 2 of
32 layers, 128 ids and 576 frontend embeddings, remat, chip_smoke.py
phase lm-train's step; with ``--cases full-recurrent``
(``full_recurrent_train_cases``) phase lm-recurrent-train's steps:
zamba2-7b's CONFIG at 2 of 81 layers with the shared block after each,
and xlstm-350m's at 8 of 24 layers, 512 ids each, remat).  For each case,
seed and mode it prints the gradient's gap (``grad_gap``: the relative
L2 error of all leaves together, the largest error over the largest
reference entry, the worst leaf's relative L2) and the loss's and the
dlogits' gaps, against float64 and against ``fixed_point_plain``, float64
with fixed point's mean behaviour.  Each secure truncation errs by -1
unit of 2^-13 on average, and the train step's sums pile that up: the
smx softmax over a vocabulary of V entries sums to about 1 - V / 8192,
and a weight gradient sums the bias of every token's dY.  So against
float64 the secure gradient is off by a multiple of itself from a
vocabulary of a few thousand on (ROADMAP N6); against the fixed-point
model only the truncations' zero-mean noise is left, and chip_smoke.py
phases lm-train and lm-recurrent-train hold the gradients there.  The
model reaches every truncation of the secure step: the recurrent blocks'
public decay contractions (``nn.recurrent._pub_left``) take the engine's
encoding and truncation hooks, which ``fixed_point_plain`` overrides.

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


def fixed_point_plain(device: str):
    """A float64 PlainEngine with fixed point's mean behaviour (ROADMAP
    N6): public constants and shared inputs rounded to units of 2^-13 as
    they are encoded, the garbled reciprocal and rsqrt rounded to units as
    their emulation rounds them, and each truncation (a truncating
    product, a public scale below 1, a mean) lowered by one unit, the
    mean error of the secure truncation (floor(z - r) + floor(r) - z over
    uniform fractions).  What is left between it and a secure run is the
    truncations' zero-mean noise; a plain float64 run also misses their
    bias, which the sums over tokens in a weight gradient and over the
    vocabulary in the softmax pile up."""
    import torch
    from repro_torch.core.ring import RING64
    from repro_torch.nn.engine import Engine, PlainEngine
    unit = 1.0 / RING64.scale

    def q(x):
        return torch.round(x * RING64.scale) * unit

    class FixedPointPlain(PlainEngine):
        def from_plain(self, x):
            return q(self._t(x))

        def _encode_public(self, c):
            return q(self._t(c))

        def matmul(self, x, w):
            return torch.matmul(x, w) - unit

        def mul(self, x, y):
            return x * y - unit

        def _truncate(self, x):
            return x - unit

        def mean(self, x, axis, keepdims=False):
            return Engine.mean(self, x, axis, keepdims)

        def softmax(self, x, axis=-1, mask=None):
            r, bit = self.relu(x)
            if mask is not None:
                r = r * self._t(mask)
            inv = self.reciprocal(torch.sum(r, dim=axis, keepdim=True)
                                  + self._encode_public(1e-2))
            p = self.mul(r, inv)
            return p, (p, inv, bit)

        def softmax_bwd(self, cache, dp, mask=None):
            p, inv, bit = cache
            inner = torch.sum(self.mul(dp, p), dim=-1, keepdim=True)
            dr = self.mul(dp - inner, inv)
            if mask is not None:
                dr = dr * self._t(mask)
            return dr * bit.to(self.dtype)

        def silu_bwd(self, cache, dy):
            x, s, seg = cache
            return self.mul(dy, s) + self.mul(dy, x) * seg.to(self.dtype)

        def rsqrt(self, x):
            y = q(torch.where(x <= 0, 0.0,
                              torch.rsqrt(torch.clamp_min(x, unit))))
            return y, (x, y)

        def reciprocal(self, x):
            return q(torch.where(x.abs() < unit, 0.0, 1.0 / torch.where(
                x == 0, 1.0, x)))

    return FixedPointPlain(device=device)


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


# phase lm-recurrent-train's main paths: the ids of a step (two chunks
# of the full configs' seq_chunk 256), and zamba2-7b's depth (its shared
# block after each layer)
RECURRENT_TRAIN_IDS = 512
RECURRENT_TRAIN_ZAMBA2_LAYERS = 2
# 4 of xlstm's 12 pairs: the smoke's whole run stays well inside its limit
RECURRENT_TRAIN_XLSTM_LAYERS = 8


def full_recurrent_train_cases(get) -> list:
    """(name, cfg, (batch, ids)) of chip_smoke.py phase lm-recurrent-
    train's main paths (a card's size): zamba2-7b's CONFIG at 2 of 81
    layers with ``shared_attn_every=1`` (retention 1, the shared block,
    retention 1, the shared block: its gradient summed over two uses) and
    xlstm-350m's CONFIG at RECURRENT_TRAIN_XLSTM_LAYERS of 24 layers (4 of
    12 pairs), full width, remat, RECURRENT_TRAIN_IDS ids at batch 1."""
    z = dataclasses.replace(get("zamba2_7b").CONFIG,
                            n_layers=RECURRENT_TRAIN_ZAMBA2_LAYERS,
                            shared_attn_every=1)
    shape = (1, RECURRENT_TRAIN_IDS)
    return [(f"zamba2_7b full width, {z.n_layers} layers, shared block "
             f"after each", z, shape),
            (f"xlstm_350m full width, {RECURRENT_TRAIN_XLSTM_LAYERS} of 24 "
             f"layers", dataclasses.replace(
                 get("xlstm_350m").CONFIG,
                 n_layers=RECURRENT_TRAIN_XLSTM_LAYERS), shape)]


def train_cases(get, cases: str) -> list:
    """(name, cfg, (batch, ids)) of the train rehearsal (``--cases``)."""
    if cases == "full":
        cfg = dataclasses.replace(get("phi_3_vision_4_2b").CONFIG, n_layers=2)
        return [("phi_3_vision_4_2b full width, 2 layers", cfg, (1, 128))]
    if cases == "full-recurrent":
        return full_recurrent_train_cases(get)
    out = []
    if cases == "all":
        for arch in ("qwen3_1_7b", "mixtral_8x7b", "whisper_tiny",
                     "phi_3_vision_4_2b"):
            cfg = get(arch).SMOKE
            cfg = dataclasses.replace(cfg, n_layers=1, n_encoder_layers=min(
                cfg.n_encoder_layers, 1))
            out.append((f"{arch} SMOKE 1 layer", cfg, (2, 8)))
        out.append(("qwen3_1_7b middle width", middle_width(), (1, 128)))
    for arch in ("zamba2_7b", "xlstm_350m"):
        out.append((f"{arch} SMOKE", get(arch).SMOKE, (2, 16)))
    out.append(("zamba2_7b d_model 256, shared block after each",
                dataclasses.replace(recurrent_middle("zamba2_7b"),
                                    shared_attn_every=1), (1, 128)))
    out.append(("xlstm_350m d_model 256", recurrent_middle("xlstm_350m"),
                (1, 128)))
    return out


def loss_and_grads(eng, cfg, params, ids, labels, extra=None):
    """``model.loss_and_grads`` from the plain weights, through its seams
    (``forward``, ``loss_head``, ``backward``).  Returns (loss, {leaf path:
    float64 numpy gradient}, dlogits opened as a float64 tensor)."""
    from repro_torch.nn import model as M
    pe = M.params_to_engine(eng, params)
    kw = {} if extra is None else extra(eng)
    logits, cache = M.forward(eng, cfg, pe, ids, **kw)
    loss, dlogits = M.loss_head(eng, cfg, logits, labels,
                                logits.shape[-2] - ids.shape[1])
    del logits
    grads = M.backward(eng, cfg, pe, cache, dlogits)
    return float(loss), grads_plain(eng, grads), \
        eng.to_plain(dlogits).double()


def grads_plain(eng, grads) -> dict:
    """A grads (or params) tree as {leaf path: float64 tensor on the
    engine's device}; a secure stacked segment leaf (a share's data (n, 4,
    ...)) opened as (n, ...)."""
    import torch
    from repro_torch.core.shares import AShare
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], f"{path}/{k}")
        elif isinstance(t, (list, tuple)):
            for i, x in enumerate(t):
                walk(x, f"{path}[{i}]")
        elif t is not None:
            if isinstance(t, AShare) and path.startswith("/segments"):
                t = AShare(torch.movedim(t.data, 0, 1))
            out[path] = eng.to_plain(t).double()

    walk(grads, "")
    return out


def grad_gap(want: dict, got: dict) -> dict:
    """The gradient's gap, leaf by leaf (no copy of the whole tree): the
    relative L2 error of all leaves together, the largest error over the
    largest reference entry, the worst leaf's relative L2 (leaves with a
    nonzero reference norm)."""
    err2 = ref2 = err_max = ref_max = 0.0
    leaves = {}
    for k in sorted(want):
        w, d = want[k], got[k].to(want[k].device) - want[k]
        e2, r2 = float((d * d).sum()), float((w * w).sum())
        err2, ref2 = err2 + e2, ref2 + r2
        err_max = max(err_max, float(d.abs().max()))
        ref_max = max(ref_max, float(w.abs().max()))
        if r2 > 0:
            leaves[k] = (e2 / r2) ** 0.5
    worst = max(leaves, key=leaves.get)
    return {"rel_l2": (err2 / ref2) ** 0.5, "err_per_max": err_max / ref_max,
            "worst_leaf": worst, "worst_leaf_rel_l2": leaves[worst]}


def shuffled(grads: dict, seed: int = 0) -> dict:
    """Each leaf's entries permuted (a control the bounds must fail)."""
    import torch
    g = torch.Generator().manual_seed(seed)
    return {k: v.reshape(-1)[torch.randperm(v.numel(), generator=g).to(
        v.device)].reshape(v.shape) for k, v in grads.items()}


def train_main(args) -> int:
    """The --train rehearsal (module docstring)."""
    from repro_torch.configs import get
    from repro_torch.core.context import make_context
    from repro_torch.core.ring import RING64
    from repro_torch.nn import model as M
    from repro_torch.nn.engine import PlainEngine, TridentEngine
    results = []
    for name, cfg, shape in train_cases(get, args.cases):
        for seed in range(args.seeds):
            params = M.init_params(cfg, seed)
            params["embed"]["table"] *= args.embed_scale
            rs = np.random.RandomState(100 + seed)
            ids = rs.randint(0, cfg.vocab, size=shape)
            labels = rs.randint(0, cfg.vocab, size=shape)
            extra = frontend(cfg, shape[0])
            refs = {
                "float64": loss_and_grads(PlainEngine(device=args.device),
                                          cfg, params, ids, labels, extra),
                "fixed_point": loss_and_grads(fixed_point_plain(args.device),
                                              cfg, params, ids, labels,
                                              extra)}
            for mode in ("faithful", "collapsed"):
                t0 = time.perf_counter()
                ctx = make_context(RING64, seed=seed,
                                   collapse=mode == "collapsed",
                                   device=args.device)
                loss, grads, dlogits = loss_and_grads(
                    TridentEngine(ctx), cfg, params, ids, labels, extra)
                r = {"case": name, "mode": mode, "seed": seed,
                     "abort": ctx.abort_flag(), "loss": loss,
                     "s": round(time.perf_counter() - t0, 1)}
                for ref, (rloss, rgrads, rdl) in refs.items():
                    r[ref] = dict(grad_gap(rgrads, grads),
                                  loss_err=abs(rloss - loss),
                                  dlogits_rel_l2=float(
                                      (rdl - dlogits).norm() / rdl.norm()))
                results.append(r)
                print(f"{name} {mode} seed {seed}: loss {loss:.6f}; "
                      + "; ".join(
                          f"{ref}: rel L2 {r[ref]['rel_l2']:.4f}, "
                          f"err/max {r[ref]['err_per_max']:.4f}, worst "
                          f"{r[ref]['worst_leaf']} "
                          f"{r[ref]['worst_leaf_rel_l2']:.4f}, loss err "
                          f"{r[ref]['loss_err']:.2e}, dlogits rel L2 "
                          f"{r[ref]['dlogits_rel_l2']:.4f}" for ref in refs)
                      + f"; abort {r['abort']} ({r['s']} s)", flush=True)
    print(json.dumps({"torch_lm_rehearsal_train": results,
                      "embed_scale": args.embed_scale}))
    return 0


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
                    choices=("all", "recurrent", "full",
                             "full-recurrent"))
    ap.add_argument("--widths", default="256")
    ap.add_argument("--prefill", type=int, default=128)
    ap.add_argument("--train", action="store_true",
                    help="the train step's gradients instead of the serve")
    args = ap.parse_args()
    import torch
    from repro_torch.configs import get
    from repro_torch.core.context import make_context
    from repro_torch.core.ring import RING64
    from repro_torch.nn import model as M
    from repro_torch.nn.engine import PlainEngine, TridentEngine
    torch.set_num_threads(4)
    if args.cases == "full-recurrent" and not args.train:
        ap.error("--cases full-recurrent is a --train case")
    if args.train:
        return train_main(args)

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
