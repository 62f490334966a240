"""The port's LM training side (``repro_torch.nn.layers``' and
``blocks``' backward passes, ``recurrent.scan_loop``'s reverse order,
``model.backward``, ``loss_and_grads``, ``train_step`` and
``sgd_update``) against the JAX package's on the same seeds.  The layer
backward passes and the reverse loop seam run live against JAX, bit for
bit; the model's train step is held to the JAX package's pinned digests
(``JAX_TRAIN_DIGESTS``, printed by ``tools/torch_lm_vs_jax.py --train``):
a JAX LM train step compiles every scan body, too slow to run here.  The
recurrent blocks' backward passes run live in one item a mode, the
optimizers beside the collapsed one; four items: the suite's wall time is
held near its limit."""
import dataclasses
import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.core import protocols as JP  # noqa: E402
from repro.core.ring import RING64 as J64  # noqa: E402
from repro.core.shares import AShare as JShare  # noqa: E402
from repro.nn import blocks as JB  # noqa: E402
from repro.nn import layers as JL  # noqa: E402
from repro.nn import recurrent as JR  # noqa: E402
from repro_torch.configs import get as tget  # noqa: E402
from repro_torch.core import protocols as TP  # noqa: E402
from repro_torch.core.context import make_context as tmake  # noqa: E402
from repro_torch.core.ring import RING64 as T64  # noqa: E402
from repro_torch.core.shares import AShare as TShare  # noqa: E402
from repro_torch.nn import blocks as TB  # noqa: E402
from repro_torch.nn import layers as TL  # noqa: E402
from repro_torch.nn import model as TM  # noqa: E402
from repro_torch.nn import recurrent as TR  # noqa: E402
from repro_torch.nn.engine import PlainEngine as TPlain  # noqa: E402
from repro_torch.nn.engine import TridentEngine as TEngine  # noqa: E402
from test_torch_lm import (_attn, _both, _conv, _pair, _same,  # noqa: E402
                           _same_ctx, _vs_jax)

# The JAX package's train_step on its TridentEngine, collapsed, from
# init_params(cfg, 0) at context seed 5: each case's SMOKE config cut to
# one layer, one step of (2, 8) ids and labels (with the frontend's
# embeddings) at lr 2^-6; "+remat" with cfg.remat (the reverse loop
# re-runs the layer forward), "+dense" with dense MoE routing,
# "+microbatch" with cfg.microbatch 2 (the JAX run's _tree_scale fixed as
# ROADMAP F5 says, in the tool's process only); zamba2 and xlstm uncut
# (zamba2: two retention groups of 2, the shared block applied twice;
# xlstm: one mLSTM + sLSTM pair) with (2, 16) ids and labels (two
# chunks); "+momentum": two steps through train.optim.Momentum (lr 2^-6,
# beta 0.875), the buffers hashed beside the params.  The sha256 of the
# new params' words, the losses, totals() and the abort flag, as
# tools/torch_lm_vs_jax.py --train prints it (JAX 0.9.0 on the CPU; the
# tool holds the port's words to JAX's leaf by leaf, both modes).
JAX_TRAIN_DIGESTS = {
    "qwen3_1_7b":
        "5c8135bad8c64a786b4f0cc0481636504fd38653d00312d486210e04d3006ec7",
    "mixtral_8x7b":
        "63e63a798c0495cd1176c5516d40a8ffe4560184ceb91bcb9534809ad2505e39",
    "whisper_tiny":
        "bd508d9ff786eca312be073fb7b19f8c6ce855a55c2a2a5574a51a11d1c2c749",
    "phi_3_vision_4_2b":
        "0b353c2a6828d5050af7134b45d356c446536d5fda0558d0f4bb14f03822d983",
    "qwen3_1_7b+remat":
        "e3be97a6942bf672f454b78ed535a696161410802e1a207959ceb3ceef2b2b8d",
    "mixtral_8x7b+dense":
        "25f46b2a0a32c00a1005c460ffe089b25fd49d35c44d9b709f658929d29f5d4e",
    "qwen3_1_7b+microbatch":
        "e9b560e2dec37f1912fdd983a0ab622b7302cde1323f20a4d49ffa9853c33a9b",
    "zamba2_7b":
        "83a288c4299d836ef2ccff17f9da1845926ecdf78ed8bd3bf20c1e0dd13be5c1",
    "xlstm_350m":
        "70fc0d209c5a55a1ea202025fbc5108cb5fac62cba3988c9d587f3038730b7f3",
    "qwen3_1_7b+momentum":
        "b724221c28795027e81649cd50b93abb017949982e57d8a5d13b6fcbbe4b4440",
}
# The secure gradients against tools/torch_lm_rehearsal.py's
# fixed_point_plain (float64 with fixed point's mean behaviour: each
# truncation -1 unit of 2^-13; against plain float64 the gradients are
# off by a multiple of themselves from a vocabulary of a few thousand on,
# ROADMAP N6).  The rehearsal (--train, on the CPU, the embedding at
# scale 0.5, 3 seeds, faithful and collapsed): the four SMOKE families at
# one layer within relative L2 0.163 and 0.210 of the largest entry,
# qwen3 at d_model 256 within 0.080 and 0.052; the loss within 1.1e-4.
# Held: relative L2 0.25, error per largest entry 0.35, the loss 1e-3;
# all-zero gradients (relative L2 1) and shuffled ones (about 1.4) fail.
GRAD_REL_L2 = 0.25
GRAD_ERR_PER_MAX = 0.35
LOSS_ATOL = 1e-3
_REHEARSAL = pathlib.Path(__file__).resolve().parents[1] / "tools" / \
    "torch_lm_rehearsal.py"


def _rehearsal():
    """tools/torch_lm_rehearsal.py as a module (its fixed-point model)."""
    spec = importlib.util.spec_from_file_location("torch_lm_rehearsal",
                                                  _REHEARSAL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _grads_same(jg, tg, what):
    assert sorted(jg) == sorted(tg), what
    for k in jg:
        _same(jg[k], tg[k], f"{what} grad {k}")


def _check_reverse_seam():
    """A two-iteration JAX lax.scan(reverse=True) whose body draws under
    two key sets (share + mult_tr under the first, mult_tr under the
    second, as _seg_bwd's remat forward and backward) against the port's
    scan_loop(reverse=True) with two tags: words, outputs in index order,
    totals(), the counter, checks."""
    jc, tc, je, te = _pair()
    rng = np.random.RandomState(10)
    x0 = rng.randn(3, 4) * 0.5
    vs = np.asarray(J64.encode(rng.randn(2, 3, 4) * 0.5))
    jcarry, tcarry = JP.share(jc, J64.encode(x0)), TP.share(tc, T64.encode(x0))
    jk1 = JR._layer_keys(je, 2, "fseam")
    jk2 = JR._layer_keys(je, 2, "bseam")

    def jbody(carry, xs):
        mark = jc.begin_body()
        with jc.scan_keys(xs["k1"]):
            a = JP.mult_tr(jc, JP.share(jc, xs["v"]), JShare(carry))
        with jc.scan_keys(xs["k2"]):
            y = JP.mult_tr(jc, a, JShare(carry))
        return y.data, {"y": y.data, "ok": jc.end_body(mark)}

    with jc.tally.scaled(2):
        jfin, jys = jax.lax.scan(jbody, jcarry.data,
                                 {"v": vs, "k1": jk1, "k2": jk2},
                                 reverse=True)
    jc.absorb_checks(jys["ok"])
    tvs = torch.from_numpy(vs.view(np.int64).copy())
    order = []

    def tbody(carry, i, scopes):
        order.append(i)
        with scopes[0]():
            a = TP.mult_tr(tc, TP.share(tc, tvs[i]), TShare(carry))
        with scopes[1]():
            y = TP.mult_tr(tc, a, TShare(carry))
        return y.data, y.data

    tfin, tys = TR.scan_loop(te, 2, ("fseam", "bseam"), tbody, tcarry.data,
                             reverse=True)
    assert order == [1, 0]
    _same(jfin, tfin, "reverse seam carry")
    _same(jys["y"], torch.stack(tys), "reverse seam outputs")
    _same_ctx(jc, tc, "reverse seam")
    assert tc._counter > 0 and tc.ledger.checks, "reverse seam: nothing drawn"


def _check_dense_layers():
    """Faithful: linear_bwd, rmsnorm_bwd, embedding_bwd (repeated ids),
    attention_bwd (GQA, qk_norm), cross_attention_bwd and mlp_bwd for each
    act, from each package's own forward cache, bit for bit."""
    jc, tc, je, te = _pair()
    rng = np.random.RandomState(11)
    # (1, 4, 16) activations throughout: the shapes repeat (eager JAX
    # compiles each op at each new shape)
    jx, tx = _both(rng, je, te, 1, 4, 16)
    jdy, tdy = _both(rng, je, te, 1, 4, 16)
    w = rng.randn(16, 16) * 0.25
    jw, tw = je.from_plain(w), te.from_plain(w)
    jy, jcache = JL.linear_fwd(je, {"w": jw}, jx)
    ty, tcache = TL.linear_fwd(te, {"w": tw}, tx)
    jdx, jg = JL.linear_bwd(je, {"w": jw}, jcache, jdy)
    tdx, tg = TL.linear_bwd(te, {"w": tw}, tcache, tdy)
    _same(jdx, tdx, "linear_bwd dx")
    _grads_same(jg, tg, "linear_bwd")
    _same_ctx(jc, tc, "linear_bwd")

    g = 1.0 + 0.1 * rng.randn(16)
    jp, tp = {"g": je.from_plain(g)}, {"g": te.from_plain(g)}
    _, jcache = JL.rmsnorm_fwd(je, jp, jx)
    _, tcache = TL.rmsnorm_fwd(te, tp, tx)
    jdx, jg = JL.rmsnorm_bwd(je, jp, jcache, jdy)
    tdx, tg = TL.rmsnorm_bwd(te, tp, tcache, tdy)
    _same(jdx, tdx, "rmsnorm_bwd dx")
    _grads_same(jg, tg, "rmsnorm_bwd")
    _same_ctx(jc, tc, "rmsnorm_bwd")

    table = rng.randn(6, 16) * 0.5
    jp, tp = {"table": je.from_plain(table)}, {"table": te.from_plain(table)}
    ids = np.array([[1, 3, 1, 1]])                 # id 1 three times
    _, jcache = JL.embedding_fwd(je, jp, ids)
    _, tcache = TL.embedding_fwd(te, tp, ids)
    _, jg = JL.embedding_bwd(je, jp, jcache, jdy)
    _, tg = TL.embedding_bwd(te, tp, tcache, tdy)
    _grads_same(jg, tg, "embedding_bwd")

    jcfg, tcfg, jp, tp = _attn(rng, je, te, qk_norm=True, rope_theta=1e6)
    _, jcache, _ = JL.attention_fwd(je, jp, jcfg, jx)
    _, tcache, _ = TL.attention_fwd(te, tp, tcfg, tx)
    jdx, jg = JL.attention_bwd(je, jp, jcfg, jcache, jdy)
    tdx, tg = TL.attention_bwd(te, tp, tcfg, tcache, tdy)
    _same(jdx, tdx, "attention_bwd dx")
    _grads_same(jg, tg, "attention_bwd")
    _same_ctx(jc, tc, "attention_bwd")

    jcfg, tcfg, jp, tp = _attn(rng, je, te)
    jenc, tenc = _both(rng, je, te, 1, 4, 16)
    _, jcache = JL.cross_attention_fwd(je, jp, jcfg, jx, jenc)
    _, tcache = TL.cross_attention_fwd(te, tp, tcfg, tx, tenc)
    jdx, jde, jg = JL.cross_attention_bwd(je, jp, jcfg, jcache, jdy)
    tdx, tde, tg = TL.cross_attention_bwd(te, tp, tcfg, tcache, tdy)
    _same(jdx, tdx, "cross_attention_bwd dx")
    _same(jde, tde, "cross_attention_bwd d_enc")
    _grads_same(jg, tg, "cross_attention_bwd")
    _same_ctx(jc, tc, "cross_attention_bwd")

    for act in ("swiglu", "sigmoid_glu", "relu2", "relu"):
        mk = dict(d_model=16, d_ff=16, act=act)
        mp = JB.mlp_init(rng, JB.MLPConfig(**mk))
        jp, tp = _conv(je, mp), _conv(te, mp)
        _, jcache = JB.mlp_fwd(je, jp, JB.MLPConfig(**mk), jx)
        _, tcache = TB.mlp_fwd(te, tp, TB.MLPConfig(**mk), tx)
        jdx, jg = JB.mlp_bwd(je, jp, JB.MLPConfig(**mk), jcache, jdy)
        tdx, tg = TB.mlp_bwd(te, tp, TB.MLPConfig(**mk), tcache, tdy)
        _same(jdx, tdx, f"mlp_bwd {act} dx")
        _grads_same(jg, tg, f"mlp_bwd {act}")
        _same_ctx(jc, tc, f"mlp_bwd {act}")


def _check_moe_bwd():
    """Collapsed: moe_bwd with dense routing, and with public routing at
    capacity factor 0.5 (every token's first choice expert 3, its 3 slots
    overflowed: padded slots scatter into token 0, overflowed
    assignments add masked rows, repeated positions sum), bit for bit."""
    jc, tc, je, te = _pair(collapse=True)
    rng = np.random.RandomState(12)
    x = np.abs(rng.randn(1, 5, 16)) * 0.5 + 0.5
    jdy, tdy = _both(rng, je, te, 1, 5, 16)
    for routing in ("dense", "public"):
        mk = dict(d_model=16, d_ff=16, n_experts=4, top_k=2, act="swiglu",
                  routing=routing, capacity_factor=0.5)
        mp = JB.moe_init(rng, JB.MoEConfig(**mk))
        if routing == "public":
            mp["router"][:, 3] = np.abs(mp["router"][:, 3]) + 0.5
        jp, tp = _conv(je, mp), _conv(te, mp)
        _, jcache = JB.moe_fwd(je, jp, JB.MoEConfig(**mk), je.from_plain(x))
        _, tcache = TB.moe_fwd(te, tp, TB.MoEConfig(**mk), te.from_plain(x))
        if routing == "public":
            keep = tcache[7].numpy()
            assert (keep == 0).sum() >= 2, "no assignment over capacity"
            assert len(set(tcache[6].reshape(-1).tolist())) < keep.size
        jdx, jg = JB.moe_bwd(je, jp, JB.MoEConfig(**mk), jcache, jdy)
        tdx, tg = TB.moe_bwd(te, tp, TB.MoEConfig(**mk), tcache, tdy)
        _same(jdx, tdx, f"moe_bwd {routing} dx")
        _grads_same(jg, tg, f"moe_bwd {routing}")
        _same_ctx(jc, tc, f"moe_bwd {routing}")


def _check_recurrent_bwd(collapse: bool):
    """retention_bwd and slstm_bwd live against the JAX package in one
    mode: x of (2, 16, 32) (4 heads, d_k = d_v = 8, seq_chunk 8: two
    chunks, so the reverse chunk loop carries the state's gradient across
    a boundary), each from its own package's forward cache; dx and the
    grads' words, totals(), the PRF counter and the abort flag."""
    mode = "collapsed" if collapse else "faithful"
    rng = np.random.RandomState(13)
    x, dy = rng.randn(2, 16, 32) * 0.5, rng.randn(2, 16, 32) * 0.5
    jc, tc, je, te = _pair(collapse)
    jx, tx = je.from_plain(x), te.from_plain(x)
    jdy, tdy = je.from_plain(dy), te.from_plain(dy)
    for name, (init, c) in _RECURRENT_BLOCKS.items():
        jcfg, tcfg = getattr(JR, c[0])(**c[1]), getattr(TR, c[0])(**c[1])
        p = getattr(JR, init)(np.random.RandomState(14), jcfg)
        jp, tp = _conv(je, p), _conv(te, p)
        _, jcache, _ = getattr(JR, f"{name}_fwd")(je, jp, jcfg, jx)
        _, tcache, _ = getattr(TR, f"{name}_fwd")(te, tp, tcfg, tx)
        jdx, jg = getattr(JR, f"{name}_bwd")(je, jp, jcfg, jcache, jdy)
        tdx, tg = getattr(TR, f"{name}_bwd")(te, tp, tcfg, tcache, tdy)
        _same(jdx, tdx, f"{name}_bwd {mode} dx")
        _grads_same(jg, tg, f"{name}_bwd {mode}")
        _same_ctx(jc, tc, f"{name}_bwd {mode}")


# the recurrent blocks of the backward checks: {name: (init, (config
# class, its fields))}
_RECURRENT_BLOCKS = {
    "retention": ("retention_init", ("RetentionConfig", dict(
        d_model=32, n_heads=4, d_k=8, d_v=8, seq_chunk=8))),
    "slstm": ("slstm_init", ("SLSTMConfig", dict(d_model=32, n_heads=4,
                                                 seq_chunk=8)))}
# the central difference's step and its tolerance, relative to the
# directional derivative: the PlainEngine's gates are piecewise linear
# (the clamp sigmoid), so away from a kink the float64 difference
# quotient of these piecewise-polynomial blocks is exact up to rounding
# (about 1e-10 here)
FD_EPS = 1e-6
FD_RTOL = 1e-6


def _check_recurrent_directional():
    """The port's retention_bwd and slstm_bwd on the PlainEngine
    (float64) against a central difference of their forward: for random
    directions v_x of the input and v_p of every weight, <dx, v_x> + sum
    <g, v_p> equals (L(+eps) - L(-eps)) / (2 eps) with L(t) = <y(x + t
    v_x, p + t v_p), dy>, within FD_RTOL: the backward is the forward's
    gradient, independently of the JAX package."""
    pe = TPlain(device="cpu")
    rng = np.random.RandomState(15)
    x, dy = (torch.from_numpy(rng.randn(2, 16, 32) * 0.5) for _ in range(2))
    for name, (init, c) in _RECURRENT_BLOCKS.items():
        cfg = getattr(TR, c[0])(**c[1])
        p = {k: torch.from_numpy(v) for k, v in
             getattr(TR, init)(np.random.RandomState(16), cfg).items()}
        fwd, bwd = getattr(TR, f"{name}_fwd"), getattr(TR, f"{name}_bwd")
        _, cache, _ = fwd(pe, p, cfg, x)
        dx, g = bwd(pe, p, cfg, cache, dy)
        assert sorted(g) == sorted(p), name
        vx = torch.from_numpy(rng.randn(*x.shape))
        vp = {k: torch.from_numpy(rng.randn(*v.shape)) for k, v in p.items()}

        def loss(t):
            y, _, _ = fwd(pe, {k: p[k] + t * vp[k] for k in p}, cfg,
                          x + t * vx)
            return float((y * dy).sum())

        fd = (loss(FD_EPS) - loss(-FD_EPS)) / (2 * FD_EPS)
        parts = [float((dx * vx).sum())] + [float((g[k] * vp[k]).sum())
                                            for k in sorted(g)]
        assert all(abs(t) > 1e-3 for t in parts), (name, parts)
        assert abs(fd - sum(parts)) <= FD_RTOL * abs(fd), (name, fd, parts)


def _stacked_tree(eng, w, n):
    """{"lm_head": {"w": a share of w[0]}, "segments": [{"w": n layers of
    w stacked, a share's data (n, 4, ...)}]}: the layout of
    params_to_engine."""
    lone, st = eng.from_plain(w[0]), eng.from_plain(w[:n])
    if isinstance(st, JShare):
        st = JShare(jax.numpy.moveaxis(st.data, 0, 1))
    else:
        st = TShare(torch.movedim(st.data, 0, 1))
    return {"lm_head": {"w": lone}, "segments": [{"w": st}]}


def _jax_on_layout(fn, *trees):
    """`fn` over _stacked_tree trees of the JAX package in its leaf order,
    the stacked leaf taken as one (n, ...) share (ROADMAP F6 fixed)."""
    def move(x):
        return JShare(jax.numpy.moveaxis(x.data, 0, 1))

    head = fn(*(t["lm_head"]["w"] for t in trees))
    st = move(fn(*(move(t["segments"][0]["w"]) for t in trees)))
    return {"lm_head": {"w": head}, "segments": [{"w": st}]}


def _check_optimizers():
    """SGD and Momentum (two updates) of the port against the JAX package
    on a tree with a plain leaf and a stacked leaf of n layers
    (``_stacked_tree``), faithful, lr 2^-2: the new params' and the
    momentum buffers' words, totals() and the PRF counter.  n = 3: against
    the JAX package's optimizers.  n = 4 (ROADMAP F6): against the JAX
    engine's updates of each leaf laid out as one (n, ...) share; the JAX
    package's own optimizers take the layer axis for the component axis
    there, and their layers open far from w - lr g.  Each layer of the
    port's opens to its float64 update within 4 units of 2^-13."""
    from repro.train import optim as JO
    from repro_torch.train import optim as TO
    leaves = _vs_jax()._leaves
    lr, beta, unit = 2.0 ** -2, 0.875, 2.0 ** -13
    rng = np.random.RandomState(17)
    w, g = rng.randn(4, 2, 3) * 0.5, rng.randn(4, 2, 3) * 0.5
    for n in (3, 4):
        for opt in ("SGD", "Momentum"):
            what = f"{opt} at n = {n}"
            jc, tc, je, te = _pair()
            jo, to = getattr(JO, opt)(lr=lr), getattr(TO, opt)(lr=lr)
            jw, tw = _stacked_tree(je, w, n), _stacked_tree(te, w, n)
            jg, tg = _stacked_tree(je, g, n), _stacked_tree(te, g, n)
            js, ts = jo.init(je, jw), to.init(te, tw)
            want_w, want_m = w[:n], np.zeros_like(w[:n])
            for _ in range(2 if opt == "Momentum" else 1):
                tw, ts = to.update(te, tw, tg, ts)
                if n == 3:
                    jw, js = jo.update(je, jw, jg, js)
                elif opt == "SGD":
                    jw = _jax_on_layout(
                        lambda a, b: je.sub(a, je.scale(b, lr)), jw, jg)
                else:
                    js = _jax_on_layout(
                        lambda m, b: je.add(je.scale(m, beta), b), js, jg)
                    jw = _jax_on_layout(
                        lambda a, m: je.sub(a, je.scale(m, lr)), jw, js)
                want_m = beta * want_m + g[:n]
                want_w = want_w - lr * (want_m if opt == "Momentum"
                                        else g[:n])
            pairs = list(zip(leaves(jw), leaves(tw)))
            if opt == "Momentum":
                pairs += list(zip(leaves(js), leaves(ts)))
            for (path, a), (_, b) in pairs:
                _same(a, b, f"{what} {path}")
            _same_ctx(jc, tc, what)
            got = te.to_plain(TShare(torch.movedim(
                tw["segments"][0]["w"].data, 0, 1))).numpy()
            assert np.abs(got - want_w).max() <= 4 * unit, what
        # the JAX package's own SGD on the 4-layer leaf (ROADMAP F6)
        jc, _, je, _ = _pair()
        jw = _stacked_tree(je, w, n)
        bad, _ = JO.SGD(lr=lr).update(je, jw, _stacked_tree(je, g, n), None)
        bad = np.asarray(je.to_plain(JShare(jax.numpy.moveaxis(
            bad["segments"][0]["w"].data, 0, 1))))
        assert (np.abs(bad - (w[:n] - lr * g[:n])).max() > 1) == (n == 4), \
            f"ROADMAP F6 at n = {n}"


def test_lm_recurrent_bwd_faithful_matches_jax():
    """retention_bwd and slstm_bwd live against the JAX package, faithful
    (``_check_recurrent_bwd``), and against a central difference of their
    forward on the PlainEngine (``_check_recurrent_directional``)."""
    _check_recurrent_bwd(collapse=False)
    _check_recurrent_directional()


def test_lm_recurrent_bwd_collapsed_and_optimizers_match_jax():
    """retention_bwd and slstm_bwd live against the JAX package,
    collapsed (``_check_recurrent_bwd``); SGD and Momentum against the
    JAX package's, and ROADMAP F6 (``_check_optimizers``)."""
    _check_recurrent_bwd(collapse=True)
    _check_optimizers()


def test_lm_train_layers_and_reverse_seam_match_jax():
    """The reverse loop seam (``_check_reverse_seam``) and the dense
    layers' and attention's backward passes (``_check_dense_layers``)
    against the JAX package, live, bit for bit, with totals(), the PRF
    counter and the abort flag after each."""
    _check_reverse_seam()
    _check_dense_layers()


def _grads_close(rh, want: dict, got: dict) -> bool:
    gap = rh.grad_gap(want, got)
    return gap["rel_l2"] <= GRAD_REL_L2 and \
        gap["err_per_max"] <= GRAD_ERR_PER_MAX


def test_lm_train_step_matches_jax_digests():
    """moe_bwd live against JAX (``_check_moe_bwd``); the port's
    train_step (collapsed, one layer) for qwen3 (dense, qk_norm), mixtral
    (public and dense routing), whisper (encdec: the encoder's grads from
    the decoder's summed d_enc) and phi-3-vision (vlm: the frontend's
    positions dropped and padded back), qwen3 with remat, with microbatch
    2 and with two Momentum steps, and zamba2 and xlstm uncut (the
    recurrent kinds and the shared block), hashed against
    JAX_TRAIN_DIGESTS; on the PlainEngine, remat equal to no remat (new
    params and loss) for zamba2 and xlstm uncut (two chunks) and qwen3 at
    two layers, and microbatch 2's grads within 1e-12 of the whole
    batch's; the secure
    gradients (qwen3 SMOKE at one layer, collapsed, the embedding at scale
    0.5) within the rehearsal's bounds of the fixed-point model, which
    all-zero and shuffled gradients fail, the loss within LOSS_ATOL."""
    _check_moe_bwd()
    vs = _vs_jax()
    for case in vs.TRAIN_CASES:
        assert vs.train_digest(vs.run_port_train(case, 1, True)) == \
            JAX_TRAIN_DIGESTS[case], \
            f"{case}: the train step's words differ from the JAX package's"

    pe = TPlain(device="cpu")
    rh = _rehearsal()
    for arch, seq in (("zamba2_7b", 16), ("xlstm_350m", 16),
                      ("qwen3_1_7b", 8)):
        cfg = tget(arch).SMOKE
        params = TM.init_params(cfg, 0)
        rs = np.random.RandomState(3)
        ids = rs.randint(0, cfg.vocab, (2, seq))
        labels = rs.randint(0, cfg.vocab, (2, seq))
        runs = {}
        for remat in (False, True):
            c = dataclasses.replace(cfg, remat=remat)
            runs[remat] = TM.train_step(pe, c,
                                        TM.params_to_engine(pe, params),
                                        ids, labels, lr=2.0 ** -6)
        assert float(runs[False][1]) == float(runs[True][1]), arch
        a, b = (rh.grads_plain(pe, runs[r][0]) for r in (False, True))
        assert sorted(a) == sorted(b) and all(
            torch.equal(a[k], b[k]) for k in a), f"{arch}: remat changed " \
            "the step"
    whole = TM.loss_and_grads(pe, cfg, TM.params_to_engine(pe, params), ids,
                              labels)
    micro = TM._microbatched_grads(
        pe, dataclasses.replace(cfg, microbatch=2),
        TM.params_to_engine(pe, params), ids, labels, None, None)
    assert abs(float(whole[0]) - float(micro[0])) <= 1e-6
    a, b = rh.grads_plain(pe, whole[1]), rh.grads_plain(pe, micro[1])
    assert all(float((a[k] - b[k]).abs().max()) <= 1e-12 for k in a), \
        "microbatch"


    one = dataclasses.replace(cfg, n_layers=1)
    params = TM.init_params(one, 0)
    params["embed"]["table"] *= 25.0
    want_loss, want, _ = rh.loss_and_grads(rh.fixed_point_plain("cpu"), one,
                                           params, ids, labels)
    ctx = tmake(T64, seed=5, collapse=True, device="cpu")
    loss, got, _ = rh.loss_and_grads(TEngine(ctx), one, params, ids, labels)
    assert not ctx.abort_flag()
    assert abs(loss - want_loss) <= LOSS_ATOL, (loss, want_loss)
    assert _grads_close(rh, want, got), rh.grad_gap(want, got)
    zeros = {k: torch.zeros_like(v) for k, v in want.items()}
    assert not _grads_close(rh, want, zeros)
    assert not _grads_close(rh, want, rh.shuffled(want))
