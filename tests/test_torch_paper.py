"""The rest of the port's joint simulation against the JAX package's, on the
same seeds, bit for bit: the paper's cost tables (``core/paper_costs.py``),
the ABY3 baseline (``core/aby3.py``), ``activations.argmax_tournament``,
the boolean chains' split route (``ops.and_chain_offline`` /
``and_chain_online``, their plain versions on the CPU) against the JAX
package's AND-by-AND offline and online code, and the trainer's
``split_offline_online`` on a small NN, whose online run opens the JAX
package's *fused* words (ROADMAP F4: JAX's own online run does not).
Two items: the suite's test count is held near its limit."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import activations as JA  # noqa: E402
from repro.core import aby3 as JY  # noqa: E402
from repro.core import boolean as JB  # noqa: E402
from repro.core import paper_costs as JPC  # noqa: E402
from repro.core import protocols as JP  # noqa: E402
from repro.core.context import make_context as jmake  # noqa: E402
from repro.core.ring import RING32 as J32, RING64 as J64  # noqa: E402
from repro.nn.engine import TridentEngine as JEngine  # noqa: E402
from repro.train import paper_ml as JML  # noqa: E402
from repro_torch.core import activations as TA  # noqa: E402
from repro_torch.core import aby3 as TY  # noqa: E402
from repro_torch.core import boolean as TB  # noqa: E402
from repro_torch.core import paper_costs as TPC  # noqa: E402
from repro_torch.core import protocols as TP  # noqa: E402
from repro_torch.core.context import make_context as tmake  # noqa: E402
from repro_torch.core.ring import (  # noqa: E402
    RING32 as T32, RING64 as T64, words_from_numpy, words_to_numpy)
from repro_torch.kernels import ops as TK  # noqa: E402
from repro_torch.train import paper_ml as TML  # noqa: E402
from repro_torch.train.trainer import split_offline_online  # noqa: E402

RINGS = ((J64, T64), (J32, T32))
SEED = 5
NET = (12, (8, 4))
BATCH = 8


def _words(x) -> np.ndarray:
    x = getattr(x, "data", x)
    return words_to_numpy(x) if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _same(jx, tx, what):
    j, t = _words(jx), _words(tx)
    assert j.shape == t.shape and j.dtype == t.dtype, what
    assert np.array_equal(j, t), f"{what}: words differ"


def _same_materials(jmats, tmats, what):
    assert len(jmats) == len(tmats), what
    for i, (jm, tm) in enumerate(zip(jmats, tmats)):
        assert sorted(jm) == sorted(tm), (what, i)
        for key in jm:
            _same(jm[key], tm[key], f"{what}: material {i} {key}")


def test_paper_costs_and_aby3_match_jax():
    """paper_costs: every table's every key at ell in {8, 16, 32, 64} (dotp
    at several d), dotp_tr_cost, and model_iteration_cost for the four
    workloads x three schemes at the paper's batches.  aby3: share,
    reveal, the RShare operators, mult (broadcast too), matmul, truncate
    and matmul_tr, words and tallies, at RING64 and RING32."""
    for name in ("TRIDENT", "TRIDENT_IMPL", "ABY3", "ABY3_SEMI", "GORDON"):
        jt, tt = getattr(JPC, name), getattr(TPC, name)
        assert sorted(jt) == sorted(tt), name
        for ell in (8, 16, 32, 64):
            for key in jt:
                assert tt[key](ell) == jt[key](ell), (name, key, ell)
                if key == "dotp":
                    for d in (1, 10, 784):
                        assert tt[key](ell, d) == jt[key](ell, d)
            for scheme in ("trident", "aby3", "aby3_semi"):
                for d in (1, 10, 784):
                    assert TPC.dotp_tr_cost(scheme, ell, d) == \
                        JPC.dotp_tr_cost(scheme, ell, d)
    assert TPC.KAPPA == JPC.KAPPA
    with pytest.raises(ValueError):
        TPC.dotp_tr_cost("gordon", 64, 1)
    for kind, layers in (("linreg", ()), ("logreg", ()),
                         ("nn", (128, 128, 10)), ("cnn", (980, 100, 10))):
        for scheme in ("trident", "aby3", "aby3_semi"):
            for B in (128, 256, 512):
                for d in (10, 784):
                    assert TPC.model_iteration_cost(
                        scheme, 64, d, B, kind, layers) == \
                        JPC.model_iteration_cost(scheme, 64, d, B, kind,
                                                 layers), (kind, scheme, B)

    rng = np.random.RandomState(SEED)
    a, b = rng.randn(4, 6) * 2, rng.randn(6, 3) * 0.5
    col = rng.randn(4, 1)
    for jr, tr in RINGS:
        where = f"RING{tr.ell}"
        jc = jmake(jr, seed=SEED)
        tc = tmake(tr, seed=SEED, device="cpu")

        def both(jfn, tfn, *args, what):
            j = jfn(jc, *[x[0] for x in args])
            t = tfn(tc, *[x[1] for x in args])
            _same(j, t, f"{what} {where}")
            return j, t

        x = both(JY.share, TY.share, (jr.encode(a), tc.encode(a)),
                 what="share")
        w = both(JY.share, TY.share, (jr.encode(b), tc.encode(b)),
                 what="share")
        c = both(lambda ctx, v: JY.share(ctx, v, malicious=False),
                 lambda ctx, v: TY.share(ctx, v, malicious=False),
                 (jr.encode(col), tc.encode(col)), what="share semi")
        _same(x[0] + w[0].data[0, 0, 0], x[1] + w[1].data[0, 0, 0],
              f"add public {where}")
        _same(x[0] - x[0], x[1] - x[1], f"sub {where}")
        _same(-(x[0] - 7), -(x[1] - 7), f"neg, sub public {where}")
        _same(x[0].mul_public(3), x[1].mul_public(3), f"mul_public {where}")
        xx = both(JY.mult, TY.mult, x, x, what="mult")
        both(JY.mult, TY.mult, x, c, what="mult broadcast")
        both(lambda ctx, u, v: JY.mult(ctx, u, v, malicious=False),
             lambda ctx, u, v: TY.mult(ctx, u, v, malicious=False), x, x,
             what="mult semi")
        both(JY.truncate, TY.truncate, xx, what="truncate")
        both(JY.matmul, TY.matmul, x, w, what="matmul")
        z = both(JY.matmul_tr, TY.matmul_tr, x, w, what="matmul_tr")
        both(lambda ctx, u, v: JY.matmul_tr(ctx, u, v, malicious=False),
             lambda ctx, u, v: TY.matmul_tr(ctx, u, v, malicious=False),
             x, w, what="matmul_tr semi")
        both(JY.reveal, TY.reveal, z, what="reveal")
        assert tc.tally.totals() == jc.tally.totals(), where
        # the same entries: names, calls, rounds and bits per phase
        assert dict(tc.tally.by_op) == dict(jc.tally.by_op), where
        if tr.ell == 64:
            # the pair truncation fails where x - r wraps: with r uniform
            # over the ring that is likely at ell = 32 (x ~ 2^26 words)
            np.testing.assert_allclose(
                tr.decode(TY.reveal(tc, z[1])).numpy(), a @ b, atol=1e-2)


def _nn_program(params, X, jax_side: bool):
    """share X and the weights, mlp_net_fwd on a TridentEngine (Newton
    division), open: the port's mlp_net_predict_joint in either package."""
    if not jax_side:
        net = TML.MLPNet(*NET)

        def program(ctx):
            enc = TML.params_from_numpy(params, ctx.ring, ctx.device)
            return TML.mlp_net_predict_joint(ctx, enc, net, X)
        return program
    net = JML.MLPNet(*NET)

    def jprogram(ctx):
        eng = JEngine(ctx, nonlinear="newton")
        h = eng.from_plain(X)
        ws = {f"w{i}": JP.share(ctx, ctx.ring.encode(params[f"w{i}"]))
              for i in range(len(params))}
        p, _ = JML.mlp_net_fwd(eng, ws, net, h)
        return JP.reconstruct(ctx, p)
    return jprogram


def test_split_offline_online_and_argmax_match_jax():
    """The boolean chains in offline and online runs (a lone AND, 1-bit and
    broadcast; the adder, and with carry-in broadcast; the prefix-OR), one
    split-entry call each, against the JAX package's AND-by-AND code:
    words, materials and totals() of both runs, faithful and collapsed.
    Then the 12-8-4 NN through split_offline_online,
    faithful and collapsed: the online words are the JAX package's fused
    run's; the offline words and materials and each run's totals() are its
    offline and online runs'; every material is consumed, no abort.  Last,
    argmax_tournament over rows of 3 (an odd round, then an even one) in
    both worlds, on the NN's batch (the NN's compiled shapes)."""
    rng = np.random.RandomState(SEED)
    # RING64 only: the chains' 32-bit masks are the fused route's, held by
    # tests/test_torch_joint.py; the split's ANDs are bitwise
    for jr, tr in RINGS[:1]:
        ell = tr.ell
        vals = [rng.randint(0, 2**31, size=s, dtype=np.int64).astype(
            jr.dtype) for s in ((3, 4), (3, 4), (3, 1), (1, 4))]
        for collapse in (False, True):
            where = f"RING{ell} collapse={collapse}"
            mats = None
            for mode in ("offline", "online"):
                jc = jmake(jr, seed=SEED, collapse=collapse, mode=mode)
                tc = tmake(tr, seed=SEED, collapse=collapse, mode=mode,
                           device="cpu")
                if mats is not None:
                    jc.materials, tc.materials = mats
                pairs = [(JB.share_bool(jc, jnp.asarray(v)),
                          TB.share_bool(tc, words_from_numpy(v)))
                         for v in vals]
                bit = [(j.bit(0), t.bit(0)) for j, t in pairs[:2]]
                calls = [
                    ("and", lambda B, c, s: B.and_bshare(c, s[0], s[1])),
                    ("and 1-bit", lambda B, c, s: B.and_bshare(
                        c, ~s[4], s[5], active_bits=1)),
                    ("and broadcast",
                     lambda B, c, s: B.and_bshare(c, s[2], s[3])),
                    ("ppa_add", lambda B, c, s: B.ppa_add(c, s[0], s[1])),
                    ("ppa_sub", lambda B, c, s: B.ppa_sub(c, s[2], s[3])),
                    ("prefix_or", lambda B, c, s: B.prefix_or(c, s[0]))]
                for what, call in calls:
                    TK.reset_launches()
                    j = call(JB, jc, [p[0] for p in pairs + bit])
                    t = call(TB, tc, [p[1] for p in pairs + bit])
                    _same(j, t, f"{what} {mode} {where}")
                    assert TK.AND_LEVEL.calls == 1, (what, mode)
                    assert TK.PRF_MASK.calls == (mode == "offline"), what
                assert tc.tally.totals() == jc.tally.totals(), (mode, where)
                mats = jc.materials, tc.materials
            _same_materials(*mats, where)
            assert tc._mat_idx == len(mats[1])

    params = JML.mlp_net_init(np.random.RandomState(0), JML.MLPNet(*NET))
    X = np.random.RandomState(1).randn(BATCH, NET[0])
    for collapse in (False, True):
        where = f"NN collapse={collapse}"
        runs = {}
        for mode in ("fused", "offline", "online"):
            jc = jmake(J64, seed=SEED, collapse=collapse, mode=mode)
            if mode == "online":
                jc.materials = runs["offline"][1].materials
            runs[mode] = (_nn_program(params, X, True)(jc), jc)
        tprog = _nn_program(params, X, False)
        TK.reset_launches()
        mats, online_fn = split_offline_online(tprog, seed=SEED,
                                               device="cpu",
                                               collapse=collapse)
        off_calls = TK.AND_LEVEL.calls
        TK.reset_launches()
        words, on_ctx = online_fn()
        # A2B's subtractor and the prefix-OR of smx's normalization, as in
        # the fused run
        assert off_calls == TK.AND_LEVEL.calls == 2, where
        _same(runs["fused"][0], words, f"online words vs fused {where}")
        _same_materials(runs["offline"][1].materials, mats, where)
        assert on_ctx._mat_idx == len(mats), where
        assert on_ctx.tally.totals() == runs["online"][1].tally.totals()
        # the offline run's offline totals and the online run's online
        # totals are the fused run's
        fused = runs["fused"][1].tally.totals()
        assert on_ctx.tally.totals()["online"] == fused["online"], where
        assert not on_ctx.abort_flag(), where
        # the offline run's words are JAX's offline run's too
        ctx = tmake(T64, seed=SEED, collapse=collapse, mode="offline",
                    device="cpu")
        _same(runs["offline"][0], tprog(ctx), f"offline words {where}")
        assert ctx.tally.totals() == runs["offline"][1].tally.totals()
        assert ctx.tally.totals()["offline"] == fused["offline"], where

    for collapse in (False, True):
        v = rng.randn(BATCH, 3)
        jc = jmake(J64, seed=SEED, collapse=collapse)
        tc = tmake(T64, seed=SEED, collapse=collapse, device="cpu")
        jm = JA.argmax_tournament(jc, JP.share(jc, J64.encode(v)))
        tm = TA.argmax_tournament(tc, TP.share(tc, tc.encode(v)))
        _same(jm, tm, f"argmax_tournament collapse={collapse}")
        assert tc.tally.totals() == jc.tally.totals()
        assert tm.shape == (BATCH, 1)
        np.testing.assert_allclose(T64.decode(tm.reveal()).numpy()[:, 0],
                                   v.max(axis=1), atol=1e-3)
