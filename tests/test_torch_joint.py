"""The port's joint simulation (``repro_torch.core``, ``nn.engine``,
``serve.engine``) against the JAX package's on the same seed, bit for bit:
every protocol of the secure-prediction path in faithful and collapsed
mode, the plain versions of the and_level / mpc_matmul_fused / ppa_msb
kernels, joint serving of a small NN, and the port's joint world against
its own party runtime -- at RING64 and at RING32.  Ring words are compared
as uint64/uint32 views; the JAX kernels run in interpret mode, as
tests/test_kernels.py runs them."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one intra-op thread, so idle torch threads do not spin
# beside the JAX tests that share this worker
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import activations as JA  # noqa: E402
from repro.core import algebra as JAL  # noqa: E402
from repro.core import boolean as JB  # noqa: E402
from repro.core import conversions as JC  # noqa: E402
from repro.core import garbled as JG  # noqa: E402
from repro.core import protocols as JP  # noqa: E402
from repro.core.context import make_context as jmake  # noqa: E402
from repro.core.ring import RING32 as J32, RING64 as J64  # noqa: E402
from repro.kernels import ops as JK  # noqa: E402
from repro.kernels.mpc_matmul_fused import (  # noqa: E402
    mpc_matmul_fused as jax_mpc_matmul_fused)
from repro.kernels import ref as JR  # noqa: E402
from repro.nn.engine import TridentEngine as JEngine  # noqa: E402
from repro.serve.engine import PredictionServer as JServer  # noqa: E402
from repro.train import paper_ml as JML  # noqa: E402
from repro_torch.core import activations as TA  # noqa: E402
from repro_torch.core import algebra as TAL  # noqa: E402
from repro_torch.core import boolean as TB  # noqa: E402
from repro_torch.core import conversions as TC  # noqa: E402
from repro_torch.core import garbled as TG  # noqa: E402
from repro_torch.core import protocols as TP  # noqa: E402
from repro_torch.core.context import make_context as tmake  # noqa: E402
from repro_torch.core.ring import (  # noqa: E402
    RING32 as T32, RING64 as T64, words_from_numpy, words_to_numpy)
from repro_torch.kernels import ops as TK  # noqa: E402
from repro_torch.kernels.mpc_matmul_fused import (  # noqa: E402
    mpc_matmul_fused_limbs_plain, mpc_matmul_fused_plain)
from repro_torch.kernels.ppa_msb import (  # noqa: E402
    and_level_plain, chain_ands, ppa_add_plain, prefix_or_plain)
from repro_torch.runtime import FourPartyRuntime  # noqa: E402
from repro_torch.serve.engine import PredictionServer  # noqa: E402
from repro_torch.train import paper_ml as TML  # noqa: E402

NET = (32, (16, 10))
BATCH = 8
SEED = 11
RINGS = ((J64, T64), (J32, T32))


def _words(x) -> np.ndarray:
    """Ring words of a share, a share's data or a tensor, as uint64/32."""
    x = getattr(x, "data", x)
    return words_to_numpy(x) if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _assert_same(jx, tx, what, wrap32=False):
    """`wrap32`: compare mod 2^32 (ROADMAP F1: at RING32 the reference's
    dotp sums uint32 words with jnp.sum, which promotes them to uint64
    under x64, so its words are right mod 2^32 only)."""
    j, t = _words(jx), _words(tx)
    if wrap32:
        j = j.astype(np.uint32)
    assert j.shape == t.shape and j.dtype == t.dtype, what
    assert np.array_equal(j, t), f"{what}: words differ"


@pytest.mark.parametrize("collapse", [False, True],
                         ids=["faithful", "collapsed"])
def test_joint_protocols_match_jax(collapse):
    """share, mult, matmul_tr, truncation, the conversions and the
    activations of the secure-prediction path, then the rest of the joint
    protocol surface and an offline -> online split: equal words in all
    four components, equal tallies, equal abort flags; at RING64 and
    RING32."""
    for jr, tr in RINGS:
        _check_protocols(jr, tr, collapse)
    # the protocol tables
    for name in ("GAMMA_TERMS", "ZERO_SUBSETS", "GAMMA_MASK_F",
                 "GAMMA_LOCAL", "GAMMA_RECV", "PART_HOLDERS", "PART_RECV"):
        assert getattr(TAL, name) == getattr(JAL, name), name
    for j in (1, 2, 3):
        assert TAL.lam_holders(j) == JAL.lam_holders(j)
        assert TAL.online_holders(j) == JAL.online_holders(j)


def _check_protocols(jr, tr, collapse):
    jc = jmake(jr, seed=SEED, collapse=collapse)
    tc = tmake(tr, seed=SEED, collapse=collapse, device="cpu")
    rng = np.random.RandomState(SEED)
    a, b = rng.randn(4, 16) * 2, rng.randn(16, 8) * 0.5
    pos = np.abs(rng.randn(4, 1)) + 0.5   # the shape of smx's denominator

    def both(jfn, tfn, *args, what, adders=None, wrap32=False):
        """`adders`: the whole-chain and_level calls the port's fused
        route must make (one per Sklansky adder or prefix-OR chain)."""
        TK.reset_launches()
        j = jfn(jc, *[x[0] for x in args])
        t = tfn(tc, *[x[1] for x in args])
        _assert_same(j, t, f"{what} RING{tr.ell}", wrap32)
        if adders is not None:
            assert TK.AND_LEVEL.calls == adders, (what, TK.AND_LEVEL.calls)
        return j, t

    x = both(JP.share, TP.share, (jr.encode(a), tc.encode(a)), what="share")
    w = both(JP.share, TP.share, (jr.encode(b), tc.encode(b)), what="share")
    both(JP.mult, TP.mult, x, x, what="mult")
    z = both(JP.matmul_tr, TP.matmul_tr, x, w, what="matmul_tr")
    both(JP.truncate_share, TP.truncate_share, z, what="truncate_share")
    zb = both(JC.a2b, TC.a2b, z, what="a2b", adders=1)
    for method in ("mul", "ppa"):
        bit = both(lambda c, v: JC.bit_extract(c, v, method=method),
                   lambda c, v: TC.bit_extract(c, v, method=method), z,
                   what=f"bit_extract[{method}]",
                   adders=int(method == "ppa"))
    both(JC.bit2a, TC.bit2a, bit, what="bit2a")
    both(JC.b2a, TC.b2a, zb, what="b2a")
    both(JC.bit_inject, TC.bit_inject, bit, z, what="bit_inject")
    both(JA.relu, TA.relu, z, what="relu")
    both(JA.sigmoid, TA.sigmoid, z, what="sigmoid")
    p = both(JP.share, TP.share, (jr.encode(pos), tc.encode(pos)),
             what="share")
    both(JA.reciprocal, TA.reciprocal, p, what="reciprocal")
    # smx: A2B's subtractor and the prefix-OR of the normalization
    both(JA.smx_softmax, TA.smx_softmax, z, what="smx_softmax", adders=2)
    # the rest of the joint protocol surface, off the NN's path
    both(lambda c: JP.zero_shares(c, (3,)),
         lambda c: TP.zero_shares(c, (3,)), what="zero_shares")
    both(lambda c: JB.bool_zero_shares(c, (3,)),
         lambda c: TB.bool_zero_shares(c, (3,)), what="bool_zero_shares")
    both(JP.ash_by_p0, TP.ash_by_p0, (z[0].m, z[1].m), what="ash_by_p0")
    both(JP.dotp, TP.dotp, x, x, what="dotp", wrap32=tr.ell == 32)
    both(JP.matmul, TP.matmul, x, w, what="matmul")
    both(lambda c, v: JP.scale_public(c, v, 0.7),
         lambda c, v: TP.scale_public(c, v, 0.7), z, what="scale_public")
    sb = both(JB.share_bool, TB.share_bool, (z[0].m, z[1].m),
              what="share_bool")
    both(JB.reconstruct_bool, TB.reconstruct_bool, sb,
         what="reconstruct_bool")
    both(JB.msb_of_sum, TB.msb_of_sum, sb, zb, what="msb_of_sum",
         adders=1)
    both(JC.less_than_zero, TC.less_than_zero, z, what="less_than_zero")
    both(JA.maximum, TA.maximum, z, (-z[0], -z[1]), what="maximum")
    both(JA.drelu_from_bit, TA.drelu_from_bit, bit, what="drelu_from_bit")
    both(JA.dsigmoid_bit, TA.dsigmoid_bit, bit, bit, what="dsigmoid_bit")
    both(JA.rsqrt, TA.rsqrt, p, what="rsqrt")
    both(lambda c, v: JA.smx_softmax(c, v, division="garbled"),
         lambda c, v: TA.smx_softmax(c, v, division="garbled"), z,
         what="smx_softmax[garbled]")
    both(JG.garbled_rsqrt, TG.garbled_rsqrt, p, what="garbled_rsqrt")
    assert tc.tally.totals() == jc.tally.totals()
    assert tc.abort_flag() is bool(jc.abort_flag()) is False

    # the offline/online split: an offline run records the material, an
    # online run of the same program consumes it (the split and_level
    # entries for the boolean chains).  The offline run's words, materials
    # and totals() are JAX's offline run's; the online run's totals() are
    # JAX's online run's, but its words are JAX's *fused* run's: the port's
    # online run takes the offline run's PRF counters (ROADMAP F4), while
    # JAX's opens other words past the first skipped draw.
    def program(share, matmul_tr, relu, a2b, ctx, enc):
        xs, ws = share(ctx, enc(a)), share(ctx, enc(b))
        z = matmul_tr(ctx, xs, ws)
        return relu(ctx, z), a2b(ctx, z)

    jfns = (JP.share, JP.matmul_tr, JA.relu, JC.a2b)
    tfns = (TP.share, TP.matmul_tr, TA.relu, TC.a2b)
    fused = program(*jfns, jmake(jr, seed=SEED, collapse=collapse),
                    jr.encode)
    materials = None
    for mode in ("offline", "online"):
        jm = jmake(jr, seed=SEED, collapse=collapse, mode=mode)
        tm = tmake(tr, seed=SEED, collapse=collapse, mode=mode,
                   device="cpu")
        if materials is not None:
            jm.materials, tm.materials = materials
        TK.reset_launches()
        jouts = program(*jfns, jm, jr.encode)
        touts = program(*tfns, tm, tm.encode)
        # A2B's subtractor: one split-chain call (relu's BitExt and BitInj
        # have no AND)
        assert TK.AND_LEVEL.calls == 1, (mode, TK.AND_LEVEL.calls)
        for j, t in zip(fused if mode == "online" else jouts, touts):
            _assert_same(j, t, f"{mode} run RING{tr.ell}")
        assert tm.tally.totals() == jm.tally.totals()
        materials = jm.materials, tm.materials
    assert len(materials[0]) == len(materials[1]) == tm._mat_idx
    for i, (jmat, tmat) in enumerate(zip(*materials)):
        assert sorted(jmat) == sorted(tmat), i
        for key in jmat:
            _assert_same(jmat[key], tmat[key], f"material {i} {key}")
    assert tm.abort_flag() is bool(jm.abort_flag()) is False


def _u(rng, shape, dtype=np.uint64):
    return rng.randint(0, np.iinfo(dtype).max, size=shape,
                       dtype=np.uint64).astype(dtype)


def test_joint_kernel_plain_versions_match_jax():
    """and_level, mpc_matmul_fused and the ppa_msb loop: the port's plain
    versions (what its wrappers run on CPU tensors) against the JAX
    package's kernels, bit for bit; the fused product's limb twin against
    JAX's mpc_matmul_fused; the whole-chain adder and prefix-OR against
    integer sums and a word-by-word prefix-OR."""
    rng = np.random.RandomState(5)
    for n, dt in ((1024, np.uint64), (512, np.uint32)):
        x, y = _u(rng, (4, n), dt), _u(rng, (4, n), dt)
        lamz, zero = _u(rng, (3, n), dt), _u(rng, (3, n), dt)
        want = JK.bool_and_level(*map(jnp.asarray, (x, y, lamz, zero)))
        got = TK.and_level(*map(words_from_numpy, (x, y, lamz, zero)))
        _assert_same(want, got, f"and_level n={n} {dt.__name__}")
        # zero = None stands for zero shares (the collapsed world)
        got0 = and_level_plain(*map(words_from_numpy, (x, y, lamz)))
        want0 = JK.bool_and_level(*map(jnp.asarray, (
            x, y, lamz, np.zeros_like(zero))))
        _assert_same(want0, got0, f"and_level zero=None n={n}")
    _check_fused(rng, np.uint64)
    # the whole adder and prefix-OR chains: on zero lambdas and zero draws
    # their m words are x + y + cin and the prefix-OR; on random lambdas
    # and draws (faithful: 6 streams an AND; collapsed: 3, zero = None)
    # the opened words are
    for ell, dt in ((64, np.uint64), (32, np.uint32)):
        n = 300
        x, y = _u(rng, n, dt), _u(rng, n, dt)
        pre = x.copy()
        j = 1
        while j < ell:
            pre |= pre >> dt(j)
            j <<= 1
        tx, ty = words_from_numpy(x), words_from_numpy(y)
        zeros = torch.zeros((3, n), dtype=tx.dtype)
        X, Y = torch.cat([tx[None], zeros]), torch.cat([ty[None], zeros])

        def opened(t):
            return words_to_numpy(t[0] ^ t[1] ^ t[2] ^ t[3])

        for S in (6, 3):
            for cin in (0, 1):
                want = x + y + dt(cin)
                d = torch.zeros((chain_ands(ell, True), S, n),
                                dtype=tx.dtype)
                got = ppa_add_plain(X, Y, d, cin)
                assert np.array_equal(words_to_numpy(got[0]), want)
                assert not got[1:].any()
                xs = words_from_numpy(_u(rng, (4, n), dt))
                ys = words_from_numpy(_u(rng, (4, n), dt))
                d = words_from_numpy(_u(rng, d.shape, dt))
                assert np.array_equal(
                    opened(ppa_add_plain(xs, ys, d, cin)),
                    opened(xs) + opened(ys) + dt(cin)), (ell, S, cin)
            d = torch.zeros((chain_ands(ell, False), S, n), dtype=tx.dtype)
            got = prefix_or_plain(X, d, -1)
            assert np.array_equal(words_to_numpy(got[0]), pre)
            assert not got[1:].any()
            xs = words_from_numpy(_u(rng, (4, n), dt))
            d = words_from_numpy(_u(rng, d.shape, dt))
            v = opened(xs)
            j = 1
            while j < ell:
                v |= v >> dt(j)
                j <<= 1
            assert np.array_equal(opened(prefix_or_plain(xs, d, -1)), v)
    _check_msb_loop(rng, np.uint64)
    # RING32: the fused product, its limb twin and the msb loop on 32-bit
    # words (and_level and the chains above run both widths)
    _check_fused(rng, np.uint32)
    _check_msb_loop(rng, np.uint32)


def _check_fused(rng, dt):
    """mpc_matmul_fused's plain version and its limb twin against the JAX
    package's on `dt` words."""
    def operands(M, K, N):
        return (_u(rng, (M, K), dt), _u(rng, (3, M, K), dt),
                _u(rng, (K, N), dt), _u(rng, (3, K, N), dt))

    for M, K, N in ((64, 128, 64), (5, 37, 3)):
        ops_ = operands(M, K, N)
        want = JK.mpc_matmul_online(*map(jnp.asarray, ops_))
        got = TK.mpc_matmul_fused(*map(words_from_numpy, ops_))
        # the gamma term comes as the collapsed stack [gamma, 0, 0]
        assert got[2].shape == (3, M, N) and not got[2][1:].any()
        for name, jw, tw in zip(("mm", "cross", "gamma"), want,
                                (got[0], got[1], got[2][0])):
            _assert_same(jw, tw, f"mpc_matmul_fused.{name} {M}x{K}x{N} "
                         f"{dt.__name__}")
        assert all(torch.equal(p, q) for p, q in zip(
            got, mpc_matmul_fused_plain(*map(words_from_numpy, ops_))))
    # the kernel's limb arithmetic (wrapped lambda sums, 8-bit limbs, s32
    # sums over K chunks shorter than K) against the JAX package's kernel
    for (M, K, N), chunk in (((16, 40, 10), 16), ((8, 24, 8), 5)):
        ops_ = operands(M, K, N)
        want = jax_mpc_matmul_fused(*map(jnp.asarray, ops_))
        got = mpc_matmul_fused_limbs_plain(*map(words_from_numpy, ops_),
                                           chunk)
        for name, jw, tw in zip(("mm", "cross", "gamma"), want,
                                (got[0], got[1], got[2][0])):
            _assert_same(jw, tw, f"limbs.{name} {M}x{K}x{N} chunk {chunk} "
                         f"{dt.__name__}")
        assert not got[2][1:].any()


def _check_msb_loop(rng, dt):
    """The ppa_msb loop's plain version against the JAX package's loop and
    its reference on `dt` words."""
    n, levels = 512, int(np.log2(np.iinfo(dt).bits)) + 1
    x, y = _u(rng, n, dt), _u(rng, n, dt)
    lamz = _u(rng, (levels, 3, n), dt)
    raw = _u(rng, (levels, 2, n), dt)
    zero = np.stack([raw[:, 0], raw[:, 1], raw[:, 0] ^ raw[:, 1]], axis=1)
    got = TK.msb_of_sum_words(*map(words_from_numpy, (x, y, lamz, zero)))
    _assert_same(JK.msb_of_sum_words(*map(jnp.asarray, (x, y, lamz, zero))),
                 got, f"msb_of_sum_words {dt.__name__}")
    _assert_same(JR.ppa_msb_ref(jnp.asarray(x), jnp.asarray(y)), got,
                 f"msb_of_sum_words vs ppa_msb_ref {dt.__name__}")


@pytest.fixture(scope="module")
def nn_setup():
    params = JML.mlp_net_init(np.random.RandomState(0), JML.MLPNet(*NET))
    queries = np.random.RandomState(1).randn(20, NET[0])
    return params, queries


def _jax_predict(params, nonlinear, ring):
    """The port's mlp_net_predict_joint in the JAX package: share X, then
    the weights, mlp_net_fwd on a TridentEngine, open."""
    net = JML.MLPNet(*NET)

    def predict(ctx, X):
        eng = JEngine(ctx, nonlinear=nonlinear)
        h = eng.from_plain(X)
        ws = {f"w{i}": JP.share(ctx, ring.encode(params[f"w{i}"]))
              for i in range(len(params))}
        p, _ = JML.mlp_net_fwd(eng, ws, net, h)
        return JP.reconstruct(ctx, p)
    return predict


def _serve(server, queries):
    for q in queries:
        server.submit(q)
    return server.flush()


def test_joint_serving_matches_jax(nn_setup):
    """PredictionServer on both packages: equal opened words (the tail
    batch padded) and equal ServeStats; one batch on the default garbled
    engine too; at RING64 and RING32."""
    params, queries = nn_setup
    net = TML.MLPNet(*NET)
    for jr, tr in RINGS:
        where = f"RING{tr.ell}"
        enc = TML.params_from_numpy(params, tr, "cpu")
        jsrv = JServer(_jax_predict(params, "newton", jr), batch_size=BATCH,
                       ring=jr, seed=SEED)
        jwords = np.stack(_serve(jsrv, queries))
        srv = PredictionServer(
            lambda ctx, X: TML.mlp_net_predict_joint(ctx, enc, net, X),
            batch_size=BATCH, ring=tr, seed=SEED, device="cpu")
        words = torch.stack(_serve(srv, queries))
        _assert_same(jwords, words, f"served words {where}")
        assert words.shape == (len(queries), NET[1][-1])
        for f in ("batches", "queries", "online_rounds", "online_bits",
                  "offline_bits"):
            assert getattr(srv.stats, f) == getattr(jsrv.stats, f), \
                (f, where)
        assert srv.stats.batches == 3 and srv.stats.aborted is False
        for k in ("queries", "lan_latency_ms", "wan_latency_s"):
            assert srv.report()[k] == jsrv.report()[k], (k, where)

        X = queries[:BATCH]
        jc = jmake(jr, seed=SEED)
        tc = tmake(tr, seed=SEED, device="cpu")
        _assert_same(_jax_predict(params, "garbled", jr)(jc, X),
                     TML.mlp_net_predict_joint(tc, enc, net, X,
                                               nonlinear="garbled"),
                     f"garbled-engine words {where}")
        assert tc.tally.totals() == jc.tally.totals(), where


def test_joint_collapsed_nn_and_runtime_twin(nn_setup):
    """The collapsed NN (the mpc_matmul_fused route) against JAX; and the
    port's faithful joint NN against its own party runtime on the same
    seed: the same words and the same totals; at RING64 and RING32."""
    params, queries = nn_setup
    net = TML.MLPNet(*NET)
    X = queries[:BATCH]
    for jr, tr in RINGS:
        where = f"RING{tr.ell}"
        enc = TML.params_from_numpy(params, tr, "cpu")
        jc = jmake(jr, seed=SEED, collapse=True)
        tc = tmake(tr, seed=SEED, collapse=True, device="cpu")
        words = TML.mlp_net_predict_joint(tc, enc, net, X)
        _assert_same(_jax_predict(params, "newton", jr)(jc, X), words,
                     f"collapsed NN words {where}")
        assert tc.tally.totals() == jc.tally.totals(), where

        fc = tmake(tr, seed=SEED, device="cpu")
        joint = TML.mlp_net_predict_joint(fc, enc, net, X)
        rt = FourPartyRuntime(tr, seed=SEED, device="cpu")
        assert torch.equal(joint,
                           TML.mlp_net_predict_runtime(rt, enc, net, X))
        assert fc.tally.totals() == rt.transport.totals(), where
        assert not fc.abort_flag() and not rt.abort_flag()
        # other PRF draws, other words
        assert not torch.equal(joint, words), where
        np.testing.assert_allclose(tr.decode(joint).numpy(),
                                   tr.decode(words).numpy(), atol=1e-3,
                                   err_msg=where)


def test_engine_op_surface_matches_jax():
    """The engines' shared op surface (shape ops on logical axes, public
    scaling, embedding): TridentEngine word for word against the JAX
    package's on one context stream, at RING64 and RING32; PlainEngine
    against its float64 twin."""
    from repro.nn import model as JM
    from repro.nn.engine import PlainEngine as JPlain
    from repro_torch.nn import model as TM
    from repro_torch.nn.engine import PlainEngine, TridentEngine

    rng = np.random.RandomState(3)
    a, b = rng.randn(2, 3, 4), rng.randn(2, 3, 4)
    ids = np.array([[2, 0], [1, 1]])
    dy = rng.randn(2, 2, 4)
    table = rng.randn(3, 4)
    mask = np.array([1, 0, 1, 1])

    def program(eng, M):
        x, y = eng.from_plain(a), eng.from_plain(b)
        t = eng.from_plain(table)
        outs = [eng.reshape(x, (6, 4)), eng.transpose(x, (2, 0, 1)),
                eng.concat([x, y], axis=1)]
        outs += eng.split(x, (1, 2), axis=1)
        outs += [eng.take(x, ids, axis=1), eng.pad_zeros(x, ((0, 1), (2, 0),
                                                             (0, 0))),
                 eng.sum(x, axis=-1, keepdims=True), eng.mean(x, axis=1),
                 eng.stack_to_new_axis([x, y], axis=1), eng.embed(t, ids),
                 eng.embed_bwd(t, ids, eng.from_plain(dy)),
                 eng.scale(x, 4.0), eng.scale(x, -2.0), eng.scale(x, 0.3),
                 eng.mul_public(x, b), eng.add_public(x, b),
                 eng.lincomb_public([(x, 0.5), (y, -1.25)]),
                 eng.mask_public(x, (b > 0).astype(np.int64))]
        # activations with their backward halves (the default garbled
        # route for division-like ops on TridentEngine)
        pos = eng.from_plain(np.abs(b) + 0.5)
        r, rc = eng.relu(x)
        s, sc = eng.sigmoid(x)
        p, pc = eng.softmax(x, axis=-1, mask=mask)
        u, uc = eng.silu(x)
        outs += [r, eng.relu_bwd(rc, y), s, eng.sigmoid_bwd(sc, y), p,
                 eng.softmax_bwd(pc, y, mask=mask), u, eng.silu_bwd(uc, y),
                 eng.square(x)[0], eng.rsqrt(pos)[0], eng.reciprocal(pos),
                 eng.mul(x, y), eng.matmul(eng.reshape(x, (6, 4)),
                                           eng.transpose(t, (1, 0)))]
        # the model's lm_head product, and the identity between prefill
        # and decode caches
        outs.append(M.linear_fwd_model(eng, {"w": eng.transpose(t, (1, 0))},
                                       x)[0])
        assert M.prepare_decode_caches(eng, None, outs) is outs
        return outs

    # collapsed contexts: the protocols' faithful paths are the first
    # test's; this one is about the engine layer
    w_r, w_l = rng.randint(0, 5, (4, 5)), rng.randint(0, 5, (5, 6))
    for jr, tr in RINGS:
        where = f"RING{tr.ell}"
        jc = jmake(jr, seed=SEED, collapse=True)
        tc = tmake(tr, seed=SEED, collapse=True, device="cpu")
        jouts, touts = program(JEngine(jc), JM), \
            program(TridentEngine(tc), TM)
        for i, (j, t) in enumerate(zip(jouts, touts)):
            _assert_same(j, t, f"TridentEngine op {i} {where}")
        assert tc.tally.totals() == jc.tally.totals(), where
        # AShare.matmul_public, both sides, through the ring matmul
        _assert_same(jouts[0].matmul_public(w_r),
                     touts[0].matmul_public(w_r), f"matmul_public {where}")
        _assert_same(jouts[0].matmul_public(w_l, right=False),
                     touts[0].matmul_public(w_l, right=False),
                     f"matmul_public(right=False) {where}")
    pouts = program(PlainEngine(device="cpu"), TM)
    for i, (j, p) in enumerate(zip(program(JPlain(jnp.float64), JM),
                                   pouts)):
        np.testing.assert_allclose(p.numpy(), np.asarray(j), rtol=1e-12,
                                   atol=1e-12, err_msg=f"PlainEngine op {i}")
