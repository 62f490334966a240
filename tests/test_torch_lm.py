"""The port's LM stack (``repro_torch.nn.layers``, ``blocks``, ``model``,
``recurrent``, ``configs``) against the JAX package's on the same seeds:
the layers, the recurrent blocks and the loop seam bit for bit (the seam:
a JAX ``lax.scan`` body traced once draws the same counters under each
iteration's key; the port's loop must draw the same words), the model's
serving path against JAX's ``PlainEngine``, the port's secure run
against its own plain one and its words against the JAX package's pinned
digests.  The model-level bit-for-bit comparison that runs JAX, too slow
here (JAX compiles every scan body), is ``tools/torch_lm_vs_jax.py``, which
prints those digests.  Five items: the suite's wall time is held near
its limit."""
import dataclasses
import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as JCFG  # noqa: E402
from repro.core import protocols as JP  # noqa: E402
from repro.core.context import make_context as jmake  # noqa: E402
from repro.core.ring import RING64 as J64  # noqa: E402
from repro.core.shares import AShare as JShare  # noqa: E402
from repro.nn import blocks as JB  # noqa: E402
from repro.nn import layers as JL  # noqa: E402
from repro.nn import model as JM  # noqa: E402
from repro.nn import recurrent as JR  # noqa: E402
from repro.nn.engine import PlainEngine as JPlain  # noqa: E402
from repro.nn.engine import TridentEngine as JEngine  # noqa: E402
from repro_torch import configs as TCFG  # noqa: E402
from repro_torch.core import protocols as TP  # noqa: E402
from repro_torch.core.context import make_context as tmake  # noqa: E402
from repro_torch.core.prf import ThreefryKey  # noqa: E402
from repro_torch.core.ring import RING64 as T64, words_to_numpy  # noqa: E402
from repro_torch.core.shares import AShare as TShare  # noqa: E402
from repro_torch.kernels import ops as TK  # noqa: E402
from repro_torch.nn import blocks as TB  # noqa: E402
from repro_torch.nn import layers as TL  # noqa: E402
from repro_torch.nn import model as TM  # noqa: E402
from repro_torch.nn import recurrent as TR  # noqa: E402
from repro_torch.nn.engine import PlainEngine as TPlain  # noqa: E402
from repro_torch.nn.engine import TridentEngine as TEngine  # noqa: E402

SEED = 5
# the attention and the recurrent families the port serves, SMOKE widths
SERVED = ("qwen3_1_7b", "mixtral_8x7b", "whisper_tiny", "phi_3_vision_4_2b")
RECURRENT = ("zamba2_7b", "xlstm_350m")
# the port's secure serve against its own float64 run.  The embedding
# table is served at scale 0.5 (EMBED_SCALE x init_params' 0.02): at 0.02
# fixed point's 13 fractional bits quantize rmsnorm's mean square to a few
# units of 2^-13 and the secure logits lie as far from float64 as logits
# of their own size (ROADMAP N1; the JAX package opens the same words).
# tools/torch_lm_rehearsal.py on the CPU at scale 0.5, four SMOKE families
# at one layer, 3 seeds, faithful and collapsed: the largest error 0.0081
# of the largest float64 logit, relative L2 error up to 0.0071 (0.0088
# and 0.0076 at d_model 256); the recurrent families' SMOKE (zamba2 uncut,
# also with long_ctx, and xlstm, 16 ids and 2 decode steps): 0.0104 and
# 0.0081 (0.0080 and 0.0075 at d_model 256).  Held: both within 0.02; an
# all-zero output (relative L2 1) and the float64 logits shuffled fail
# them.
EMBED_SCALE = 25.0
ERR_PER_LOGIT = 0.02
MAX_REL_L2 = 0.02
# The JAX package's serve on its TridentEngine, collapsed, from
# init_params(cfg, 0) at context seed 5: the attention families' SMOKE
# cut to one layer, serve_prefill of (2, 8) ids and one serve_decode step;
# the recurrent families' SMOKE uncut (zamba2's shared block applied
# twice), (2, 16) ids (two chunks) and two decode steps, zamba2 also with
# long_ctx and long_window 12 ("zamba2_7b+long_ctx"); mixtral at one layer
# with long_ctx and long_window 12 (its window of 4 widened), (2, 16) ids
# and two decode steps ("mixtral_8x7b+long_ctx").  The sha256 of its
# logits and cache words, totals() and abort flag, as
# tools/torch_lm_vs_jax.py prints it (JAX 0.9.0 on the CPU; the tool
# itself holds the port's words to JAX's, leaf by leaf).  The port's run
# must give the same digest: the words of params_to_engine's draws, the
# segments' and chunks' loop keys, the KV cache and state plumbing and the
# frontend inputs.
JAX_SERVE_DIGESTS = {
    "qwen3_1_7b":
        "15dc957fe4eb45465aac032e50874f31eba78bf97c1746561ab0be87db309085",
    "mixtral_8x7b":
        "92ea4584dea8a70824de5b32c15d117dd7e7e5079554eb1f1ce9a7047825c1ab",
    "whisper_tiny":
        "8c7a7f10e9516f9de1da926773c77e6b12edbbb4f948292d458d801e5705f56b",
    "phi_3_vision_4_2b":
        "62725e7d5c2369a160d2f5ee7eeeeee981de34a0044d2079f6d4c10ccc9fffc1",
    "zamba2_7b":
        "41dac942610d02ee2f70c08384fc451401777f55df5373e31d2fc8734e0c5a5d",
    "xlstm_350m":
        "79a4dd7834d1506f91fe9abf338db51fefc228751898e1fa929d086600e12786",
    "zamba2_7b+long_ctx":
        "2f53a4060cc7b3fc447e46a5aa994f09774d617b97990c512adfc486c1431d64",
    "mixtral_8x7b+long_ctx":
        "1dc3828d140dc348c664748f7014a630caea93957e39a349dfb0d0cc79adec91",
}
_VS_JAX = pathlib.Path(__file__).resolve().parents[1] / "tools" / \
    "torch_lm_vs_jax.py"


def _vs_jax():
    """tools/torch_lm_vs_jax.py as a module (its port runner and digest)."""
    spec = importlib.util.spec_from_file_location("torch_lm_vs_jax", _VS_JAX)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _words(x) -> np.ndarray:
    x = getattr(x, "data", x)
    return words_to_numpy(x) if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _same(jx, tx, what):
    j, t = _words(jx), _words(tx)
    assert j.shape == t.shape and j.dtype == t.dtype, what
    assert np.array_equal(j, t), f"{what}: words differ"


def _pair(collapse=False):
    jc = jmake(J64, seed=SEED, collapse=collapse)
    tc = tmake(T64, seed=SEED, collapse=collapse, device="cpu")
    return jc, tc, JEngine(jc), TEngine(tc)


def _same_ctx(jc, tc, what):
    assert jc.tally.totals() == tc.tally.totals(), f"{what}: totals differ"
    assert jc._counter == tc._counter, f"{what}: PRF counters differ"
    assert bool(jc.abort_flag()) is tc.abort_flag() is False, what


def _conv(eng, tree):
    return {k: _conv(eng, v) if isinstance(v, dict) else eng.from_plain(v)
            for k, v in sorted(tree.items())}


def _attn(rng, je, te, **kw):
    """Random attention weights (16-wide model, 2 heads of 8) as shares in
    both packages."""
    acfg = dict(d_model=16, n_heads=2, n_kv_heads=1, d_head=8, **kw)
    jcfg, tcfg = JL.AttnConfig(**acfg), TL.AttnConfig(**acfg)
    p = JL.attention_init(rng, jcfg)
    return jcfg, tcfg, _conv(je, p), _conv(te, p)


def _both(rng, je, te, *shape):
    x = rng.randn(*shape) * 0.5
    return je.from_plain(x), te.from_plain(x)


def test_lm_seam_prefill_and_k2_match_jax():
    """(1) The split twin against jax.random.split; faithful at RING64,
    bit for bit against JAX: (2) the loop seam, a two-iteration JAX
    lax.scan of share + mult_tr under ctx.scan_keys against the port's
    scan_loop (words, totals(), the counter after the loop, checks);
    (3) attention_prefill (GQA, qk_norm: rmsnorm_fwd on the heads) with
    q_chunk None and q_chunk < s (four one-row chunks through
    scan_loop); (4) the K2 plain path: batched and broadcast products
    against torch.matmul, N-D x 2-D products on the 2-D kernel's
    count."""
    for seed, fold in ((SEED, None), (2**40 + 3, 17)):
        jkey, tkey = jax.random.key(seed), ThreefryKey.from_seed(seed)
        if fold is not None:
            jkey, tkey = jax.random.fold_in(jkey, fold), tkey.fold_in(fold)
        want = np.asarray(jax.random.key_data(jax.random.split(jkey, 5)))
        got = np.array([k.data for k in tkey.split(5)], np.uint32)
        assert np.array_equal(want, got), (seed, fold)

    jc, tc, je, te = _pair()
    rng = np.random.RandomState(0)
    x0 = rng.randn(3, 4) * 0.5
    vs = np.asarray(J64.encode(rng.randn(2, 3, 4) * 0.5))
    jcarry, tcarry = JP.share(jc, J64.encode(x0)), TP.share(tc, T64.encode(x0))
    jkeys = JR._layer_keys(je, 2, "seam")

    def jbody(carry, xs):
        with jc.scan_keys(xs["key"]):
            mark = jc.begin_body()
            y = JP.mult_tr(jc, JP.share(jc, xs["v"]), JShare(carry))
            ok = jc.end_body(mark)
        return y.data, {"y": y.data, "ok": ok}

    with jc.tally.scaled(2):
        jfin, jys = jax.lax.scan(jbody, jcarry.data, {"v": vs, "key": jkeys})
    jc.absorb_checks(jys["ok"])
    tvs = torch.from_numpy(vs.view(np.int64).copy())

    def tbody(carry, i):
        y = TP.mult_tr(tc, TP.share(tc, tvs[i]), TShare(carry))
        return y.data, y.data

    tfin, tys = TR.scan_loop(te, 2, "seam", tbody, tcarry.data)
    _same(jfin, tfin, "seam carry")
    _same(jys["y"], torch.stack(tys), "seam outputs")
    _same_ctx(jc, tc, "seam")
    assert tc._counter > 0 and tc.ledger.checks, "seam: nothing drawn"

    jcfg, tcfg, jp, tp = _attn(rng, je, te, qk_norm=True, rope_theta=1e6)
    jx, tx = _both(rng, je, te, 1, 4, 16)
    for qc in (None, 1):
        jy, jkv = JL.attention_prefill(je, jp, jcfg, jx, q_chunk=qc)
        ty, tkv = TL.attention_prefill(te, tp, tcfg, tx, q_chunk=qc)
        _same(jy, ty, f"attention_prefill q_chunk={qc}")
        _same(jkv["k"], tkv["k"], f"attention_prefill k q_chunk={qc}")
        _same(jkv["v"], tkv["v"], f"attention_prefill v q_chunk={qc}")
        _same_ctx(jc, tc, f"attention_prefill q_chunk={qc}")

    g = torch.Generator().manual_seed(1)

    def w(*shape):
        return torch.randint(-2**62, 2**62, shape, generator=g,
                             dtype=torch.int64)

    TK.reset_launches()
    cases = (((2, 3, 5, 7), (2, 3, 7, 4)),      # scores-like
             ((2, 3, 5, 7), (7, 4)),            # linear: the 2-D kernel
             ((3, 5, 7), (1, 7, 4)),            # broadcast batch
             ((5, 7), (3, 7, 4)),               # a 2-D left operand
             ((2, 1, 5, 7), (1, 3, 7, 4)))      # both broadcast
    for sa, sb in cases:
        a, b = w(*sa), w(*sb)
        assert torch.equal(TK.ring_matmul(a, b), torch.matmul(a, b)), sa
    a32 = w(3, 5, 7).to(torch.int32)
    b32 = w(3, 7, 4).to(torch.int32)
    assert torch.equal(TK.ring_matmul(a32, b32), torch.matmul(a32, b32))
    assert (TK.RING_MATMUL.calls, TK.RING_MATMUL_BATCHED.calls) == (1, 5)
    assert TK.RING_MATMUL_BATCHED.launches == 0


def test_lm_decode_and_blocks_match_jax():
    """Bit for bit against JAX at RING64: faithful, attention_decode (GQA,
    qk_norm) over 3 cached positions and cross_attention_fwd of one
    decoder token over 4 encoder positions (its scores the decode step's
    (1, 2, 1, 4): eager JAX compiles each op at each new shape, so the
    shapes repeat where they can); collapsed, moe_fwd with dense
    routing."""
    jc, tc, je, te = _pair()
    rng = np.random.RandomState(1)
    jcfg, tcfg, jp, tp = _attn(rng, je, te, qk_norm=True, rope_theta=1e6)
    past = {k: _both(rng, je, te, 1, 1, 3, 8) for k in "kv"}
    jpast = {k: v[0] for k, v in past.items()}
    tpast = {k: v[1] for k, v in past.items()}
    jx, tx = _both(rng, je, te, 1, 1, 16)
    jy, jkv = JL.attention_decode(je, jp, jcfg, jx, jpast, 3)
    ty, tkv = TL.attention_decode(te, tp, tcfg, tx, tpast, 3)
    _same(jy, ty, "attention_decode")
    _same(jkv["k"], tkv["k"], "attention_decode k")
    _same(jkv["v"], tkv["v"], "attention_decode v")
    _same_ctx(jc, tc, "attention_decode")
    jcfg, tcfg, jp, tp = _attn(rng, je, te)
    jenc, tenc = _both(rng, je, te, 1, 4, 16)
    jy, _ = JL.cross_attention_fwd(je, jp, jcfg, jx, jenc)
    ty, _ = TL.cross_attention_fwd(te, tp, tcfg, tx, tenc)
    _same(jy, ty, "cross_attention_fwd")
    _same_ctx(jc, tc, "cross_attention_fwd")

    jc, tc, je, te = _pair(collapse=True)
    jy, ty, _, _ = _moe(je, te, rng, "dense", rng.randn(1, 5, 16) * 0.5)
    _same(jy, ty, "moe_fwd dense")
    _same_ctx(jc, tc, "moe_fwd dense")


def test_lm_recurrent_blocks_match_jax():
    """The recurrent blocks bit for bit against the JAX package's, run
    live at RING64, faithful then collapsed: retention_fwd over x of
    (2, 16, 32) (4 heads, d_k = d_v = 8, seq_chunk 8: two chunks through
    scan_loop "ret_fwd", the state crossing a chunk boundary),
    retention_step from its state, slstm_fwd (two chunks of "slstm_fwd":
    the public decay contractions through the ring matmul) and slstm_step
    from its state.  Output words, the carried state, totals(), the PRF
    counter and the abort flag after each block."""
    rng = np.random.RandomState(7)
    rc = dict(d_model=32, n_heads=4, d_k=8, d_v=8, seq_chunk=8)
    sc = dict(d_model=32, n_heads=4, seq_chunk=8)
    rp = JR.retention_init(rng, JR.RetentionConfig(**rc))
    sp = JR.slstm_init(rng, JR.SLSTMConfig(**sc))
    x, x1 = rng.randn(2, 16, 32) * 0.5, rng.randn(2, 1, 32) * 0.5
    for collapse in (False, True):
        mode = "collapsed" if collapse else "faithful"
        jc, tc, je, te = _pair(collapse)
        jx, tx, jx1, tx1 = (e.from_plain(v) for v in (x, x1) for e in (je, te))
        for name, M, c in (("retention", "Retention", rc),
                           ("slstm", "SLSTM", sc)):
            jcfg = getattr(JR, f"{M}Config")(**c)
            tcfg = getattr(TR, f"{M}Config")(**c)
            p = rp if name == "retention" else sp
            jp, tp = _conv(je, p), _conv(te, p)
            fwd, step = f"{name}_fwd", f"{name}_step"
            jy, _, jst = getattr(JR, fwd)(je, jp, jcfg, jx)
            ty, _, tst = getattr(TR, fwd)(te, tp, tcfg, tx)
            _same(jy, ty, f"{fwd} {mode}")
            _same(jst, tst, f"{fwd} {mode} state")
            _same_ctx(jc, tc, f"{fwd} {mode}")
            jy, jst = getattr(JR, step)(je, jp, jcfg, jx1, jst)
            ty, tst = getattr(TR, step)(te, tp, tcfg, tx1, tst)
            _same(jy, ty, f"{step} {mode}")
            _same(jst, tst, f"{step} {mode} state")
            _same_ctx(jc, tc, f"{step} {mode}")
        assert tc._counter > 0 and tc.tally.totals()["online"]["rounds"]


def _check_mlp():
    """mlp_fwd swiglu and relu2, faithful, bit for bit against JAX."""
    jc, tc, je, te = _pair()
    rng = np.random.RandomState(2)
    jx, tx = _both(rng, je, te, 1, 4, 16)
    for act in ("swiglu", "relu2"):
        mk = dict(d_model=16, d_ff=16, act=act)
        mp = JB.mlp_init(rng, JB.MLPConfig(**mk))
        jy, _ = JB.mlp_fwd(je, _conv(je, mp), JB.MLPConfig(**mk), jx)
        ty, _ = TB.mlp_fwd(te, _conv(te, mp), TB.MLPConfig(**mk), tx)
        _same(jy, ty, f"mlp_fwd {act}")
        _same_ctx(jc, tc, f"mlp_fwd {act}")


def _moe(je, te, rng, routing, x):
    """moe_fwd of `x` (B, S, 16) through both packages: 4 experts of
    width 16, top-2, capacity factor 1 (E x capacity = T x k: the slots'
    and the picks' shapes agree)."""
    mk = dict(d_model=16, d_ff=16, n_experts=4, top_k=2, act="swiglu",
              routing=routing, capacity_factor=1.0)
    mp = JB.moe_init(rng, JB.MoEConfig(**mk))
    if routing == "public":
        # every token's first choice is expert 3 and its last expert 0;
        # experts 1 and 2 share router columns, equal scores up to the
        # truncations' last bit
        mp["router"][:, 3] = np.abs(mp["router"][:, 3]) + 0.5
        mp["router"][:, 0] = -np.abs(mp["router"][:, 0]) - 0.5
        mp["router"][:, 2] = mp["router"][:, 1]
    jy, jc_ = JB.moe_fwd(je, _conv(je, mp), JB.MoEConfig(**mk),
                         je.from_plain(x))
    ty, tc_ = TB.moe_fwd(te, _conv(te, mp), TB.MoEConfig(**mk),
                         te.from_plain(x))
    return jy, ty, jc_, tc_


def _check_moe(monkeypatch):
    """moe_fwd with public routing, collapsed, bit for bit against JAX
    (10 positive tokens x top-2 into 4 experts of capacity 5, over
    capacity; experts 1 and 2 on equal router columns, exact ties in some
    tokens' scores); the top-k's tie order against jax.lax.top_k; the dispatch bookkeeping
    against JAX's on routings that overflow capacity."""
    scores = np.array([[0.5, 0.25, 0.5, 0.125], [1, 1, 1, 0],
                       [0, 0.75, 0.75, 0.75]], np.float32)
    want = np.asarray(jax.lax.top_k(jnp.asarray(scores), 2)[1])
    assert np.array_equal(TB.top_k_indices(torch.from_numpy(scores), 2),
                          want)
    rs = np.random.RandomState(3)
    for _ in range(4):
        top = rs.randint(0, 4, size=(12, 2)).astype(np.int32)
        top[:6, 0] = 3                                # overflow expert 3
        for j, t in zip(JB._dispatch_indices(jnp.asarray(top), 4, 4),
                        TB._dispatch_indices(torch.from_numpy(top), 4, 4)):
            assert np.array_equal(np.asarray(j), t.numpy())

    jc, tc, je, te = _pair(collapse=True)
    rng = np.random.RandomState(4)
    seen = []

    def top_k(scores, k):
        seen.append(scores)
        return top_k_indices(scores, k)

    top_k_indices = TB.top_k_indices
    monkeypatch.setattr(TB, "top_k_indices", top_k)
    x = np.abs(rng.randn(2, 5, 16)) * 0.5 + 0.5
    jy, ty, jcache, tcache = _moe(je, te, rng, "public", x)
    _same(jy, ty, "moe_fwd public")
    _same_ctx(jc, tc, "moe_fwd public")
    top = tcache[-1].numpy()
    assert np.array_equal(np.asarray(jcache[-1]), top), "top-k"
    # first choices all expert 3 (5 tokens over its 5 slots); on the
    # tokens whose declassified scores of experts 1 and 2 tie exactly, the
    # second choice is expert 1, as jax.lax.top_k chooses
    scores = seen[0].numpy()
    tied = scores[:, 1] == scores[:, 2]
    assert tied.any(), "no tie in the declassified scores"
    assert (top[:, 0] == 3).all() and (top[tied, 1] == 1).all()
    assert int((tcache[7] == 0).sum()) >= 5, "assignments over capacity"


def _serve(M, eng, cfg, params, conv):
    """serve_prefill of (2, 8) ids (with the frontend's embeddings) and one
    serve_decode step: (prefill logits, decode logits, decode caches)."""
    ids = np.random.RandomState(1).randint(0, cfg.vocab, size=(2, 8))
    rs = np.random.RandomState(2)
    kw = {}
    if cfg.family == "vlm":
        kw["frontend_embs"] = conv(rs.randn(2, cfg.frontend_tokens,
                                            cfg.d_model) * 0.5)
    if cfg.family == "encdec":
        kw["enc_inputs"] = conv(rs.randn(2, cfg.frontend_tokens,
                                         cfg.d_model) * 0.5)
    pe = M.params_to_engine(eng, params)
    lg, caches = M.serve_prefill(eng, cfg, pe, ids, **kw)
    pos = 8 + (cfg.frontend_tokens if cfg.family == "vlm" else 0)
    lg2, caches2 = M.serve_decode(eng, cfg, pe, ids[:, -1:], caches, pos)
    return lg, lg2, caches2


def _close(want, got, rows=False):
    """`got` within ERR_PER_LOGIT of the largest float64 logit and within
    MAX_REL_L2 of `want` in relative L2; rows=True: the two figures."""
    err = np.abs(want - got).max() / np.abs(want).max()
    rel = np.linalg.norm(want - got) / np.linalg.norm(want)
    if rows:
        return err, rel
    return err <= ERR_PER_LOGIT and rel <= MAX_REL_L2


def _f64(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x,
                      np.float64)


def test_lm_moe_mlp_and_serve_match(monkeypatch):
    """MoE and MLP bit for bit against JAX (``_check_moe``,
    ``_check_mlp``); the secure serve of the four families (collapsed,
    one layer) bit for bit against the JAX package's pinned digests
    (JAX_SERVE_DIGESTS).  Every CONFIG /
    SMOKE field, the registry and the 40-cell grid equal to JAX's; for
    qwen3 (dense, qk_norm), mixtral (moe, window), whisper (encdec) and
    phi-3-vision (vlm) SMOKE: the port's PlainEngine prefill + decode
    within 1e-9 of JAX's PlainEngine (float64; logits and KV caches), and
    for qwen3 the full forward's logits; the port's
    TridentEngine (collapsed, one layer) within the rehearsal's bounds of
    its own plain run (the embedding at scale 0.5), no abort, where
    all-zero or shuffled logits fall outside the bounds.  The recurrent
    families and long_ctx: test_lm_recurrent_and_long_ctx_serve_match."""
    _check_moe(monkeypatch)
    _check_mlp()
    assert TCFG.ARCHS == JCFG.ARCHS and TCFG.ALIASES == JCFG.ALIASES
    assert TCFG.SHAPES == JCFG.SHAPES
    assert TCFG.LONG_CONTEXT_ARCHS == JCFG.LONG_CONTEXT_ARCHS
    assert TCFG.cells() == JCFG.cells() and len(TCFG.cells()) == 40
    assert TCFG.cells(False) == JCFG.cells(False)
    for arch in JCFG.ARCHS:
        for name in ("CONFIG", "SMOKE"):
            j = dataclasses.asdict(getattr(JCFG.get(arch), name))
            t = dataclasses.asdict(getattr(TCFG.get(arch), name))
            assert j == t, (arch, name)
            assert getattr(TCFG.get(arch), name).segments() == getattr(
                JCFG.get(arch), name).segments()

    vs = _vs_jax()
    for arch in SERVED:
        assert vs.digest(vs.run_port(arch, 1, True)) == \
            JAX_SERVE_DIGESTS[arch], f"{arch}: the serve's words differ " \
            f"from the JAX package's"
        jcfg, tcfg = JCFG.get(arch).SMOKE, TCFG.get(arch).SMOKE
        params = TM.init_params(tcfg, 0)
        jparams = JM.init_params(jcfg, 0)
        assert all(np.array_equal(a, b) for a, b in zip(
            jax.tree_util.tree_leaves(jparams),
            [leaf for _, leaf in _tree_leaves(params)])), arch
        jpe = JPlain(dtype=jnp.float64)
        tpe = TPlain(device="cpu")
        j = _serve(JM, jpe, jcfg, jparams, jpe.from_plain)
        t = _serve(TM, tpe, tcfg, params, tpe.from_plain)
        if arch == "qwen3_1_7b":
            # the training-side forward: every position's logits
            ids = np.random.RandomState(3).randint(0, tcfg.vocab, (2, 8))
            jf, _ = JM.forward(jpe, jcfg, JM.params_to_engine(jpe, jparams),
                               ids)
            tf, _ = TM.forward(tpe, tcfg, TM.params_to_engine(tpe, params),
                               ids)
            assert np.abs(_f64(jf) - _f64(tf)).max() <= 1e-9, (arch, "fwd")
        for what, a, b in zip(("prefill", "decode"), j[:2], t[:2]):
            assert np.abs(_f64(a) - _f64(b)).max() <= 1e-9, (arch, what)
        for seg_j, seg_t in zip(j[2], t[2]):
            for (pa, a), (pb, b) in zip(_tree_leaves(seg_j),
                                        _tree_leaves(seg_t)):
                assert pa == pb and _f64(a).shape == _f64(b).shape
                assert np.abs(_f64(a) - _f64(b)).max() <= 1e-9, (arch, pa)

        one = dataclasses.replace(tcfg, n_layers=1, n_encoder_layers=min(
            tcfg.n_encoder_layers, 1))
        p1 = TM.init_params(one, 0)
        p1["embed"]["table"] *= EMBED_SCALE
        plain = _serve(TM, tpe, one, p1, tpe.from_plain)
        ctx = tmake(T64, seed=SEED, collapse=True, device="cpu")
        eng = TEngine(ctx)
        sec = _serve(TM, eng, one, p1, eng.from_plain)
        assert not ctx.abort_flag(), arch
        for what, a, b in zip(("prefill", "decode"), plain[:2], sec[:2]):
            a, b = _f64(a), _f64(eng.to_plain(b))
            assert _close(a, b), (arch, what, _close(a, b, rows=True))
            shuffled = np.random.RandomState(0).permutation(a.reshape(-1))
            assert not _close(a, np.zeros_like(a)), (arch, what)
            assert not _close(a, shuffled.reshape(a.shape)), (arch, what)


def test_lm_recurrent_and_long_ctx_serve_match():
    """The recurrent families' serve and the long_ctx windows against
    JAX: zamba2 (hybrid: two retention groups, the shared block applied
    twice) and xlstm (ssm) SMOKE uncut, zamba2 with long_ctx (the shared
    block's window) and mixtral with long_ctx at one layer (an attention
    kind's window widened from 4), each through ``_check_long_serve``."""
    vs = _vs_jax()
    for case in RECURRENT + ("zamba2_7b" + vs.LONG, "mixtral_8x7b" + vs.LONG):
        _check_long_serve(vs, case)


def _serve_long(M, eng, cfg, params, long_ctx, steps=2, jit=None):
    """serve_prefill of (2, 16) ids (two chunks) and `steps` serve_decode
    steps, each jitted by `jit` when given: ([the steps' logits], the last
    caches)."""
    ids = np.random.RandomState(1).randint(0, cfg.vocab, size=(2, 16))

    def prefill(pe, ids):
        return M.serve_prefill(eng, cfg, pe, ids, long_ctx=long_ctx)

    def decode(pe, ids, caches, pos):
        return M.serve_decode(eng, cfg, pe, ids, caches, pos,
                              long_ctx=long_ctx)

    if jit is not None:
        prefill, decode = jit(prefill), jit(decode, static_argnums=3)
    pe = M.params_to_engine(eng, params)
    out = [prefill(pe, ids)]
    for t in range(steps):
        out.append(decode(pe, ids[:, -1:], out[-1][1], 16 + t))
    return [lg for lg, _ in out], out[-1][1]


def _check_long_serve(vs, case):
    """A case of the recurrent and long_ctx serve (SMOKE; the recurrent
    families uncut, the attention families at one layer; `case` +
    "+long_ctx": long_window 12, below the prefill): init_params equal to
    JAX's (the shared block's set drawn last); the port's PlainEngine
    serve within 1e-9 of JAX's, JAX's run jitted (logits of the prefill
    and of two decode steps, one with long_ctx, and every state and KV
    cache leaf) and, for a recurrent family without long_ctx, its full
    forward's logits; the port's secure serve (collapsed) hashed against
    JAX_SERVE_DIGESTS (two decode steps) and, with the embedding at scale
    0.5, within the rehearsal's bounds of its own plain run (zeros and
    shuffled logits must fail)."""
    assert vs.digest(vs.run_port(case, 1, True)) == JAX_SERVE_DIGESTS[case], \
        f"{case}: the serve's words differ from the JAX package's"
    jcfg, long_ctx = vs.case_config(JCFG.get, case, 1)
    tcfg, _ = vs.case_config(TCFG.get, case, 1)
    recurrent = tcfg.family in ("hybrid", "ssm")
    params, jparams = TM.init_params(tcfg, 0), JM.init_params(jcfg, 0)
    assert [p for p, _ in _tree_leaves(params)][-1].startswith(
        "/shared_attn") == (jcfg.family == "hybrid"), case
    assert all(np.array_equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(jparams),
        [leaf for _, leaf in _tree_leaves(params) if leaf is not None],
        strict=True)), case
    jpe, tpe = JPlain(dtype=jnp.float64), TPlain(device="cpu")
    steps = 1 if long_ctx else 2
    j = _serve_long(JM, jpe, jcfg, jparams, long_ctx, steps, jit=jax.jit)
    t = _serve_long(TM, tpe, tcfg, params, long_ctx, steps)
    for i, (a, b) in enumerate(zip(j[0], t[0], strict=True)):
        assert np.abs(_f64(a) - _f64(b)).max() <= 1e-9, (case, "step", i)
    jl, tl = list(_tree_leaves(j[1])), list(_tree_leaves(t[1]))
    assert [p for p, _ in jl] == [p for p, _ in tl], case
    for (pa, a), (_, b) in zip(jl, tl):
        assert _f64(a).shape == _f64(b).shape, (case, pa)
        assert np.abs(_f64(a) - _f64(b)).max() <= 1e-9, (case, pa)
    if long_ctx:
        kv = t[1][-1]["k"]
        assert kv.shape[-2] == tcfg.long_window < 16, (case, kv.shape)
    elif recurrent:
        # the training-side forward: every position's logits
        ids = np.random.RandomState(3).randint(0, tcfg.vocab, (2, 16))
        jf = jax.jit(lambda pe, ids: JM.forward(jpe, jcfg, pe, ids)[0])(
            JM.params_to_engine(jpe, jparams), ids)
        tf, _ = TM.forward(tpe, tcfg, TM.params_to_engine(tpe, params), ids)
        assert np.abs(_f64(jf) - _f64(tf)).max() <= 1e-9, (case, "fwd")

    params["embed"]["table"] *= EMBED_SCALE
    plain, _ = _serve_long(TM, tpe, tcfg, params, long_ctx)
    ctx = tmake(T64, seed=SEED, collapse=True, device="cpu")
    eng = TEngine(ctx)
    sec, _ = _serve_long(TM, eng, tcfg, params, long_ctx)
    assert not ctx.abort_flag(), case
    for i, (a, b) in enumerate(zip(plain, sec)):
        a, b = _f64(a), _f64(eng.to_plain(b))
        assert _close(a, b), (case, i, _close(a, b, rows=True))
        shuffled = np.random.RandomState(0).permutation(a.reshape(-1))
        assert not _close(a, np.zeros_like(a)), (case, i)
        assert not _close(a, shuffled.reshape(a.shape)), (case, i)


def _tree_leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tree_leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from _tree_leaves(t, f"{path}[{i}]")
    else:
        yield path, tree
