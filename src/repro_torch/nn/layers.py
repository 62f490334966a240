"""Model layers over the Engine interface, forward and serving side
(``repro/nn/layers.py``).

Every layer runs privately (``TridentEngine``: [[.]]-shares and the 4PC
protocols) and in the clear (``PlainEngine``: the correctness oracle) from
the same code.  Every layer exposes, as in the JAX package,

    fwd(eng, params, x, ...)    -> (y, cache)
    bwd(eng, params, cache, dy) -> (dx, grads-dict)

(integer share words have no autograd: backprop is written by hand, as
the paper does).  A weight gradient dW = X^T @ dY is one truncating
matmul whose cost does not depend on the contraction (token) length.

Public tensors the layers build (rope tables, attention masks, token ids)
go to the engine's device.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core.shares import AShare
from .engine import Engine, TridentEngine
from . import recurrent as R


def _device(eng) -> torch.device:
    return eng.ctx.device if isinstance(eng, TridentEngine) else eng.device


# ---------------------------------------------------------------------------
# Linear
# ---------------------------------------------------------------------------
def linear_init(rng: np.random.RandomState, d_in: int, d_out: int,
                scale: float | None = None):
    s = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return {"w": (rng.randn(d_in, d_out) * s).astype(np.float64)}


def linear_fwd(eng: Engine, params, x):
    y = eng.matmul(x, params["w"])
    return y, (x,)


def linear_bwd(eng: Engine, params, cache, dy):
    (x,) = cache
    # flatten leading dims for the weight gradient contraction
    d_in = eng.shape_of(x)[-1]
    d_out = eng.shape_of(dy)[-1]
    x2 = eng.reshape(x, (-1, d_in))
    dy2 = eng.reshape(dy, (-1, d_out))
    dw = eng.matmul(eng.transpose(x2, (1, 0)), dy2)
    dx = eng.matmul(dy, eng.transpose(params["w"], (1, 0)))
    return dx, {"w": dw}


# ---------------------------------------------------------------------------
# Embedding (public token ids)
# ---------------------------------------------------------------------------
def embedding_init(rng, vocab: int, d_model: int):
    return {"table": (rng.randn(vocab, d_model) * 0.02).astype(np.float64)}


def embedding_fwd(eng: Engine, params, ids):
    ids = torch.as_tensor(ids).to(dtype=torch.int64, device=_device(eng))
    return eng.embed(params["table"], ids), (ids,)


def embedding_bwd(eng: Engine, params, cache, dy):
    """The table's gradient: dy's rows summed into their ids' rows (a
    repeated id sums, mod 2^ell on shares)."""
    (ids,) = cache
    return None, {"table": eng.embed_bwd(params["table"], ids, dy)}


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------
def rmsnorm_init(_rng, d: int):
    return {"g": np.ones((d,), np.float64)}


def rmsnorm_fwd(eng: Engine, params, x, eps: float = 1e-5):
    sq, _ = eng.square(x)
    ms = eng.mean(sq, axis=-1, keepdims=True)
    ms = eng.add_public(ms, eps)
    inv, _ = eng.rsqrt(ms)
    inv_b = _broadcast_like(eng, inv, x)
    xhat = eng.mul(x, inv_b)
    g_b = _broadcast_param(eng, params["g"], x)
    y = eng.mul(xhat, g_b)
    return y, (xhat, inv, params["g"])


def rmsnorm_bwd(eng: Engine, _params, cache, dy):
    xhat, inv, g = cache
    g_b = _broadcast_param(eng, g, dy)
    dxhat = eng.mul(dy, g_b)
    prod = eng.mul(dxhat, xhat)
    m = eng.mean(prod, axis=-1, keepdims=True)
    m_b = _broadcast_like(eng, m, dy)
    inner = eng.sub(dxhat, eng.mul(xhat, m_b))
    inv_b = _broadcast_like(eng, inv, dy)
    dx = eng.mul(inner, inv_b)
    # dg = sum over all leading dims of dy * xhat
    dg_full = eng.mul(dy, xhat)
    d = eng.shape_of(dy)[-1]
    dg = eng.sum(eng.reshape(dg_full, (-1, d)), axis=0)
    return dx, {"g": dg}


def _broadcast_like(eng: Engine, small, like):
    """Broadcast a (..., 1) tensor against `like` (component-aware)."""
    if isinstance(eng, TridentEngine):
        return AShare(small.data.expand(like.data.shape))
    return small.expand(like.shape)


def _broadcast_param(eng: Engine, p, like):
    """A parameter already stored as an engine tensor, broadcast to `like`
    (right-aligned, numpy-style, component axis preserved)."""
    if isinstance(eng, TridentEngine):
        d = p.data
        missing = like.data.dim() - d.dim()
        if missing > 0:
            d = d.reshape(d.shape[:1] + (1,) * missing + d.shape[1:])
        return AShare(d.expand(like.data.shape))
    return p.expand(like.shape)


# ---------------------------------------------------------------------------
# RoPE -- a public rotation: linear, communication-free on shares.
# ---------------------------------------------------------------------------
def rope_tables(seq: int, d_head: int, theta: float = 10000.0,
                offset: int = 0):
    half = d_head // 2
    freqs = 1.0 / (theta ** (np.arange(half) / half))
    pos = np.arange(offset, offset + seq)[:, None] * freqs[None, :]
    return np.cos(pos), np.sin(pos)          # (seq, half)


def rope_apply(eng: Engine, x, cos, sin, inverse: bool = False):
    """x: (B, H, S, dh).  Public-matrix rotation on (first, second) halves,
    one truncation an output (``lincomb_public``)."""
    dh = eng.shape_of(x)[-1]
    half = dh // 2
    x1 = _last_slice(eng, x, 0, half)
    x2 = _last_slice(eng, x, half, dh)
    sin_ = -sin if inverse else sin
    y1 = eng.lincomb_public([(x1, cos), (x2, -sin_)])
    y2 = eng.lincomb_public([(x1, sin_), (x2, cos)])
    return eng.concat([y1, y2], axis=-1)


def _last_slice(eng: Engine, x, a, b):
    if isinstance(eng, TridentEngine):
        return AShare(x.data[..., a:b])
    return x[..., a:b]


# ---------------------------------------------------------------------------
# GQA attention with the paper's relu-normalized softmax (smx).
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    qk_norm: bool = False
    window: int | None = None        # sliding-window attention (mixtral)
    causal: bool = True
    rope_theta: float = 10000.0


def attention_init(rng, cfg: AttnConfig):
    d, H, Hk, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    p = {
        "wq": linear_init(rng, d, H * dh)["w"],
        "wk": linear_init(rng, d, Hk * dh)["w"],
        "wv": linear_init(rng, d, Hk * dh)["w"],
        "wo": linear_init(rng, H * dh, d)["w"],
    }
    if cfg.qk_norm:
        p["qnorm_g"] = np.ones((dh,), np.float64)
        p["knorm_g"] = np.ones((dh,), np.float64)
    return p


def _window_mask(q_pos, k_pos, causal: bool, window):
    m = torch.ones(torch.broadcast_shapes(q_pos.shape, k_pos.shape),
                   dtype=torch.bool, device=q_pos.device)
    if causal:
        m = m & (k_pos <= q_pos)
    if window is not None:
        m = m & (k_pos > q_pos - window)
    return m


def attn_mask(cfg: AttnConfig, s_q: int, s_k: int, offset: int = 0,
              device=None):
    """Public causal / sliding-window mask (s_q, s_k), True = attend."""
    q_pos = torch.arange(s_q, device=device)[:, None] + offset
    k_pos = torch.arange(s_k, device=device)[None, :]
    return _window_mask(q_pos, k_pos, cfg.causal, cfg.window)


def _split_heads(eng, x, n_heads, d_head):
    b, s, _ = eng.shape_of(x)
    x = eng.reshape(x, (b, s, n_heads, d_head))
    return eng.transpose(x, (0, 2, 1, 3))           # (B,H,S,dh)


def _merge_heads(eng, x):
    b, h, s, dh = eng.shape_of(x)
    x = eng.transpose(x, (0, 2, 1, 3))
    return eng.reshape(x, (b, s, h * dh))


def _repeat_kv(eng, x, groups: int):
    """(B,Hk,S,dh) -> (B,Hk*groups,S,dh) by repetition (local)."""
    if groups == 1:
        return x
    if isinstance(eng, TridentEngine):
        return AShare(torch.repeat_interleave(x.data, groups, dim=2))
    return torch.repeat_interleave(x, groups, dim=1)


def _qkv(eng, params, cfg: AttnConfig, x):
    """The heads of q, k and v, qk-normed where the config says."""
    H, Hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q, cq = linear_fwd(eng, {"w": params["wq"]}, x)
    k, ck = linear_fwd(eng, {"w": params["wk"]}, x)
    v, cv = linear_fwd(eng, {"w": params["wv"]}, x)
    q = _split_heads(eng, q, H, dh)
    k = _split_heads(eng, k, Hk, dh)
    v = _split_heads(eng, v, Hk, dh)
    qk_caches = None
    if cfg.qk_norm:
        q, cqn = rmsnorm_fwd(eng, {"g": params["qnorm_g"]}, q)
        k, ckn = rmsnorm_fwd(eng, {"g": params["knorm_g"]}, k)
        qk_caches = (cqn, ckn)
    return q, k, v, (cq, ck, cv, qk_caches)


def attention_fwd(eng: Engine, params, cfg: AttnConfig, x,
                  kv_cache=None, pos_offset: int = 0):
    """x: (B,S,D).  kv_cache: optional dict(k,v) of (B,Hk,S_past,dh);
    returns (y, cache, new_kv)."""
    b, s, d = eng.shape_of(x)
    H, Hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q, k, v, (cq, ck, cv, qk_caches) = _qkv(eng, params, cfg, x)
    cos, sin = rope_tables(s, dh, cfg.rope_theta, offset=pos_offset)
    q = rope_apply(eng, q, cos, sin)
    k = rope_apply(eng, k, cos, sin)

    if kv_cache is not None:
        k = eng.concat([kv_cache["k"], k], axis=2)
        v = eng.concat([kv_cache["v"], v], axis=2)
    new_kv = {"k": k, "v": v}
    s_k = eng.shape_of(k)[2]

    groups = H // Hk
    k_full = _repeat_kv(eng, k, groups)
    v_full = _repeat_kv(eng, v, groups)

    kt = eng.transpose(k_full, (0, 1, 3, 2))         # (B,H,dh,Sk)
    scores = eng.matmul(q, kt)                       # (B,H,S,Sk)
    scores = eng.scale(scores, 1.0 / math.sqrt(dh))
    # q tokens are the last s positions of the s_k key axis
    mask = attn_mask(cfg, s, s_k, offset=s_k - s, device=_device(eng))
    probs, csm = eng.softmax(scores, axis=-1, mask=mask)
    ctx_v = eng.matmul(probs, v_full)                # (B,H,S,dh)
    merged = _merge_heads(eng, ctx_v)
    y, co = linear_fwd(eng, {"w": params["wo"]}, merged)
    cache = (cq, ck, cv, qk_caches, (q, k_full, v_full, probs, csm), co)
    return y, cache, new_kv


def _attn_core_bwd(eng, cfg: AttnConfig, core, dy, co, wo, mask):
    """The shared middle of attention_bwd and cross_attention_bwd: from
    dy back through wo, probs @ v, the smx softmax and q k^T.  Returns
    (dq, dk, dv) by head, the KV repetition summed back per group, and
    wo's gradient."""
    q, k_full, v_full, probs, csm = core
    H, Hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    groups = H // Hk
    dmerged, g_o = linear_bwd(eng, {"w": wo}, co, dy)
    dctx = _split_heads(eng, dmerged, H, dh)          # (B,H,S,dh)
    # ctx = probs @ v
    dprobs = eng.matmul(dctx, eng.transpose(v_full, (0, 1, 3, 2)))
    dv_full = eng.matmul(eng.transpose(probs, (0, 1, 3, 2)), dctx)
    dscores = eng.softmax_bwd(csm, dprobs, mask=mask)
    dscores = eng.scale(dscores, 1.0 / math.sqrt(dh))
    dq = eng.matmul(dscores, k_full)                  # (B,H,S,dh)
    dk_full = eng.matmul(eng.transpose(dscores, (0, 1, 3, 2)), q)
    # undo the KV repetition: sum the grads across each group
    dk = _sum_groups(eng, dk_full, Hk, groups)
    dv = _sum_groups(eng, dv_full, Hk, groups)
    return dq, dk, dv, g_o["w"]


def attention_bwd(eng: Engine, params, cfg: AttnConfig, cache, dy):
    cq, ck, cv, qk_caches, core, co = cache
    dh = cfg.d_head
    s, s_k = eng.shape_of(core[0])[2], eng.shape_of(core[1])[2]
    mask = attn_mask(cfg, s, s_k, offset=s_k - s, device=_device(eng))
    dq, dk, dv, g_o = _attn_core_bwd(eng, cfg, core, dy, co, params["wo"],
                                     mask)
    cos, sin = rope_tables(s, dh, cfg.rope_theta)
    dq = rope_apply(eng, dq, cos, sin, inverse=True)
    dk = rope_apply(eng, dk, cos, sin, inverse=True)
    grads = {}
    if cfg.qk_norm:
        cqn, ckn = qk_caches
        dq, gq = rmsnorm_bwd(eng, {"g": params["qnorm_g"]}, cqn, dq)
        dk, gk = rmsnorm_bwd(eng, {"g": params["knorm_g"]}, ckn, dk)
        grads["qnorm_g"] = gq["g"]
        grads["knorm_g"] = gk["g"]

    dx1, g_q = linear_bwd(eng, {"w": params["wq"]}, cq, _merge_heads(eng, dq))
    dx2, g_k = linear_bwd(eng, {"w": params["wk"]}, ck, _merge_heads(eng, dk))
    dx3, g_v = linear_bwd(eng, {"w": params["wv"]}, cv, _merge_heads(eng, dv))
    dx = eng.add(eng.add(dx1, dx2), dx3)
    grads.update({"wq": g_q["w"], "wk": g_k["w"], "wv": g_v["w"], "wo": g_o})
    return dx, grads


def _sum_groups(eng, x, hk, groups):
    """(B, Hk*groups, S, dh) -> (B, Hk, S, dh): each KV head's repeated
    copies summed (the gradient of ``_repeat_kv``)."""
    if groups == 1:
        return x
    b, h, s, dh = eng.shape_of(x)
    x = eng.reshape(x, (b, hk, groups, s, dh))
    return eng.sum(x, axis=2)


# ---------------------------------------------------------------------------
# Cross attention (whisper decoder): q from x, k/v from the encoder output.
# ---------------------------------------------------------------------------
def cross_attention_fwd(eng: Engine, params, cfg: AttnConfig, x, enc_out):
    """x: (B,S,D) decoder stream; enc_out: (B,S_enc,D)."""
    H, Hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q, cq = linear_fwd(eng, {"w": params["wq"]}, x)
    k, ck = linear_fwd(eng, {"w": params["wk"]}, enc_out)
    v, cv = linear_fwd(eng, {"w": params["wv"]}, enc_out)
    q = _split_heads(eng, q, H, dh)
    k = _split_heads(eng, k, Hk, dh)
    v = _split_heads(eng, v, Hk, dh)
    groups = H // Hk
    k_full = _repeat_kv(eng, k, groups)
    v_full = _repeat_kv(eng, v, groups)
    kt = eng.transpose(k_full, (0, 1, 3, 2))
    scores = eng.matmul(q, kt)
    scores = eng.scale(scores, 1.0 / math.sqrt(dh))
    probs, csm = eng.softmax(scores, axis=-1, mask=None)
    ctx_v = eng.matmul(probs, v_full)
    merged = _merge_heads(eng, ctx_v)
    y, co = linear_fwd(eng, {"w": params["wo"]}, merged)
    return y, (cq, ck, cv, (q, k_full, v_full, probs, csm), co)


def cross_attention_bwd(eng: Engine, params, cfg: AttnConfig, cache, dy):
    """Returns (dx, d_enc_out, grads)."""
    cq, ck, cv, core, co = cache
    dq, dk, dv, g_o = _attn_core_bwd(eng, cfg, core, dy, co, params["wo"],
                                     None)
    dx, g_q = linear_bwd(eng, {"w": params["wq"]}, cq, _merge_heads(eng, dq))
    de1, g_k = linear_bwd(eng, {"w": params["wk"]}, ck, _merge_heads(eng, dk))
    de2, g_v = linear_bwd(eng, {"w": params["wv"]}, cv, _merge_heads(eng, dv))
    d_enc = eng.add(de1, de2)
    grads = {"wq": g_q["w"], "wk": g_k["w"], "wv": g_v["w"], "wo": g_o}
    return dx, d_enc, grads


# ---------------------------------------------------------------------------
# Inference attention: q-chunked.  The paper's relu-normalized smx softmax
# is linear in the key axis, so a query chunk's rows need no other chunk:
# the (S, S_k) score matrix never materializes at once.
# ---------------------------------------------------------------------------
def attention_prefill(eng: Engine, params, cfg: AttnConfig, x,
                      q_chunk: int | None = None, want_kv: bool = True):
    """Forward-only attention for serving; returns (y, kv).  Scores are
    computed a query chunk of q_chunk rows at a time against all keys, as
    a loop with the JAX package's ``lax.scan`` semantics (``scan_loop``)."""
    b, s, d = eng.shape_of(x)
    H, Hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q, k, v, _ = _qkv(eng, params, cfg, x)
    cos, sin = rope_tables(s, dh, cfg.rope_theta)
    q = rope_apply(eng, q, cos, sin)
    k = rope_apply(eng, k, cos, sin)
    kv = {"k": k, "v": v} if want_kv else None

    groups = H // Hk
    k_full = _repeat_kv(eng, k, groups)
    v_full = _repeat_kv(eng, v, groups)
    kt = eng.transpose(k_full, (0, 1, 3, 2))
    dev = _device(eng)

    C = s if q_chunk is None else min(q_chunk, s)
    if C == s:
        scores = eng.matmul(q, kt)
        scores = eng.scale(scores, 1.0 / math.sqrt(dh))
        mask = attn_mask(cfg, s, s, offset=0, device=dev)
        probs, _ = eng.softmax(scores, axis=-1, mask=mask)
        ctx_v = eng.matmul(probs, v_full)
    else:
        nc = s // C
        qc = eng.reshape(eng.transpose(q, (2, 0, 1, 3)), (nc, C, b, H, dh))
        k_pos = torch.arange(s, device=dev)[None, :]

        def body(carry, i):
            qi = eng.transpose(_chunk(eng, qc, i), (1, 2, 0, 3))  # (B,H,C,dh)
            sc = eng.matmul(qi, kt)                       # (B,H,C,S)
            sc = eng.scale(sc, 1.0 / math.sqrt(dh))
            q_pos = i * C + torch.arange(C, device=dev)[:, None]
            m = _window_mask(q_pos, k_pos, True, cfg.window)
            yi, _ = eng.softmax(sc, axis=-1, mask=m)
            yi = eng.matmul(yi, v_full)                   # (B,H,C,dh)
            return carry, eng.transpose(yi, (2, 0, 1, 3))  # (C,B,H,dh)

        _, ys = R.scan_loop(eng, nc, "attn_prefill", body)
        yc = eng.concat(ys, axis=0)                       # (S,B,H,dh)
        ctx_v = eng.transpose(yc, (1, 2, 0, 3))           # (B,H,S,dh)
    merged = _merge_heads(eng, ctx_v)
    y, _ = linear_fwd(eng, {"w": params["wo"]}, merged)
    return y, kv


def _chunk(eng, xc, i: int):
    if isinstance(eng, TridentEngine):
        return AShare(xc.data[:, i])
    return xc[i]


def attention_decode(eng: Engine, params, cfg: AttnConfig, x, kv_cache,
                     pos: int):
    """One-token decode: x (B,1,D); kv_cache k/v (B,Hk,S_past,dh).
    Returns (y, new_kv).  Sliding-window archs keep only the last
    cfg.window positions."""
    H, Hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q, k, v, _ = _qkv(eng, params, cfg, x)
    cos, sin = rope_tables(1, dh, cfg.rope_theta, offset=pos)
    q = rope_apply(eng, q, cos, sin)
    k = rope_apply(eng, k, cos, sin)
    k_all = eng.concat([kv_cache["k"], k], axis=2)       # (B,Hk,S+1,dh)
    v_all = eng.concat([kv_cache["v"], v], axis=2)
    if cfg.window is not None:
        s_tot = eng.shape_of(k_all)[2]
        if s_tot > cfg.window:
            k_all = _last_slice_axis2(eng, k_all, cfg.window)
            v_all = _last_slice_axis2(eng, v_all, cfg.window)
    new_kv = {"k": k_all, "v": v_all}
    groups = H // Hk
    k_full = _repeat_kv(eng, k_all, groups)
    v_full = _repeat_kv(eng, v_all, groups)
    scores = eng.matmul(q, eng.transpose(k_full, (0, 1, 3, 2)))  # (B,H,1,S+1)
    scores = eng.scale(scores, 1.0 / math.sqrt(dh))
    probs, _ = eng.softmax(scores, axis=-1, mask=None)   # causal: all past
    ctx_v = eng.matmul(probs, v_full)
    y, _ = linear_fwd(eng, {"w": params["wo"]}, _merge_heads(eng, ctx_v))
    return y, new_kv


def _last_slice_axis2(eng, x, n):
    if isinstance(eng, TridentEngine):
        return AShare(x.data[:, :, :, -n:])
    return x[:, :, -n:]


def cross_attention_decode(eng: Engine, params, cfg: AttnConfig, x, enc_kv):
    """Decode-time cross attention against a fixed encoder cache."""
    H, Hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q, _ = linear_fwd(eng, {"w": params["wq"]}, x)
    q = _split_heads(eng, q, H, dh)
    groups = H // Hk
    k_full = _repeat_kv(eng, enc_kv["k"], groups)
    v_full = _repeat_kv(eng, enc_kv["v"], groups)
    scores = eng.matmul(q, eng.transpose(k_full, (0, 1, 3, 2)))
    scores = eng.scale(scores, 1.0 / math.sqrt(dh))
    probs, _ = eng.softmax(scores, axis=-1, mask=None)
    ctx_v = eng.matmul(probs, v_full)
    y, _ = linear_fwd(eng, {"w": params["wo"]}, _merge_heads(eng, ctx_v))
    return y
