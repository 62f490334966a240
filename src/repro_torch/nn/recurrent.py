"""Loop helpers of the model stack (``repro/nn/recurrent.py``): the
leaf/wrap plumbing of its layer and chunk loops, the per-layer PRF keys,
the checks of a loop body, and ``scan_loop``, which runs a loop body with
the semantics of the JAX package's ``lax.scan``.  A loop body indexes its
inputs itself, so the JAX package's scan-layout moves (``_scan_leaf``,
``_unscan_leaf``) and its null scope for the plain engine (``_scan_ctx``)
have no counterpart here.

A ``lax.scan`` body is traced ONCE.  So every iteration draws the same PRF
counters ``c0 .. c0 + k - 1``, each under its own key (``ctx.scan_keys``
with the iteration's ``_layer_keys`` key), and the counter stands at
``c0 + k`` after the loop; the body's tally counts once, scaled by the
iteration count; the body's checks leave it folded into one boolean an
iteration.  ``scan_loop`` runs the body once an iteration and reproduces
all three: it sets the counter back to ``c0`` before each iteration,
tallies the first iteration scaled by the count and the others not at
all, and folds each iteration's checks.  A loop that kept counting would
draw other words from the second iteration on.

The recurrent blocks, forward and serving side: a retention-style matrix
state (zamba2's Mamba2 layers, xlstm's mLSTM) and an sLSTM-style scalar
state, each with a public per-head decay a_h and secret gates.  Under a
public decay the linear recurrence costs no communication: within a chunk
of C positions it is a public decay-matrix contraction, across chunks a
first-order carry; only the projections, the state contractions and the
gates pay for products.  Each chunk loop is a ``scan_loop`` (tags
``"ret_fwd"`` and ``"slstm_fwd"``), so a chunk's PRF draws are the JAX
package's.  ``retention_step`` and ``slstm_step`` take one token against
the carried state (decode).  ``retention_bwd`` and ``slstm_bwd`` run the
chunks in reverse (``scan_loop(..., reverse=True)``, tags ``"ret_bwd"``
and ``"slstm_bwd"``), carrying the state's gradient back a chunk at a
time.  Inside the model's backward segment loop these chunk loops nest
in a loop of their own: their keys come from the master key and the tag
alone, so their masks repeat from layer to layer, as the JAX package's do
(ROADMAP N2).  The public decay contractions (``_pub_left``) take the
engine's encoding and truncation hooks on every engine, so a plain
engine that models fixed point reaches them too.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import zlib

import numpy as np
import torch

from ..core.shares import AShare
from ..kernels import ops
from . import layers as L
from .engine import Engine, TridentEngine


def _is_triv(eng) -> bool:
    return isinstance(eng, TridentEngine)


def _leaf(eng, x):
    """Engine tensor -> raw tensor (a share's (4, ...) stack)."""
    return x.data if _is_triv(eng) else x


def _wrap(eng, x):
    """Raw tensor -> engine tensor."""
    return AShare(x) if _is_triv(eng) else x


def _checks_begin(eng):
    return eng.ctx.ledger.begin_body() if _is_triv(eng) else 0


def _checks_end(eng, mark):
    return eng.ctx.ledger.end_body(mark) if _is_triv(eng) else None


def _checks_absorb(eng, oks) -> None:
    if _is_triv(eng) and eng.ctx.malicious_checks:
        eng.ctx.ledger.absorb(oks)


def _layer_keys(eng, n: int, tag: str) -> list:
    """Per-iteration PRF keys of a loop: ``split(fold_in(master,
    crc32(tag)), n)``, the JAX package's for the same tag."""
    if not _is_triv(eng):
        return [None] * n
    tid = zlib.crc32(tag.encode()) & 0x7FFFFFFF
    return eng.ctx.keys.master.fold_in(tid).split(n)


def scan_loop(eng, n: int, tag, body, carry=None, reverse: bool = False):
    """``lax.scan`` of ``body(carry, i) -> (carry, out)`` over i < n, as
    the JAX package traces it (module docstring); returns (carry, [out for
    each i]), the outs in index order.  `reverse`: ``lax.scan(...,
    reverse=True)``, i from n - 1 down to 0; each iteration still takes
    the key of its own index, and the first to run is tallied.

    `tag` a tuple of tags: a body with several key sets, as the JAX
    package's backward segment scan has (the remat forward under the
    forward's keys, the backward under its own).  The body then runs under
    none of them and is called as ``body(carry, i, scopes)``, where
    ``scopes[j]`` is the context of tag j's key for iteration i.  On the
    plain engine a plain loop (its scopes do nothing)."""
    tags = tag if isinstance(tag, tuple) else None
    order = range(n - 1, -1, -1) if reverse else range(n)
    outs = [None] * n
    if not _is_triv(eng):
        null = [contextlib.nullcontext] * len(tags or ())
        for i in order:
            carry, out = body(carry, i, null) if tags else body(carry, i)
            outs[i] = out
        return carry, outs
    ctx = eng.ctx
    keys = [_layer_keys(eng, n, t) for t in (tags or (tag,))]
    c0 = ctx._counter
    oks = [None] * n
    for step, i in enumerate(order):
        ctx._counter = c0
        mark = _checks_begin(eng)
        with ctx.tally.scaled(n if step == 0 else 0):
            if tags:
                scopes = [lambda ks=ks, i=i: ctx.scan_keys(ks[i])
                          for ks in keys]
                carry, out = body(carry, i, scopes)
            else:
                with ctx.scan_keys(keys[0][i]):
                    carry, out = body(carry, i)
        oks[i] = _checks_end(eng, mark)
        outs[i] = out
    _checks_absorb(eng, oks)
    return carry, outs


def stack_outs(outs: list, dim: int = 0):
    """Loop outputs (tensors, or dicts and lists of them) stacked along a
    new axis `dim`, leaf by leaf (``lax.scan``'s ys)."""
    first = outs[0]
    if isinstance(first, dict):
        return {k: stack_outs([o[k] for o in outs], dim) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(stack_outs([o[i] for o in outs], dim)
                           for i in range(len(first)))
    return torch.stack(outs, dim)


# ---------------------------------------------------------------------------
# Config / init
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class RetentionConfig:
    d_model: int
    n_heads: int
    d_k: int                 # state width (zamba2 ssm_state, e.g. 64)
    d_v: int                 # value head dim (d_model // n_heads)
    seq_chunk: int = 128


@dataclasses.dataclass(frozen=True)
class SLSTMConfig:
    d_model: int
    n_heads: int
    seq_chunk: int = 128


def head_decays(n_heads: int) -> np.ndarray:
    """Public per-head decay a_h = 1 - 2^-(5 + h*3/H) (RetNet schedule)."""
    h = np.arange(n_heads)
    return 1.0 - 2.0 ** (-5.0 - 3.0 * h / max(n_heads - 1, 1))


def retention_init(rng, cfg: RetentionConfig):
    d, H, dk, dv = cfg.d_model, cfg.n_heads, cfg.d_k, cfg.d_v
    p = {
        "wq": L.linear_init(rng, d, H * dk)["w"],
        "wk": L.linear_init(rng, d, H * dk)["w"],
        "wv": L.linear_init(rng, d, H * dv)["w"],
        "wo": L.linear_init(rng, H * dv, d)["w"],
    }
    p["wg"] = L.linear_init(rng, d, H * dv)["w"]   # the silu gate
    return p


def slstm_init(rng, cfg: SLSTMConfig):
    d = cfg.d_model
    return {
        "wi": L.linear_init(rng, d, d)["w"],
        "wz": L.linear_init(rng, d, d)["w"],
        "wo": L.linear_init(rng, d, d)["w"],
        "wout": L.linear_init(rng, d, d)["w"],
    }


# ---------------------------------------------------------------------------
# Public decay tables (float64 numpy: applying them costs no communication)
# ---------------------------------------------------------------------------
def _decay_tables(decay: np.ndarray, C: int):
    """Per-head (H,) decay a -> public chunk tables:
    D (H,C,C) lower-tri a^{i-j}; u (H,C) = a^{i+1}; w (H,C) = a^{C-1-j};
    ac (H,) = a^C."""
    i = np.arange(C)[:, None]
    j = np.arange(C)[None, :]
    expnt = np.clip(i - j, 0, None)
    D = np.where(i >= j, decay[:, None, None] ** expnt[None], 0.0)
    u = decay[:, None] ** (np.arange(C)[None, :] + 1)
    w = decay[:, None] ** (C - 1 - np.arange(C)[None, :])
    ac = decay ** C
    return D, u, w, ac


def _proj_heads(eng, x, w, H, dh):
    """(B,S,D) @ w -> (B,H,S,dh)."""
    y, cache = L.linear_fwd(eng, {"w": w}, x)
    b, s, _ = eng.shape_of(x)
    y = eng.reshape(y, (b, s, H, dh))
    return eng.transpose(y, (0, 2, 1, 3)), cache


def _unproj_heads(eng, y):
    b, h, s, dh = eng.shape_of(y)
    y = eng.transpose(y, (0, 2, 1, 3))
    return eng.reshape(y, (b, s, h * dh))


def _chunks(eng, x, C):
    """(B,H,S,dh) -> (nc, B,H,C,dh): chunk i is ``L._chunk(eng, xc, i)``."""
    b, h, s, dh = eng.shape_of(x)
    nc = s // C
    x = eng.reshape(x, (b, h, nc, C, dh))
    return eng.transpose(x, (2, 0, 1, 3, 4)), nc


def _unchunks(eng, x):
    nc, b, h, C, dh = eng.shape_of(x)
    x = eng.transpose(x, (1, 2, 0, 3, 4))
    return eng.reshape(x, (b, h, nc * C, dh))


def _split_like(eng, x, H, dh):
    b, s, _ = eng.shape_of(x)
    x = eng.reshape(x, (b, s, H, dh))
    return eng.transpose(x, (0, 2, 1, 3))


def _stack_chunks(eng, outs):
    """A chunk loop's raw outputs -> the chunked tensor (nc, B,H,C,dh)."""
    return eng.stack_to_new_axis([_wrap(eng, o) for o in outs], axis=0)


# ---------------------------------------------------------------------------
# Retention forward: chunked loop carrying the (B,H,dk,dv) state.
# ---------------------------------------------------------------------------
def retention_fwd(eng: Engine, params, cfg: RetentionConfig, x):
    """x: (B,S,D) -> (y, cache, new_state), the state (B,H,dk,dv) run
    from zero."""
    H, dk, dv, C = cfg.n_heads, cfg.d_k, cfg.d_v, cfg.seq_chunk
    b, s, d = eng.shape_of(x)
    C = min(C, s)
    assert s % C == 0, (s, C)
    D, u, w, ac = _decay_tables(head_decays(H), C)

    q, cq = _proj_heads(eng, x, params["wq"], H, dk)
    k, ck = _proj_heads(eng, x, params["wk"], H, dk)
    v, cv = _proj_heads(eng, x, params["wv"], H, dv)
    scale = 1.0 / math.sqrt(dk)

    qc, nc = _chunks(eng, q, C)           # (nc,B,H,C,dk)
    kc, _ = _chunks(eng, k, C)
    vc, _ = _chunks(eng, v, C)

    state = eng.zeros((b, H, dk, dv))

    Dp = D[None]                                    # (1,H,C,C) public
    up = u[None, :, :, None]                        # (1,H,C,1)
    wp = w[None, :, :, None]
    acp = ac[None, :, None, None]

    def body(carry, i):
        Sm = _wrap(eng, carry)
        qi, ki, vi = (L._chunk(eng, t, i) for t in (qc, kc, vc))
        s_qk = eng.matmul(qi, eng.transpose(ki, (0, 1, 3, 2)))
        s_m = eng.mul_public(s_qk, Dp * scale)      # public decay mask
        y_intra = eng.matmul(s_m, vi)
        q_u = eng.mul_public(qi, up * scale)
        y_inter = eng.matmul(q_u, Sm)
        kw = eng.mul_public(ki, wp)
        S_new = eng.add(
            eng.mul_public(Sm, acp),
            eng.matmul(eng.transpose(kw, (0, 1, 3, 2)), vi))
        y = eng.add(y_intra, y_inter)
        return _leaf(eng, S_new), (_leaf(eng, y), _leaf(eng, Sm))

    final_state, outs = scan_loop(eng, nc, "ret_fwd", body, _leaf(eng, state))
    y_heads = _unchunks(eng, _stack_chunks(eng, [y for y, _ in outs]))
    y_flat = _unproj_heads(eng, y_heads)            # (B,S,H*dv)

    g_lin, cg = L.linear_fwd(eng, {"w": params["wg"]}, x)
    g, cact = eng.silu(g_lin)
    gate_cache = (cg, cact, g, y_flat)
    out, co = L.linear_fwd(eng, {"w": params["wo"]}, eng.mul(y_flat, g))
    cache = (cq, ck, cv, q, k, v, [sm for _, sm in outs], gate_cache, co)
    return out, cache, _wrap(eng, final_state)


def retention_bwd(eng: Engine, params, cfg: RetentionConfig, cache, dy):
    """The chunks in reverse, carrying dL/dS back from the last chunk's
    state (zero: the final state is not an output); each chunk recomputes
    its masked scores rather than keeping them.  Returns (dx, grads)."""
    cq, ck, cv, q, k, v, Sm_list, gate_cache, co = cache
    H, dk, dv = cfg.n_heads, cfg.d_k, cfg.d_v
    b, _, s, _ = eng.shape_of(q)
    C = min(cfg.seq_chunk, s)
    D, u, w, ac = _decay_tables(head_decays(H), C)
    scale = 1.0 / math.sqrt(dk)

    # the silu gate: out = wo(y_flat * g), g = silu(x wg)
    dflat, g_o = L.linear_bwd(eng, {"w": params["wo"]}, co, dy)
    cg, cact, g, y_pre = gate_cache
    dg = eng.mul(dflat, y_pre)
    dflat = eng.mul(dflat, g)
    dx_gate, g_g = L.linear_bwd(eng, {"w": params["wg"]}, cg,
                                eng.silu_bwd(cact, dg))
    grads = {"wo": g_o["w"], "wg": g_g["w"]}

    dyc, nc = _chunks(eng, _split_like(eng, dflat, H, dv), C)
    qc, _ = _chunks(eng, q, C)
    kc, _ = _chunks(eng, k, C)
    vc, _ = _chunks(eng, v, C)

    Dp = D[None] * scale                            # (1,H,C,C) public
    up = u[None, :, :, None] * scale                # (1,H,C,1)
    wp = w[None, :, :, None]
    acp = ac[None, :, None, None]

    def tr(t):
        return eng.transpose(t, (0, 1, 3, 2))

    def body(carry, i):
        dS = _wrap(eng, carry)                      # dL/dS' (after chunk i)
        qi, ki, vi, dyi = (L._chunk(eng, t, i) for t in (qc, kc, vc, dyc))
        Sm = _wrap(eng, Sm_list[i])
        # recomputed (cheaper than keeping S x C scores a chunk)
        s_m = eng.mul_public(eng.matmul(qi, tr(ki)), Dp)
        kw = eng.mul_public(ki, wp)
        q_u = eng.mul_public(qi, up)
        # S' = ac Sm + kw^T v  |  y = s_m v + q_u Sm
        dvi = eng.add(eng.matmul(tr(s_m), dyi), eng.matmul(kw, dS))
        ds_qk = eng.mul_public(eng.matmul(dyi, tr(vi)), Dp)
        dq = eng.add(eng.matmul(ds_qk, ki),
                     eng.mul_public(eng.matmul(dyi, tr(Sm)), up))
        dkw = eng.matmul(vi, tr(dS))
        dki = eng.add(eng.matmul(tr(ds_qk), qi), eng.mul_public(dkw, wp))
        dSm = eng.add(eng.mul_public(dS, acp), eng.matmul(tr(q_u), dyi))
        return _leaf(eng, dSm), tuple(_leaf(eng, t) for t in (dq, dki, dvi))

    _, outs = scan_loop(eng, nc, "ret_bwd", body,
                        _leaf(eng, eng.zeros((b, H, dk, dv))), reverse=True)
    for j, (name, c) in enumerate((("wq", cq), ("wk", ck), ("wv", cv))):
        d = _unproj_heads(eng, _unchunks(eng, _stack_chunks(
            eng, [o[j] for o in outs])))
        dxj, gj = L.linear_bwd(eng, {"w": params[name]}, c, d)
        grads[name] = gj["w"]
        dx = dxj if j == 0 else eng.add(dx, dxj)
    return eng.add(dx, dx_gate), grads


def retention_step(eng: Engine, params, cfg: RetentionConfig, x, state):
    """Single-token decode: x (B,1,D), state (B,H,dk,dv).
    y_t = q_t (a S + k_t^T v_t);  S' = a S + k_t^T v_t  (O(1) memory)."""
    H, dk, dv = cfg.n_heads, cfg.d_k, cfg.d_v
    q, _ = _proj_heads(eng, x, params["wq"], H, dk)   # (B,H,1,dk)
    k, _ = _proj_heads(eng, x, params["wk"], H, dk)
    v, _ = _proj_heads(eng, x, params["wv"], H, dv)
    a = head_decays(H)[None, :, None, None]
    S_dec = eng.mul_public(state, a)
    S_new = eng.add(S_dec, eng.matmul(eng.transpose(k, (0, 1, 3, 2)), v))
    y = eng.matmul(eng.mul_public(q, 1.0 / math.sqrt(dk)), S_new)
    y_flat = _unproj_heads(eng, y)
    g_lin, _ = L.linear_fwd(eng, {"w": params["wg"]}, x)
    g, _ = eng.silu(g_lin)
    out, _ = L.linear_fwd(eng, {"w": params["wo"]}, eng.mul(y_flat, g))
    return out, S_new


# ---------------------------------------------------------------------------
# sLSTM-style block: scalar state per channel, public per-head decay.
# ---------------------------------------------------------------------------
def slstm_fwd(eng: Engine, params, cfg: SLSTMConfig, x):
    """x: (B,S,D), the state run from zero.  c_t = f c_{t-1} + i_t*z_t ;
    h_t = o_t * c_t.  With public f the c-recurrence is a public
    lower-triangular contraction (local: no communication); only i*z and
    o*c pay Pi_Mult.  A head's channels share its decay."""
    d, H, C = cfg.d_model, cfg.n_heads, cfg.seq_chunk
    b, s, _ = eng.shape_of(x)
    C = min(C, s)
    assert s % C == 0
    Dh, u, wgt, ac = _decay_tables(head_decays(H), C)

    i_lin, ci = L.linear_fwd(eng, {"w": params["wi"]}, x)
    z, cz = L.linear_fwd(eng, {"w": params["wz"]}, x)
    o_lin, c_o = L.linear_fwd(eng, {"w": params["wo"]}, x)
    i_g, ci_act = eng.sigmoid(i_lin)
    o_g, co_act = eng.sigmoid(o_lin)
    iz = eng.mul(i_g, z)                          # (B,S,D) secret product

    # chunked public recurrence on heads (B,H,S,dh)
    dh = d // H
    izc, nc = _chunks(eng, _split_like(eng, iz, H, dh), C)  # (nc,B,H,C,dh)
    state = eng.zeros((b, H, 1, dh))

    up = u[None, :, :, None]                      # (1,H,C,1)
    acp = ac[None, :, None, None]

    def body(carry, i):
        c_prev = _wrap(eng, carry)                # (B,H,1,dh)
        izi = L._chunk(eng, izc, i)
        # intra: c_rel = Dh @ iz  (public matmul: local, no communication)
        c_intra = _pub_left(eng, Dh, izi)
        c_inter = eng.mul_public(_bcast_chunk(eng, c_prev, C), up)
        c = eng.add(c_intra, c_inter)
        # the carry: c_last = a^C c_prev + sum_j a^{C-1-j} iz_j
        c_last = eng.add(eng.mul_public(c_prev, acp),
                         _pub_left(eng, wgt[:, None], izi))
        return _leaf(eng, c_last), _leaf(eng, c)

    final_c, cs = scan_loop(eng, nc, "slstm_fwd", body, _leaf(eng, state))
    c_full = _unproj_heads(eng, _unchunks(eng, _stack_chunks(eng, cs)))

    h = eng.mul(o_g, c_full)
    y, c_out = L.linear_fwd(eng, {"w": params["wout"]}, h)
    cache = (ci, cz, c_o, ci_act, co_act, i_g, z, o_g, c_full, c_out)
    return y, cache, _wrap(eng, final_c)


def slstm_bwd(eng: Engine, params, cfg: SLSTMConfig, cache, dy):
    """Backward through the gate products and the public recurrence: its
    transpose is again a local public contraction, the chunks in reverse
    carrying dL/dc_last back (zero after the last chunk).  Returns (dx,
    grads)."""
    ci, cz, c_o, ci_act, co_act, i_g, z, o_g, c_full, c_out = cache
    d, H = cfg.d_model, cfg.n_heads
    b, s, _ = eng.shape_of(c_full)
    C = min(cfg.seq_chunk, s)
    Dh, u, wgt, ac = _decay_tables(head_decays(H), C)

    dh_, g_out = L.linear_bwd(eng, {"w": params["wout"]}, c_out, dy)
    do = eng.mul(dh_, c_full)
    dc_full = eng.mul(dh_, o_g)

    dhd = d // H
    dcc, nc = _chunks(eng, _split_like(eng, dc_full, H, dhd), C)
    Dt = np.swapaxes(Dh, -1, -2)                   # (H,C,C) upper-tri
    wlast = wgt[None, :, :, None]                  # (1,H,C,1): iz_j in c_last
    acp = ac[None, :, None, None]

    def body(carry, i):
        dcarry = _wrap(eng, carry)                 # (B,H,1,dh) dL/dc_last
        dci = L._chunk(eng, dcc, i)
        # diz_j = sum_{i>=j} a^{i-j} dc_i + a^{C-1-j} dcarry
        diz = eng.add(_pub_left(eng, Dt, dci),
                      eng.mul_public(_bcast_chunk(eng, dcarry, C), wlast))
        # dc_prev = a^C dcarry + sum_i a^{i+1} dc_i
        dc_prev = eng.add(eng.mul_public(dcarry, acp),
                          _pub_left(eng, u[:, None], dci))
        return _leaf(eng, dc_prev), _leaf(eng, diz)

    _, dizc = scan_loop(eng, nc, "slstm_bwd", body,
                        _leaf(eng, eng.zeros((b, H, 1, dhd))), reverse=True)
    diz = _unproj_heads(eng, _unchunks(eng, _stack_chunks(eng, dizc)))

    di = eng.mul(diz, z)
    dz = eng.mul(diz, i_g)
    di_lin = eng.sigmoid_bwd(ci_act, di)
    do_lin = eng.sigmoid_bwd(co_act, do)
    dx1, g_i = L.linear_bwd(eng, {"w": params["wi"]}, ci, di_lin)
    dx2, g_z = L.linear_bwd(eng, {"w": params["wz"]}, cz, dz)
    dx3, g_o = L.linear_bwd(eng, {"w": params["wo"]}, c_o, do_lin)
    grads = {"wout": g_out["w"], "wi": g_i["w"], "wz": g_z["w"],
             "wo": g_o["w"]}
    return eng.add(eng.add(dx1, dx2), dx3), grads


def _pub_left(eng, P, x):
    """P (H,M,C) public @ x (B,H,C,dh) share -> (B,H,M,dh): a local
    contraction with the encoded public matrix (on shares the ring
    matmul, P broadcast over the components and the batch) and one
    truncation for the fixed-point rescale, through the engine's encoding
    and truncation hooks (the plain engine's cast and identity).  The
    decay matrices (M = C), the carry's weights a^{C-1-j} and the carry
    gradient's a^{i+1} (M = 1, one row a head)."""
    enc = eng._encode_public(P)
    if _is_triv(eng):
        return eng._truncate(AShare(ops.ring_matmul(enc[None, None],
                                                    x.data)))
    return eng._truncate(torch.matmul(enc, x))


def _bcast_chunk(eng, c_prev, C):
    """(B,H,1,dh) -> (B,H,C,dh) broadcast."""
    if _is_triv(eng):
        d = c_prev.data
        return AShare(d.expand(d.shape[:3] + (C,) + d.shape[4:]))
    return c_prev.expand(c_prev.shape[:2] + (C,) + c_prev.shape[3:])


def slstm_step(eng: Engine, params, cfg: SLSTMConfig, x, state):
    """Single-token decode: c' = f c + i*z ; h = o * c'.
    state layout matches slstm_fwd's carry: (B, H, 1, d//H)."""
    d, H = cfg.d_model, cfg.n_heads
    i_lin, _ = L.linear_fwd(eng, {"w": params["wi"]}, x)
    z, _ = L.linear_fwd(eng, {"w": params["wz"]}, x)
    o_lin, _ = L.linear_fwd(eng, {"w": params["wo"]}, x)
    i_g, _ = eng.sigmoid(i_lin)
    o_g, _ = eng.sigmoid(o_lin)
    iz = eng.mul(i_g, z)                           # (B,1,D)
    izh = _split_like(eng, iz, H, d // H)          # (B,H,1,dh)
    a = head_decays(H)[None, :, None, None]
    c_new = eng.add(eng.mul_public(state, a),
                    izh)
    c_flat = _unproj_heads(eng, c_new)             # (B,1,D)
    h = eng.mul(o_g, c_flat)
    y, _ = L.linear_fwd(eng, {"w": params["wout"]}, h)
    return y, c_new
