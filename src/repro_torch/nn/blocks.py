"""MLP and MoE blocks over the Engine, with manual backprop
(``repro/nn/blocks.py``).

MoE privacy modes:
  * public  -- router top-k indices are declassified (the standard PPML
    routing leakage trade-off); dispatch and combine become local gathers
    on shares and experts run on their own tokens only.  Default.
  * dense   -- no routing leak: soft routing with full softmax gates, every
    expert processes every token (E/k x compute, the honest-MPC cost).

Routing bookkeeping is public; it runs with torch on the declassified
scores' device, as ``jax.lax.top_k`` and the scatter run on the JAX
package's (no copy to the host).  The top-k keeps ``jax.lax.top_k``'s
order: descending, the lower expert first on a tie (a stable sort).  The
backward pass scatters rows back to public positions with an integer
``index_add_`` (``_scatter_rows``): repeated positions sum mod 2^ell, in
any order, so the words are exact on the card too.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core.shares import AShare
from .engine import Engine, TridentEngine
from .layers import linear_bwd, linear_fwd, linear_init


# ---------------------------------------------------------------------------
# Dense MLP: swiglu (llama/qwen), relu2 (nemotron), relu, sigmoid_glu.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class MLPConfig:
    d_model: int
    d_ff: int
    act: str = "swiglu"      # swiglu | relu | relu2 | sigmoid_glu


def mlp_init(rng, cfg: MLPConfig):
    p = {"w_up": linear_init(rng, cfg.d_model, cfg.d_ff)["w"],
         "w_down": linear_init(rng, cfg.d_ff, cfg.d_model)["w"]}
    if cfg.act in ("swiglu", "sigmoid_glu"):
        p["w_gate"] = linear_init(rng, cfg.d_model, cfg.d_ff)["w"]
    return p


def mlp_fwd(eng: Engine, params, cfg: MLPConfig, x):
    up, c_up = linear_fwd(eng, {"w": params["w_up"]}, x)
    if cfg.act == "swiglu":
        gate, c_gate = linear_fwd(eng, {"w": params["w_gate"]}, x)
        a, c_act = eng.silu(gate)
        h = eng.mul(a, up)
        cache_act = (c_gate, c_act, a, up)
    elif cfg.act == "sigmoid_glu":
        gate, c_gate = linear_fwd(eng, {"w": params["w_gate"]}, x)
        a, c_act = eng.sigmoid(gate)
        h = eng.mul(a, up)
        cache_act = (c_gate, c_act, a, up)
    elif cfg.act == "relu2":
        r, bit = eng.relu(up)
        h = eng.mul(r, r)
        cache_act = (bit, r)
    else:  # relu
        h, bit = eng.relu(up)
        cache_act = (bit,)
    y, c_down = linear_fwd(eng, {"w": params["w_down"]}, h)
    return y, (c_up, cache_act, c_down)


def mlp_bwd(eng: Engine, params, cfg: MLPConfig, cache, dy):
    c_up, cache_act, c_down = cache
    dh, g_down = linear_bwd(eng, {"w": params["w_down"]}, c_down, dy)
    grads = {"w_down": g_down["w"]}
    dx_g = None
    if cfg.act in ("swiglu", "sigmoid_glu"):
        c_gate, c_act, a, up = cache_act
        da = eng.mul(dh, up)
        dup = eng.mul(dh, a)
        if cfg.act == "swiglu":
            dgate = eng.silu_bwd(c_act, da)
        else:
            dgate = eng.sigmoid_bwd(c_act, da)
        dx_g, g_gate = linear_bwd(eng, {"w": params["w_gate"]}, c_gate, dgate)
        grads["w_gate"] = g_gate["w"]
    elif cfg.act == "relu2":
        bit, r = cache_act
        dr = eng.mul(dh, eng.scale(r, 2.0))
        dup = eng.relu_bwd(bit, dr)
    else:  # relu
        (bit,) = cache_act
        dup = eng.relu_bwd(bit, dh)
    dx_u, g_up = linear_bwd(eng, {"w": params["w_up"]}, c_up, dup)
    grads["w_up"] = g_up["w"]
    dx = eng.add(dx_u, dx_g) if dx_g is not None else dx_u
    return dx, grads


# ---------------------------------------------------------------------------
# Mixture of Experts
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int
    n_experts: int
    top_k: int
    act: str = "swiglu"
    routing: str = "public"      # public | dense
    capacity_factor: float = 1.25


def moe_init(rng, cfg: MoEConfig):
    mcfg = MLPConfig(cfg.d_model, cfg.d_ff, cfg.act)
    p = {"router": linear_init(rng, cfg.d_model, cfg.n_experts)["w"]}
    # experts as stacked tensors (E, d, f): batched matmuls
    ups, downs, gates = [], [], []
    for _ in range(cfg.n_experts):
        e = mlp_init(rng, mcfg)
        ups.append(e["w_up"])
        downs.append(e["w_down"])
        if "w_gate" in e:
            gates.append(e["w_gate"])
    p["e_up"] = np.stack(ups)
    p["e_down"] = np.stack(downs)
    if gates:
        p["e_gate"] = np.stack(gates)
    return p


def _expert_mlp_fwd(eng, params, cfg: MoEConfig, x):
    """x: (E, C, D) tokens grouped per expert; batched expert matmuls
    (kernel route K2 on the card)."""
    up = eng.matmul(x, params["e_up"])         # (E,C,F): batched over E
    if cfg.act == "swiglu":
        gate = eng.matmul(x, params["e_gate"])
        a, c_act = eng.silu(gate)
        h = eng.mul(a, up)
        cache = (x, c_act, a, up)
    else:
        h, bit = eng.relu(up)
        cache = (x, bit)
    y = eng.matmul(h, params["e_down"])
    return y, (cache, h)


def _expert_mlp_bwd(eng, params, cfg: MoEConfig, cache, dy):
    inner, h = cache
    dh = eng.matmul(dy, eng.transpose(params["e_down"], (0, 2, 1)))
    g_down = eng.matmul(eng.transpose(h, (0, 2, 1)), dy)
    grads = {"e_down": g_down}
    if cfg.act == "swiglu":
        x, c_act, a, up = inner
        da = eng.mul(dh, up)
        dup = eng.mul(dh, a)
        dgate = eng.silu_bwd(c_act, da)
        grads["e_gate"] = eng.matmul(eng.transpose(x, (0, 2, 1)), dgate)
        dx = eng.add(
            eng.matmul(dup, eng.transpose(params["e_up"], (0, 2, 1))),
            eng.matmul(dgate, eng.transpose(params["e_gate"], (0, 2, 1))))
    else:
        x, bit = inner
        dup = eng.relu_bwd(bit, dh)
        dx = eng.matmul(dup, eng.transpose(params["e_up"], (0, 2, 1)))
    grads["e_up"] = eng.matmul(eng.transpose(x, (0, 2, 1)), dup)
    return dx, grads


def top_k_indices(scores: torch.Tensor, k: int) -> torch.Tensor:
    """``jax.lax.top_k(scores, k)[1]`` (int64, on the scores' device):
    the k largest of the last axis, descending, the lower index first
    among equal scores."""
    return torch.sort(scores, dim=-1, descending=True,
                      stable=True).indices[..., :k]


def moe_fwd(eng: Engine, params, cfg: MoEConfig, x):
    """x: (B,S,D) -> (B,S,D)."""
    b, s, d = eng.shape_of(x)
    t = b * s
    xf = eng.reshape(x, (t, d))
    logits, c_r = linear_fwd(eng, {"w": params["router"]}, xf)  # (T,E)

    if cfg.routing == "dense":
        gates, c_sm = eng.softmax(logits, axis=-1)              # (T,E) secret
        # every expert runs every token: (E,T,D)
        xe = _tile_experts(eng, xf, cfg.n_experts)
        ye, c_e = _expert_mlp_fwd(eng, params, cfg, xe)         # (E,T,D)
        yw = _weight_by_gates(eng, ye, gates)                   # (E,T,D)
        yf = eng.sum(yw, axis=0)
        y = eng.reshape(yf, (b, s, d))
        return y, (c_r, c_sm, c_e, gates, ye)

    # public routing: declassify router scores (documented leakage)
    scores_pub = eng.declassify(logits)
    top_idx = top_k_indices(scores_pub, cfg.top_k)              # (T,k) public
    cap = int(math.ceil(t * cfg.top_k / cfg.n_experts *
                        cfg.capacity_factor))
    disp_idx, combine_pos, keep = _dispatch_indices(
        top_idx, cfg.n_experts, cap)                            # public
    # gather tokens per expert (local on shares)
    xe = eng.take(xf, disp_idx.reshape(-1), axis=0)
    xe = eng.reshape(xe, (cfg.n_experts, cap, d))
    ye, c_e = _expert_mlp_fwd(eng, params, cfg, xe)             # (E,cap,D)
    # gates: softmax over the k selected logits (still secret)
    rows = torch.arange(t, device=top_idx.device)[:, None]
    sel = eng.take(eng.reshape(logits, (-1,)),
                   (rows * cfg.n_experts + top_idx).reshape(-1), axis=0)
    sel = eng.reshape(sel, (t, cfg.top_k))
    gates, c_sm = eng.softmax(sel, axis=-1)                     # (T,k)
    # combine: for slot (t, k): y += gate_{t,k} * ye[expert, pos]
    yflat = eng.reshape(ye, (cfg.n_experts * cap, d))
    picked = eng.take(yflat, combine_pos.reshape(-1), axis=0)   # (T*k, D)
    picked = eng.reshape(picked, (t, cfg.top_k, d))
    keep_f = keep.to(torch.int64)                               # (T,k) public
    gw = _broadcast_gate(eng, gates, picked)
    contrib = eng.mul(picked, gw)
    contrib = eng.mask_public(contrib, keep_f[..., None])
    yf = eng.sum(contrib, axis=1)                               # (T,D)
    y = eng.reshape(yf, (b, s, d))
    cache = (c_r, c_sm, c_e, gates, picked, disp_idx, combine_pos,
             keep_f, top_idx)
    return y, cache


def moe_bwd(eng: Engine, params, cfg: MoEConfig, cache, dy):
    b, s, d = eng.shape_of(dy)
    t = b * s
    dyf = eng.reshape(dy, (t, d))
    if cfg.routing == "dense":
        c_r, c_sm, c_e, gates, ye = cache
        dye_w = _tile_experts(eng, dyf, cfg.n_experts)          # (E,T,D)
        # y = sum_e gate_e * ye_e
        dye = _weight_by_gates(eng, dye_w, gates)
        dgates_full = eng.sum(eng.mul(dye_w, ye), axis=-1)      # (E,T)
        dgates = eng.transpose(dgates_full, (1, 0))             # (T,E)
        dlogits = eng.softmax_bwd(c_sm, dgates)
        dxe, g_e = _expert_mlp_bwd(eng, params, cfg, c_e, dye)
        dxf = eng.sum(dxe, axis=0)                              # (T,D)
        dxr, g_r = linear_bwd(eng, {"w": params["router"]}, c_r, dlogits)
        g_e["router"] = g_r["w"]
        return eng.reshape(eng.add(dxf, dxr), (b, s, d)), g_e

    (c_r, c_sm, c_e, gates, picked, disp_idx, combine_pos, keep_f,
     top_idx) = cache
    # contrib = gate * picked * keep
    dyk = _tile_k(eng, dyf, cfg.top_k)                          # (T,k,D)
    dyk = eng.mask_public(dyk, keep_f[..., None])
    gw = _broadcast_gate(eng, gates, dyk)
    dpicked = eng.mul(dyk, gw)                                  # (T,k,D)
    dgates = eng.sum(eng.mul(dyk, picked), axis=-1)             # (T,k)
    dsel = eng.softmax_bwd(c_sm, dgates)
    # scatter dsel back into the (T,E) logits' grad (public positions)
    dlogits = _scatter_topk(eng, dsel, top_idx, cfg.n_experts)
    # scatter dpicked back to the expert slots; an overflowed assignment
    # adds its masked (zero) row to the slot it was clamped to
    cap = _cap_of(eng, c_e)
    dye = _scatter_rows(eng, eng.reshape(dpicked, (t * cfg.top_k, d)),
                        combine_pos.reshape(-1), cfg.n_experts * cap, d)
    dye = eng.reshape(dye, (cfg.n_experts, cap, d))
    dxe, g_e = _expert_mlp_bwd(eng, params, cfg, c_e, dye)
    # scatter the experts' token grads back to (T,D); a padded slot's row
    # goes to token 0, as its forward gather took token 0
    dxf = _scatter_rows(eng, eng.reshape(dxe, (cfg.n_experts * cap, d)),
                        disp_idx.reshape(-1), t, d)
    dxr, g_r = linear_bwd(eng, {"w": params["router"]}, c_r, dlogits)
    g_e["router"] = g_r["w"]
    return eng.reshape(eng.add(dxf, dxr), (b, s, d)), g_e


def _cap_of(eng, c_e):
    """The expert capacity: the expert cache's x is (E, cap, D)."""
    return eng.shape_of(c_e[0][0])[1]


def _tile_experts(eng, xf, e):
    if isinstance(eng, TridentEngine):
        return AShare(xf.data[:, None].expand((4, e) + xf.data.shape[1:]))
    return xf[None].expand((e,) + tuple(xf.shape))


def _tile_k(eng, xf, k):
    """(T, D) -> (T, k, D), each row repeated k times (a view)."""
    if isinstance(eng, TridentEngine):
        _, t, d = xf.data.shape
        return AShare(xf.data[:, :, None].expand((4, t, k, d)))
    t, d = xf.shape
    return xf[:, None].expand((t, k, d))


def _weight_by_gates(eng, ye, gates):
    """ye: (E,T,D); gates: (T,E) -> gate-weighted ye."""
    gt = eng.transpose(gates, (1, 0))          # (E,T)
    if isinstance(eng, TridentEngine):
        g = AShare(gt.data[:, :, :, None])
    else:
        g = gt[:, :, None]
    return eng.mul(ye, _bcast(eng, g, ye))


def _broadcast_gate(eng, gates, like):
    if isinstance(eng, TridentEngine):
        return AShare(gates.data[..., None].expand(like.data.shape))
    return gates[..., None].expand(like.shape)


def _bcast(eng, small, like):
    if isinstance(eng, TridentEngine):
        return AShare(small.data.expand(like.data.shape))
    return small.expand(like.shape)


def _dispatch_indices(top_idx: torch.Tensor, n_experts: int, cap: int):
    """Public routing bookkeeping.  Returns
    disp_idx (E, cap): token index feeding each expert slot (0-padded),
    combine_pos (T, k): flat slot index (e*cap+c) for each assignment,
    keep (T, k): bool, False when the slot overflowed capacity.
    An assignment past capacity writes token 0 into the last slot, in
    assignment order, as the JAX package's scatter does: where several
    assignments hit one slot the last one stands."""
    t, k = top_idx.shape
    dev = top_idx.device
    flat_e = top_idx.reshape(-1).to(torch.int64)         # (T*k,)
    flat_t = torch.arange(t, device=dev).repeat_interleave(k)
    # position of each assignment within its expert (rank by order)
    onehot = torch.nn.functional.one_hot(flat_e, n_experts)
    pos = torch.sum(torch.cumsum(onehot, dim=0) * onehot, dim=-1) - 1
    keep = pos < cap
    slot = flat_e * cap + torch.clamp(pos, max=cap - 1)
    target = torch.where(keep, slot, n_experts * cap - 1)
    value = torch.where(keep, flat_t, 0)
    # the last assignment to write each slot
    last = torch.full((n_experts * cap,), -1, dtype=torch.int64, device=dev)
    last.scatter_reduce_(0, target, torch.arange(t * k, device=dev), "amax")
    disp = torch.where(last >= 0, value[last.clamp(min=0)], 0)
    return (disp.reshape(n_experts, cap), slot.reshape(t, k),
            keep.reshape(t, k))


def _scatter_topk(eng, dsel, top_idx, n_experts):
    """(T, k) grads of the selected logits -> the (T, E) logits' grad."""
    t, k = top_idx.shape
    rows = torch.arange(t, device=top_idx.device)[:, None]
    flat_pos = (rows * n_experts + top_idx).reshape(-1)
    return _scatter_rows(eng, eng.reshape(dsel, (t * k, 1)), flat_pos,
                         t * n_experts, 1, reshape_to=(t, n_experts))


def _scatter_rows(eng, rows, pos, n_out, d, reshape_to=None):
    """A (n_out, d) tensor of zeros with each row of `rows` added at its
    public position in `pos` (repeated positions sum): the JAX package's
    ``.at[pos].add``, an integer ``index_add_`` on share words."""
    if isinstance(eng, TridentEngine):
        data = rows.data
        out = torch.zeros((4, n_out, d), dtype=data.dtype, device=data.device)
        out.index_add_(1, pos.to(device=data.device, dtype=torch.int64), data)
        res = AShare(out)
    else:
        res = torch.zeros((n_out, d), dtype=rows.dtype, device=rows.device)
        res.index_add_(0, pos.to(device=rows.device, dtype=torch.int64), rows)
    if reshape_to is not None:
        res = eng.reshape(res, reshape_to)
    return res
