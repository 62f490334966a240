"""MLP and MoE blocks over the Engine, forward side
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
order: descending, the lower expert first on a tie (a stable sort).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core.shares import AShare
from .engine import Engine, TridentEngine
from .layers import linear_fwd, linear_init


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


def _tile_experts(eng, xf, e):
    if isinstance(eng, TridentEngine):
        return AShare(xf.data[:, None].expand((4, e) + xf.data.shape[1:]))
    return xf[None].expand((e,) + tuple(xf.shape))


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
