"""Abstract parameter, input and decode-cache specs
(``repro/launch/specs.py``): the trees ``nn.model.params_to_engine``,
the launcher's inputs and ``serve_prefill``'s caches would hold, with
tensors on ``torch.device("meta")`` at the leaves (shapes and dtypes, no
storage), so the 235B-parameter configs are sized without memory.
``param_specs`` equals the port's real ``params_to_engine(init_params(
SMOKE))`` leaf for leaf (tests/test_torch_launch.py).

Trident leaves are shares: ``AShare`` of ring words, data (4, *shape), a
stacked segment leaf (count, 4, *shape); caches keep two components (m,
the lambda sum).  ``trident=False`` gives the PlainEngine's float64
tensors.  The JAX module's sharding rules (``fit_sharding``,
``param_shardings``, ``decode_cache_shardings``) map these trees onto a
16x16 or 2x16x16 TPU mesh; one card has no such mesh, and they wait for a
multi-card slice (ROADMAP, Queue 1).
"""
from __future__ import annotations

import torch

from ..configs import SHAPES
from ..core.ring import RING64, Ring
from ..core.shares import AShare
from ..nn.model import ModelConfig, tree_map

META = torch.device("meta")
IDS_DTYPE = torch.int32          # the token ids and labels (TokenStream)
PLAIN_DTYPE = torch.float64      # the PlainEngine's tensors


# ===========================================================================
# Abstract parameters
# ===========================================================================
def _layer_shapes(cfg: ModelConfig, kind: str) -> dict:
    d = cfg.d_model
    if kind in ("attn_mlp", "enc", "shared_attn"):
        return {"n1": {"g": (d,)}, "attn": _attn_shapes(cfg),
                "n2": {"g": (d,)}, "mlp": _mlp_shapes(cfg)}
    if kind == "attn_moe":
        E, f = cfg.n_experts, cfg.d_ff
        moe = {"router": (d, E), "e_up": (E, d, f), "e_down": (E, f, d)}
        if cfg.act in ("swiglu", "sigmoid_glu"):
            moe["e_gate"] = (E, d, f)
        return {"n1": {"g": (d,)}, "attn": _attn_shapes(cfg),
                "n2": {"g": (d,)}, "moe": moe}
    if kind == "retention":
        return {"n1": {"g": (d,)}, "ret": _ret_shapes(cfg)}
    if kind == "ret_slstm_pair":
        return {"n1": {"g": (d,)}, "ret": _ret_shapes(cfg),
                "n2": {"g": (d,)},
                "sl": {"wi": (d, d), "wz": (d, d), "wo": (d, d),
                       "wout": (d, d)}}
    if kind == "xattn_mlp":
        return {"n1": {"g": (d,)}, "attn": _attn_shapes(cfg),
                "nx": {"g": (d,)}, "xattn": _attn_shapes(cfg),
                "n2": {"g": (d,)}, "mlp": _mlp_shapes(cfg)}
    raise ValueError(kind)


def _attn_shapes(cfg: ModelConfig) -> dict:
    d, H, Hk, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.dh
    s = {"wq": (d, H * dh), "wk": (d, Hk * dh), "wv": (d, Hk * dh),
         "wo": (H * dh, d)}
    if cfg.qk_norm:
        s["qnorm_g"] = (dh,)
        s["knorm_g"] = (dh,)
    return s


def _mlp_shapes(cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    s = {"w_up": (d, f), "w_down": (f, d)}
    if cfg.act in ("swiglu", "sigmoid_glu"):
        s["w_gate"] = (d, f)
    return s


def _ret_shapes(cfg: ModelConfig) -> dict:
    r, d = cfg.ret_cfg(), cfg.d_model
    return {"wq": (d, r.n_heads * r.d_k), "wk": (d, r.n_heads * r.d_k),
            "wv": (d, r.n_heads * r.d_v), "wo": (r.n_heads * r.d_v, d),
            "wg": (d, r.n_heads * r.d_v)}


def _map_shapes(fn, tree):
    """`fn` over the shape tuples at the leaves of a nested dict."""
    if isinstance(tree, tuple):
        return fn(tree)
    return {k: _map_shapes(fn, tree[k]) for k in sorted(tree)}


def param_specs(cfg: ModelConfig, ring: Ring = RING64, trident: bool = True,
                ncomp: int = 4):
    """The tree ``params_to_engine`` returns, with meta tensors.  ncomp=2
    is the compressed [m, lam_sum] representation."""
    def leaf(shape, count=None):
        pre = () if count is None else (count,)
        if trident:
            return AShare(torch.empty(pre + (ncomp,) + tuple(shape),
                                      dtype=ring.dtype, device=META))
        return torch.empty(pre + tuple(shape), dtype=PLAIN_DTYPE,
                           device=META)

    def conv(tree, count=None):
        return _map_shapes(lambda s: leaf(s, count), tree)

    out = {"embed": conv({"table": (cfg.vocab, cfg.d_model)}),
           "final_norm": conv({"g": (cfg.d_model,)}),
           "lm_head": conv({"w": (cfg.d_model, cfg.vocab)})}
    out["segments"] = [None if kind == "shared_attn" else
                       conv(_layer_shapes(cfg, kind), count)
                       for kind, count in cfg.segments()]
    if any(kind == "shared_attn" for kind, _ in cfg.segments()):
        out["shared_attn"] = conv(_layer_shapes(cfg, "shared_attn"))
    return out


# ===========================================================================
# Inputs
# ===========================================================================
def _share(shape, ring: Ring, trident: bool, ncomp: int = 4):
    if trident:
        return AShare(torch.empty((ncomp,) + tuple(shape), dtype=ring.dtype,
                                  device=META))
    return torch.empty(tuple(shape), dtype=PLAIN_DTYPE, device=META)


def input_specs(cfg: ModelConfig, shape_name: str, ring: Ring = RING64,
                trident: bool = True, dims: tuple | None = None) -> dict:
    """Meta stand-ins for every model input of a workload shape
    (``configs.SHAPES[shape_name]``, or `dims` = (seq, batch, kind)):
    train takes ids and labels, prefill ids, decode one id a row and the
    caches of `seq` positions; the vlm's frontend embeddings and the
    encdec's encoder inputs are shares."""
    seq, batch, kind = dims or SHAPES[shape_name]
    args = {}
    if kind in ("train", "prefill"):
        args["ids"] = torch.empty((batch, seq), dtype=IDS_DTYPE, device=META)
        if kind == "train":
            args["labels"] = torch.empty((batch, seq), dtype=IDS_DTYPE,
                                         device=META)
        front = (batch, cfg.frontend_tokens, cfg.d_model)
        if cfg.family == "vlm":
            args["frontend_embs"] = _share(front, ring, trident)
        if cfg.family == "encdec":
            args["enc_inputs"] = _share(front, ring, trident)
        return args
    # decode / long_decode: one token + caches of length seq
    args["ids"] = torch.empty((batch, 1), dtype=IDS_DTYPE, device=META)
    args["caches"] = decode_cache_specs(cfg, batch, seq, ring=ring,
                                        trident=trident,
                                        long_ctx=kind == "long_decode")
    return args


def _effective_kv_len(cfg: ModelConfig, seq: int, long_ctx: bool) -> int:
    w = cfg.long_window if long_ctx else cfg.window
    return min(seq, w) if w else seq


def decode_cache_specs(cfg: ModelConfig, batch: int, seq: int,
                       ring: Ring = RING64, trident: bool = True,
                       long_ctx: bool = False) -> list:
    """The caches ``serve_prefill`` returns for `seq` positions (each
    segment's stacked raw leaves (count, 2, ...), the shared block's (2,
    ...), the encoder output a share), with meta tensors."""
    Hk, dh = cfg.n_kv_heads, cfg.dh
    rcfg = cfg.ret_cfg()

    def raw(*shape, count=None):
        pre = () if count is None else (count,)
        if trident:
            return torch.empty(pre + (2,) + shape, dtype=ring.dtype,
                               device=META)
        return torch.empty(pre + shape, dtype=PLAIN_DTYPE, device=META)

    def kv_stacked(count, s_len):
        return {"k": raw(batch, Hk, s_len, dh, count=count),
                "v": raw(batch, Hk, s_len, dh, count=count)}

    s_eff = _effective_kv_len(cfg, seq, long_ctx)
    caches = []
    for kind, count in cfg.segments():
        if kind == "enc":
            caches.append(_share((batch, cfg.frontend_tokens, cfg.d_model),
                                 ring, trident))
        elif kind == "shared_attn":
            w = min(seq, cfg.long_window) if long_ctx else seq
            caches.append({"k": raw(batch, Hk, w, dh),
                           "v": raw(batch, Hk, w, dh)})
        elif kind in ("attn_mlp", "attn_moe"):
            caches.append(kv_stacked(count, s_eff))
        elif kind == "retention":
            caches.append({"s": raw(batch, rcfg.n_heads, rcfg.d_k, rcfg.d_v,
                                    count=count)})
        elif kind == "ret_slstm_pair":
            dsl = cfg.d_model // cfg.n_heads
            caches.append({
                "s1": raw(batch, rcfg.n_heads, rcfg.d_k, rcfg.d_v,
                          count=count),
                "s2": raw(batch, cfg.n_heads, 1, dsl, count=count)})
        elif kind == "xattn_mlp":
            c = kv_stacked(count, s_eff)
            c["enc_kv"] = kv_stacked(count, cfg.frontend_tokens)
            caches.append(c)
        else:
            raise ValueError(kind)
    return caches


# ===========================================================================
# Sizes
# ===========================================================================
def tree_bytes(tree) -> int:
    """Bytes of every tensor in a tree (a share's data; meta or real)."""
    total = [0]

    def add(x):
        t = getattr(x, "data", x)
        if isinstance(t, torch.Tensor):
            total[0] += t.numel() * t.element_size()
        return x

    tree_map(add, tree)
    return total[0]
