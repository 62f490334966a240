"""Abstract parameter, input and decode-cache specs and their sharding
rules (``repro/launch/specs.py``): the trees ``nn.model.params_to_engine``,
the launcher's inputs and ``serve_prefill``'s caches would hold, with
tensors on ``torch.device("meta")`` at the leaves (shapes and dtypes, no
storage), so the 235B-parameter configs are sized without memory.
``param_specs`` equals the port's real ``params_to_engine(init_params(
SMOKE))`` leaf for leaf (tests/test_torch_launch.py).

Trident leaves are shares: ``AShare`` of ring words, data (4, *shape), a
stacked segment leaf (count, 4, *shape); caches keep two components (m,
the lambda sum).  ``trident=False`` gives the PlainEngine's float64
tensors.

Sharding rules (the JAX module's, rule for rule), over a ``mesh.Mesh``:
  * batch dims -> ("pod", "data"); the model axis carries TP (heads /
    d_ff) and EP (experts); the share-component axis is never sharded;
  * fsdp=True also shards the d_model axis of the big weight matrices
    over "data" (gathered on use);
  * a decode cache leaf shards its first dimension of the batch's size
    over the data axes; everything else is replicated;
  * ``fit_sharding`` drops an entry whose dimension the mesh axes do not
    divide (whisper's vocab 51,865 on 16 model ranks stays whole).
A sharding is a ``Sharding`` (mesh, spec) whose ``shard_shape`` is what
``jax.sharding.NamedSharding.shard_shape`` gives; the sharding trees
match the spec trees leaf for leaf, as JAX's do.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..configs import SHAPES
from ..core.ring import RING64, Ring
from ..core.shares import AShare
from ..nn.model import ModelConfig, tree_map
from .mesh import data_axes

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
                trident: bool = True, dims: tuple | None = None,
                mesh=None):
    """Meta stand-ins for every model input of a workload shape
    (``configs.SHAPES[shape_name]``, or `dims` = (seq, batch, kind)):
    train takes ids and labels, prefill ids, decode one id a row and the
    caches of `seq` positions; the vlm's frontend embeddings and the
    encdec's encoder inputs are shares.  Without a mesh, the args dict;
    with one, (args, shardings) as the JAX module returns them."""
    seq, batch, kind = dims or SHAPES[shape_name]
    bdims = None if mesh is None else data_axes(mesh)

    def bshard(shape):
        return None if mesh is None else fit_sharding(mesh, shape,
                                                      (bdims, None))

    args, shards = {}, {}
    if kind in ("train", "prefill"):
        args["ids"] = torch.empty((batch, seq), dtype=IDS_DTYPE, device=META)
        shards["ids"] = bshard((batch, seq))
        if kind == "train":
            args["labels"] = torch.empty((batch, seq), dtype=IDS_DTYPE,
                                         device=META)
            shards["labels"] = bshard((batch, seq))
        front = (batch, cfg.frontend_tokens, cfg.d_model)
        key = {"vlm": "frontend_embs", "encdec": "enc_inputs"}.get(
            cfg.family)
        if key:
            args[key] = _share(front, ring, trident)
            shards[key] = _share_shard(mesh, bdims, trident, (None, None),
                                       front)
        return args if mesh is None else (args, shards)
    # decode / long_decode: one token + caches of length seq
    long_ctx = kind == "long_decode"
    args["ids"] = torch.empty((batch, 1), dtype=IDS_DTYPE, device=META)
    shards["ids"] = bshard((batch, 1))
    args["caches"] = decode_cache_specs(cfg, batch, seq, ring=ring,
                                        trident=trident, long_ctx=long_ctx)
    if mesh is None:
        return args
    shards["caches"] = decode_cache_shardings(
        cfg, mesh, bdims, trident=trident, batch=batch, seq=seq,
        long_ctx=long_ctx)
    return args, shards


def _share_shard(mesh, bdims, trident: bool, rest: tuple, shape: tuple):
    if mesh is None:
        return None
    pre = (None,) if trident else ()
    full = ((4,) if trident else ()) + tuple(shape)
    return fit_sharding(mesh, full, pre + (bdims,) + tuple(rest))


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
# Sharding rules
# ===========================================================================
def _entry(ent):
    """A spec entry as JAX's PartitionSpec keeps it: None, a name, or a
    tuple of two or more names (a one-name tuple is the name)."""
    if isinstance(ent, tuple):
        return ent[0] if len(ent) == 1 else ent
    return ent


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A leaf's layout on `mesh`: `spec` has one entry a dimension, None
    (replicated), an axis name or a tuple of names."""
    mesh: object
    spec: tuple

    def __post_init__(self):
        object.__setattr__(self, "spec",
                           tuple(_entry(e) for e in self.spec))

    def ways(self, ent) -> int:
        """How many shards a spec entry cuts its dimension into."""
        if ent is None:
            return 1
        axes = ent if isinstance(ent, tuple) else (ent,)
        return math.prod(self.mesh.shape[a] for a in axes)

    def shard_shape(self, shape) -> tuple:
        """One device's block of a leaf of `shape`."""
        shape = tuple(shape)
        spec = self.spec + (None,) * (len(shape) - len(self.spec))
        out = []
        for dim, ent in zip(shape, spec):
            k = self.ways(ent)
            if dim % k:
                raise ValueError(f"{shape} dim {dim} not divisible by {k} "
                                 f"({self.spec})")
            out.append(dim // k)
        return tuple(out)

    def axes(self) -> set:
        """Every mesh axis the spec names."""
        out = set()
        for ent in self.spec:
            if ent is not None:
                out.update(ent if isinstance(ent, tuple) else (ent,))
        return out


def fit_sharding(mesh, shape, spec: tuple) -> Sharding:
    """Drop spec entries whose dimension is not divisible by the mesh-axis
    product (e.g. whisper's vocab 51865 on a 16-way model axis, batch-1
    long-context decode) -- those dims stay replicated."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, ent in zip(shape, entries):
        if ent is None:
            out.append(None)
            continue
        axes = ent if isinstance(ent, tuple) else (ent,)
        k = math.prod(mesh.shape[a] for a in axes)
        out.append(ent if dim % k == 0 else None)
    return Sharding(mesh, tuple(out))


def _pspec(rule: tuple, trident: bool, stacked: bool,
           ncomp_axes: int = 1) -> tuple:
    """rule: spec entries for the LOGICAL (unstacked, no-component) shape;
    prepend None for the layer-stack and component axes."""
    pre = (None,) * ((1 if stacked else 0) + (ncomp_axes if trident else 0))
    return pre + tuple(rule)


def _leaf_shape(x) -> tuple:
    return tuple(getattr(x, "data", x).shape)


def _map_rules(fn, rules, specs):
    """`fn(rule, spec_leaf)` over a rule tree (nested dicts of tuples)
    laid on its spec tree."""
    if isinstance(rules, tuple):
        return fn(rules, specs)
    return {k: _map_rules(fn, rules[k], specs[k]) for k in sorted(rules)}


def _attn_rules(cfg: ModelConfig, mdl, dat) -> dict:
    r = {"wq": (dat, mdl), "wk": (dat, mdl), "wv": (dat, mdl),
         "wo": (mdl, dat)}
    if cfg.qk_norm:
        r["qnorm_g"] = (None,)
        r["knorm_g"] = (None,)
    return r


def _mlp_rules(cfg: ModelConfig, mdl, dat) -> dict:
    r = {"w_up": (dat, mdl), "w_down": (mdl, dat)}
    if cfg.act in ("swiglu", "sigmoid_glu"):
        r["w_gate"] = (dat, mdl)
    return r


def _ret_rules(mdl, dat) -> dict:
    return {"wq": (dat, mdl), "wk": (dat, mdl), "wv": (dat, mdl),
            "wo": (mdl, dat), "wg": (dat, mdl)}


def _moe_rules(cfg: ModelConfig, mdl, dat) -> dict:
    moe = {"router": (dat, None),
           "e_up": (mdl, dat, None),          # EP: experts over model
           "e_down": (mdl, None, dat)}
    if cfg.act in ("swiglu", "sigmoid_glu"):
        moe["e_gate"] = (mdl, dat, None)
    return moe


def _sl_rules(mdl, dat) -> dict:
    return {"wi": (dat, mdl), "wz": (dat, mdl), "wo": (dat, mdl),
            "wout": (mdl, dat)}


def seg_rules(cfg: ModelConfig, kind: str, fsdp: bool = False) -> dict:
    """The logical spec of every leaf of one layer of `kind`."""
    mdl, dat = "model", ("data" if fsdp else None)
    norm = {"g": (None,)}
    if kind in ("attn_mlp", "enc", "shared_attn", "xattn_mlp"):
        r = {"n1": norm, "n2": norm, "attn": _attn_rules(cfg, mdl, dat),
             "mlp": _mlp_rules(cfg, mdl, dat)}
        if kind == "xattn_mlp":
            r["nx"] = norm
            r["xattn"] = _attn_rules(cfg, mdl, dat)
        return r
    if kind == "attn_moe":
        return {"n1": norm, "n2": norm, "attn": _attn_rules(cfg, mdl, dat),
                "moe": _moe_rules(cfg, mdl, dat)}
    if kind == "retention":
        return {"n1": norm, "ret": _ret_rules(mdl, dat)}
    if kind == "ret_slstm_pair":
        return {"n1": norm, "ret": _ret_rules(mdl, dat), "n2": norm,
                "sl": _sl_rules(mdl, dat)}
    raise ValueError(kind)


def head_rules() -> dict:
    """The logical specs of the embedding, the final norm and the head."""
    return {"embed": {"table": ("model", None)},
            "final_norm": {"g": (None,)},
            "lm_head": {"w": (None, "model")}}


def param_shardings(cfg: ModelConfig, mesh, trident: bool = True,
                    fsdp: bool = False, ncomp: int = 4):
    """The Sharding tree matching param_specs (divisibility-fitted)."""
    specs = param_specs(cfg, trident=trident, ncomp=ncomp)

    def fit(stacked):
        return lambda rule, leaf: fit_sharding(
            mesh, _leaf_shape(leaf), _pspec(rule, trident, stacked))

    out = {k: _map_rules(fit(False), r, specs[k])
           for k, r in head_rules().items()}
    out["segments"] = [
        None if kind == "shared_attn" else
        _map_rules(fit(True), seg_rules(cfg, kind, fsdp),
                   specs["segments"][i])
        for i, (kind, _count) in enumerate(cfg.segments())]
    if "shared_attn" in [k for k, _ in cfg.segments()]:
        out["shared_attn"] = _map_rules(
            fit(False), seg_rules(cfg, "shared_attn", fsdp),
            specs["shared_attn"])
    return out


def decode_cache_shardings(cfg: ModelConfig, mesh, bdims,
                           trident: bool = True, batch: int = 2,
                           seq: int = 4, long_ctx: bool = False) -> list:
    """Shard every cache leaf's batch axis (its first dimension of the
    batch's size) over the data axes; everything else replicated (Hk is
    typically < model parallelism)."""
    specs = decode_cache_specs(cfg, batch, seq, trident=trident,
                               long_ctx=long_ctx)

    def leaf(x):
        shape = _leaf_shape(x)
        spec = [None] * len(shape)
        for i, s in enumerate(shape):
            if s == batch:
                spec[i] = bdims
                break
        return fit_sharding(mesh, shape, tuple(spec))

    return tree_map(leaf, specs)


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


def shard_bytes(tree, shardings) -> int:
    """One device's bytes of a tree laid out by `shardings` (a tree of
    Shardings matching it leaf for leaf)."""
    total = [0]

    def add(x, sh):
        t = getattr(x, "data", x)
        if isinstance(t, torch.Tensor):
            total[0] += math.prod(sh.shard_shape(t.shape)) * t.element_size()
        return x

    tree_map(add, tree, shardings)
    return total[0]
