"""Generic LM over the Engine: forward, training and serving
(``repro/nn/model.py``).

A model is a sequence of SEGMENTS, each a homogeneous run of layers over
stacked per-layer parameters.  The JAX package runs each segment as a
``jax.lax.scan``; the port runs it as a loop with the same semantics
(``recurrent.scan_loop``: the same PRF counters and keys an iteration, the
same tally and checks), so both open the same words.  Segment kinds:

    attn_mlp    pre-norm attention + pre-norm MLP (dense transformers, vlm)
    attn_moe    pre-norm attention + pre-norm MoE (qwen3-moe, mixtral)
    enc         whisper's encoder layers (attention + MLP)
    xattn_mlp   decoder block with self-attn + cross-attn + MLP (whisper)
    retention   pre-norm matrix-state recurrence (zamba2 mamba, xlstm mLSTM)
    ret_slstm_pair
                a retention layer then a pre-norm scalar-state recurrence
                (xlstm's mLSTM + sLSTM pairs)
    shared_attn zamba2's single shared attn+mlp block applied after each
                retention group (one parameter set for every application;
                it runs outside any layer loop, on the context's own key)

Modality frontends (whisper audio, phi-3-vision CLIP) are stubs:
precomputed frame / patch embeddings are secret-shared and consumed
directly.

Manual backprop: the forward loop keeps each layer's cache (with
cfg.remat only its input); ``backward`` runs each segment's layers as a
reverse loop (``scan_loop(..., reverse=True)``) whose body re-runs the
layer forward under the forward's keys where cfg.remat says so, then the
layer backward under keys of its own (tags ``seg_{kind}`` and
``segbwd_{kind}``), as the JAX package's reverse scan does.  The re-run
forward starts from the backward loop's PRF counter, not the forward's:
its masks, and so its truncations' rounding, may differ from the forward
run's; the JAX package's do too, so the words are the same.
The shared block's backward runs outside any loop, at its place in the
reversed segment order, and its gradients are summed over its uses into
``grads["shared_attn"]`` (its segment's entry stays None).
``train_step`` is one step of training: ``loss_and_grads`` (the smx
softmax's cross-entropy gradient (p - onehot) / N, one declassified
monitoring loss), optionally summed over microbatches, then plain SGD
(``sgd_update``) or an optimizer of ``train.optim`` (``SGD``,
``Momentum``).  Every segment kind trains.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.shares import AShare
from . import blocks as B
from . import layers as L
from . import recurrent as R
from .engine import Engine, TridentEngine
from .recurrent import _leaf, _wrap, scan_loop, stack_outs


# ===========================================================================
# Config
# ===========================================================================
@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0              # 0 -> d_model // n_heads
    act: str = "swiglu"          # mlp activation
    qk_norm: bool = False
    window: int | None = None    # sliding-window attention
    n_experts: int = 0
    top_k: int = 0
    moe_routing: str = "public"  # public | dense
    ssm_state: int = 0
    shared_attn_every: int = 6   # zamba2: shared block cadence
    n_encoder_layers: int = 0    # whisper
    frontend: str | None = None  # audio | vision (stub)
    frontend_tokens: int = 0     # prepended patch/frame embeddings (vlm)
    rope_theta: float = 1e4
    seq_chunk: int = 128         # recurrence chunk
    q_chunk: int | None = None   # prefill query chunk
    long_window: int = 8192      # window cap for hybrid long-context serving
    remat: bool = True
    microbatch: int = 0          # 0 = no microbatching

    @property
    def dh(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    def attn_cfg(self, window=None) -> L.AttnConfig:
        return L.AttnConfig(
            d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, d_head=self.dh,
            qk_norm=self.qk_norm,
            window=self.window if window is None else window,
            rope_theta=self.rope_theta)

    def mlp_cfg(self) -> B.MLPConfig:
        return B.MLPConfig(self.d_model, self.d_ff, self.act)

    def moe_cfg(self) -> B.MoEConfig:
        return B.MoEConfig(self.d_model, self.d_ff, self.n_experts,
                           self.top_k, self.act, self.moe_routing)

    def ret_cfg(self) -> R.RetentionConfig:
        return R.RetentionConfig(
            d_model=self.d_model, n_heads=self.n_heads,
            d_k=self.ssm_state or self.dh,
            d_v=self.d_model // self.n_heads, seq_chunk=self.seq_chunk)

    def slstm_cfg(self) -> R.SLSTMConfig:
        return R.SLSTMConfig(self.d_model, self.n_heads, self.seq_chunk)

    def segments(self):
        """[(kind, count)] layer plan."""
        if self.family in ("dense", "vlm"):
            return [("attn_mlp", self.n_layers)]
        if self.family == "moe":
            return [("attn_moe", self.n_layers)]
        if self.family == "hybrid":
            segs = []
            left = self.n_layers
            while left > 0:
                take = min(self.shared_attn_every, left)
                segs.append(("retention", take))
                left -= take
                segs.append(("shared_attn", 1))
            return segs
        if self.family == "ssm":
            # xlstm: alternate mLSTM (retention) and sLSTM pairs
            return [("ret_slstm_pair", self.n_layers // 2)]
        if self.family == "encdec":
            return [("enc", self.n_encoder_layers),
                    ("xattn_mlp", self.n_layers)]
        raise ValueError(self.family)


# ===========================================================================
# Parameter trees: nested dicts (and lists) with arrays at the leaves.
# Dict keys are visited in sorted order, as jax.tree_util visits them, so
# converting a tree draws the PRF streams in the JAX package's order.
# ===========================================================================
def tree_map(fn, *trees):
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees))
                for k in sorted(first)}
    if isinstance(first, (list, tuple)):
        return type(first)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


# ===========================================================================
# Parameter init (numpy float64; converted per engine afterwards)
# ===========================================================================
def _layer_init(rng, cfg: ModelConfig, kind: str):
    if kind in ("attn_mlp", "enc", "shared_attn"):
        return {"n1": L.rmsnorm_init(rng, cfg.d_model),
                "attn": L.attention_init(rng, cfg.attn_cfg()),
                "n2": L.rmsnorm_init(rng, cfg.d_model),
                "mlp": B.mlp_init(rng, cfg.mlp_cfg())}
    if kind == "attn_moe":
        return {"n1": L.rmsnorm_init(rng, cfg.d_model),
                "attn": L.attention_init(rng, cfg.attn_cfg()),
                "n2": L.rmsnorm_init(rng, cfg.d_model),
                "moe": B.moe_init(rng, cfg.moe_cfg())}
    if kind == "xattn_mlp":
        return {"n1": L.rmsnorm_init(rng, cfg.d_model),
                "attn": L.attention_init(rng, cfg.attn_cfg()),
                "nx": L.rmsnorm_init(rng, cfg.d_model),
                "xattn": L.attention_init(rng, cfg.attn_cfg()),
                "n2": L.rmsnorm_init(rng, cfg.d_model),
                "mlp": B.mlp_init(rng, cfg.mlp_cfg())}
    if kind == "retention":
        return {"n1": L.rmsnorm_init(rng, cfg.d_model),
                "ret": R.retention_init(rng, cfg.ret_cfg())}
    if kind == "ret_slstm_pair":
        return {"n1": L.rmsnorm_init(rng, cfg.d_model),
                "ret": R.retention_init(rng, cfg.ret_cfg()),
                "n2": L.rmsnorm_init(rng, cfg.d_model),
                "sl": R.slstm_init(rng, cfg.slstm_cfg())}
    raise ValueError(kind)


def init_params(cfg: ModelConfig, seed: int = 0):
    """The plain (numpy float64) parameter tree: the JAX package's draws
    from the same ``RandomState`` in the same order, so the same weights
    (and the way weights cross between the packages).  A shared_attn
    segment holds None; its one parameter set ("shared_attn") is drawn
    after every segment."""
    rng = np.random.RandomState(seed)
    p = {"embed": L.embedding_init(rng, cfg.vocab, cfg.d_model),
         "final_norm": L.rmsnorm_init(rng, cfg.d_model),
         "lm_head": L.linear_init(rng, cfg.d_model, cfg.vocab, scale=0.02)}
    p["segments"] = [
        None if kind == "shared_attn" else
        tree_map(lambda *xs: np.stack(xs),
                 *[_layer_init(rng, cfg, kind) for _ in range(count)])
        for kind, count in cfg.segments()]
    if any(kind == "shared_attn" for kind, _ in cfg.segments()):
        p["shared_attn"] = _layer_init(rng, cfg, "shared_attn")
    return p


def params_to_engine(eng: Engine, params):
    """Convert the numpy tree to engine tensors (Pi_Sh for Trident).
    Stacked segment leaves keep the JAX package's scan layout: a share's
    data is (n, 4, ...)."""
    def conv_stacked(x):
        t = eng.from_plain(x)            # AShare data (4, n, ...) | (n, ...)
        if isinstance(eng, TridentEngine):
            return AShare(torch.movedim(t.data, 0, 1))   # (n, 4, ...)
        return t

    out = {"embed": tree_map(eng.from_plain, params["embed"]),
           "final_norm": tree_map(eng.from_plain, params["final_norm"]),
           "lm_head": tree_map(eng.from_plain, params["lm_head"])}
    out["segments"] = [tree_map(conv_stacked, stacked)
                       for stacked in params["segments"]]
    if "shared_attn" in params:
        out["shared_attn"] = tree_map(eng.from_plain, params["shared_attn"])
    return out


def _layer(eng, stacked, i: int):
    """Layer i's parameters of a stacked segment."""
    if isinstance(eng, TridentEngine):
        return tree_map(lambda a: AShare(a.data[i]), stacked)
    return tree_map(lambda a: a[i], stacked)


def _cache_at(cache, i: int):
    """Layer i's raw serving cache of a stacked segment cache."""
    return tree_map(lambda a: a[i], cache)


# ===========================================================================
# Blocks (single layer) -- pre-norm residual wiring
# ===========================================================================
def _block_fwd(eng, cfg: ModelConfig, kind: str, p, x, enc_out=None):
    if kind in ("attn_mlp", "enc", "attn_moe", "shared_attn"):
        h, c1 = L.rmsnorm_fwd(eng, p["n1"], x)
        a, ca, _ = L.attention_fwd(eng, p["attn"], cfg.attn_cfg(), h)
        x1 = eng.add(x, a)
        h2, c2 = L.rmsnorm_fwd(eng, p["n2"], x1)
        if kind == "attn_moe":
            m, cm = B.moe_fwd(eng, p["moe"], cfg.moe_cfg(), h2)
        else:
            m, cm = B.mlp_fwd(eng, p["mlp"], cfg.mlp_cfg(), h2)
        y = eng.add(x1, m)
        return y, (c1, ca, c2, cm)
    if kind == "xattn_mlp":
        h, c1 = L.rmsnorm_fwd(eng, p["n1"], x)
        a, ca, _ = L.attention_fwd(eng, p["attn"], cfg.attn_cfg(), h)
        x1 = eng.add(x, a)
        hx, cxn = L.rmsnorm_fwd(eng, p["nx"], x1)
        xa, cxa = L.cross_attention_fwd(eng, p["xattn"], cfg.attn_cfg(),
                                        hx, enc_out)
        x2 = eng.add(x1, xa)
        h2, c2 = L.rmsnorm_fwd(eng, p["n2"], x2)
        m, cm = B.mlp_fwd(eng, p["mlp"], cfg.mlp_cfg(), h2)
        y = eng.add(x2, m)
        return y, (c1, ca, cxn, cxa, c2, cm)
    if kind == "retention":
        h, c1 = L.rmsnorm_fwd(eng, p["n1"], x)
        r, cr, _ = R.retention_fwd(eng, p["ret"], cfg.ret_cfg(), h)
        return eng.add(x, r), (c1, cr)
    if kind == "ret_slstm_pair":
        h, c1 = L.rmsnorm_fwd(eng, p["n1"], x)
        r, cr, _ = R.retention_fwd(eng, p["ret"], cfg.ret_cfg(), h)
        x1 = eng.add(x, r)
        h2, c2 = L.rmsnorm_fwd(eng, p["n2"], x1)
        sl, cs, _ = R.slstm_fwd(eng, p["sl"], cfg.slstm_cfg(), h2)
        return eng.add(x1, sl), (c1, cr, c2, cs)
    raise ValueError(kind)


def _seg_fwd(eng, cfg: ModelConfig, kind: str, stacked, x, count: int,
             enc_out=None):
    """One segment's layers; returns (y, [each layer's cache]): its input
    with cfg.remat (the backward pass re-runs the layer), else its
    forward cache."""
    def body(carry, i):
        xi = _wrap(eng, carry)
        y, cache = _block_fwd(eng, cfg, kind, _layer(eng, stacked, i), xi,
                              enc_out=enc_out)
        return _leaf(eng, y), (_leaf(eng, xi) if cfg.remat else cache)

    y, caches = scan_loop(eng, count, f"seg_{kind}", body, _leaf(eng, x))
    return _wrap(eng, y), caches


def _block_bwd(eng, cfg: ModelConfig, kind: str, p, cache, dy):
    """One layer's backward pass: (dx, grads), and for xattn_mlp
    (dx, grads, d_enc)."""
    if kind in ("attn_mlp", "enc", "attn_moe", "shared_attn"):
        c1, ca, c2, cm = cache
        if kind == "attn_moe":
            dm, g_m = B.moe_bwd(eng, p["moe"], cfg.moe_cfg(), cm, dy)
        else:
            dm, g_m = B.mlp_bwd(eng, p["mlp"], cfg.mlp_cfg(), cm, dy)
        dh2, g_n2 = L.rmsnorm_bwd(eng, p["n2"], c2, dm)
        dx1 = eng.add(dy, dh2)
        da, g_a = L.attention_bwd(eng, p["attn"], cfg.attn_cfg(), ca, dx1)
        dh1, g_n1 = L.rmsnorm_bwd(eng, p["n1"], c1, da)
        dx = eng.add(dx1, dh1)
        return dx, {"n1": g_n1, "attn": g_a, "n2": g_n2,
                    "moe" if kind == "attn_moe" else "mlp": g_m}
    if kind == "xattn_mlp":
        c1, ca, cxn, cxa, c2, cm = cache
        dm, g_m = B.mlp_bwd(eng, p["mlp"], cfg.mlp_cfg(), cm, dy)
        dh2, g_n2 = L.rmsnorm_bwd(eng, p["n2"], c2, dm)
        dx2 = eng.add(dy, dh2)
        dxa, d_enc, g_x = L.cross_attention_bwd(eng, p["xattn"],
                                                cfg.attn_cfg(), cxa, dx2)
        dhx, g_nx = L.rmsnorm_bwd(eng, p["nx"], cxn, dxa)
        dx1 = eng.add(dx2, dhx)
        da, g_a = L.attention_bwd(eng, p["attn"], cfg.attn_cfg(), ca, dx1)
        dh1, g_n1 = L.rmsnorm_bwd(eng, p["n1"], c1, da)
        dx = eng.add(dx1, dh1)
        grads = {"n1": g_n1, "attn": g_a, "nx": g_nx, "xattn": g_x,
                 "n2": g_n2, "mlp": g_m}
        return dx, grads, d_enc
    if kind == "retention":
        c1, cr = cache
        dr, g_r = R.retention_bwd(eng, p["ret"], cfg.ret_cfg(), cr, dy)
        dh1, g_n1 = L.rmsnorm_bwd(eng, p["n1"], c1, dr)
        return eng.add(dy, dh1), {"n1": g_n1, "ret": g_r}
    if kind == "ret_slstm_pair":
        # the sLSTM half first, then the retention half on its dx
        c1, cr, c2, cs = cache
        ds, g_s = R.slstm_bwd(eng, p["sl"], cfg.slstm_cfg(), cs, dy)
        dh2, g_n2 = L.rmsnorm_bwd(eng, p["n2"], c2, ds)
        dx1 = eng.add(dy, dh2)
        dr, g_r = R.retention_bwd(eng, p["ret"], cfg.ret_cfg(), cr, dx1)
        dh1, g_n1 = L.rmsnorm_bwd(eng, p["n1"], c1, dr)
        return eng.add(dx1, dh1), {"n1": g_n1, "ret": g_r, "n2": g_n2,
                                   "sl": g_s}
    raise ValueError(kind)


def _stack_layers(eng, trees: list):
    """Per-layer grads trees -> one tree of stacked leaves, the layout of
    ``params_to_engine``'s segments: a share's data (n, 4, ...)."""
    if isinstance(eng, TridentEngine):
        return tree_map(lambda *xs: AShare(torch.stack([x.data for x in xs])),
                        *trees)
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def _seg_bwd(eng, cfg: ModelConfig, kind: str, stacked, caches, dy,
             count: int, enc_out=None):
    """A segment's layers in reverse (``scan_loop(..., reverse=True)``):
    with cfg.remat each layer's forward runs again from its stored input
    under the forward's keys (tag ``seg_{kind}``), then its backward under
    ``segbwd_{kind}``.  Returns (dx, stacked grads[, the summed d_enc])."""
    has_enc = kind == "xattn_mlp"

    def body(carry, i, scopes):
        fwd_keys, bwd_keys = scopes
        dxc, denc_acc = carry if has_enc else (carry, None)
        p = _layer(eng, stacked, i)
        if cfg.remat:
            with fwd_keys():
                _, cache = _block_fwd(eng, cfg, kind, p,
                                      _wrap(eng, caches[i]), enc_out=enc_out)
        else:
            cache = caches[i]
        with bwd_keys():
            out = _block_bwd(eng, cfg, kind, p, cache, _wrap(eng, dxc))
        if has_enc:
            dx, grads, d_enc = out
            return (_leaf(eng, dx), denc_acc + _leaf(eng, d_enc)), grads
        dx, grads = out
        return _leaf(eng, dx), grads

    init = _leaf(eng, dy)
    if has_enc:
        init = (init, _leaf(eng, eng.zeros(eng.shape_of(enc_out))))
    fin, grads = scan_loop(eng, count, (f"seg_{kind}", f"segbwd_{kind}"),
                           body, init, reverse=True)
    grads = _stack_layers(eng, grads)
    if has_enc:
        return _wrap(eng, fin[0]), grads, _wrap(eng, fin[1])
    return _wrap(eng, fin), grads


# ===========================================================================
# Full model forward
# ===========================================================================
def forward(eng: Engine, cfg: ModelConfig, params, ids,
            frontend_embs=None, enc_inputs=None):
    """ids: (B, S) public token ids.
    frontend_embs (vlm): (B, n_patches, D) precomputed patch embeddings
    (secret-shared activations from the stubbed frontend).
    enc_inputs (encdec): (B, S_enc, D) precomputed frame embeddings.
    Returns (logits, cache)."""
    x, c_emb = L.embedding_fwd(eng, params["embed"], ids)
    n_front = 0
    if cfg.family == "vlm" and frontend_embs is not None:
        x = eng.concat([frontend_embs, x], axis=1)
        n_front = eng.shape_of(frontend_embs)[1]

    enc_out = None
    seg_caches = []
    for (kind, count), stacked in zip(cfg.segments(), params["segments"]):
        if kind == "enc":
            enc_out, cs = _seg_fwd(eng, cfg, kind, stacked, enc_inputs,
                                   count)
        elif kind == "shared_attn":
            x, cs = _block_fwd(eng, cfg, kind, params["shared_attn"], x)
        else:
            x, cs = _seg_fwd(eng, cfg, kind, stacked, x, count,
                             enc_out=enc_out)
        seg_caches.append(cs)

    xn, c_fn = L.rmsnorm_fwd(eng, params["final_norm"], x)
    logits, c_head = linear_fwd_model(eng, params["lm_head"], xn)
    return logits, (c_emb, n_front, seg_caches, c_fn, c_head, enc_out)


def linear_fwd_model(eng, p, x):
    """The lm_head's ``linear_fwd`` (the JAX package's name for it)."""
    return L.linear_fwd(eng, p, x)


def backward(eng: Engine, cfg: ModelConfig, params, cache, dlogits):
    """Returns the grads tree, laid out as params (segments stacked; a
    shared_attn segment's entry None, the shared block's gradients summed
    over its uses in ``grads["shared_attn"]``)."""
    c_emb, n_front, seg_caches, c_fn, c_head, enc_out = cache
    dxn, g_head = L.linear_bwd(eng, params["lm_head"], c_head, dlogits)
    dx, g_fn = L.rmsnorm_bwd(eng, params["final_norm"], c_fn, dxn)
    grads = {"lm_head": g_head, "final_norm": g_fn}
    seg_grads = []
    d_enc_total = shared = None
    for (kind, count), stacked, cs in zip(
            reversed(cfg.segments()), reversed(params["segments"]),
            reversed(seg_caches)):
        if kind == "shared_attn":
            # outside any loop, under the context's own keys and counter
            dx, g_seg = _block_bwd(eng, cfg, kind, params["shared_attn"], cs,
                                   dx)
            shared = g_seg if shared is None else tree_map(eng.add, shared,
                                                           g_seg)
            g_seg = None
        elif kind == "enc":
            # the encoder's grads come after the decoder's d_enc is summed
            _, g_seg = _seg_bwd(eng, cfg, kind, stacked, cs, d_enc_total,
                                count)
        elif kind == "xattn_mlp":
            dx, g_seg, d_enc = _seg_bwd(eng, cfg, kind, stacked, cs, dx,
                                        count, enc_out=enc_out)
            d_enc_total = d_enc if d_enc_total is None else \
                eng.add(d_enc_total, d_enc)
        else:
            dx, g_seg = _seg_bwd(eng, cfg, kind, stacked, cs, dx, count)
        seg_grads.append(g_seg)
    grads["segments"] = list(reversed(seg_grads))
    if shared is not None:
        grads["shared_attn"] = shared
    if n_front:
        dx = _drop_front(eng, dx, n_front)
    _, grads["embed"] = L.embedding_bwd(eng, params["embed"], c_emb, dx)
    return grads


def _drop_front(eng, x, n_front):
    """(B, S, ...) -> (B, S - n_front, ...): the frontend's positions
    dropped."""
    if isinstance(eng, TridentEngine):
        return AShare(x.data[:, :, n_front:])
    return x[:, n_front:]


def _pad_front(eng, x, n_front):
    """(B, S, D) -> (B, n_front + S, D): zeros before the positions."""
    if isinstance(eng, TridentEngine):
        return AShare(torch.nn.functional.pad(x.data, (0, 0, n_front, 0)))
    return torch.nn.functional.pad(x, (0, 0, n_front, 0))


# ===========================================================================
# Train step: smx-softmax cross-entropy gradient + manual backprop
# ===========================================================================
def loss_and_grads(eng: Engine, cfg: ModelConfig, params, ids, labels,
                   frontend_embs=None, enc_inputs=None):
    """Cross-entropy through the paper's smx softmax (``loss_head``), then
    ``backward``.  Returns (loss_proxy, grads)."""
    logits, cache = forward(eng, cfg, params, ids,
                            frontend_embs=frontend_embs,
                            enc_inputs=enc_inputs)
    nf = eng.shape_of(frontend_embs)[1] \
        if cfg.family == "vlm" and frontend_embs is not None else 0
    loss, dlogits = loss_head(eng, cfg, logits, labels, nf)
    del logits
    return loss, backward(eng, cfg, params, cache, dlogits)


def loss_head(eng: Engine, cfg: ModelConfig, logits, labels,
              n_front: int = 0):
    """The loss at the logits of every position: the smx softmax p over
    the vocabulary, dlogits = (p - onehot) / N (N = labels.size; zeros at
    the first `n_front` positions, the frontend's) and loss_proxy = mean(1
    - p_correct), declassified (one Pi_Rec): a float32 scalar tensor.
    Returns (loss_proxy, dlogits)."""
    labels = torch.as_tensor(labels).to(dtype=torch.int64,
                                        device=L._device(eng))
    bsz, seq = labels.shape
    if n_front:
        logits = _drop_front(eng, logits, n_front)
    p, _ = eng.softmax(logits, axis=-1)
    del logits
    onehot = torch.nn.functional.one_hot(labels, cfg.vocab).to(torch.float64)
    dlogits = eng.scale(eng.add_public(p, -onehot), 1.0 / (bsz * seq))
    del onehot
    if n_front:
        dlogits = _pad_front(eng, dlogits, n_front)
    # monitoring loss: 1 - mean(p[label])  (a local gather + 1 declassify)
    loss = eng.declassify(_mean_all(eng, _gather_labels(eng, p, labels)))
    return 1.0 - loss.reshape(()), dlogits


def _mean_all(eng, x):
    n = 1
    for s in eng.shape_of(x):
        n *= s
    s = eng.sum(eng.reshape(x, (n,)), axis=0, keepdims=True)
    return eng.scale(s, 1.0 / n)


def _gather_labels(eng, p, labels):
    """p: (B,S,V), labels public (B,S) -> (B,S) share of p[label]."""
    b, s, v = eng.shape_of(p)
    flat_idx = torch.arange(b * s, device=labels.device) * v \
        + labels.reshape(-1)
    pf = eng.reshape(p, (b * s * v,))
    return eng.reshape(eng.take(pf, flat_idx, axis=0), (b, s))


def train_step(eng: Engine, cfg: ModelConfig, params, ids, labels, lr=0.01,
               frontend_embs=None, enc_inputs=None, optimizer=None,
               opt_state=None):
    """One training step (forward, backward, update), microbatched where
    cfg.microbatch > 1: plain SGD at `lr` (``sgd_update``), or
    `optimizer`'s update (``train.optim``; its state from
    ``optimizer.init`` where `opt_state` is None).  Returns (new_params,
    loss, opt_state)."""
    if cfg.microbatch and cfg.microbatch > 1:
        loss, grads = _microbatched_grads(eng, cfg, params, ids, labels,
                                          frontend_embs, enc_inputs)
    else:
        loss, grads = loss_and_grads(eng, cfg, params, ids, labels,
                                     frontend_embs=frontend_embs,
                                     enc_inputs=enc_inputs)
    if optimizer is None:
        return sgd_update(eng, params, grads, lr), loss, None
    if opt_state is None:
        opt_state = optimizer.init(eng, params)
    new_params, opt_state = optimizer.update(eng, params, grads, opt_state)
    return new_params, loss, opt_state


def _microbatched_grads(eng, cfg, params, ids, labels, fe, enc):
    """Gradient accumulation over cfg.microbatch slices of the batch
    (activation memory / n_micro; the grads add locally, no
    communication), then one scale by 1 / n_micro a leaf."""
    n_micro = cfg.microbatch
    mb = ids.shape[0] // n_micro
    total_loss, acc = 0.0, None
    for i in range(n_micro):
        sl = slice(i * mb, (i + 1) * mb)
        loss, grads = loss_and_grads(
            eng, cfg, params, ids[sl], labels[sl],
            frontend_embs=None if fe is None else _slice0(eng, fe, sl),
            enc_inputs=None if enc is None else _slice0(eng, enc, sl))
        total_loss = total_loss + loss
        acc = grads if acc is None else tree_map(eng.add, acc, grads)
    return total_loss / n_micro, _tree_scale(eng, acc, 1.0 / n_micro)


def _slice0(eng, x, sl):
    if isinstance(eng, TridentEngine):
        return AShare(x.data[:, sl])
    return x[sl]


def _tree_scale(eng, grads, c: float):
    """Each grads leaf times c (one truncation a leaf where c < 1), in the
    JAX package's leaf order (``map_params``).  (The JAX package scales
    the stacked (n, 4, ...) words as a share whose component axis is the
    layer axis, and its new params come out (4, 4, ...): ROADMAP F5.)"""
    return map_params(eng, lambda x: eng.scale(x, c), grads)


def map_params(eng, fn, *trees):
    """`fn` over the aligned leaves of trees laid out as params, in the
    JAX package's leaf order (sorted keys, the segments in order).  Which
    leaves are stacked is read from the tree's structure: each leaf under
    ``"segments"`` is a share's data (n, 4, ...), taken by `fn` as one
    (n, ...) share (``_on_stacked``), whatever n is.  (The JAX package
    tells a stacked leaf by its shape and takes one of 4 layers for a
    plain share: ROADMAP F5, F6.)"""
    out = {}
    for key in sorted(trees[0]):
        sub = [t[key] for t in trees]
        if key == "segments":
            out[key] = [tree_map(lambda *xs: _on_stacked(eng, fn, *xs), *segs)
                        for segs in zip(*sub)]
        else:
            out[key] = tree_map(fn, *sub)
    return out


def _on_stacked(eng, fn, *xs):
    """`fn` of shares over stacked segment leaves (a share's data (n, 4,
    ...)) as (n, ...) shares: the component axis moved first and back."""
    if isinstance(eng, TridentEngine):
        r = fn(*(AShare(torch.movedim(x.data, 0, 1)) for x in xs))
        return AShare(torch.movedim(r.data, 0, 1))
    return fn(*xs)


def sgd_update(eng: Engine, params, grads, lr: float):
    """w <- w - lr * g, leaf by leaf in the JAX package's order (each
    scale by lr < 1 draws a truncation's PRF words).  A stacked segment
    leaf is updated as one (n, ...) share.  The grads tree is consumed:
    each leaf is dropped once its new leaf exists."""
    def upd(w, g):
        return eng.sub(w, eng.scale(g, lr))

    def stacked_upd(w, g):
        return _on_stacked(eng, upd, w, g)

    def consume(f, ps, gs, key):
        out = tree_map(f, ps[key], gs[key])
        gs[key] = None
        return out

    new = {key: consume(upd, params, grads, key)
           for key in ("embed", "final_norm", "lm_head")}
    gsegs = grads["segments"]
    new["segments"] = [
        None if stacked is None else consume(stacked_upd, params["segments"],
                                             gsegs, i)
        for i, stacked in enumerate(params["segments"])]
    if "shared_attn" in params:
        new["shared_attn"] = consume(upd, params, grads, "shared_attn")
    return new


# ===========================================================================
# Serving
# ===========================================================================
# KV caches are stored 2-component ([m, lam_sum]): per-party memory is what
# a real deployment pays; the joint simulation's 4-component stack is
# redundant for cached tensors (values and tallies identical).
def kv_compress(eng, x):
    if isinstance(eng, TridentEngine):
        d = x.data
        return torch.stack([d[0], d[1] + d[2] + d[3]])
    return x


def kv_expand(eng, raw):
    if isinstance(eng, TridentEngine):
        return AShare(torch.cat([raw, torch.zeros_like(raw)], dim=0))
    return raw


def _last_token(eng, x):
    if isinstance(eng, TridentEngine):
        return AShare(x.data[:, :, -1:])
    return x[:, -1:]


def serve_prefill(eng: Engine, cfg: ModelConfig, params, ids,
                  frontend_embs=None, enc_inputs=None, long_ctx=False):
    """Prefill with q-chunked attention; returns (logits_last, caches).
    caches: list aligned with cfg.segments():
      {"k", "v"} raw (L, 2, ...)        attention segments
      + "enc_kv" {"k", "v"}             cross-attention segments (whisper)
      {"s"} / {"s1", "s2"} raw (L, 2, ...)  recurrent states (retention;
                                        ret_slstm_pair)
      {"k", "v"} raw (2, ...)           the shared block (no layer axis)
      share                             encoder output (whisper)
    Each segment's layers run as one loop (``scan_loop``); the shared
    block runs outside any loop.  long_ctx: the attention windows, the
    shared block's too, take cfg.long_window (``_window``)."""
    x, _ = L.embedding_fwd(eng, params["embed"], ids)
    if cfg.family == "vlm" and frontend_embs is not None:
        x = eng.concat([frontend_embs, x], axis=1)

    enc_out = None
    caches = []
    for (kind, count), stacked in zip(cfg.segments(), params["segments"]):
        if kind == "enc":
            enc_out, _ = _seg_fwd(eng, cfg, kind, stacked, enc_inputs,
                                  count)
            caches.append(enc_out)
            continue
        if kind == "shared_attn":
            x, kv = _infer_block(eng, cfg, kind, params["shared_attn"], x,
                                 None, long_ctx)
            caches.append(kv)
            continue
        x, cache = _seg_infer_scan(eng, cfg, kind, stacked, x, count,
                                   enc_out=enc_out, long_ctx=long_ctx)
        caches.append(cache)

    xn, _ = L.rmsnorm_fwd(eng, params["final_norm"], x)
    last = _last_token(eng, xn)
    logits, _ = L.linear_fwd(eng, params["lm_head"], last)
    return logits, caches


def _window(cfg, long_ctx):
    """The attention kinds' window: cfg.long_window when serving a long
    context (it widens a narrower cfg.window, as the JAX package does),
    else cfg.window.  The hybrid family has no cfg.window, so its shared
    block keeps all positions, or the last cfg.long_window of them."""
    return (cfg.long_window if long_ctx else None) or cfg.window


def _infer_block(eng, cfg, kind, p, x, enc_out, long_ctx):
    """Forward-only block; returns (y, serve-cache dict of raw leaves)."""
    if kind in ("attn_mlp", "enc", "attn_moe", "shared_attn"):
        window = _window(cfg, long_ctx)
        h, _ = L.rmsnorm_fwd(eng, p["n1"], x)
        a, kv = L.attention_prefill(eng, p["attn"],
                                    cfg.attn_cfg(window=window), h,
                                    q_chunk=cfg.q_chunk)
        x1 = eng.add(x, a)
        h2, _ = L.rmsnorm_fwd(eng, p["n2"], x1)
        if kind == "attn_moe":
            m, _ = B.moe_fwd(eng, p["moe"], cfg.moe_cfg(), h2)
        else:
            m, _ = B.mlp_fwd(eng, p["mlp"], cfg.mlp_cfg(), h2)
        y = eng.add(x1, m)
        cache = {"k": kv_compress(eng, kv["k"]),
                 "v": kv_compress(eng, kv["v"])}
        if window is not None:
            cache = {"k": cache["k"][..., -window:, :],
                     "v": cache["v"][..., -window:, :]}
        return y, cache
    if kind == "retention":
        h, _ = L.rmsnorm_fwd(eng, p["n1"], x)
        r, _, st = R.retention_fwd(eng, p["ret"], cfg.ret_cfg(), h)
        return eng.add(x, r), {"s": kv_compress(eng, st)}
    if kind == "ret_slstm_pair":
        h, _ = L.rmsnorm_fwd(eng, p["n1"], x)
        r, _, st1 = R.retention_fwd(eng, p["ret"], cfg.ret_cfg(), h)
        x1 = eng.add(x, r)
        h2, _ = L.rmsnorm_fwd(eng, p["n2"], x1)
        sl, _, st2 = R.slstm_fwd(eng, p["sl"], cfg.slstm_cfg(), h2)
        return eng.add(x1, sl), {"s1": kv_compress(eng, st1),
                                 "s2": kv_compress(eng, st2)}
    if kind == "xattn_mlp":
        h, _ = L.rmsnorm_fwd(eng, p["n1"], x)
        a, kv = L.attention_prefill(eng, p["attn"], cfg.attn_cfg(), h,
                                    q_chunk=cfg.q_chunk)
        x1 = eng.add(x, a)
        hx, _ = L.rmsnorm_fwd(eng, p["nx"], x1)
        xa, _ = L.cross_attention_fwd(eng, p["xattn"], cfg.attn_cfg(),
                                      hx, enc_out)
        x2 = eng.add(x1, xa)
        h2, _ = L.rmsnorm_fwd(eng, p["n2"], x2)
        m, _ = B.mlp_fwd(eng, p["mlp"], cfg.mlp_cfg(), h2)
        y = eng.add(x2, m)
        # per-layer cross-attention K/V of the encoder output, for decode
        Hk, dh = cfg.n_kv_heads, cfg.dh
        ek, _ = L.linear_fwd(eng, {"w": p["xattn"]["wk"]}, enc_out)
        ev, _ = L.linear_fwd(eng, {"w": p["xattn"]["wv"]}, enc_out)
        ek = L._split_heads(eng, ek, Hk, dh)
        ev = L._split_heads(eng, ev, Hk, dh)
        return y, {"k": kv_compress(eng, kv["k"]),
                   "v": kv_compress(eng, kv["v"]),
                   "enc_kv": {"k": kv_compress(eng, ek),
                              "v": kv_compress(eng, ev)}}
    raise ValueError(kind)


def _seg_infer_scan(eng, cfg, kind, stacked, x, count, enc_out=None,
                    long_ctx=False):
    def body(carry, i):
        y, cache = _infer_block(eng, cfg, kind, _layer(eng, stacked, i),
                                _wrap(eng, carry), enc_out, long_ctx)
        return _leaf(eng, y), cache

    y, caches = scan_loop(eng, count, f"inf_{kind}", body, _leaf(eng, x))
    return _wrap(eng, y), stack_outs(caches)


def serve_decode(eng: Engine, cfg: ModelConfig, params, ids_last, caches,
                 pos: int, long_ctx=False):
    """One decode step: ids_last (B,1) public; caches from serve_prefill
    (or a decode step before), served with the same long_ctx.  Returns
    (logits, new_caches)."""
    x, _ = L.embedding_fwd(eng, params["embed"], ids_last)
    new_caches = []
    for (kind, count), stacked, seg_cache in zip(
            cfg.segments(), params["segments"], caches):
        if kind == "enc":
            # the encoder output stays; each decoder layer caches its
            # cross-attention K/V ("enc_kv")
            new_caches.append(seg_cache)
            continue
        if kind == "shared_attn":
            x, kv = _decode_block(eng, cfg, kind, params["shared_attn"], x,
                                  seg_cache, pos, long_ctx)
            new_caches.append(kv)
            continue
        x, new_seg = _seg_decode_scan(eng, cfg, kind, stacked, x,
                                      seg_cache, count, pos, long_ctx)
        new_caches.append(new_seg)
    xn, _ = L.rmsnorm_fwd(eng, params["final_norm"], x)
    logits, _ = L.linear_fwd(eng, params["lm_head"], xn)
    return logits, new_caches


def prepare_decode_caches(eng, cfg, prefill_caches):  # noqa: ARG001 -- API
    """The identity: ``serve_prefill`` already gives the caches in the
    layout ``serve_decode`` reads."""
    return prefill_caches


def _decode_block(eng, cfg, kind, p, x, cache, pos, long_ctx):
    if kind in ("attn_mlp", "enc", "attn_moe", "shared_attn"):
        kv = {"k": kv_expand(eng, cache["k"]),
              "v": kv_expand(eng, cache["v"])}
        h, _ = L.rmsnorm_fwd(eng, p["n1"], x)
        a, kv2 = L.attention_decode(
            eng, p["attn"], cfg.attn_cfg(window=_window(cfg, long_ctx)), h,
            kv, pos)
        x1 = eng.add(x, a)
        h2, _ = L.rmsnorm_fwd(eng, p["n2"], x1)
        if kind == "attn_moe":
            m, _ = B.moe_fwd(eng, p["moe"], cfg.moe_cfg(), h2)
        else:
            m, _ = B.mlp_fwd(eng, p["mlp"], cfg.mlp_cfg(), h2)
        y = eng.add(x1, m)
        # windowed archs keep a static cache size; others grow by one
        return y, {"k": kv_compress(eng, kv2["k"]),
                   "v": kv_compress(eng, kv2["v"])}
    if kind == "retention":
        h, _ = L.rmsnorm_fwd(eng, p["n1"], x)
        r, st = R.retention_step(eng, p["ret"], cfg.ret_cfg(), h,
                                 kv_expand(eng, cache["s"]))
        return eng.add(x, r), {"s": kv_compress(eng, st)}
    if kind == "ret_slstm_pair":
        h, _ = L.rmsnorm_fwd(eng, p["n1"], x)
        r, st1 = R.retention_step(eng, p["ret"], cfg.ret_cfg(), h,
                                  kv_expand(eng, cache["s1"]))
        x1 = eng.add(x, r)
        h2, _ = L.rmsnorm_fwd(eng, p["n2"], x1)
        sl, st2 = R.slstm_step(eng, p["sl"], cfg.slstm_cfg(), h2,
                               kv_expand(eng, cache["s2"]))
        return eng.add(x1, sl), {"s1": kv_compress(eng, st1),
                                 "s2": kv_compress(eng, st2)}
    if kind == "xattn_mlp":
        kv = {"k": kv_expand(eng, cache["k"]),
              "v": kv_expand(eng, cache["v"])}
        enc_kv = cache["enc_kv"]
        h, _ = L.rmsnorm_fwd(eng, p["n1"], x)
        a, kv2 = L.attention_decode(eng, p["attn"], cfg.attn_cfg(), h, kv,
                                    pos)
        x1 = eng.add(x, a)
        hx, _ = L.rmsnorm_fwd(eng, p["nx"], x1)
        xa = L.cross_attention_decode(
            eng, p["xattn"], cfg.attn_cfg(), hx,
            {"k": kv_expand(eng, enc_kv["k"]),
             "v": kv_expand(eng, enc_kv["v"])})
        x2 = eng.add(x1, xa)
        h2, _ = L.rmsnorm_fwd(eng, p["n2"], x2)
        m, _ = B.mlp_fwd(eng, p["mlp"], cfg.mlp_cfg(), h2)
        y = eng.add(x2, m)
        return y, {"k": kv_compress(eng, kv2["k"]),
                   "v": kv_compress(eng, kv2["v"]), "enc_kv": enc_kv}
    raise ValueError(kind)


def _seg_decode_scan(eng, cfg, kind, stacked, x, seg_cache, count, pos,
                     long_ctx=False):
    def body(carry, i):
        y, nc = _decode_block(eng, cfg, kind, _layer(eng, stacked, i),
                              _wrap(eng, carry), _cache_at(seg_cache, i),
                              pos, long_ctx)
        return _leaf(eng, y), nc

    y, caches = scan_loop(eng, count, f"dec_{kind}", body, _leaf(eng, x))
    return _wrap(eng, y), stack_outs(caches)
