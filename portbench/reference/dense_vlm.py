"""Plain PyTorch reference of the dense vision-language block: the
pre-norm decoder (RMSNorm, rotary multi-head attention, SwiGLU MLP) behind
a run of frontend embeddings, its loss, its hand-written backward pass, a
step of Polyak momentum, and the logits of every position for serving.

It imports nothing of the program.  It follows the equations of the secure
model the program computes, which depart from the published phi-3 block in
three places, each for the arithmetic of secret sharing:

- softmax is the relu-normalised one, p = relu(s) / (sum relu(s) + 0.01),
  over the scores (causal mask) and over the vocabulary in the loss;
- SiLU is x * hardsigmoid(x), hardsigmoid(x) = clamp(x + 1/2, 0, 1);
- the loss is 1 - mean p[label] with dlogits = (p - onehot) / N, N the
  label positions; the frontend's positions carry no label.

Rotary embedding is plain RoPE (theta 10,000) on the two halves of each
head, as the program applies it; phi-3's long-context scaling is left out.

``FixedPoint`` models fixed point's mean behaviour in float64 (or in the
precision given).  The program holds values as words of Z_2^64 with 13
fractional bits.  Every input and public constant is rounded to units of
2^-13 as it is encoded; each truncation (after a product of two shared
values, a product by a public constant that is not a power of two of at
least 1, and a mean, whose 1/n is encoded as round(2^13 / n) units) errs by
-1 unit on average; the reciprocal and the inverse square root are rounded
to units.  What is left between the model and a secure run is the
truncations' zero-mean noise.  A plain float64 run misses the -1 unit bias,
and the sums of a weight gradient over positions and of the softmax over
the vocabulary pile it up until it is many times the gradient itself, so
only the model is a reference for the secure gradient.
"""
from __future__ import annotations

import math

import torch


class FixedPoint:
    """The arithmetic of the model: fixed point's mean behaviour at `frac`
    fractional bits.  With a generator as `noise`, each truncation also
    errs by a zero-mean draw, uniform within `noise_units` units either
    side: a second, noisy run of the same model, which shows how far a
    number compared moves with the truncations' noise alone."""

    def __init__(self, frac: int = 13, noise=None, noise_units=1.0):
        self.frac = frac
        self.unit = 2.0 ** -frac
        self.noise = noise
        self.noise_units = noise_units

    def trunc(self, x):
        """A product as truncated back to `frac` fractional bits."""
        if self.noise is None:
            return x - self.unit
        u = torch.rand(x.shape, generator=self.noise, device=x.device,
                       dtype=x.dtype)
        return x - self.unit + (2 * u - 1) * (self.noise_units * self.unit)

    def q(self, x):
        """A value as it is encoded: rounded to units."""
        s = 2.0 ** self.frac
        return torch.round(x * s) / s

    def qc(self, c: float) -> float:
        s = 2.0 ** self.frac
        return round(c * s) / s

    def mm(self, a, b):
        return self.trunc(torch.matmul(a, b))

    def mul(self, a, b):
        return self.trunc(a * b)

    def scale(self, x, c: float):
        """x * c for a public c: exact for a power of two of at least 1,
        else one truncation of the product by c as encoded."""
        if c >= 1 and float(c).is_integer() and int(c) & (int(c) - 1) == 0:
            return x * c
        return self.trunc(x * self.qc(c))

    def lincomb(self, terms):
        acc = None
        for x, c in terms:
            t = x * (self.q(c) if torch.is_tensor(c) else self.qc(c))
            acc = t if acc is None else acc + t
        return self.trunc(acc)

    def mean(self, x, dim: int):
        return self.scale(x.sum(dim=dim, keepdim=True), 1.0 / x.shape[dim])

    def rsqrt(self, x):
        u = self.unit
        return self.q(torch.where(x <= 0, torch.zeros_like(x),
                                  torch.rsqrt(torch.clamp_min(x, u))))

    def reciprocal(self, x):
        u = self.unit
        return self.q(torch.where(x.abs() < u, torch.zeros_like(x),
                                  1.0 / torch.where(x == 0,
                                                    torch.ones_like(x), x)))


# ---------------------------------------------------------------------------
# The layers, forward and backward
# ---------------------------------------------------------------------------
def rmsnorm(fx, g, x):
    ms = fx.mean(fx.mul(x, x), -1) + fx.qc(1e-5)
    inv = fx.rsqrt(ms)
    xhat = fx.mul(x, inv)
    return fx.mul(xhat, g), (xhat, inv, g)


def rmsnorm_bwd(fx, cache, dy):
    xhat, inv, g = cache
    dxhat = fx.mul(dy, g)
    m = fx.mean(fx.mul(dxhat, xhat), -1)
    dx = fx.mul(dxhat - fx.mul(xhat, m), inv)
    dg = fx.mul(dy, xhat).reshape(-1, dy.shape[-1]).sum(0)
    return dx, dg


def rope_tables(seq: int, d_head: int, theta: float, offset: int, device,
                dtype):
    half = d_head // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float64,
                                          device=device) / half))
    pos = torch.arange(offset, offset + seq, dtype=torch.float64,
                       device=device)[:, None] * freqs[None, :]
    return torch.cos(pos).to(dtype), torch.sin(pos).to(dtype)


def rope(fx, x, cos, sin, inverse: bool = False):
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    s = -sin if inverse else sin
    return torch.cat([fx.lincomb([(x1, cos), (x2, -s)]),
                      fx.lincomb([(x1, s), (x2, cos)])], dim=-1)


def smx(fx, x, mask=None):
    """The relu-normalised softmax over the last axis; (p, cache)."""
    bit = x > 0
    r = torch.clamp_min(x, 0)
    if mask is not None:
        r = r * mask
    inv = fx.reciprocal(r.sum(-1, keepdim=True) + fx.qc(1e-2))
    p = fx.mul(r, inv)
    return p, (p, inv, bit)


def smx_bwd(fx, cache, dp, mask=None):
    p, inv, bit = cache
    inner = fx.mul(dp, p).sum(-1, keepdim=True)
    dr = fx.mul(dp - inner, inv)
    if mask is not None:
        dr = dr * mask
    return dr * bit


def linear_bwd(fx, x, w, dy):
    dw = fx.mm(x.reshape(-1, x.shape[-1]).T, dy.reshape(-1, dy.shape[-1]))
    return fx.mm(dy, w.T), dw


def _heads(x, h):
    b, s, _ = x.shape
    return x.reshape(b, s, h, -1).transpose(1, 2)


def _merge(x):
    b, h, s, dh = x.shape
    return x.transpose(1, 2).reshape(b, s, h * dh)


def attention(fx, p, cfg, x):
    b, s, _ = x.shape
    h, dh = cfg["n_heads"], cfg["d_head"]
    q = _heads(fx.mm(x, p["wq"]), h)
    k = _heads(fx.mm(x, p["wk"]), h)
    v = _heads(fx.mm(x, p["wv"]), h)
    cos, sin = rope_tables(s, dh, cfg["rope_theta"], 0, x.device, x.dtype)
    q, k = rope(fx, q, cos, sin), rope(fx, k, cos, sin)
    mask = torch.tril(torch.ones(s, s, dtype=x.dtype, device=x.device))
    sc = fx.scale(fx.mm(q, k.transpose(-1, -2)), 1.0 / math.sqrt(dh))
    probs, csm = smx(fx, sc, mask)
    merged = _merge(fx.mm(probs, v))
    y = fx.mm(merged, p["wo"])
    return y, (x, q, k, v, probs, csm, mask, merged)


def attention_bwd(fx, p, cfg, cache, dy):
    x, q, k, v, probs, csm, mask, merged = cache
    h, dh = cfg["n_heads"], cfg["d_head"]
    dmerged, g_o = linear_bwd(fx, merged, p["wo"], dy)
    dctx = _heads(dmerged, h)
    dprobs = fx.mm(dctx, v.transpose(-1, -2))
    dv = fx.mm(probs.transpose(-1, -2), dctx)
    ds = fx.scale(smx_bwd(fx, csm, dprobs, mask), 1.0 / math.sqrt(dh))
    dq = fx.mm(ds, k)
    dk = fx.mm(ds.transpose(-1, -2), q)
    cos, sin = rope_tables(x.shape[1], dh, cfg["rope_theta"], 0, x.device,
                           x.dtype)
    dq, dk = rope(fx, dq, cos, sin, True), rope(fx, dk, cos, sin, True)
    dx1, g_q = linear_bwd(fx, x, p["wq"], _merge(dq))
    dx2, g_k = linear_bwd(fx, x, p["wk"], _merge(dk))
    dx3, g_v = linear_bwd(fx, x, p["wv"], _merge(dv))
    return dx1 + dx2 + dx3, {"wq": g_q, "wk": g_k, "wv": g_v, "wo": g_o}


def mlp(fx, p, x):
    up = fx.mm(x, p["w_up"])
    gate = fx.mm(x, p["w_gate"])
    seg = (gate > -0.5) & (gate < 0.5)
    s = torch.clamp(gate + 0.5, 0.0, 1.0)
    a = fx.mul(gate, s)
    hid = fx.mul(a, up)
    return fx.mm(hid, p["w_down"]), (x, up, gate, s, seg, a, hid)


def mlp_bwd(fx, p, cache, dy):
    x, up, gate, s, seg, a, hid = cache
    dh, g_down = linear_bwd(fx, hid, p["w_down"], dy)
    da, dup = fx.mul(dh, up), fx.mul(dh, a)
    dgate = fx.mul(da, s) + fx.mul(da, gate) * seg
    dx_g, g_gate = linear_bwd(fx, x, p["w_gate"], dgate)
    dx_u, g_up = linear_bwd(fx, x, p["w_up"], dup)
    return dx_u + dx_g, {"w_down": g_down, "w_gate": g_gate, "w_up": g_up}


def block(fx, p, cfg, x):
    h, c1 = rmsnorm(fx, p["n1"], x)
    a, ca = attention(fx, p, cfg, h)
    x1 = x + a
    h2, c2 = rmsnorm(fx, p["n2"], x1)
    m, cm = mlp(fx, p, h2)
    return x1 + m, (c1, ca, c2, cm)


def block_bwd(fx, p, cfg, cache, dy):
    c1, ca, c2, cm = cache
    dm, g_m = mlp_bwd(fx, p, cm, dy)
    dh2, g_n2 = rmsnorm_bwd(fx, c2, dm)
    dx1 = dy + dh2
    da, g_a = attention_bwd(fx, p, cfg, ca, dx1)
    dh1, g_n1 = rmsnorm_bwd(fx, c1, da)
    return dx1 + dh1, {"n1": g_n1, "n2": g_n2, **g_a, **g_m}


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------
def encode(fx, params):
    """The weights as the program holds them once shared."""
    return {k: ([{n: fx.q(t) for n, t in lp.items()} for lp in v]
                if k == "layers" else fx.q(v)) for k, v in params.items()}


def forward(fx, params, cfg, ids, front):
    """Logits of every position of [front, embed(ids)]; (logits, cache)."""
    x = params["embed"][ids]
    if front is not None:
        x = torch.cat([fx.q(front), x], dim=1)
    caches = []
    for p in params["layers"]:
        x, c = block(fx, p, cfg, x)
        caches.append(c)
    xn, c_fn = rmsnorm(fx, params["final_norm"], x)
    return fx.mm(xn, params["lm_head"]), (caches, c_fn, xn)


def loss_head(fx, logits, labels, n_front: int):
    lg = logits[:, n_front:]
    p, _ = smx(fx, lg)
    n = labels.numel()
    onehot = torch.nn.functional.one_hot(labels, lg.shape[-1]).to(lg.dtype)
    dl = fx.scale(p - onehot, 1.0 / n)
    dl = torch.nn.functional.pad(dl, (0, 0, n_front, 0))
    picked = torch.gather(p, -1, labels[..., None]).reshape(-1)
    mean = fx.scale(picked.sum(0, keepdim=True), 1.0 / n)
    return 1.0 - float(mean.to(torch.float32)), dl


def grads(fx, params, cfg, ids, labels, front):
    """(loss, gradient tree laid out as params) of one step."""
    logits, (caches, c_fn, xn) = forward(fx, params, cfg, ids, front)
    n_front = 0 if front is None else front.shape[1]
    loss, dl = loss_head(fx, logits, labels, n_front)
    del logits
    dxn, g_head = linear_bwd(fx, xn, params["lm_head"], dl)
    dx, g_fn = rmsnorm_bwd(fx, c_fn, dxn)
    g_layers = [None] * len(caches)
    for i in range(len(caches) - 1, -1, -1):
        dx, g_layers[i] = block_bwd(fx, params["layers"][i], cfg, caches[i],
                                    dx)
    caches.clear()
    dx = dx[:, n_front:]
    g_embed = torch.zeros_like(params["embed"]).index_add_(
        0, ids.reshape(-1), dx.reshape(-1, dx.shape[-1]))
    return loss, {"embed": g_embed, "final_norm": g_fn, "lm_head": g_head,
                  "layers": g_layers}


def momentum(fx, params, m, g, lr: float, beta: float):
    """Polyak momentum, m <- beta m + g, w <- w - lr m (m None: zeros);
    returns (params, m)."""
    def tmap(fn, *ts):
        return {k: ([{n: fn(*(t[k][i][n] for t in ts)) for n in lp}
                     for i, lp in enumerate(v)] if k == "layers" else
                    fn(*(t[k] for t in ts))) for k, v in ts[0].items()}
    if m is None:
        m = tmap(torch.zeros_like, g)
    m = tmap(lambda a, b: fx.scale(a, beta) + b, m, g)
    return tmap(lambda w, a: w - fx.scale(a, lr), params, m), m


def served_logits(fx, params, cfg, ids, front):
    """Logits of every position after the frontend, in one causal pass
    over the prompt and the tokens served after it (ids: the prompt's ids
    and all served tokens but the last)."""
    logits, _ = forward(fx, params, cfg, ids, front)
    n_front = 0 if front is None else front.shape[1]
    return logits[:, n_front:]
