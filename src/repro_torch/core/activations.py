"""ML building blocks over [[.]]-shares of the joint simulation (paper
Section V and beyond; ``repro/core/activations.py``).

Paper-faithful: relu / drelu (BitExt + BitInj), sigmoid (2 BitExt + AND +
BitInj + Bit2A), the max of a row by tournament, smx softmax (relu / sum(relu), division via the garbled
world).  Beyond-paper: Newton-Raphson reciprocal and rsqrt with an
in-protocol power-of-two normalization (boolean prefix-OR leading-one
detection + one-hot Bit2A table lookup), costs tallied through the same
primitives.
"""
from __future__ import annotations

import torch

from . import boolean as BW
from . import conversions as CV
from . import garbled as GW
from . import protocols as PR
from .context import TridentContext
from .ring import bit_planes
from .shares import AShare, BShare


# ---------------------------------------------------------------------------
# ReLU family (Section V-C a).
# ---------------------------------------------------------------------------
def relu(ctx: TridentContext, v: AShare, return_bit: bool = False):
    """relu(v) = (1 xor b) * v with b = msb(v).  4 online rounds, 8l+2 bits
    with the Fig. 19 BitExt."""
    b = CV.bit_extract(ctx, v)
    nb = ~b
    out = CV.bit_inject(ctx, nb, v)
    return (out, nb) if return_bit else out


def drelu_from_bit(ctx: TridentContext, nb: BShare) -> AShare:
    """drelu = (1 xor b) as an arithmetic share (for backprop)."""
    return CV.bit2a(ctx, nb)


def mul_by_cached_bit(ctx: TridentContext, nb: BShare, v: AShare) -> AShare:
    """dY * drelu using the bit cached by the forward pass (one BitInj)."""
    return CV.bit_inject(ctx, nb, v)


# ---------------------------------------------------------------------------
# Sigmoid (Section V-C b): piecewise-linear MPC approximation.
# ---------------------------------------------------------------------------
def sigmoid(ctx: TridentContext, v: AShare) -> AShare:
    """sig(v) = (1^b1) b2 (v + 1/2) + (1^b2); b1 = [v+1/2 < 0],
    b2 = [v-1/2 < 0].  5 online rounds, 16l+7 bits (Table X)."""
    ring = ctx.ring
    half = ctx.encode(0.5)
    v_hi = v + half
    v_lo = v - half
    # offline material of both BitExts and the AND ships in one round
    # (Lemma D.5: offline R = 3 total with BitInj/Bit2A's two rounds).
    with ctx.tally.parallel(("offline",)):
        with ctx.tally.parallel():
            with ctx.tally.branch():
                b1 = CV.bit_extract(ctx, v_hi)
            with ctx.tally.branch():
                b2 = CV.bit_extract(ctx, v_lo)
        a = BW.and_bshare(ctx, ~b1, b2, active_bits=1)   # (1^b1) AND b2
    with ctx.tally.parallel():
        with ctx.tally.branch():
            t = CV.bit_inject(ctx, a, v_hi)
        with ctx.tally.branch():
            d = CV.bit2a(ctx, ~b2)
    # bit2a yields the *integer* bit; lift to fixed point (local shift)
    return t + d.mul_public(ring.scale)


def dsigmoid_bit(ctx: TridentContext, b1: BShare, b2: BShare) -> BShare:
    """Derivative indicator (1 on the linear segment)."""
    return BW.and_bshare(ctx, ~b1, b2, active_bits=1)


# ---------------------------------------------------------------------------
# Comparison / select / max.
# ---------------------------------------------------------------------------
def select(ctx: TridentContext, b: BShare, x: AShare, y: AShare) -> AShare:
    """b ? x : y  =  y + b*(x - y)."""
    return y + CV.bit_inject(ctx, b, x - y)


def maximum(ctx: TridentContext, x: AShare, y: AShare) -> AShare:
    ge = ~CV.bit_extract(ctx, x - y)     # 1 iff x >= y
    return select(ctx, ge, x, y)


def argmax_tournament(ctx: TridentContext, x: AShare) -> AShare:
    """Secure max over the last axis by tournament; returns max values.
    log2(n) comparison rounds (used by secure top-k routing)."""
    n = x.shape[-1]
    cur = x
    while n > 1:
        half = n // 2
        m = maximum(ctx, cur[..., :half], cur[..., half:2 * half])
        if n % 2:
            m = AShare(torch.cat([m.data, cur[..., 2 * half:].data], dim=-1))
            n = half + 1
        else:
            n = half
        cur = m
    return cur


# ---------------------------------------------------------------------------
# Newton-Raphson reciprocal / rsqrt with in-protocol normalization.
# ---------------------------------------------------------------------------
def _leading_one_factors(ctx: TridentContext, x: AShare, table):
    """Boolean leading-one detection + one-hot arithmetization.

    Returns [[F]] = sum_k onehot_k * table[k] for bit positions in the
    window; positions outside the window contribute 0 (the window is set to
    cover the operating range).
    """
    ring = ctx.ring
    xb = CV.a2b(ctx, x)
    pf = BW.prefix_or(ctx, xb)
    onehot = pf ^ pf.shift_right(1)          # exactly the leading-one bit
    lo, hi = ctx.norm_window
    # stack the window's bit planes into one vectorized Bit2A
    planes = bit_planes(onehot.data, lo, hi, dim=1)   # (4, W, *shape)
    arith = CV.bit2a(ctx, BShare(planes, 1))  # (W, *shape) arithmetic shares
    coeff = torch.stack([table(k) for k in range(lo, hi)])
    coeff = coeff.reshape((hi - lo,) + (1,) * len(x.shape))
    weighted = arith.mul_public(coeff)
    return AShare(torch.sum(weighted.data, dim=1, dtype=ring.dtype))


def reciprocal(ctx: TridentContext, x: AShare, iters: int = 3) -> AShare:
    """[[1/x]] for x > 0 (fixed point), Newton-Raphson after normalizing
    x to [0.5, 1) via the leading-one factor F = 2^{f-k-1}."""
    ring = ctx.ring
    F = _leading_one_factors(
        ctx, x, lambda k: ctx.encode(2.0 ** (ring.frac - k - 1)))
    xn = PR.mult_tr(ctx, x, F)               # normalized to [0.5, 1)
    # y0 = 2.9142 - 2 xn  (classic initial guess, |err| < 0.09)
    y = (-(xn + xn)) + ctx.encode(2.9142)
    two = ctx.encode(2.0)
    for _ in range(iters):
        t = PR.mult_tr(ctx, xn, y)
        y = PR.mult_tr(ctx, y, (-t) + two)
    return PR.mult_tr(ctx, y, F)             # 1/x = y_n * F


def rsqrt(ctx: TridentContext, x: AShare, iters: int = 3) -> AShare:
    """[[x^{-1/2}]] for x > 0: normalization factor G = 2^{-(k-f+1)/2} is a
    public per-position table, then NR: y <- y (3 - xn y^2) / 2."""
    ring = ctx.ring
    F = _leading_one_factors(
        ctx, x, lambda k: ctx.encode(2.0 ** (ring.frac - k - 1)))
    G = _leading_one_factors(
        ctx, x, lambda k: ctx.encode(2.0 ** (-(k - ring.frac + 1) / 2.0)))
    xn = PR.mult_tr(ctx, x, F)               # in [0.5, 1)
    y = (-PR.scale_public(ctx, xn, 1.2)) + ctx.encode(2.213)
    three = ctx.encode(3.0)
    for _ in range(iters):
        y2 = PR.mult_tr(ctx, y, y)
        t = PR.mult_tr(ctx, xn, y2)
        y = PR.mult_tr(ctx, y, (-t) + three)
        y = PR.scale_public(ctx, y, 0.5)
    # rsqrt(x) = y * sqrt(F) ... folded into the G table: y * G
    return PR.mult_tr(ctx, y, G)


# ---------------------------------------------------------------------------
# Softmax (paper Section VI-A: smx = relu / sum(relu); SecureML variant).
# ---------------------------------------------------------------------------
def smx_softmax(ctx: TridentContext, u: AShare, axis: int = -1,
                division: str = "newton") -> AShare:
    """MPC-friendly softmax.  division = "garbled" follows the paper's NN
    benchmarks (division circuit in the garbled world); "newton" stays in
    the arithmetic world (beyond-paper)."""
    ring = ctx.ring
    r = relu(ctx, u)
    dim = axis if axis < 0 else axis + 1
    s_data = torch.sum(r.data, dim=dim, keepdim=True, dtype=ring.dtype)
    # eps keeps the denominator strictly positive (all-negative rows)
    s = AShare(s_data) + ctx.encode(1e-2)
    if division == "garbled":
        return GW.garbled_div(ctx, r, AShare(s.data.broadcast_to(
            r.data.shape)))
    inv = reciprocal(ctx, s)
    return PR.mult_tr(ctx, r, AShare(inv.data.broadcast_to(r.data.shape)))
