"""ML activations over party-sliced shares
(``repro/runtime/activations.py``): ReLU, the piecewise-linear sigmoid,
the Newton-Raphson reciprocal and rsqrt with in-protocol normalization,
and the smx softmax, composed from the ported conversions in the JAX package's
sampling order and round-overlap structure.
"""
from __future__ import annotations

import torch

from ..core.ring import bit_planes
from ..obs import traced_protocol
from . import boolean as RB
from . import conversions as CV
from . import protocols as RT
from .party import DistAShare, DistBShare, PartyBView, map_components
from .runtime import FourPartyRuntime


@traced_protocol("relu")
def relu(rt: FourPartyRuntime, v: DistAShare, return_bit: bool = False):
    """relu(v) = (1 xor b) * v with b = msb(v)."""
    b = CV.bit_extract(rt, v)
    nb = b.invert()
    out = CV.bit_inject(rt, nb, v)
    return (out, nb) if return_bit else out


def drelu_from_bit(rt: FourPartyRuntime, nb: DistBShare) -> DistAShare:
    """drelu = (1 xor b) as an arithmetic share (for backprop)."""
    return CV.bit2a(rt, nb)


def mul_by_cached_bit(rt: FourPartyRuntime, nb: DistBShare,
                      v: DistAShare) -> DistAShare:
    """dY * drelu using the bit cached by the forward pass (one BitInj)."""
    return CV.bit_inject(rt, nb, v)


@traced_protocol("sigmoid")
def sigmoid(rt: FourPartyRuntime, v: DistAShare, return_cache: bool = False):
    """sig(v) = (1^b1) b2 (v + 1/2) + (1^b2);
    b1 = [v + 1/2 < 0], b2 = [v - 1/2 < 0].

    ``return_cache`` also returns the segment bit (1^b1) b2, the
    derivative indicator ``RuntimeEngine``'s backward pass injects with;
    the protocol trace is the same either way."""
    ring = rt.ring
    tp = rt.transport
    half = rt.encode(0.5)
    v_hi = v.add_public(half)
    v_lo = v.add_public(-half)
    with tp.parallel(("offline",)):
        with tp.parallel():
            with tp.branch():
                b1 = CV.bit_extract(rt, v_hi)
            with tp.branch():
                b2 = CV.bit_extract(rt, v_lo)
        a = RB.and_bshare(rt, b1.invert(), b2, active_bits=1)
    with tp.parallel():
        with tp.branch():
            t = CV.bit_inject(rt, a, v_hi)
        with tp.branch():
            d = CV.bit2a(rt, b2.invert())
    y = t.add(d.mul_public(ring.scale))
    return (y, a) if return_cache else y


def _stack_bit_planes(v: DistBShare, lo: int, hi: int) -> DistBShare:
    """Bit planes [lo, hi) stacked on a new leading axis as one 1-bit
    share."""
    views = [PartyBView(None if pv.m is None else bit_planes(pv.m, lo, hi),
                        {j: bit_planes(lv, lo, hi)
                         for j, lv in pv.lam.items()}, 1)
             for pv in v.views]
    return DistBShare(tuple(views), (hi - lo,) + tuple(v.shape), v.dtype, 1)


def _leading_one_factors(rt: FourPartyRuntime, x: DistAShare, table
                         ) -> DistAShare:
    """Boolean leading-one detection + one-hot arithmetization:
    [[F]] = sum_k onehot_k * table(k) over the rt.norm_window positions."""
    ring = rt.ring
    xb = CV.a2b(rt, x)
    pf = RB.prefix_or(rt, xb)
    onehot = pf.xor(pf.shift_right(1))       # exactly the leading-one bit
    lo, hi = rt.norm_window
    arith = CV.bit2a(rt, _stack_bit_planes(onehot, lo, hi))
    coeff = torch.stack([table(k) for k in range(lo, hi)])
    coeff = coeff.reshape((hi - lo,) + (1,) * len(x.shape))
    return map_components(
        lambda a: torch.sum(a, dim=0, dtype=ring.dtype),
        arith.mul_public(coeff))


@traced_protocol("reciprocal")
def reciprocal(rt: FourPartyRuntime, x: DistAShare,
               iters: int = 3) -> DistAShare:
    """[[1/x]] for x > 0 (fixed point): Newton-Raphson after normalizing x
    to [0.5, 1) by the leading-one factor F = 2^{f-k-1}."""
    frac = rt.ring.frac
    F = _leading_one_factors(
        rt, x, lambda k: rt.encode(2.0 ** (frac - k - 1)))
    xn = RT.mult_tr(rt, x, F)                # normalized to [0.5, 1)
    # y0 = 2.9142 - 2 xn  (classic initial guess, |err| < 0.09)
    y = xn.add(xn).neg().add_public(rt.encode(2.9142))
    two = rt.encode(2.0)
    for _ in range(iters):
        t = RT.mult_tr(rt, xn, y)
        y = RT.mult_tr(rt, y, t.neg().add_public(two))
    return RT.mult_tr(rt, y, F)              # 1/x = y_n * F


@traced_protocol("rsqrt")
def rsqrt(rt: FourPartyRuntime, x: DistAShare, iters: int = 3) -> DistAShare:
    """[[x^{-1/2}]] for x > 0: the normalization factor G = 2^{-(k-f+1)/2}
    is a public per-position table, then NR: y <- y (3 - xn y^2) / 2."""
    frac = rt.ring.frac
    F = _leading_one_factors(
        rt, x, lambda k: rt.encode(2.0 ** (frac - k - 1)))
    G = _leading_one_factors(
        rt, x, lambda k: rt.encode(2.0 ** (-(k - frac + 1) / 2.0)))
    xn = RT.mult_tr(rt, x, F)                # in [0.5, 1)
    y = RT.scale_public(rt, xn, 1.2).neg().add_public(rt.encode(2.213))
    three = rt.encode(3.0)
    for _ in range(iters):
        y2 = RT.mult_tr(rt, y, y)
        t = RT.mult_tr(rt, xn, y2)
        y = RT.mult_tr(rt, y, t.neg().add_public(three))
        y = RT.scale_public(rt, y, 0.5)
    # rsqrt(x) = y * sqrt(F), folded into the G table: y * G
    return RT.mult_tr(rt, y, G)


@traced_protocol("softmax")
def smx_softmax(rt: FourPartyRuntime, u: DistAShare, axis: int = -1,
                mask=None, return_cache: bool = False):
    """MPC-friendly softmax smx = relu / (sum(relu) + 0.01); the
    denominator stays in the arithmetic world via the NR reciprocal.
    `mask`: a public 0/1 array applied to the relu before the sum.

    ``return_cache`` also returns the (p, inv, relu bit) triple
    ``RuntimeEngine``'s backward pass consumes; the relu bit is a
    byproduct, so the protocol trace is the same either way."""
    r, bit = relu(rt, u, return_bit=True)
    if mask is not None:
        r = r.mul_public(rt.words(mask))
    s = map_components(
        lambda a: torch.sum(a, dim=axis, keepdim=True, dtype=rt.ring.dtype),
        r)
    # eps keeps the denominator strictly positive (all-negative rows)
    inv = reciprocal(rt, s.add_public(rt.encode(1e-2)))
    inv_b = map_components(lambda a: a.expand(r.shape), inv)
    p = RT.mult_tr(rt, r, inv_b)
    return (p, (p, inv, bit)) if return_cache else p
