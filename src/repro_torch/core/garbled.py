"""Garbled world of the joint simulation: faithful cost accounting plus
value-level emulation (``repro/core/garbled.py``).

The paper uses the 4PC-adapted MRZ garbling scheme (P1,P2,P3 garble, P0
evaluates; free-XOR, half-gates, fixed-key AES), and enters the garbled
world only for division (softmax) and as conversion endpoints.  It is
modeled at two levels:

  * cost: every protocol tallies the paper's exact rounds/bits (Table IX),
    including the kappa factors;
  * value: the garbled evaluation computes the same function the circuit
    would, on the joint-simulation wire values (float64, the JAX package's
    operations in its order), and the result re-enters the arithmetic
    world as a fresh [[.]]-share (exactly what Pi_G2A produces).

kappa = 128 (computational security parameter, as in the paper).
"""
from __future__ import annotations

import torch

from .algebra import PARTIES, lam_holders
from .algebra import numel as _n
from .context import TridentContext
from .shares import AShare, stack_components

KAPPA = 128


# Garbled-circuit size estimates (ANDs) for the ell-bit primitives used.
def sub_circuit_ands(ell: int) -> int:          # ripple-borrow subtractor
    return ell


def add_circuit_ands(ell: int) -> int:
    return ell


def div_circuit_ands(ell: int) -> int:
    # Long division: ell iterations of subtract-compare-select ~ 2*ell ANDs.
    return 2 * ell * ell


def rsqrt_circuit_ands(ell: int) -> int:
    # normalization + 3 Newton iterations: ~3 multiplier circuits of
    # ell^2 ANDs each plus shifts => ~4*ell^2.
    return 4 * ell * ell


def recip_circuit_ands(ell: int) -> int:
    return 3 * ell * ell


def _fresh_ashare(ctx: TridentContext, value: torch.Tensor) -> AShare:
    """Re-share a value produced by a garbled evaluation as [[.]]: the
    Pi_vSh(P3, P0, .) step of Figs. 10/11."""
    lam = torch.stack(ctx.sample_group(
        [(PARTIES if j in (0, 3) else lam_holders(j), value.shape)
         for j in (1, 2, 3)]))
    m = value.to(ctx.ring.dtype) + lam[0] + lam[1] + lam[2]
    return AShare(stack_components(m, lam))


def _wire_values(ctx: TridentContext, x: AShare) -> torch.Tensor:
    """The signed fixed-point wire values as float64 (not yet descaled)."""
    return x.reveal().to(torch.float64)


# ---------------------------------------------------------------------------
# Conversion endpoints -- cost per Table IX ("This" rows).
# ---------------------------------------------------------------------------
def a2g_cost(ctx: TridentContext, shape) -> None:
    ell = ctx.ring.ell
    n = _n(shape)
    ctx.tally.add("A2G", "offline", rounds=1,
                  bits=(ell * KAPPA + 2 * KAPPA * sub_circuit_ands(ell)) * n)
    ctx.tally.add("A2G", "online", rounds=1, bits=ell * KAPPA * n)


def g2a_cost(ctx: TridentContext, shape) -> None:
    ell = ctx.ring.ell
    n = _n(shape)
    ctx.tally.add("G2A", "offline", rounds=1,
                  bits=(ell * KAPPA + ell
                        + 2 * KAPPA * sub_circuit_ands(ell)) * n)
    ctx.tally.add("G2A", "online", rounds=1, bits=3 * ell * n)


def b2g_cost(ctx: TridentContext, shape, nbits: int) -> None:
    n = _n(shape) * nbits
    ctx.tally.add("B2G", "offline", rounds=1, bits=KAPPA * n)
    ctx.tally.add("B2G", "online", rounds=1, bits=KAPPA * n)


def g2b_cost(ctx: TridentContext, shape, nbits: int) -> None:
    n = _n(shape) * nbits
    ctx.tally.add("G2B", "offline", rounds=1, bits=(KAPPA + 1) * n)
    ctx.tally.add("G2B", "online", rounds=1, bits=3 * n)


def garbled_eval_cost(ctx: TridentContext, shape, n_ands: int) -> None:
    """P1 ships the garbled tables (2*kappa bits per AND, half-gates) to P0
    in the offline phase; online evaluation is local to P0."""
    ctx.tally.add("GC.tables", "offline", rounds=1,
                  bits=2 * KAPPA * n_ands * _n(shape))


# ---------------------------------------------------------------------------
# Garbled division (paper Section VI-A: the smx softmax denominator).
# ---------------------------------------------------------------------------
def garbled_div(ctx: TridentContext, num: AShare, den: AShare) -> AShare:
    """[[num / den]] (fixed point) via the garbled world, as the paper's NN
    benchmarks do: A2G both operands, evaluate a division circuit, G2A
    back."""
    ring = ctx.ring
    shape = tuple(torch.broadcast_shapes(num.shape, den.shape))
    a2g_cost(ctx, shape)
    a2g_cost(ctx, shape)
    garbled_eval_cost(ctx, shape, div_circuit_ands(ring.ell))
    g2a_cost(ctx, shape)
    # Value-level emulation of the division circuit on the wire values:
    n = _wire_values(ctx, num)
    d = _wire_values(ctx, den)
    safe = torch.where(d == 0, 1.0, d)
    q = torch.where(d == 0, torch.zeros_like(n),
                    torch.round(n * ring.scale / safe))
    return _fresh_ashare(ctx, q.to(ring.dtype))


def _garbled_unary(ctx: TridentContext, x: AShare, n_ands: int,
                   fn) -> AShare:
    """Shared skeleton: A2G -> garbled circuit -> G2A, per Figs. 11/13.
    Cost per element is tallied with the Table IX formulas; the circuit's
    value is emulated on the joint-simulation wire values."""
    ring = ctx.ring
    shape = x.shape
    a2g_cost(ctx, shape)
    garbled_eval_cost(ctx, shape, n_ands)
    g2a_cost(ctx, shape)
    v = _wire_values(ctx, x) / ring.scale
    y = torch.round(fn(v) * ring.scale).to(ring.dtype)
    return _fresh_ashare(ctx, y)


def garbled_rsqrt(ctx: TridentContext, x: AShare) -> AShare:
    """[[x^{-1/2}]] via the garbled world (the paper's route for division-
    like ops, Section VI-A); clamped at tiny positives like the NR
    variant."""
    tiny = 2.0 ** -ctx.ring.frac
    return _garbled_unary(
        ctx, x, rsqrt_circuit_ands(ctx.ring.ell),
        lambda v: torch.where(v <= 0, 0.0,
                              1.0 / torch.sqrt(torch.clamp_min(v, tiny))))


def garbled_reciprocal(ctx: TridentContext, x: AShare) -> AShare:
    tiny = 2.0 ** -ctx.ring.frac
    return _garbled_unary(
        ctx, x, recip_circuit_ands(ctx.ring.ell),
        lambda v: torch.where(v.abs() < tiny, 0.0,
                              1.0 / torch.where(v == 0, 1.0, v)))
