"""Trident 4PC protocols of the joint simulation (paper Sections III and
IV-B, Fig. 1-5, 9, 18; ``repro/core/protocols.py``).

Each protocol computes the union of the four parties' local work on stacked
(4, *shape) shares, moves "messages" as local dataflow, and tallies the real
inter-party communication (rounds/bits, offline vs online) analytically.

Per-element online costs (the paper's amortized lemmas; hashes are free):
    Pi_Sh      1 round, 3*ell bits          (Lemma B.1)
    Pi_aSh     offline: 1 round, 2*ell      (Lemma B.2)
    Pi_Rec     1 round, 4*ell               (Lemma B.3)
    Pi_Mult    offline 1 rnd 3*ell; online 1 rnd 3*ell   (Lemma B.4)
    Pi_DotP    same as Pi_Mult, *independent of vector length* (Lemma C.3)
    Pi_MultTr  offline 2 rnd 6*ell; online 1 rnd 3*ell   (Lemma D.2)

Kernel routes.  PyTorch has no integer matmul on CUDA, so every matmul
contraction (``_mm``: gamma pieces, online parts, m_x @ m_y) goes through
``kernels.ops.ring_matmul``: a 2-D product, or [..., M, K] @ (K, N), takes
the ring matmul kernel, and a product with batch dimensions on both sides
(attention, MoE experts) the batched one (kernel route K2).  In ``fused`` mode with ``collapse=True`` a 2-D secure matmul makes
ONE ``kernels.ops.mpc_matmul_fused`` call where the gamma term is formed,
which also yields m_x @ m_y and the online cross term.  The ``offline`` and
``online`` modes keep the plain path through the ring matmul.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..kernels import ops
from . import algebra as AL
from .algebra import PARTIES, TRUNC_GUARD, as_op
from .algebra import numel as _n
from .context import TridentContext
from .shares import AShare, stack_components


def _sum3(t: torch.Tensor) -> torch.Tensor:
    return t[0] + t[1] + t[2]


# ---------------------------------------------------------------------------
# Pi_Zero (Fig. 22): A + B + Gamma = 0, non-interactive.
# ---------------------------------------------------------------------------
def zero_shares(ctx: TridentContext, shape) -> torch.Tensor:
    """Returns stacked (3, *shape): A, B, Gamma with A+B+Gamma = 0, from
    the streams of ``algebra.ZERO_SUBSETS`` in that order."""
    f1, f2, f3 = ctx.sample_group([(s, shape) for s in AL.ZERO_SUBSETS])
    return torch.stack([f2 - f1, f3 - f2, f1 - f3])


# ---------------------------------------------------------------------------
# Pi_Sh (Fig. 1): [[.]]-sharing of v by owner P_i.
# ---------------------------------------------------------------------------
def share(ctx: TridentContext, v, owner: int = 0) -> AShare:
    ring = ctx.ring
    v = ctx.words(v)
    # lambda_{v,j} is sampled by P \ {P_j}, except the owner's own index
    # which all parties sample together with k_P (Fig. 1).
    lam = torch.stack(ctx.sample_group(
        [(PARTIES if owner == j else AL.lam_holders(j), v.shape)
         for j in (1, 2, 3)]))
    m = v + lam[0] + lam[1] + lam[2]
    ctx.tally.add("Pi_Sh", "online", rounds=1, bits=3 * ring.ell * _n(v.shape))
    return AShare(stack_components(m, lam))


# ---------------------------------------------------------------------------
# Pi_aSh (Fig. 2): <.>-sharing of a value known to P0, in the offline phase.
# ---------------------------------------------------------------------------
def ash_by_p0(ctx: TridentContext, v) -> torch.Tensor:
    """Returns stacked (3, *shape) additive shares v1+v2+v3 = v."""
    ring = ctx.ring
    v = ctx.words(v)
    v1, v2 = ctx.sample_group([(s, v.shape) for s in AL.ASH_SUBSETS])
    v3 = v - v1 - v2                       # P0 sends to P1, P2
    ctx.tally.add("Pi_aSh", "offline", rounds=1,
                  bits=2 * ring.ell * _n(v.shape))
    if ctx.malicious_checks:
        # P1 and P2 exchange H(v3): both copies are the same wire here
        ctx.check_equal(v3, v3, "aSh.v3")
    return torch.stack([v1, v2, v3])


# ---------------------------------------------------------------------------
# Pi_Rec (Fig. 3) / Pi_fRec (Fig. 5): reconstruction.
# ---------------------------------------------------------------------------
def reconstruct(ctx: TridentContext, x: AShare,
                receivers: Sequence[int] = PARTIES, fair: bool = False
                ) -> torch.Tensor:
    ring = ctx.ring
    n = _n(x.shape)
    if fair:
        ctx.tally.add("Pi_fRec", "online", rounds=4, bits=8 * ring.ell * n)
    else:
        ctx.tally.add("Pi_Rec", "online", rounds=1,
                      bits=ring.ell * n * len(receivers))
    return x.reveal()


# ---------------------------------------------------------------------------
# Pi_Mult (Fig. 4) -- elementwise multiplication.
# ---------------------------------------------------------------------------
def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``matmul`` of ring words (``jnp.matmul``'s shapes) by the ring
    matmul kernels: 2-D or batched (their plain versions on the CPU)."""
    return ops.ring_matmul(a, b)


def _fused_matmul(ctx: TridentContext, x: AShare, y: AShare,
                  contract) -> bool:
    """Does this secure product take the ``mpc_matmul_fused`` route?"""
    return (ctx.collapse and ctx.mode == "fused" and contract is _mm
            and x.ndim == 2 and y.ndim == 2)


def _gamma_offline(ctx: TridentContext, lx: torch.Tensor, ly: torch.Tensor,
                   contract=None) -> torch.Tensor:
    """gamma_xy = lambda_x * lambda_y, <.>-shared per Fig. 4's split.

    lx, ly: (3, *shape) lambda stacks.  `contract`: None for elementwise, or
    the contraction (e.g. ``_mm``) -- Pi_DotP sums gamma terms *before* the
    exchange, which is why its comm is length-free.  Returns (3, *out_shape)
    with components summing to <lam_x . lam_y>.
    """
    op = as_op(contract)
    if ctx.collapse:
        # component-collapsed: only gamma_total = lam_x_sum . lam_y_sum
        g = op(_sum3(lx), _sum3(ly))
        z = torch.zeros_like(g)
        return torch.stack([g, z, z])
    # Faithful split (algebra.GAMMA_TERMS): piece j collects the
    # lambda-index pairs one online party can compute locally.
    lam_x = {j: lx[j - 1] for j in (1, 2, 3)}
    lam_y = {j: ly[j - 1] for j in (1, 2, 3)}
    pieces = {j: AL.gamma_piece(op, j, lam_x, lam_y) for j in (1, 2, 3)}
    fs = ctx.sample_group([(s, pieces[1].shape) for s in AL.ZERO_SUBSETS])
    return torch.stack([pieces[j] + fs[a] - fs[b]
                        for j, (a, b) in sorted(AL.GAMMA_MASK_F.items())])


def _fused_gamma(x: AShare, y: AShare) -> tuple:
    """The collapsed gamma stack [g, 0, 0] and the online products
    (m_x @ m_y, cross) from one ``mpc_matmul_fused`` call (views of its
    one zeroed output)."""
    mm, cross, gamma = ops.mpc_matmul_fused(x.m, x.data[1:], y.m,
                                            y.data[1:])
    return gamma, (mm, cross)


def _mult_like(ctx: TridentContext, x: AShare, y: AShare, name: str,
               contract=None, out_shape=None) -> AShare:
    """Shared skeleton of Pi_Mult / Pi_DotP / Pi_MatMul."""
    ring = ctx.ring
    lx, ly = x.data[1:], y.data[1:]
    mx, my = x.m, y.m
    if out_shape is None:
        out_shape = tuple(torch.broadcast_shapes(x.shape, y.shape))
    n_out = _n(out_shape)
    fused = _fused_matmul(ctx, x, y, contract)

    # ---- offline ----------------------------------------------------------
    if ctx.mode in ("fused", "offline"):
        lam_z = torch.stack(ctx.sample_group(
            [(AL.lam_holders(j), out_shape) for j in (1, 2, 3)]))
        if fused:
            gamma, (mm, cross) = _fused_gamma(x, y)
        else:
            gamma = _gamma_offline(ctx, lx, ly, contract)
        ctx.offer({"lam_z": lam_z, "gamma": gamma})
    else:
        mat = ctx.get_material()
        lam_z, gamma = mat["lam_z"], mat["gamma"]
    ctx.tally.add(name, "offline", rounds=1, bits=3 * ring.ell * n_out)

    if ctx.mode == "offline":
        m = torch.zeros(out_shape, dtype=ring.dtype, device=ctx.device)
        return AShare(stack_components(m, lam_z))

    # ---- online -----------------------------------------------------------
    op = as_op(contract)
    if fused:
        mz_prime = -cross + _sum3(gamma) + _sum3(lam_z)
    elif ctx.collapse:
        mm = op(mx, my)
        mz_prime = -op(_sum3(lx), my) - op(mx, _sum3(ly)) + _sum3(gamma) \
            + _sum3(lam_z)
    else:
        mm = op(mx, my)
        parts = [
            AL.mult_online_part(op, lx[i], ly[i], mx, my, gamma[i], lam_z[i])
            for i in range(3)]
        if ctx.malicious_checks:
            ctx.check_equal(parts[0], parts[0], f"{name}.mz'")
        mz_prime = parts[0] + parts[1] + parts[2]
    m_z = mz_prime + mm
    ctx.tally.add(name, "online", rounds=1, bits=3 * ring.ell * n_out)
    return AShare(stack_components(m_z, lam_z))


def mult(ctx: TridentContext, x: AShare, y: AShare) -> AShare:
    """Pi_Mult (Fig. 4): elementwise product, no truncation."""
    return _mult_like(ctx, x, y, "Pi_Mult")


# ---------------------------------------------------------------------------
# Pi_DotP (Fig. 9) / matrix multiplication (torch.matmul semantics).
# ---------------------------------------------------------------------------
def _dot_last(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b, dim=-1, dtype=a.dtype)


def dotp(ctx: TridentContext, x: AShare, y: AShare) -> AShare:
    """Pi_DotP: dot product along the last axis; comm independent of d."""
    out_shape = tuple(torch.broadcast_shapes(x.shape, y.shape))[:-1]
    return _mult_like(ctx, x, y, "Pi_DotP", contract=_dot_last,
                      out_shape=out_shape)


def matmul(ctx: TridentContext, x: AShare, y: AShare) -> AShare:
    """Pi_MatMul = batched Pi_DotP: [[X]] @ [[Y]] with comm 3*ell per output
    element (paper Section VI-A: matrix ops decompose into dot products)."""
    return _mult_like(ctx, x, y, "Pi_DotP", contract=_mm,
                      out_shape=AL.matmul_shape(x.shape, y.shape))


# ---------------------------------------------------------------------------
# Pi_MultTr (Fig. 18): multiplication with free truncation.
# ---------------------------------------------------------------------------
#
# Guarded r sampling (algebra.TRUNC_GUARD): each r_j is uniform over
# [0, 2^{ell-TRUNC_GUARD}), so r = r1+r2+r3 < 2^{ell-2} and the opened
# z - r cannot wrap mod 2^ell whenever |z| < 2^{ell-2}.
#
def _trunc_pair(ctx: TridentContext, shape):
    """Offline (r, r^t): r = r1+r2+r3 sampled, P0 truncates and <.>-shares.
    The correctness check (Lemma D.1) ships one round later -- call
    ``_trunc_pair_check`` after the enclosing parallel-offline scope so the
    aSh overlaps the gamma exchange (Lemma D.2: 2 offline rounds total)."""
    ring = ctx.ring
    r_j = torch.stack(ctx.sample_group(
        [(AL.lam_holders(j), shape, ring.ell - TRUNC_GUARD)
         for j in (1, 2, 3)]))
    r_t = ring.truncate(_sum3(r_j))             # arithmetic shift (signed)
    rt_shares = ash_by_p0(ctx, r_t)             # 1 round, 2*ell (offline)
    return r_j, rt_shares


def _trunc_pair_check(ctx: TridentContext, r_j, rt_shares):
    """Fig. 18 check r = 2^d r^t + r_d: 1 offline round, ell bits (P1->P2)."""
    ring = ctx.ring
    if ctx.malicious_checks:
        r = _sum3(r_j)
        r_t = _sum3(rt_shares)
        lhs = r - (r_t << ring.frac) - ring.low_bits(r, ring.frac)
        ctx.check_equal(lhs, torch.zeros_like(lhs), "MultTr.rt")
    ctx.tally.add("TruncPair", "offline", rounds=1,
                  bits=ring.ell * _n(r_j.shape[1:]))


def mult_tr(ctx: TridentContext, x: AShare, y: AShare,
            contract=None, out_shape=None, name="Pi_MultTr") -> AShare:
    """Fig. 18 generalized over elementwise/dot/matmul contraction."""
    ring = ctx.ring
    lx, ly = x.data[1:], y.data[1:]
    mx, my = x.m, y.m
    if out_shape is None:
        out_shape = tuple(torch.broadcast_shapes(x.shape, y.shape))
    n_out = _n(out_shape)
    fused = _fused_matmul(ctx, x, y, contract)

    # ---- offline: Pi_Mult offline minus lam_z, plus the (r, r^t) pair -----
    # Round 1: gamma exchange || Pi_aSh(r^t); round 2: the Lemma D.1 check.
    if ctx.mode in ("fused", "offline"):
        with ctx.tally.parallel(("offline",)):
            if fused:
                gamma, (mm, cross) = _fused_gamma(x, y)
            else:
                gamma = _gamma_offline(ctx, lx, ly, contract)
            ctx.tally.add(name, "offline", rounds=1,
                          bits=3 * ring.ell * n_out)
            r_j, rt_shares = _trunc_pair(ctx, out_shape)
        _trunc_pair_check(ctx, r_j, rt_shares)
        ctx.offer({"gamma": gamma, "r_j": r_j, "rt": rt_shares})
    else:
        mat = ctx.get_material()
        gamma, r_j, rt_shares = mat["gamma"], mat["r_j"], mat["rt"]
        with ctx.tally.parallel(("offline",)):
            ctx.tally.add(name, "offline", rounds=1,
                          bits=3 * ring.ell * n_out)
            ctx.tally.add("Pi_aSh", "offline", rounds=1,
                          bits=2 * ring.ell * n_out)
        _trunc_pair_check(ctx, r_j, rt_shares)

    # Output lambda: [[r^t]] has m = 0 and <lam> = -<r^t> so that the share
    # evaluates to (z-r)^t + r^t (Fig. 18's sign typo corrected, as in the
    # JAX package).
    lam_out = -rt_shares
    if ctx.mode == "offline":
        m = torch.zeros(out_shape, dtype=ring.dtype, device=ctx.device)
        return AShare(stack_components(m, lam_out))

    # ---- online ------------------------------------------------------------
    op = as_op(contract)
    if fused:
        zp = -cross + _sum3(gamma) - _sum3(r_j)
    elif ctx.collapse:
        mm = op(mx, my)
        zp = -op(_sum3(lx), my) - op(mx, _sum3(ly)) + _sum3(gamma) \
            - _sum3(r_j)
    else:
        mm = op(mx, my)
        parts = [
            AL.mult_online_part(op, lx[i], ly[i], mx, my, gamma[i], -r_j[i])
            for i in range(3)]
        zp = parts[0] + parts[1] + parts[2]
    z_minus_r = zp + mm                          # opened: z - r
    zt_public = ring.truncate(z_minus_r)         # (z - r)^t, public to P1..P3
    # Pi_vSh(P1,P2,P3, (z-r)^t): non-interactive, lambda = 0; add [[r^t]].
    ctx.tally.add(name, "online", rounds=1, bits=3 * ring.ell * n_out)
    return AShare(stack_components(zt_public, lam_out))


def matmul_tr(ctx: TridentContext, x: AShare, y: AShare) -> AShare:
    """[[X]] @ [[Y]] with fused truncation (the PPML workhorse)."""
    return mult_tr(ctx, x, y, contract=_mm,
                   out_shape=AL.matmul_shape(x.shape, y.shape),
                   name="Pi_MatMulTr")


def truncate_share(ctx: TridentContext, x: AShare) -> AShare:
    """Standalone truncation of [[x]] (x known to have 2f fractional bits):
    the Fig. 18 machinery with the multiply already done."""
    ring = ctx.ring
    out_shape = x.shape
    if ctx.mode in ("fused", "offline"):
        r_j, rt_shares = _trunc_pair(ctx, out_shape)
        _trunc_pair_check(ctx, r_j, rt_shares)
        ctx.offer({"r_j": r_j, "rt": rt_shares})
    else:
        mat = ctx.get_material()
        r_j, rt_shares = mat["r_j"], mat["rt"]
        ctx.tally.add("Pi_aSh", "offline", rounds=1,
                      bits=2 * ring.ell * _n(out_shape))
        _trunc_pair_check(ctx, r_j, rt_shares)
    if ctx.mode == "offline":
        m = torch.zeros(out_shape, dtype=ring.dtype, device=ctx.device)
        return AShare(stack_components(m, -rt_shares))
    # online: open z - r (z's m minus lambda contributions minus r shares)
    z_minus_r = x.m - (x.data[1] + r_j[0]) - (x.data[2] + r_j[1]) \
        - (x.data[3] + r_j[2])
    zt = ring.truncate(z_minus_r)
    ctx.tally.add("Pi_Trunc", "online", rounds=1,
                  bits=3 * ring.ell * _n(out_shape))
    return AShare(stack_components(zt, -rt_shares))


# ---------------------------------------------------------------------------
# Public-constant ops that need truncation (fixed-point aware helpers).
# ---------------------------------------------------------------------------
def scale_public(ctx: TridentContext, x: AShare, c: float) -> AShare:
    """[[x]] * c for a public real constant: local mul + one truncation."""
    return truncate_share(ctx, x.mul_public(ctx.encode(c)))
