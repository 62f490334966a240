"""Shared protocol description (``repro/core/algebra.py``): the routing
tables and per-component formulas of the Trident protocols, restated here
so the port needs nothing of the JAX package.

Index conventions: parties 0..3; lambda components 1..3 (P_i misses
lambda_i; P0 misses m and knows every lambda).  ``op`` is the bilinear map
of the protocol instance: elementwise product for Pi_Mult, a contraction
for Pi_MatMul.
"""
from __future__ import annotations

import math

import torch

PARTIES = (0, 1, 2, 3)

# Guarded r sampling for truncation pairs: each r_j is uniform over
# [0, 2^{ell-TRUNC_GUARD}), so r = r1+r2+r3 < 2^{ell-2} and the opened z - r
# cannot wrap for |z| < 2^{ell-2} (the JAX package's core.protocols value).
TRUNC_GUARD = 4


def numel(shape) -> int:
    """Element count of a shape (1 for scalars)."""
    return int(math.prod(shape)) if shape else 1


def as_op(contract):
    """Elementwise product unless a contraction is supplied."""
    return (lambda a, b: a * b) if contract is None else contract


def matmul_shape(x_shape, y_shape) -> tuple:
    """Output shape of ``torch.matmul`` on the given operand shapes,
    worked out on the meta device (no data, no compute)."""
    a = torch.empty(tuple(x_shape), device="meta")
    b = torch.empty(tuple(y_shape), device="meta")
    return tuple(torch.matmul(a, b).shape)


def lam_holders(j: int) -> tuple:
    """Parties holding lambda component j: everyone but P_j."""
    return tuple(p for p in PARTIES if p != j)


def online_holders(j: int) -> tuple:
    """Online parties (P1..P3) holding lambda component j."""
    return tuple(p for p in (1, 2, 3) if p != j)


# Pi_Mult gamma split (Fig. 4): piece j -> the (a, b) lambda-index pairs of
# its lam_x[a] op lam_y[b] terms (1-based).
GAMMA_TERMS = {
    1: ((1, 1), (1, 2), (2, 1)),
    2: ((2, 2), (2, 3), (3, 2)),
    3: ((3, 3), (3, 1), (1, 3)),
}

# Zero-share masks (Fig. 22): three PRF streams sampled by these subsets in
# this order; gamma piece j is masked with f_plus - f_minus.
ZERO_SUBSETS = ((0, 1, 3), (0, 1, 2), (0, 2, 3))
GAMMA_MASK_F = {1: (0, 2), 2: (1, 0), 3: (2, 1)}

# Gamma piece j is computed by P0 and GAMMA_LOCAL[j]; P0 sends it to
# GAMMA_RECV[j].  Online part j is held by PART_HOLDERS[j] = (value sender,
# hash sender) and sent to PART_RECV[j] = P_j, the one online party
# missing lambda_j.
GAMMA_LOCAL = {1: 3, 2: 1, 3: 2}
GAMMA_RECV = {1: 2, 2: 3, 3: 1}
PART_HOLDERS = {1: (3, 2), 2: (1, 3), 3: (2, 1)}
PART_RECV = {1: 1, 2: 2, 3: 3}


def bit_masks(ell: int, level: int) -> tuple:
    """(boundary_mask, upper_mask) of Sklansky adder level `level`: the top
    bit of each lower half-block, and every bit of the upper half-blocks."""
    half = 1 << level
    block = half * 2
    boundary = 0
    upper = 0
    for pos in range(ell):
        if pos % block == half - 1:
            boundary |= 1 << pos
        if pos % block >= half:
            upper |= 1 << pos
    return boundary, upper


# Pi_Rec (Fig. 3): component c -> (value sender, hash sender); receiver c.
REC_ROUTE = {0: (1, 2), 1: (2, 3), 2: (3, 1), 3: (1, 2)}

# Pi_aSh (Fig. 2): v1/v2 from these PRF subsets; piece i held by P0 and
# ASH_HOLDERS[i].
ASH_SUBSETS = ((0, 2, 3), (0, 1, 3))
ASH_HOLDERS = {1: (2, 3), 2: (1, 3), 3: (1, 2)}

# B2A (Fig. 16): (aSh piece, include the public bits q, vSh owners).
B2A_VALS = ((2, True, (1, 3)), (3, False, (2, 1)), (1, False, (3, 2)))


def gamma_piece(op, j: int, lam_x, lam_y, mask=None):
    """Gamma piece j from 1-indexed component mappings lam_x / lam_y."""
    acc = None
    for a, b in GAMMA_TERMS[j]:
        t = op(lam_x[a], lam_y[b])
        acc = t if acc is None else acc + t
    return acc if mask is None else acc + mask


def mult_online_part(op, lam_x_j, lam_y_j, m_x, m_y, gamma_j, lam_z_j):
    """Online summand j of m_z': -lam_x_j m_y - m_x lam_y_j + gamma_j +
    lam_z_j (Pi_MultTr passes lam_z_j = -r_j)."""
    return -op(lam_x_j, m_y) - op(m_x, lam_y_j) + gamma_j + lam_z_j


def b2a_val(q, p, pow2, include_q: bool, dtype):
    """One B2A composition value: sum_i 2^i (q_i [if include_q] + p_i
    - 2 q_i p_i), leading axis = bit index."""
    term = p - 2 * q * p
    if include_q:
        term = term + q
    return torch.sum(pow2 * term, dim=0, dtype=dtype)


def trunc_check_send(r_2, r_3, v_2, v_3, frac: int):
    return (r_2 + r_3) - ((v_2 + v_3) << frac)


def trunc_check_verify(a1, r_1, v_1, frac: int):
    """True iff the truncation-pair residue lies in [0, 2^f) as an unsigned
    ring word: its bits above frac are all zero."""
    resid = a1 + r_1 - (v_1 << frac)
    return torch.all((resid >> frac) == 0)


class CheckLedger:
    """Collects recompute-and-compare outcomes as device booleans; they are
    folded into one flag only by ``abort_flag()``, so recording a check
    never waits for the device."""

    def __init__(self):
        self.checks: list = []

    def check_equal(self, a, b, tag: str = "") -> None:
        self.checks.append(torch.all(a == b))

    def record(self, ok, tag: str = "") -> None:
        """Record an already-evaluated predicate (e.g. a range check)."""
        self.checks.append(torch.all(ok))

    # --- loop bodies: a body's checks fold into one per iteration ---------
    def begin_body(self) -> int:
        return len(self.checks)

    def end_body(self, mark: int):
        """The checks since `mark` folded into one device boolean (None if
        there were none), taken off the list."""
        cs = self.checks[mark:]
        del self.checks[mark:]
        return torch.stack(cs).all() if cs else None

    def absorb(self, oks) -> None:
        """Record the iterations' folded checks as one."""
        oks = [ok for ok in oks if ok is not None]
        if oks:
            self.checks.append(torch.stack(oks).all())

    def abort_flag(self) -> bool:
        """False if every consistency check passed; True = abort."""
        return not all_ok(self.checks)


def all_ok(checks: list) -> bool:
    """AND of device-boolean checks, read back in one transfer."""
    return not checks or bool(torch.stack(checks).all())
