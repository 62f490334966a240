"""Mixed-world sharing conversions of the joint simulation (paper Section
IV-C, Figs. 10-17, 19; ``repro/core/conversions.py``).

A2B, B2A, Bit2A, BitInj and BitExt (both the faithful Fig. 19 variant with
its wraparound precondition, and the robust PPA variant).  The
garbled-world endpoints live in garbled.py (cost-modeled and
value-emulated).

Cost targets (the JAX package's tests/test_costs.py):
    A2B    offline 1 rnd,  3l log l + 2l   online 1+log l rnd, 3l log l + l
    Bit2A  offline 2 rnd,  3l + 1          online 1 rnd, 3l
    B2A    offline 2 rnd,  3l^2 + l        online 1 rnd, 3l
    BitInj offline 2 rnd,  6l + 1          online 1 rnd, 3l
    BitExt offline 1 rnd,  4l + 1          online 3 rnd, 5l + 2
"""
from __future__ import annotations

import torch

from . import algebra as AL
from . import boolean as BW
from . import protocols as PR
from .algebra import PARTIES
from .algebra import numel as _n
from .context import TridentContext
from .ring import lshr
from .shares import AShare, BShare, public_to_ashare, stack_components


# ---------------------------------------------------------------------------
# Pi_vSh (arithmetic, Fig. 7) -- verifiable sharing by two owners.
# ---------------------------------------------------------------------------
def vsh_arith(ctx: TridentContext, v, owners=(1, 2),
              phase: str = "online") -> AShare:
    ring = ctx.ring
    v = ctx.words(v)
    lam = torch.stack(ctx.sample_group(
        [(PARTIES if j in owners else AL.lam_holders(j), v.shape)
         for j in (1, 2, 3)]))
    m = v + lam[0] + lam[1] + lam[2]
    factor = 2 if 0 in owners else 1
    ctx.tally.add("Pi_vSh", phase, rounds=1,
                  bits=factor * ring.ell * _n(v.shape))
    return AShare(stack_components(m, lam))


# ---------------------------------------------------------------------------
# A2B (Fig. 14): v = x - y with x = m_v - lam_1 (P2,P3), y = lam_2+lam_3
# (P0,P1); boolean subtractor circuit.
# ---------------------------------------------------------------------------
def a2b(ctx: TridentContext, v: AShare) -> BShare:
    # All offline exchanges (vSh^B of y + every PPA AND's gamma) are
    # data-independent and ship in one round (Lemma C.8: offline R = 1).
    with ctx.tally.parallel(("offline",)):
        y = v.data[2] + v.data[3]                # lam_2 + lam_3 (offline)
        yb = BW.vsh_bool(ctx, y, owners=(0, 1), phase="offline")
        x = v.m - v.data[1]                      # m_v - lam_1 (online)
        xb = BW.vsh_bool(ctx, x, owners=(2, 3), phase="online")
        out = BW.ppa_sub(ctx, xb, yb)
    ctx.tally.add("A2B", "offline", rounds=0, bits=0)   # marker op
    return out


# ---------------------------------------------------------------------------
# Bit2A (Fig. 15): [[b]]^B (1 bit) -> [[b]]^A.
# ---------------------------------------------------------------------------
def bit2a(ctx: TridentContext, b: BShare) -> AShare:
    """b = m_b XOR lam_b = v + u - 2uv over the ring, where u = lam_b and
    v = m_b lifted to ring elements."""
    ring = ctx.ring
    assert b.nbits == 1
    lam_bit = (b.data[1] ^ b.data[2] ^ b.data[3]) & 1   # u as ring element
    m_bit = b.m & 1                                     # v (public to P1-3)

    if ctx.mode in ("fused", "offline"):
        u_sh = PR.ash_by_p0(ctx, lam_bit)        # offline 1 rnd, 2l
        # P1,P2,P3 verification of <u> (Fig. 15): l + 1 bits, 1 more round.
        if ctx.malicious_checks:
            ctx.check_equal(u_sh[0] + u_sh[1] + u_sh[2], lam_bit, "Bit2A.u")
        ctx.tally.add("Bit2A.check", "offline", rounds=1,
                      bits=(ring.ell + 1) * _n(b.shape))
        ctx.offer({"u_sh": u_sh})
    else:
        u_sh = ctx.get_material()["u_sh"]
        ctx.tally.add("Bit2A.check", "offline", rounds=1,
                      bits=(ring.ell + 1) * _n(b.shape))

    # <u> -> [[u]]: m_u = 0, <lam_u> = -<u>.
    u = AShare(stack_components(torch.zeros_like(m_bit), -u_sh))
    # online: [[v]] is the non-interactive public sharing; Pi_Mult with
    # lam_v = 0 => gamma = 0 (paper note), so offline mult cost is free.
    v_sh = public_to_ashare(m_bit, ring)
    uv = _mult_lam0(ctx, u, v_sh)
    return v_sh + u - (uv + uv)


def _mult_lam0(ctx: TridentContext, u: AShare, v_pub: AShare) -> AShare:
    """Pi_Mult specialization where lam_v = 0 (gamma vanishes): online-only
    1 round, 3l bits -- exactly Lemma C.9's accounting."""
    ring = ctx.ring
    out_shape = tuple(torch.broadcast_shapes(u.shape, v_pub.shape))
    if ctx.mode in ("fused", "offline"):
        lam_z = torch.stack(ctx.sample_group(
            [(AL.lam_holders(j), out_shape) for j in (1, 2, 3)]))
        ctx.offer({"lam_z": lam_z})
    else:
        lam_z = ctx.get_material()["lam_z"]
    if ctx.mode == "offline":
        m = torch.zeros(out_shape, dtype=ring.dtype, device=ctx.device)
        return AShare(stack_components(m, lam_z))
    mv = v_pub.m
    lu = u.data[1:]
    mz = u.m * mv - (lu[0] + lu[1] + lu[2]) * mv \
        + lam_z[0] + lam_z[1] + lam_z[2]
    ctx.tally.add("Pi_Mult", "online", rounds=1,
                  bits=3 * ring.ell * _n(out_shape))
    return AShare(stack_components(mz, lam_z))


# ---------------------------------------------------------------------------
# B2A (Fig. 16): constant-round bit composition.
# ---------------------------------------------------------------------------
def b2a(ctx: TridentContext, v: BShare) -> AShare:
    ring = ctx.ring
    ell = v.nbits
    shape = v.shape
    # lam bit-planes lifted to ring elements: p_i, i in [ell]
    lam_word = v.data[1] ^ v.data[2] ^ v.data[3]
    lam_bits = torch.stack([(lam_word >> i) & 1 for i in range(ell)])

    if ctx.mode in ("fused", "offline"):
        p_sh = PR.ash_by_p0(ctx, lam_bits)       # (3, ell, *shape)
        if ctx.malicious_checks:
            ctx.check_equal(p_sh[0] + p_sh[1] + p_sh[2], lam_bits, "B2A.p")
        ctx.tally.add("Bit2A.check", "offline", rounds=1,
                      bits=(ring.ell + 1) * ell * _n(shape))
        ctx.offer({"p_sh": p_sh})
    else:
        p_sh = ctx.get_material()["p_sh"]
        ctx.tally.add("Bit2A.check", "offline", rounds=1,
                      bits=(ring.ell + 1) * ell * _n(shape))

    # online: x,y,z from q_i (public bits of m) and the p shares; the
    # composition values and their vSh owner pairs are the shared
    # description (algebra.B2A_VALS).
    one = torch.ones((), dtype=ring.dtype, device=ctx.device)
    pow2 = one << torch.arange(ell, dtype=ring.dtype, device=ctx.device)
    pow2 = pow2.reshape((ell,) + (1,) * len(shape))
    q = torch.stack([(v.m >> i) & 1 for i in range(ell)])
    out = None
    with ctx.tally.parallel():
        for piece, include_q, owners in AL.B2A_VALS:
            val = AL.b2a_val(q, p_sh[piece - 1], pow2, include_q, ring.dtype)
            sh = vsh_arith(ctx, val, owners=owners)
            out = sh if out is None else out + sh
    return out


# ---------------------------------------------------------------------------
# BitInj (Fig. 17): [[b]]^B * [[v]]^A -> [[b v]]^A.
# ---------------------------------------------------------------------------
def bit_inject(ctx: TridentContext, b: BShare, v: AShare) -> AShare:
    ring = ctx.ring
    assert b.nbits == 1
    out_shape = tuple(torch.broadcast_shapes(b.shape, v.shape))
    lam_b = (b.data[1] ^ b.data[2] ^ b.data[3]) & 1
    lam_v = v.data[1] + v.data[2] + v.data[3]
    y1 = lam_b.broadcast_to(out_shape)
    y2 = (lam_b * lam_v).broadcast_to(out_shape)

    if ctx.mode in ("fused", "offline"):
        # y1/y2 aSh ship together (Lemma C.11: offline round 1 of 2)
        with ctx.tally.parallel(("offline",)):
            y1_sh = PR.ash_by_p0(ctx, y1)
            y2_sh = PR.ash_by_p0(ctx, y2)
        if ctx.malicious_checks:
            ctx.check_equal(y1_sh[0] + y1_sh[1] + y1_sh[2], y1, "BitInj.y1")
            ctx.check_equal(y2_sh[0] + y2_sh[1] + y2_sh[2], y2, "BitInj.y2")
        # checks: (l+1) for y1 (as Bit2A) + l for y2  (Lemma C.11)
        ctx.tally.add("BitInj.check", "offline", rounds=1,
                      bits=(2 * ring.ell + 1) * _n(out_shape))
        ctx.offer({"y1": y1_sh, "y2": y2_sh})
    else:
        mat = ctx.get_material()
        y1_sh, y2_sh = mat["y1"], mat["y2"]
        ctx.tally.add("BitInj.check", "offline", rounds=1,
                      bits=(2 * ring.ell + 1) * _n(out_shape))

    m_b = b.m & 1
    m_v = v.m
    x0 = m_b * m_v
    x1 = m_b
    x2 = m_v - 2 * m_v * m_b
    x3 = 2 * m_b - 1
    # Each c_k is vSh'd by an owner pair and combines only components BOTH
    # owners hold: aSh piece k and the lambda_v component the pair shares
    # ((1,3) hold lambda_2, (2,1) lambda_3, (3,2) lambda_1), the split the
    # party runtime executes.
    c2 = x0 - x1 * v.data[2] + x2 * y1_sh[1] + x3 * y2_sh[1]
    c3 = -x1 * v.data[3] + x2 * y1_sh[2] + x3 * y2_sh[2]
    c1 = -x1 * v.data[1] + x2 * y1_sh[0] + x3 * y2_sh[0]
    with ctx.tally.parallel():
        s2 = vsh_arith(ctx, c2, owners=(1, 3))
        s3 = vsh_arith(ctx, c3, owners=(2, 1))
        s1 = vsh_arith(ctx, c1, owners=(3, 2))
    return s1 + s2 + s3


# ---------------------------------------------------------------------------
# BitExt / secure comparison (Fig. 19 + robust PPA variant).
# ---------------------------------------------------------------------------
def bit_extract(ctx: TridentContext, v: AShare,
                method: str | None = None) -> BShare:
    """[[msb(v)]]^B.

    method "mul" (Fig. 19, paper-faithful): needs |r*v| < 2^{ell-1}; |r| is
    bounded by 2^{ell-1-guard}, so it is correct whenever |v| < 2^{guard}
    (ctx.bitext_guard).  3 online rounds, 5l+2 bits.
    method "ppa" (robust): msb via the boolean PPA on the two addends.
    """
    method = method or ctx.bitext_method
    if method == "ppa":
        y = -(v.data[2] + v.data[3])
        yb = BW.vsh_bool(ctx, y, owners=(0, 1), phase="offline")
        x = v.m - v.data[1]
        xb = BW.vsh_bool(ctx, x, owners=(2, 3), phase="online")
        return BW.msb_of_sum(ctx, xb, yb)
    with ctx.tally.parallel(("offline",)):
        return _bit_extract_mul_body(ctx, v)


def _bit_extract_mul_body(ctx: TridentContext, v: AShare) -> BShare:
    # offline exchanges (vSh of r, vSh^B of msb(r), Pi_Mult's gamma) are
    # data-independent: 1 offline round total (Lemma D.3).
    ring = ctx.ring
    shape = v.shape
    # offline: P1,P2 sample r (guard-bounded, odd -- nonzero), x = msb(r)
    if ctx.mode in ("fused", "offline"):
        mag, sign = ctx.sample_group(
            [((1, 2), shape, ring.ell - 1 - ctx.bitext_guard),
             ((1, 2), shape)])
        sign = lshr(sign, ring.ell - 1)
        r = torch.where(sign.bool(), -(mag | 1), mag | 1)
        x_bit = ring.msb(r)
        r_sh = vsh_arith(ctx, r, owners=(1, 2), phase="offline")
        x_sh = BW.vsh_bool(ctx, x_bit, owners=(1, 2), nbits=1,
                           phase="offline")
        ctx.offer({"r": r_sh.data, "x": x_sh.data})
    else:
        mat = ctx.get_material()
        r_sh, x_sh = AShare(mat["r"]), BShare(mat["x"], 1)
    # online: [[rv]] = Pi_Mult, open towards P0 & P3, y = msb(rv)
    # (in offline mode the m-flow is garbage but the lambda/material flow and
    # PRF counter order are identical to the online run -- by design).
    rv = PR.mult(ctx, r_sh, v)
    rv_val = PR.reconstruct(ctx, rv, receivers=(0, 3))
    y_bit = ring.msb(rv_val)
    y_sh = BW.vsh_bool(ctx, y_bit, owners=(3, 0), nbits=1)
    return x_sh ^ y_sh


def less_than_zero(ctx: TridentContext, v: AShare, **kw) -> BShare:
    """[[v < 0]]^B -- the secure comparison primitive."""
    return bit_extract(ctx, v, **kw)
