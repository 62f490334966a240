"""Party-local mixed-world conversions (``repro/runtime/conversions.py``):
A2B, Bit2A, BitInj and BitExt with the JAX package's counter order and
algebra.

Checks, all verified on *received* bytes so a tampered wire flips the
receiving party's ledger:

  * Bit2A / B2A <u>-verification (Fig. 15/16): P3 sends v1+v2, P2 sends
    the lambda_1 bits; P1 completes both sides and compares;
  * BitInj verifies <y1> the same way, and <y2> by P1 aggregating v2+v3
    towards P0, who alone holds lambda_b * lambda_v;
  * BitExt inherits Pi_Mult's and Pi_Rec's jmp hash checks.

All conversion masks (<u>, <p>, y1/y2, BitExt's (r, msb(r)) pair) are prep
material: built and verified at deal time, drawn from the PrepStore by the
online-only run (see protocols.py's module docstring for the seam).
"""
from __future__ import annotations

import torch

from ..core.algebra import PARTIES, lam_holders
from ..core.ring import lshr
from ..obs import traced_protocol
from . import boolean as RB
from .party import DistAShare, DistBShare, PartyAView
from .protocols import (_ash_pieces, _ash_specs, _held_lam, _open_parts,
                        _vsh, reconstruct)
from .protocols import mult as rt_mult
from .runtime import FourPartyRuntime


def _public_to_dist(rt: FourPartyRuntime, vals: dict, shape) -> DistAShare:
    """Non-interactive sharing of a value all online parties know:
    lambda = 0, m = value (``vals[i]`` is P_i's local copy)."""
    ring = rt.ring
    zero = torch.zeros(shape, dtype=ring.dtype, device=rt.device)
    views = [PartyAView(None, {1: zero, 2: zero, 3: zero})]
    for i in (1, 2, 3):
        views.append(PartyAView(vals[i],
                                {j: zero for j in (1, 2, 3) if j != i}))
    return DistAShare(tuple(views), tuple(shape), ring.dtype)


def _parts_to_neg_lam(rt: FourPartyRuntime, parts: list, shape,
                      key: str = "p") -> DistAShare:
    """<u> -> [[u]]: m = 0, lambda_j = -u_j (aSh piece j's holders are
    exactly lambda_j's online holders).  In deal mode m stays None."""
    ring = rt.ring
    zero = None if rt.prep.skip_online else torch.zeros(
        shape, dtype=ring.dtype, device=rt.device)
    views = [PartyAView(None, {j: -parts[0][key][j] for j in (1, 2, 3)})]
    for i in (1, 2, 3):
        views.append(PartyAView(zero, {j: -parts[i][key][j]
                                       for j in parts[i][key]}))
    return DistAShare(tuple(views), tuple(shape), ring.dtype)


# ---------------------------------------------------------------------------
# A2B (Fig. 14): v = x - y, boolean subtractor circuit.
# ---------------------------------------------------------------------------
@traced_protocol("a2b")
def a2b(rt: FourPartyRuntime, v: DistAShare) -> DistBShare:
    tp = rt.transport
    tag = rt.next_tag("a2b")
    with tp.parallel(("offline",)):
        # y = lam_2 + lam_3 (P0, P1): data-independent, an offline vSh;
        # x = m_v - lam_1 (P2, P3): data-dependent, exchanged online.
        yb = RB.vsh_bool(rt, lambda p: v.views[p].lam[2] + v.views[p].lam[3],
                         (0, 1), v.shape, tag=tag + ".y", phase="offline")
        xb = RB.vsh_bool(rt, lambda p: v.views[p].m - v.views[p].lam[1],
                         (2, 3), v.shape, tag=tag + ".x")
        out = RB.ppa_sub(rt, xb, yb)
    return out


# ---------------------------------------------------------------------------
# Bit2A (Fig. 15): [[b]]^B (1 bit) -> [[b]]^A.
# ---------------------------------------------------------------------------
def _u_check(rt: FourPartyRuntime, b: DistBShare, pieces: list, *,
             tag: str) -> None:
    """Fig. 15 verification of <u> = <lambda_b>: P3 aggregates v1+v2 to P1
    (ell bits), P2 ships the lambda_1 bit (1 bit); P1 recomposes lambda_b
    and compares.  One offline round, (ell + 1) bits per element."""
    ring = rt.ring
    tp = rt.transport
    agg = pieces[3][1] + pieces[3][2]
    l1_bit = b.views[2].lam[1] & 1
    with tp.round("offline"):
        tp.send(3, 1, agg, tag=tag + ".ck", nbits=ring.ell, phase="offline")
        tp.send(2, 1, l1_bit, tag=tag + ".l1", nbits=1, phase="offline")
        got_agg = tp.recv(1, 3, tag=tag + ".ck")
        got_l1 = tp.recv(1, 2, tag=tag + ".l1")
    if rt.malicious_checks:
        s = got_agg + pieces[1][3]
        lam_b = got_l1 ^ ((b.views[1].lam[2] ^ b.views[1].lam[3]) & 1)
        rt.parties[1].check_equal(s, lam_b, tag + ".ck")


def _mult_lam0(rt: FourPartyRuntime, u: DistAShare, m_pub, out_shape, *,
               tag: str) -> DistAShare:
    """Pi_Mult for a public right operand (lam_v = 0, gamma vanishes):
    online-only, 1 round, 3*ell bits.  The output mask is the only prep."""
    ring = rt.ring

    def build():
        lam_z = dict(zip((1, 2, 3), rt.sample_group(
            [(lam_holders(j), out_shape) for j in (1, 2, 3)])))
        return [{"lam_z": _held_lam(lam_z, i)} for i in PARTIES]

    parts = rt.prep.acquire(tag + ".lz", "mult_lam0", build)
    if rt.prep.skip_online:
        views = [PartyAView(None, dict(parts[i]["lam_z"]))
                 for i in PARTIES]
        return DistAShare(tuple(views), tuple(out_shape), ring.dtype)

    def parts_of(party: int, j: int):
        return -(u.views[party].lam[j] * m_pub[party]) \
            + parts[party]["lam_z"][j]

    have = _open_parts(rt, parts_of, tag=tag, nbits=ring.ell)
    views = [PartyAView(None, dict(parts[0]["lam_z"]))]
    for i in (1, 2, 3):
        m_z = u.views[i].m * m_pub[i] + have[i][1] + have[i][2] + have[i][3]
        views.append(PartyAView(m_z, dict(parts[i]["lam_z"])))
    return DistAShare(tuple(views), tuple(out_shape), ring.dtype)


@traced_protocol("bit2a")
def bit2a(rt: FourPartyRuntime, b: DistBShare) -> DistAShare:
    """b = v + u - 2uv over the ring with u = lam_b, v = m_b (public)."""
    if b.nbits != 1:
        raise ValueError(f"bit2a takes a 1-bit share, got {b.nbits} bits")
    tag = rt.next_tag("bit2a")

    def build():
        # offline: <u> dealt by P0 (who holds every lambda), then verified
        lam_bit0 = (b.views[0].lam[1] ^ b.views[0].lam[2]
                    ^ b.views[0].lam[3]) & 1
        pieces = _ash_pieces(rt, lam_bit0, tag=tag + ".p")
        _u_check(rt, b, pieces, tag=tag)
        return [{"p": dict(pieces[i])} for i in PARTIES]

    parts = rt.prep.acquire(tag, "bit2a", build)
    u = _parts_to_neg_lam(rt, parts, b.shape)
    if rt.prep.skip_online:
        uv = _mult_lam0(rt, u, None, b.shape, tag=tag)
        return u.sub(uv.add(uv))
    # online: [[v]] is the public non-interactive sharing; uv via the
    # gamma-free mult
    m_bit = {i: b.views[i].m & 1 for i in (1, 2, 3)}
    v_sh = _public_to_dist(rt, m_bit, b.shape)
    uv = _mult_lam0(rt, u, m_bit, b.shape, tag=tag)
    return v_sh.add(u).sub(uv.add(uv))


# ---------------------------------------------------------------------------
# BitInj (Fig. 17): [[b]]^B * [[v]]^A -> [[b v]]^A.
# ---------------------------------------------------------------------------
@traced_protocol("bit_inject")
def bit_inject(rt: FourPartyRuntime, b: DistBShare,
               v: DistAShare) -> DistAShare:
    ring = rt.ring
    if b.nbits != 1:
        raise ValueError(f"bit_inject takes a 1-bit share, got {b.nbits}")
    tp = rt.transport
    out_shape = tuple(torch.broadcast_shapes(b.shape, v.shape))
    tag = rt.next_tag("binj")

    def build():
        # ---- offline: <y1> = <lam_b>, <y2> = <lam_b lam_v> by P0 ---------
        lam_b0 = torch.broadcast_to(
            (b.views[0].lam[1] ^ b.views[0].lam[2] ^ b.views[0].lam[3])
            & 1, out_shape)
        lam_v0 = torch.broadcast_to(
            v.views[0].lam[1] + v.views[0].lam[2] + v.views[0].lam[3],
            out_shape)
        # the two aSh's draws in one group (counter order kept)
        drawn = rt.sample_group(_ash_specs(out_shape) * 2)
        with tp.parallel(("offline",)):
            y1 = _ash_pieces(rt, lam_b0, tag=tag + ".y1", drawn=drawn[:2])
            y2 = _ash_pieces(rt, lam_b0 * lam_v0, tag=tag + ".y2",
                             drawn=drawn[2:])
        # Verification round: <y1> as in Bit2A; <y2> aggregated to P0
        # (2*ell + 1 bits, 1 round: Lemma C.11).
        agg2 = y2[1][2] + y2[1][3]
        with tp.round("offline"):
            tp.send(3, 1, y1[3][1] + y1[3][2], tag=tag + ".ck1",
                    nbits=ring.ell, phase="offline")
            l1_bit = torch.broadcast_to(b.views[2].lam[1] & 1, out_shape)
            tp.send(2, 1, l1_bit, tag=tag + ".l1", nbits=1, phase="offline")
            tp.send(1, 0, agg2, tag=tag + ".ck2", nbits=ring.ell,
                    phase="offline")
            got_agg1 = tp.recv(1, 3, tag=tag + ".ck1")
            got_l1 = tp.recv(1, 2, tag=tag + ".l1")
            got_agg2 = tp.recv(0, 1, tag=tag + ".ck2")
        if rt.malicious_checks:
            lam_b1 = got_l1 ^ torch.broadcast_to(
                (b.views[1].lam[2] ^ b.views[1].lam[3]) & 1, out_shape)
            rt.parties[1].check_equal(got_agg1 + y1[1][3], lam_b1,
                                      tag + ".ck1")
            rt.parties[0].check_equal(y2[0][1] + got_agg2, lam_b0 * lam_v0,
                                      tag + ".ck2")
        return [{"y1": dict(y1[i]), "y2": dict(y2[i])} for i in PARTIES]

    parts = rt.prep.acquire(tag, "binj", build)

    # ---- online: c_k from the m's + the components each pair holds -------
    def c_of(party: int, k: int):
        bv, vv = b.views[party], v.views[party]
        m_b = bv.m & 1
        m_v = vv.m
        x1 = m_b
        x2 = m_v - 2 * m_v * m_b
        x3 = 2 * m_b - 1
        # pair (1,3) -> lam_2 & piece 2; (2,1) -> lam_3 & piece 3;
        # (3,2) -> lam_1 & piece 1
        c = -x1 * vv.lam[k] + x2 * parts[party]["y1"][k] \
            + x3 * parts[party]["y2"][k]
        if k == 2:
            c = m_b * m_v + c
        return c

    with tp.parallel():
        with tp.round("online"):
            s2 = _vsh(rt, lambda p: c_of(p, 2), (1, 3), out_shape,
                      tag=tag + ".s2")
            s3 = _vsh(rt, lambda p: c_of(p, 3), (2, 1), out_shape,
                      tag=tag + ".s3")
            s1 = _vsh(rt, lambda p: c_of(p, 1), (3, 2), out_shape,
                      tag=tag + ".s1")
    return s1.add(s2).add(s3)


# ---------------------------------------------------------------------------
# BitExt / secure comparison (Fig. 19 + robust PPA variant).
# ---------------------------------------------------------------------------
@traced_protocol("bit_extract")
def bit_extract(rt: FourPartyRuntime, v: DistAShare,
                method: str | None = None) -> DistBShare:
    """[[msb(v)]]^B -- method "mul" (Fig. 19, guarded r) or "ppa"."""
    method = method or rt.bitext_method
    tag = rt.next_tag("bext")
    if method == "ppa":
        yb = RB.vsh_bool(rt,
                         lambda p: -(v.views[p].lam[2] + v.views[p].lam[3]),
                         (0, 1), v.shape, tag=tag + ".y", phase="offline")
        xb = RB.vsh_bool(rt, lambda p: v.views[p].m - v.views[p].lam[1],
                         (2, 3), v.shape, tag=tag + ".x")
        return RB.msb_of_sum(rt, xb, yb)
    if method != "mul":
        raise ValueError(f"unknown BitExt method {method!r}")
    return _bit_extract_mul(rt, v, tag)


def _bit_extract_mul(rt: FourPartyRuntime, v: DistAShare,
                     tag: str) -> DistBShare:
    ring = rt.ring
    tp = rt.transport
    shape = v.shape
    with tp.parallel(("offline",)):
        if rt.prep.consuming:
            # online-only: the (r, msb(r)) pair comes straight from the
            # store (both are offline vSh records carrying their m)
            r_sh = _vsh(rt, None, (1, 2), shape, tag=tag + ".r",
                        phase="offline")
            x_sh = RB.vsh_bool(rt, None, (1, 2), shape, nbits=1,
                               tag=tag + ".xb", phase="offline")
        else:
            # offline: P1, P2 sample r (guard-bounded, odd -- nonzero),
            # x = msb(r)
            mag, sign = rt.sample_group(
                [((1, 2), shape, ring.ell - 1 - rt.bitext_guard),
                 ((1, 2), shape)])
            sign = lshr(sign, ring.ell - 1)
            r = torch.where(sign.bool(), -(mag | 1), mag | 1)
            x_bit = ring.msb(r)
            with tp.round("offline"):
                r_sh = _vsh(rt, lambda p: r, (1, 2), shape, tag=tag + ".r",
                            phase="offline")
            x_sh = RB.vsh_bool(rt, lambda p: x_bit, (1, 2), shape, nbits=1,
                               tag=tag + ".xb", phase="offline")
        # online: [[rv]], opened towards P0 & P3; y = msb(rv).  In the
        # dealer pass reconstruct returns placeholders (the y vSh is
        # data-dependent: only its lambdas are prep, val_of is unused)
        rv = rt_mult(rt, r_sh, v)
        rv_val = reconstruct(rt, rv, receivers=(0, 3))
        y_bit = {p: ring.msb(rv_val[p]) for p in (0, 3)}
        y_sh = RB.vsh_bool(rt, lambda p: y_bit[p], (3, 0), shape,
                           nbits=1, tag=tag + ".yb")
    return x_sh.xor(y_sh)


def less_than_zero(rt: FourPartyRuntime, v: DistAShare, **kw) -> DistBShare:
    """[[v < 0]]^B -- the secure comparison primitive."""
    return bit_extract(rt, v, **kw)
