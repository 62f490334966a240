"""Party-local boolean world (``repro/runtime/boolean.py``): Pi_vSh^B,
the secure AND (Pi_Mult over Z_2 with the arithmetic world's gamma routing
tables, XOR replacing +), and the Sklansky parallel-prefix adder built
from them.  One AND message moves a full ring word but is tallied at
``active_bits`` per element, the joint tally's per-gate accounting.
"""
from __future__ import annotations

import math

import torch

from ..core import algebra as AL
from ..core.algebra import (GAMMA_LOCAL, GAMMA_RECV, PARTIES, ZERO_SUBSETS,
                            bit_masks, lam_holders)
from ..core.ring import signed
from ..obs import traced_protocol
from .party import DistBShare, PartyBView
from .protocols import (_jmp, _open_parts, _round_pieces, _vsh_exchange,
                        _vsh_lam_parts)
from .runtime import FourPartyRuntime


# ---------------------------------------------------------------------------
# Pi_vSh^B (Fig. 7): verifiable boolean sharing by two owners.
# ---------------------------------------------------------------------------
@traced_protocol("vsh_bool")
def vsh_bool(rt: FourPartyRuntime, val_of, owners: tuple, shape,
             nbits: int | None = None, *, tag: str,
             phase: str = "online") -> DistBShare:
    """``val_of(party)`` returns the owner's local copy of v.  The masked
    value is jmp-sent to each non-owner online party.  A phase="offline"
    vSh^B runs its exchange inside the prep build (its record carries m);
    a phase="online" one exchanges online, and in deal mode stops at the
    lambdas."""
    ring = rt.ring
    nbits = ring.ell if nbits is None else nbits
    mask = signed((1 << nbits) - 1, ring.ell)
    tp = rt.transport

    def exchange(lam_of):
        with tp.round(phase):
            return _vsh_exchange(
                rt, lambda p: val_of(p) & mask, owners, lam_of, tag=tag,
                nbits=nbits, phase=phase, xor=True)

    def build():
        lam, parts = _vsh_lam_parts(rt, owners, shape, mask=mask)
        if phase == "offline":
            m = exchange(lambda p: lam)
            for i in (1, 2, 3):
                parts[i]["m"] = m[i]
        return parts

    parts = rt.prep.acquire(tag, f"vshB.{phase}", build)
    if phase == "offline":
        m = {i: parts[i]["m"] for i in (1, 2, 3)}
    elif rt.prep.skip_online:
        m = {i: None for i in (1, 2, 3)}
    else:
        m = exchange(lambda p: parts[p]["lam"])
    views = [PartyBView(None if i == 0 else m[i],
                        {j: parts[i]["lam"][j] for j in (1, 2, 3) if j != i},
                        nbits) for i in PARTIES]
    return DistBShare(tuple(views), tuple(shape), ring.dtype, nbits)


# ---------------------------------------------------------------------------
# Secure AND (Pi_Mult over Z_2, Fig. 4 with XOR/AND).
# ---------------------------------------------------------------------------
@traced_protocol("and")
def and_bshare(rt: FourPartyRuntime, x: DistBShare, y: DistBShare,
               active_bits: int | None = None) -> DistBShare:
    """[[x AND y]]^B.  Offline: 3 gamma-piece jmps; online: 3 part jmps --
    each tallied at ``active_bits`` bits per element."""
    ring = rt.ring
    tp = rt.transport
    nbits = max(x.nbits, y.nbits)
    active = nbits if active_bits is None else active_bits
    out_shape = tuple(torch.broadcast_shapes(x.shape, y.shape))
    tag = rt.next_tag("and")

    def build():
        # offline, in the JAX package's counter order: lam_z, zero shares
        # (one group of six draws)
        drawn = rt.sample_group([(lam_holders(j), out_shape)
                                 for j in (1, 2, 3)]
                                + [(s, out_shape) for s in ZERO_SUBSETS])
        lam_z = dict(zip((1, 2, 3), drawn[:3]))
        fs = drawn[3:]
        masks = {j: fs[a] ^ fs[b] for j, (a, b) in AL.GAMMA_MASK_F.items()}

        gamma = _round_pieces(rt.kernels.bool_gamma_pieces_round, x, y,
                              masks)
        with tp.round("offline"):
            for j in (1, 2, 3):
                local, recv = GAMMA_LOCAL[j], GAMMA_RECV[j]
                gamma[recv][j] = _jmp(rt, 0, local, recv, gamma[0][j],
                                      gamma[local][j], tag=f"{tag}.g{j}",
                                      nbits=active, phase="offline")
        return [{"gamma": dict(gamma[i]),
                 "lam_z": {j: lam_z[j] for j in (1, 2, 3) if j != i}}
                for i in PARTIES]

    parts = rt.prep.acquire(tag, "and", build)
    if rt.prep.skip_online:
        views = [PartyBView(None, dict(parts[i]["lam_z"]), nbits)
                 for i in PARTIES]
        return DistBShare(tuple(views), out_shape, ring.dtype, nbits)

    # ---- online: every party's m_x & m_y + two parts in one round call --
    def request(party: int) -> tuple:
        vx, vy = x.views[party], y.views[party]
        js = tuple(j for j in (1, 2, 3) if party in AL.PART_HOLDERS[j])
        return (vx.m, vy.m, vx.lam, vy.lam, parts[party]["gamma"],
                {j: parts[party]["lam_z"][j] for j in js}, js)

    local = dict(zip((1, 2, 3), rt.kernels.bool_online_parts_round(
        [request(i) for i in (1, 2, 3)])))

    have = _open_parts(rt, lambda party, j: local[party][1][j], tag=tag,
                       nbits=active)
    views = [PartyBView(None, dict(parts[0]["lam_z"]), nbits)]
    for i in (1, 2, 3):
        m_z = local[i][0] ^ have[i][1] ^ have[i][2] ^ have[i][3]
        views.append(PartyBView(m_z, dict(parts[i]["lam_z"]), nbits))
    return DistBShare(tuple(views), out_shape, ring.dtype, nbits)


# ---------------------------------------------------------------------------
# Word-level parallel-prefix adder (Sklansky) on bit-packed shares.
# ---------------------------------------------------------------------------
def _smear_left(x: DistBShare, width: int) -> DistBShare:
    """Broadcast isolated boundary bits `width` positions leftward (local:
    shift-XOR doubling of disjoint bits = OR over GF(2))."""
    cur = x
    j = 1
    while j < width:
        cur = cur.xor(cur.shift_left(j))
        j <<= 1
    return cur


@traced_protocol("ppa_add")
def ppa_add(rt: FourPartyRuntime, x: DistBShare, y: DistBShare,
            cin: int = 0) -> DistBShare:
    """[[x + y + cin]]^B over Z_{2^ell}: log2(ell) AND-levels, each level's
    two ANDs sharing one round."""
    ell = rt.ring.ell
    tp = rt.transport
    p0 = x.xor(y)
    g = and_bshare(rt, x, y)                       # ell ANDs
    p = p0
    if cin:
        g = g.xor(p.and_public(1))
    for k in range(int(math.log2(ell))):
        half = 1 << k
        bnd, upper = bit_masks(ell, k)
        gb = _smear_left(g.and_public(bnd).shift_left(1), half)
        pb = _smear_left(p.and_public(bnd).shift_left(1), half)
        pu = p.and_public(upper)
        with tp.parallel():
            t_g = and_bshare(rt, pu, gb, active_bits=ell // 2)
            t_p = and_bshare(rt, pu, pb, active_bits=ell // 2)
        g = g.xor(t_g)
        p = p.and_public(((1 << ell) - 1) ^ upper).xor(t_p)
    s = p0.xor(g.shift_left(1))
    if cin:
        s = s.xor_public(1)
    return DistBShare(s.views, s.shape, s.dtype, ell)


def ppa_sub(rt: FourPartyRuntime, x: DistBShare, y: DistBShare
            ) -> DistBShare:
    """[[x - y]]^B = x + NOT(y) + 1."""
    return ppa_add(rt, x, y.invert(), cin=1)


def msb_of_sum(rt: FourPartyRuntime, x: DistBShare, y: DistBShare,
               cin: int = 0) -> DistBShare:
    """[[msb(x + y + cin)]]^B as a 1-bit share."""
    return ppa_add(rt, x, y, cin=cin).bit(rt.ring.ell - 1)


@traced_protocol("prefix_or")
def prefix_or(rt: FourPartyRuntime, x: DistBShare) -> DistBShare:
    """[[prefix-OR]]^B from the msb downward: out_i = OR_{j>=i} x_j, over
    log2(ell) levels of OR(a,b) = NOT(AND(NOT a, NOT b))."""
    ell = rt.ring.ell
    cur = x
    j = 1
    while j < ell:
        shifted = cur.shift_right(j)
        cur = and_bshare(rt, cur.invert(), shifted.invert()).invert()
        j <<= 1
    return cur
