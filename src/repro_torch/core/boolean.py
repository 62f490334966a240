"""Boolean world of the joint simulation: XOR-shared circuits, bit-sliced
over ring words (``repro/core/boolean.py``).

The boolean [[.]]^B world mirrors the arithmetic protocols with (XOR, AND)
replacing (+, *).  The ell bit positions of a value are packed into one
ring word per element, so one word-level secure AND evaluates ell
independent AND gates -- communication is tallied per *active bit*,
matching the paper's per-gate accounting.

The parallel-prefix adder is a Sklansky network implemented with word-level
masks and local "smear" broadcasts (shift-XOR doubling of disjoint bits is
linear over GF(2), hence share-local): log2(ell) levels with ell/2 active
positions * 2 ANDs each, ell*(log ell + 1) ANDs in all with the initial
g = x AND y.

Kernel routes, in ``fused`` mode: a lone secure AND's local math -- the
Fig. 4 gamma split, the three m_z' parts and m_z -- is ONE ``and_level``
kernel call (``kernels.ops.and_level``) on the (4, n) flattened share
stacks; a whole adder (``ppa_add``) or prefix-OR chain (``prefix_or``) is
ONE call (``kernels.ops.ppa_add`` / ``prefix_or``) that runs every AND
level, smear and mask of the chain per word, with all its ANDs' PRF draws
taken in one group in the AND-by-AND order and its tally entries made by a
host loop in the AND-by-AND order.  The ``offline`` and ``online`` modes
keep the plain tensor code.
"""
from __future__ import annotations

import math

import torch

from ..kernels import ops
from . import algebra as AL
from .algebra import PARTIES
from .algebra import numel as _n
from .context import TridentContext
from .ring import signed
from .shares import BShare, stack_components


# ---------------------------------------------------------------------------
# Sharing / reconstruction in the boolean world.
# ---------------------------------------------------------------------------
def share_bool(ctx: TridentContext, v, owner: int = 0,
               nbits: int | None = None) -> BShare:
    """Pi_Sh^B: boolean [[.]]-sharing of packed-bit words."""
    nbits = ctx.ring.ell if nbits is None else nbits
    v, mask = ctx.words(v), signed((1 << nbits) - 1, ctx.ring.ell)
    lam = torch.stack(ctx.sample_group(
        [(PARTIES if owner == j else AL.lam_holders(j), v.shape)
         for j in (1, 2, 3)])) & mask
    m = (v ^ lam[0] ^ lam[1] ^ lam[2]) & mask
    ctx.tally.add("Pi_Sh^B", "online", rounds=1,
                  bits=3 * nbits * _n(v.shape))
    return BShare(stack_components(m, lam), nbits)


def vsh_bool(ctx: TridentContext, v, owners=(2, 3),
             nbits: int | None = None, phase: str = "online") -> BShare:
    """Pi_vSh^B (Fig. 7): verifiable sharing by two owners.

    Cost (Lemma C.1): 1 round; 2*nbits if P0 is an owner else nbits.
    """
    nbits = ctx.ring.ell if nbits is None else nbits
    v, mask = ctx.words(v), signed((1 << nbits) - 1, ctx.ring.ell)
    lam = torch.stack(ctx.sample_group(
        [(PARTIES if j in owners else AL.lam_holders(j), v.shape)
         for j in (1, 2, 3)])) & mask
    m = (v ^ lam[0] ^ lam[1] ^ lam[2]) & mask
    factor = 2 if 0 in owners else 1
    ctx.tally.add("Pi_vSh^B", phase, rounds=1,
                  bits=factor * nbits * _n(v.shape))
    return BShare(stack_components(m, lam), nbits)


def reconstruct_bool(ctx: TridentContext, x: BShare,
                     receivers=PARTIES) -> torch.Tensor:
    ctx.tally.add("Pi_Rec^B", "online", rounds=1,
                  bits=x.nbits * _n(x.shape) * len(receivers))
    return x.reveal()


# ---------------------------------------------------------------------------
# Boolean zero shares + secure AND (the XOR/AND twin of Pi_Mult).
# ---------------------------------------------------------------------------
def bool_zero_shares(ctx: TridentContext, shape) -> torch.Tensor:
    return _bool_zero_stack(
        *ctx.sample_group([(s, shape) for s in AL.ZERO_SUBSETS]))


def _bool_zero_stack(f1, f2, f3) -> torch.Tensor:
    return torch.stack([f2 ^ f1, f3 ^ f2, f1 ^ f3])


def _flat(t: torch.Tensor, out_shape) -> torch.Tensor:
    """A (rows, *shape) stack broadcast to out_shape, as (rows, n)."""
    rows = t.shape[0]
    lead = (1,) * (len(out_shape) - (t.dim() - 1))
    t = t.reshape((rows,) + lead + tuple(t.shape[1:]))
    return t.broadcast_to((rows,) + tuple(out_shape)).reshape(rows, -1)


def _and_level(x: BShare, y: BShare, lam_z, zs, out_shape) -> torch.Tensor:
    """One ``and_level`` kernel call on the broadcast, (4, n)-flattened
    stacks; returns the (4, *out_shape) output stack (m_z, lam_z)."""
    out = ops.and_level(_flat(x.data, out_shape), _flat(y.data, out_shape),
                        _flat(lam_z, out_shape),
                        None if zs is None else _flat(zs, out_shape))
    return out.reshape((4,) + tuple(out_shape))


def _and_specs(ctx: TridentContext, out_shape) -> list:
    """One fused AND's draws in the JAX package's order: lam_z, then
    (faithful) the Pi_Zero streams."""
    specs = [(AL.lam_holders(j), out_shape) for j in (1, 2, 3)]
    if not ctx.collapse:
        specs += [(s, out_shape) for s in AL.ZERO_SUBSETS]
    return specs


def _tally_and(ctx: TridentContext, n_gates: int) -> None:
    ctx.tally.add("Pi_AND", "offline", rounds=1, bits=3 * n_gates)
    ctx.tally.add("Pi_AND", "online", rounds=1, bits=3 * n_gates)


def _chain_draws(ctx: TridentContext, ands: int, out_shape) -> torch.Tensor:
    """The draws of `ands` fused ANDs in a row, as one (ands, S, n) view of
    the buffer they were drawn into (S = 6 faithful, 3 collapsed)."""
    specs = _and_specs(ctx, out_shape)
    buf = ctx.sample_group(specs * ands, flat=True)
    return buf.view(ands, len(specs), _n(out_shape))


def and_bshare(ctx: TridentContext, x: BShare, y: BShare,
               active_bits: int | None = None) -> BShare:
    """Secure AND (Pi_Mult over Z_2, Fig. 4 with XOR/AND).

    active_bits: number of bit positions that actually carry gates (for the
    PPA's masked levels); defaults to max(x.nbits, y.nbits).
    """
    ring = ctx.ring
    nbits = max(x.nbits, y.nbits)
    active = nbits if active_bits is None else active_bits
    out_shape = tuple(torch.broadcast_shapes(x.shape, y.shape))
    n_gates = active * _n(out_shape)
    lx, ly = x.data[1:], y.data[1:]
    mx, my = x.m, y.m

    if ctx.mode == "fused":
        # the kernel route: lam_z, then (faithful) the zero shares, in the
        # JAX package's sampling order, as one group of draws; m_z from one
        # fused level
        drawn = ctx.sample_group(_and_specs(ctx, out_shape))
        lam_z = torch.stack(drawn[:3])
        zs = None if ctx.collapse else _bool_zero_stack(*drawn[3:])
        _tally_and(ctx, n_gates)
        return BShare(_and_level(x, y, lam_z, zs, out_shape), nbits)

    if ctx.mode == "offline":
        lam_z = torch.stack(ctx.sample_group(
            [(AL.lam_holders(j), out_shape) for j in (1, 2, 3)]))
        if ctx.collapse:
            g = (lx[0] ^ lx[1] ^ lx[2]) & (ly[0] ^ ly[1] ^ ly[2])
            z = torch.zeros_like(g)
            gamma = torch.stack([g, z, z])
        else:
            g2 = (lx[1] & ly[1]) ^ (lx[1] & ly[2]) ^ (lx[2] & ly[1])
            g3 = (lx[2] & ly[2]) ^ (lx[2] & ly[0]) ^ (lx[0] & ly[2])
            g1 = (lx[0] & ly[0]) ^ (lx[0] & ly[1]) ^ (lx[1] & ly[0])
            zs = bool_zero_shares(ctx, g1.shape)
            gamma = torch.stack([g1 ^ zs[2], g2 ^ zs[0], g3 ^ zs[1]])
        ctx.offer({"lam_z": lam_z, "gamma": gamma})
    else:
        mat = ctx.get_material()
        lam_z, gamma = mat["lam_z"], mat["gamma"]
    ctx.tally.add("Pi_AND", "offline", rounds=1, bits=3 * n_gates)

    if ctx.mode == "offline":
        m = torch.zeros(out_shape, dtype=ring.dtype, device=ctx.device)
        return BShare(stack_components(m, lam_z), nbits)

    if ctx.collapse:
        lxs, lys = lx[0] ^ lx[1] ^ lx[2], ly[0] ^ ly[1] ^ ly[2]
        mz_p = (lxs & my) ^ (mx & lys) ^ gamma[0] ^ gamma[1] ^ gamma[2] \
            ^ lam_z[0] ^ lam_z[1] ^ lam_z[2]
    else:
        parts = [(lx[i] & my) ^ (mx & ly[i]) ^ gamma[i] ^ lam_z[i]
                 for i in range(3)]
        mz_p = parts[0] ^ parts[1] ^ parts[2]
    m_z = mz_p ^ (mx & my)
    ctx.tally.add("Pi_AND", "online", rounds=1, bits=3 * n_gates)
    return BShare(stack_components(m_z, lam_z), nbits)


# ---------------------------------------------------------------------------
# Word-level parallel-prefix adder (Sklansky) on bit-packed shares.
# ---------------------------------------------------------------------------
def _smear_left(x: BShare, width: int) -> BShare:
    """Broadcast isolated boundary bits across `width` positions to their
    left (local: shift-XOR doubling of disjoint bits = OR over GF(2))."""
    d = x.data
    j = 1
    while j < width:
        d = d ^ (d << j)
        j <<= 1
    return BShare(d, x.nbits)


def ppa_add(ctx: TridentContext, x: BShare, y: BShare,
            cin: int = 0) -> BShare:
    """[[x + y + cin]]^B over Z_{2^ell}: log2(ell) AND-levels."""
    ell = ctx.ring.ell
    if ctx.mode == "fused":
        return _ppa_add_fused(ctx, x, y, cin)
    p0 = x ^ y
    g = and_bshare(ctx, x, y)                       # ell ANDs
    p = p0
    if cin:
        # public carry-in: g_0 ^= p_0 AND cin -- AND with a public mask and
        # share-XOR are both local.
        g = g ^ p.and_public(1)
    for k in range(int(math.log2(ell))):
        half = 1 << k
        bnd, upper = AL.bit_masks(ell, k)
        # boundary bit (top of lower half) broadcast to the `half` upper
        # positions boundary+1 .. boundary+half: shift by 1 then double.
        gb = _smear_left(g.and_public(bnd).shift_left(1), half)
        pb = _smear_left(p.and_public(bnd).shift_left(1), half)
        pu = p.and_public(upper)
        with ctx.tally.parallel():
            t_g = and_bshare(ctx, pu, gb, active_bits=ell // 2)
            t_p = and_bshare(ctx, pu, pb, active_bits=ell // 2)
        g = g ^ t_g
        p = p.and_public(((1 << ell) - 1) ^ upper) ^ t_p
    # sum_i = p0_i ^ carry_i,  carry = (prefix_g << 1) | cin
    s = p0 ^ g.shift_left(1)
    if cin:
        s = s ^ 1
    return BShare(s.data, ell)


def _ppa_add_fused(ctx: TridentContext, x: BShare, y: BShare,
                   cin: int) -> BShare:
    """ppa_add as one ``ops.ppa_add`` call: the 2 log2(ell) + 1 ANDs'
    draws in one group, the operands broadcast once, the tally's entries
    and parallel frames as the AND-by-AND code makes them."""
    ell = ctx.ring.ell
    levels = int(math.log2(ell))
    out_shape = tuple(torch.broadcast_shapes(x.shape, y.shape))
    n = _n(out_shape)
    draws = _chain_draws(ctx, 2 * levels + 1, out_shape)
    _tally_and(ctx, max(x.nbits, y.nbits) * n)
    for _ in range(levels):
        with ctx.tally.parallel():
            _tally_and(ctx, ell // 2 * n)
            _tally_and(ctx, ell // 2 * n)
    data = ops.ppa_add(_flat(x.data, out_shape), _flat(y.data, out_shape),
                       draws, cin)
    return BShare(data.reshape((4,) + out_shape), ell)


def ppa_sub(ctx: TridentContext, x: BShare, y: BShare) -> BShare:
    """[[x - y]]^B = x + NOT(y) + 1."""
    return ppa_add(ctx, x, ~y, cin=1)


def msb_of_sum(ctx: TridentContext, x: BShare, y: BShare,
               cin: int = 0) -> BShare:
    """[[msb(x + y + cin)]]^B as a 1-bit share."""
    return ppa_add(ctx, x, y, cin=cin).bit(ctx.ring.ell - 1)


def prefix_or(ctx: TridentContext, x: BShare) -> BShare:
    """[[prefix-OR]]^B from the msb downward: out_i = OR_{j>=i} x_j.

    log2(ell) levels; OR(a,b) = NOT(AND(NOT a, NOT b)).
    Used by the in-protocol power-of-two normalization (activations.py).
    """
    ell = ctx.ring.ell
    if ctx.mode == "fused":
        return _prefix_or_fused(ctx, x)
    cur = x
    j = 1
    while j < ell:
        shifted = cur.shift_right(j)
        cur = ~and_bshare(ctx, ~cur, ~shifted)
        j <<= 1
    return cur


def _prefix_or_fused(ctx: TridentContext, x: BShare) -> BShare:
    """prefix_or as one ``ops.prefix_or`` call: the log2(ell) ANDs' draws
    in one group, their tally entries as the AND-by-AND code makes them."""
    ell, n = ctx.ring.ell, _n(x.shape)
    ands = int(math.log2(ell))
    draws = _chain_draws(ctx, ands, x.shape)
    for _ in range(ands):
        _tally_and(ctx, x.nbits * n)
    data = ops.prefix_or(x.data.reshape(4, -1), draws,
                         signed((1 << x.nbits) - 1, ell))
    return BShare(data.reshape(x.data.shape), x.nbits)
