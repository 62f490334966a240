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

Kernel routes: in ``fused`` mode a lone secure AND's local math -- the
Fig. 4 gamma split, the three m_z' parts and m_z -- is ONE ``and_level``
kernel call (``kernels.ops.and_level``) on the (4, n) flattened share
stacks; a whole adder (``ppa_add``) or prefix-OR chain (``prefix_or``) is
ONE call (``kernels.ops.ppa_add`` / ``prefix_or``) that runs every AND
level, smear and mask of the chain per word.  In the ``offline`` and
``online`` modes an AND's gamma is a material, so a lone AND, an adder or a
prefix-OR is ONE call of the split entries (``kernels.ops.
and_chain_offline``, which hands out every AND's gamma, and
``and_chain_online``, which takes them in).  Every route takes a chain's
PRF draws in one group in the AND-by-AND order and makes its tally
entries by a host loop in the AND-by-AND order.
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
def _bool_zero_stack(f1, f2, f3) -> torch.Tensor:
    return torch.stack([f2 ^ f1, f3 ^ f2, f1 ^ f3])


def bool_zero_shares(ctx: TridentContext, shape) -> torch.Tensor:
    """Pi_Zero's XOR stack from the three subset draws, in the order of
    ``ZERO_SUBSETS`` (one draw group)."""
    return _bool_zero_stack(*ctx.sample_group(
        [(s, shape) for s in AL.ZERO_SUBSETS]))


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
    """One AND's draws in the JAX package's order: lam_z, then (faithful)
    the Pi_Zero streams."""
    specs = [(AL.lam_holders(j), out_shape) for j in (1, 2, 3)]
    if not ctx.collapse:
        specs += [(s, out_shape) for s in AL.ZERO_SUBSETS]
    return specs


def _tally_and(ctx: TridentContext, n_gates: int) -> None:
    """One AND's entries: its gamma exchange, and (but in an offline run)
    its m_z' exchange."""
    ctx.tally.add("Pi_AND", "offline", rounds=1, bits=3 * n_gates)
    if ctx.mode != "offline":
        ctx.tally.add("Pi_AND", "online", rounds=1, bits=3 * n_gates)


def _chain_draws(ctx: TridentContext, ands: int, out_shape) -> torch.Tensor:
    """The draws of `ands` ANDs in a row, as one (ands, S, n) view of the
    buffer they were drawn into (S = 6 faithful, 3 collapsed)."""
    specs = _and_specs(ctx, out_shape)
    buf = ctx.sample_group(specs * ands, flat=True)
    return buf.view(ands, len(specs), _n(out_shape))


def _split_chain(ctx: TridentContext, kind: str, ands: int, x: BShare,
                 y: BShare | None, out_shape, arg: int) -> torch.Tensor:
    """A chain of `ands` ANDs in an offline or online run, one
    ``ops.and_chain_offline`` / ``and_chain_online`` call on the
    broadcast, (4, n)-flattened stacks.  Offline: the chain's draws in one
    group, then one material per AND, ``{"lam_z", "gamma"}`` as views of
    the draws and of the kernel's gammas; online: one material consumed per
    AND.  Returns the (4, *out_shape) stack."""
    xs = _flat(x.data, out_shape)
    ys = None if y is None else _flat(y.data, out_shape)
    if ctx.mode == "offline":
        draws = _chain_draws(ctx, ands, out_shape)
        gammas, data = ops.and_chain_offline(kind, xs, ys, draws, arg)
        for a in range(ands):
            ctx.offer({"lam_z": draws[a, :3].view((3,) + out_shape),
                       "gamma": gammas[a].view((3,) + out_shape)})
    else:
        mats = [ctx.get_material() for _ in range(ands)]
        lam_z = torch.stack([m["lam_z"].reshape(3, -1) for m in mats])
        gammas = torch.stack([m["gamma"].reshape(3, -1) for m in mats])
        data = ops.and_chain_online(kind, xs, ys, lam_z, gammas, arg)
    return data.reshape((4,) + out_shape)


def and_bshare(ctx: TridentContext, x: BShare, y: BShare,
               active_bits: int | None = None) -> BShare:
    """Secure AND (Pi_Mult over Z_2, Fig. 4 with XOR/AND).

    active_bits: number of bit positions that actually carry gates (for the
    PPA's masked levels); defaults to max(x.nbits, y.nbits).
    """
    nbits = max(x.nbits, y.nbits)
    active = nbits if active_bits is None else active_bits
    out_shape = tuple(torch.broadcast_shapes(x.shape, y.shape))
    _tally_and(ctx, active * _n(out_shape))
    if ctx.mode != "fused":
        return BShare(_split_chain(ctx, "and", 1, x, y, out_shape, 0),
                      nbits)
    # lam_z, then (faithful) the zero shares, in the JAX package's sampling
    # order, as one group of draws; m_z from one fused level
    drawn = ctx.sample_group(_and_specs(ctx, out_shape))
    lam_z = torch.stack(drawn[:3])
    zs = None if ctx.collapse else _bool_zero_stack(*drawn[3:])
    return BShare(_and_level(x, y, lam_z, zs, out_shape), nbits)


# ---------------------------------------------------------------------------
# Word-level parallel-prefix adder (Sklansky) on bit-packed shares.
# ---------------------------------------------------------------------------
def ppa_add(ctx: TridentContext, x: BShare, y: BShare,
            cin: int = 0) -> BShare:
    """[[x + y + cin]]^B over Z_{2^ell}: log2(ell) AND-levels after the
    first AND g = x AND y, two ANDs a level (t_g, t_p in parallel), as one
    kernel call (``ops.ppa_add`` fused, the split entries otherwise); the
    tally's entries and parallel frames as the AND-by-AND circuit makes
    them."""
    ell = ctx.ring.ell
    levels = int(math.log2(ell))
    out_shape = tuple(torch.broadcast_shapes(x.shape, y.shape))
    n = _n(out_shape)
    _tally_and(ctx, max(x.nbits, y.nbits) * n)
    for _ in range(levels):
        with ctx.tally.parallel():
            _tally_and(ctx, ell // 2 * n)
            _tally_and(ctx, ell // 2 * n)
    if ctx.mode != "fused":
        return BShare(_split_chain(ctx, "add", 2 * levels + 1, x, y,
                                   out_shape, cin), ell)
    draws = _chain_draws(ctx, 2 * levels + 1, out_shape)
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

    log2(ell) levels; OR(a,b) = NOT(AND(NOT a, NOT b)), as one kernel call
    (``ops.prefix_or`` fused, the split entries otherwise).  Used by the
    in-protocol power-of-two normalization (activations.py).
    """
    ell, n = ctx.ring.ell, _n(x.shape)
    ands = int(math.log2(ell))
    for _ in range(ands):
        _tally_and(ctx, x.nbits * n)
    mask = signed((1 << x.nbits) - 1, ell)
    if ctx.mode != "fused":
        return BShare(_split_chain(ctx, "or", ands, x, None, x.shape, mask),
                      x.nbits)
    draws = _chain_draws(ctx, ands, x.shape)
    data = ops.prefix_or(x.data.reshape(4, -1), draws, mask)
    return BShare(data.reshape(x.data.shape), x.nbits)
