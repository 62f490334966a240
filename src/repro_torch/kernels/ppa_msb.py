"""Fused boolean AND levels of the joint simulation -- one level, the whole
Sklansky adder and the whole prefix-OR chain -- and the Sklansky msb(x + y)
loop over single levels: the Hopper kernels and their plain PyTorch
versions (``repro/kernels/ppa_msb.py``).

    and_level(x, y, lamz, zero) -> (4, n): (m_z, lamz[0], lamz[1], lamz[2])
    ppa_add(x, y, draws, cin)   -> (4, n): [[x + y + cin]]
    prefix_or(x, draws, mask)   -> (4, n): [[OR_{j >= i} x_j]]

x, y are (4, n) bit-sliced share stacks (m, l1, l2, l3); lamz the (3, n)
fresh output lambdas; zero the (3, n) Pi_Zero shares that randomize the
gamma split, or None for zero shares (the component-collapsed joint
world).  A chain's `draws` are its ANDs' PRF draws as one (A, S, n)
buffer: AND a's lam_z streams, then, faithful (S = 6), its three Pi_Zero
streams f1, f2, f3, of which the level takes (f2 ^ f1, f3 ^ f2, f1 ^ f3);
S = 3 is the collapsed world's lam_z alone.  `mask` is the public all-ones
word of the share's valid bits (NOT).  XOR, AND and the shifts are
bitwise, so each kernel (``csrc/and_level.cu``, one thread a word) equals
its plain version word for word.

The split twins, for the joint simulation's offline and online runs
(kind "and": x AND y; "add": the adder, arg = cin; "or": the prefix-OR of
x, arg = mask):

    and_chain_offline(kind, x, y, draws, arg) -> (gammas (A, 3, n), (4, n))
    and_chain_online(kind, x, y, lamz, gammas, arg) -> (4, n)

The offline pass forms every AND's gamma -- Fig. 4's split with the zero
shares faithful, ``[lx_sum & ly_sum, 0, 0]`` collapsed (S = 3) -- and the
stack the offline run gives (each AND's m word 0, its lambdas from the
draws; the linear steps act on the m words as they are); the online pass
takes each AND's lam_z and gamma ((A, 3, n) each) and forms m_z.

``ppa_msb`` is the Python loop of the whole msb(x + y) over public words:
log2(ell) + 1 AND levels with the Sklansky smear masks, each level one call
of the ``and_level`` it is given; with ``and_level_plain`` it is the plain
version of the ``ppa_msb`` kernel (``ppa_msb_cuda``), which runs the whole
loop in one launch, one thread a word.
"""
from __future__ import annotations

import math

import torch

from ..core.algebra import bit_masks
from ..core.ring import lshr, signed, width_of
from .build import check_operands, launch

_SYMBOL = {torch.int64: "and_level_u64", torch.int32: "and_level_u32"}
_ADD = {torch.int64: "ppa_add_u64", torch.int32: "ppa_add_u32"}
_OR = {torch.int64: "prefix_or_u64", torch.int32: "prefix_or_u32"}
_MSB = {torch.int64: "ppa_msb_u64", torch.int32: "ppa_msb_u32"}
_OFFLINE = {torch.int64: "and_chain_offline_u64",
            torch.int32: "and_chain_offline_u32"}
_ONLINE = {torch.int64: "and_chain_online_u64",
           torch.int32: "and_chain_online_u32"}
# the split entries' chain codes
CHAIN_KINDS = {"and": 0, "add": 1, "or": 2}


def chain_ands(ell: int, adder: bool) -> int:
    """ANDs of a chain: the adder's first AND and two a level over
    log2(ell) levels, or the prefix-OR's one per doubling."""
    levels = int(math.log2(ell))
    return 2 * levels + 1 if adder else levels


def split_ands(kind: str, ell: int) -> int:
    """ANDs of a split chain of `kind` ("and", "add" or "or")."""
    return 1 if kind == "and" else chain_ands(ell, kind == "add")


def and_level_plain(x, y, lamz, zero=None) -> torch.Tensor:
    mx, lx1, lx2, lx3 = x[0], x[1], x[2], x[3]
    my, ly1, ly2, ly3 = y[0], y[1], y[2], y[3]
    g1 = (lx1 & ly1) ^ (lx1 & ly2) ^ (lx2 & ly1)
    g2 = (lx2 & ly2) ^ (lx2 & ly3) ^ (lx3 & ly2)
    g3 = (lx3 & ly3) ^ (lx3 & ly1) ^ (lx1 & ly3)
    if zero is not None:
        g1, g2, g3 = g1 ^ zero[2], g2 ^ zero[0], g3 ^ zero[1]
    p1 = (lx1 & my) ^ (mx & ly1) ^ g1 ^ lamz[0]
    p2 = (lx2 & my) ^ (mx & ly2) ^ g2 ^ lamz[1]
    p3 = (lx3 & my) ^ (mx & ly3) ^ g3 ^ lamz[2]
    m_z = p1 ^ p2 ^ p3 ^ (mx & my)
    return torch.stack([m_z, lamz[0], lamz[1], lamz[2]])


def and_level_cuda(x, y, lamz, zero=None) -> torch.Tensor:
    """The ``and_level`` kernel on CUDA tensors."""
    n = x.shape[-1]
    if (x.shape != (4, n) or y.shape != (4, n) or lamz.shape != (3, n)
            or (zero is not None and zero.shape != (3, n))):
        raise ValueError(
            f"and_level takes x, y (4, n), lamz and zero (3, n), got "
            f"{tuple(x.shape)}, {tuple(y.shape)}, {tuple(lamz.shape)}, "
            f"{None if zero is None else tuple(zero.shape)}")
    ins = [t.contiguous() for t in (x, y, lamz)]
    if zero is not None:
        ins.append(zero.contiguous())
    check_operands(*ins)
    if x.dtype not in _SYMBOL:
        raise ValueError(f"and_level takes int64/int32 words, got {x.dtype}")
    out = torch.empty_like(ins[0])
    launch("and_level", _SYMBOL[x.dtype], x.device, ins[0].data_ptr(),
           ins[1].data_ptr(), ins[2].data_ptr(),
           ins[3].data_ptr() if zero is not None else None, out.data_ptr(),
           n)
    return out


def _drawn_and(x, y, d) -> torch.Tensor:
    """One level with its (S, n) draws: lam_z, then (S = 6) the Pi_Zero
    streams f1, f2, f3."""
    zero = None if d.shape[0] == 3 else torch.stack(
        [d[4] ^ d[3], d[5] ^ d[4], d[3] ^ d[5]])
    return and_level_plain(x, y, d[:3], zero)


def _smear(v: torch.Tensor, width: int) -> torch.Tensor:
    """Isolated boundary bits copied `width` positions leftward by
    shift-XOR doubling (linear over GF(2), so it acts on shares)."""
    j = 1
    while j < width:
        v = v ^ (v << j)
        j <<= 1
    return v


def _adder(x, y, and_, cin: int) -> torch.Tensor:
    """[[x + y + cin]] of (4, n) stacks by the Sklansky adder on bit-packed
    words, the levels of ``core.boolean.ppa_add``, AND a being
    ``and_(a, u, v)``."""
    ell = width_of(x.dtype)
    p0 = x ^ y
    g = and_(0, x, y)
    p = p0
    if cin:
        g = g ^ (p & 1)
    for k in range(int(math.log2(ell))):
        half = 1 << k
        bnd, upper = (signed(m, ell) for m in bit_masks(ell, k))
        gb = _smear((g & bnd) << 1, half)
        pb = _smear((p & bnd) << 1, half)
        pu = p & upper
        g = g ^ and_(1 + 2 * k, pu, gb)
        p = (p & ~upper) ^ and_(2 + 2 * k, pu, pb)
    s = p0 ^ (g << 1)
    if cin:
        s[0] ^= 1
    return s


def _prefix_or(x, and_, mask: int) -> torch.Tensor:
    """[[prefix-OR]] of a (4, n) stack from the msb down, the levels of
    ``core.boolean.prefix_or``: OR(a, b) = NOT(AND(NOT a, NOT b)), NOT the
    XOR of the public `mask` into m; AND a being ``and_(a, u, v)``."""
    ell = width_of(x.dtype)
    cur = x
    for a in range(chain_ands(ell, adder=False)):
        nc, sh = cur.clone(), lshr(cur, 1 << a)
        nc[0] ^= mask
        sh[0] ^= mask
        cur = and_(a, nc, sh)
        cur[0] ^= mask
    return cur


def _drawn(draws):
    return lambda a, u, v: _drawn_and(u, v, draws[a])


def ppa_add_plain(x, y, draws, cin: int = 0) -> torch.Tensor:
    """The adder with AND a taking draws[a] ((A, S, n), A = 2 log2(ell) +
    1)."""
    return _adder(x, y, _drawn(draws), cin)


def prefix_or_plain(x, draws, mask: int) -> torch.Tensor:
    """The prefix-OR with AND a taking draws[a] ((log2(ell), S, n))."""
    return _prefix_or(x, _drawn(draws), mask)


def _chain(kind: str, x, y, and_, arg: int) -> torch.Tensor:
    if kind == "and":
        return and_(0, x, y)
    if kind == "add":
        return _adder(x, y, and_, arg)
    return _prefix_or(x, and_, arg)


def and_chain_offline_plain(kind: str, x, y, draws, arg: int = 0) -> tuple:
    """The offline run of a chain: (gammas (A, 3, n), the (4, n) stack with
    each AND's m word 0); AND a draws[a] ((A, S, n))."""
    gammas = torch.empty((draws.shape[0], 3, draws.shape[2]),
                         dtype=draws.dtype, device=draws.device)

    def and_(a, u, v):
        d, lu, lv = draws[a], u[1:], v[1:]
        if d.shape[0] == 3:
            gammas[a, 0] = (lu[0] ^ lu[1] ^ lu[2]) & (lv[0] ^ lv[1] ^ lv[2])
            gammas[a, 1:] = 0
        else:
            gammas[a, 0] = (lu[0] & lv[0]) ^ (lu[0] & lv[1]) \
                ^ (lu[1] & lv[0]) ^ d[3] ^ d[5]
            gammas[a, 1] = (lu[1] & lv[1]) ^ (lu[1] & lv[2]) \
                ^ (lu[2] & lv[1]) ^ d[4] ^ d[3]
            gammas[a, 2] = (lu[2] & lv[2]) ^ (lu[2] & lv[0]) \
                ^ (lu[0] & lv[2]) ^ d[5] ^ d[4]
        return torch.cat([torch.zeros_like(d[:1]), d[:3]])

    return gammas, _chain(kind, x, y, and_, arg)


def and_chain_online_plain(kind: str, x, y, lamz, gammas,
                           arg: int = 0) -> torch.Tensor:
    """The online run of a chain: AND a on lamz[a] and gammas[a] ((A, 3, n)
    each)."""
    def and_(a, u, v):
        z = lamz[a]
        p = (u[1:] & v[0]) ^ (u[0] & v[1:]) ^ gammas[a] ^ z
        return torch.cat([(p[0] ^ p[1] ^ p[2] ^ (u[0] & v[0]))[None], z])

    return _chain(kind, x, y, and_, arg)


def _chain_operands(name, stacks, draws, adder):
    n = stacks[0].shape[-1]
    ell = width_of(stacks[0].dtype)
    A = chain_ands(ell, adder)
    if (any(s.shape != (4, n) for s in stacks) or draws.dim() != 3
            or draws.shape[0] != A or draws.shape[1] not in (3, 6)
            or draws.shape[2] != n):
        raise ValueError(
            f"{name} takes stacks (4, n) and draws ({A}, 3 or 6, n), got "
            f"{[tuple(s.shape) for s in stacks]}, {tuple(draws.shape)}")
    ins = [t.contiguous() for t in (*stacks, draws)]
    check_operands(*ins)
    if ins[0].dtype not in _SYMBOL:
        raise ValueError(f"{name} takes int64/int32 words, got "
                         f"{ins[0].dtype}")
    return ins, n


def ppa_add_cuda(x, y, draws, cin: int = 0) -> torch.Tensor:
    """The ``ppa_add`` kernel: the whole adder in one launch."""
    (x, y, draws), n = _chain_operands("ppa_add", (x, y), draws, True)
    out = torch.empty_like(x)
    launch("and_level", _ADD[x.dtype], x.device, x.data_ptr(), y.data_ptr(),
           draws.data_ptr(), draws.shape[1], int(bool(cin)), out.data_ptr(),
           n)
    return out


def prefix_or_cuda(x, draws, mask: int) -> torch.Tensor:
    """The ``prefix_or`` kernel: the whole chain in one launch."""
    (x, draws), n = _chain_operands("prefix_or", (x,), draws, False)
    out = torch.empty_like(x)
    launch("and_level", _OR[x.dtype], x.device, x.data_ptr(),
           draws.data_ptr(), draws.shape[1], mask & (2**64 - 1),
           out.data_ptr(), n)
    return out


def _split_operands(name, kind, x, y, planes, n_planes):
    """The split entries' operands, contiguous and checked: x (and y but
    for "or") (4, n); each of `planes` (A, n_planes[i], n)."""
    if kind not in CHAIN_KINDS:
        raise ValueError(f"{name}: kind must be one of {list(CHAIN_KINDS)}, "
                         f"got {kind!r}")
    n = x.shape[-1]
    A = split_ands(kind, width_of(x.dtype))
    stacks = (x,) if kind == "or" else (x, y)
    want = [(A, s, n) for s in n_planes]
    if (any(s.shape != (4, n) for s in stacks)
            or [tuple(p.shape) for p in planes] != want):
        raise ValueError(
            f"{name} ({kind}) takes stacks (4, n) and planes {want}, got "
            f"{[tuple(s.shape) for s in stacks]}, "
            f"{[tuple(p.shape) for p in planes]}")
    ins = [t.contiguous() for t in (*stacks, *planes)]
    check_operands(*ins)
    if ins[0].dtype not in _OFFLINE:
        raise ValueError(f"{name} takes int64/int32 words, got "
                         f"{ins[0].dtype}")
    if kind == "or":
        ins.insert(1, None)
    return ins, n


def and_chain_offline_cuda(kind: str, x, y, draws, arg: int = 0) -> tuple:
    """The ``and_chain_offline`` kernel: the chain's offline run in one
    launch."""
    S = draws.shape[1] if draws.dim() == 3 else 0
    if S not in (3, 6):
        raise ValueError(f"and_chain_offline takes draws (A, 3 or 6, n), "
                         f"got {tuple(draws.shape)}")
    (x, y, draws), n = _split_operands("and_chain_offline", kind, x, y,
                                       (draws,), (S,))
    gammas = torch.empty((draws.shape[0], 3, n), dtype=x.dtype,
                         device=x.device)
    out = torch.empty_like(x)
    launch("and_level", _OFFLINE[x.dtype], x.device, CHAIN_KINDS[kind],
           x.data_ptr(), None if y is None else y.data_ptr(),
           draws.data_ptr(), S, arg & (2**64 - 1), gammas.data_ptr(),
           out.data_ptr(), n)
    return gammas, out


def and_chain_online_cuda(kind: str, x, y, lamz, gammas,
                          arg: int = 0) -> torch.Tensor:
    """The ``and_chain_online`` kernel: the chain's online run in one
    launch."""
    (x, y, lamz, gammas), n = _split_operands(
        "and_chain_online", kind, x, y, (lamz, gammas), (3, 3))
    out = torch.empty_like(x)
    launch("and_level", _ONLINE[x.dtype], x.device, CHAIN_KINDS[kind],
           x.data_ptr(), None if y is None else y.data_ptr(),
           lamz.data_ptr(), gammas.data_ptr(), arg & (2**64 - 1),
           out.data_ptr(), n)
    return out


def ppa_msb(x, y, lamz_levels, zero_levels, and_level) -> torch.Tensor:
    """msb(x + y) per word of the (n,) public words x, y, through
    log2(ell) + 1 levels of `and_level` (each AND on stacks whose lambdas
    are 0, with level lvl's lamz_levels[lvl] / zero_levels[lvl], (3, n)
    each; zero shares must XOR to 0 for the sum to be right)."""
    ell = width_of(x.dtype)
    n = x.shape[0]
    zero3 = torch.zeros((3, n), dtype=x.dtype, device=x.device)

    def AND(a, b, lvl):
        out = and_level(torch.cat([a.unsqueeze(0), zero3]),
                        torch.cat([b.unsqueeze(0), zero3]),
                        lamz_levels[lvl], zero_levels[lvl])
        return out[0] ^ out[1] ^ out[2] ^ out[3]

    g = AND(x, y, 0)
    p = x ^ y
    for k in range(int(math.log2(ell))):
        half = 1 << k
        bnd, upper = (signed(m, ell) for m in bit_masks(ell, k))
        gb = _smear((g & bnd) << 1, half)
        pb = _smear((p & bnd) << 1, half)
        pu = p & upper
        g = g ^ AND(pu, gb, k + 1)
        p = (p & ~upper) ^ AND(pu, pb, k + 1)
    s = x ^ y ^ (g << 1)
    return lshr(s, ell - 1) & 1


def ppa_msb_cuda(x, y, lamz_levels, zero_levels) -> torch.Tensor:
    """The ``ppa_msb`` kernel: ``ppa_msb(x, y, lamz_levels, zero_levels,
    and_level_plain)`` in one launch; x, y (n,), the levels (L, 3, n) with
    L >= log2(ell) + 1 (the first log2(ell) + 1 are read)."""
    n = x.shape[-1]
    L = int(math.log2(width_of(x.dtype))) + 1
    if (x.shape != (n,) or y.shape != (n,) or lamz_levels.dim() != 3
            or lamz_levels.shape[0] < L
            or lamz_levels.shape[1:] != (3, n)
            or zero_levels.shape != lamz_levels.shape):
        raise ValueError(
            f"ppa_msb takes x, y (n,) and levels ({L}, 3, n), got "
            f"{tuple(x.shape)}, {tuple(y.shape)}, "
            f"{tuple(lamz_levels.shape)}, {tuple(zero_levels.shape)}")
    ins = [t.contiguous() for t in (x, y, lamz_levels[:L], zero_levels[:L])]
    check_operands(*ins)
    if x.dtype not in _MSB:
        raise ValueError(f"ppa_msb takes int64/int32 words, got {x.dtype}")
    out = torch.empty_like(ins[0])
    launch("and_level", _MSB[x.dtype], x.device, *(t.data_ptr() for t in ins),
           out.data_ptr(), n)
    return out
