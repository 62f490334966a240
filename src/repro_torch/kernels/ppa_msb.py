"""One fused boolean AND level of the joint simulation, and the Sklansky
msb(x + y) loop over it: the Hopper kernel and its plain PyTorch version
(``repro/kernels/ppa_msb.py``).

    and_level(x, y, lamz, zero) -> (4, n): (m_z, lamz[0], lamz[1], lamz[2])

x, y are (4, n) bit-sliced share stacks (m, l1, l2, l3); lamz the (3, n)
fresh output lambdas; zero the (3, n) Pi_Zero shares that randomize the
gamma split, or None for zero shares (the component-collapsed joint
world).  XOR and AND are bitwise, so the kernel (``csrc/and_level.cu``)
equals the plain version word for word.

``ppa_msb`` is the Python loop of the whole msb(x + y) over public words:
log2(ell) + 1 AND levels with the Sklansky smear masks, each level one call
of the ``and_level`` it is given.
"""
from __future__ import annotations

import math

import torch

from ..core.algebra import bit_masks
from ..core.ring import lshr, signed, width_of
from .build import check_operands, launch

_SYMBOL = {torch.int64: "and_level_u64", torch.int32: "and_level_u32"}


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


def _smear(v: torch.Tensor, width: int) -> torch.Tensor:
    """Shift the isolated boundary bits up by one and copy each `width`
    positions leftward (OR-doubling)."""
    out = v << 1
    j = 1
    while j < width:
        out = out | (out << j)
        j <<= 1
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
        gb = _smear(g & bnd, half)
        pb = _smear(p & bnd, half)
        pu = p & upper
        g = g ^ AND(pu, gb, k + 1)
        p = (p & ~upper) ^ AND(pu, pb, k + 1)
    s = x ^ y ^ (g << 1)
    return lshr(s, ell - 1) & 1
