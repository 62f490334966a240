"""Share containers of the joint simulation (``repro/core/shares.py``).

Arithmetic [[v]]-sharing (paper III-A): m_v = v + lambda_v with
lambda = l1 + l2 + l3; P1, P2, P3 know m_v, each P_i misses l_i, P0 knows
all l_i.  The joint simulation stores the 4 distinct values as one stacked
tensor ``data`` of shape (4, *shape): data[0] = m_v, data[1:] = l1..l3.

Boolean [[v]]^B-sharing is identical with XOR replacing +; ring words carry
ell independent bit positions (bit-sliced), so word ops act on all bit
planes at once.

Linear gates act component-wise on the stack, so they are single tensor
ops.  Words are int64 / int32 (``core.ring``): add, sub, neg and mul wrap
mod 2^ell, and the boolean right shift is logical (``lshr``).
"""
from __future__ import annotations

import dataclasses

import torch

from ..kernels import ops
from .ring import Ring, lshr, signed, width_of

NCOMP = 4  # m, l1, l2, l3


def _const(c, like: torch.Tensor) -> torch.Tensor:
    """A public constant or array as words of `like`'s type and device."""
    if isinstance(c, int):
        c = signed(c, width_of(like.dtype))
    return torch.as_tensor(c).to(dtype=like.dtype, device=like.device)


def _matmul_last_first(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Contract a's last axis with w's first (``dot_general`` over one
    axis pair) as ONE 2-D ring matmul of the flattened operands."""
    out = ops.ring_matmul(a.reshape(-1, a.shape[-1]).contiguous(),
                          w.reshape(w.shape[0], -1).contiguous())
    return out.reshape(tuple(a.shape[:-1]) + tuple(w.shape[1:]))


def stack_components(m: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """The (4, *shape) share stack of m and the (3, *shape) lambdas."""
    return torch.cat([m.unsqueeze(0), lam])


@dataclasses.dataclass
class AShare:
    """Arithmetic [[.]]-share over Z_{2^ell}: data (4, *shape)."""

    data: torch.Tensor

    # -- views -------------------------------------------------------------
    @property
    def shape(self) -> tuple:
        return tuple(self.data.shape[1:])

    @property
    def ndim(self) -> int:
        return self.data.dim() - 1

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def m(self) -> torch.Tensor:
        return self.data[0]

    def lam(self, i: int) -> torch.Tensor:
        assert 1 <= i <= 3
        return self.data[i]

    @property
    def lam_sum(self) -> torch.Tensor:
        return self.data[1] + self.data[2] + self.data[3]

    def reveal(self) -> torch.Tensor:
        """Joint-simulation plaintext (Pi_Rec without the network)."""
        return self.data[0] - self.lam_sum

    # -- linear algebra (local ops, zero communication) --------------------
    def __add__(self, other):
        if isinstance(other, AShare):
            return AShare(self.data + other.data)
        d = self.data.clone()
        d[0] += _const(other, d)
        return AShare(d)

    __radd__ = __add__

    def __sub__(self, other):
        if isinstance(other, AShare):
            return AShare(self.data - other.data)
        d = self.data.clone()
        d[0] -= _const(other, d)
        return AShare(d)

    def __rsub__(self, other):
        return (-self) + other

    def __neg__(self):
        return AShare(-self.data)

    def mul_public(self, c) -> "AShare":
        """Multiply by a public *integer* (ring) constant/array."""
        c = _const(c, self.data)
        return AShare(self.data * c.unsqueeze(0) if c.dim()
                      else self.data * c)

    def matmul_public(self, w, right: bool = True) -> "AShare":
        """[[x]] @ W_pub (or W_pub @ [[x]] if right=False); local.  Goes
        through the ring matmul: with right=True the four components are
        one (4 * rows, k) @ (k, n) product."""
        w = _const(w, self.data)
        if right:
            return AShare(_matmul_last_first(self.data, w))
        return AShare(torch.stack([_matmul_last_first(w, self.data[k])
                                   for k in range(NCOMP)]))

    # -- shape ops ---------------------------------------------------------
    def reshape(self, *shape):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return AShare(self.data.reshape((NCOMP,) + tuple(shape)))

    def transpose(self, axes=None):
        if axes is None:
            axes = tuple(reversed(range(self.ndim)))
        return AShare(self.data.permute((0,) + tuple(a + 1 for a in axes)))

    def __getitem__(self, idx):
        if not isinstance(idx, tuple):
            idx = (idx,)
        return AShare(self.data[(slice(None),) + idx])

    def astype_ring(self, ring: Ring):
        return AShare(self.data.to(ring.dtype))


@dataclasses.dataclass
class BShare:
    """Boolean [[.]]^B-share: XOR-sharing, bit-sliced in ring words.

    ``nbits`` = number of valid bit positions (ell for full words, 1 for a
    single bit stored at bit 0).  Communication tallies use nbits, so a
    one-bit share costs 1 bit, not ell.
    """

    data: torch.Tensor
    nbits: int

    @property
    def shape(self) -> tuple:
        return tuple(self.data.shape[1:])

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def m(self) -> torch.Tensor:
        return self.data[0]

    def reveal(self) -> torch.Tensor:
        return self.data[0] ^ self.data[1] ^ self.data[2] ^ self.data[3]

    # XOR is the boolean world's addition: local.
    def __xor__(self, other):
        if isinstance(other, BShare):
            return BShare(self.data ^ other.data,
                          max(self.nbits, other.nbits))
        d = self.data.clone()
        d[0] ^= _const(other, d)
        return BShare(d, self.nbits)

    __rxor__ = __xor__

    def __invert__(self):
        """NOT = XOR with public all-ones (over valid bits)."""
        return self ^ ((1 << self.nbits) - 1)

    def and_public(self, mask) -> "BShare":
        return BShare(self.data & _const(mask, self.data), self.nbits)

    def shift_left(self, k: int) -> "BShare":
        return BShare(self.data << k, self.nbits)

    def shift_right(self, k: int) -> "BShare":
        """Logical right shift of every component."""
        return BShare(lshr(self.data, k), self.nbits)

    def bit(self, k: int) -> "BShare":
        """Extract bit plane k as a 1-bit share."""
        return BShare((self.data >> k) & 1, 1)

    def __getitem__(self, idx):
        if not isinstance(idx, tuple):
            idx = (idx,)
        return BShare(self.data[(slice(None),) + idx], self.nbits)


def zeros_like_share(x: AShare) -> AShare:
    return AShare(torch.zeros_like(x.data))


def public_to_ashare(v: torch.Tensor, ring: Ring) -> AShare:
    """Non-interactive sharing of a value all of P1,P2,P3 know (paper IV-B
    a): lambda = 0, m = v.  Zero communication."""
    v = v.to(ring.dtype)
    z = torch.zeros((3,) + tuple(v.shape), dtype=ring.dtype, device=v.device)
    return AShare(stack_components(v, z))


def public_to_bshare(v: torch.Tensor, ring: Ring,
                     nbits: int | None = None) -> BShare:
    v = v.to(ring.dtype)
    z = torch.zeros((3,) + tuple(v.shape), dtype=ring.dtype, device=v.device)
    return BShare(stack_components(v, z),
                  ring.ell if nbits is None else nbits)
