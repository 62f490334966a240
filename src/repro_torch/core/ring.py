"""Ring Z_{2^ell} arithmetic and fixed-point encoding on torch tensors.

The counterpart of ``repro/core/ring.py``.  torch has no arithmetic on
``uint64``/``uint32``, so ring words are stored in the signed type of the
same width (``int64`` for ell = 64, ``int32`` for ell = 32): add, sub, neg
and mul wrap mod 2^ell exactly as the unsigned ring does, and the bits are
the same words.  Two things differ from unsigned storage and are handled
here:

  * ``>>`` on a signed tensor is arithmetic, so a *logical* right shift
    (``lshr``, ``Ring.msb``) masks off the sign-extended bits;
  * a Python constant at or above 2^(ell-1) must become its signed twin
    (``signed``) before it meets a tensor.

``words_from_numpy`` / ``words_to_numpy`` move words between the JAX
package's unsigned ndarrays and this package's tensors by a bit-preserving
``view``, so the tests compare ring words exactly.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

_TORCH = {64: torch.int64, 32: torch.int32}
_NP_UNSIGNED = {64: np.uint64, 32: np.uint32}
_NP_SIGNED = {64: np.int64, 32: np.int32}


def signed(value: int, ell: int) -> int:
    """The signed twin of a Python int taken mod 2^ell (same ell bits)."""
    value &= (1 << ell) - 1
    return value - (1 << ell) if value >> (ell - 1) else value


def width_of(dtype: torch.dtype) -> int:
    """Ring width of a storage dtype."""
    for ell, dt in _TORCH.items():
        if dt == dtype:
            return ell
    raise TypeError(f"{dtype} is not a ring storage type")


def lshr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of ring words by a constant k."""
    if k == 0:
        return x
    ell = width_of(x.dtype)
    return (x >> k) & ((1 << (ell - k)) - 1)


def bit_planes(word: torch.Tensor, lo: int, hi: int, dim: int = 0
               ) -> torch.Tensor:
    """Bits lo..hi-1 of each word as 0/1 words, stacked on a new axis
    `dim`.  A bit at or past the word's width is 0, as the JAX package's
    logical shift of unsigned words gives it (an int32 ``>>`` by 32 or more
    would give the sign bit)."""
    ell = width_of(word.dtype)
    planes = [(word >> i) & 1 for i in range(lo, min(hi, ell))]
    if hi > max(lo, ell):
        planes += [torch.zeros_like(word)] * (hi - max(lo, ell))
    return torch.stack(planes, dim=dim)


def words_from_numpy(a, device=None, copy: bool = True) -> torch.Tensor:
    """uint64/uint32 ndarray -> int64/int32 tensor with the same bits.
    ``copy=False`` lets a tensor on the CPU share a writable array's
    memory (a received frame's buffer, which nothing else holds)."""
    a = np.asarray(a, order="C")        # a 0-d array stays 0-d
    for ell, udt in _NP_UNSIGNED.items():
        if a.dtype == udt:
            a = a.view(_NP_SIGNED[ell])
            t = torch.from_numpy(a.copy() if copy else a)
            return t if device is None else t.to(device)
    raise TypeError(f"{a.dtype} is not an unsigned ring word type")


def words_to_numpy(t: torch.Tensor) -> np.ndarray:
    """int64/int32 tensor -> uint64/uint32 ndarray with the same bits."""
    ell = width_of(t.dtype)
    return t.detach().cpu().contiguous().numpy().view(_NP_UNSIGNED[ell])


def words_to_numpy_batch(tensors) -> list:
    """``words_to_numpy`` of each tensor (any other dtype keeps its own),
    with one device-to-host copy per (device, dtype) group, not one per
    tensor: the arrays are views into the group's one host buffer."""
    out: list = [None] * len(tensors)
    groups: dict = {}
    for i, t in enumerate(tensors):
        groups.setdefault((t.device, t.dtype), []).append(i)
    for (_, dtype), idx in groups.items():
        flat = torch.cat([tensors[i].detach().reshape(-1) for i in idx])
        host = flat.cpu().numpy()
        if dtype in _TORCH.values():
            host = host.view(_NP_UNSIGNED[width_of(dtype)])
        off = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = host[off:off + n].reshape(tuple(tensors[i].shape))
            off += n
    return out


@dataclasses.dataclass(frozen=True)
class Ring:
    """Configuration of the algebraic ring + fixed-point embedding."""

    ell: int = 64          # ring bit width (32 or 64)
    frac: int = 13         # fractional bits of the fixed-point embedding

    def __post_init__(self):
        if self.ell not in (32, 64):
            raise ValueError(f"unsupported ring width {self.ell}")
        if not 0 <= self.frac < self.ell - 1:
            raise ValueError(f"bad frac {self.frac} for ell {self.ell}")

    # --- dtypes -----------------------------------------------------------
    @property
    def dtype(self) -> torch.dtype:
        return _TORCH[self.ell]

    @property
    def scale(self) -> int:
        return 1 << self.frac

    # --- fixed point ------------------------------------------------------
    def encode(self, x, device=None) -> torch.Tensor:
        """float -> ring fixed point (round half to even, as jnp.round)."""
        x = torch.as_tensor(x, dtype=torch.float64, device=device)
        return torch.round(x * self.scale).to(self.dtype)

    def decode(self, v: torch.Tensor) -> torch.Tensor:
        """ring fixed point -> float64."""
        return v.to(torch.float64) / self.scale

    # --- ring ops (wrap mod 2^ell in the storage type) ----------------------
    def msb(self, a: torch.Tensor) -> torch.Tensor:
        """Most significant bit (the fixed-point sign) as 0/1 ring element."""
        return lshr(a, self.ell - 1)

    def truncate(self, a: torch.Tensor, bits: int | None = None):
        """Arithmetic (sign-preserving) right shift by `bits` (default frac)."""
        return a >> (self.frac if bits is None else bits)

    def low_bits(self, a: torch.Tensor, bits: int) -> torch.Tensor:
        """The low `bits` bits of each word."""
        return a & signed((1 << bits) - 1, self.ell)


RING64 = Ring(ell=64, frac=13)
RING32 = Ring(ell=32, frac=13)
