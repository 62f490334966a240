"""Shared-key setup and counter-mode PRF sampling (``repro/core/prf.py``).

Key management follows the JAX package exactly, so both packages draw the
same streams from the same seed: a master threefry2x32 key per runtime, one
subset key per party subset by ``fold_in``, one per-invocation 64-bit
``squares`` key by a further ``fold_in`` of the protocol counter.  That key
schedule runs on the host in Python ints (``ThreefryKey``): it is a few
dozen 32-bit operations per sample.  Only the ``squares`` stream itself,
one 64-bit word per element, runs on the device.

``threefry2x32`` below is a pure-integer twin of ``jax.random.key(seed)``,
``jax.random.fold_in``, ``jax.random.split`` and ``jax.random.key_data``
for the default threefry implementation (Salmon et al. 2011, 20 rounds, the rotation
schedule of Random123); the tests hold it against ``jax.random``.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable

import torch

from .ring import Ring, lshr, signed

PARTIES = (0, 1, 2, 3)

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl32(v: int, r: int) -> int:
    return ((v << r) | (v >> (32 - r))) & _M32


def threefry2x32(key: tuple, count: tuple) -> tuple:
    """Threefry-2x32 (20 rounds) of one counter pair under one key pair,
    all 32-bit Python ints -- the block function of ``jax.random``."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (count[0] + ks[0]) & _M32
    x1 = (count[1] + ks[1]) & _M32
    for step in range(5):
        for r in _ROTATIONS[step % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl32(x1, r) ^ x0
        x0 = (x0 + ks[(step + 1) % 3]) & _M32
        x1 = (x1 + ks[(step + 2) % 3] + step + 1) & _M32
    return x0, x1


@dataclasses.dataclass(frozen=True)
class ThreefryKey:
    """A threefry2x32 key: the two uint32 words ``jax.random.key_data``
    returns for the matching JAX key."""

    data: tuple

    @classmethod
    def from_seed(cls, seed: int) -> "ThreefryKey":
        """``jax.random.key(seed)`` for a 64-bit integer seed."""
        seed &= (1 << 64) - 1
        return cls(((seed >> 32) & _M32, seed & _M32))

    def fold_in(self, data: int) -> "ThreefryKey":
        """``jax.random.fold_in``: data is taken as a uint32."""
        return ThreefryKey(threefry2x32(self.data, (0, data & _M32)))

    def split(self, n: int) -> list:
        """``jax.random.split(key, n)`` under ``jax_threefry_partitionable``
        (JAX's default since 0.5): key i is the block function of the
        64-bit counter i, as (high, low) words."""
        return [ThreefryKey(threefry2x32(self.data, (i >> 32 & _M32,
                                                     i & _M32)))
                for i in range(n)]


def subset_id(subset: Iterable[int]) -> int:
    """Encode a party subset as a bitmask (e.g. {0,1} -> 0b0011)."""
    m = 0
    for p in subset:
        m |= 1 << p
    return m


class SetupKeys:
    """F_setup output of the joint simulation: one master key; each subset
    key is ``fold_in(master, subset_id)``, as the JAX package derives it.
    The joint simulation holds the master and derives every subset's
    stream (a party outside subset S could not predict S's stream)."""

    def __init__(self, master: ThreefryKey):
        self.master = master
        self._subset: dict = {}

    def subset_key(self, subset: Iterable[int]) -> ThreefryKey:
        sid = subset_id(subset)
        key = self._subset.get(sid)
        if key is None:
            key = self._subset[sid] = self.master.fold_in(sid)
        return key


def make_setup_keys(seed: int = 0) -> SetupKeys:
    return SetupKeys(ThreefryKey.from_seed(seed))


_GOLDEN = 0x9E3779B97F4A7C15


def squares_key(key: ThreefryKey, counter: int) -> int:
    """The per-invocation 64-bit ``squares`` key (an odd Python int below
    2^64) from a subset key and the statically allocated protocol counter."""
    hi, lo = key.fold_in(counter).data
    return (((hi << 32) | lo) ^ _GOLDEN) | 1


def squares_stream(key64: int, n: int, counter0: int = 0,
                   device=None) -> torch.Tensor:
    """Counter-mode ``squares`` PRF (Widynski 2020): (n,) int64 words, the
    bits of the JAX package's uint64 stream.  The plain PyTorch version of
    the ``prf_mask`` kernel: 4 rounds of ``x*x + y|z`` and a 32-bit rotate,
    with every right shift logical."""
    key = signed(key64, 64)
    ctr = torch.arange(counter0, counter0 + n, dtype=torch.int64,
                       device=device)
    x = ctr * key
    y = x
    z = y + key

    def rot32(v):
        return lshr(v, 32) | (v << 32)

    x = rot32(x * x + y)
    x = rot32(x * x + z)
    x = rot32(x * x + y)
    x = x * x + z
    t = x
    x = rot32(x)
    return t ^ lshr(x * x + y, 32)


def numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def prf_bits(key: ThreefryKey, counter: int, shape, ring: Ring,
             device=None) -> torch.Tensor:
    """F_k(counter) -> uniform ring elements of `shape` (counter-mode PRF).
    For ell = 32 each word keeps the low half of the 64-bit stream word, as
    the JAX package's ``astype(uint32)`` does."""
    out = squares_stream(squares_key(key, counter), numel(shape),
                         device=device)
    return out.reshape(tuple(shape)).to(ring.dtype)


def prf_bounded(key: ThreefryKey, counter: int, shape, ring: Ring,
                bits: int, device=None) -> torch.Tensor:
    """Uniform over [0, 2^bits) embedded in the ring (guarded BitExt)."""
    return lshr(prf_bits(key, counter, shape, ring, device), ring.ell - bits)
