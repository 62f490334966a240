"""Counter-mode ``squares`` PRF stream: the Hopper kernel and its plain
PyTorch versions (``repro/kernels/prf_mask.py``).

The stream itself is ``core.prf.squares_stream`` (``prf_mask_plain``), the
function every lambda and zero-share draw is defined by.  The kernel
(``csrc/prf_mask.cu``) draws up to ``MAX_STREAMS`` protocol streams in one
launch and derives each stream's squares key on the card; its plain version
``prf_mask_group_plain`` is the per-stream ``core.prf.prf_bits`` /
``prf_bounded`` sequence.

A stream is given as ``(key_data, counter, n, shift)``: the subset key's
two uint32 words (``ThreefryKey.data``), the protocol counter, the word
count and the logical right shift of each word (0, or ell - bits for a
bounded draw).  Both versions return one flat buffer of ring words, the
streams one after the other.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.prf import ThreefryKey, prf_bits, prf_bounded
from ..core.prf import squares_stream as prf_mask_plain  # noqa: F401
from ..core.ring import RING32, RING64
from .build import check_operands, launch

MAX_STREAMS = 8          # kMaxStreams of the kernel

_M32 = 0xFFFFFFFF


class _Stream(ctypes.Structure):
    _fields_ = [("key0", ctypes.c_uint32), ("key1", ctypes.c_uint32),
                ("counter", ctypes.c_uint32), ("shift", ctypes.c_uint32),
                ("offset", ctypes.c_int64), ("n", ctypes.c_int64)]


class _Group(ctypes.Structure):
    _fields_ = [("count", ctypes.c_int32), ("pad", ctypes.c_int32),
                ("s", _Stream * MAX_STREAMS)]


_RING = {torch.int64: RING64, torch.int32: RING32}
_SYMBOL = {torch.int64: "prf_mask_group_u64",
           torch.int32: "prf_mask_group_u32"}


def prf_mask_group_plain(streams, dtype: torch.dtype,
                         device=None) -> torch.Tensor:
    """The streams' words, one after the other, in `dtype` (CPU): each
    stream is ``core.prf``'s ``prf_bits``, or ``prf_bounded`` to
    ell - shift bits."""
    ring = _RING[dtype]
    parts = [prf_bits(ThreefryKey(tuple(kd)), ctr, (n,), ring, device)
             if shift == 0 else
             prf_bounded(ThreefryKey(tuple(kd)), ctr, (n,), ring,
                         ring.ell - shift, device)
             for kd, ctr, n, shift in streams]
    if not parts:
        return torch.empty(0, dtype=dtype, device=device)
    return torch.cat(parts)


def prf_mask_group_cuda(streams, out: torch.Tensor) -> torch.Tensor:
    """The same words from ONE ``prf_mask`` launch (1 to MAX_STREAMS
    streams), written into `out`: a contiguous int64/int32 CUDA tensor of
    the streams' total length."""
    if not 1 <= len(streams) <= MAX_STREAMS:
        raise ValueError(f"a grouped draw takes 1 to {MAX_STREAMS} streams, "
                         f"got {len(streams)}")
    check_operands(out)
    if out.dtype not in _SYMBOL:
        raise ValueError(f"prf_mask writes int64/int32 words, got "
                         f"{out.dtype}")
    ell = torch.iinfo(out.dtype).bits
    g = _Group(count=len(streams))
    off = 0
    for s, (kd, ctr, n, shift) in zip(g.s, streams):
        if not 0 <= shift < ell:
            raise ValueError(f"shift {shift} outside [0, {ell})")
        s.key0, s.key1 = kd
        s.counter, s.shift, s.offset, s.n = ctr & _M32, shift, off, n
        off += n
    if out.numel() != off:
        raise ValueError(f"out holds {out.numel()} words, the streams "
                         f"{off}")
    launch("prf_mask", _SYMBOL[out.dtype], out.device, out.data_ptr(),
           ctypes.addressof(g))
    return out
