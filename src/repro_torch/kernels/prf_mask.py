"""Counter-mode ``squares`` PRF stream: the Hopper kernel and its plain
PyTorch versions (``repro/kernels/prf_mask.py``).

The stream itself is ``core.prf.squares_stream`` (``prf_mask_plain``), the
function every lambda and zero-share draw is defined by.  The kernel
(``csrc/prf_mask.cu``) draws a whole group of up to ``MAX_STREAMS``
protocol streams in one launch and derives each stream's squares key on
the card; its plain version ``prf_mask_group_plain`` is the per-stream
``core.prf.prf_bits`` / ``prf_bounded`` sequence.

A stream is given as ``(key_data, counter, n, shift)``: the subset key's
two uint32 words (``ThreefryKey.data``), the protocol counter, the word
count and the logical right shift of each word (0, or ell - bits for a
bounded draw).  Both versions return one flat buffer of ring words, the
streams one after the other.
"""
from __future__ import annotations

import ctypes
import struct
import threading

import torch

from ..core.prf import ThreefryKey, prf_bits, prf_bounded
from ..core.prf import squares_stream as prf_mask_plain  # noqa: F401
from ..core.ring import RING32, RING64
from .build import check_operands, launch

MAX_STREAMS = 120        # kMaxStreams of the kernel
TILE_WORDS = 128         # kTileWords: 32 lanes x 4 words

_M32 = 0xFFFFFFFF
# PrfGroup's header (count, misalign, tiles, per: set by the launcher) and
# a PrfStream (key0, key1, counter, shift, offset, n, first_tile) of
# csrc/prf_mask.cu
_HEADER = struct.Struct("<iIII")
_STREAM = struct.Struct("<IIIIqII")
_TABLE_BYTES = _HEADER.size + MAX_STREAMS * _STREAM.size

_RING = {torch.int64: RING64, torch.int32: RING32}
_SYMBOL = {torch.int64: "prf_mask_group_u64",
           torch.int32: "prf_mask_group_u32"}
# one descriptor table a thread (a pipelined server's dealer thread draws
# beside its consumer), filled in place for every launch
_TABLES = threading.local()


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


def describe_group(streams, elsize: int, misalign: int) -> tuple:
    """(table, tiles): the kernel's descriptor table for `streams` drawn
    into an output whose first word lies `misalign` words past a 16-byte
    boundary (words of `elsize` bytes), filled into this thread's table
    (a ctypes buffer), and the group's tile count.  A stream's tiles lie on
    the output's 16-byte grid: its first tile starts head = (misalign +
    offset) mod (16 / elsize) words before it."""
    if not 1 <= len(streams) <= MAX_STREAMS:
        raise ValueError(f"a grouped draw takes 1 to {MAX_STREAMS} streams, "
                         f"got {len(streams)}")
    table = getattr(_TABLES, "table", None)
    if table is None:
        table = _TABLES.table = ctypes.create_string_buffer(_TABLE_BYTES)
    vec, ell = 16 // elsize, 8 * elsize
    off = tiles = 0
    at = _HEADER.size
    for (k0, k1), ctr, n, shift in streams:
        if not 0 <= shift < ell or not 0 <= n < 2**32:
            raise ValueError(f"stream of {n} words shifted by {shift}: "
                             f"shift must lie in [0, {ell}), n below 2^32")
        _STREAM.pack_into(table, at, k0, k1, ctr & _M32, shift, off, n,
                          tiles)
        if n:
            tiles += -(-((misalign + off) % vec + n) // TILE_WORDS)
        off += n
        at += _STREAM.size
    _HEADER.pack_into(table, 0, len(streams), misalign, tiles, 0)
    return table, tiles


def launch_group(streams, out: torch.Tensor) -> bool:
    """ONE ``prf_mask`` launch of `streams` into `out` (a contiguous
    int64/int32 CUDA tensor of their total length, not checked here);
    False, with no launch, when every stream is empty."""
    elsize = out.element_size()
    table, tiles = describe_group(streams, elsize,
                                  out.data_ptr() // elsize % (16 // elsize))
    if not tiles:
        return False
    launch("prf_mask", _SYMBOL[out.dtype], out.device, out.data_ptr(),
           ctypes.addressof(table))
    return True


def prf_mask_group_cuda(streams, out: torch.Tensor) -> torch.Tensor:
    """The same words from ONE ``prf_mask`` launch (1 to MAX_STREAMS
    streams), written into `out`: a contiguous int64/int32 CUDA tensor of
    the streams' total length."""
    check_operands(out)
    if out.dtype not in _SYMBOL:
        raise ValueError(f"prf_mask writes int64/int32 words, got "
                         f"{out.dtype}")
    total = sum(n for _, _, n, _ in streams)
    if out.numel() != total:
        raise ValueError(f"out holds {out.numel()} words, the streams "
                         f"{total}")
    launch_group(streams, out)
    return out
