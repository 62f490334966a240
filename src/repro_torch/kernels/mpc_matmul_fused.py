"""Fused local products of the collapsed joint simulation's secure matmul:
the Hopper kernel and its plain PyTorch versions
(``repro/kernels/mpc_matmul_fused.py``).

    mpc_matmul_fused(mx, lx, my, ly) -> (mm, cross, gamma_stack)
        mm    = mx @ my
        cross = lx_sum @ my + mx @ ly_sum
        gamma_stack = [lx_sum @ ly_sum, 0, 0]

mod 2^ell, for mx (M, K), lx (3, M, K), my (K, N), ly (3, K, N) and the
lambda sums over the 3-stacks.  The three results are views of one zeroed
(5, M, N) buffer, so the collapsed gamma stack costs no copy.  The kernel
(``csrc/mpc_matmul_fused.cu``) runs the ring matmul's int8 tensor-core limb
core over the four quadrants (mx | lx_sum) x (my | ly_sum) in one launch,
forming the lambda sums as it splits the tiles.
``mpc_matmul_fused_limbs_plain`` is that arithmetic in plain PyTorch for
the CPU tests; nothing on the main path calls it.
"""
from __future__ import annotations

import torch

from .build import check_operands, launch
from .ring_matmul import (_sm_count, k_chunk, ring_matmul_limbs_plain,
                          ring_matmul_plain)

_SYMBOL = {torch.int64: "mpc_matmul_fused_u64",
           torch.int32: "mpc_matmul_fused_u32"}


def _views(out: torch.Tensor) -> tuple:
    return out[0], out[1], out[2:]


def _combine(quadrant, M: int, N: int, dtype, device) -> tuple:
    """(mm, cross, [gamma, 0, 0]) from the quadrant products
    quadrant(a, b), a and b in (0: m, 1: lambda sum)."""
    out = torch.zeros((5, M, N), dtype=dtype, device=device)
    out[0] = quadrant(0, 0)
    out[1] = quadrant(1, 0) + quadrant(0, 1)
    out[2] = quadrant(1, 1)
    return _views(out)


def mpc_matmul_fused_plain(mx, lx, my, ly) -> tuple:
    """The three products by ``ring_matmul_plain`` (CPU tensors)."""
    xs = (mx, lx[0] + lx[1] + lx[2])
    ys = (my, ly[0] + ly[1] + ly[2])
    return _combine(lambda i, j: ring_matmul_plain(xs[i], ys[j]),
                    mx.shape[0], my.shape[1], mx.dtype, mx.device)


def mpc_matmul_fused_limbs_plain(mx, lx, my, ly, k_chunk: int) -> tuple:
    """The kernel's arithmetic: the lambda sums wrapped in the word type,
    each quadrant by ``ring_matmul_limbs_plain`` over K chunks of
    `k_chunk` words (its s32 check included), the quadrants combined."""
    xs = (mx, lx[0] + lx[1] + lx[2])
    ys = (my, ly[0] + ly[1] + ly[2])
    return _combine(
        lambda i, j: ring_matmul_limbs_plain(xs[i], ys[j], k_chunk),
        mx.shape[0], my.shape[1], mx.dtype, mx.device)


def quadrant_chunk(M: int, N: int, K: int, sms: int, ell: int = 64) -> int:
    """The wrapper's K words a block: the four quadrants share the card, a
    quarter of the SMs each (``ring_matmul.k_chunk``)."""
    return k_chunk(M, N, K, sms // 4, ell)


def mpc_matmul_fused_cuda(mx, lx, my, ly, chunk: int | None = None
                          ) -> tuple:
    """(mm, cross, [gamma, 0, 0]) by the ``mpc_matmul_fused`` kernel: one
    fill of the (5, M, N) output and one launch.  `chunk`: K words a
    block (a multiple of 32 within the exactness bound), or None for the
    split that fills the card."""
    if (mx.dim() != 2 or my.dim() != 2 or mx.shape[1] != my.shape[0]
            or lx.shape != (3,) + tuple(mx.shape)
            or ly.shape != (3,) + tuple(my.shape)):
        raise ValueError(
            f"mpc_matmul_fused takes mx (M, K), lx (3, M, K), my (K, N), "
            f"ly (3, K, N), got {tuple(mx.shape)}, {tuple(lx.shape)}, "
            f"{tuple(my.shape)}, {tuple(ly.shape)}")
    # the path's operands are share stacks' views, already contiguous
    mx, lx, my, ly = (t.contiguous() for t in (mx, lx, my, ly))
    check_operands(mx, lx, my, ly)
    if mx.dtype not in _SYMBOL:
        raise ValueError(f"mpc_matmul_fused takes int64/int32 words, got "
                         f"{mx.dtype}")
    (M, K), N = mx.shape, my.shape[1]
    if chunk is None:
        chunk = quadrant_chunk(M, N, K, _sm_count(mx.device),
                               torch.iinfo(mx.dtype).bits)
    # quadrants and chunks meet in the outputs by atomic adds
    out = torch.zeros((5, M, N), dtype=mx.dtype, device=mx.device)
    launch("mpc_matmul_fused", _SYMBOL[mx.dtype], mx.device, mx.data_ptr(),
           lx.data_ptr(), my.data_ptr(), ly.data_ptr(), out.data_ptr(), M,
           N, K, chunk)
    return _views(out)
