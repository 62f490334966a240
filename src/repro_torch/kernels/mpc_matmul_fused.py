"""Fused local products of the collapsed joint simulation's secure matmul:
the Hopper kernel and its plain PyTorch version
(``repro/kernels/mpc_matmul_fused.py``).

    mpc_matmul_fused(mx, lx, my, ly) -> (mm, cross, gamma)
        mm    = mx @ my
        cross = lx_sum @ my + mx @ ly_sum
        gamma = lx_sum @ ly_sum

mod 2^ell, for mx (M, K), lx (3, M, K), my (K, N), ly (3, K, N) and the
lambda sums over the 3-stacks.  The kernel (``csrc/mpc_matmul_fused.cu``)
reads each operand once for all three products.
"""
from __future__ import annotations

import torch

from .build import check_operands, launch
from .ring_matmul import k_chunk, ring_matmul_plain

_SYMBOL = {torch.int64: "mpc_matmul_fused_u64",
           torch.int32: "mpc_matmul_fused_u32"}


def mpc_matmul_fused_plain(mx, lx, my, ly) -> tuple:
    """The three products by ``ring_matmul_plain`` (CPU tensors)."""
    lxs = lx[0] + lx[1] + lx[2]
    lys = ly[0] + ly[1] + ly[2]
    mm = ring_matmul_plain(mx, my)
    cross = ring_matmul_plain(lxs, my) + ring_matmul_plain(mx, lys)
    gamma = ring_matmul_plain(lxs, lys)
    return mm, cross, gamma


def mpc_matmul_fused_cuda(mx, lx, my, ly) -> tuple:
    """(mm, cross, gamma) by the ``mpc_matmul_fused`` kernel."""
    if (mx.dim() != 2 or my.dim() != 2 or mx.shape[1] != my.shape[0]
            or lx.shape != (3,) + tuple(mx.shape)
            or ly.shape != (3,) + tuple(my.shape)):
        raise ValueError(
            f"mpc_matmul_fused takes mx (M, K), lx (3, M, K), my (K, N), "
            f"ly (3, K, N), got {tuple(mx.shape)}, {tuple(lx.shape)}, "
            f"{tuple(my.shape)}, {tuple(ly.shape)}")
    mx, lx, my, ly = (t.contiguous() for t in (mx, lx, my, ly))
    check_operands(mx, lx, my, ly)
    if mx.dtype not in _SYMBOL:
        raise ValueError(f"mpc_matmul_fused takes int64/int32 words, got "
                         f"{mx.dtype}")
    (M, K), N = mx.shape, my.shape[1]
    sms = torch.cuda.get_device_properties(mx.device).multi_processor_count
    chunk = k_chunk(M, N, K, 2 * sms)
    # chunks of K meet in the outputs by atomic adds: start them at zero
    alloc = torch.zeros if K > chunk else torch.empty
    out = alloc((3, M, N), dtype=mx.dtype, device=mx.device)
    launch("mpc_matmul_fused", _SYMBOL[mx.dtype], mx.device, mx.data_ptr(),
           lx.data_ptr(), my.data_ptr(), ly.data_ptr(), out.data_ptr(), M,
           N, K, chunk)
    return out[0], out[1], out[2]
