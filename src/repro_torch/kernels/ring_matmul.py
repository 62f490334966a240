"""Ring matmul A @ B mod 2^ell: the Hopper kernel and its plain PyTorch
version (``repro/kernels/limb_matmul.py`` and ``mpc_matmul_fused.py``).

The plain version is ``torch.matmul`` on int64/int32 words, which wraps
mod 2^ell on the CPU.  PyTorch has no integer matmul on CUDA, so on the
card the kernel (``csrc/ring_matmul.cu``) is the only route.
"""
from __future__ import annotations

import torch

from .build import check_operands, launch

TILE = 64          # output tile edge of the kernel (kBM = kBN)
STEP_K = 16        # K step of the kernel (kBK)

_SYMBOL = {torch.int64: "ring_matmul_u64", torch.int32: "ring_matmul_u32"}


def ring_matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A @ B mod 2^ell in the storage type (CPU tensors)."""
    return torch.matmul(a, b)


def k_chunk(M: int, N: int, K: int, blocks_wanted: int) -> int:
    """K words per block: split K until the grid has about
    `blocks_wanted` blocks (a multiple of the kernel's K step)."""
    tiles = -(-M // TILE) * -(-N // TILE)
    splits = max(1, min(-(-blocks_wanted // tiles), -(-K // STEP_K)))
    return -(-(-(-K // splits)) // STEP_K) * STEP_K


def ring_matmul_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A (M, K) @ B (K, N) mod 2^ell by the ``ring_matmul`` kernel."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"ring_matmul takes (M, K) @ (K, N), got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    a, b = a.contiguous(), b.contiguous()
    check_operands(a, b)
    if a.dtype not in _SYMBOL:
        raise ValueError(f"ring_matmul takes int64/int32 words, got "
                         f"{a.dtype}")
    (M, K), N = a.shape, b.shape[1]
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    chunk = k_chunk(M, N, K, 2 * sms)
    # chunks of K meet in the output by atomic adds: start it at zero
    alloc = torch.zeros if K > chunk else torch.empty
    out = alloc((M, N), dtype=a.dtype, device=a.device)
    launch("ring_matmul", _SYMBOL[a.dtype], a.device, a.data_ptr(),
           b.data_ptr(), out.data_ptr(), M, N, K, chunk)
    return out
