"""Counter-mode ``squares`` PRF stream: the Hopper kernel and its plain
PyTorch version (``repro/kernels/prf_mask.py``).

The plain version is ``core.prf.squares_stream``, the function every
lambda and zero-share draw is defined by; the kernel
(``csrc/prf_mask.cu``) computes the same words on the card.
"""
from __future__ import annotations

import torch

from ..core.prf import squares_stream as prf_mask_plain  # noqa: F401
from .build import check_operands, launch


def prf_mask_cuda(key64: int, n: int, counter0: int, device) -> torch.Tensor:
    """(n,) int64 stream words from the ``prf_mask`` kernel on `device`."""
    out = torch.empty(n, dtype=torch.int64, device=device)
    check_operands(out)
    launch("prf_mask", "prf_mask_u64", out.device, out.data_ptr(),
           key64 & ((1 << 64) - 1), counter0, n)
    return out
