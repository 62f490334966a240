"""Grouped elementwise gamma-piece / online-part kernels and their plain
PyTorch versions (``repro/kernels/gamma_parts.py``):

    mult_terms(a, b, c, signs):  out[j] = sum_t signs[t] a[j,t] b[j,t] + c[j]
    and_terms(a, b, c):          out[j] = XOR_t (a[j,t] & b[j,t]) ^ c[j]

a, b are (J, T, n) stacked operand groups, c is (J, n).  Ring arithmetic
wraps in the storage type and XOR/AND are bitwise, so the kernels
(``csrc/gamma_parts.cu``) equal the plain versions word for word.
"""
from __future__ import annotations

import torch

from .build import check_operands, launch

_SUFFIX = {torch.int64: "u64", torch.int32: "u32"}


def mult_terms_plain(a, b, c, signs) -> torch.Tensor:
    acc = c
    for t, s in enumerate(signs):
        term = a[:, t] * b[:, t]
        acc = acc - term if s < 0 else acc + term
    return acc


def and_terms_plain(a, b, c) -> torch.Tensor:
    acc = c
    for t in range(a.shape[1]):
        acc = acc ^ (a[:, t] & b[:, t])
    return acc


def _grouped_cuda(symbol: str, a, b, c, *extra) -> torch.Tensor:
    if a.dim() != 3 or b.shape != a.shape or c.shape != (a.shape[0],
                                                         a.shape[2]):
        raise ValueError(f"{symbol} takes a, b (J, T, n) and c (J, n), got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}, "
                         f"{tuple(c.shape)}")
    a, b, c = a.contiguous(), b.contiguous(), c.contiguous()
    check_operands(a, b, c)
    if a.dtype not in _SUFFIX:
        raise ValueError(f"{symbol} takes int64/int32 words, got {a.dtype}")
    J, T, n = a.shape
    out = torch.empty_like(c)
    launch("gamma_parts", f"{symbol}_{_SUFFIX[a.dtype]}", a.device,
           a.data_ptr(), b.data_ptr(), c.data_ptr(), out.data_ptr(), J, T, n,
           *extra)
    return out


def mult_terms_cuda(a, b, c, signs) -> torch.Tensor:
    neg_mask = sum(1 << t for t, s in enumerate(signs) if s < 0)
    if len(signs) != a.shape[1] or len(signs) > 32:
        raise ValueError(f"mult_terms: {len(signs)} signs for T = "
                         f"{a.shape[1]}")
    return _grouped_cuda("mult_terms", a, b, c, neg_mask)


def and_terms_cuda(a, b, c) -> torch.Tensor:
    return _grouped_cuda("and_terms", a, b, c)
