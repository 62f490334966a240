"""Ring matmul A @ B mod 2^ell: the Hopper kernel and its plain PyTorch
versions (``repro/kernels/limb_matmul.py`` and ``mpc_matmul_fused.py``).

The plain version is ``torch.matmul`` on int64/int32 words, which wraps
mod 2^ell on the CPU.  PyTorch has no integer matmul on CUDA, so on the
card the kernel (``csrc/ring_matmul.cu``) is the only route.  It runs on
the int8 tensor cores: 8-bit limbs, the limb pairs that survive mod 2^ell,
s32 sums over K chunks short enough to stay exact.
``ring_matmul_limbs_plain`` is that arithmetic in plain PyTorch, so the
CPU tests can hold the limb decomposition and its bound against
``torch.matmul``; nothing on the main path calls it.

The batched entry (``ring_matmul_batched_cuda``) takes products with batch
dimensions on both sides, broadcast as ``torch.matmul`` broadcasts them,
in one launch of the same kernel (a 2-D product is its batch of one);
``ring_matmul_plain`` is its plain version too.
"""
from __future__ import annotations

import torch

from .build import check_operands, launch

TILE = 64          # output tile edge of the kernel (kBM = kBN)
STEP_K = 32        # K words per step of the kernel (kBK, one k32 wgmma)
LIMB_MAX = 255 * 255
S32_MAX = 2**31 - 1

_SYMBOL = {torch.int64: "ring_matmul_u64", torch.int32: "ring_matmul_u32"}
_BATCHED = {torch.int64: "ring_matmul_batched_u64",
            torch.int32: "ring_matmul_batched_u32"}
MAX_GRID_Z = 65535     # batch x K chunks of one launch (gridDim.z)


def max_k_chunk(ell: int) -> int:
    """Longest K chunk whose limb sums stay in [0, 2^31): a diagonal of
    the limb product sums at most ell / 8 pairs of 255^2 per K word
    (4,128 words for ell = 64, 8,256 for ell = 32; ``kMaxKChunk``)."""
    return S32_MAX // (ell // 8 * LIMB_MAX)


def ring_matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A @ B mod 2^ell in the storage type (CPU tensors), with
    ``torch.matmul``'s shapes: the plain version of both entries."""
    return torch.matmul(a, b)


def _limbs(x: torch.Tensor, ell: int) -> list:
    """The ell / 8 byte planes of ring words, as int64 values in [0, 256)."""
    x = x.to(torch.int64)
    return [(x >> (8 * i)) & 0xFF for i in range(ell // 8)]


def ring_matmul_limbs_plain(a: torch.Tensor, b: torch.Tensor,
                            k_chunk: int) -> torch.Tensor:
    """A @ B mod 2^ell by the kernel's arithmetic: 8-bit limbs, the pairs
    i + j < ell / 8, each diagonal's sum over one K chunk checked against
    the s32 bound, the shifted sums combined mod 2^ell."""
    ell = torch.iinfo(a.dtype).bits
    if not 0 < k_chunk <= max_k_chunk(ell):
        raise ValueError(f"k_chunk {k_chunk} outside (0, "
                         f"{max_k_chunk(ell)}] for ell = {ell}")
    la, lb = _limbs(a, ell), _limbs(b, ell)
    L, K = ell // 8, a.shape[1]
    out = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.int64)
    for k0 in range(0, K, k_chunk):
        ks = slice(k0, k0 + k_chunk)
        for s in range(L):
            t = sum(la[i][:, ks] @ lb[s - i][ks, :] for i in range(s + 1))
            if int(t.max()) > S32_MAX:
                raise AssertionError(f"diagonal {s} sum {int(t.max())} "
                                     f"leaves s32 at k_chunk {k_chunk}")
            out += t << (8 * s)
    return out.to(a.dtype)


def k_chunk(M: int, N: int, K: int, blocks_wanted: int,
            ell: int = 64) -> int:
    """K words per block: split K until the grid has at most
    `blocks_wanted` blocks (one a SM: one wave), in whole kernel steps,
    within the s32 bound."""
    tiles = -(-M // TILE) * -(-N // TILE)
    steps = -(-K // STEP_K)
    splits = max(1, min(blocks_wanted // tiles, steps))
    chunk = -(-steps // splits) * STEP_K
    return min(chunk, max_k_chunk(ell) // STEP_K * STEP_K)


_SMS: dict = {}


def _sm_count(device: torch.device) -> int:
    n = _SMS.get(device.index)
    if n is None:
        n = _SMS[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return n


def _check_words(*ts, contiguous: bool = True) -> None:
    check_operands(*ts, contiguous=contiguous)
    if ts[0].dtype not in _SYMBOL:
        raise ValueError(f"ring_matmul takes int64/int32 words, got "
                         f"{ts[0].dtype}")


def _batch_operand(x: torch.Tensor, batch: tuple) -> tuple:
    """(contiguous words, batch stride in words) of one operand of a
    batched product: stride 0 when every product reads the same matrix,
    else its matrices one after another (broadcast ones copied out)."""
    mat = tuple(x.shape[-2:])
    nb = 1
    for d in x.shape[:-2]:
        nb *= d
    if nb == 1:
        return x.reshape(mat).contiguous(), 0
    full = x.expand(batch + mat) if tuple(x.shape[:-2]) != batch else x
    return full.contiguous(), mat[0] * mat[1]


def ring_matmul_batched_cuda(a: torch.Tensor,
                             b: torch.Tensor) -> torch.Tensor:
    """A [..., M, K] @ B [..., K, N] mod 2^ell by ONE launch of the batched
    ``ring_matmul`` kernel, batch dimensions broadcast as in
    ``torch.matmul``."""
    if a.dim() < 2 or b.dim() < 2 or a.shape[-1] != b.shape[-2]:
        raise ValueError(f"ring_matmul_batched takes [..., M, K] @ "
                         f"[..., K, N], got {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    _check_words(a, b, contiguous=False)
    batch = tuple(torch.broadcast_shapes(a.shape[:-2], b.shape[:-2]))
    nb = 1
    for d in batch:
        nb *= d
    (M, K), N = a.shape[-2:], b.shape[-1]
    a3, a_stride = _batch_operand(a, batch)
    b3, b_stride = _batch_operand(b, batch)
    chunk = k_chunk(M, N, K, max(1, _sm_count(a.device) // max(nb, 1)),
                    torch.iinfo(a.dtype).bits)
    chunks = -(-K // chunk)
    if nb * chunks > MAX_GRID_Z:
        raise ValueError(f"ring_matmul_batched: {nb} products x {chunks} K "
                         f"chunks exceed one launch's {MAX_GRID_Z}")
    alloc = torch.zeros if chunks > 1 else torch.empty
    out = alloc(batch + (M, N), dtype=a.dtype, device=a.device)
    launch("ring_matmul", _BATCHED[a.dtype], a.device, a3.data_ptr(),
           b3.data_ptr(), out.data_ptr(), nb, M, N, K, chunk, a_stride,
           b_stride)
    return out


def ring_matmul_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A (M, K) @ B (K, N) mod 2^ell by the ``ring_matmul`` kernel."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"ring_matmul takes (M, K) @ (K, N), got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    a, b = a.contiguous(), b.contiguous()
    _check_words(a, b)
    (M, K), N = a.shape, b.shape[1]
    chunk = k_chunk(M, N, K, _sm_count(a.device),
                    torch.iinfo(a.dtype).bits)
    # chunks of K meet in the output by atomic adds: start it at zero
    alloc = torch.zeros if K > chunk else torch.empty
    out = alloc((M, N), dtype=a.dtype, device=a.device)
    launch("ring_matmul", _SYMBOL[a.dtype], a.device, a.data_ptr(),
           b.data_ptr(), out.data_ptr(), M, N, K, chunk)
    return out
