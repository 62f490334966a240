"""Public wrappers of the Hopper kernels (``repro/kernels/ops.py``).

The runtime's ``"hopper"`` kernel backend calls the kernels only through
here.  Each wrapper takes its kernel's plain PyTorch version for tensors
that lie on the CPU, and launches the kernel for CUDA tensors -- it never
falls back from one to the other.  Each kernel carries a launch count that
its wrapper raises by one where it launches it, and nowhere else, so a run
can show that its main path went through the kernels.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.prf import numel as prf_numel
from .gamma_parts import (MAX_GROUPS, and_terms_group_plain,
                          and_terms_plain, group_outputs, group_shape,
                          mult_terms_group_plain, mult_terms_plain,
                          terms_group_cuda)
from .mpc_matmul_fused import mpc_matmul_fused_cuda, mpc_matmul_fused_plain
from .ppa_msb import (and_chain_offline_cuda, and_chain_offline_plain,
                      and_chain_online_cuda, and_chain_online_plain,
                      and_level_cuda, and_level_plain, ppa_add_cuda,
                      ppa_add_plain, ppa_msb, ppa_msb_cuda, prefix_or_cuda,
                      prefix_or_plain)
from .prf_mask import launch_group as prf_launch_group
from .prf_mask import prf_mask_group_plain
from .ring_matmul import (ring_matmul_batched_cuda, ring_matmul_cuda,
                          ring_matmul_plain)

_CSRC = "src/repro_torch/kernels/csrc/"


@dataclasses.dataclass
class Kernel:
    """One hand-written kernel as a run reports it."""

    name: str
    source: str            # CUDA source, path in the repo
    replaces: str          # the TPU (Pallas) kernel, file:line
    launches: int = 0
    streams: int = 0       # prf_mask: PRF streams its launches drew
    # wrapper calls on either device, so a CPU run counts what the card
    # launches (one launch a call; mult_terms / and_terms one a call of
    # <= MAX_GROUPS groups)
    calls: int = 0


PRF_MASK = Kernel("prf_mask", _CSRC + "prf_mask.cu",
                  "src/repro/kernels/prf_mask.py:49")
RING_MATMUL = Kernel("ring_matmul", _CSRC + "ring_matmul.cu",
                     "src/repro/kernels/limb_matmul.py:79")
# kernel route K2: products with batch dimensions on both sides (the LM
# stack's attention and MoE experts), one launch each; they replace the
# JAX package's jnp.matmul, which no Pallas kernel computes
RING_MATMUL_BATCHED = Kernel("ring_matmul_batched", _CSRC + "ring_matmul.cu",
                             "src/repro/core/protocols.py:189")
MPC_MATMUL_GRID = Kernel("mpc_matmul_grid", _CSRC + "ring_matmul.cu",
                         "src/repro/kernels/mpc_matmul_fused.py:46")
MULT_TERMS = Kernel("mult_terms", _CSRC + "gamma_parts.cu",
                    "src/repro/kernels/gamma_parts.py:77")
AND_TERMS = Kernel("and_terms", _CSRC + "gamma_parts.cu",
                   "src/repro/kernels/gamma_parts.py:86")
MPC_MATMUL_FUSED = Kernel("mpc_matmul_fused", _CSRC + "mpc_matmul_fused.cu",
                          "src/repro/kernels/mpc_matmul_fused.py:72")
AND_LEVEL = Kernel("and_level", _CSRC + "and_level.cu",
                   "src/repro/kernels/ppa_msb.py:43")
# the whole msb(x + y) in one and_level.cu launch (its ppa_msb entry)
PPA_MSB = Kernel("ppa_msb", _CSRC + "and_level.cu",
                 "src/repro/kernels/ppa_msb.py:65")
KERNELS = (PRF_MASK, RING_MATMUL, RING_MATMUL_BATCHED, MPC_MATMUL_GRID,
           MPC_MATMUL_FUSED, MULT_TERMS, AND_TERMS, AND_LEVEL, PPA_MSB)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = k.streams = k.calls = 0


def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


def lambda_masks_group(streams, dtype: torch.dtype, device,
                       flat: bool = False):
    """The protocols' PRF draws, ONE launch per call on the card (up to
    MAX_STREAMS streams).  `streams`: (key_data, counter, shape, shift)
    each -- the subset key's two uint32 words, the protocol counter, the
    shape and the logical right shift of each word; returns one tensor of
    ring words (`dtype`) per stream, views of one buffer -- or, with
    `flat`, that buffer, the streams' words one after another."""
    PRF_MASK.calls += 1
    sized = [(kd, ctr, prf_numel(shape), shift)
             for kd, ctr, shape, shift in streams]
    device = torch.device(device)
    if device.type == "cpu":
        buf = prf_mask_group_plain(sized, dtype, device)
    else:
        if device.type != "cuda":
            raise ValueError(f"kernel operands must be CUDA tensors, got "
                             f"{device}")
        buf = torch.empty(sum(n for _, _, n, _ in sized), dtype=dtype,
                          device=device)
        if prf_launch_group(sized, buf):
            PRF_MASK.launches += 1
        PRF_MASK.streams += len(sized)
    if flat:
        return buf
    return [part.view(tuple(shape)) for part, (_, _, shape, _) in
            zip(buf.split([n for _, _, n, _ in sized]), streams)]


def ring_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A @ B mod 2^ell with ``torch.matmul``'s shapes: (M, K) @ (K, N), and
    [..., M, K] @ (K, N) as the one (prod(...) * M, K) @ (K, N) product,
    take the ring matmul kernel; products with batch dimensions on the
    right take the batched kernel (one launch each)."""
    if b.dim() == 2 and a.dim() >= 2:
        RING_MATMUL.calls += 1
        if _on_cpu(a):
            return ring_matmul_plain(a, b)
        out = ring_matmul_cuda(a.reshape(-1, a.shape[-1]), b)
        RING_MATMUL.launches += 1
        return out.view(tuple(a.shape[:-1]) + (b.shape[1],))
    RING_MATMUL_BATCHED.calls += 1
    if _on_cpu(a):
        return ring_matmul_plain(a, b)
    out = ring_matmul_batched_cuda(a, b)
    RING_MATMUL_BATCHED.launches += 1
    return out


def mpc_matmul_grid(xs, ys) -> list:
    """All-pairs quadrants [i][j] = xs[i] @ ys[j] mod 2^ell from ONE ring
    matmul of the row-stacked xs and the column-stacked ys (equal shapes
    within each list)."""
    MPC_MATMUL_GRID.calls += 1
    M, N = xs[0].shape[0], ys[0].shape[1]
    a = torch.cat(list(xs), dim=0)
    b = torch.cat(list(ys), dim=1)
    if _on_cpu(a):
        p = ring_matmul_plain(a, b)
    else:
        p = ring_matmul_cuda(a, b)
        MPC_MATMUL_GRID.launches += 1
    return [[p[i * M:(i + 1) * M, j * N:(j + 1) * N] for j in range(len(ys))]
            for i in range(len(xs))]


def _terms_groups(kernel: Kernel, xor: bool, groups, outs=None) -> list:
    """The grouped gamma-piece kernel over `groups`, MAX_GROUPS a launch:
    each launch counted on `kernel`.  `outs`: the groups' outputs, or None
    to allocate them as views of one buffer."""
    kernel.calls += 1
    if not groups:
        return []
    if _on_cpu(groups[0][0][0][0]):
        plain = and_terms_group_plain if xor else mult_terms_group_plain
        return plain(groups)
    if outs is None:
        first = groups[0][0][0][0]
        outs = group_outputs([group_shape(g) for g in groups], first.dtype,
                             first.device)
    for i in range(0, len(groups), MAX_GROUPS):
        if terms_group_cuda(xor, groups[i:i + MAX_GROUPS],
                            outs[i:i + MAX_GROUPS]):
            kernel.launches += 1
    return outs


def mult_terms_group(groups) -> list:
    """One tensor per ``(pairs, consts, signs)`` group: sum of the
    constants plus sum_t signs[t] * a_t * b_t mod 2^ell, over 1-3 operand
    pairs ``(a_t, b_t)``, 0-2 constants and +-1 signs, every operand
    broadcasting to the group's shape.  One launch per MAX_GROUPS groups;
    the outputs are views of one buffer."""
    return _terms_groups(MULT_TERMS, False, groups)


def and_terms_group(groups) -> list:
    """One tensor per ``(pairs, consts)`` group: XOR of the constants and
    of a_t & b_t over the pairs, on bit-packed words; as
    ``mult_terms_group``."""
    return _terms_groups(AND_TERMS, True,
                         [(pairs, consts, None) for pairs, consts in groups])


def _stacked_groups(a, b, c, signs) -> list:
    if a.dim() != 3 or b.shape != a.shape or c.shape != (a.shape[0],
                                                         a.shape[2]):
        raise ValueError(f"a, b (J, T, n) and c (J, n) expected, got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}, "
                         f"{tuple(c.shape)}")
    return [(list(zip(aj.unbind(0), bj.unbind(0))), (cj,), signs)
            for aj, bj, cj in zip(a.unbind(0), b.unbind(0), c.unbind(0))]


def mult_terms(a, b, c, signs) -> torch.Tensor:
    """out[j] = sum_t signs[t] * a[j,t] * b[j,t] + c[j] mod 2^ell;
    a, b: (J, T, n), c: (J, n), signs: length-T tuple of +-1 -- the
    grouped kernel with one group per row."""
    if _on_cpu(a):
        MULT_TERMS.calls += 1
        return mult_terms_plain(a, b, c, signs)
    out = torch.empty(c.shape, dtype=c.dtype, device=c.device)
    _terms_groups(MULT_TERMS, False, _stacked_groups(a, b, c, signs),
                  list(out))
    return out


def and_terms(a, b, c) -> torch.Tensor:
    """out[j] = XOR_t (a[j,t] & b[j,t]) ^ c[j] on bit-packed words; as
    ``mult_terms``."""
    if _on_cpu(a):
        AND_TERMS.calls += 1
        return and_terms_plain(a, b, c)
    out = torch.empty(c.shape, dtype=c.dtype, device=c.device)
    _terms_groups(AND_TERMS, True, _stacked_groups(a, b, c, None), list(out))
    return out


def mpc_matmul_fused(mx, lx, my, ly) -> tuple:
    """(mx @ my, lx_sum @ my + mx @ ly_sum, [lx_sum @ ly_sum, 0, 0]) mod
    2^ell, views of one zeroed buffer; mx (M, K), lx (3, M, K), my (K, N),
    ly (3, K, N)."""
    MPC_MATMUL_FUSED.calls += 1
    if _on_cpu(mx):
        return mpc_matmul_fused_plain(mx, lx, my, ly)
    out = mpc_matmul_fused_cuda(mx, lx, my, ly)
    MPC_MATMUL_FUSED.launches += 1
    return out


def and_level(x, y, lamz, zero=None) -> torch.Tensor:
    """One boolean AND level on (4, n) share stacks: returns the (4, n)
    output stack (m_z, lamz); `zero` (3, n) Pi_Zero shares or None."""
    AND_LEVEL.calls += 1
    if _on_cpu(x):
        return and_level_plain(x, y, lamz, zero)
    out = and_level_cuda(x, y, lamz, zero)
    AND_LEVEL.launches += 1
    return out


def ppa_add(x, y, draws, cin: int = 0) -> torch.Tensor:
    """[[x + y + cin]] of (4, n) boolean share stacks by the whole Sklansky
    adder in one ``and_level.cu`` launch; `draws` (2 log2(ell) + 1, S, n)
    its ANDs' PRF draws (S = 6 faithful, 3 collapsed)."""
    AND_LEVEL.calls += 1
    if _on_cpu(x):
        return ppa_add_plain(x, y, draws, cin)
    out = ppa_add_cuda(x, y, draws, cin)
    AND_LEVEL.launches += 1
    return out


def prefix_or(x, draws, mask: int) -> torch.Tensor:
    """[[prefix-OR]] of a (4, n) boolean share stack from the msb down in
    one ``and_level.cu`` launch; `draws` (log2(ell), S, n), `mask` the
    all-ones word of the valid bits."""
    AND_LEVEL.calls += 1
    if _on_cpu(x):
        return prefix_or_plain(x, draws, mask)
    out = prefix_or_cuda(x, draws, mask)
    AND_LEVEL.launches += 1
    return out


def and_chain_offline(kind: str, x, y, draws, arg: int = 0) -> tuple:
    """The joint offline run of a boolean chain (kind "and": x AND y;
    "add": the adder, arg = cin; "or": the prefix-OR of x, arg = mask) in
    one ``and_level.cu`` launch: (gammas (A, 3, n), the (4, n) stack);
    `draws` (A, S, n) its ANDs' PRF draws."""
    AND_LEVEL.calls += 1
    if _on_cpu(x):
        return and_chain_offline_plain(kind, x, y, draws, arg)
    out = and_chain_offline_cuda(kind, x, y, draws, arg)
    AND_LEVEL.launches += 1
    return out


def and_chain_online(kind: str, x, y, lamz, gammas, arg: int = 0):
    """The joint online run of a boolean chain in one ``and_level.cu``
    launch: the (4, n) stack from its ANDs' lamz and gammas, (A, 3, n)
    each."""
    AND_LEVEL.calls += 1
    if _on_cpu(x):
        return and_chain_online_plain(kind, x, y, lamz, gammas, arg)
    out = and_chain_online_cuda(kind, x, y, lamz, gammas, arg)
    AND_LEVEL.launches += 1
    return out


def msb_of_sum_words(x, y, lamz_levels, zero_levels) -> torch.Tensor:
    """msb(x + y) of (n,) public words by the Sklansky adder in one
    ``and_level.cu`` launch; lamz/zero levels (log2(ell) + 1, 3, n)."""
    PPA_MSB.calls += 1
    if _on_cpu(x):
        return ppa_msb(x, y, lamz_levels, zero_levels, and_level_plain)
    out = ppa_msb_cuda(x, y, lamz_levels, zero_levels)
    PPA_MSB.launches += 1
    return out
