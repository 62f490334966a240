"""The yardstick's arithmetic: the card's peaks, the ring matmul's bound,
and the plain model's operations a step or a prefill needs.

Peaks are NVIDIA's data sheet for the H100 SXM (dense, 700 W): 1,979 TOP/s
int8 on the tensor cores and 3.35 TB/s of HBM.  The program multiplies
words of Z_2^64 as 8 limbs of 8 bits, 36 limb pairs a product of two
words, so its peak in ring multiply-adds is 1,979 / 36 TOP/s: the rate
against which ``mfu`` holds the plain model's operations (one plain
multiply-add is one ring multiply-add of the secure model's words, and
the secure protocols do several of those for each).
"""
from __future__ import annotations

import math

INT8_TC_OPS_PER_S = 1979e12
HBM_BYTES_PER_S = 3.35e12


def limb_pairs(word_bytes: int) -> int:
    """The 8-bit limb products of one product mod 2^(8 word_bytes): the
    pairs (i, j) with i + j below the word's limbs."""
    return word_bytes * (word_bytes + 1) // 2


def ring_peak_ops_per_s(word_bytes: int = 8) -> float:
    return INT8_TC_OPS_PER_S / limb_pairs(word_bytes)


def matmul_dims(a_shape, b_shape) -> tuple:
    """(batch, M, K, N) of ``torch.matmul``'s shapes as the ring matmul
    takes them: [..., M, K] @ (K, N) is one (prod(...) M, K) @ (K, N)
    product; batched operands broadcast their leading dimensions."""
    if len(b_shape) == 2:
        m = math.prod(a_shape[:-1])
        return 1, m, a_shape[-1], b_shape[1]
    lead = []
    la, lb = list(a_shape[:-2]), list(b_shape[:-2])
    n = max(len(la), len(lb))
    la, lb = [1] * (n - len(la)) + la, [1] * (n - len(lb)) + lb
    for x, y in zip(la, lb):
        lead.append(max(x, y))
    return math.prod(lead), a_shape[-2], a_shape[-1], b_shape[-1]


def ring_matmul_bound_s(a_shape, b_shape, word_bytes: int = 8) -> float:
    """The least time of one ring matmul: its operands read once and its
    product written once at the HBM rate, against its limb-pair products
    (2 M N K each) at the int8 tensor-core rate."""
    batch, m, k, n = matmul_dims(tuple(a_shape), tuple(b_shape))
    nbytes = word_bytes * (math.prod(a_shape) + math.prod(b_shape)
                           + batch * m * n)
    ops = limb_pairs(word_bytes) * 2 * batch * m * n * k
    return max(nbytes / HBM_BYTES_PER_S, ops / INT8_TC_OPS_PER_S)


def layer_matmul_params(s: dict) -> int:
    """Weights one position multiplies through in a layer: q, k, v, o and
    the SwiGLU MLP's up, gate and down."""
    hd, kd = s["h"] * s["dh"], s["hk"] * s["dh"]
    return s["d"] * (2 * hd + 2 * kd) + 3 * s["d"] * s["f"]


def attention_ops(s: dict, q_positions: int, k_offset: int = 0) -> int:
    """Multiply-adds x 2 of the causal score and value products of one
    layer: each query attends to the keys up to its own position."""
    pairs = sum(k_offset + i + 1 for i in range(q_positions))
    return 2 * 2 * pairs * s["h"] * s["dh"]


def train_step_ops(s: dict, positions: int, labels: int) -> int:
    """A training step of the plain model: forward and backward (twice the
    forward's products) of every layer over all positions, the lm_head
    over the positions that carry a label, no recompute."""
    fwd = s["layers"] * (2 * layer_matmul_params(s) * positions
                         + attention_ops(s, positions)) \
        + 2 * s["d"] * s["v"] * labels
    return 3 * fwd


def prefill_ops(s: dict, positions: int) -> int:
    """A prefill of the plain model: every layer over all positions and
    the lm_head at the last."""
    return s["layers"] * (2 * layer_matmul_params(s) * positions
                          + attention_ops(s, positions)) \
        + 2 * s["d"] * s["v"]


def decode_ops(s: dict, past: int) -> int:
    """One decode step after `past` positions."""
    return s["layers"] * (2 * layer_matmul_params(s)
                          + attention_ops(s, 1, past)) + 2 * s["d"] * s["v"]
