"""Roofline terms of a dry-run cell on one H100 (``repro/launch/
roofline.py``).

    compute term    = secure ring MACs x 36 limb-pair products x 2 ops
                      / the dense int8 tensor-core rate
    memory term     = the arguments and outputs, each moved once / HBM rate
    collective term = 0: one card, no collectives

Hardware constants: NVIDIA H100 SXM5 data sheet, 3.35 TB/s HBM3 and
1,979 TOP/s dense int8 (the rates ``PERF.md`` §6 bounds the kernels by),
80 GB of HBM3.  A 64-bit ring MAC is 36 u8 x u8 limb-pair products on
the ``wgmma`` limb core (``kernels/csrc/limb_core.cuh``; the TPU route's
16-limb decomposition counts 136 MXU flops).  A secure matmul is 4 ring
products in the collapsed joint simulation (``mpc_matmul_fused``'s four
quadrants) and 16 in the faithful one (its component pairs).

There is no compiled program to read: the secure ring MACs come from the
model's MACs (``model_flops`` / 2); ``model_flops`` and
``active_params`` are the JAX module's, unchanged.
"""
from __future__ import annotations

HBM_BW = 3.35e12             # bytes/s, H100 SXM5 HBM3
PEAK_INT8_OPS = 1979e12      # dense int8 tensor-core ops/s, H100 SXM5
HBM_BYTES = 80e9             # device memory, H100 80GB
LIMB_FACTOR_U64 = 36         # u8 limb-pair products per 64-bit ring MAC
PRODUCTS_PER_SECURE_MAC = {True: 4, False: 16}   # collapsed, faithful


def collective_bytes(_cell=None) -> float:
    """Bytes of collectives: none on one card."""
    return 0.0


def model_flops(cfg, batch: int, seq: int, kind: str) -> float:
    """6*N*D (training) / 2*N*D (inference) with N = active params."""
    n_active = active_params(cfg)
    d_tokens = batch * seq if kind in ("train", "prefill") else batch
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_active * d_tokens


def active_params(cfg) -> float:
    d, f, V, L = cfg.d_model, cfg.d_ff, cfg.vocab, cfg.n_layers
    H, Hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.dh
    attn = d * H * dh + 2 * d * Hk * dh + H * dh * d
    if cfg.n_experts:
        ff = cfg.top_k * (3 if cfg.act == "swiglu" else 2) * d * f \
            + d * cfg.n_experts
    elif f:
        ff = (3 if cfg.act in ("swiglu", "sigmoid_glu") else 2) * d * f
    else:
        ff = 0
    if cfg.family == "ssm":
        r = cfg.ret_cfg()
        per = (2 * d * r.n_heads * r.d_k + 3 * d * r.n_heads * r.d_v
               + 4 * d * d) / 2
        core = L * per
    elif cfg.family == "hybrid":
        r = cfg.ret_cfg()
        ret = 2 * d * r.n_heads * r.d_k + 3 * d * r.n_heads * r.d_v
        core = L * ret + attn + ff        # shared attn counted once
    else:
        core = L * (attn + ff)
    return core + 2 * d * V


def roofline_terms(metrics: dict, cfg, batch: int, seq: int,
                   kind: str) -> dict:
    """The terms of one cell from its metrics (``devices``, ``collapse``,
    ``mem``'s argument and output bytes)."""
    chips = metrics["devices"]
    mem = metrics["mem"]
    moved = (mem["argument_size_bytes"] or 0) + (mem["output_size_bytes"]
                                                  or 0)
    mf = model_flops(cfg, batch, seq, kind)
    ring_macs = mf / 2 * PRODUCTS_PER_SECURE_MAC[bool(metrics["collapse"])]
    terms = {"t_compute": None,
             "t_compute_limb": ring_macs * LIMB_FACTOR_U64 * 2
             / (chips * PEAK_INT8_OPS),
             "t_memory": moved / (chips * HBM_BW),
             "t_collective": collective_bytes() / chips,
             "model_flops": mf, "ring_macs": ring_macs,
             "useful_ratio": None}
    terms["bottleneck"] = max(("t_compute_limb", "t_memory",
                               "t_collective"), key=lambda k: terms[k])
    return terms
