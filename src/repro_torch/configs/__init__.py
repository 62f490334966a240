"""Architecture registry (``repro/configs``): the 10 assigned architectures
+ the paper's own four ML workloads (``paper_models``), selectable by id.
The arch modules' ``CONFIG`` and ``SMOKE`` equal the JAX package's field
for field.

Each module exposes:
    CONFIG        full-size ModelConfig (exact numbers from the assignment)
    SMOKE         reduced same-family config for CPU tests
    SHAPES        {shape_name: (seq_len, global_batch, kind)}
"""
from __future__ import annotations

import importlib

ARCHS = [
    "qwen3_moe_235b_a22b",
    "mixtral_8x7b",
    "zamba2_7b",
    "nemotron_4_15b",
    "minitron_8b",
    "qwen3_1_7b",
    "deepseek_7b",
    "whisper_tiny",
    "xlstm_350m",
    "phi_3_vision_4_2b",
]

# canonical ids as assigned (dashes/dots) -> module names
ALIASES = {
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "mixtral-8x7b": "mixtral_8x7b",
    "zamba2-7b": "zamba2_7b",
    "nemotron-4-15b": "nemotron_4_15b",
    "minitron-8b": "minitron_8b",
    "qwen3-1.7b": "qwen3_1_7b",
    "deepseek-7b": "deepseek_7b",
    "whisper-tiny": "whisper_tiny",
    "xlstm-350m": "xlstm_350m",
    "phi-3-vision-4.2b": "phi_3_vision_4_2b",
}

# LM shape grid (assignment): name -> (seq_len, global_batch, kind)
SHAPES = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "long_decode"),
}

# archs that support long_500k (sub-quadratic sequence mixing); pure
# full-attention archs skip it (DESIGN.md section Arch-applicability)
LONG_CONTEXT_ARCHS = {"zamba2_7b", "xlstm_350m", "mixtral_8x7b"}


def get(arch: str):
    """Returns the arch module for an id or alias."""
    mod = ALIASES.get(arch, arch).replace("-", "_").replace(".", "_")
    if mod not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ALIASES)}")
    return importlib.import_module(f".{mod}", __name__)


def cells(include_long: bool = True):
    """All (arch, shape) dry-run cells -- 40 total; long_500k only for
    sub-quadratic archs per the assignment note."""
    out = []
    for a in ARCHS:
        for s in SHAPES:
            if s == "long_500k" and a not in LONG_CONTEXT_ARCHS:
                if include_long:
                    out.append((a, s, "skip"))
                continue
            out.append((a, s, "run"))
    return out
