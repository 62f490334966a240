"""Shared helpers for architecture configs (``repro/configs/_common.py``)."""
from __future__ import annotations

from ..nn.model import ModelConfig

# Dry-run execution knobs shared by all full-size configs: remat bounds
# activation memory to ~one layer; q_chunk bounds prefill score tiles;
# microbatching is set per-shape by the launcher.
FULL_KNOBS = dict(remat=True, q_chunk=512, seq_chunk=256)
SMOKE_KNOBS = dict(remat=False, q_chunk=None, seq_chunk=8)


def full(**kw) -> ModelConfig:
    merged = {**FULL_KNOBS, **kw}
    return ModelConfig(**merged)


def smoke(**kw) -> ModelConfig:
    merged = {**SMOKE_KNOBS, **kw}
    return ModelConfig(**merged)
