"""The device layout a launch runs on (``repro/launch/mesh.py``).

The JAX package builds a 16x16 TPU pod mesh, or 2x16x16 across two pods,
and shards batches over its data axes and heads, d_ff and experts over
its model axis.  The port runs on one card: the layout keeps the axis
names ("data", "model") with one device on each, so ``data_axes`` and
``model_axis`` answer as they do for a single-pod mesh.  The pod meshes
wait for a multi-card slice (ROADMAP, Queue 1).
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.context import resolve_device


@dataclasses.dataclass(frozen=True)
class OneCardMesh:
    device: torch.device
    axis_names: tuple = ("data", "model")

    @property
    def size(self) -> int:
        return 1


def make_mesh(device=None) -> OneCardMesh:
    """The one-card layout on `device` (CUDA unless given; refused without
    CUDA when no device is given)."""
    return OneCardMesh(resolve_device(device))


def data_axes(mesh) -> tuple:
    """Axes that carry the batch dimension."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def model_axis(_mesh) -> str:
    return "model"
