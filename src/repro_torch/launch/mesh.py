"""The device layouts a launch is sized for (``repro/launch/mesh.py``).

``make_production_mesh`` gives the JAX package's layouts as H100s: a pod
of 16x16 = 256 cards over the axes ("data", "model"), or two pods,
2x16x16 = 512 cards over ("pod", "data", "model").  A ``Mesh`` is a
description only: axis names, sizes and a device count.  It holds no
devices and creates no ``torch.distributed`` process group (a
``DeviceMesh`` of 256 needs 256 live ranks; the JAX dry run fakes 512
host devices to the same end).  The sharding rules (``specs.py``) and the
dry run (``dryrun.py``) read it.

Ranks are numbered as ``jax.make_mesh`` numbers devices: row-major over
the axes, the model axis fastest, so a model group is 16 consecutive
ranks.  With ``GPUS_PER_NODE`` = 8 cards a node (HGX H100), a model group
spans two nodes and a data group sixteen.

``ONE_CARD`` is the 1x1 layout named "1xH100" that the dry run sizes the
launcher's cell on (ROADMAP D5); ``OneCardMesh`` / ``make_mesh`` hold the
card the launcher runs on.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..core.context import resolve_device

GPUS_PER_NODE = 8            # HGX H100: 8 SXM5 cards on one NVSwitch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An abstract device grid: `sizes` along `axis_names`."""
    sizes: tuple
    axis_names: tuple
    label: str | None = None

    @property
    def shape(self) -> dict:
        """Axis name -> size, in axis order (``jax`` Mesh.shape)."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    @property
    def name(self) -> str:
        return self.label or "x".join(str(s) for s in self.sizes)

    def coords(self, rank: int) -> tuple:
        """The rank's coordinate on each axis (row-major, last fastest)."""
        out = []
        for s in reversed(self.sizes):
            out.append(rank % s)
            rank //= s
        return tuple(reversed(out))

    def rank(self, coords: tuple) -> int:
        r = 0
        for c, s in zip(coords, self.sizes):
            r = r * s + c
        return r

    def group(self, axes, rank: int = 0) -> list:
        """The ranks that share `rank`'s coordinates off `axes` (a name or
        a tuple of names): the members of one collective over `axes`."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        base = self.coords(rank)
        idx = [self.axis_names.index(a) for a in axes]
        members = []
        for flat in range(math.prod(self.sizes[i] for i in idx)):
            c = list(base)
            for i in reversed(idx):
                c[i] = flat % self.sizes[i]
                flat //= self.sizes[i]
            members.append(self.rank(tuple(c)))
        return sorted(members)

    def crosses_nodes(self, axes) -> bool:
        """Whether a collective over `axes` leaves one node (every group
        of this numbering is alike, so rank 0's answers)."""
        return len({r // GPUS_PER_NODE for r in self.group(axes)}) > 1


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 = 256 cards a pod; 2 pods = 512 cards when multi_pod."""
    if multi_pod:
        return Mesh((2, 16, 16), ("pod", "data", "model"))
    return Mesh((16, 16), ("data", "model"))


ONE_CARD = Mesh((1, 1), ("data", "model"), label="1xH100")


def mesh_named(name: str) -> Mesh:
    """The mesh a dry-run record names: "16x16", "2x16x16" or "1xH100"."""
    meshes = {m.name: m for m in (make_production_mesh(),
                                  make_production_mesh(multi_pod=True),
                                  ONE_CARD)}
    return meshes[name]


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
