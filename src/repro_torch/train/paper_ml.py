"""The paper's NN workload on the party runtime (``repro/train/paper_ml.py``).

NN: 784-128-128-10, ReLU hidden, smx output (Section VI-A c).  This slice
of the port carries the network description, its initialisation, the
carry-over of the JAX package's parameters, and secure prediction -- the
forward pass of ``mlp_net_fwd`` on the runtime: share X and the weights,
``matmul_tr`` -> ``relu`` per hidden layer, ``matmul_tr`` -> ``smx_softmax``
at the output, then open the probabilities.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.ring import Ring
from ..runtime import activations as RA
from ..runtime import protocols as RT
from ..runtime.runtime import FourPartyRuntime


@dataclasses.dataclass(frozen=True)
class MLPNet:
    features: int
    layers: tuple                     # e.g. (128, 128, 10)

    @property
    def dims(self):
        return (self.features,) + tuple(self.layers)


def mlp_net_init(rng: np.random.RandomState, net: MLPNet) -> dict:
    """Float64 weights {"w0", "w1", ...}, drawn as the JAX package draws
    them (same RandomState calls, same order)."""
    dims = net.dims
    return {f"w{i}": (rng.randn(dims[i], dims[i + 1]) /
                      np.sqrt(dims[i])).astype(np.float64)
            for i in range(len(dims) - 1)}


def params_from_numpy(params: dict, ring: Ring, device) -> dict:
    """The JAX package's parameters (numpy float64, e.g. from
    ``repro.train.paper_ml.mlp_net_init``) as this package's fixed-point
    ring words on `device`: both packages then share the same words."""
    return {k: ring.encode(np.asarray(v, np.float64), device=device)
            for k, v in params.items()}


def mlp_net_predict(rt: FourPartyRuntime, params: dict, net: MLPNet,
                    X) -> torch.Tensor:
    """Secure prediction of one batch: returns the opened probabilities as
    ring words (P1's copy; every receiver opens the same words).  `params`
    are encoded weights (``params_from_numpy``); X is float data."""
    h = RT.share(rt, rt.encode(X))
    ws = [RT.share(rt, params[f"w{i}"]) for i in range(len(net.layers))]
    for i, w in enumerate(ws):
        z = RT.matmul_tr(rt, h, w)
        h = RA.relu(rt, z) if i < len(ws) - 1 else RA.smx_softmax(rt, z)
    return RT.reconstruct(rt, h)[1]
