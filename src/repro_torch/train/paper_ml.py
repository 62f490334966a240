"""The paper's NN workload (``repro/train/paper_ml.py``).

NN: 784-128-128-10, ReLU hidden, smx output (Section VI-A c).  The port
carries the network description, its initialisation, the carry-over of the
JAX package's parameters, the engine-generic forward pass ``mlp_net_fwd``,
and secure prediction in two worlds: ``mlp_net_predict`` on the party
runtime and ``mlp_net_predict_joint`` on the joint simulation.  Both share
X and then the weights, run ``matmul_tr`` -> ``relu`` per hidden layer and
``matmul_tr`` -> ``smx`` at the output, and open the probabilities.  (The
runtime's ``mlp_net_predict`` becomes engine-generic when the runtime's
engine is ported.)
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import protocols as PR
from ..core.context import TridentContext
from ..core.ring import Ring
from ..nn.engine import Engine, TridentEngine
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


def mlp_net_fwd(eng: Engine, params: dict, net: MLPNet, X):
    """Returns (probs, caches).  Hidden ReLU; output smx softmax.  `X` and
    `params` are the engine's tensors."""
    h = X
    caches = []
    n = len(net.dims) - 1
    for i in range(n):
        z = eng.matmul(h, params[f"w{i}"])
        if i < n - 1:
            a, bit = eng.relu(z)
            caches.append((h, bit))
            h = a
        else:
            p, csm = eng.softmax(z, axis=-1)
            caches.append((h, csm))
            h = p
    return h, caches


def mlp_net_predict_joint(ctx: TridentContext, params: dict, net: MLPNet,
                          X, nonlinear: str = "newton") -> torch.Tensor:
    """Secure prediction of one batch on the joint simulation: share X,
    then the encoded weights (``params_from_numpy``), then ``mlp_net_fwd``
    on a ``TridentEngine``; returns the opened probabilities as ring words.
    With nonlinear="newton" this is ``mlp_net_predict``'s program, word
    for word on the same seed."""
    eng = TridentEngine(ctx, nonlinear=nonlinear)
    h = eng.from_plain(X)
    ws = {f"w{i}": PR.share(ctx, params[f"w{i}"])
          for i in range(len(net.layers))}
    p, _ = mlp_net_fwd(eng, ws, net, h)
    return PR.reconstruct(ctx, p)
