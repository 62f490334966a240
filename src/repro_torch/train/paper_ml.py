"""The paper's ML workloads over the Engine (``repro/train/paper_ml.py``,
Section VI).

Linear Regression  w <- w - a/B X^T (X w - y)            (Section VI-A a)
Logistic Regression  ... sig(X w) ...                    (Section VI-A b)
NN    784-128-128-10, ReLU hidden, smx output            (Section VI-A c)

All matmuls are Pi_MatMulTr; activations are the paper's protocols.
Forward and backward passes are written by hand against the Engine
interface, so one program trains on ``PlainEngine``, ``TridentEngine`` and
``RuntimeEngine``.  Besides the engine-generic functions the module keeps
the parameters' carry-over from the JAX package (``params_from_numpy``)
and two secure prediction programs over encoded weights:
``mlp_net_predict_runtime`` on the party runtime and
``mlp_net_predict_joint`` on the joint simulation, word for word the same
program on the same seed.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import protocols as PR
from ..core.context import TridentContext
from ..core.ring import Ring
from ..nn.engine import Engine, TridentEngine
from ..nn.runtime_engine import RuntimeEngine
from ..runtime import protocols as RT
from ..runtime.runtime import FourPartyRuntime


# ---------------------------------------------------------------------------
# Linear / logistic regression
# ---------------------------------------------------------------------------
def reg_init(rng: np.random.RandomState, d: int) -> dict:
    return {"w": (rng.randn(d, 1) * 0.01).astype(np.float64)}


def linreg_step(eng: Engine, params, X, y, lr: float):
    """One GD iteration; X: (B, d), y: (B, 1) engine tensors."""
    pred = eng.matmul(X, params["w"])                   # (B, 1)
    err = eng.sub(pred, y)
    grad = eng.matmul(eng.transpose(X, (1, 0)), err)    # (d, 1)
    bsz = eng.shape_of(X)[0]
    upd = eng.scale(grad, lr / bsz)
    return {"w": eng.sub(params["w"], upd)}, err


def logreg_step(eng: Engine, params, X, y, lr: float):
    z = eng.matmul(X, params["w"])
    p, _ = eng.sigmoid(z)
    err = eng.sub(p, y)
    grad = eng.matmul(eng.transpose(X, (1, 0)), err)
    bsz = eng.shape_of(X)[0]
    upd = eng.scale(grad, lr / bsz)
    return {"w": eng.sub(params["w"], upd)}, err


def reg_predict(eng: Engine, params, X, logistic: bool = False):
    z = eng.matmul(X, params["w"])
    if logistic:
        p, _ = eng.sigmoid(z)
        return p
    return z


# ---------------------------------------------------------------------------
# NN (MLP stack per the paper's benchmark network)
# ---------------------------------------------------------------------------
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


def mlp_net_bwd(eng: Engine, params: dict, net: MLPNet, caches, dout):
    """`dout` is dL/dlogits: (p - y) / B passed straight to the last layer
    (the cross-entropy shortcut), so the softmax's backward is skipped."""
    n = len(net.dims) - 1
    grads = {}
    dz = dout
    for i in reversed(range(n)):
        h, _ = caches[i]
        grads[f"w{i}"] = eng.matmul(eng.transpose(
            eng.reshape(h, (-1, net.dims[i])), (1, 0)), dz)
        if i > 0:
            dh = eng.matmul(dz, eng.transpose(params[f"w{i}"], (1, 0)))
            _, bit = caches[i - 1]
            dz = eng.relu_bwd(bit, dh)
    return grads


def mlp_net_step(eng: Engine, params: dict, net: MLPNet, X, labels_onehot,
                 lr: float):
    """One training iteration (forward + backward + SGD); returns (new
    params, probs)."""
    p, caches = mlp_net_fwd(eng, params, net, X)
    bsz = eng.shape_of(X)[0]
    diff = eng.add_public(p, -np.asarray(labels_onehot, np.float64))
    dlogits = eng.scale(diff, 1.0 / bsz)
    grads = mlp_net_bwd(eng, params, net, caches, dlogits)
    new = {k: eng.sub(params[k], eng.scale(grads[k], lr)) for k in params}
    return new, p


def mlp_net_predict(eng: Engine, params: dict, net: MLPNet, X):
    """The forward pass's probabilities, on any engine."""
    p, _ = mlp_net_fwd(eng, params, net, X)
    return p


# ---------------------------------------------------------------------------
# Secure prediction over encoded weights (the serving programs)
# ---------------------------------------------------------------------------
def _predict_encoded(eng: Engine, share, params: dict, net: MLPNet, X):
    """The serving program on `eng`: share X, then the encoded weights
    with `share`, ``mlp_net_fwd``, and open the probabilities as ring
    words."""
    h = eng.from_plain(X)
    ws = {f"w{i}": share(params[f"w{i}"]) for i in range(len(net.layers))}
    p, _ = mlp_net_fwd(eng, ws, net, h)
    return eng.reveal(p)


def mlp_net_predict_runtime(rt: FourPartyRuntime, params: dict, net: MLPNet,
                            X) -> torch.Tensor:
    """Secure prediction of one batch on the party runtime: returns the
    opened probabilities as ring words (P1's copy; every receiver opens
    the same words).  `params` are encoded weights
    (``params_from_numpy``); X is float data."""
    return _predict_encoded(RuntimeEngine(rt), lambda w: RT.share(rt, w),
                            params, net, X)


def mlp_net_predict_joint(ctx: TridentContext, params: dict, net: MLPNet,
                          X, nonlinear: str = "newton") -> torch.Tensor:
    """Secure prediction of one batch on the joint simulation, the same
    program on a ``TridentEngine``.  With nonlinear="newton" it opens
    ``mlp_net_predict_runtime``'s words on the same seed."""
    return _predict_encoded(TridentEngine(ctx, nonlinear=nonlinear),
                            lambda w: PR.share(ctx, w), params, net, X)
