"""Optimizers on [[.]]-shares (``repro/train/optim.py``).

All state (momentum buffers) stays secret-shared; the hyperparameters
(lr, beta) are public.  Updates are linear except the public-constant
scalings, each of which costs one truncation (Pi_Trunc) where the scale
lies below 1.  Both optimizers take trees laid out as the LM's params
(``nn.model.params_to_engine``: a segment's stacked leaf is a share's
data (n, 4, ...)) and visit the leaves in the JAX package's order
(``nn.model.map_params``), so each truncation draws the JAX package's PRF
words.  A stacked leaf is updated as one (n, ...) share for every n; the
JAX package tells a stacked leaf by ``shape[0] != 4`` and updates a
segment of exactly four layers as a share whose component axis is the
layer axis (ROADMAP F6), so the port's words equal the JAX package's
wherever n != 4.
"""
from __future__ import annotations

import dataclasses

from ..nn.engine import Engine
from ..nn.model import map_params


@dataclasses.dataclass
class SGD:
    lr: float = 2.0 ** -6

    def init(self, eng, params):
        return None

    def update(self, eng: Engine, params, grads, state):
        """w <- w - lr g.  Returns (new params, None)."""
        return map_params(eng, lambda w, g: eng.sub(w, eng.scale(g, self.lr)),
                          params, grads), None


@dataclasses.dataclass
class Momentum:
    """Polyak momentum: m <- beta m + g ; w <- w - lr m (shares)."""
    lr: float = 2.0 ** -6
    beta: float = 0.875              # 1 - 2^-3: one truncation a leaf

    def init(self, eng, params):
        """Zero buffers in the params' layout (a stacked leaf's zeros
        stacked alike)."""
        return map_params(eng, lambda w: eng.zeros(eng.shape_of(w)), params)

    def update(self, eng: Engine, params, grads, state):
        """Every buffer first, then every weight, each pass in leaf order
        (the JAX package's two tree maps).  Returns (new params, new
        buffers)."""
        new_m = map_params(eng, lambda m, g: eng.add(eng.scale(m, self.beta),
                                                     g), state, grads)
        new_p = map_params(eng, lambda w, m: eng.sub(w, eng.scale(m, self.lr)),
                           params, new_m)
        return new_p, new_m
