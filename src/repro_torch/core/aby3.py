"""ABY3 (Mohassel & Rindal, CCS'18) 3PC baseline -- the paper's comparison
(``repro/core/aby3.py``).

Functional 2-out-of-3 replicated secret sharing with semi-honest
multiplication, plus the paper-claimed malicious cost formulas (see
``paper_costs.ABY3``) tallied beside it.  The joint simulation stores the
three additive legs as one (3, *shape) tensor on the context's device;
party i holds legs (i, i+1 mod 3).

Implemented: share / reveal / add / mult / matmul / SecureML-style
truncation pair: enough to run the paper's ML workloads as a baseline and
to time its local compute; the malicious variant is cost-modeled.

Kernel routes.  PyTorch has no integer matmul on CUDA, so every leg
product goes through a hand-written kernel: ``matmul``'s legs
``x_i@y_i + x_i@y_j + x_j@y_i`` use all nine pairs of the 3x3 grid, ONE
``kernels.ops.mpc_matmul_grid`` launch; ``mult``'s legs are three groups of
three products plus the zero share z_i, ONE ``kernels.ops.mult_terms_group``
launch.  ``_zero3``, ``share`` and ``truncate`` draw their streams as one
``sample_group`` each, in the JAX package's counter order.
"""
from __future__ import annotations

import dataclasses

import torch

from ..kernels import ops
from .algebra import numel as _n
from .context import TridentContext
from .shares import _const


@dataclasses.dataclass
class RShare:
    """Replicated 3PC share: data (3, *shape), legs sum to the value."""

    data: torch.Tensor

    @property
    def shape(self) -> tuple:
        return tuple(self.data.shape[1:])

    def reveal(self) -> torch.Tensor:
        return self.data[0] + self.data[1] + self.data[2]

    def __add__(self, other):
        if isinstance(other, RShare):
            return RShare(self.data + other.data)
        d = self.data.clone()
        d[0] += _const(other, d)
        return RShare(d)

    def __sub__(self, other):
        if isinstance(other, RShare):
            return RShare(self.data - other.data)
        d = self.data.clone()
        d[0] -= _const(other, d)
        return RShare(d)

    def __neg__(self):
        return RShare(-self.data)

    def mul_public(self, c):
        return RShare(self.data * _const(c, self.data))


def share(ctx: TridentContext, v, malicious: bool = True) -> RShare:
    ring = ctx.ring
    v = ctx.words(v)
    a, b = ctx.sample_group([((0, 1), v.shape), ((1, 2), v.shape)])
    ctx.tally.add("ABY3.share", "online", rounds=1,
                  bits=(3 if malicious else 2) * ring.ell * _n(v.shape))
    return RShare(torch.stack([a, b, v - a - b]))


def reveal(ctx: TridentContext, x: RShare, malicious: bool = True):
    ctx.tally.add("ABY3.rec", "online", rounds=1,
                  bits=(6 if malicious else 3) * ctx.ring.ell * _n(x.shape))
    return x.reveal()


def _zero3(ctx: TridentContext, shape) -> torch.Tensor:
    f1, f2, f3 = ctx.sample_group([(s, shape)
                                   for s in ((0, 1), (1, 2), (2, 0))])
    return torch.stack([f1 - f3, f2 - f1, f3 - f2])


def mult(ctx: TridentContext, x: RShare, y: RShare,
         malicious: bool = True) -> RShare:
    """Replicated multiplication + resharing.  Semi-honest: 3 elements,
    1 round; malicious tallied at the paper-claimed 9 elements online."""
    ring = ctx.ring
    z = _zero3(ctx, tuple(torch.broadcast_shapes(x.shape, y.shape)))
    groups = []
    for i in range(3):
        j = (i + 1) % 3
        groups.append(([(x.data[i], y.data[i]), (x.data[i], y.data[j]),
                        (x.data[j], y.data[i])], (z[i],), (1, 1, 1)))
    legs = torch.stack(ops.mult_terms_group(groups))
    n = _n(legs.shape[1:])
    ctx.tally.add("ABY3.mult", "online", rounds=1,
                  bits=(9 if malicious else 3) * ring.ell * n)
    ctx.tally.add("ABY3.mult", "offline", rounds=1,
                  bits=(3 if malicious else 0) * ring.ell * n)
    return RShare(legs)


def matmul(ctx: TridentContext, x: RShare, y: RShare,
           malicious: bool = True) -> RShare:
    """ABY3 dot-product/matmul: communication scales with the contraction
    length in the malicious case (the paper's headline comparison).  x's
    last axis is contracted with y's first, the legs flattened to 2-D."""
    ring = ctx.ring
    d = x.shape[-1]
    out_shape = tuple(x.shape[:-1]) + tuple(y.shape[1:])
    z = _zero3(ctx, out_shape)
    q = ops.mpc_matmul_grid(
        [x.data[i].reshape(-1, d) for i in range(3)],
        [y.data[i].reshape(d, -1) for i in range(3)])
    legs = []
    for i in range(3):
        j = (i + 1) % 3
        legs.append((q[i][i] + q[i][j] + q[j][i]).reshape(out_shape) + z[i])
    n = _n(out_shape)
    ctx.tally.add("ABY3.dotp", "online", rounds=1,
                  bits=(9 * d if malicious else 3) * ring.ell * n)
    ctx.tally.add("ABY3.dotp", "offline", rounds=1,
                  bits=(3 * d if malicious else 0) * ring.ell * n)
    return RShare(torch.stack(legs))


def truncate(ctx: TridentContext, x: RShare,
             malicious: bool = True) -> RShare:  # noqa: ARG001 -- API parity
    """SecureML-style pair truncation; ABY3's offline pair generation uses
    (2*ell-2)-round RCA circuits -- tallied, value emulated via the pair."""
    ring = ctx.ring
    shape = x.shape
    r1, r2, r3 = ctx.sample_group([(s, shape)
                                   for s in ((0, 1), (1, 2), (2, 0))])
    r = r1 + r2 + r3
    rt = ring.truncate(r)
    # offline RCA evaluation: 2*ell-2 rounds (paper Table X)
    ctx.tally.add("ABY3.trunc_pair", "offline", rounds=2 * ring.ell - 2,
                  bits=(96 * ring.ell - 84) * _n(shape))
    zt = ring.truncate(x.reveal() - r)
    ctx.tally.add("ABY3.trunc", "online", rounds=1,
                  bits=3 * ring.ell * _n(shape))
    return RShare(torch.stack([zt + r1 - r + rt, r2, r3]))


def matmul_tr(ctx: TridentContext, x: RShare, y: RShare,
              malicious: bool = True) -> RShare:
    return truncate(ctx, matmul(ctx, x, y, malicious), malicious)
