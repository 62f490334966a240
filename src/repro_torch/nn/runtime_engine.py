"""RuntimeEngine: the Engine backed by the party-sliced runtime
(``repro/nn/runtime_engine.py``).

The third execution world beside ``PlainEngine`` and ``TridentEngine``:
tensors are ``DistAShare``s (four per-party views), every protocol moves
its messages through the runtime's measured ``Transport``, and offline
material flows through the runtime's prep seam, so the same nn/train
program runs inline, dealt ahead, or online-only without change.

Bit-identity contract: a program run on ``RuntimeEngine`` from seed s
opens the same words as the same program on
``TridentEngine(make_context(seed=s), nonlinear="newton")`` -- every op
here composes the runtime twins of the protocol calls the joint engine
makes, in the same PRF counter order.  Tensors live on the runtime's
device.

Layering: this module lives in nn/ but imports runtime/ (not the other way
around); nn/engine.py stays free of runtime machinery.
"""
from __future__ import annotations

import torch

from ..core.algebra import PARTIES
from ..core.ring import signed, width_of
from ..runtime import activations as RA
from ..runtime import conversions as RC
from ..runtime import protocols as RT
from ..runtime.party import (DistAShare, PartyAView, map_components,
                             map_components_multi)
from ..runtime.runtime import FourPartyRuntime
from .engine import Engine


class RuntimeEngine(Engine):
    name = "runtime"
    is_private = True

    def __init__(self, rt: FourPartyRuntime):
        self.rt = rt
        self.ring = rt.ring
        self._sum_dtype = rt.ring.dtype

    # io
    def from_plain(self, x):
        return RT.share(self.rt, self.rt.encode(x))

    def to_plain(self, x: DistAShare):
        return self.ring.decode(RT.reconstruct(self.rt, x)[1])

    def zeros(self, shape):
        z = torch.zeros(tuple(shape), dtype=self.ring.dtype,
                        device=self.rt.device)
        views = [PartyAView(None if i == 0 else z,
                            {j: z for j in (1, 2, 3) if j != i})
                 for i in PARTIES]
        return DistAShare(tuple(views), tuple(shape), self.ring.dtype)

    # linear algebra (all truncating: fixed-point products)
    def matmul(self, x: DistAShare, w: DistAShare) -> DistAShare:
        return RT.matmul_tr(self.rt, x, w)

    def mul(self, x: DistAShare, y: DistAShare) -> DistAShare:
        return RT.mult_tr(self.rt, x, y)

    # storage seam: four per-party views (m + held lambdas)
    def _on_parts(self, fn, *xs):
        return map_components(fn, *xs)

    def _on_parts_multi(self, fn, x, n):
        return map_components_multi(fn, x, n)

    def _encode_public(self, c):
        return self.rt.encode(c)

    def _raw_const(self, arr):
        if isinstance(arr, int):
            arr = signed(arr, width_of(self.ring.dtype))
        return self.rt.words(arr)

    def _mul_public_raw(self, x: DistAShare, enc) -> DistAShare:
        return x.mul_public(enc)

    def _truncate(self, x: DistAShare) -> DistAShare:
        return RT.truncate_share(self.rt, x)

    def declassify(self, x: DistAShare):
        """Open to all parties and decode (measured reconstruction)."""
        return self.to_plain(x).to(torch.float32)

    # activations (the runtime twins, in the joint engine's op order)
    def relu(self, x: DistAShare):
        return RA.relu(self.rt, x, return_bit=True)

    def relu_bwd(self, cache, dy: DistAShare) -> DistAShare:
        return RC.bit_inject(self.rt, cache, dy)

    def sigmoid(self, x: DistAShare):
        y, seg = RA.sigmoid(self.rt, x, return_cache=True)
        return y, (seg, y)

    def sigmoid_bwd(self, cache, dy: DistAShare) -> DistAShare:
        seg, _ = cache
        return RC.bit_inject(self.rt, seg, dy)

    def silu_bwd(self, cache, dy: DistAShare) -> DistAShare:
        x, s, seg = cache
        t1 = self.mul(dy, s)
        t2 = RC.bit_inject(self.rt, seg, self.mul(dy, x))
        return t1 + t2

    def softmax(self, x: DistAShare, axis=-1, mask=None):
        return RA.smx_softmax(self.rt, x, axis=axis, mask=mask,
                              return_cache=True)

    def softmax_bwd(self, cache, dp: DistAShare, mask=None) -> DistAShare:
        p, inv, bit = cache
        rt = self.rt
        prod = RT.mult_tr(rt, dp, p)
        # dtype keeps int32 words int32 (torch.sum would promote them)
        inner = map_components(
            lambda a: torch.sum(a, dim=-1, keepdim=True,
                                dtype=self.ring.dtype), prod)
        diff = dp - inner
        inv_b = map_components(lambda a: a.expand(diff.shape), inv)
        dr = RT.mult_tr(rt, diff, inv_b)
        if mask is not None:
            dr = dr.mul_public(self._raw_const(mask))
        return RC.bit_inject(rt, bit, dr)

    def rsqrt(self, x: DistAShare):
        y = RA.rsqrt(self.rt, x)
        return y, (x, y)

    def reciprocal(self, x: DistAShare):
        return RA.reciprocal(self.rt, x)

    def reveal(self, x: DistAShare):
        """Declassify to plaintext ring words (identical at every party;
        party 1's copy is returned)."""
        return RT.reconstruct(self.rt, x)[1]
