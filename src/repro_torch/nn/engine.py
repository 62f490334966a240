"""Engine abstraction (``repro/nn/engine.py``): a model runs in the clear
(``PlainEngine``, float64: the correctness oracle) or as a joint simulation
of the 4PC protocols (``TridentEngine``, tensors are [[.]]-shares stacked
in one process); the party-sliced world's engine is ``RuntimeEngine``
(``nn/runtime_engine.py``).

Layers are written once against this interface with *manual* forward /
backward (integer share dtypes have no autograd; the paper hand-codes
backprop for the same reason).

The base class owns the SHARED op surface: public lincomb / scale (with the
power-of-two fast path), the component-aware shape ops (reshape, transpose,
concat, split, take, pad, sum, mean, stack, embed), and the generic
activation compositions (square, silu).  Engines implement only the small
storage seam underneath -- ``_on_parts`` (map a tensor function over the
aligned raw components of their share container), ``_encode_public`` /
``_raw_const`` / ``_mul_public_raw`` / ``_truncate`` (the fixed-point
quartet) -- plus the protocol-specific ops (matmul, mul, activations, io).

Activation fwd methods return (y, cache); the matching *_bwd consumes the
cache.  Shape ops take LOGICAL axes (the component axis of share
containers is handled inside the seam).
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..core import activations as ACT
from ..core import boolean as BW
from ..core import conversions as CV
from ..core import garbled as GW
from ..core import protocols as PR
from ..core.context import TridentContext, resolve_device
from ..core.ring import signed, width_of
from ..core.shares import AShare


def _take(a: torch.Tensor, ids, axis: int) -> torch.Tensor:
    """``jnp.take(a, ids, axis)``: gather along `axis` by an index array
    of any shape."""
    ids = torch.as_tensor(ids, device=a.device)
    axis %= a.dim()
    out = a.index_select(axis, ids.reshape(-1))
    return out.reshape(tuple(a.shape[:axis]) + tuple(ids.shape)
                       + tuple(a.shape[axis + 1:]))


def _pad(a: torch.Tensor, pads) -> torch.Tensor:
    """``jnp.pad(a, pads)`` with zeros; pads = ((before, after), ...) per
    axis."""
    flat = [int(p) for pair in reversed(tuple(pads)) for p in pair]
    return torch.nn.functional.pad(a, flat)


class Engine:
    """Shared op surface over the per-engine storage seam; see
    PlainEngine / TridentEngine."""

    name: str = "abstract"
    is_private: bool = False
    _sum_dtype = None                # ring dtype for share engines

    # --- io (protocol-specific) ----------------------------------------
    def from_plain(self, x):
        raise NotImplementedError

    def to_plain(self, x):
        raise NotImplementedError

    # --- linear algebra (protocol-specific) ----------------------------
    def matmul(self, x, w):
        raise NotImplementedError

    def mul(self, x, y):
        raise NotImplementedError

    # --- storage seam ---------------------------------------------------
    def _on_parts(self, fn, *xs):
        """Apply a tensor function to every aligned raw component of the
        engine's tensor container(s) and rebundle.  Components carry the
        LOGICAL tensor shape; `fn` must be additively homomorphic (all the
        shape ops below are)."""
        raise NotImplementedError

    def _on_parts_multi(self, fn, x, n: int):
        """Like _on_parts, but `fn` returns a list of `n` tensors per
        component (e.g. a split); returns `n` containers."""
        raise NotImplementedError

    def _encode_public(self, c):
        """Public constant/array in the engine's value encoding (fixed
        point for share engines, dtype cast for plain)."""
        raise NotImplementedError

    def _raw_const(self, arr):
        """Public array as a raw word-level constant (no fixed-point
        scaling) -- for 0/1 masks and power-of-two integer factors."""
        raise NotImplementedError

    def _mul_public_raw(self, x, enc):
        """Local product with an already-encoded public factor; NO
        truncation (the caller decides when to drop fractional bits)."""
        raise NotImplementedError

    def _truncate(self, x):
        """Drop one factor of fractional bits after a raw public product
        (identity for plain floats)."""
        raise NotImplementedError

    # --- shared linear surface -----------------------------------------
    def add(self, x, y):
        return x + y

    def sub(self, x, y):
        return x - y

    def neg(self, x):
        return -x

    def add_public(self, x, arr):
        return x + self._encode_public(arr)

    def scale(self, x, c: float):
        """x * c for a public real scalar; public power-of-two scales with
        |c| >= 1 avoid a truncation entirely (integer multiply)."""
        frac = float(c)
        if frac != 0 and (abs(frac) >= 1) and float(abs(frac)).is_integer() \
                and abs(int(frac)) & (abs(int(frac)) - 1) == 0:
            return self._mul_public_raw(x, self._raw_const(int(frac))) \
                if frac > 0 else \
                self._mul_public_raw(self.neg(x), self._raw_const(int(-frac)))
        return self.lincomb_public([(x, c)])

    def mul_public(self, x, arr):
        return self._truncate(self._mul_public_raw(
            x, self._encode_public(arr)))

    def lincomb_public(self, terms):
        """sum_i c_i * x_i for public real c_i with ONE truncation (the
        products share their 2f fractional bits)."""
        acc = None
        for x, c in terms:
            t = self._mul_public_raw(x, self._encode_public(c))
            acc = t if acc is None else self.add(acc, t)
        return self._truncate(acc)

    def mask_public(self, x, mask01):
        """Multiply by a public 0/1 mask: word-level multiply, no
        truncation."""
        return self._mul_public_raw(x, self._raw_const(mask01))

    # --- shared shape ops (logical axes; component axis in the seam) ----
    def reshape(self, x, shape):
        shape = tuple(shape)
        return self._on_parts(lambda a: a.reshape(shape), x)

    def transpose(self, x, axes):
        return self._on_parts(lambda a: a.permute(tuple(axes)), x)

    def concat(self, xs, axis):
        return self._on_parts(lambda *arrs: torch.cat(arrs, dim=axis), *xs)

    def split(self, x, sizes: Sequence[int], axis):
        idx, s = [], 0
        for sz in sizes[:-1]:
            s += sz
            idx.append(s)
        return self._on_parts_multi(
            lambda a: list(torch.tensor_split(a, idx, dim=axis)), x,
            len(sizes))

    def take(self, x, ids, axis=0):
        return self._on_parts(lambda a: _take(a, ids, axis), x)

    def pad_zeros(self, x, pads):
        return self._on_parts(lambda a: _pad(a, pads), x)

    def sum(self, x, axis, keepdims=False):
        kw = {} if self._sum_dtype is None else {"dtype": self._sum_dtype}
        return self._on_parts(
            lambda a: torch.sum(a, dim=axis, keepdim=keepdims, **kw), x)

    def mean(self, x, axis, keepdims=False):
        n = self.shape_of(x)[axis]
        return self.scale(self.sum(x, axis, keepdims=keepdims), 1.0 / n)

    def stack_to_new_axis(self, xs, axis=0):
        return self._on_parts(lambda *arrs: torch.stack(arrs, dim=axis), *xs)

    # --- shared embedding (public token ids: gather is share-local) -----
    def embed(self, table, ids):
        return self._on_parts(lambda t: _take(t, ids, 0), table)

    def embed_bwd(self, table, ids, dy):
        def fn(t, d):
            flat_ids = torch.as_tensor(ids, device=t.device).reshape(-1)
            return torch.zeros_like(t).index_add_(
                0, flat_ids, d.reshape((-1, d.shape[-1])))

        return self._on_parts(fn, table, dy)

    # --- shared activation compositions ---------------------------------
    def square(self, x):
        return self.mul(x, x), x

    def silu(self, x):
        s, (seg, _) = self.sigmoid(x)
        y = self.mul(x, s)
        return y, (x, s, seg)

    def shape_of(self, x):
        return tuple(x.shape)


# ===========================================================================
# Plain (cleartext) engine -- float64.
# ===========================================================================
class PlainEngine(Engine):
    """Cleartext oracle on `device` (CUDA unless the caller says
    otherwise)."""

    name = "plain"
    is_private = False

    def __init__(self, dtype=torch.float64, device=None):
        self.dtype = dtype
        self.device = resolve_device(device)

    def _t(self, x):
        return torch.as_tensor(x, dtype=self.dtype, device=self.device)

    # io
    def from_plain(self, x):
        return self._t(x)

    def to_plain(self, x):
        return x.to(torch.float64)

    def zeros(self, shape):
        return torch.zeros(tuple(shape), dtype=self.dtype, device=self.device)

    # linear algebra
    def matmul(self, x, w):
        return torch.matmul(x, w)

    def mul(self, x, y):
        return x * y

    # storage seam: the container IS the tensor
    def _on_parts(self, fn, *xs):
        return fn(*xs)

    def _on_parts_multi(self, fn, x, n):
        return fn(x)

    def _encode_public(self, c):
        return self._t(c)

    def _raw_const(self, arr):
        return self._t(arr)

    def _mul_public_raw(self, x, enc):
        return x * enc

    def _truncate(self, x):
        return x

    def mean(self, x, axis, keepdims=False):
        # true float mean (the base default is the fixed-point scaled sum)
        return torch.mean(x, dim=axis, keepdim=keepdims)

    def declassify(self, x):
        return x.to(torch.float32)

    # activations (identical approximations to the MPC versions, so the
    # oracle matches up to fixed-point noise)
    def relu(self, x):
        return torch.clamp_min(x, 0), (x > 0)

    def relu_bwd(self, cache, dy):
        return dy * cache.to(self.dtype)

    def sigmoid(self, x):
        y = torch.clamp(x + 0.5, 0.0, 1.0)
        seg = (x > -0.5) & (x < 0.5)
        return y, (seg, y)

    def sigmoid_bwd(self, cache, dy):
        seg, _ = cache
        return dy * seg.to(self.dtype)

    def silu_bwd(self, cache, dy):
        x, s, seg = cache
        return dy * (s + x * seg.to(self.dtype))

    def softmax(self, x, axis=-1, mask=None):
        r = torch.clamp_min(x, 0)
        bit = x > 0
        if mask is not None:
            r = r * self._t(mask)
        s = torch.sum(r, dim=axis, keepdim=True) + 1e-2
        inv = 1.0 / s
        p = r * inv
        return p, (p, inv, bit)

    def softmax_bwd(self, cache, dp, mask=None):
        p, inv, bit = cache
        inner = torch.sum(dp * p, dim=-1, keepdim=True)
        dr = inv * (dp - inner)
        if mask is not None:
            dr = dr * self._t(mask)
        return dr * bit.to(self.dtype)

    def rsqrt(self, x):
        y = torch.rsqrt(torch.clamp_min(x, 1e-9))
        return y, (x, y)

    def reciprocal(self, x):
        return 1.0 / x

    def reveal(self, x):
        return x


# ===========================================================================
# Trident engine -- [[.]]-shares + 4PC protocols (joint simulation).
# ===========================================================================
class TridentEngine(Engine):
    name = "trident"
    is_private = True

    def __init__(self, ctx: TridentContext, nonlinear: str = "garbled"):
        """nonlinear: how division-like ops (reciprocal, rsqrt, softmax
        denominator) are computed.
          "garbled"  -- the paper's route (Section VI-A: switch to the
                        garbled world, evaluate a circuit, switch back);
                        cost-modeled per Table IX, value-emulated.
          "newton"   -- beyond-paper arithmetic-world Newton-Raphson with
                        boolean-world normalization; every bit stays in
                        protocols (the route of the party runtime, so a
                        program on it opens the runtime's words).
        The engine runs on the context's device.
        """
        self.ctx = ctx
        self.ring = ctx.ring
        self.nonlinear = nonlinear
        self._sum_dtype = ctx.ring.dtype

    # io
    def from_plain(self, x):
        return PR.share(self.ctx, self.ctx.encode(x))

    def to_plain(self, x: AShare):
        return self.ring.decode(x.reveal())

    def zeros(self, shape):
        return AShare(torch.zeros((4,) + tuple(shape), dtype=self.ring.dtype,
                                  device=self.ctx.device))

    # linear algebra (all truncating: fixed-point products)
    def matmul(self, x: AShare, w: AShare) -> AShare:
        return PR.matmul_tr(self.ctx, x, w)

    def mul(self, x: AShare, y: AShare) -> AShare:
        return PR.mult_tr(self.ctx, x, y)

    # storage seam: components stacked on axis 0 of .data
    def _on_parts(self, fn, *xs):
        return AShare(torch.stack(
            [fn(*[x.data[k] for x in xs]) for k in range(4)]))

    def _on_parts_multi(self, fn, x, n):
        per_comp = [fn(x.data[k]) for k in range(4)]
        return [AShare(torch.stack([per_comp[k][i] for k in range(4)]))
                for i in range(n)]

    def _encode_public(self, c):
        return self.ctx.encode(c)

    def _raw_const(self, arr):
        if isinstance(arr, int):
            arr = signed(arr, width_of(self.ring.dtype))
        return torch.as_tensor(arr).to(device=self.ctx.device,
                                       dtype=self.ring.dtype)

    def _mul_public_raw(self, x: AShare, enc) -> AShare:
        return x.mul_public(enc)

    def _truncate(self, x: AShare) -> AShare:
        return PR.truncate_share(self.ctx, x)

    def declassify(self, x: AShare):
        """Open to all parties and decode (tallied reconstruction)."""
        return self.ring.decode(PR.reconstruct(self.ctx, x)).to(torch.float32)

    # activations
    def relu(self, x: AShare):
        y, nb = ACT.relu(self.ctx, x, return_bit=True)
        return y, nb

    def relu_bwd(self, cache, dy: AShare) -> AShare:
        return CV.bit_inject(self.ctx, cache, dy)

    def sigmoid(self, x: AShare):
        ctx = self.ctx
        half = ctx.encode(0.5)
        v_hi, v_lo = x + half, x - half
        with ctx.tally.parallel(("offline",)):
            with ctx.tally.parallel():
                with ctx.tally.branch():
                    b1 = CV.bit_extract(ctx, v_hi)
                with ctx.tally.branch():
                    b2 = CV.bit_extract(ctx, v_lo)
            seg = BW.and_bshare(ctx, ~b1, b2, active_bits=1)
        with ctx.tally.parallel():
            with ctx.tally.branch():
                t = CV.bit_inject(ctx, seg, v_hi)
            with ctx.tally.branch():
                d = CV.bit2a(ctx, ~b2)
        y = t + d.mul_public(self.ring.scale)
        return y, (seg, y)

    def sigmoid_bwd(self, cache, dy: AShare) -> AShare:
        seg, _ = cache
        return CV.bit_inject(self.ctx, seg, dy)

    def silu_bwd(self, cache, dy: AShare) -> AShare:
        x, s, seg = cache
        t1 = self.mul(dy, s)
        t2 = CV.bit_inject(self.ctx, seg, self.mul(dy, x))
        return t1 + t2

    def softmax(self, x: AShare, axis=-1, mask=None):
        ctx = self.ctx
        r, bit = ACT.relu(ctx, x, return_bit=True)
        if mask is not None:
            r = r.mul_public(self._raw_const(mask))
        dim = axis if axis < 0 else axis + 1
        s_data = torch.sum(r.data, dim=dim, keepdim=True,
                           dtype=self.ring.dtype)
        s = AShare(s_data) + ctx.encode(1e-2)
        inv = self.reciprocal(s)
        inv_b = AShare(inv.data.broadcast_to(r.data.shape))
        p = PR.mult_tr(ctx, r, inv_b)
        return p, (p, inv, bit)

    def softmax_bwd(self, cache, dp: AShare, mask=None) -> AShare:
        p, inv, bit = cache
        ctx = self.ctx
        prod = PR.mult_tr(ctx, dp, p)
        inner = AShare(torch.sum(prod.data, dim=-1, keepdim=True,
                                 dtype=self.ring.dtype))
        diff = dp - inner
        inv_b = AShare(inv.data.broadcast_to(diff.data.shape))
        dr = PR.mult_tr(ctx, diff, inv_b)
        if mask is not None:
            dr = dr.mul_public(self._raw_const(mask))
        return CV.bit_inject(ctx, bit, dr)

    def rsqrt(self, x: AShare):
        if self.nonlinear == "garbled":
            y = GW.garbled_rsqrt(self.ctx, x)
        else:
            y = ACT.rsqrt(self.ctx, x)
        return y, (x, y)

    def reciprocal(self, x: AShare):
        if self.nonlinear == "garbled":
            return GW.garbled_reciprocal(self.ctx, x)
        return ACT.reciprocal(self.ctx, x)

    def reveal(self, x: AShare):
        """Declassify (tallied as a reconstruction)."""
        return PR.reconstruct(self.ctx, x)
