"""Declared workloads (``repro/offline/workload.py``): counts and shapes of
protocol invocations, compiled to a canonical program the dealer can walk.

``Workload().matmul_tr((8, 32), (32, 16)).relu((8, 16))`` declares the
preprocessing a serving or training loop will need; ``program()`` turns
the declaration into a deterministic protocol program (inputs shared as
zeros: the offline phase is data-independent, only shapes matter) that the
dealer and the online-only run both execute.  Any data-independent
program is a workload too: hand a predict function to ``dealer.deal``.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.ring import RING64, Ring

# op kind -> number of operand shapes it consumes
_OPS = {
    "mult": 2, "dotp": 2, "matmul": 2, "mult_tr": 2, "matmul_tr": 2,
    "trunc": 1, "and": 2, "a2b": 1, "b2a": 1, "bit2a": 1, "bit_inject": 2,
    "bit_extract": 1, "relu": 1, "sigmoid": 1,
    "reciprocal": 1, "rsqrt": 1, "smx_softmax": 1,
}


@dataclasses.dataclass(frozen=True)
class OpSpec:
    kind: str
    shapes: tuple
    count: int
    options: tuple = ()             # e.g. (("method", "mul"),)


class Workload:
    """Builder: every declaration method takes the operand shape(s) plus
    ``n`` (how many independent instances) and returns self."""

    def __init__(self, ring: Ring = RING64):
        self.ring = ring
        self.ops: list[OpSpec] = []

    def _add(self, kind: str, shapes, n: int, **options) -> "Workload":
        shapes = tuple(tuple(s) for s in shapes)
        if len(shapes) != _OPS[kind]:
            raise ValueError(f"{kind} takes {_OPS[kind]} shapes, got "
                             f"{shapes}")
        self.ops.append(OpSpec(kind, shapes, n,
                               tuple(sorted(options.items()))))
        return self

    def mult(self, shape, n: int = 1):
        return self._add("mult", (shape, shape), n)

    def dotp(self, shape, n: int = 1):
        return self._add("dotp", (shape, shape), n)

    def matmul(self, a, b, n: int = 1):
        return self._add("matmul", (a, b), n)

    def mult_tr(self, shape, n: int = 1):
        return self._add("mult_tr", (shape, shape), n)

    def matmul_tr(self, a, b, n: int = 1):
        return self._add("matmul_tr", (a, b), n)

    def trunc(self, shape, n: int = 1):
        return self._add("trunc", (shape,), n)

    def and_bits(self, shape, n: int = 1):
        return self._add("and", (shape, shape), n)

    def a2b(self, shape, n: int = 1):
        return self._add("a2b", (shape,), n)

    def b2a(self, shape, n: int = 1):
        return self._add("b2a", (shape,), n)

    def bit2a(self, shape, n: int = 1):
        return self._add("bit2a", (shape,), n)

    def bit_inject(self, bit_shape, val_shape, n: int = 1):
        return self._add("bit_inject", (bit_shape, val_shape), n)

    def bit_extract(self, shape, n: int = 1, method: str | None = None):
        return self._add("bit_extract", (shape,), n, method=method)

    def relu(self, shape, n: int = 1):
        return self._add("relu", (shape,), n)

    def sigmoid(self, shape, n: int = 1):
        return self._add("sigmoid", (shape,), n)

    def reciprocal(self, shape, n: int = 1):
        return self._add("reciprocal", (shape,), n)

    def rsqrt(self, shape, n: int = 1):
        return self._add("rsqrt", (shape,), n)

    def smx_softmax(self, shape, n: int = 1):
        return self._add("smx_softmax", (shape,), n)

    # -- introspection -----------------------------------------------------
    def counts(self) -> dict:
        out: dict = {}
        for spec in self.ops:
            out[spec.kind] = out.get(spec.kind, 0) + spec.count
        return out

    def describe(self) -> list:
        return [{"kind": s.kind, "shapes": s.shapes, "count": s.count,
                 **dict(s.options)} for s in self.ops]

    # -- compilation -------------------------------------------------------
    def program(self):
        """The canonical protocol program of this declaration; runs under
        any prep mode (deal / online / inline)."""
        from ..runtime import activations as RA
        from ..runtime import boolean as RB
        from ..runtime import conversions as RC
        from ..runtime import protocols as RT

        ops = list(self.ops)

        def run(rt):
            def zeros(shape):
                return torch.zeros(shape, dtype=rt.ring.dtype,
                                   device=rt.device)

            def arith(shape):
                return RT.share(rt, zeros(shape))

            def boolean(shape, nbits=1):
                return RT.share_bool(rt, zeros(shape), nbits=nbits)

            calls = {
                "mult": lambda s, o: RT.mult(rt, arith(s[0]), arith(s[1])),
                "dotp": lambda s, o: RT.dotp(rt, arith(s[0]), arith(s[1])),
                "matmul": lambda s, o: RT.matmul(rt, arith(s[0]),
                                                 arith(s[1])),
                "mult_tr": lambda s, o: RT.mult_tr(rt, arith(s[0]),
                                                   arith(s[1])),
                "matmul_tr": lambda s, o: RT.matmul_tr(rt, arith(s[0]),
                                                       arith(s[1])),
                "trunc": lambda s, o: RT.truncate_share(rt, arith(s[0])),
                "and": lambda s, o: RB.and_bshare(
                    rt, boolean(s[0]), boolean(s[1]), active_bits=1),
                "a2b": lambda s, o: RC.a2b(rt, arith(s[0])),
                "b2a": lambda s, o: RT.b2a(
                    rt, boolean(s[0], nbits=rt.ring.ell)),
                "bit2a": lambda s, o: RC.bit2a(rt, boolean(s[0])),
                "bit_inject": lambda s, o: RC.bit_inject(
                    rt, boolean(s[0]), arith(s[1])),
                "bit_extract": lambda s, o: RC.bit_extract(
                    rt, arith(s[0]), method=o.get("method")),
                "relu": lambda s, o: RA.relu(rt, arith(s[0])),
                "sigmoid": lambda s, o: RA.sigmoid(rt, arith(s[0])),
                "reciprocal": lambda s, o: RA.reciprocal(rt, arith(s[0])),
                "rsqrt": lambda s, o: RA.rsqrt(rt, arith(s[0])),
                "smx_softmax": lambda s, o: RA.smx_softmax(rt,
                                                           arith(s[0])),
            }
            for spec in ops:
                for _ in range(spec.count):
                    calls[spec.kind](spec.shapes, dict(spec.options))

        return run
