"""Local-compute backends of the party runtime: the kernel seam
(``repro/runtime/kernel_backend.py``).

Every bilinear local computation a party performs -- gamma pieces offline,
online m_z' parts, the PRF streams feeding both -- goes through the
backend ``FourPartyRuntime`` holds:

  * ``TorchKernels`` ("torch"): per-component PyTorch evaluation through
    the shared algebra, the twin of the JAX package's ``JnpKernels``.  It
    runs on the CPU only: PyTorch has no integer matmul on CUDA;
  * ``HopperKernels`` ("hopper", the default): the same math routed
    through the hand-written kernels (``kernels.ops``).  Pi_Mult and the
    boolean AND take ONE launch per protocol round for all parties: the
    ``*_round`` methods turn every party's gamma pieces (offline) or
    online parts and m_x op m_y (online) into groups of the grouped
    fused multiply-add (XOR/AND) kernel, which reads each party's words in
    place and folds the constants (masks, gamma_j + lambda_z_j) in.
    Pi_DotP takes the same one launch per round for the term products
    (no constants: they have the contracted shape), then contracts the
    last axis and adds the constants, as the JAX package's
    ``PallasKernels`` does.
    Pi_MatMul keeps one ring matmul per gamma piece (its three terms fused
    on the K axis) and a 3x3 all-pairs ring matmul per party online; each
    group of PRF draws is one launch that derives the streams' keys and
    words in-kernel.  On CPU tensors each wrapper takes its kernel's plain
    version.

A round call takes one request per party -- the argument tuple of the
per-party method -- and returns one result per request.  The per-party
methods stay for a process that holds one party.

The two backends are bit-identical: ring arithmetic mod 2^ell and XOR/AND
are exactly associative and commutative, so transcripts, wire bytes and
outputs do not depend on the backend.
"""
from __future__ import annotations

import time

import torch

from ..core import algebra as AL
from ..kernels import ops
from ..obs import get_registry


class TorchKernels:
    """Per-component PyTorch local compute (the shared-algebra path)."""

    name = "torch"

    # -- PRF streams -------------------------------------------------------
    def prf_bits_group(self, draws, ring, device):
        """One tensor per draw ``(key, counter, shape, bits)``: uniform ring
        words (bits None), or uniform over [0, 2^bits).  Through the
        ``prf_mask`` wrapper, which takes the plain per-stream draw on the
        CPU and, on the card, derives the keys and words of a group in one
        launch."""
        return ops.lambda_masks_group(
            [(key.data, ctr, shape, 0 if bits is None else ring.ell - bits)
             for key, ctr, shape, bits in draws], ring.dtype, device)

    # -- arithmetic world (Pi_Mult / Pi_MatMul) ------------------------------
    def gamma_pieces(self, kind, op, lam_x, lam_y, masks, js):
        """{j: gamma piece j} for the pieces in `js`, from this party's
        lambda component dicts.  `masks[j]` is the zero-share mask."""
        return {j: AL.gamma_piece(op, j, lam_x, lam_y, mask=masks[j])
                for j in js}

    def online_parts(self, kind, op, m_x, m_y, lam_x, lam_y, gammas,
                     lam_zs, js):
        """(m_x op m_y, {j: online part j}) for this party's parts `js`.
        `lam_zs[j]` is the additive output mask (-r_j for Pi_MultTr)."""
        parts = {j: AL.mult_online_part(op, lam_x[j], lam_y[j], m_x, m_y,
                                        gammas[j], lam_zs[j]) for j in js}
        return op(m_x, m_y), parts

    # -- one protocol round, all parties: a request is the argument tuple
    # of the per-party method ------------------------------------------------
    def gamma_pieces_round(self, kind, op, requests):
        return [self.gamma_pieces(kind, op, *r) for r in requests]

    def online_parts_round(self, kind, op, requests):
        return [self.online_parts(kind, op, *r) for r in requests]

    def bool_gamma_pieces_round(self, requests):
        return [self.bool_gamma_pieces(*r) for r in requests]

    def bool_online_parts_round(self, requests):
        return [self.bool_online_parts(*r) for r in requests]

    # -- boolean world (secure AND / PPA levels) ---------------------------
    def bool_gamma_pieces(self, lam_x, lam_y, masks, js):
        out = {}
        for j in js:
            acc = None
            for a, b in AL.GAMMA_TERMS[j]:
                t = lam_x[a] & lam_y[b]
                acc = t if acc is None else acc ^ t
            out[j] = acc ^ masks[j]
        return out

    def bool_online_parts(self, m_x, m_y, lam_x, lam_y, gammas, lam_zs, js):
        parts = {j: (lam_x[j] & m_y) ^ (m_x & lam_y[j])
                 ^ gammas[j] ^ lam_zs[j] for j in js}
        return m_x & m_y, parts


class HopperKernels(TorchKernels):
    """Local compute through the hand-written Hopper kernels
    (``kernels.ops``), bit-identical to ``TorchKernels``."""

    name = "hopper"

    # -- arithmetic world --------------------------------------------------
    def gamma_pieces(self, kind, op, lam_x, lam_y, masks, js):
        if kind != "matmul":
            return self.gamma_pieces_round(kind, op,
                                           [(lam_x, lam_y, masks, js)])[0]
        p0, q0 = AL.GAMMA_TERMS[js[0]][0]           # indices this party holds
        if lam_x[p0].dim() != 2 or lam_y[q0].dim() != 2:
            _batched_matmul(lam_x[p0])
            return super().gamma_pieces(kind, op, lam_x, lam_y, masks, js)
        # sum_t A_t @ B_t == [A_1|A_2|A_3] @ [B_1;B_2;B_3]: one ring matmul
        # per piece, the three terms fused on the K axis.
        out = {}
        for j in js:
            terms = AL.GAMMA_TERMS[j]
            a = torch.cat([lam_x[p] for p, _ in terms], dim=1)
            b = torch.cat([lam_y[q] for _, q in terms], dim=0)
            out[j] = ops.ring_matmul(a, b) + masks[j]
        return out

    def online_parts(self, kind, op, m_x, m_y, lam_x, lam_y, gammas,
                     lam_zs, js):
        if kind != "matmul":
            return self.online_parts_round(
                kind, op, [(m_x, m_y, lam_x, lam_y, gammas, lam_zs, js)])[0]
        if m_x.dim() != 2 or m_y.dim() != 2:
            _batched_matmul(m_x)
            return super().online_parts(kind, op, m_x, m_y, lam_x, lam_y,
                                        gammas, lam_zs, js)
        # one 3x3 all-pairs launch: row 0 / column 0 give m_x @ m_y and the
        # four cross products the two parts need.
        p = ops.mpc_matmul_grid([m_x] + [lam_x[j] for j in js],
                                [m_y] + [lam_y[j] for j in js])
        parts = {j: gammas[j] + lam_zs[j] - p[k + 1][0] - p[0][k + 1]
                 for k, j in enumerate(js)}
        return p[0][0], parts

    def gamma_pieces_round(self, kind, op, requests):
        if kind == "matmul":
            return super().gamma_pieces_round(kind, op, requests)
        _elementwise(kind)
        if kind == "mul":
            return _split_pieces(
                ops.mult_terms_group(gamma_groups(requests)), requests)
        # dotp: the term products in one launch, contracted after (exact:
        # ring addition is associative), then the masks added
        got = _split_pieces(_contract(ops.mult_terms_group(
            gamma_groups(requests, consts=False))), requests)
        return [{j: s + r[2][j] for j, s in pieces.items()}
                for pieces, r in zip(got, requests)]

    def online_parts_round(self, kind, op, requests):
        if kind == "matmul":
            return super().online_parts_round(kind, op, requests)
        _elementwise(kind)
        if kind == "mul":
            return _split_parts(
                ops.mult_terms_group(online_groups(requests)), requests)
        got = _split_parts(_contract(ops.mult_terms_group(
            online_groups(requests, consts=False))), requests)
        # r[4], r[5]: the request's gammas and lam_zs
        return [(mm, {j: s + r[4][j] + r[5][j] for j, s in parts.items()})
                for (mm, parts), r in zip(got, requests)]

    # -- boolean world -----------------------------------------------------
    def bool_gamma_pieces(self, lam_x, lam_y, masks, js):
        return self.bool_gamma_pieces_round([(lam_x, lam_y, masks, js)])[0]

    def bool_online_parts(self, m_x, m_y, lam_x, lam_y, gammas, lam_zs, js):
        return self.bool_online_parts_round(
            [(m_x, m_y, lam_x, lam_y, gammas, lam_zs, js)])[0]

    def bool_gamma_pieces_round(self, requests):
        return _split_pieces(ops.and_terms_group(
            gamma_groups(requests, xor=True)), requests)

    def bool_online_parts_round(self, requests):
        return _split_parts(ops.and_terms_group(
            online_groups(requests, xor=True)), requests)


def _group(xor: bool, pairs, consts, signs) -> tuple:
    """A group of ``ops.mult_terms_group``, or of ``ops.and_terms_group``
    (`xor`: the ring's signs dropped)."""
    return (pairs, consts) if xor else (pairs, consts, signs)


def gamma_groups(requests, xor: bool = False, consts: bool = True) -> list:
    """The grouped kernel's groups of an offline round: for each request
    ``(lam_x, lam_y, masks, js)`` and each piece j, the three products
    lam_x[p] lam_y[q] of GAMMA_TERMS[j] with masks[j] as the constant
    (none without `consts`)."""
    return [_group(xor, [(lam_x[p], lam_y[q]) for p, q in AL.GAMMA_TERMS[j]],
                   (masks[j],) if consts else (), (1, 1, 1))
            for lam_x, lam_y, masks, js in requests for j in js]


def online_groups(requests, xor: bool = False, consts: bool = True) -> list:
    """The groups of an online round: for each request ``(m_x, m_y, lam_x,
    lam_y, gammas, lam_zs, js)``, part j = gamma_j + lam_z_j - lam_x[j] m_y
    - m_x lam_y[j] (XOR for an AND; without `consts`, gamma_j and lam_z_j
    are left out) for each j in js, then m_x op m_y."""
    groups = []
    for m_x, m_y, lam_x, lam_y, gammas, lam_zs, js in requests:
        groups += [_group(xor, [(lam_x[j], m_y), (m_x, lam_y[j])],
                          (gammas[j], lam_zs[j]) if consts else (), (-1, -1))
                   for j in js]
        groups.append(_group(xor, [(m_x, m_y)], (), (1,)))
    return groups


def _contract(outs: list) -> list:
    """Pi_DotP's contraction of the last axis of each group's output;
    ``dtype`` keeps int32 words int32 (torch.sum would promote them)."""
    return [o.sum(-1, dtype=o.dtype) for o in outs]


def _split_pieces(outs: list, requests) -> list:
    it = iter(outs)
    return [{j: next(it) for j in r[-1]} for r in requests]


def _split_parts(outs: list, requests) -> list:
    it = iter(outs)
    res = []
    for r in requests:
        parts = {j: next(it) for j in r[-1]}
        res.append((next(it), parts))
    return res


def _batched_matmul(t: torch.Tensor) -> None:
    """Batched operands take the per-component path on the CPU; on CUDA
    there is none (PyTorch has no integer matmul there)."""
    if t.device.type != "cpu":
        raise NotImplementedError(
            "batched (ndim != 2) ring matmul on CUDA: the batched kernel "
            "comes with the LM-stack slice of the port")


def _elementwise(kind: str) -> None:
    if kind not in ("mul", "dotp"):
        raise NotImplementedError(f"hopper backend: no {kind!r} kernel path")


class MeteredKernels:
    """Always-on metering proxy: every backend call increments
    ``trident_kernel_launches_total{kind, backend}`` on the metrics
    registry.  The kind labels match the JAX package's."""

    def __init__(self, inner, registry=None):
        self._inner = inner
        self._reg = registry if registry is not None else get_registry()
        self._counters: dict = {}
        self.name = inner.name

    def _count(self, kind: str) -> None:
        c = self._counters.get(kind)
        if c is None:
            c = self._counters[kind] = self._reg.counter(
                "trident_kernel_launches_total",
                "kernel-backend launches", kind=kind, backend=self.name)
        c.inc()

    def prf_bits_group(self, draws, ring, device):
        # one count per stream, of the JAX package's kind, however many
        # launches the group takes
        for draw in draws:
            self._count("prf_bits" if draw[3] is None else "prf_bounded")
        return self._inner.prf_bits_group(draws, ring, device)

    def gamma_pieces(self, kind, op, lam_x, lam_y, masks, js):
        self._count(f"gamma.{kind}")
        return self._inner.gamma_pieces(kind, op, lam_x, lam_y, masks, js)

    def online_parts(self, kind, op, m_x, m_y, lam_x, lam_y, gammas,
                     lam_zs, js):
        self._count(f"online.{kind}")
        return self._inner.online_parts(kind, op, m_x, m_y, lam_x, lam_y,
                                        gammas, lam_zs, js)

    def bool_gamma_pieces(self, lam_x, lam_y, masks, js):
        self._count("gamma.bool")
        return self._inner.bool_gamma_pieces(lam_x, lam_y, masks, js)

    def bool_online_parts(self, m_x, m_y, lam_x, lam_y, gammas, lam_zs, js):
        self._count("online.bool")
        return self._inner.bool_online_parts(m_x, m_y, lam_x, lam_y,
                                             gammas, lam_zs, js)

    # a round call counts one call of the per-party kind per request, as
    # the JAX runtime's per-party calls are counted
    def gamma_pieces_round(self, kind, op, requests):
        for _ in requests:
            self._count(f"gamma.{kind}")
        return self._inner.gamma_pieces_round(kind, op, requests)

    def online_parts_round(self, kind, op, requests):
        for _ in requests:
            self._count(f"online.{kind}")
        return self._inner.online_parts_round(kind, op, requests)

    def bool_gamma_pieces_round(self, requests):
        for _ in requests:
            self._count("gamma.bool")
        return self._inner.bool_gamma_pieces_round(requests)

    def bool_online_parts_round(self, requests):
        for _ in requests:
            self._count("online.bool")
        return self._inner.bool_online_parts_round(requests)


class TracedKernels:
    """Tracing proxy over a backend (``MeteredKernels``): every request of
    a call becomes a ``kernel.{kind}`` span (backend, kind, shape) on the
    process tracer, so the spans of a kind count what
    ``trident_kernel_launches_total`` counts.  A round call or a PRF draw
    group serves several requests at once; its host interval and device
    time are split evenly over their spans (``group``: the requests of
    the call).  On the card a pair of CUDA timing events on the current
    stream brackets the call -- the staging and the launches it queues --
    and ``Tracer.drain`` reads them into each span's ``device_ms``.
    ``FourPartyRuntime`` installs the proxy only when tracing is enabled,
    so the disabled path holds no proxy and records no event."""

    def __init__(self, inner, tracer, device: torch.device):
        self._inner = inner
        self._tracer = tracer
        self.name = inner.name
        self._device = device if device.type == "cuda" else None

    def __getattr__(self, attr):
        return getattr(self._inner, attr)

    def _call(self, reqs, fn, *args):
        """``fn(*args)`` as the spans of ``reqs``, one ``(kind, shape)``
        per request."""
        events = stream = None
        if self._device is not None:
            stream = torch.cuda.current_stream(self._device)
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            events[0].record(stream)
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            dur = time.perf_counter() - t0
            if events is not None:
                events[1].record(stream)
            n = len(reqs)
            self._tracer.device_spans(
                [(f"kernel.{kind}", {"backend": self.name, "kind": kind,
                                     "shape": list(shape), "group": n})
                 for kind, shape in reqs], "kernel", t0, dur, events)

    def prf_bits_group(self, draws, ring, device):
        return self._call(
            [("prf_bits" if bits is None else "prf_bounded", shape)
             for _, _, shape, bits in draws],
            self._inner.prf_bits_group, draws, ring, device)

    def gamma_pieces(self, kind, op, lam_x, lam_y, masks, js):
        return self._call([(f"gamma.{kind}", masks[js[0]].shape)],
                          self._inner.gamma_pieces, kind, op, lam_x, lam_y,
                          masks, js)

    def online_parts(self, kind, op, m_x, m_y, lam_x, lam_y, gammas,
                     lam_zs, js):
        return self._call([(f"online.{kind}", m_x.shape)],
                          self._inner.online_parts, kind, op, m_x, m_y,
                          lam_x, lam_y, gammas, lam_zs, js)

    def bool_gamma_pieces(self, lam_x, lam_y, masks, js):
        return self._call([("gamma.bool", masks[js[0]].shape)],
                          self._inner.bool_gamma_pieces, lam_x, lam_y,
                          masks, js)

    def bool_online_parts(self, m_x, m_y, lam_x, lam_y, gammas, lam_zs, js):
        return self._call([("online.bool", m_x.shape)],
                          self._inner.bool_online_parts, m_x, m_y, lam_x,
                          lam_y, gammas, lam_zs, js)

    # a request: (lam_x, lam_y, masks, js) offline, (m_x, ...) online
    def gamma_pieces_round(self, kind, op, requests):
        return self._call([(f"gamma.{kind}", r[2][r[3][0]].shape)
                           for r in requests],
                          self._inner.gamma_pieces_round, kind, op, requests)

    def online_parts_round(self, kind, op, requests):
        return self._call([(f"online.{kind}", r[0].shape) for r in requests],
                          self._inner.online_parts_round, kind, op, requests)

    def bool_gamma_pieces_round(self, requests):
        return self._call([("gamma.bool", r[2][r[3][0]].shape)
                           for r in requests],
                          self._inner.bool_gamma_pieces_round, requests)

    def bool_online_parts_round(self, requests):
        return self._call([("online.bool", r[0].shape) for r in requests],
                          self._inner.bool_online_parts_round, requests)


_BACKENDS = {"torch": TorchKernels, "hopper": HopperKernels}


def make_kernel_backend(spec, device: torch.device):
    """A backend by name ("torch" or "hopper"); an instance passes
    through.  "torch" refuses a CUDA device."""
    if not isinstance(spec, str):
        return spec
    if spec not in _BACKENDS:
        raise ValueError(f"unknown kernel backend {spec!r}: expected one of "
                         f"{sorted(_BACKENDS)}")
    if spec == "torch" and device.type != "cpu":
        raise ValueError("the 'torch' kernel backend runs on the CPU only "
                         "(no integer matmul on CUDA): use 'hopper'")
    return _BACKENDS[spec]()
