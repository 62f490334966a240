"""The port's party runtime (repro_torch.runtime) against the JAX runtime,
protocol by protocol: the same program on the same seed must open the same
ring words, leave the same share components at every party, move the same
bits on every link in the same rounds, and agree on the abort flag -- under
both of the port's kernel backends ("torch", and "hopper" on the CPU, where
every kernel wrapper takes its plain version) -- at RING64 and at RING32.
The JAX reference (``kernel_backend="jnp"``) runs once per program and
ring."""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one intra-op thread, so idle torch threads do not spin
# beside the JAX tests that share this worker
torch.set_num_threads(1)

from repro.core.ring import RING32 as J32, RING64 as J64  # noqa: E402
from repro.runtime import FourPartyRuntime as JRuntime  # noqa: E402
from repro.runtime import activations as JA  # noqa: E402
from repro.runtime import boolean as JB  # noqa: E402
from repro.runtime import conversions as JC  # noqa: E402
from repro.obs.registry import MetricsRegistry as JRegistry  # noqa: E402
from repro.runtime import protocols as JP  # noqa: E402
from repro.runtime.kernel_backend import MeteredKernels as JMetered  # noqa: E402
from repro_torch.core.ring import (RING32 as T32, RING64 as T64,  # noqa: E402
                                   words_from_numpy, words_to_numpy)
from repro_torch.kernels import ops as TOPS  # noqa: E402
from repro_torch.runtime import FourPartyRuntime as TRuntime  # noqa: E402
from repro_torch.runtime import activations as TA  # noqa: E402
from repro_torch.runtime import boolean as TB  # noqa: E402
from repro_torch.runtime import conversions as TC  # noqa: E402
from repro_torch.obs import MetricsRegistry as TRegistry  # noqa: E402
from repro_torch.runtime import protocols as TP  # noqa: E402
from repro_torch.runtime.kernel_backend import (  # noqa: E402
    MeteredKernels as TMetered)

SEED = 5
_rng = np.random.RandomState(2024)
X1 = _rng.randn(3, 4) * 2.0
X2 = _rng.randn(3, 4)
W = _rng.randn(4, 2)
WORDS = _rng.randint(0, 1 << 30, (3, 4)).astype(np.uint64)
RINGS = {64: (J64, T64), 32: (J32, T32)}


def _unsigned(ell):
    return np.uint64 if ell == 64 else np.uint32


def jax_pkg(ell=64):
    ring = RINGS[ell][0]
    return types.SimpleNamespace(
        P=JP, B=JB, C=JC, A=JA, ell=ell,
        runtime=lambda: JRuntime(ring, seed=SEED, kernel_backend="jnp"),
        metered=lambda inner: JMetered(inner, registry=JRegistry()),
        enc=lambda rt, x: rt.ring.encode(x),
        words=lambda v: np.asarray(v, _unsigned(ell)),
        np=lambda v: np.asarray(v),
        round_calls=lambda: None)


def torch_pkg(backend, ell=64):
    ring = RINGS[ell][1]
    return types.SimpleNamespace(
        P=TP, B=TB, C=TC, A=TA, ell=ell,
        runtime=lambda: TRuntime(ring, seed=SEED, kernel_backend=backend,
                                 device="cpu"),
        metered=lambda inner: TMetered(inner, registry=TRegistry()),
        enc=lambda rt, x: rt.encode(x),
        words=lambda v: words_from_numpy(np.asarray(v, _unsigned(ell))),
        np=words_to_numpy,
        # grouped-kernel wrapper calls (counted on the CPU too): one per
        # protocol round on the "hopper" backend
        round_calls=lambda: (TOPS.MULT_TERMS.calls, TOPS.AND_TERMS.calls))


def _share(L, rt, x):
    return L.P.share(rt, L.enc(rt, x))


# each program returns (opened {party: words}, share whose views to compare)
def p_share(L, rt):
    return L.P.reconstruct(rt, _share(L, rt, X1)), None


def p_mult(L, rt):
    return L.P.reconstruct(rt, L.P.mult(rt, _share(L, rt, X1),
                                        _share(L, rt, X2))), None


def p_mult_tr(L, rt):
    return L.P.reconstruct(rt, L.P.mult_tr(rt, _share(L, rt, X1),
                                           _share(L, rt, X2))), None


def p_dotp(L, rt):
    return L.P.reconstruct(rt, L.P.dotp(rt, _share(L, rt, X1),
                                        _share(L, rt, X2))), None


def p_scale_public(L, rt):
    return L.P.reconstruct(rt, L.P.scale_public(rt, _share(L, rt, X1),
                                                0.75)), None


def p_matmul(L, rt):
    return L.P.reconstruct(rt, L.P.matmul(rt, _share(L, rt, X1),
                                          _share(L, rt, W))), None


def p_matmul_tr(L, rt):
    return L.P.reconstruct(rt, L.P.matmul_tr(rt, _share(L, rt, X1),
                                             _share(L, rt, W))), None


def p_truncate(L, rt):
    x = _share(L, rt, X1).mul_public(L.enc(rt, 0.5))
    return L.P.reconstruct(rt, L.P.truncate_share(rt, x)), None


def p_bit_extract(L, rt):
    b = L.C.bit_extract(rt, _share(L, rt, X1))
    return L.P.reconstruct(rt, L.P.b2a(rt, b)), b


def p_bit_extract_ppa(L, rt):
    b = L.C.bit_extract(rt, _share(L, rt, X1), method="ppa")
    return L.P.reconstruct(rt, L.P.b2a(rt, b)), b


def p_less_than_zero(L, rt):
    b = L.C.less_than_zero(rt, _share(L, rt, X1))
    return L.P.reconstruct(rt, L.P.b2a(rt, b)), b


def p_bit2a(L, rt):
    b = L.C.bit_extract(rt, _share(L, rt, X2))
    return L.P.reconstruct(rt, L.C.bit2a(rt, b)), None


def p_bit_inject(L, rt):
    nb = L.C.bit_extract(rt, _share(L, rt, X1)).invert()
    return L.P.reconstruct(rt, L.C.bit_inject(rt, nb, _share(L, rt, X2))), \
        None


def p_a2b(L, rt):
    b = L.C.a2b(rt, _share(L, rt, X1))
    return L.P.reconstruct(rt, L.P.b2a(rt, b)), b


def p_share_bool(L, rt):
    b = L.P.share_bool(rt, L.words(WORDS))
    return L.P.reconstruct(rt, L.P.b2a(rt, b)), b


def p_and_bshare(L, rt):
    a = L.C.a2b(rt, _share(L, rt, X1))
    b = L.C.a2b(rt, _share(L, rt, X2))
    c = L.B.and_bshare(rt, a, b)
    return L.P.reconstruct(rt, L.P.b2a(rt, c)), c


def p_prefix_or(L, rt):
    pf = L.B.prefix_or(rt, L.C.a2b(rt, _share(L, rt, X2)))
    return {}, pf


def p_relu(L, rt):
    return L.P.reconstruct(rt, L.A.relu(rt, _share(L, rt, X1))), None


def p_sigmoid(L, rt):
    return L.P.reconstruct(rt, L.A.sigmoid(rt, _share(L, rt, X1))), None


def p_rsqrt(L, rt):
    return L.P.reconstruct(rt, L.A.rsqrt(rt, _share(L, rt, RSQRT_IN))), None


def p_smx_softmax(L, rt):
    return L.P.reconstruct(rt, L.A.smx_softmax(rt, _share(L, rt, X1))), None


def p_drelu_from_bit(L, rt):
    nb = L.C.bit_extract(rt, _share(L, rt, X2)).invert()
    return L.P.reconstruct(rt, L.A.drelu_from_bit(rt, nb)), None


def p_mul_by_cached_bit(L, rt):
    _, nb = L.A.relu(rt, _share(L, rt, X1), return_bit=True)
    return L.P.reconstruct(rt, L.A.mul_by_cached_bit(
        rt, nb, _share(L, rt, X2))), None


RSQRT_IN = np.abs(X1) + 0.5          # rsqrt takes x > 0

GROUPS = {
    "arithmetic": (p_share, p_mult, p_mult_tr, p_dotp, p_matmul,
                   p_matmul_tr, p_truncate, p_scale_public),
    "conversions": (p_bit_extract, p_bit_extract_ppa, p_less_than_zero,
                    p_bit2a, p_bit_inject),
    "boolean": (p_share_bool, p_a2b, p_and_bshare, p_prefix_or),
    "activations": (p_relu, p_sigmoid, p_rsqrt, p_smx_softmax,
                    p_drelu_from_bit, p_mul_by_cached_bit),
}

# plain results the opened words must decode to (13 fractional bits)
DECODED = {"mult_tr": X1 * X2, "matmul_tr": X1 @ W,
           "scale_public": X1 * 0.75,
           "relu": np.maximum(X1, 0.0),
           "sigmoid": np.clip(X1 + 0.5, 0.0, 1.0),
           "mul_by_cached_bit": np.where(X1 >= 0, X2, 0.0)}


def run(L, program, tamper=None):
    rt = L.runtime()
    # a registry of this run's own, to read the backend calls by kind
    rt.kernels = L.metered(rt.kernels._inner)
    if tamper is not None:
        rt.transport.tamper(**tamper)
    TOPS.reset_launches()
    opened, sh = program(L, rt)
    views = None
    if sh is not None:
        views = [(None if v.m is None else L.np(v.m),
                  {j: L.np(lv) for j, lv in v.lam.items()})
                 for v in sh.views]
    return {"opened": {p: L.np(v) for p, v in opened.items()},
            "views": views, "per_link": rt.transport.per_link(),
            "totals": rt.transport.totals(), "abort": bool(rt.abort_flag()),
            "calls": {k: c.value for k, c in rt.kernels._counters.items()},
            "round_calls": L.round_calls()}


def _same(a, b):
    return a.dtype == b.dtype and np.array_equal(a, b)


def _same_mod_2_32(a, b):
    return np.array_equal(a.astype(np.uint32), b.astype(np.uint32))


def _assert_matches(got, want, where, wrap32=False):
    assert got["opened"].keys() == want["opened"].keys(), where
    for p in want["opened"]:
        same = _same_mod_2_32 if wrap32 else _same
        assert same(got["opened"][p], want["opened"][p]), \
            f"{where}: P{p} opened"
    if want["views"] is not None:
        for i, ((gm, gl), (wm, wl)) in enumerate(zip(got["views"],
                                                     want["views"])):
            assert (gm is None) == (wm is None), f"{where}: P{i} m"
            assert gm is None or _same(gm, wm), f"{where}: P{i} m"
            assert gl.keys() == wl.keys(), where
            for j in wl:
                assert _same(gl[j], wl[j]), f"{where}: P{i} lambda_{j}"
    assert got["per_link"] == want["per_link"], where
    assert got["totals"] == want["totals"], where
    assert got["abort"] is want["abort"] is False, where
    # the registry counts each PRF draw once (prf_bits / prf_bounded), and
    # every other backend call by kind, as the JAX runtime's MeteredKernels
    # does -- however many launches the grouped draws take
    assert got["calls"] == want["calls"], where


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_protocols_match_jax_runtime(group):
    for ell in RINGS:
        for program in GROUPS[group]:
            name = program.__name__[2:]
            where = f"{name} RING{ell}"
            want = run(jax_pkg(ell), program)
            # each Pi_Mult/Pi_DotP and each AND: 4 gamma-piece and 3
            # online-part calls (as counted by kind), and on the "hopper"
            # backend 2 grouped wrapper calls, one per protocol round,
            # whatever the party count
            mults, ands = (sum(want["calls"].get(f"online.{k}", 0)
                               for k in kinds) // 3
                           for kinds in (("mul", "dotp"), ("bool",)))
            assert want["calls"].get("gamma.mul", 0) \
                + want["calls"].get("gamma.dotp", 0) == 4 * mults, where
            assert want["calls"].get("gamma.bool", 0) == 4 * ands, where
            # ROADMAP F1: at RING32 the reference's dotp sums uint32 words
            # with jnp.sum, which promotes them to uint64 under x64; its
            # words are right mod 2^32 only, so they are compared so
            wrap32 = ell == 32 and name == "dotp"
            for backend in ("torch", "hopper"):
                got = run(torch_pkg(backend, ell), program)
                _assert_matches(got, want, f"{where} [{backend}]", wrap32)
                assert got["round_calls"] == ((2 * mults, 2 * ands)
                                              if backend == "hopper"
                                              else (0, 0)), (where, backend)
            if name in DECODED:
                signed = np.int64 if ell == 64 else np.int32
                opened = got["opened"][1].view(signed) / 2**13
                np.testing.assert_allclose(opened, DECODED[name], atol=2e-3,
                                           err_msg=where)


def test_tamper_flips_abort_in_both_packages():
    for ell in RINGS:
        for tamper in [
            {"tag": ".p1", "delta": 9},              # online part of Pi_Mult
            {"tag": ".g2", "delta": 1},              # offline gamma piece
            # an opening: the top bit of the word (2^31 at RING32, which
            # the reference adds to a uint32 word)
            {"src": 2, "dst": 1, "tag": ".c1", "delta": 1 << (ell - 1)},
        ]:
            want = run(jax_pkg(ell), p_mult, tamper=tamper)
            assert want["abort"] is True, (tamper, ell)
            for backend in ("torch", "hopper"):
                got = run(torch_pkg(backend, ell), p_mult, tamper=tamper)
                assert got["abort"] is True, (tamper, backend, ell)
                assert got["totals"] == want["totals"], (tamper, backend,
                                                         ell)
