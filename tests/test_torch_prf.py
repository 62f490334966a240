"""The port's key schedule and PRF (repro_torch.core.prf) against the JAX
package: the threefry2x32 twin of jax.random.key / fold_in / key_data, the
per-invocation squares key, and the ring-word streams -- every later
bit-identity between the two packages rests on these."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one intra-op thread, so idle torch threads do not spin
# beside the JAX tests that share this worker
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.core import prf as JP  # noqa: E402
from repro.core.ring import RING32 as J32, RING64 as J64  # noqa: E402
from repro_torch.core import prf as TP  # noqa: E402
from repro_torch.core.ring import (RING32 as T32, RING64 as T64,  # noqa: E402
                                   words_to_numpy)
from repro_torch.kernels.prf_mask import prf_mask_group_plain  # noqa: E402

RINGS = {64: (J64, T64), 32: (J32, T32)}


def _key_data(k) -> tuple:
    return tuple(int(v) for v in np.asarray(jax.random.key_data(k)))


def test_threefry_twin_matches_jax_random():
    for seed in [0, 1, 11, 12345, 2**31 + 7, 2**40 + 3]:
        rng = np.random.RandomState(seed % 2**32)
        jkey = jax.random.key(seed)
        tkey = TP.ThreefryKey.from_seed(seed)
        assert tkey.data == _key_data(jkey), seed
        for data in [0, 1, 3, 15, 2**32 - 1] + list(rng.randint(0, 2**31, 8)):
            assert tkey.fold_in(int(data)).data == \
                _key_data(jax.random.fold_in(jkey, int(data))), (seed, data)
        # two levels, as the runtime derives (master -> subset -> counter)
        for subset in (3, 7, 13, 15):
            js, ts = jax.random.fold_in(jkey, subset), tkey.fold_in(subset)
            for counter in rng.randint(0, 10**6, 4):
                assert ts.fold_in(int(counter)).data == \
                    _key_data(jax.random.fold_in(js, int(counter))), \
                    (seed, subset, counter)


def test_squares_key_matches():
    for seed in (0, 7, 99):
        jkey = jax.random.fold_in(jax.random.key(seed), 0b1011)
        tkey = TP.ThreefryKey.from_seed(seed).fold_in(0b1011)
        for counter in (0, 1, 17, 4096):
            want = int(np.asarray(JP.squares_key(jkey, counter))[0])
            got = TP.squares_key(tkey, counter)
            assert got == want and got & 1 and 0 <= got < 2**64


def test_squares_stream_matches():
    key64 = 0x9E3779B97F4A7C15 | 1
    for n, counter0 in [(7, 0), (512, 0), (1000, 12345)]:
        want = np.asarray(JP.squares_stream(
            jax.numpy.asarray([key64], jax.numpy.uint64), n, counter0))
        got = TP.squares_stream(key64, n, counter0)
        assert got.dtype == torch.int64
        assert np.array_equal(words_to_numpy(got), want), (n, counter0)


@pytest.mark.parametrize("ell", [64, 32])
def test_prf_bits_and_bounded_match(ell):
    jring, tring = RINGS[ell]
    jkey = jax.random.fold_in(jax.random.key(42), 0b0111)
    tkey = TP.ThreefryKey.from_seed(42).fold_in(0b0111)
    for shape in [(5,), (3, 7), (2, 3, 4)]:
        for counter in (0, 9, 300):
            want = np.asarray(JP.prf_bits(jkey, counter, shape, jring))
            got = TP.prf_bits(tkey, counter, shape, tring)
            assert got.dtype == tring.dtype and tuple(got.shape) == shape
            assert np.array_equal(words_to_numpy(got), want), \
                (shape, counter)
            for bits in (1, 20, ell - 4):
                want = np.asarray(JP.prf_bounded(jkey, counter, shape, jring,
                                                 bits))
                got = words_to_numpy(TP.prf_bounded(tkey, counter, shape,
                                                    tring, bits))
                assert np.array_equal(got, want), (shape, counter, bits)
                assert int(got.max()) < 2**bits
    # the grouped draw's plain version: every (shape, counter) stream, plain
    # and at each bound, one after the other in one buffer
    streams, wants = [], []
    for shape in [(5,), (3, 7), (2, 3, 4)]:
        for counter in (0, 9, 300):
            for bits in (None, 1, 20, ell - 4):
                shift = 0 if bits is None else ell - bits
                streams.append((tkey.data, counter, TP.numel(shape), shift))
                wants.append(np.asarray(
                    JP.prf_bits(jkey, counter, shape, jring) if bits is None
                    else JP.prf_bounded(jkey, counter, shape, jring, bits)
                ).reshape(-1))
    got = words_to_numpy(prf_mask_group_plain(streams, tring.dtype))
    assert np.array_equal(got, np.concatenate(wants))
