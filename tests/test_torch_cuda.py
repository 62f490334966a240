"""The hand-written Hopper kernels on the card, each against its plain
PyTorch version, word for word, on 64- and 32-bit ring words.  They need
an NVIDIA GPU and skip without one.  This file imports neither jax nor the
JAX package, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
        tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import gamma_parts as GP  # noqa: E402
from repro_torch.kernels import mpc_matmul_fused as MF  # noqa: E402
from repro_torch.kernels import ppa_msb as PPA  # noqa: E402
from repro_torch.kernels import prf_mask as PM  # noqa: E402
from repro_torch.kernels import ring_matmul as RM  # noqa: E402


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernels_equal_plain_on_card(cuda_device):
    rng = np.random.RandomState(3)
    for dtype in (torch.int64, torch.int32):
        info = torch.iinfo(dtype)

        def words(*shape):
            return torch.from_numpy(rng.randint(
                info.min, info.max, size=shape, dtype=np.int64)).to(dtype)

        for M, K, N in [(5, 7, 3), (128, 2352, 128), (384, 784, 384),
                        (70, 300, 65)]:
            a, b = words(M, K), words(K, N)
            got = RM.ring_matmul_cuda(a.to(cuda_device), b.to(cuda_device))
            assert torch.equal(got.cpu(), RM.ring_matmul_plain(a, b)), \
                (dtype, M, K, N)
        # all-ones words maximise every limb sum; K spans two chunks of the
        # exactness bound, with an odd K (one-word copies) beside it
        top = RM.max_k_chunk(info.bits)
        for K in (top + 32, top + 33):
            a = torch.full((65, K), -1, dtype=dtype)
            b = torch.full((K, 66), -1, dtype=dtype)
            got = RM.ring_matmul_cuda(a.to(cuda_device), b.to(cuda_device))
            assert torch.equal(got.cpu(), RM.ring_matmul_plain(a, b)), K
        for J, T, n, signs in [(3, 3, 16384, (1, 1, 1)),
                               (3, 2, 1000, (1, -1)), (1, 3, 5, (-1, 1, -1))]:
            a, b, c = words(J, T, n), words(J, T, n), words(J, n)
            dev = [t.to(cuda_device) for t in (a, b, c)]
            assert torch.equal(GP.mult_terms_cuda(*dev, signs).cpu(),
                               GP.mult_terms_plain(a, b, c, signs)), \
                (dtype, J, T, n)
            assert torch.equal(GP.and_terms_cuda(*dev).cpu(),
                               GP.and_terms_plain(a, b, c)), (dtype, J, T, n)
        for M, K, N in [(5, 37, 3), (128, 784, 128), (128, 128, 10)]:
            ops_ = (words(M, K), words(3, M, K), words(K, N), words(3, K, N))
            got = MF.mpc_matmul_fused_cuda(*(t.to(cuda_device)
                                             for t in ops_))
            for g, w in zip(got, MF.mpc_matmul_fused_plain(*ops_)):
                assert torch.equal(g.cpu(), w), (dtype, M, K, N)
        for n in (1, 128, 1000, 1 << 20):
            x, y, lamz, zero = (words(4, n), words(4, n), words(3, n),
                                words(3, n))
            dev = [t.to(cuda_device) for t in (x, y, lamz, zero)]
            assert torch.equal(PPA.and_level_cuda(*dev).cpu(),
                               PPA.and_level_plain(x, y, lamz, zero)), n
            assert torch.equal(PPA.and_level_cuda(*dev[:3]).cpu(),
                               PPA.and_level_plain(x, y, lamz)), n
        n = 4096
        x, y = words(n), words(n)
        lamz = words(8, 3, n)
        zero = torch.stack([lamz[:, 0], lamz[:, 1], lamz[:, 0] ^ lamz[:, 1]],
                           dim=1)
        dev = [t.to(cuda_device) for t in (x, y, lamz, zero)]
        got = PPA.ppa_msb(*dev, PPA.and_level_cuda).cpu()
        assert torch.equal(got, PPA.ppa_msb(x, y, lamz, zero,
                                            PPA.and_level_plain))
        ell = torch.iinfo(dtype).bits
        assert torch.equal(got, ((x + y) >> (ell - 1)) & 1)
    key = (0x9E3779B9, 0x7F4A7C15)
    for n, counter in [(1, 0), (100352, 0), (1000, 12345)]:
        one = [(key, counter, n, 0)]            # a lone draw: a group of one
        out = torch.empty(n, dtype=torch.int64, device=cuda_device)
        assert torch.equal(PM.prf_mask_group_cuda(one, out).cpu(),
                           PM.prf_mask_group_plain(one, torch.int64)), n
    # grouped draws: every stream's key derived on the card, shifts, an
    # empty stream, both word widths
    for dtype in (torch.int64, torch.int32):
        ell = torch.iinfo(dtype).bits
        streams = [((0x243F6A88, 0x85A308D3 + j), 2**32 + 7 * j, n, shift)
                   for j, (n, shift) in enumerate(
                       [(100352, 0), (5, ell - 1), (0, 0), (1000, 20),
                        (3, 1), (257, 0), (1, 4), (64, ell - 13)])]
        for count in (1, 3, 8):
            part = streams[:count]
            out = torch.empty(sum(s[2] for s in part), dtype=dtype,
                              device=cuda_device)
            assert torch.equal(PM.prf_mask_group_cuda(part, out).cpu(),
                               PM.prf_mask_group_plain(part, dtype)), \
                (dtype, count)
