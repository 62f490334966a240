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
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ppa_msb as PPA  # noqa: E402
from repro_torch.kernels import prf_mask as PM  # noqa: E402
from repro_torch.kernels import ring_matmul as RM  # noqa: E402


def _descriptor_groups(words, count: int, dev) -> tuple:
    """`count` groups cycling through T = 1..3 term pairs, 0-2 constants,
    signs, ragged word counts, operands one word into a longer tensor
    (unaligned), one-word (broadcast) operands and expanded views; as
    (CPU groups, the same groups on `dev`)."""
    cpu, card = [], []
    for k in range(count):
        T, nc, n = 1 + k % 3, k % 3, (1, 5, 128, 1000, 16385)[k % 5]
        shape = (n,) if k % 4 else (n // 5 + 1, 5)

        def operand(slot, k=k, shape=shape):
            if (slot + k) % 5 == 0:                    # one broadcast word
                w = words(*(1,) * len(shape))
                return w, w.to(dev)
            if len(shape) == 2 and (slot + k) % 5 == 1:   # expanded view
                w = words(shape[0], 1)
                return w.expand(shape), w.to(dev).expand(shape)
            if k % 2:                                  # unaligned view
                w = words(torch.Size(shape).numel() + 1)
                return w[1:].view(shape), w.to(dev)[1:].view(shape)
            w = words(*shape)
            return w, w.to(dev)

        ops_ = [operand(i) for i in range(2 * T + nc)]
        signs = tuple(-1 if (k + t) % 2 else 1 for t in range(T))
        for side, out in ((0, cpu), (1, card)):
            v = [o[side] for o in ops_]
            out.append(([(v[2 * t], v[2 * t + 1]) for t in range(T)],
                        tuple(v[2 * T:]), signs))
    return cpu, card


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
        # the grouped gamma-piece kernel: the stacked (J, T, n) form (odd
        # n: rows at unaligned offsets; J = 20: two launches) ...
        for J, T, n, signs in [(3, 3, 16384, (1, 1, 1)),
                               (3, 2, 1000, (1, -1)), (1, 3, 5, (-1, 1, -1)),
                               (20, 2, 129, (-1, 1))]:
            a, b, c = words(J, T, n), words(J, T, n), words(J, n)
            dev = [t.to(cuda_device) for t in (a, b, c)]
            assert torch.equal(ops.mult_terms(*dev, signs).cpu(),
                               GP.mult_terms_plain(a, b, c, signs)), \
                (dtype, J, T, n)
            assert torch.equal(ops.and_terms(*dev).cpu(),
                               GP.and_terms_plain(a, b, c)), (dtype, J, T, n)
        # ... and descriptor groups: ragged n, views at odd offsets, one-word
        # operands, 0-2 constants, mixed signs, expanded views, and more
        # groups than one launch takes
        for count in (1, 9, 2 * GP.MAX_GROUPS + 5):
            cpu_groups, dev_groups = _descriptor_groups(words, count,
                                                        cuda_device)
            launches = -(-count // GP.MAX_GROUPS)
            ops.reset_launches()
            got = ops.mult_terms_group(dev_groups)
            want = GP.mult_terms_group_plain(cpu_groups)
            assert ops.MULT_TERMS.launches == launches, count
            for k, (g, w) in enumerate(zip(got, want)):
                assert torch.equal(g.cpu(), w), (dtype, count, k)
            got = ops.and_terms_group([g[:2] for g in dev_groups])
            want = GP.and_terms_group_plain(cpu_groups)
            assert ops.AND_TERMS.launches == launches, count
            for k, (g, w) in enumerate(zip(got, want)):
                assert torch.equal(g.cpu(), w), (dtype, count, k)
        # the fused product on the limb core: the three NN shapes, ragged
        # and odd shapes (one-word copies), and all-ones words, which
        # maximise every limb sum, in chunks at the exactness bound
        for M, K, N in [(5, 37, 3), (128, 784, 128), (128, 128, 128),
                        (128, 128, 10), (70, 300, 65), (65, 33, 66)]:
            ops_ = (words(M, K), words(3, M, K), words(K, N), words(3, K, N))
            got = MF.mpc_matmul_fused_cuda(*(t.to(cuda_device)
                                             for t in ops_))
            for g, w in zip(got, MF.mpc_matmul_fused_plain(*ops_)):
                assert torch.equal(g.cpu(), w), (dtype, M, K, N)
        K = top + 32
        ones = (torch.full((65, K), -1, dtype=dtype),
                torch.full((3, 65, K), -1, dtype=dtype),
                torch.full((K, 66), -1, dtype=dtype),
                torch.full((3, K, 66), -1, dtype=dtype))
        got = MF.mpc_matmul_fused_cuda(*(t.to(cuda_device) for t in ones),
                                       chunk=top)
        for g, w in zip(got, MF.mpc_matmul_fused_plain(*ones)):
            assert torch.equal(g.cpu(), w), (dtype, "all-ones", K)
        for n in (1, 128, 1000, 1 << 20):
            x, y, lamz, zero = (words(4, n), words(4, n), words(3, n),
                                words(3, n))
            dev = [t.to(cuda_device) for t in (x, y, lamz, zero)]
            assert torch.equal(PPA.and_level_cuda(*dev).cpu(),
                               PPA.and_level_plain(x, y, lamz, zero)), n
            assert torch.equal(PPA.and_level_cuda(*dev[:3]).cpu(),
                               PPA.and_level_plain(x, y, lamz)), n
            # the whole adder and prefix-OR chain, faithful (6 draws an
            # AND) and collapsed (3)
            ell = info.bits
            for S in (6, 3):
                add_d = words(PPA.chain_ands(ell, True), S, n)
                or_d = words(PPA.chain_ands(ell, False), S, n)
                for cin in (0, 1):
                    got = PPA.ppa_add_cuda(*dev[:2], add_d.to(cuda_device),
                                           cin)
                    assert torch.equal(got.cpu(), PPA.ppa_add_plain(
                        x, y, add_d, cin)), (dtype, n, S, cin)
                for mask in (-1, (1 << (ell - 3)) - 1):
                    got = PPA.prefix_or_cuda(dev[0], or_d.to(cuda_device),
                                             mask)
                    assert torch.equal(got.cpu(), PPA.prefix_or_plain(
                        x, or_d, mask)), (dtype, n, S, mask)
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
