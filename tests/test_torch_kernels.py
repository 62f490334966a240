"""The port's kernel wrappers (repro_torch.kernels.ops) on the CPU, where
each takes its kernel's plain PyTorch version, against the JAX package's
Pallas kernels run as its own tests run them (interpret mode), word for
word, at ragged shapes and both ring widths; plus the routing rules that
keep a non-CPU tensor off the plain path.  The kernels themselves run only
on the card (tests/test_torch_cuda.py)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one intra-op thread, so idle torch threads do not spin
# beside the JAX tests that share this worker
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import prf as JPRF  # noqa: E402
from repro.core.ring import RING32 as J32, RING64 as J64  # noqa: E402
from repro.kernels import ops as JOPS  # noqa: E402
from repro_torch.core.prf import ThreefryKey  # noqa: E402
from repro_torch.core.ring import words_from_numpy, words_to_numpy  # noqa: E402
from repro_torch.kernels import gamma_parts as GP  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import prf_mask as PM  # noqa: E402
from repro_torch.kernels import ring_matmul as RM  # noqa: E402

UNSIGNED = {64: np.uint64, 32: np.uint32}
T_DTYPE = {64: torch.int64, 32: torch.int32}


def _words(rng, ell, *shape):
    return rng.randint(0, 2**ell, size=shape, dtype=np.uint64).astype(
        UNSIGNED[ell])


def _same(got, want) -> bool:
    want = np.asarray(want)
    got = words_to_numpy(got)
    return got.dtype == want.dtype and np.array_equal(got, want)


def test_ring_matmul_matches_limb_kernel():
    """The wrapper's plain version and the tensor-core kernel's limb
    arithmetic (8-bit limbs, s32 sums over K chunks) against the JAX
    package's limb_matmul, with small forced K chunks; and all-ones words,
    which maximise every limb sum, at the exactness bound's chunk edge."""
    for ell in (64, 32):
        for M, K, N in [(5, 7, 3), (70, 10, 9), (3, 300, 2)]:
            rng = np.random.RandomState(M + K + N + ell)
            a, b = _words(rng, ell, M, K), _words(rng, ell, K, N)
            want = JOPS.ring_matmul(jnp.asarray(a), jnp.asarray(b))
            ta, tb = words_from_numpy(a), words_from_numpy(b)
            assert _same(ops.ring_matmul(ta, tb), want), (ell, M, K, N)
            for chunk in (1, 3, 32, RM.max_k_chunk(ell)):
                got = RM.ring_matmul_limbs_plain(ta, tb, chunk)
                assert _same(got, want), (ell, M, K, N, chunk)
        top = RM.max_k_chunk(ell)
        assert top == {64: 4128, 32: 8256}[ell]
        ones_a = torch.full((2, top + 5), -1, dtype=T_DTYPE[ell])
        ones_b = torch.full((top + 5, 3), -1, dtype=T_DTYPE[ell])
        assert torch.equal(RM.ring_matmul_limbs_plain(ones_a, ones_b, top),
                           torch.matmul(ones_a, ones_b)), ell
        # the bound is tight: all-ones words over one word more per chunk
        # would leave s32 on the top diagonal, so that chunk is refused
        L = ell // 8
        assert L * 255**2 * top <= 2**31 - 1 < L * 255**2 * (top + 1)
        with pytest.raises(ValueError, match="k_chunk"):
            RM.ring_matmul_limbs_plain(ones_a, ones_b, top + 1)


def test_mpc_matmul_grid_matches():
    for ell in (64, 32):
        rng = np.random.RandomState(ell)
        xs = [_words(rng, ell, 6, 5) for _ in range(3)]
        ys = [_words(rng, ell, 5, 4) for _ in range(3)]
        want = JOPS.mpc_matmul_grid([jnp.asarray(x) for x in xs],
                                    [jnp.asarray(y) for y in ys])
        got = ops.mpc_matmul_grid([words_from_numpy(x) for x in xs],
                                  [words_from_numpy(y) for y in ys])
        for i in range(3):
            for j in range(3):
                assert _same(got[i][j], want[i][j]), (ell, i, j)


# descriptor groups of GROUP_N words: (T, signs, constants, slots holding
# one broadcast word, operands as views at odd word offsets)
GROUP_N = 37
GROUP_CASES = [
    (1, (1,), 0, (), False), (2, (1, -1), 1, ("b0",), True),
    (3, (-1, 1, -1), 2, ("a1", "c1"), False),
    (3, (1, 1, 1), 1, (), True), (2, (-1, -1), 2, ("a0", "b1"), True),
]


def _torch_operand(w, odd):
    """Ring words as a tensor; `odd`: a view one word into a longer one."""
    if not odd:
        return words_from_numpy(w)
    pad = np.concatenate([w.reshape(-1)[:1], w.reshape(-1)])
    return words_from_numpy(pad)[1:].view(w.shape)


def test_grouped_terms_match():
    """The grouped wrappers (ops.mult_terms_group / and_terms_group, plain
    on the CPU) group by group against the JAX package's mult_terms /
    and_terms (interpret mode) on the same words, the broadcast words and
    constants folded into the JAX kernel's (1, T, n) and (1, n) operands;
    the descriptor table the card's launch would take for them; and the
    stacked (J, T, n) wrappers."""
    for ell in (64, 32):
        rng = np.random.RandomState(ell)
        cases, n = GROUP_CASES, GROUP_N
        mult, xor, wants = [], [], []
        for T, signs, nc, one, odd in cases:
            def word(slot):
                return _words(rng, ell, *((1,) if slot in one else (n,)))
            a = [word(f"a{t}") for t in range(T)]
            b = [word(f"b{t}") for t in range(T)]
            c = [word(f"c{k}") for k in range(nc)]
            full = [np.broadcast_to(v, (n,)) for v in (*a, *b)]
            ja = jnp.asarray(np.stack(full[:T])[None])
            jb = jnp.asarray(np.stack(full[T:])[None])
            csum = np.zeros(n, UNSIGNED[ell])
            cxor = np.zeros(n, UNSIGNED[ell])
            for v in c:
                csum = csum + v
                cxor = cxor ^ v
            wants.append((JOPS.mult_terms(ja, jb, jnp.asarray(csum[None]),
                                          signs)[0],
                          JOPS.and_terms(ja, jb,
                                         jnp.asarray(cxor[None]))[0]))
            pairs = [(_torch_operand(x, odd and x.size > 1),
                      _torch_operand(y, odd and y.size > 1))
                     for x, y in zip(a, b)]
            consts = tuple(_torch_operand(v, odd and v.size > 1) for v in c)
            mult.append((pairs, consts, signs))
            xor.append((pairs, consts))
        got_m = ops.mult_terms_group(mult)
        got_x = ops.and_terms_group(xor)
        for k, (wm, wx) in enumerate(wants):
            assert _same(got_m[k], wm), (ell, k)
            assert _same(got_x[k], wx), (ell, k)
        # the card's descriptor table for these groups, from CPU tensors
        outs = GP.group_outputs([GP.group_shape(g) for g in mult],
                                T_DTYPE[ell], "cpu")
        assert all(o.data_ptr() % GP.ALIGN == 0 for o in outs)
        desc = GP.describe_groups(mult, outs)
        assert desc.count == len(cases)
        for g, (T, signs, nc, one, odd) in zip(desc.g, cases):
            assert (g.n, g.terms, g.consts) == (n, T, nc)
            assert g.neg == sum(1 << t for t, s in enumerate(signs) if s < 0)
            slots = [f"a{t}" for t in range(3)] + \
                [f"b{t}" for t in range(3)] + ["c0", "c1"]
            assert g.bcast == sum(1 << i for i, sl in enumerate(slots)
                                  if sl in one)
            assert g.vec == int(not odd), (ell, T, odd)
        with pytest.raises(ValueError, match="at most 16 groups"):
            GP.describe_groups(mult * 4, outs * 4)
    # the stacked (J, T, n) form: one group per row
    for ell in (64, 32):
        for (J, T, n), signs in [((3, 3, 7), (1, 1, 1)),
                                 ((4, 2, 600), (1, -1)),
                                 ((1, 3, 512), (-1, 1, -1))]:
            rng = np.random.RandomState(n + ell)
            a, b = _words(rng, ell, J, T, n), _words(rng, ell, J, T, n)
            c = _words(rng, ell, J, n)
            ja, jb, jc = (jnp.asarray(v) for v in (a, b, c))
            ta, tb, tc = (words_from_numpy(v) for v in (a, b, c))
            assert _same(ops.mult_terms(ta, tb, tc, signs),
                         JOPS.mult_terms(ja, jb, jc, signs)), \
                (ell, J, T, n, signs)
            assert _same(ops.and_terms(ta, tb, tc),
                         JOPS.and_terms(ja, jb, jc)), (ell, J, T, n)


def test_lambda_masks_matches_prf_kernel():
    key64 = (0x243F6A8885A308D3 << 1 | 1) & (2**64 - 1)
    for n, counter0 in [(7, 0), (513, 0), (1000, 4096)]:
        want = JOPS.lambda_masks(jnp.asarray([key64], jnp.uint64), n,
                                 counter0)
        assert _same(PM.prf_mask_plain(key64, n, counter0), want), \
            (n, counter0)
    # the grouped draw (more streams than the joint adder's 78 -- one
    # launch on the card --, shifts and empty streams included) against the
    # JAX package's per-stream draws
    jkey = jax.random.fold_in(jax.random.key(7), 0b1101)
    tkey = ThreefryKey.from_seed(7).fold_in(0b1101)
    for ell, jring in ((64, J64), (32, J32)):
        kinds = [((3, 5), None), ((7,), ell - 4), ((0,), None), ((2, 2), 1),
                 ((513,), None), ((4,), 20), ((1,), ell - 1), ((6,), None),
                 ((9,), 13)]
        draws = [(c, *kinds[c % len(kinds)]) for c in range(81)]
        streams = [(tkey.data, c, shape, 0 if bits is None else ell - bits)
                   for c, shape, bits in draws]
        got = ops.lambda_masks_group(streams, T_DTYPE[ell], device="cpu")
        for g, (c, shape, bits) in zip(got, draws):
            want = JPRF.prf_bits(jkey, c, shape, jring) if bits is None \
                else JPRF.prf_bounded(jkey, c, shape, jring, bits)
            assert _same(g, want), (ell, c, shape, bits)
        # the kernel's descriptor table, and its tiling emulated: each
        # warp's tile lies in one stream, every word of every stream is
        # written once, and every full chunk is a 16-byte store
        sized = [(kd, c, int(np.prod(shape)), sh)
                 for kd, c, shape, sh in streams]
        elsize, vec = ell // 8, 16 // (ell // 8)
        for misalign in range(vec):
            table, tiles = PM.describe_group(sized, elsize, misalign)
            raw = bytes(table)
            count, mis, ntiles, _ = PM._HEADER.unpack_from(raw, 0)
            assert (count, mis, ntiles) == (len(sized), misalign, tiles)
            desc = [PM._STREAM.unpack_from(raw, PM._HEADER.size
                                           + k * PM._STREAM.size)
                    for k in range(count)]
            written = []
            for t in range(tiles):
                s = max(k for k, d in enumerate(desc) if d[6] <= t)
                k0, k1, ctr, shift, off, n, first = desc[s]
                assert ((k0, k1), ctr, n, shift) == sized[s][:2] + (
                    sized[s][2], sized[s][3])
                head = (mis + off) % vec
                for j in range(PM.TILE_WORDS // vec):   # a lane's chunk
                    i = (t - first) * PM.TILE_WORDS + j * vec - head
                    if i >= 0 and i + vec <= n:
                        assert (mis + off + i) % vec == 0
                    written += [off + i + e for e in range(vec)
                                if 0 <= i + e < n]
            assert sorted(written) == list(range(sum(d[5] for d in desc)))
        with pytest.raises(ValueError, match="1 to 120 streams"):
            PM.describe_group(sized * 2, elsize, 0)


def test_wrappers_route_by_device():
    """CPU tensors take the plain versions and count no launch; a tensor
    off the CPU goes to the kernel or raises -- here (a meta tensor, no
    CUDA) it raises before any pointer is passed."""
    ops.reset_launches()
    calls = [
        lambda t: ops.ring_matmul(t, t),
        lambda t: ops.mpc_matmul_grid([t, t], [t]),
        lambda t: ops.mult_terms(t[None], t[None], t[:1], (1,) * 4),
        lambda t: ops.and_terms(t[None], t[None], t[:1]),
        lambda t: ops.mult_terms_group([([(t, t), (t[:1], t)], (t,),
                                         (1, -1))] * 17),
        lambda t: ops.and_terms_group([([(t, t[0, 0])], ())]),
        lambda t: ops.lambda_masks_group([((1, 2), 0, (8,), 0)],
                                         torch.int64, device=t.device),
        lambda t: ops.mpc_matmul_fused(t, t.expand(3, 4, 4), t,
                                       t.expand(3, 4, 4)),
        lambda t: ops.and_level(t, t, t[:3], t[:3]),
        lambda t: ops.ppa_add(t, t, t.new_zeros((13, 6, 4)), 1),
        lambda t: ops.prefix_or(t, t.new_zeros((6, 3, 4)), -1),
        lambda t: ops.msb_of_sum_words(t[0], t[1], t.new_zeros((7, 3, 4)),
                                       t.new_zeros((7, 3, 4))),
    ]
    for call in calls:
        call(torch.ones((4, 4), dtype=torch.int64))
    assert all(k.launches == 0 for k in ops.KERNELS)
    # a grouped, fused or and_level call counts as a call on either device
    assert (ops.MULT_TERMS.calls, ops.AND_TERMS.calls) == (2, 2)
    assert (ops.MPC_MATMUL_FUSED.calls, ops.AND_LEVEL.calls) == (1, 3)
    assert (ops.PRF_MASK.calls, ops.PPA_MSB.calls) == (1, 1)
    meta = torch.empty((4, 4), dtype=torch.int64, device="meta")
    for call in calls:
        with pytest.raises(ValueError, match="CUDA"):
            call(meta)


def test_k_chunk_covers_k_in_kernel_steps():
    for M, N, K in [(128, 128, 2352), (384, 384, 784), (128, 10, 128),
                    (1, 1, 5), (4000, 4000, 64)]:
        chunk = RM.k_chunk(M, N, K, 264)
        chunks = -(-K // chunk)
        tiles = -(-M // RM.TILE) * -(-N // RM.TILE)
        assert chunk % RM.STEP_K == 0 and chunk >= RM.STEP_K
        assert chunk <= RM.max_k_chunk(64)
        assert (chunks - 1) * chunk < K <= chunks * chunk
        assert chunks == 1 or tiles * chunks <= 2 * 264
