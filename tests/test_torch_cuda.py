"""The hand-written Hopper kernels on the card, each against its plain
PyTorch version, word for word, on 64- and 32-bit ring words; Pi_DotP's
rounds on the "hopper" backend against the "torch" backend's on the CPU;
the store handoff between two streams under stress; and the pipelined
server (each batch dealt on the dealer thread's own CUDA stream and
served online-only on this thread's), every prediction held to the inline
runtime at that batch's seed; one traced batch, its words the untraced
batch's and every kernel span carrying a device time read from CUDA
events; and one task on four party daemons on the card over TCP
(``runtime.net.PartyCluster``), its words and traffic those of the
in-process runtime.  They need an NVIDIA GPU and skip without
one.  This file imports neither jax nor the JAX package, so it runs on a
machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
        tests/test_torch_cuda.py
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs, offline  # noqa: E402
from repro_torch.core.algebra import GAMMA_LOCAL, PART_HOLDERS  # noqa: E402
from repro_torch.core.ring import RING64, words_to_numpy  # noqa: E402
from repro_torch.kernels import gamma_parts as GP  # noqa: E402
from repro_torch.kernels import mpc_matmul_fused as MF  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ppa_msb as PPA  # noqa: E402
from repro_torch.kernels import prf_mask as PM  # noqa: E402
from repro_torch.kernels import ring_matmul as RM  # noqa: E402
from repro_torch.runtime import FourPartyRuntime  # noqa: E402
from repro_torch.runtime.kernel_backend import (  # noqa: E402
    HopperKernels, TorchKernels)
from repro_torch.runtime.net import PartyCluster  # noqa: E402
from repro_torch.serve.party_server import PartyPredictionServer  # noqa: E402
from repro_torch.train.paper_ml import (MLPNet, mlp_net_init,  # noqa: E402
                                        mlp_net_predict_runtime,
                                        params_from_numpy)


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


def _cluster_task(rt, _rank, X=None, params=None):
    """A daemon's task (module level: the daemons are spawned): the small
    NN's prediction over weights encoded on the daemon's device."""
    return mlp_net_predict_runtime(
        rt, params_from_numpy(params, RING64, rt.device),
        MLPNet(16, (8, 8, 4)), X)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _kernel_family(key: str):
    """The span kinds' family (prf, matmul, mul, bool) whose backend calls
    launch the profiled kernel `key`, if any."""
    if "squares_group_kernel" in key:
        return "prf"
    if "ring_matmul_kernel" in key:
        return "matmul"
    if "terms_group_kernel" in key:
        return "bool" if "true" in key else "mul"
    return None


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
        # the training step's products at batch 128 (X^T dz0, dz2 w2^T,
        # h2^T dz2, and logreg's X w and X^T err): each gamma piece
        # (M, 3K) @ (3K, N) and each online grid (3M, K) @ (K, 3N) through
        # the wrappers, the transposed operands as permuted views
        for M, K, N in [(784, 128, 128), (128, 10, 128), (128, 128, 10),
                        (128, 784, 1), (784, 128, 1)]:
            xs = [words(K, M).t() for _ in range(3)]
            ys = [words(K, N) for _ in range(3)]
            dev_xs = [x.to(cuda_device) for x in xs]
            dev_ys = [y.to(cuda_device) for y in ys]
            assert not dev_xs[0].is_contiguous()
            a, b = torch.cat(xs, dim=1), torch.cat(ys, dim=0)
            got = ops.ring_matmul(torch.cat(dev_xs, dim=1),
                                  torch.cat(dev_ys, dim=0))
            assert torch.equal(got.cpu(), RM.ring_matmul_plain(a, b)), \
                (dtype, "gamma", M, K, N)
            got = ops.ring_matmul(dev_xs[0], dev_ys[0])
            assert torch.equal(got.cpu(), RM.ring_matmul_plain(
                xs[0], ys[0])), (dtype, "permuted", M, K, N)
            grid = ops.mpc_matmul_grid(dev_xs, dev_ys)
            want = RM.ring_matmul_plain(torch.cat(xs, dim=0),
                                        torch.cat(ys, dim=1))
            for i in range(3):
                for j in range(3):
                    assert torch.equal(
                        grid[i][j].cpu(),
                        want[i * M:(i + 1) * M, j * N:(j + 1) * N]), \
                        (dtype, "grid", M, K, N, i, j)
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
        # msb(x + y): the loop over the and_level kernel, and the ppa_msb
        # kernel (the whole loop in one launch) on zero shares that XOR to
        # 0 and on shares that do not, at n = 4096 and an odd n
        ell = info.bits
        for n in (4096, 1001):
            x, y = words(n), words(n)
            lamz = words(8, 3, n)
            zero = torch.stack([lamz[:, 0], lamz[:, 1],
                                lamz[:, 0] ^ lamz[:, 1]], dim=1)
            dev = [t.to(cuda_device) for t in (x, y, lamz, zero)]
            loop = PPA.ppa_msb(x, y, lamz, zero, PPA.and_level_plain)
            assert torch.equal(loop, ((x + y) >> (ell - 1)) & 1), n
            got = PPA.ppa_msb(*dev, PPA.and_level_cuda).cpu()
            assert torch.equal(got, loop), (dtype, n)
            ops.reset_launches()
            got = ops.msb_of_sum_words(*dev).cpu()
            assert ops.PPA_MSB.launches == 1 and ops.AND_LEVEL.launches == 0
            assert torch.equal(got, loop), (dtype, n)
            other = words(8, 3, n)
            got = PPA.ppa_msb_cuda(*dev[:3], other.to(cuda_device)).cpu()
            assert torch.equal(got, PPA.ppa_msb(
                x, y, lamz, other, PPA.and_level_plain)), (dtype, n)
    key = (0x9E3779B9, 0x7F4A7C15)
    for n, counter in [(1, 0), (100352, 0), (1000, 12345)]:
        one = [(key, counter, n, 0)]            # a lone draw: a group of one
        out = torch.empty(n, dtype=torch.int64, device=cuda_device)
        assert torch.equal(PM.prf_mask_group_cuda(one, out).cpu(),
                           PM.prf_mask_group_plain(one, torch.int64)), n
    # grouped draws, one launch each: every stream's key derived on the
    # card, shifts, empty and odd streams, more than 8 streams (the joint
    # adder's 78, MAX_STREAMS), outputs off the 16-byte grid, both widths
    for dtype in (torch.int64, torch.int32):
        ell = torch.iinfo(dtype).bits
        kinds = [(100352, 0), (5, ell - 1), (0, 0), (1000, 20), (3, 1),
                 (257, 0), (1, 4), (64, ell - 13), (128, 0), (0, 7)]
        streams = [((0x243F6A88, 0x85A308D3 + j), 2**32 + 7 * j, n, shift)
                   for j, (n, shift) in enumerate(
                       kinds[j % len(kinds)] for j in range(PM.MAX_STREAMS))]
        for count in (1, 3, 8, 9, 78, PM.MAX_STREAMS):
            part = streams[:count]
            total = sum(s[2] for s in part)
            want = PM.prf_mask_group_plain(part, dtype)
            for skew in range(4):
                buf = torch.empty(total + skew, dtype=dtype,
                                  device=cuda_device)
                assert torch.equal(
                    PM.prf_mask_group_cuda(part, buf[skew:]).cpu(), want), \
                    (dtype, count, skew)
            ops.reset_launches()
            got = ops.lambda_masks_group(
                [(kd, c, (n,), sh) for kd, c, n, sh in part], dtype,
                cuda_device, flat=True)
            assert ops.PRF_MASK.launches == 1, count
            assert torch.equal(got.cpu(), want), (dtype, count)
    # Pi_DotP's rounds (kernel route K1): one grouped mult_terms launch a
    # round, contracted after, equal to the "torch" backend on the CPU
    rng64 = np.random.RandomState(5)

    def lam(*shape):
        return {j: torch.from_numpy(rng64.randint(-2**62, 2**62, size=shape,
                                                  dtype=np.int64))
                for j in (1, 2, 3)}

    def dot(a, b):
        return torch.sum(a * b, dim=-1, dtype=a.dtype)

    def on_card(reqs):
        return [tuple({j: t.to(cuda_device) for j, t in x.items()}
                      if isinstance(x, dict) else
                      x.to(cuda_device) if torch.is_tensor(x) else x
                      for x in r) for r in reqs]

    lx, ly, masks, gammas, lam_zs = (lam(128, 784), lam(128, 784),
                                     lam(128), lam(128), lam(128))
    mx, my = lam(128, 784)[1], lam(128, 784)[1]
    gamma_reqs = [(lx, ly, masks, (1, 2, 3))] + [(lx, ly, masks, (j,))
                                                 for j in GAMMA_LOCAL]
    online_reqs = [(mx, my, lx, ly, gammas, lam_zs,
                    tuple(j for j in (1, 2, 3) if p in PART_HOLDERS[j]))
                   for p in (1, 2, 3)]
    for name, reqs in (("gamma_pieces_round", gamma_reqs),
                       ("online_parts_round", online_reqs)):
        ops.reset_launches()
        got = getattr(HopperKernels(), name)("dotp", dot, on_card(reqs))
        assert ops.MULT_TERMS.launches == 1, name
        want = getattr(TorchKernels(), name)("dotp", dot, reqs)
        for g, w in zip(got, want):
            g, w = (g, w) if isinstance(g, dict) else (
                {0: g[0], **g[1]}, {0: w[0], **w[1]})
            assert all(torch.equal(g[j].cpu(), w[j]) for j in w), name
    # the store handoff under stress, with no host wait between the
    # streams: (a) words written on a side stream behind a spin, popped
    # and read at once on this stream (the wait on store.ready); (b) words
    # popped, their read held behind a spin on this stream while the host
    # drops them and the side stream allocates and scribbles blocks of
    # their size (record_stream)
    n, spin = 1 << 20, 200_000_000
    want = torch.arange(4 * n, dtype=torch.int64).view(4, n) * 3 + 1
    # (a first pass with no spins loads the kernels these launch: a module
    # loaded lazily mid-case would wait for the spinning stream)
    side = torch.cuda.Stream(cuda_device)
    for case in ("warm-up", "a", "b"):
        torch.cuda.synchronize(cuda_device)
        torch.cuda.empty_cache()
        store = offline.PrepStore()
        with torch.cuda.stream(side):
            recs = [torch.full((n,), -1, dtype=torch.int64,
                               device=cuda_device) for _ in range(4)]
            torch.cuda._sleep(spin if case == "a" else 1)
            for i, r in enumerate(recs):
                torch.arange(i * n, (i + 1) * n, out=r)
                r.mul_(3).add_(1)
            store.put("h#0", "h", [{"w": r} for r in recs])
            store.mark_ready(cuda_device)
        del recs, r
        parts = offline.OnlinePrep(store, cuda_device).acquire("h#0", "h",
                                                               None)
        assert case != "a" or not side.query()   # the side stream spins
        torch.cuda._sleep(spin if case == "b" else 1)
        got = torch.stack([p["w"] for p in parts])
        del parts
        if case == "b":
            with torch.cuda.stream(side):
                scribble = [torch.full((n,), -2, dtype=torch.int64,
                                       device=cuda_device) for _ in range(8)]
            del scribble
        assert torch.equal(got.cpu(), want), case
    # the offline-online split on the card: a store dealt on a side
    # stream is consumed on this thread's stream; then the pipelined
    # server (its dealer thread on a stream of its own), every batch equal
    # to its inline twin
    net = MLPNet(16, (8, 8, 4))
    params = params_from_numpy(mlp_net_init(np.random.RandomState(0), net),
                               RING64, cuda_device)

    def predict(rt, X):
        return mlp_net_predict_runtime(rt, params, net, X)

    queries = np.random.RandomState(1).randn(4 * 8 - 3, 16)
    side = torch.cuda.Stream(cuda_device)
    with torch.cuda.stream(side):
        store, _ = offline.deal(lambda rt: predict(rt, np.zeros((8, 16))),
                                seed=3, device=cuda_device)
    assert isinstance(store.ready, torch.cuda.Event)
    got, rep = offline.run_online(lambda rt: predict(rt, queries[:8]), store,
                                  device=cuda_device)
    inline = predict(FourPartyRuntime(RING64, seed=3, device=cuda_device),
                     queries[:8])
    assert torch.equal(got.cpu(), inline.cpu()) and rep.offline_bits == 0
    srv = PartyPredictionServer(predict, batch_size=8, seed=3,
                                prep="pipelined", device=cuda_device)
    for q in queries:
        srv.submit(q)
    words = torch.stack(srv.flush()).cpu()
    report = srv.report()
    assert report["batches"] == 4 and not report["aborted"]
    assert report["offline_bits_per_batch"] == 0
    X = np.concatenate([queries, np.zeros((3, 16))])
    for k in range(4):
        rows = slice(8 * k, 8 * (k + 1))
        twin = predict(FourPartyRuntime(RING64, seed=3 + k,
                                        device=cuda_device), X[rows]).cpu()
        assert torch.equal(words[rows], twin[:len(words[rows])]), k
    # one traced batch, under the profiler: the untraced words, a device
    # time on every kernel span, and each kernel's summed device windows
    # at least its kernels' device time in the same run (events recorded
    # on another stream than the kernels' would read less)
    from torch.profiler import ProfilerActivity, profile
    tracer = obs.Tracer("card")
    prev = obs.install_tracer(tracer)
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            traced = predict(FourPartyRuntime(RING64, seed=3,
                                              device=cuda_device),
                             queries[:8])
            torch.cuda.synchronize()
    finally:
        obs.install_tracer(prev)
    assert torch.equal(traced.cpu(), inline.cpu())
    spans = [e for e in tracer.drain()["events"] if e["cat"] == "kernel"]
    assert spans and all(np.isfinite(e["args"]["device_ms"])
                         and e["args"]["device_ms"] >= 0 for e in spans)
    windows, kernel_ms = {}, {}
    for e in spans:
        kind = e["args"]["kind"]
        fam = "prf" if kind.startswith("prf") else kind.split(".")[1]
        windows[fam] = windows.get(fam, 0.0) + e["args"]["device_ms"]
    for e in prof.key_averages():
        fam = _kernel_family(e.key)
        if fam is not None:
            kernel_ms[fam] = kernel_ms.get(fam, 0.0) + \
                e.device_time_total / 1e3
    assert kernel_ms, "the profiler saw none of the runtime's kernels"
    for fam, ms in kernel_ms.items():
        assert windows.get(fam, 0.0) >= ms, (fam, windows, kernel_ms)
    # the four parties as four daemon processes on the card over TCP: one
    # task opens the in-process runtime's words and traffic in every daemon
    raw = mlp_net_init(np.random.RandomState(0), net)
    with PartyCluster(device=cuda_device) as cluster:
        res = cluster.submit(functools.partial(_cluster_task, X=queries[:8],
                                               params=raw), seed=3)
    rt = FourPartyRuntime(RING64, seed=3, device=cuda_device)
    want = words_to_numpy(predict(rt, queries[:8]))
    for r in res:
        assert np.array_equal(r.result, want) and not r.abort, r.rank
        assert r.totals == rt.transport.totals(), r.rank
        assert r.per_link == rt.transport.per_link(), r.rank
