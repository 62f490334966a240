"""The port's offline-online split (repro_torch.offline, the runtime's prep
modes) against the JAX package's (repro.offline), on the CPU at a tiny
width: every program is dealt into a PrepStore and run online-only through
both packages on the same seed, with the same opened words, share views,
reports and registry counts; stores cross between the packages through
disk both ways; the store contract holds; and the pipelined server serves
what the JAX package's serves.  One test item, so the collected count
stays where the tier-1 split of the slow tests needs it."""
import json
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one intra-op thread, so idle torch threads do not spin
# beside the JAX tests that share this worker
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import repro.offline as JO  # noqa: E402
from repro.core.ring import RING32 as J32, RING64 as J64  # noqa: E402
from repro.obs.registry import MetricsRegistry as JRegistry  # noqa: E402
from repro.runtime import FourPartyRuntime as JRuntime  # noqa: E402
from repro.runtime import LocalTransport as JTransport  # noqa: E402
from repro.runtime import activations as JA  # noqa: E402
from repro.runtime import boolean as JB  # noqa: E402
from repro.runtime import conversions as JC  # noqa: E402
from repro.runtime import protocols as JP  # noqa: E402
from repro.runtime.kernel_backend import MeteredKernels as JMetered  # noqa: E402
from repro.runtime.party import (  # noqa: E402
    DistAShare as JDistA, DistBShare as JDistB,
    map_components_multi as jmap_multi)
from repro.serve.party_server import (  # noqa: E402
    PartyPredictionServer as JServer)
from repro.train.paper_ml import MLPNet as JNet, mlp_net_init  # noqa: E402
import repro_torch.offline as TO  # noqa: E402
from repro_torch.offline.store import _flatten  # noqa: E402
from repro_torch.core.ring import (RING32 as T32, RING64 as T64,  # noqa: E402
                                   words_from_numpy, words_to_numpy)
from repro_torch.kernels import ops as TOPS  # noqa: E402
from repro_torch.obs import MetricsRegistry as TRegistry  # noqa: E402
from repro_torch.runtime import FourPartyRuntime as TRuntime  # noqa: E402
from repro_torch.runtime import LocalTransport as TTransport  # noqa: E402
from repro_torch.runtime import PhaseViolation  # noqa: E402
from repro_torch.runtime import activations as TA  # noqa: E402
from repro_torch.runtime import boolean as TB  # noqa: E402
from repro_torch.runtime import conversions as TC  # noqa: E402
from repro_torch.runtime import protocols as TP  # noqa: E402
from repro_torch.runtime.kernel_backend import (  # noqa: E402
    MeteredKernels as TMetered)
from repro_torch.runtime.party import (  # noqa: E402
    DistAShare as TDistA, DistBShare as TDistB,
    map_components_multi as tmap_multi)
from repro_torch.serve.party_server import PartyPredictionServer  # noqa: E402
from repro_torch.train.paper_ml import (  # noqa: E402
    MLPNet, mlp_net_predict_runtime, params_from_numpy)

from test_torch_slice import _jax_predict  # noqa: E402

SEED = 7
# one (4, 4) shape for every operand, and a net of that width: the JAX
# package compiles each eager operation once per shape and dtype, and that
# compiling is most of this test's time
_rng = np.random.RandomState(2024)
VALS = _rng.randn(4, 4) * 2.0
VALS2 = _rng.randn(4, 4)
POS = np.abs(VALS) + 0.25                      # rsqrt takes x > 0
BITS = _rng.randint(0, 2, (4, 4))
WORDS = _rng.randint(0, 1 << 30, (4, 4)).astype(np.uint64)   # msb: row 1
NET = (4, (4, 4))
BATCH = 4
KERNEL_BACKEND = "hopper"   # the card's route; its plain versions here


def jax_pkg(ell):
    ring = J64 if ell == 64 else J32
    words = np.uint64 if ell == 64 else np.uint32
    return types.SimpleNamespace(
        P=JP, B=JB, C=JC, A=JA, O=JO, ring=ring,
        DistA=JDistA, DistB=JDistB, map_multi=jmap_multi,
        split=lambda a: jnp.split(a, 2),
        runtime=lambda **kw: JRuntime(ring, seed=SEED, **kw),
        transport=JTransport, kw={},
        metered=lambda inner: JMetered(inner, registry=JRegistry()),
        words=lambda v: np.asarray(v, words),
        np=lambda v: np.asarray(v))


def torch_pkg(ell):
    ring = T64 if ell == 64 else T32
    return types.SimpleNamespace(
        P=TP, B=TB, C=TC, A=TA, O=TO, ring=ring,
        DistA=TDistA, DistB=TDistB, map_multi=tmap_multi,
        split=lambda a: list(torch.split(a, 2)),
        runtime=lambda **kw: TRuntime(ring, seed=SEED,
                                      kernel_backend=KERNEL_BACKEND,
                                      device="cpu", **kw),
        transport=TTransport,
        kw={"device": "cpu",
            "runtime_kwargs": {"kernel_backend": KERNEL_BACKEND}},
        metered=lambda inner: TMetered(inner, registry=TRegistry()),
        words=lambda v: words_from_numpy(
            np.asarray(v, np.uint64 if ell == 64 else np.uint32)),
        np=words_to_numpy)


def _sh(L, rt, x):
    return L.P.share(rt, L.ring.encode(x))


def _shb(L, rt, words, nbits=None):
    return L.P.share_bool(rt, L.words(words), nbits=nbits)


# each program returns its output share (arithmetic ones are opened by the
# runner); JAX's tests/test_offline.py programs plus rsqrt, scale_public
# and less_than_zero
PROGRAMS = {
    "mult": lambda L, rt: L.P.mult(rt, _sh(L, rt, VALS), _sh(L, rt, VALS2)),
    "mult_tr": lambda L, rt: L.P.mult_tr(rt, _sh(L, rt, VALS),
                                         _sh(L, rt, VALS2)),
    "dotp": lambda L, rt: L.P.dotp(rt, _sh(L, rt, VALS), _sh(L, rt, VALS2)),
    "matmul_tr": lambda L, rt: L.P.matmul_tr(rt, _sh(L, rt, VALS),
                                             _sh(L, rt, VALS2)),
    "trunc": lambda L, rt: L.P.truncate_share(rt, _sh(L, rt, VALS)),
    "and": lambda L, rt: L.B.and_bshare(rt, _shb(L, rt, BITS, 1),
                                        _shb(L, rt, BITS, 1), active_bits=1),
    "a2b": lambda L, rt: L.C.a2b(rt, _sh(L, rt, VALS)),
    "b2a": lambda L, rt: L.P.b2a(rt, _shb(
        L, rt, WORDS + np.asarray([[0], [1 << (L.ring.ell - 1)], [0], [0]],
                                  np.uint64))),
    "bit2a": lambda L, rt: L.C.bit2a(rt, _shb(L, rt, BITS, 1)),
    "bit_inject": lambda L, rt: L.C.bit_inject(rt, _shb(L, rt, BITS, 1),
                                               _sh(L, rt, VALS)),
    "bitext_mul": lambda L, rt: L.C.bit_extract(rt, _sh(L, rt, VALS),
                                                method="mul"),
    "bitext_ppa": lambda L, rt: L.C.bit_extract(rt, _sh(L, rt, VALS),
                                                method="ppa"),
    "relu": lambda L, rt: L.A.relu(rt, _sh(L, rt, VALS)),
    "sigmoid": lambda L, rt: L.A.sigmoid(rt, _sh(L, rt, VALS)),
    "rsqrt": lambda L, rt: L.A.rsqrt(rt, _sh(L, rt, POS)),
    "scale_public": lambda L, rt: L.P.scale_public(rt, _sh(L, rt, VALS),
                                                   -1.25),
    "less_than_zero": lambda L, rt: L.C.less_than_zero(rt, _sh(L, rt, VALS)),
}


def _opened(L, rt, program, out):
    """The program's output: (opened words {party: words}, party views)."""
    sh = PROGRAMS[program](L, rt)
    opened = {} if hasattr(sh, "nbits") else L.P.reconstruct(rt, sh)
    out["opened"] = {p: L.np(v) for p, v in opened.items()}
    out["views"] = [(None if v.m is None else L.np(v.m),
                     {j: L.np(lv) for j, lv in v.lam.items()})
                    for v in sh.views]


def _leaves(rec, fn=lambda t: t) -> dict:
    """A prep record's tensors by path, each through `fn`."""
    flat = {}
    _flatten(rec, "", flat)
    return {k: fn(t) for k, t in flat.items()}


def run(L, program, mode, store=None):
    """One run of `program` in `mode` ("inline", "deal" or "online"): the
    opened words and views, the report, per_link(), the registry counts
    and the port's wrapper calls."""
    out = {}
    box = {}

    def prog(rt):
        # a registry of this run's own, to read the backend calls by kind
        rt.kernels = L.metered(rt.kernels._inner)
        box["rt"] = rt
        _opened(L, rt, program, out)

    TOPS.reset_launches()
    tp = L.transport()
    if mode == "inline":
        prog(L.runtime(transport=tp))
        out["report"] = None
    elif mode == "deal":
        # the port's store keeps the dealer's own tensors: every entry's
        # words when it was put must still be its words after the pass
        # (no protocol writes a prep tensor in place)
        put, at_put = TO.PrepStore.put, {}

        def put_and_copy(self, tag, kind, parts):
            put(self, tag, kind, parts)
            at_put[tag] = [_leaves(rec, torch.clone) for rec in parts]

        TO.PrepStore.put = put_and_copy
        try:
            store, rep = L.O.deal(prog, ring=L.ring, seed=SEED,
                                  transport=tp, **L.kw)
        finally:
            TO.PrepStore.put = put
        for tag, recs in at_put.items():
            now = [_leaves(rec) for rec in store._entries[tag][1]]
            assert all(a.keys() == b.keys() and all(
                torch.equal(a[k], b[k]) for k in a)
                for a, b in zip(recs, now)), (program, tag)
        out["store"] = store
        out["report"] = (rep.entries, rep.offline_rounds, rep.offline_bits,
                         rep.abort, rep.summary)
    else:
        _, rep = L.O.run_online(prog, store, ring=L.ring, transport=tp,
                                **L.kw)
        out["report"] = (rep.online_rounds, rep.online_bits,
                         rep.offline_bits, rep.leftover_entries, rep.abort)
    rt = box["rt"]
    out["abort"] = bool(rt.abort_flag())
    out["per_link"] = tp.per_link()
    out["calls"] = {k: c.value for k, c in rt.kernels._counters.items()}
    out["kernel_calls"] = {k.name: k.calls for k in TOPS.KERNELS}
    return out


def _same(a, b, ell, wrap=False):
    """Equal words of equal dtype; `wrap`: equal mod 2^ell."""
    if wrap:
        mask = np.uint64((1 << ell) - 1)
        return np.array_equal(a.astype(np.uint64) & mask,
                              b.astype(np.uint64) & mask)
    return a.dtype == b.dtype and np.array_equal(a, b)


def _assert_words(got, want, ell, where, wrap=False):
    assert got["opened"].keys() == want["opened"].keys(), where
    for p in want["opened"]:
        assert _same(got["opened"][p], want["opened"][p], ell, wrap), \
            f"{where}: P{p} opened"
    for i, ((gm, gl), (wm, wl)) in enumerate(zip(got["views"],
                                                 want["views"])):
        assert (gm is None) == (wm is None), f"{where}: P{i} m"
        assert gm is None or _same(gm, wm, ell, wrap), f"{where}: P{i} m"
        assert gl.keys() == wl.keys(), where
        for j in wl:
            assert _same(gl[j], wl[j], ell, wrap), f"{where}: P{i} lam_{j}"


def _assert_files_equal(jdir, tdir, ell, where, wrap=False):
    """The two packages' saved stores: equal manifests, and in every
    party's npz the same keys, each array of the same dtype and words."""
    with open(jdir / "manifest.json") as f, open(tdir / "manifest.json") as g:
        assert json.load(f) == json.load(g), where
    for i in range(4):
        # each read of an npz key decompresses it: read every key once
        with np.load(jdir / f"party{i}.npz") as a, \
                np.load(tdir / f"party{i}.npz") as b:
            a, b = dict(a), dict(b)
        assert list(a) == list(b), (where, i)
        for key, want in a.items():
            if not wrap:
                assert b[key].dtype == (np.uint64 if ell == 64
                                        else np.uint32), (where, key)
            assert _same(want, b[key], ell, wrap), (where, i, key)


def _check_programs(ell, tmp_path):
    J, T = jax_pkg(ell), torch_pkg(ell)
    for program in PROGRAMS:
        where = f"{program} (RING{ell})"
        # ROADMAP F1: at RING32 the reference's dotp sums uint32 words with
        # jnp.sum, which promotes them to uint64 under x64; its words are
        # right mod 2^32 only, so they are compared mod 2^32
        wrap = ell == 32 and program == "dotp"
        jdeal = run(J, program, "deal")
        jdir = tmp_path / f"j_{program}_{ell}"
        jdeal["store"].save(str(jdir))
        jon = run(J, program, "online", jdeal["store"])
        inline = run(T, program, "inline")
        tdeal = run(T, program, "deal")
        tdir = tmp_path / f"t_{program}_{ell}"
        tdeal["store"].save(str(tdir))
        _assert_files_equal(jdir, tdir, ell, where, wrap)
        ton = run(T, program, "online", tdeal["store"])
        # online-only: the inline run's words and views, and JAX's
        _assert_words(ton, inline, ell, where)
        _assert_words(ton, jon, ell, where, wrap)
        # deal mode: zero placeholders opened, lambda-only views, as JAX
        _assert_words(tdeal, jdeal, ell, where + " deal", wrap)
        assert all(m is None for m, _ in tdeal["views"]), where
        for got, want in ((tdeal, jdeal), (ton, jon)):
            assert got["report"] == want["report"], where
            assert got["per_link"] == want["per_link"], where
            assert got["calls"] == want["calls"], where
            assert got["abort"] is want["abort"] is False, where
        assert ton["report"][2] == 0, where               # offline bits
        # the online phase moves the inline run's online bits per link;
        # the deal its offline bits
        for phase, part in (("online", ton), ("offline", tdeal)):
            assert {k: v[phase] for k, v in part["per_link"].items()
                    if v[phase]} == {k: v[phase] for k, v in
                                     inline["per_link"].items()
                                     if v[phase]}, (where, phase)
        # backend calls by kind and wrapper calls by kernel: deal + online
        # is the inline run; the online run draws no PRF word
        for counts in ("calls", "kernel_calls"):
            both = {k: tdeal[counts].get(k, 0) + ton[counts].get(k, 0)
                    for k in set(tdeal[counts]) | set(ton[counts])}
            assert {k: v for k, v in both.items() if v} == \
                {k: v for k, v in inline[counts].items() if v}, \
                (where, counts)
        assert ton["kernel_calls"]["prf_mask"] == 0, where
        assert not any(k.startswith("prf") for k in ton["calls"]), where
        # the disk round trip: the loaded store opens the same words
        loaded = TO.PrepStore.load(str(tdir))
        assert len(loaded) == tdeal["report"][0], where
        _assert_words(run(T, program, "online", loaded), inline, ell,
                      where + " loaded")
        with np.load(tdir / "party1.npz") as npz:
            assert {npz[k].dtype for k in npz.files} == \
                {np.dtype(np.uint64 if ell == 64 else np.uint32)}, where


def _nn():
    params = mlp_net_init(np.random.RandomState(0), JNet(*NET))
    net = MLPNet(*NET)
    enc = params_from_numpy(params, T64, "cpu")
    return params, (lambda rt, X: mlp_net_predict_runtime(rt, enc, net, X))


def _check_stores_cross(tmp_path):
    """The tiny NN: each package loads and runs the other's store."""
    params, tpredict = _nn()
    jpredict = _jax_predict(params)
    X = np.random.RandomState(3).randn(BATCH, NET[0])
    zeros = np.zeros_like(X)
    want = words_to_numpy(tpredict(TRuntime(T64, seed=SEED, device="cpu"),
                                   X))
    jstore, _ = JO.deal(lambda rt: jpredict(rt, zeros), ring=J64, seed=SEED)
    jstore.save(str(tmp_path / "nn_j"))
    tstore, _ = TO.deal(lambda rt: tpredict(rt, zeros), ring=T64, seed=SEED,
                        device="cpu")
    tstore.save(str(tmp_path / "nn_t"))
    _assert_files_equal(tmp_path / "nn_j", tmp_path / "nn_t", 64, "NN")
    got, rep = TO.run_online(lambda rt: tpredict(rt, X),
                             TO.PrepStore.load(str(tmp_path / "nn_j")),
                             device="cpu")
    assert np.array_equal(words_to_numpy(got), want), "JAX store -> port"
    assert rep.offline_bits == 0 and not rep.abort
    jgot, jrep = JO.run_online(lambda rt: jpredict(rt, X),
                               JO.PrepStore.load(str(tmp_path / "nn_t")),
                               ring=J64)
    assert np.array_equal(np.asarray(jgot), want), "port store -> JAX"
    assert jrep.offline_bits == 0 and not jrep.abort
    assert (rep.online_rounds, rep.online_bits) == \
        (jrep.online_rounds, jrep.online_bits)


def _check_party_surface():
    """The share containers' surface the offline slice brings: operators,
    map_components_multi, to_joint / from_joint, in both packages."""
    got = {}
    for name, L in (("jax", jax_pkg(64)), ("torch", torch_pkg(64))):
        rt = L.runtime()
        x, y = _sh(L, rt, VALS), _sh(L, rt, VALS2)
        half = L.ring.encode(0.5)
        z = (x + y) - (-x) + half
        z = half + (z - half)
        lo, hi = L.map_multi(L.split, z, 2)
        b = _shb(L, rt, BITS, 1)
        joint = z.to_joint()
        again = L.DistA.from_joint(joint)
        bjoint = L.DistB.from_joint(b.to_joint()).to_joint()
        got[name] = [L.np(w) for w in (
            *(L.P.reconstruct(rt, t)[1] for t in (z, lo, hi, again)),
            joint.data, bjoint.data)]
    for g, w in zip(got["torch"], got["jax"]):
        assert _same(g, w, 64)


def _check_store_contract():
    prog = PROGRAMS["mult"]
    L = torch_pkg(64)
    store, _ = TO.deal(lambda rt: prog(L, rt), seed=SEED, device="cpu")
    first, tag = store.tags()[:2]
    with pytest.raises(TO.PrepKindError):
        store.pop(first, "other")
    kind = store._entries[tag][0]
    store.pop(tag, kind)
    with pytest.raises(TO.PrepReplayError, match="use-once"):
        store.pop(tag, kind)
    with pytest.raises(TO.PrepMissingError):
        store.pop("nope#1", kind)
    with pytest.raises(TO.PrepMissingError):
        TO.run_online(lambda rt: prog(L, rt), TO.PrepStore(), device="cpu")
    # the consuming runtime draws no PRF word
    rt = TO.online_runtime(TO.PrepStore(), device="cpu")
    with pytest.raises(RuntimeError, match="PrepStore"):
        rt.sample((0, 1), (2,))
    # the offline phase is forbidden on an online-only run's wire
    tp = TTransport()
    tp.forbid_phase("offline")
    with pytest.raises(PhaseViolation):
        prog(L, TRuntime(T64, seed=SEED, transport=tp, device="cpu"))
    # a bank: tombstones, seek, save/load of an unconsumed bank
    bank, reps = TO.deal_sessions([lambda rt: prog(L, rt)] * 3,
                                  base_seed=SEED, device="cpu")
    assert [r.entries for r in reps] == [len(s) for s in bank._stores]
    assert bank.resident() == 3 and bank.sessions_left == 3
    first = bank.next()
    assert first.meta["session"] == 0 and bank.resident() == 2
    bank.seek(2)                       # skips session 1
    assert bank.resident() == 1 and bank.sessions_left == 1
    with pytest.raises(TO.PrepReplayError, match="skipped"):
        bank.seek(1)
    with pytest.raises(TO.PrepError, match="partially consumed"):
        bank.save("unused")
    with pytest.raises(TO.PrepMissingError):
        bank.seek(5)
    assert bank.next().meta["session"] == 2
    with pytest.raises(TO.PrepMissingError):
        bank.next()


def _check_bank_disk(tmp_path):
    L = torch_pkg(64)
    prog = PROGRAMS["mult_tr"]
    bank, _ = TO.deal_sessions([lambda rt: prog(L, rt)] * 2, base_seed=SEED,
                               device="cpu")
    bank.save(str(tmp_path / "bank"))
    jbank = JO.PrepBank.load(str(tmp_path / "bank"))
    loaded = TO.PrepBank.load(str(tmp_path / "bank"))
    for k in range(2):
        got, _ = TO.run_online(lambda rt: TP.reconstruct(rt, prog(L, rt))[1],
                               loaded.next(), device="cpu")
        J = jax_pkg(64)
        jgot, _ = JO.run_online(lambda rt: J.P.reconstruct(rt, prog(J, rt))[1],
                                jbank.next(), ring=J64)
        want = TP.reconstruct(
            *(lambda rt: (rt, prog(L, rt)))(TRuntime(T64, seed=SEED + k,
                                                     device="cpu")))[1]
        assert np.array_equal(words_to_numpy(got), words_to_numpy(want)), k
        assert np.array_equal(np.asarray(jgot), words_to_numpy(want)), k


def _check_workload():
    """Every kind of a declared Workload but the Newton chains deals and
    runs online in both packages with the same reports."""
    shapes = {"matmul": ((4, 4), (4, 4)), "matmul_tr": ((4, 4), (4, 4)),
              "bit_inject": ((4, 4), (4, 4))}
    got = {}
    for name, O in (("jax", JO), ("torch", TO)):
        wl = O.Workload()
        for kind in sorted(O.workload._OPS):
            if kind in ("reciprocal", "rsqrt", "smx_softmax"):
                continue    # Newton chains: in PROGRAMS and in the NN
            method = {"and": "and_bits"}.get(kind, kind)
            args = shapes.get(kind, ((4, 4),))     # the NN's shapes
            getattr(wl, method)(*args)
        kw = {"device": "cpu"} if name == "torch" else {}
        store, drep = O.deal(wl.program(), seed=SEED, **kw)
        _, orep = O.run_online(wl.program(), store, **kw)
        got[name] = (wl.counts(), drep.entries, drep.offline_rounds,
                     drep.offline_bits, drep.summary, orep.online_rounds,
                     orep.online_bits, orep.offline_bits,
                     orep.leftover_entries)
    assert set(TO.workload._OPS) == set(JO.workload._OPS)
    assert got["torch"] == got["jax"]


def _check_pipelined_server():
    params, tpredict = _nn()
    queries = np.random.RandomState(1).randn(10, NET[0])   # 3 batches of 4
    jsrv = JServer(_jax_predict(params), batch_size=BATCH, ring=J64,
                   seed=SEED, prep="pipelined")
    try:
        for q in queries:
            jsrv.submit(q)
        jwords = np.stack(jsrv.flush())
        jrep = jsrv.report()
    finally:
        jsrv.close()
    srv = PartyPredictionServer(tpredict, batch_size=BATCH, seed=SEED,
                                prep="pipelined", device="cpu")
    for q in queries:
        srv.submit(q)
    words = words_to_numpy(torch.stack(srv.flush()))
    rep = srv.report()
    assert np.array_equal(words, jwords)
    assert rep["batches"] == 3 and rep["offline_bits_per_batch"] == 0
    for key in ("queries", "batches", "aborted", "online_rounds_per_batch",
                "online_bits_per_batch", "offline_bits_per_batch",
                "link_online_bits"):
        assert rep[key] == jrep[key], key
    assert rep["online_only_ms_per_batch"] > 0
    assert rep["offline_deal_s_per_batch"] > 0
    # batch k was dealt from seed SEED + k: its inline twin at that seed
    X = np.concatenate([queries, np.zeros((2, NET[0]))])
    for k in range(3):
        rows = slice(BATCH * k, BATCH * (k + 1))
        inline = tpredict(TRuntime(T64, seed=SEED + k, device="cpu"),
                          X[rows])
        assert np.array_equal(words[rows],
                              words_to_numpy(inline)[:len(words[rows])]), k


def test_offline_online_matches_jax(tmp_path):
    for ell in (64, 32):
        _check_programs(ell, tmp_path)
    _check_party_surface()
    _check_stores_cross(tmp_path)
    _check_store_contract()
    _check_bank_disk(tmp_path)
    _check_workload()
    _check_pipelined_server()
