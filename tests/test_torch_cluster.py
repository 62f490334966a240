"""The port's socket cluster (``repro_torch.runtime.net``,
``offline.live``, ``serve_over_sockets``, the cluster steps of
``train.secure_sgd``) against the JAX package on the CPU: frames cross
between the packages both ways over a socket pair at both ring widths; a
cluster of four daemon processes opens the words, ``totals()``,
``per_link()`` and abort flags of JAX's in-process runtime on the same
seed, in at most 3 frames a round per party; a dial carrying another
mesh's token is refused while the mesh forms; a tampered gamma piece
aborts; three ``ClusterSGD(prep="live")`` steps fed by a dealer process
are bit-equal to JAX's joint world with no offline bit on the mesh, and a
replayed step poisons the cluster; ``serve_over_sockets`` serves the same
words inline, dealt ahead and live; a ``ShardedClusterSGD`` step is the
mean of its members.  The shared cluster traces and serves its metrics
(``trace=True, metrics=True``), so the same words also show that tracing
changes no word: each daemon's registry and trace hold its ``per_link()``
bits, the four exporters scrape, the health documents between tasks and
after training are healthy, the merged timeline covers the four ranks and
the dealer; a terminated daemon reads as ``rank_down``.  One test item,
so the collected count stays where the tier-1 split of the slow tests
needs it.

The daemons are spawned and import this module to find its programs, so
its top level imports neither jax nor the JAX package: the JAX side is
imported inside the test."""
import concurrent.futures
import json
import os
import socket
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small shapes: one intra-op thread, so idle torch threads do not spin
# beside the JAX tests that share this worker
torch.set_num_threads(1)

from repro_torch.core.ring import (RING32, RING64,  # noqa: E402
                                   words_from_numpy, words_to_numpy_batch)
from repro_torch import obs as TO  # noqa: E402
from repro_torch.obs import MetricsRegistry, install_registry  # noqa: E402
from repro_torch.offline import (ContinuousDealer, LivePrepBank,  # noqa: E402
                                 PrepError, PrepMissingError, deal)
from repro_torch.offline.live import (store_from_blob,  # noqa: E402
                                      store_to_blob)
from repro_torch.runtime import FourPartyRuntime  # noqa: E402
from repro_torch.runtime import activations as TRA  # noqa: E402
from repro_torch.runtime import protocols as TRT  # noqa: E402
from repro_torch.runtime.net import framing as TF  # noqa: E402
from repro_torch.runtime.net.cluster import (ClusterPoisoned,  # noqa: E402
                                             PartyCluster, _free_ports)
from repro_torch.runtime.net.socket_transport import (  # noqa: E402
    TOKEN_BYTES, SocketTransport)
from repro_torch.serve.party_server import serve_over_sockets  # noqa: E402
from repro_torch.train import data as TD  # noqa: E402
from repro_torch.train import secure_sgd as TS  # noqa: E402

SEED = 11
SERVE_SEED = 3
TRAIN_SEED = 17
STEPS = 3
BATCH = 8
# the tiny NN of tests/test_socket_transport.py
_rng = np.random.RandomState(0)
W1 = _rng.randn(4, 3) * 0.4
W2 = _rng.randn(3, 2) * 0.4
X = _rng.randn(2, 4)
QUERIES = np.random.RandomState(1).randn(6, 4)
TASK = TS.logreg_task(features=6, lr=0.5)
DATA = TD.RegressionData(features=6, n=256, seed=1, logistic=True)
TAMPER = {"src": 0, "tag": ".g2", "delta": 5}


# -- the daemons' programs (module level: spawn pickles them by name) ------
def nn_program(rt, rank):
    """Linear (fused truncation) -> relu -> linear -> sigmoid -> open."""
    xs, w1, w2 = (TRT.share(rt, rt.encode(a)) for a in (X, W1, W2))
    h = TRA.relu(rt, TRT.matmul_tr(rt, xs, w1))
    out = TRA.sigmoid(rt, TRT.matmul_tr(rt, h, w2))
    return TRT.reconstruct(rt, out)[rank]


def serve_predict(rt, Xb):
    """predict_fn of the serving streams: relu(X W1), P1's opened words."""
    xs = TRT.share(rt, rt.encode(Xb))
    w = TRT.share(rt, rt.encode(W1))
    return TRT.reconstruct(rt, TRA.relu(rt, TRT.matmul_tr(rt, xs, w)))[1]


def link_totals(rt, rank):
    """The daemon's per_link() over every task it ran."""
    return rt.transport.per_link()


def _deal_program(rt):
    xs = TRT.share(rt, rt.encode(np.zeros((2, 4))))
    TRT.mult_tr(rt, xs, xs)


# -- the JAX side ------------------------------------------------------------
def _jax():
    import types

    from repro.core.ring import RING64 as JR64
    from repro.runtime import FourPartyRuntime as JRuntime
    from repro.runtime import activations as JRA
    from repro.runtime import protocols as JRT
    from repro.runtime.net import framing as JF
    from repro.train import secure_sgd as JS
    return types.SimpleNamespace(R64=JR64, Runtime=JRuntime, RA=JRA, RT=JRT,
                                 F=JF, S=JS,
                                 task=JS.logreg_task(features=6, lr=0.5))


def _jax_nn(J, rt):
    enc = J.R64.encode
    xs, w1, w2 = (J.RT.share(rt, enc(a)) for a in (X, W1, W2))
    h = J.RA.relu(rt, J.RT.matmul_tr(rt, xs, w1))
    out = J.RA.sigmoid(rt, J.RT.matmul_tr(rt, h, w2))
    return J.RT.reconstruct(rt, out)


def _jax_serve_words(J, batch: np.ndarray, seed: int) -> np.ndarray:
    rt = J.Runtime(J.R64, seed=seed)
    xs = J.RT.share(rt, J.R64.encode(batch))
    w = J.RT.share(rt, J.R64.encode(W1))
    out = J.RA.relu(rt, J.RT.matmul_tr(rt, xs, w))
    return np.asarray(J.RT.reconstruct(rt, out)[1])


def _nonzero(per_link: dict) -> dict:
    out = {}
    for link, per in per_link.items():
        cell = {p: b for p, b in per.items() if b}
        if cell:
            out[link] = cell
    return out


def _wait(cond, what: str, timeout: float = 60.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.05)


def _same_store(a, b) -> None:
    """Two stores hold the same entries, kinds and words."""
    da, db = a.to_arrays(), b.to_arrays()
    assert [e[:2] for e in da["entries"]] == [e[:2] for e in db["entries"]]
    for (tag, _, fa), (_, _, fb) in zip(da["entries"], db["entries"]):
        for x, y in zip(fa, fb):
            assert x.keys() == y.keys(), tag
            assert all(np.array_equal(x[k], y[k]) for k in x), tag


def _same_params(a: dict, b: dict, where: str) -> None:
    assert sorted(a) == sorted(b), where
    for k in a:
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), \
            f"{where}: params[{k!r}] differ"


# -- checks -------------------------------------------------------------------
def _check_frames_cross(J) -> None:
    """Port frames decode with JAX's recv_frame and JAX frames with the
    port's, over a socket pair, at both widths (0-d, empty, odd shapes);
    the port's tensors go through the batched host copy of a flush."""
    rng = np.random.RandomState(5)
    for ring in (RING64, RING32):
        udt = np.uint64 if ring.ell == 64 else np.uint32
        arrays = [np.frombuffer(rng.bytes(int(np.prod(s)) * ring.ell // 8),
                                udt).reshape(s).copy()
                  for s in ((3, 5), (), (0,), (7,), (2, 1, 3))]
        tensors = [words_from_numpy(a) for a in arrays]
        assert tensors[0].dtype == ring.dtype
        items = [(f"t#{i}.p1", a) for i, a in
                 enumerate(words_to_numpy_batch(tensors))]
        a, b = socket.socketpair()
        with a, b:
            nbytes = TF.send_frames(a, items)
            TF.send_frames(a, [("one", items[0][1])])
            J.F.send_frames(a, [(f"j#{i}", x) for i, x in enumerate(arrays)])
            J.F.send_frame(a, "jone", arrays[3])
            got = J.F.recv_frame(b) + J.F.recv_frame(b)
            assert [t for t, _ in got] == [t for t, _ in items] + ["one"]
            for (_, arr), want in zip(got, arrays + [arrays[0]]):
                assert arr.dtype == udt and arr.shape == want.shape
                assert np.array_equal(arr, want)
            frames = TF.recv_frame(b) + TF.recv_frame(b)
        assert nbytes > sum(x.nbytes for x in arrays)   # header included
        assert [t for t, _ in frames] == [f"j#{i}" for i in range(5)] + \
            ["jone"]
        for (_, arr), want in zip(frames, arrays + [arrays[3]]):
            assert arr.dtype == udt and arr.flags.writeable
            # JAX's framing sends a 0-d array as shape [1]
            assert arr.shape == (want.shape or (1,))
            assert torch.equal(words_from_numpy(arr, copy=False),
                               words_from_numpy(want.reshape(arr.shape)))


def _check_registry_and_stores() -> None:
    """The daemons' registry double-books the wire (link_bits ==
    per_link(), messages counted); a dealt store crosses a blob with its
    words; ContinuousDealer's session 1, which the dealer daemon streams,
    is the deal at seed + 1; LivePrepBank's ordering and watermark
    errors."""
    reg = MetricsRegistry("party-P0", rank=0)
    prev = install_registry(reg)
    try:
        rt = FourPartyRuntime(RING64, seed=SEED, device="cpu")
        nn_program(rt, 0)
    finally:
        install_registry(prev)
    snap = reg.snapshot()
    bits = {(int(s["labels"]["src"]), int(s["labels"]["dst"]),
             s["labels"]["phase"]): s["value"]
            for s in snap["metrics"]["trident_wire_bits_total"]["samples"]}
    assert bits == {(*k, p): b for k, v in rt.transport.per_link().items()
                    for p, b in v.items() if b}
    assert snap["label"] == "party-P0" and snap["rank"] == 0
    msgs = snap["metrics"]["trident_wire_msgs_total"]["samples"]
    assert sum(s["value"] for s in msgs) == \
        sum(rt.transport.link_msgs.values()) > 0
    rounds = snap["metrics"]["trident_wire_round_scopes_total"]["samples"]
    assert sum(s["value"] for s in rounds) >= \
        sum(v["rounds"] for v in rt.transport.totals().values())

    store, _ = deal(_deal_program, seed=SEED, device="cpu")
    back = store_from_blob(store_to_blob(store))
    assert back.meta == store.meta and len(back) > 0
    _same_store(back, store)

    with ContinuousDealer(lambda _s: _deal_program, base_seed=SEED,
                          total=2, device="cpu") as dealer:
        assert dealer.next_store().meta["step"] == 0
        second = dealer.next_store()
    want, _ = deal(_deal_program, seed=SEED + 1, device="cpu")
    assert second.meta["step"] == 1
    _same_store(second, want)

    bank = LivePrepBank(ahead=2)
    bank.append(0, back)
    with pytest.raises(PrepError, match="out of order"):
        bank.append(2, back)
    with pytest.raises(PrepMissingError, match="dealer watermark at 1"):
        bank.seek(2)


def _check_stray_dial_refused() -> None:
    """A dial whose hello names a rank of the mesh but carries another
    token (a cluster that came to the same port) is closed, and the
    listener goes on to take its own peers."""
    token = os.urandom(TOKEN_BYTES)
    endpoints = [("127.0.0.1", p) for p in _free_ports(4)]
    made = {}

    def boot(rank):
        made[rank] = SocketTransport(rank, endpoints, token=token,
                                     device="cpu", timeout=30.0,
                                     connect_timeout=30.0)

    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        first = pool.submit(boot, 0)
        deadline = time.monotonic() + 30.0
        while True:
            try:
                stray = socket.create_connection(endpoints[0], timeout=10.0)
                break
            except OSError:
                assert time.monotonic() < deadline, "P0 never listened"
                time.sleep(0.05)
        with stray:
            stray.sendall(bytes([1]) + bytes(b ^ 0xFF for b in token))
            assert stray.recv(1) == b"", "a foreign hello was taken"
        rest = [pool.submit(boot, rank) for rank in (1, 2, 3)]
        for f in [first, *rest]:
            f.result(timeout=60)
    try:
        for a in range(4):
            for b in range(a + 1, 4):
                assert made[a]._socks[b].getpeername() == \
                    made[b]._socks[a].getsockname(), (a, b)
    finally:
        for t in made.values():
            t.close()


def _check_cluster(J, cluster) -> None:
    """The tiny NN as one task: every daemon's words, totals(), per_link()
    and abort equal JAX's in-process runtime; frames per party bounded by
    the rounds."""
    res = cluster.submit(nn_program, seed=SEED)
    jrt = J.Runtime(J.R64, seed=SEED)
    jopened = _jax_nn(J, jrt)
    rounds = sum(v["rounds"] for v in jrt.transport.totals().values())
    for r in res:
        assert r.result.dtype == np.uint64
        assert np.array_equal(r.result, np.asarray(jopened[r.rank])), r.rank
        assert r.totals == jrt.transport.totals(), r.rank
        assert r.per_link == jrt.transport.per_link(), r.rank
        assert r.abort is bool(jrt.abort_flag()) is False
        frames = sum(r.frames_sent.values())
        assert 0 < frames <= 3 * rounds + 3, (r.rank, frames, rounds)
        assert set(r.frames_sent) == set(r.bytes_sent)
        assert all(k[0] == r.rank for k in r.frames_sent)
        # the traced, metered daemons: the first task's registry and trace
        # chunk hold its bits; every kernel span a launch of the registry
        assert TO.snapshot_link_bits(r.metrics) == _nonzero(r.per_link)
        assert TO.snapshot_value(r.metrics, "trident_cluster_tasks_total") \
            == 1
        assert TO.snapshot_value(r.metrics,
                                 "trident_cluster_tasks_inflight") == 0
        assert r.trace["label"] == f"party-P{r.rank}"
        kinds = [e["args"]["kind"] for e in r.trace["events"]
                 if e["cat"] == "kernel"]
        assert len(kinds) == TO.snapshot_total(
            r.metrics, "trident_kernel_launches_total") > 0
    merged = TO.merged_link_bits([r.trace for r in res])
    assert merged == {f"{s}->{d}": cell for (s, d), cell
                      in _nonzero(res[0].per_link).items()}


def _check_observed(cluster, dealer, tmp_path) -> None:
    """Between tasks: four scrapes, each holding its daemon's per_link();
    a healthy document with the dealer scraped; the merged timeline of the
    four ranks and the dealer."""
    totals = {r.rank: r.result for r in cluster.submit(link_totals)}
    assert cluster.inflight == 0 and cluster.poisoned is None
    snaps = cluster.scrape()
    assert sorted(snaps) == [0, 1, 2, 3]
    for rank, snap in snaps.items():
        assert snap["rank"] == rank and snap["label"] == f"party-P{rank}"
        assert TO.snapshot_link_bits(snap) == _nonzero(totals[rank]), rank
        assert TO.snapshot_value(snap, "trident_cluster_tasks_inflight") == 0
        assert TO.snapshot_value(snap, "trident_cluster_tasks_total") == \
            cluster.tasks_run
    _wait(lambda: dealer.metrics_port and dealer.trace_chunks,
          "the dealer's exporter and first chunk")
    doc = cluster.health(dealer=dealer)
    assert doc["healthy"], doc
    assert all(e["alive"] and e["scrape_ok"] for e in doc["ranks"].values())
    assert sorted(doc["ranks"]) == [0, 1, 2, 3]
    assert doc["dealer"]["scrape_ok"] and doc["dealer"]["alive"], doc
    json.dumps(doc)
    # the dealer may ship another session meanwhile: one list of its
    # chunks for both merges
    dealer_chunks = list(dealer.trace_chunks)
    merged = cluster.save_trace(tmp_path / "cluster.json",
                                extra_chunks=dealer_chunks)
    assert sorted(merged["metadata"]["processes"]) == \
        ["dealer"] + [f"party-P{r}" for r in range(4)]
    assert merged["metadata"]["ranks"] == [0, 1, 2, 3]
    assert json.loads((tmp_path / "cluster.json").read_text()) == merged
    assert cluster.merged_trace(dealer_chunks) == merged


def _check_sharded(J, cluster) -> None:
    params = TASK.init_params(seed=0)
    batch = DATA.batch(0, BATCH)
    shards = TS.shard_batch(batch, 2)
    for i, shard in enumerate(shards):
        for a, b in zip(shard, batch):
            assert np.array_equal(a, b[i * 4:(i + 1) * 4])
    with pytest.raises(ValueError, match="evenly"):
        TS.shard_batch(batch, 3)
    sgd = TS.ShardedClusterSGD([cluster, cluster], TASK, base_seed=SEED)
    got, loss, abort = sgd.step_fn(params, 0, *batch)
    members = [J.S.run_step(J.task, params, shard, step=0, base_seed=SEED,
                            world="joint") for shard in shards]
    _same_params(got, {k: np.mean([m[0][k] for m in members], axis=0)
                       for k in params}, "sharded step")
    assert loss == float(np.mean([m[1] for m in members]))
    assert abort is False


def _check_live_training(J, cluster, dealer) -> None:
    sgd = TS.ClusterSGD(cluster, TASK, base_seed=TRAIN_SEED, prep="live",
                        dealer=dealer)
    p = want = TASK.init_params(seed=0)
    for step in range(STEPS):
        batch = DATA.batch(step, BATCH)
        p, loss, abort = sgd.step_fn(p, step, *batch)
        want, jloss, _ = J.S.run_step(J.task, want, batch, step=step,
                                      base_seed=TRAIN_SEED, world="joint")
        _same_params(p, want, f"live step {step}")
        assert loss == jloss and abort is False, step
    assert sgd.offline_bits_on_mesh() == 0
    for results in sgd.results:
        for r in results:
            assert r.totals["offline"]["bits"] == 0, r.rank
            assert r.totals["online"]["bits"] > 0, r.rank
    assert dealer.failed is None
    # between steps, the finished dealer still serving its exporter (its
    # last session reached the daemons before its "done" reached us)
    _wait(lambda: dealer.done, "the dealer's done")
    doc = sgd.health()
    assert doc["healthy"] and doc["dealer"]["done"], doc
    assert doc["dealer"]["scrape_ok"] and doc["dealer"]["watermark"] == STEPS
    assert {e["next_session"] for e in doc["ranks"].values()} == {STEPS}
    # a replayed streamed step fails naming its session and step...
    with pytest.raises(RuntimeError) as replay:
        sgd.step_fn(p, 1, *DATA.batch(1, BATCH))
    msg = str(replay.value)
    assert "already consumed" in msg and "session 1" in msg \
        and "step 1" in msg, msg
    # ...and poisons the cluster: the next submit raises at once
    t0 = time.monotonic()
    with pytest.raises(ClusterPoisoned, match="already consumed"):
        sgd.step_fn(p, 2, *DATA.batch(2, BATCH))
    assert time.monotonic() - t0 < 5.0
    assert cluster.poisoned is not None


def _serve(prep):
    return serve_over_sockets(serve_predict, QUERIES, batch_size=4,
                              seed=SERVE_SEED, prep=prep, timeout=120,
                              device="cpu")


def _tampered_then_killed():
    """The tampered task on a metered cluster; then one daemon is
    terminated and the health document names it."""
    with PartyCluster(device="cpu", tampers=[TAMPER], timeout=120,
                      metrics=True) as cluster:
        res = cluster.submit(nn_program, seed=SEED)
        proc = cluster._procs[3]
        proc.terminate()
        proc.join(timeout=10)
        assert not proc.is_alive()
        return res, cluster.health()


def test_cluster_matches_jax(tmp_path):
    J = _jax()
    _check_frames_cross(J)
    # before any other thread runs a runtime: the registry is the process's
    _check_registry_and_stores()
    _check_stray_dial_refused()
    # the one-shot clusters (two streams that provision their own, the
    # tampered run) boot and run beside the shared cluster: the daemons
    # spend most of their time importing torch
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        side = {prep: pool.submit(_serve, prep) for prep in ("ahead", "live")}
        tampered = pool.submit(_tampered_then_killed)
        params0 = TASK.init_params(seed=0)
        with PartyCluster(device="cpu", live_prep=True, timeout=120,
                          trace=True, metrics=True) as cluster:
            # the dealer deals while the cluster runs its first tasks
            with TS.attach_live_dealer(cluster, TASK, params0,
                                       DATA.batch(0, BATCH),
                                       base_seed=TRAIN_SEED,
                                       total=STEPS) as dealer:
                _check_cluster(J, cluster)
                streams = {None: serve_over_sockets(
                    serve_predict, QUERIES, batch_size=4, seed=SERVE_SEED,
                    cluster=cluster, device="cpu")}
                _check_sharded(J, cluster)
                _check_observed(cluster, dealer, tmp_path)
                _check_live_training(J, cluster, dealer)
        streams.update({prep: f.result(timeout=300)
                        for prep, f in side.items()})
        res, killed = tampered.result(timeout=300)

    want_words = [_jax_serve_words(J, QUERIES[i:i + 4], SERVE_SEED + k)
                  for k, i in enumerate((0, 4))]
    for prep, (preds, report) in streams.items():
        assert len(preds) == len(QUERIES) and report["batches"] == 2
        assert not report["aborted"], prep
        assert np.array_equal(np.stack(preds), np.concatenate(want_words)), \
            prep
        if prep is not None:
            assert report["online_only"] and report["prep"] == prep
            assert report["totals"]["offline"]["bits"] == 0
    assert streams["ahead"][1]["totals"]["online"] == \
        streams[None][1]["totals"]["online"]
    assert streams["live"][1]["link_online_bits"] == \
        streams[None][1]["link_online_bits"]

    jrt = J.Runtime(J.R64, seed=SEED)
    jrt.transport.tamper(**TAMPER)
    _jax_nn(J, jrt)
    assert [r.abort for r in res] == [bool(jrt.abort_flag())] * 4 \
        == [True] * 4
    assert not killed["healthy"] and killed["probes"] == [
        {"probe": "rank_down", "rank": 3, "alive": False,
         "scrape_ok": False}], killed
