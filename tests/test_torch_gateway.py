"""The port's serving gateway (``repro_torch.serve.gateway``) against the
JAX package on the CPU, on two live clusters of four daemon processes
booted once and adopted by every part:

  (a) queries from four threads coalesce into padded share batches (fewer
      dispatches than queries); every row equals JAX's
      ``FourPartyRuntime`` on its dispatch's padded batch and seed, bit
      for bit; the latency percentiles and the registry's serving and
      gateway counters follow the queries and batches served;
  (b) a live pool with one shared dealer: nine dispatches one at a time
      (the two members take turns, and none stalls the dealer: the
      reference design's scheduler sends them all to one member, and the
      dealer blocks on the other's full control queues), then a burst;
      every row equals JAX's inline run at ``base_seed + session``, each
      session used once across the pool, no offline bit, no eviction;
      idle, the dealer stops exactly ``LIVE_LEAD`` sessions past the
      slowest member's cursor;
  (c) cluster 0's daemons stopped, then killed once a batch was dispatched
      to them, with batches queued: that batch is re-dispatched and every
      query resolves, on cluster 1, equal to JAX; ``health()`` names the
      eviction and a dealer that did not fail; with cluster 1 killed too,
      the next query fails with "gateway pool exhausted";
  (d) ``PartyPredictionServer`` serves through the gateway: a flush whose
      program raises raises, and the next flush serves JAX's server's
      words, each batch counted once on the registry;
  (e) a plain pool the gateway booted itself: its member's daemons killed
      while idle, the member is evicted, a replacement boots and serves
      JAX's words.

The daemons and the dealer are spawned and import this module to find
its programs, so its top level imports neither jax nor the JAX package:
the JAX side is imported inside the test."""
import concurrent.futures
import os
import signal
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small shapes: one intra-op thread, so idle torch threads do not spin
# beside the JAX tests that share this worker
torch.set_num_threads(1)

from repro_torch.core.ring import words_to_numpy  # noqa: E402
from repro_torch.obs import get_registry, snapshot_total  # noqa: E402
from repro_torch.runtime import activations as TRA  # noqa: E402
from repro_torch.runtime import protocols as TRT  # noqa: E402
from repro_torch.runtime.net.cluster import (LIVE_LEAD,  # noqa: E402
                                             PartyCluster)
from repro_torch.serve.gateway import ServingGateway  # noqa: E402
from repro_torch.serve.party_server import (  # noqa: E402
    PartyPredictionServer)

TIMEOUT = 120.0
PLAIN_SEED = 5
LIVE_SEED = 9
SERVER_SEED = 3
_rng = np.random.RandomState(7)
W1 = _rng.randn(4, 3) * 0.4
QUERIES = np.random.RandomState(3).randn(40, 4)
COUNTED = ("trident_serve_queries_total", "trident_serve_batches_total",
           "trident_serve_batch_latency_us", "trident_gateway_queries_total",
           "trident_gateway_dispatches_total", "trident_gateway_batch_size",
           "trident_gateway_query_latency_us")


def gw_predict(rt, Xb):
    """share -> matmul_tr -> relu -> reconstruct: P1's opened words."""
    xs = TRT.share(rt, rt.encode(Xb))
    w = TRT.share(rt, rt.encode(W1))
    return TRT.reconstruct(rt, TRA.relu(rt, TRT.matmul_tr(rt, xs, w)))[1]


# -- the JAX side ------------------------------------------------------------
def _jax_words(Xb: np.ndarray, seed: int) -> np.ndarray:
    from repro.core.ring import RING64
    from repro.runtime import FourPartyRuntime
    from repro.runtime import activations as RA
    from repro.runtime import protocols as RT
    rt = FourPartyRuntime(RING64, seed=seed)
    xs = RT.share(rt, RING64.encode(Xb))
    w = RT.share(rt, RING64.encode(W1))
    return np.asarray(RT.reconstruct(rt, RA.relu(
        rt, RT.matmul_tr(rt, xs, w)))[1])


def _jax_predict(rt, Xb):
    from repro.core.ring import RING64
    from repro.runtime import activations as RA
    from repro.runtime import protocols as RT
    xs = RT.share(rt, RING64.encode(Xb))
    w = RT.share(rt, RING64.encode(W1))
    return np.asarray(RT.reconstruct(rt, RA.relu(
        rt, RT.matmul_tr(rt, xs, w)))[1])


# -- helpers ---------------------------------------------------------------
def _counts() -> dict:
    snap = get_registry().snapshot()
    return {name: snapshot_total(snap, name) for name in COUNTED}


def _served(gw, futs, queries) -> list:
    """Every row equals JAX on the padded batch and seed of the dispatch
    that served it (the LAST record naming its query id: an earlier one
    is an evicted member's lost dispatch); returns the serving records."""
    rows = [fut.result(timeout=TIMEOUT) for fut in futs]
    records = [rec for m in gw._members for rec in m.dispatch_log]
    want, used = {}, []
    for fut, row, q in zip(futs, rows, queries):
        rec = [r for r in records if r["qids"] and fut.qid in r["qids"]][-1]
        if id(rec) not in want:
            want[id(rec)] = _jax_words(rec["X"], rec["seed"])
            used.append(rec)
        i = rec["qids"].index(fut.qid)
        assert row.dtype == np.uint64
        assert np.array_equal(row, want[id(rec)][i]), fut.qid
        assert np.array_equal(rec["X"][i], q), fut.qid
    return used


def _feed(gw, queries, threads: int = 4) -> list:
    futs = [None] * len(queries)

    def feed(k):
        for i in range(k, len(queries), threads):
            futs[i] = gw.submit(queries[i])

    workers = [threading.Thread(target=feed, args=(k,))
               for k in range(threads)]
    for t in workers:
        t.start()
    for t in workers:
        t.join()
    return futs


# -- the parts -------------------------------------------------------------
def _check_plain(clusters) -> None:
    before = _counts()
    queries = QUERIES[:12]
    with ServingGateway(gw_predict, clusters=clusters, max_batch=4,
                        max_wait_ms=100.0, base_seed=PLAIN_SEED,
                        timeout=TIMEOUT, keep_results=True) as gw:
        futs = _feed(gw, queries)
        gw.drain(timeout=TIMEOUT)
        used = _served(gw, futs, queries)
        rep = gw.report()
    after = _counts()
    assert rep["queries"] == 12 and rep["evictions"] == 0
    assert rep["pool_size"] == 2
    assert rep["batches"] == len(used) < 12 and rep["avg_batch_size"] > 1
    assert rep["p99_ms"] >= rep["p50_ms"] > 0 and rep["achieved_qps"] > 0
    assert sorted(r["seed"] for r in used) == \
        list(range(PLAIN_SEED, PLAIN_SEED + len(used)))
    assert sum(m["tasks"] for m in rep["per_member"].values()) == len(used)
    delta = {k: after[k] - before[k] for k in COUNTED}
    assert delta == {
        "trident_serve_queries_total": 12,
        "trident_serve_batches_total": len(used),
        "trident_serve_batch_latency_us": len(used),
        "trident_gateway_queries_total": 12,
        "trident_gateway_dispatches_total": len(used),
        "trident_gateway_batch_size": len(used),
        "trident_gateway_query_latency_us": 12}, delta


def _check_live_then_evict(clusters) -> None:
    queries = QUERIES[12:]
    with ServingGateway(gw_predict, clusters=clusters, prep="live",
                        max_batch=4, max_wait_ms=None, base_seed=LIVE_SEED,
                        timeout=TIMEOUT, keep_results=True) as gw:
        # (b) nine dispatches one at a time, then a burst of eight
        futs = []
        for q in queries[:9]:
            futs.append(gw.submit(q))
            gw.flush()
            futs[-1].result(timeout=TIMEOUT)
        futs += [gw.submit(q) for q in queries[9:17]]
        gw.drain(timeout=TIMEOUT)
        used = _served(gw, futs, queries[:17])
        rep = gw.report()
        assert rep["evictions"] == 0 and rep["queries"] == 17
        sessions = sorted(r["session"] for r in used)
        assert sessions == list(range(11))
        assert all(r["seed"] == LIVE_SEED + r["session"] for r in used)
        order = sorted(used, key=lambda r: r["session"])
        assert [r["member"] for r in order[:9]] == [0, 1] * 4 + [0]
        for m in gw._members:
            assert len(m.results_log) == len(m.dispatch_log) > 0
            for results in m.results_log:
                for r in results:
                    assert r.totals["offline"]["bits"] == 0, r.rank
                    assert r.totals["online"]["bits"] > 0 and not r.abort
        # idle, the dealer runs exactly LIVE_LEAD sessions past the
        # slowest member's cursor (its last session + 1), and no further
        bound = min(m.backend.last_session for m in gw._members) + 1 \
            + LIVE_LEAD
        deadline = time.monotonic() + 60
        while gw.dealer.dealt < bound:
            assert time.monotonic() < deadline, (gw.dealer.dealt, bound)
            time.sleep(0.05)
        time.sleep(0.5)
        assert gw.dealer.dealt == bound

        # (c) cluster 0's daemons killed with batches queued; stopped
        # first, so the batch dispatched to them cannot finish before the
        # kill
        for p in clusters[0]._procs:
            os.kill(p.pid, signal.SIGSTOP)
        more = queries[17:25]
        futs = [gw.submit(q) for q in more]
        gw.flush()
        qids = {f.qid for f in futs}
        deadline = time.monotonic() + 60
        while not any(qids & set(r["qids"])
                      for r in gw._members[0].dispatch_log):
            assert time.monotonic() < deadline, "nothing dispatched to 0"
            time.sleep(0.01)
        for p in clusters[0]._procs:
            p.kill()
        gw.drain(timeout=TIMEOUT)
        used = _served(gw, futs, more)
        assert {r["member"] for r in used} == {1}
        lost = {q for r in gw._members[0].dispatch_log
                for q in r["qids"]} & qids
        assert lost and all(                    # re-dispatched to 1
            any(q in r["qids"] for r in used) for q in lost)
        sessions = [r["session"] for m in gw._members
                    for r in m.dispatch_log]
        assert len(sessions) == len(set(sessions))     # none used twice
        rep, health = gw.report(), gw.health()
        assert rep["evictions"] == 1 and rep["pool_size"] == 1
        assert rep["queries"] == 25
        assert health["pool"]["0"] == {"healthy": False, "evicted": True}
        assert health["evictions"][0]["member"] == 0
        assert health["dealer_failed"] is None and gw.dealer.failed is None
        assert not gw.dealer.done

        for p in clusters[1]._procs:
            p.kill()
        last = gw.submit(queries[25])
        gw.flush()
        with pytest.raises(RuntimeError, match="gateway pool exhausted"):
            last.result(timeout=TIMEOUT)
        assert gw.pool_size == 0


def _check_in_process() -> None:
    from repro.core.ring import RING64
    from repro.serve.party_server import PartyPredictionServer as JServer
    queries = QUERIES[:5]
    jsrv = JServer(_jax_predict, batch_size=2, ring=RING64,
                   seed=SERVER_SEED)
    try:
        for q in queries:
            jsrv.submit(q)
        jwords = np.stack(jsrv.flush())
    finally:
        jsrv.close()
    calls = []

    def flaky(rt, Xb):
        calls.append(len(Xb))
        if len(calls) == 1:
            raise RuntimeError("flaky program")
        return gw_predict(rt, Xb)

    before = _counts()
    srv = PartyPredictionServer(flaky, batch_size=2, seed=SERVER_SEED,
                                device="cpu")
    try:
        srv.submit(queries[0])
        with pytest.raises(RuntimeError, match="flaky program"):
            srv.flush()
        assert srv._gw.pool_size == 1 and not srv._gw.evictions
        for q in queries:
            srv.submit(q)
        words = words_to_numpy(torch.stack(srv.flush()))
    finally:
        srv.close()
    after = _counts()
    assert np.array_equal(words, jwords) and len(calls) == 4
    rep = srv.report()
    assert rep["queries"] == 5 and rep["batches"] == 3
    assert not rep["aborted"]
    assert after["trident_serve_queries_total"] - \
        before["trident_serve_queries_total"] == 5
    for name in ("trident_serve_batches_total",
                 "trident_serve_batch_latency_us"):
        assert after[name] - before[name] == 3, name


def _replaced(serve_now: threading.Event):
    """(e), beside the other parts; it serves once `serve_now` is set (the
    registry counts of (a) are exact).  Returns the rows, the dispatch
    records, the report and the health document."""
    with ServingGateway(gw_predict, pool=1, device="cpu", max_batch=2,
                        max_wait_ms=None, base_seed=PLAIN_SEED,
                        timeout=TIMEOUT, keep_results=True) as gw:
        for p in gw._members[0].backend.cluster._procs:
            p.kill()
        deadline = time.monotonic() + 120
        while not (len(gw._members) == 2 and gw.pool_size == 1):
            assert time.monotonic() < deadline, "no replacement joined"
            time.sleep(0.1)
        assert serve_now.wait(timeout=300)
        futs = [gw.submit(q) for q in QUERIES[:2]]
        gw.flush()
        rows = [f.result(timeout=TIMEOUT) for f in futs]
        records = [r for m in gw._members for r in m.dispatch_log]
        return rows, records, gw.report(), gw.health()


def test_gateway_matches_jax():
    _check_in_process()
    serve_now = threading.Event()
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        replaced = pool.submit(_replaced, serve_now)
        boots = [pool.submit(PartyCluster, device="cpu", live_prep=True,
                             metrics=True, timeout=TIMEOUT)
                 for _ in range(2)]
        clusters = [f.result(timeout=300) for f in boots]
        try:
            _check_plain(clusters)
            serve_now.set()
            _check_live_then_evict(clusters)
        finally:
            serve_now.set()
            for c in clusters:
                c.close()
        rows, records, rep, health = replaced.result(timeout=300)

    (rec,) = records
    assert rec["member"] == 1 and rec["seed"] == PLAIN_SEED
    want = _jax_words(rec["X"], rec["seed"])
    assert all(np.array_equal(r, w) for r, w in zip(rows, want))
    assert rep["evictions"] == 1 and rep["queries"] == 2
    assert health["pool"]["0"] == {"healthy": False, "evicted": True}
    assert "went down while idle: party daemon(s) [0, 1, 2, 3] died" in \
        health["evictions"][0]["error"]
