"""The port's observability plane (``repro_torch.obs`` and its seams in the
transport, the runtime and the kernel backend) against the JAX package's
on the CPU.

The program of ``tests/test_obs.py`` (share, share, matmul, relu, open)
runs at seeds 1-7 through JAX's runtime (x64, a ``repro.obs.Tracer`` and
a fresh registry installed) and through the port's (``device="cpu"``,
the "hopper" and "torch" backends in turn), and the two must agree
exactly: the tracer's link bits (both equal to ``per_link()``), the
sequences of protocol spans, round spans and send instants, the kernel
spans per kind (equal to the registry's launches), and the registry
snapshot (values, types, labels and help; the wall-clock fields and the
microsecond wall totals left out).  Then the pure helpers on the same
inputs: the Prometheus text of a registry fed the same increments,
``merge_chunks``, ``merged_link_bits``, ``round_wall_ms``,
``metrics_snapshot`` and the fired probes of ``evaluate_probes``; each
package's scraper reads the other's exporter; and with tracing off the
port holds the null tracer and no ``TracedKernels``, and opens the words
it opens traced.  One test item, so the collected count stays where the
tier-1 split of the slow tests needs it.
"""
import collections
import json
import time
import types
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import obs as JO  # noqa: E402
from repro.obs import exporter as JE  # noqa: E402
from repro.obs import health as JH  # noqa: E402
from repro.runtime import FourPartyRuntime as JRuntime  # noqa: E402
from repro.runtime import activations as JA  # noqa: E402
from repro.runtime import protocols as JP  # noqa: E402
from repro_torch import obs as TO  # noqa: E402
from repro_torch.core.ring import RING64  # noqa: E402
from repro_torch.obs import exporter as TE  # noqa: E402
from repro_torch.obs import health as TH  # noqa: E402
from repro_torch.runtime import FourPartyRuntime as TRuntime  # noqa: E402
from repro_torch.runtime import activations as TA  # noqa: E402
from repro_torch.runtime import protocols as TP  # noqa: E402
from repro_torch.runtime.kernel_backend import (  # noqa: E402
    MeteredKernels, TracedKernels)
from repro_torch.serve.party_server import serve_over_sockets  # noqa: E402

SEEDS = range(1, 8)
# each event category and the args of it that both packages must agree on
SPAN_ARGS = {
    "protocol": ("prep", "session", "checks"),
    "wire.round": ("phase", "index", "bits"),
    "wire.send": ("src", "dst", "tag", "bits", "phase", "round"),
}
# snapshot keys that read a clock or name the process
WALL_KEYS = ("updated", "ts", "pid", "created")


def _jax_program(rt):
    x = JP.share(rt, jnp.arange(6, dtype=jnp.int64).reshape(2, 3))
    y = JP.share(rt, jnp.ones((3, 2), dtype=jnp.int64))
    z = JP.matmul(rt, x, y)
    r = JA.relu(rt, z)
    return JP.reconstruct(rt, r)[0]


def _port_program(rt):
    x = TP.share(rt, rt.words(np.arange(6).reshape(2, 3)))
    y = TP.share(rt, rt.words(np.ones((3, 2), dtype=np.int64)))
    z = TP.matmul(rt, x, y)
    r = TA.relu(rt, z)
    return TP.reconstruct(rt, r)[0]


def _nonzero(per_link: dict) -> dict:
    out = {}
    for link, per in per_link.items():
        cell = {p: b for p, b in per.items() if b}
        if cell:
            out[link] = cell
    return out


def _events(chunk: dict, cat: str) -> list:
    keys = SPAN_ARGS[cat]
    return [(e["name"], *(e.get("args", {}).get(k) for k in keys))
            for e in chunk["events"] if e["cat"] == cat]


def _kernel_spans(chunk: dict) -> dict:
    """kind -> [shape, ...] in call order."""
    out = collections.defaultdict(list)
    for e in chunk["events"]:
        if e["cat"] == "kernel":
            assert e["name"] == f"kernel.{e['args']['kind']}"
            out[e["args"]["kind"]].append(list(e["args"]["shape"]))
    return dict(out)


def _comparable(snap: dict, backend_label: dict | None = None) -> dict:
    """A snapshot without its clocks and wall totals; `backend_label`
    renames the kernel backend label (the counts do not depend on it)."""
    out = {}
    for name, fam in snap["metrics"].items():
        wall = name.endswith("_us_total") or fam["type"] == "histogram"
        samples = []
        for s in fam["samples"]:
            s = {k: v for k, v in s.items() if k not in WALL_KEYS}
            if "backend" in s["labels"] and backend_label:
                s["labels"] = {**s["labels"], "backend": backend_label[
                    s["labels"]["backend"]]}
            if wall:
                s = {"labels": s["labels"]}
            samples.append(s)
        out[name] = {"type": fam["type"], "help": fam["help"],
                     "samples": sorted(samples, key=json.dumps)}
    return out


def _run_jax(seed: int):
    tracer, reg = JO.Tracer("test", rank=0), JO.MetricsRegistry("test", 0)
    prev_t, prev_r = JO.install_tracer(tracer), JO.install_registry(reg)
    try:
        rt = JRuntime(seed=seed)
        words = np.asarray(_jax_program(rt))
    finally:
        JO.install_tracer(prev_t)
        JO.install_registry(prev_r)
    assert rt.tracer is tracer
    return words, rt, tracer, reg


def _run_port(seed: int, backend: str, traced: bool = True):
    tracer = TO.Tracer("test", rank=0) if traced else TO.NULL_TRACER
    reg = TO.MetricsRegistry("test", 0)
    prev_t, prev_r = TO.install_tracer(tracer), TO.install_registry(reg)
    try:
        rt = TRuntime(seed=seed, device="cpu", kernel_backend=backend)
        words = _port_program(rt).numpy().astype(np.uint64)
    finally:
        TO.install_tracer(prev_t)
        TO.install_registry(prev_r)
    return words, rt, tracer, reg


def _check_program(seed: int) -> dict:
    """One seed through both packages; returns JAX's drained chunk."""
    backend = "hopper" if seed % 2 else "torch"
    jwords, jrt, jtr, jreg = _run_jax(seed)
    twords, trt, ttr, treg = _run_port(seed, backend)
    assert np.array_equal(twords, jwords), seed
    assert isinstance(trt.kernels, TracedKernels) and trt.tracer is ttr
    assert trt.transport.tracer is ttr

    measured = _nonzero(trt.transport.per_link())
    assert measured == _nonzero(jrt.transport.per_link()), seed
    assert ttr.link_bits() == measured == jtr.link_bits(), seed
    assert treg.link_bits() == measured == jreg.link_bits(), seed

    jchunk, tchunk = jtr.drain(), ttr.drain()
    json.dumps(tchunk)
    assert tchunk.keys() == jchunk.keys()
    assert tchunk["link_bits"] == jchunk["link_bits"], seed
    for cat in SPAN_ARGS:
        got, want = _events(tchunk, cat), _events(jchunk, cat)
        assert got and got == want, (seed, cat)
    assert {"protocol", "wire.round", "wire.send", "kernel"} <= \
        {e["cat"] for e in tchunk["events"]}
    spans = _kernel_spans(tchunk)
    assert spans == _kernel_spans(jchunk), seed
    launches = {s["labels"]["kind"]: s["value"] for s in treg.snapshot()[
        "metrics"]["trident_kernel_launches_total"]["samples"]}
    assert {k: len(v) for k, v in spans.items()} == launches, seed
    for e in tchunk["events"]:
        if e["cat"] == "kernel":
            # no CUDA events on the CPU; a round call's requests share it
            assert "device_ms" not in e["args"] and e["args"]["group"] >= 1
            assert e["args"]["backend"] == backend

    tsnap, jsnap = treg.snapshot(), jreg.snapshot()
    assert tsnap.keys() == jsnap.keys()
    assert (tsnap["label"], tsnap["rank"]) == (jsnap["label"], jsnap["rank"])
    assert jsnap["metrics"]["trident_protocol_checks_total"]["samples"][0][
        "value"] > 0
    assert _comparable(tsnap) == _comparable(jsnap, {"jnp": backend}), seed
    assert TO.snapshot_link_bits(tsnap) == measured

    # tracing off: the null tracer, no proxy, the same words
    off_words, off_rt, off_tr, _ = _run_port(seed, backend, traced=False)
    assert off_tr is TO.NULL_TRACER and off_rt.tracer is TO.NULL_TRACER
    assert type(off_rt.kernels) is MeteredKernels
    assert np.array_equal(off_words, twords), seed
    assert off_rt.transport.per_link() == trt.transport.per_link()
    return jchunk


def _feed(reg) -> None:
    """The same increments on either package's registry."""
    c = reg.counter("c_total", "a counter", kind="x")
    c.inc()
    c.inc(4)
    reg.counter("c_total", kind="y").inc(2.5)
    reg.gauge("g", "a gauge", rank=3).set(7)
    reg.gauge("g_nohelp").set(-1.25)
    h = reg.histogram("h_us", "a histogram", phase="online")
    for v in (5.0, 10.0, 99.9, 100.0, 1e6, 0.0):
        h.observe(v)
    reg.histogram("h_us", phase="offline")
    reg.counter("trident_wire_bits_total", "bits", src=0, dst=1,
                phase="online").inc(64)
    reg.counter("trident_wire_bits_total", "bits", src=1, dst=0,
                phase="offline").inc(0)


def _check_registry_text() -> None:
    treg, jreg = TO.MetricsRegistry("r", 1), JO.MetricsRegistry("r", 1)
    _feed(treg)
    _feed(jreg)
    assert treg.render_prometheus() == jreg.render_prometheus()
    tsnap, jsnap = treg.snapshot(), jreg.snapshot()
    assert _comparable(tsnap) == _comparable(jsnap)
    # one sample line a counter or gauge sample, buckets + sum + count a
    # histogram sample
    lines = [ln for ln in treg.render_prometheus().splitlines()
             if not ln.startswith("#")]
    assert len(lines) == sum(
        len(s["edges"]) + 3 if f["type"] == "histogram" else 1
        for f in tsnap["metrics"].values() for s in f["samples"])
    for name in ("c_total", "g", "h_us", "trident_wire_bits_total"):
        assert TO.snapshot_total(tsnap, name) == \
            JO.snapshot_total(jsnap, name) == treg.total(name)
        assert TO.snapshot_updated(tsnap, name) > 0
    assert TO.snapshot_value(tsnap, "c_total", kind="x") == 5
    assert TO.snapshot_value(tsnap, "h_us", phase="online") == 6
    assert TO.snapshot_value(tsnap, "nope", default=None) is None
    assert treg.link_bits() == jreg.link_bits() == {(0, 1): {"online": 64}}
    with pytest.raises(ValueError, match="already registered"):
        treg.gauge("c_total")
    assert treg.gauge("g", rank=3).read()[0] == 7


def _chunks(jchunk: dict) -> list:
    """Hand-made chunks of two processes (spans, instants, counters,
    rounds) beside a real one."""
    def chunk(label, rank, epoch, events, links):
        return {"label": label, "rank": rank, "epoch": epoch,
                "events": events, "link_bits": links}
    a = chunk("party-P0", 0, 1000.0, [
        {"ph": "X", "name": "round[online]", "cat": "wire.round",
         "ts": 1.0, "dur": 0.002, "tid": 1,
         "args": {"phase": "online", "index": 0, "bits": 64}},
        {"ph": "X", "name": "round[online]", "cat": "wire.round",
         "ts": 1.5, "dur": 0.004, "tid": 1,
         "args": {"phase": "online", "index": 1, "bits": 128}},
        {"ph": "i", "name": "send", "cat": "wire.send", "ts": 1.001,
         "tid": 1, "args": {"src": 0, "dst": 1, "tag": "t", "bits": 64,
                            "phase": "online", "round": 0}},
        {"ph": "C", "name": "live_bank_depth", "cat": "prep", "ts": 1.2,
         "tid": 2, "args": {"value": 3}},
        {"ph": "C", "name": "live_bank_depth", "cat": "prep", "ts": 1.3,
         "tid": 2, "args": {"value": 1}},
        {"ph": "X", "name": "kernel.prf_bits", "cat": "kernel", "ts": 1.1,
         "dur": 1e-5, "tid": 1, "args": {"kind": "prf_bits"}}],
        {"0->1": {"online": 192}})
    b = chunk("party-P1", 1, 999.5, [
        {"ph": "X", "name": "round[online]", "cat": "wire.round",
         "ts": 1.6, "dur": 0.003, "tid": 7,
         "args": {"phase": "online", "index": 0, "bits": 64}},
        {"ph": "X", "name": "deal", "cat": "", "ts": 1.7, "dur": 0.1,
         "tid": 7}],
        {"0->1": {"online": 128, "offline": 8}, "1->2": {"online": 4}})
    return [a, None, b, dict(a, events=a["events"][:1]), jchunk]


def _check_merge(jchunk: dict, tmp_path) -> None:
    chunks = _chunks(jchunk)
    tdoc, jdoc = TO.merge_chunks(chunks), JO.merge_chunks(chunks)
    assert json.dumps(tdoc) == json.dumps(jdoc)
    assert json.dumps(TO.merged_link_bits(chunks)) == \
        json.dumps(JO.merged_link_bits(chunks))
    for pid in (None, 1, 2):
        assert json.dumps(TO.round_wall_ms(tdoc, pid)) == \
            json.dumps(JO.round_wall_ms(jdoc, pid))
    assert json.dumps(TO.metrics_snapshot(tdoc)) == \
        json.dumps(JO.metrics_snapshot(jdoc))
    written = TO.write_chrome_trace(tmp_path / "trace.json", chunks)
    assert json.loads((tmp_path / "trace.json").read_text()) == written


def _rank_snap(reg_mod, *, inflight=0, online_rounds=0, depth=None,
               next_session=0, age=0.0):
    reg = reg_mod.MetricsRegistry("party-P0", rank=0)
    reg.gauge("trident_cluster_tasks_inflight").set(inflight)
    if online_rounds:
        reg.counter("trident_wire_round_scopes_total",
                    phase="online").inc(online_rounds)
    if depth is not None:
        reg.gauge("trident_live_bank_depth").set(depth)
    reg.gauge("trident_prep_next_session").set(next_session)
    snap = reg.snapshot()
    for fam in snap["metrics"].values():
        for s in fam["samples"]:
            s["updated"] -= age
    return snap


def _dealer_snap(reg_mod, *, watermark=0, done=0, age=0.0):
    reg = reg_mod.MetricsRegistry("dealer")
    reg.gauge("trident_dealer_watermark").set(watermark)
    reg.gauge("trident_dealer_done").set(done)
    snap = reg.snapshot()
    for fam in snap["metrics"].values():
        for s in fam["samples"]:
            s["updated"] -= age
    return snap


def _check_probes() -> None:
    """The same snapshots and `now` fire the same probes in both."""
    now = time.time()
    cases = [
        ({0: dict(inflight=1, online_rounds=3, age=10.0)}, None, False),
        ({0: dict(inflight=1, age=10.0)}, None, False),
        ({0: dict(inflight=0, age=100.0)}, None, False),
        ({0: dict(inflight=1, online_rounds=1, age=1.0)}, None, False),
        ({0: dict(inflight=1, depth=0, age=10.0)},
         dict(watermark=5, age=10.0), True),
        ({0: dict(inflight=1, depth=0, age=10.0)},
         dict(watermark=5, done=1), True),
        ({0: dict(next_session=7), 1: dict(next_session=3)},
         dict(watermark=2, age=10.0), True),
        ({0: dict(next_session=7)}, dict(watermark=2, age=1.0), True),
        ({0: dict(next_session=7)}, dict(watermark=9, age=10.0), True),
    ]
    fired = set()
    for ranks, dealer, attached in cases:
        got = {}
        for mod, probe in ((TO, TH), (JO, JH)):
            snaps = {r: _rank_snap(mod, **kw) for r, kw in ranks.items()}
            snaps[9] = None
            dsnap = _dealer_snap(mod, **dealer) if dealer else None
            got[mod] = probe.evaluate_probes(snaps, dsnap, now=now,
                                             stall_s=5.0,
                                             dealer_attached=attached)
        assert [p["probe"] for p in got[TO]] == \
            [p["probe"] for p in got[JO]], (ranks, dealer)
        for p, q in zip(got[TO], got[JO]):
            assert p.keys() == q.keys() and p.get("rank") == q.get("rank")
        fired |= {p["probe"] for p in got[TO]}
    assert fired == {"round_stall", "bank_low", "dealer_lag"}


class _StubCluster:
    """What cluster_health reads of a cluster: liveness and ports."""

    def __init__(self, ports: dict):
        self.metrics_ports = ports

    def alive(self) -> dict:
        return {r: True for r in self.metrics_ports}


def _check_exporters() -> None:
    """Each package's scraper reads the other's exporter; the port's
    health document over its own exporter and a dead port."""
    treg, jreg = TO.MetricsRegistry("party-P0", 0), JO.MetricsRegistry(
        "party-P1", 1)
    _feed(treg)
    _feed(jreg)
    with TE.MetricsExporter(treg) as tex, \
            JE.MetricsExporter(jreg) as jex:
        got = JH.scrape(tex.port)
        assert _comparable(got) == _comparable(treg.snapshot())
        assert (got["label"], got["rank"]) == ("party-P0", 0)
        back = TH.scrape(jex.port)
        assert _comparable(back) == _comparable(jreg.snapshot())
        text = urllib.request.urlopen(
            f"http://127.0.0.1:{tex.port}/metrics", timeout=5).read()
        assert text.decode() == treg.render_prometheus()
        hz = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{tex.port}/healthz", timeout=5).read())
        assert hz["ok"] and hz["label"] == "party-P0"
        for mod, probe in ((TH, TO), (JH, JO)):
            doc = mod.cluster_health(_StubCluster({0: tex.port,
                                                   1: jex.port}))
            assert doc["healthy"] and [
                doc["ranks"][r]["scrape_ok"] for r in (0, 1)] == [True] * 2
        dead = TH.cluster_health(_StubCluster({0: tex.port, 1: None}))
        assert not dead["healthy"] and dead["probes"] == [
            {"probe": "rank_down", "rank": 1, "alive": True,
             "scrape_ok": False}]
    assert TH._try_scrape(tex.port, 0.5) is None      # closed


def _check_switches(monkeypatch) -> None:
    """Tracing is off unless asked for; the helpers."""
    monkeypatch.delenv(TO.TRACE_ENV, raising=False)
    monkeypatch.delenv(TO.METRICS_ENV, raising=False)
    prev = TO.install_tracer(None)
    try:
        assert TO.get_tracer() is TO.NULL_TRACER
        assert not TO.tracing_enabled() and not TO.metrics_enabled()
        assert TO.NULL_TRACER.drain() is None
        rt = TRuntime(seed=1, device="cpu")
        assert rt.tracer is TO.NULL_TRACER
        assert type(rt.kernels) is MeteredKernels
        monkeypatch.setenv(TO.TRACE_ENV, "1")
        monkeypatch.setenv(TO.METRICS_ENV, "1")
        TO.install_tracer(None)
        assert TO.get_tracer().enabled and TO.metrics_enabled()
        tr = TO.Tracer("lbl", rank=2)
        TO.install_tracer(tr)
        assert TO.get_tracer() is tr and (tr.label, tr.rank) == ("lbl", 2)

        class Stats:
            a = b = 0.0
        with TO.timed(Stats, "a", "b", span="serve.batch", queries=3):
            time.sleep(0.01)
        assert Stats.a == Stats.b >= 0.01
        ev = tr.drain()["events"]
        assert [(e["name"], e["cat"], e["args"]) for e in ev] == \
            [("serve.batch", "serve", {"queries": 3})]
        with TO.stopwatch() as sw:
            time.sleep(0.01)
        assert sw.s >= 0.01
        # ensure_tracer keeps an enabled tracer and installs one where
        # tracing is off, as JAX's does
        assert TO.ensure_tracer("other", rank=3) is tr
        for pkg in (TO, JO):
            jprev = pkg.install_tracer(pkg.NULL_TRACER)
            try:
                made = pkg.ensure_tracer("ens", rank=1)
                assert made.enabled and pkg.get_tracer() is made
                assert (made.label, made.rank) == ("ens", 1)
                assert pkg.ensure_tracer("again") is made
            finally:
                pkg.install_tracer(jprev)
    finally:
        TO.install_tracer(prev)


def _check_stream_arguments() -> None:
    """A given cluster must be live for prep="live" and metered for
    metrics=True; both refusals come before any task."""
    plain = types.SimpleNamespace(ring=RING64, net_model=None,
                                  live_prep=False, metrics=False)
    queries = np.zeros((2, 3))
    with pytest.raises(ValueError, match="live_prep=True"):
        serve_over_sockets(None, queries, cluster=plain, prep="live")
    with pytest.raises(ValueError, match="metrics=True"):
        serve_over_sockets(None, queries, cluster=plain, metrics=True)
    with pytest.raises(ValueError, match="loads or streams"):
        serve_over_sockets(None, queries, cluster=types.SimpleNamespace(
            **{**vars(plain), "live_prep": True}), prep="ahead")


def test_obs_matches_jax(monkeypatch, tmp_path):
    jchunks = [_check_program(seed) for seed in SEEDS]
    _check_registry_text()
    _check_merge(jchunks[0], tmp_path)
    _check_probes()
    _check_exporters()
    _check_switches(monkeypatch)
    _check_stream_arguments()
