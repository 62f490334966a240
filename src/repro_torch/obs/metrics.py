"""Metrics snapshots over merged trace documents
(``repro/obs/metrics.py``).

Where ``merge.py`` answers "show me the timeline", this module answers
"give me the numbers": per-category span histograms, per-phase round
wall-clock (the measured side of a measured-vs-modeled
attribution), per-link byte totals, and counter extrema (queue depths).
Everything operates on the plain-dict Chrome trace document, so the
cluster's parent process and the tests share one reading of a trace file
(and read the JAX package's trace files the same way).
"""
from __future__ import annotations

from collections import defaultdict

_HIST_EDGES_US = (10.0, 100.0, 1_000.0, 10_000.0, 100_000.0)


def _histogram(durs_us) -> dict:
    """Fixed-edge log histogram over span durations (µs)."""
    buckets = [0] * (len(_HIST_EDGES_US) + 1)
    for d in durs_us:
        for i, edge in enumerate(_HIST_EDGES_US):
            if d < edge:
                buckets[i] += 1
                break
        else:
            buckets[-1] += 1
    return {"edges_us": list(_HIST_EDGES_US), "counts": buckets}


def round_wall_ms(doc, pid=None) -> dict:
    """Measured wall time spent inside transport round scopes.

    Without ``pid``: {pid: {phase: ms}} across every process on the
    timeline.  With ``pid``: the FLAT ``{phase: ms}`` for that one
    process (a single pid's total is the measured online/offline time
    from that process's perspective -- the number to set beside the
    NetModel prediction)."""
    per: dict = defaultdict(lambda: defaultdict(float))
    for ev in doc["traceEvents"]:
        if ev["ph"] == "X" and ev.get("cat") == "wire.round":
            if pid is not None and ev["pid"] != pid:
                continue
            phase = ev.get("args", {}).get("phase", "?")
            per[ev["pid"]][phase] += ev["dur"] / 1e3
    if pid is not None:
        return dict(per.get(pid, {}))
    return {p: dict(v) for p, v in per.items()}


def metrics_snapshot(doc) -> dict:
    """Aggregate a merged trace document into a metrics dict:

    * ``spans``: per category -- count, total/max ms, duration histogram;
    * ``rounds``: per phase -- round-scope count and wall ms (max over
      processes, since each process times the same global round
      structure);
    * ``sends``: per phase -- message count and bits;
    * ``counters``: per counter name -- last/max value.
    """
    span_durs: dict = defaultdict(list)
    rounds: dict = defaultdict(lambda: {"count": 0, "wall_ms": 0.0})
    sends: dict = defaultdict(lambda: {"count": 0, "bits": 0})
    counters: dict = {}
    round_pid: dict = defaultdict(lambda: defaultdict(float))

    for ev in doc["traceEvents"]:
        args = ev.get("args", {})
        if ev["ph"] == "X":
            span_durs[ev.get("cat") or "misc"].append(ev["dur"])
            if ev.get("cat") == "wire.round":
                phase = args.get("phase", "?")
                round_pid[phase][ev["pid"]] += ev["dur"] / 1e3
                rounds[phase]["count"] = max(
                    rounds[phase]["count"],
                    args.get("index", 0) + 1)
        elif ev["ph"] == "i" and ev.get("cat") == "wire.send":
            cell = sends[args.get("phase", "?")]
            cell["count"] += 1
            cell["bits"] += args.get("bits", 0)
        elif ev["ph"] == "C":
            cell = counters.setdefault(
                ev["name"], {"last": 0, "max": 0})
            val = args.get("value", 0)
            cell["last"] = val
            cell["max"] = max(cell["max"], val)

    for phase, per_pid in round_pid.items():
        rounds[phase]["wall_ms"] = max(per_pid.values())

    spans = {}
    for cat, durs in sorted(span_durs.items()):
        spans[cat] = {"count": len(durs),
                      "total_ms": sum(durs) / 1e3,
                      "max_ms": max(durs) / 1e3,
                      "hist": _histogram(durs)}
    return {"spans": spans, "rounds": {k: dict(v) for k, v in rounds.items()},
            "sends": {k: dict(v) for k, v in sends.items()},
            "counters": counters}
