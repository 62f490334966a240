"""Merge per-process trace chunks into one Chrome trace-event timeline
(``repro/obs/merge.py``).

Each process (four party daemons, the dealer daemon, optionally the
parent) drains its ``Tracer`` into a chunk: perf_counter-stamped events
plus the perf->epoch offset taken when that tracer was built.  The
merger shifts every event onto the shared wall-clock (``ts + epoch``),
normalizes to the earliest event across all chunks, and emits the Chrome
trace-event JSON object format -- one ``pid`` per source process with a
``process_name`` metadata record, so Perfetto / chrome://tracing shows
the cluster as aligned per-party tracks.

Clock caveat: epoch alignment is exact on one host (all processes read
the same CLOCK_REALTIME); across hosts it is only as good as NTP.  Good
enough to eyeball round overlap; don't read microsecond skew as truth.
"""
from __future__ import annotations

import json


def merge_chunks(chunks) -> dict:
    """Fold trace chunks (see ``Tracer.drain``) into a Chrome trace-event
    document: ``{"traceEvents": [...], "metadata": {...}}``.

    Chunks may arrive in any order and any multiplicity per process
    (cluster daemons drain once per task); chunks sharing a label are
    mapped to the same pid.  ``None`` entries are skipped so callers can
    pass results through unfiltered.
    """
    chunks = [c for c in chunks if c]
    events: list[dict] = []
    pids: dict[str, int] = {}
    # earliest absolute timestamp across every chunk anchors t=0
    t_zero = min((c["epoch"] + ev["ts"] for c in chunks
                  for ev in c["events"]), default=0.0)

    for chunk in chunks:
        label = chunk["label"]
        if label not in pids:
            pid = pids[label] = len(pids) + 1
            events.append({"ph": "M", "name": "process_name", "pid": pid,
                           "tid": 0, "args": {"name": label}})
        pid = pids[label]
        epoch = chunk["epoch"]
        for ev in chunk["events"]:
            out = {"ph": ev["ph"], "name": ev["name"],
                   "cat": ev.get("cat") or "misc", "pid": pid,
                   "tid": ev.get("tid", 0),
                   "ts": (epoch + ev["ts"] - t_zero) * 1e6}
            if ev["ph"] == "X":
                out["dur"] = ev["dur"] * 1e6
            if ev["ph"] == "i":
                out["s"] = "t"  # thread-scoped instant
            if "args" in ev:
                out["args"] = ev["args"]
            events.append(out)

    events.sort(key=lambda e: (e.get("ts", 0.0), e["pid"]))
    ranks = sorted({c["rank"] for c in chunks if c.get("rank") is not None})
    return {"traceEvents": events,
            "metadata": {"processes": pids, "ranks": ranks,
                         "chunks": len(chunks)}}


def write_chrome_trace(path, chunks) -> dict:
    """Merge and dump to ``path`` (open in https://ui.perfetto.dev).
    Returns the merged document."""
    doc = merge_chunks(chunks)
    with open(path, "w") as fh:
        json.dump(doc, fh)
    return doc


def merged_link_bits(chunks) -> dict:
    """Per-link traced bytes from ONE process's perspective, keyed
    ``"src->dst"`` -> phase -> bits.  Under the replicated-program model
    every daemon simulates the full mesh, so chunks from different ranks
    each carry the complete per-link picture; this helper takes the
    maximum per cell rather than summing, and callers compare it against
    ``MeasuredTransport.per_link()``."""
    out: dict = {}
    for chunk in chunks:
        if not chunk:
            continue
        for link, per in chunk.get("link_bits", {}).items():
            cell = out.setdefault(link, {})
            for phase, bits in per.items():
                cell[phase] = max(cell.get(phase, 0), bits)
    return out
