"""Process-local live metrics registry, the always-on half of obs
(``repro/obs/registry.py``).

Where ``tracer.py`` is OFF by default and buffers a timeline, the
metrics registry is ALWAYS ON and holds only running aggregates --
monotonic counters, gauges, and fixed-edge histograms (the same
log-spaced edges ``metrics.py`` uses for trace-span histograms).  An
instrumented seam pays one dict lookup (or, on hot paths, a cached
metric object) plus one lock-protected add per update; nothing feeds
back into the protocols, so wire accounting and bit-identity are
untouched by construction.

Metric name taxonomy (the JAX package's names, so each reads as its
counterpart):

  * ``trident_wire_*``      -- MeasuredTransport: per-link/per-phase bits,
    per-link messages, round scopes, recv wait, slow receives;
  * ``trident_protocol_*``  -- runtime protocol entries + check verdicts;
  * ``trident_kernel_*``    -- kernel-backend launches (kind x backend);
  * ``trident_cluster_*``   -- PartyCluster task lifecycle;
  * ``trident_prep_*`` / ``trident_live_bank_*`` -- prep consumption and
    the live streamed bank;
  * ``trident_dealer_*``    -- DealerDaemon sessions and watermark;
  * ``trident_serve_*``     -- serving-layer queries/batches/latency.

The registry double-books wire traffic on purpose (like the tracer):
``trident_wire_bits_total{src,dst,phase}`` must equal
``MeasuredTransport.per_link()`` EXACTLY -- the consistency contract
the tests and ``chip_smoke.py`` assert in process and across the
socket cluster.

One registry per process (``get_registry()`` / ``install_registry()``,
the same singleton pattern as the tracer); party daemons and the dealer
install labeled registries at startup, and ``exporter.py`` serves a
registry over HTTP when ``TRIDENT_METRICS=1`` (or ``metrics=True`` on
``PartyCluster`` / ``DealerDaemon``) asks for exporters.
"""
from __future__ import annotations

import os
import threading
import time

from .metrics import _HIST_EDGES_US

METRICS_ENV = "TRIDENT_METRICS"


def metrics_enabled() -> bool:
    """Are the HTTP exporters requested via the environment?  (The
    registry itself is always on; this only gates the endpoints.)"""
    return os.environ.get(METRICS_ENV, "") == "1"


class Counter:
    """A monotonic counter.  ``inc`` takes ints or floats (e.g. the recv
    wait total in microseconds); ``updated`` is the wall-clock of the
    last increment -- health probes age-gate on it."""

    __slots__ = ("_lock", "value", "updated")

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self.value = 0
        self.updated = 0.0

    def inc(self, n=1) -> None:
        with self._lock:
            self.value += n
            self.updated = time.time()


class Gauge:
    """A last-value gauge (queue depths, watermarks, in-flight tasks)."""

    __slots__ = ("_lock", "value", "updated")

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self.value = 0
        self.updated = 0.0

    def set(self, v) -> None:
        with self._lock:
            self.value = v
            self.updated = time.time()

    def read(self):
        """Torn-read-safe (value, updated) pair."""
        with self._lock:
            return self.value, self.updated


class Histogram:
    """Fixed-edge histogram with the same strict ``v < edge`` bucket rule
    as ``metrics._histogram`` -- a value landing exactly on an edge goes
    to the NEXT bucket."""

    __slots__ = ("_lock", "edges", "buckets", "sum", "count", "updated")

    def __init__(self, lock: threading.Lock, edges=_HIST_EDGES_US):
        self._lock = lock
        self.edges = tuple(edges)
        self.buckets = [0] * (len(self.edges) + 1)
        self.sum = 0.0
        self.count = 0
        self.updated = 0.0

    def observe(self, v) -> None:
        with self._lock:
            for i, edge in enumerate(self.edges):
                if v < edge:
                    self.buckets[i] += 1
                    break
            else:
                self.buckets[-1] += 1
            self.sum += v
            self.count += 1
            self.updated = time.time()


class MetricsRegistry:
    """A process's metric families: ``name -> {labelset -> metric}``.

    ``counter``/``gauge``/``histogram`` get-or-create and return the
    metric object -- hot paths cache the returned object and skip the
    name lookup thereafter.  All metrics share ONE registry lock, so a
    snapshot is a consistent point-in-time read (no torn gauges) and
    concurrent increments never lose updates.
    """

    def __init__(self, label: str | None = None, rank: int | None = None):
        self.label = label or f"proc-{os.getpid()}"
        self.rank = rank
        self.created = time.time()
        self._lock = threading.Lock()
        # name -> {"type", "help", "samples": {labelkey: metric}}
        self._families: dict = {}

    # -- get-or-create -----------------------------------------------------
    def _metric(self, name: str, mtype: str, help_: str, labels: dict,
                factory):
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = {"type": mtype, "help": help_, "samples": {}}
                self._families[name] = fam
            elif fam["type"] != mtype:
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{fam['type']}, not {mtype}")
            metric = fam["samples"].get(key)
            if metric is None:
                metric = fam["samples"][key] = factory()
            return metric

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._metric(name, "counter", help, labels,
                            lambda: Counter(self._lock))

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._metric(name, "gauge", help, labels,
                            lambda: Gauge(self._lock))

    def histogram(self, name: str, help: str = "",
                  edges=_HIST_EDGES_US, **labels) -> Histogram:
        return self._metric(name, "histogram", help, labels,
                            lambda: Histogram(self._lock, edges))

    # -- reading -----------------------------------------------------------
    def snapshot(self) -> dict:
        """A plain-data, JSON-clean point-in-time copy: ships over the
        cluster result queue and out of the /metrics.json endpoint."""
        with self._lock:
            metrics = {}
            for name, fam in sorted(self._families.items()):
                samples = []
                for key, m in sorted(fam["samples"].items()):
                    s = {"labels": dict(key), "updated": m.updated}
                    if isinstance(m, Histogram):
                        s.update(edges=list(m.edges),
                                 buckets=list(m.buckets),
                                 sum=m.sum, count=m.count)
                    else:
                        s["value"] = m.value
                    samples.append(s)
                metrics[name] = {"type": fam["type"], "help": fam["help"],
                                 "samples": samples}
            return {"label": self.label, "rank": self.rank,
                    "pid": os.getpid(), "created": self.created,
                    "ts": time.time(), "metrics": metrics}

    def total(self, name: str):
        """Sum of a family's sample values (histograms: total count)."""
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                return 0
            return sum(m.count if isinstance(m, Histogram) else m.value
                       for m in fam["samples"].values())

    def link_bits(self) -> dict:
        """The wire counters reshaped to ``MeasuredTransport.per_link()``'s
        ``{(src, dst): {phase: bits}}`` -- only cells that moved bits, the
        exact-equality side of the consistency contract."""
        return snapshot_link_bits(self.snapshot())

    # -- Prometheus text exposition ---------------------------------------
    def render_prometheus(self) -> str:
        snap = self.snapshot()
        lines = []
        for name, fam in snap["metrics"].items():
            if fam["help"]:
                lines.append(f"# HELP {name} {fam['help']}")
            lines.append(f"# TYPE {name} {fam['type']}")
            for s in fam["samples"]:
                if fam["type"] == "histogram":
                    cum = 0
                    for edge, n in zip(s["edges"] + ["+Inf"],
                                       s["buckets"]):
                        cum += n
                        lines.append(
                            f"{name}_bucket"
                            f"{_labels({**s['labels'], 'le': edge})} "
                            f"{cum}")
                    lines.append(
                        f"{name}_sum{_labels(s['labels'])} {s['sum']}")
                    lines.append(
                        f"{name}_count{_labels(s['labels'])} {s['count']}")
                else:
                    lines.append(
                        f"{name}{_labels(s['labels'])} {s['value']}")
        return "\n".join(lines) + "\n"


def _labels(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def snapshot_total(snap: dict, name: str):
    """``MetricsRegistry.total`` over an already-taken snapshot."""
    fam = snap["metrics"].get(name)
    if fam is None:
        return 0
    return sum(s["count"] if fam["type"] == "histogram" else s["value"]
               for s in fam["samples"])


def snapshot_value(snap: dict, name: str, default=0, **labels):
    """One sample's value from a snapshot (exact label match)."""
    fam = snap["metrics"].get(name)
    if fam is None:
        return default
    want = {k: str(v) for k, v in labels.items()}
    for s in fam["samples"]:
        if s["labels"] == want:
            return s.get("value", s.get("count", default))
    return default


def snapshot_updated(snap: dict, name: str, **labels) -> float:
    """Latest ``updated`` wall-clock across a family's samples (optionally
    filtered by a label subset); 0.0 if the family never recorded."""
    fam = snap["metrics"].get(name)
    if fam is None:
        return 0.0
    want = {k: str(v) for k, v in labels.items()}
    ts = [s["updated"] for s in fam["samples"]
          if all(s["labels"].get(k) == v for k, v in want.items())]
    return max(ts, default=0.0)


def snapshot_link_bits(snap: dict) -> dict:
    """Parse ``trident_wire_bits_total`` samples out of a snapshot into
    ``{(src, dst): {phase: bits}}`` (non-zero cells only)."""
    out: dict = {}
    fam = snap["metrics"].get("trident_wire_bits_total")
    for s in (fam["samples"] if fam else ()):
        if not s["value"]:
            continue
        lab = s["labels"]
        link = (int(lab["src"]), int(lab["dst"]))
        out.setdefault(link, {})[lab["phase"]] = s["value"]
    return out


# ---------------------------------------------------------------------------
# The process registry (singleton, mirroring tracer.get_tracer).
# ---------------------------------------------------------------------------
_process_registry: MetricsRegistry | None = None


def get_registry() -> MetricsRegistry:
    """The process metrics registry; lazily created (always on)."""
    global _process_registry
    if _process_registry is None:
        _process_registry = MetricsRegistry()
    return _process_registry


def install_registry(registry: MetricsRegistry | None) -> \
        MetricsRegistry | None:
    """Swap the process registry (labeled daemon registries, fresh ones in
    tests); returns the previous one so callers can restore it.
    NOTE: instrumented objects capture the registry at construction
    (``MeasuredTransport.__init__``), so install BEFORE building them."""
    global _process_registry
    prev = _process_registry
    _process_registry = registry
    return prev
