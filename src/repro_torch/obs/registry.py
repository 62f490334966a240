"""Process-local live metrics registry (``repro/obs/registry.py``, the part
the party daemons install).

The registry is always on and holds monotonic counters only.  A seam pays
one cached counter object and one locked add per update; nothing feeds
back into the protocols, so words and wire accounting do not depend on it.

One registry per process (``get_registry`` / ``install_registry``).  A
party daemon installs a labeled registry before it builds its transport,
because instrumented objects capture the registry when they are made
(``MeasuredTransport.__init__``).

``trident_wire_bits_total{src,dst,phase}`` double-books the wire: it equals
``MeasuredTransport.per_link()`` exactly.  Gauges, histograms, update
times, the Prometheus exposition and the HTTP exporter come with the
port's observability slice, together with the exporter and health
documents that read them.
"""
from __future__ import annotations

import os
import threading


class Counter:
    """A monotonic counter."""

    __slots__ = ("_lock", "value")

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self.value = 0

    def inc(self, n=1) -> None:
        with self._lock:
            self.value += n


class MetricsRegistry:
    """A process's counter families, ``name -> {labels -> Counter}``.

    ``counter`` gets or creates a counter; hot paths keep the returned
    object.  All counters share one lock, so a snapshot is one consistent
    reading."""

    def __init__(self, label: str | None = None, rank: int | None = None):
        self.label = label or f"proc-{os.getpid()}"
        self.rank = rank
        self._lock = threading.Lock()
        self._families: dict = {}

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = {"help": help, "samples": {}}
            c = fam["samples"].get(key)
            if c is None:
                c = fam["samples"][key] = Counter(self._lock)
            return c

    def snapshot(self) -> dict:
        """A plain-data, JSON-clean copy of every counter (the JAX
        package's snapshot layout, counters only)."""
        with self._lock:
            metrics = {
                name: {"type": "counter", "help": fam["help"],
                       "samples": [{"labels": dict(key), "value": c.value}
                                   for key, c in sorted(
                                       fam["samples"].items())]}
                for name, fam in sorted(self._families.items())}
            return {"label": self.label, "rank": self.rank,
                    "pid": os.getpid(), "metrics": metrics}


_process_registry: MetricsRegistry | None = None


def get_registry() -> MetricsRegistry:
    """The process metrics registry, created on first use."""
    global _process_registry
    if _process_registry is None:
        _process_registry = MetricsRegistry()
    return _process_registry


def install_registry(registry: MetricsRegistry | None
                     ) -> MetricsRegistry | None:
    """Make `registry` the process registry; returns the previous one.
    Install before building the objects that should count into it."""
    global _process_registry
    prev = _process_registry
    _process_registry = registry
    return prev
