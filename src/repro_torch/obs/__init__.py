"""The observability surface the runtime imports (``repro/obs``): the
null tracer, protocol-call counting, and a process metrics registry of
plain counters.  The recording tracer, exporter and health modules are not
ported yet."""
from __future__ import annotations

import functools
import threading

# a receive that blocks at least this long counts as slow
RECV_SPAN_MIN_S = 1e-3


class NullTracer:
    """The disabled tracer: instrumented code guards each hook with
    ``if tracer.enabled:``, so the off path costs one branch.  (The
    recording tracer comes with a later slice of the port.)"""

    enabled = False

    def wire_send(self, src, dst, tag, bits, phase, rnd) -> None:
        pass


NULL_TRACER = NullTracer()


def get_tracer() -> NullTracer:
    return NULL_TRACER


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
    """Counters keyed by (name, labels)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict = {}

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            c = self._counters.get(key)
            if c is None:
                c = self._counters[key] = Counter(self._lock)
            return c


_process_registry: MetricsRegistry | None = None


def get_registry() -> MetricsRegistry:
    """The process metrics registry, created on first use."""
    global _process_registry
    if _process_registry is None:
        _process_registry = MetricsRegistry()
    return _process_registry


def traced_protocol(name: str):
    """Decorate a runtime protocol entry point ``fn(rt, ...)``: the metrics
    registry counts every call."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(rt, *args, **kwargs):
            get_registry().counter("trident_protocol_calls_total",
                                   "runtime protocol entries",
                                   protocol=name).inc()
            return fn(rt, *args, **kwargs)
        return wrapper
    return deco
