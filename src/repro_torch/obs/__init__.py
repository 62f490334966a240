"""The observability surface the runtime imports (``repro/obs``): the
null tracer, protocol-call counting, and the process metrics registry
(``registry.py``).  The recording tracer, trace merge, exporter and health
modules come with the port's observability slice."""
from __future__ import annotations

import functools

from .registry import (Counter, MetricsRegistry, get_registry,
                       install_registry)

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


__all__ = [
    "Counter", "MetricsRegistry", "NULL_TRACER",
    "NullTracer", "RECV_SPAN_MIN_S", "get_registry", "get_tracer",
    "install_registry", "traced_protocol",
]
