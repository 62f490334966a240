"""The observability plane, tracing and live metrics (``repro/obs``).

Two halves:

  * **Tracing** (off by default; ``TRIDENT_TRACE=1`` /
    ``PartyCluster(trace=True)``): every instrumented seam records
    span/instant events that merge into one Perfetto-viewable cluster
    timeline (``merge.py``).  On the card, each kernel-backend span also
    carries ``device_ms``, the window of its call on its CUDA stream, read
    from timing events when the trace is drained.
  * **Live metrics** (always on): the same seams update a process-local
    ``MetricsRegistry`` -- counters, gauges, fixed-edge histograms --
    unconditionally; ``TRIDENT_METRICS=1`` / ``PartyCluster(metrics=True)``
    also serves each daemon's registry over a tiny HTTP exporter, and
    ``health.cluster_health`` scrapes all five into one health document.

The metric, span and category names, the chunk and snapshot layouts and
the health document are the JAX package's, so either package's tools
read the other's output.
"""
from .merge import merge_chunks, merged_link_bits, write_chrome_trace
from .metrics import metrics_snapshot, round_wall_ms
from .registry import (
    METRICS_ENV,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
    install_registry,
    metrics_enabled,
    snapshot_link_bits,
    snapshot_total,
    snapshot_updated,
    snapshot_value,
)
from .tracer import (
    NULL_TRACER,
    RECV_SPAN_MIN_S,
    NullTracer,
    Stopwatch,
    TRACE_ENV,
    Tracer,
    get_tracer,
    install_tracer,
    stopwatch,
    timed,
    traced_protocol,
    tracing_enabled,
)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "METRICS_ENV",
    "MetricsRegistry",
    "NULL_TRACER",
    "NullTracer",
    "RECV_SPAN_MIN_S",
    "Stopwatch",
    "TRACE_ENV",
    "Tracer",
    "get_registry",
    "get_tracer",
    "install_registry",
    "install_tracer",
    "merge_chunks",
    "merged_link_bits",
    "metrics_enabled",
    "metrics_snapshot",
    "round_wall_ms",
    "snapshot_link_bits",
    "snapshot_total",
    "snapshot_updated",
    "snapshot_value",
    "stopwatch",
    "timed",
    "traced_protocol",
    "tracing_enabled",
    "write_chrome_trace",
]
