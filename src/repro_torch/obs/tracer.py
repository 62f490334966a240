"""Structured tracing for the party runtime (``repro/obs/tracer.py``).

A ``Tracer`` is a per-process buffer of timestamped events -- spans
(duration work: a protocol, a kernel-backend call, a wire round),
instants (point events: a message send, a modeled round), and counters
(gauges: queue depths).  Tracing is OFF by default: every instrumented
seam holds a reference to the process tracer and guards its recording
with a single ``tracer.enabled`` attribute check, so a disabled run pays
one branch per hook and nothing else -- wire accounting and the words
are untouched by construction (the tracer never feeds values back into
the protocols).

Enablement:

  * ``TRIDENT_TRACE=1`` in the environment -- the process tracer comes up
    enabled at first use; spawned party and dealer daemons inherit the
    environment, so one variable traces the whole 4-process cluster;
  * ``install_tracer(Tracer(...))`` -- explicit, per-process (what
    ``PartyCluster(trace=True)`` does inside each daemon).

Each process buffers its own events against its own ``perf_counter``
clock and remembers the perf->epoch offset taken at tracer creation;
``drain()`` snapshots the buffer into a self-describing **chunk** (label,
rank, epoch, events, per-link traced bits) that crosses a process
boundary as a plain pickle/JSON value.  ``merge.py`` aligns the chunks of
the four party daemons and the dealer into one Chrome trace-event
timeline.  The chunk layout is the JAX package's, so the two packages'
chunks merge and read alike.

A kernel-backend call on the card returns once its launches are queued,
so its host ``dur`` is the enqueue.  ``device_spans`` records spans with
a pair of CUDA timing events recorded on the caller's current stream
around the call; ``drain`` resolves every pending pair after ONE
synchronize and writes ``device_ms`` into the spans' args, so a drained
chunk holds plain numbers only.  ``device_ms`` is the stream's window
from the call's first event to its last: the call's kernels and copies,
and the gaps in which the stream waited for the host to queue the next
one.  It is at least the kernels' device time and, on a host-bound path,
close to the host ``dur``; the kernels alone need the profiler.

The tracer double-books wire traffic on purpose: ``wire_send`` keeps its
own per-(src, dst)-per-phase bit totals, which equal
``MeasuredTransport.per_link()`` exactly -- an end-to-end cross-check
that the trace saw every bit the transport measured.
"""
from __future__ import annotations

import contextlib
import functools
import os
import threading
import time
from collections import defaultdict

TRACE_ENV = "TRIDENT_TRACE"

# recv spans are only recorded when the receive actually blocked this
# long -- every recv as a span would drown the timeline in no-wait noise
RECV_SPAN_MIN_S = 1e-3


def tracing_enabled() -> bool:
    """Is tracing requested via the environment (``TRIDENT_TRACE=1``)?"""
    return os.environ.get(TRACE_ENV, "") == "1"


class NullTracer:
    """The disabled tracer: every hook is a no-op.  Instrumented code
    guards with ``if tracer.enabled:`` so the off path costs one branch."""

    enabled = False
    label = "null"
    rank = None

    def span(self, name, cat="", **args):
        return _NULL_SPAN

    def raw_span(self, name, cat, t0, dur, **args) -> None:
        pass

    def instant(self, name, cat="", **args) -> None:
        pass

    def counter(self, name, value, cat="") -> None:
        pass

    def wire_send(self, src, dst, tag, bits, phase, rnd) -> None:
        pass

    def drain(self):
        return None


_NULL_SPAN = contextlib.nullcontext()
NULL_TRACER = NullTracer()


class Tracer:
    """An enabled per-process trace buffer.

    Events are dicts ``{ph, name, cat, ts, dur?, tid, args?}`` with
    ``ts``/``dur`` in ``perf_counter`` seconds; ``ph`` follows the Chrome
    trace-event phases ("X" span, "i" instant, "C" counter).  Appends are
    lock-protected: a party daemon's control thread (live prep) and task
    thread trace into the same buffer.
    """

    enabled = True

    def __init__(self, label: str | None = None, rank: int | None = None):
        self.label = label or f"proc-{os.getpid()}"
        self.rank = rank
        self._epoch = time.time() - time.perf_counter()
        self._lock = threading.Lock()
        self._events: list[dict] = []
        # (start, end, [args of the spans sharing the pair]): CUDA timing
        # events not yet read, resolved in drain()
        self._pending: list[tuple] = []
        # traced wire bits, (src, dst) -> phase -> bits: the tracer-side
        # twin of MeasuredTransport.link_bits (asserted equal in tests)
        self._link_bits: dict = defaultdict(lambda: defaultdict(int))

    # -- recording ---------------------------------------------------------
    def _append(self, ev: dict) -> None:
        ev["tid"] = threading.get_ident()
        with self._lock:
            self._events.append(ev)

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "", **args):
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            self.raw_span(name, cat, t0, time.perf_counter() - t0, **args)

    def raw_span(self, name: str, cat: str, t0: float, dur: float,
                 **args) -> None:
        """Record an already-timed span (callers that measure their own
        wall clock, e.g. the transport's round scopes)."""
        ev = {"ph": "X", "name": name, "cat": cat, "ts": t0, "dur": dur}
        if args:
            ev["args"] = args
        self._append(ev)

    def device_spans(self, spans, cat: str, t0: float, dur: float,
                     events) -> None:
        """Record one host interval ``[t0, t0 + dur)`` split evenly into
        consecutive spans, ``spans`` being ``(name, args)`` pairs, and the
        CUDA timing events ``(start, end)`` recorded around it (None off
        the card).  Each span's ``device_ms`` is its even share of the
        pair's elapsed time -- the stream's window around the call, not
        kernel time alone -- read in ``drain``."""
        n = len(spans)
        step = dur / n
        tid = threading.get_ident()
        evs = [{"ph": "X", "name": name, "cat": cat, "ts": t0 + k * step,
                "dur": step, "tid": tid, "args": args}
               for k, (name, args) in enumerate(spans)]
        with self._lock:
            self._events.extend(evs)
            if events is not None:
                self._pending.append((*events, [a for _, a in spans]))

    def instant(self, name: str, cat: str = "", **args) -> None:
        ev = {"ph": "i", "name": name, "cat": cat,
              "ts": time.perf_counter()}
        if args:
            ev["args"] = args
        self._append(ev)

    def counter(self, name: str, value, cat: str = "") -> None:
        self._append({"ph": "C", "name": name, "cat": cat,
                      "ts": time.perf_counter(), "args": {"value": value}})

    def wire_send(self, src: int, dst: int, tag: str, bits: int,
                  phase: str, rnd: int) -> None:
        """One measured transport send: accumulate the traced per-link
        bits and drop an instant on the timeline.  Zero-bit sends (hash
        copies) are timeline events but never link-bit cells, mirroring
        ``MeasuredTransport``'s own ``if bits:`` accounting guard."""
        if bits:
            with self._lock:
                self._link_bits[(src, dst)][phase] += bits
        self.instant("send", cat="wire.send", src=src, dst=dst, tag=tag,
                     bits=bits, phase=phase, round=rnd)

    # -- snapshotting ------------------------------------------------------
    def link_bits(self) -> dict:
        """Traced bits so far: {(src, dst): {phase: bits}} -- directly
        comparable to ``MeasuredTransport.per_link()`` (phases absent from
        the trace are simply missing keys)."""
        with self._lock:
            return {link: dict(per) for link, per
                    in sorted(self._link_bits.items())}

    def drain(self) -> dict:
        """Snapshot-and-reset: returns a self-describing trace chunk and
        clears the buffer (per-task deltas in the cluster daemons).  The
        pending CUDA timing events are read first, after one synchronize,
        so the chunk is plain data -- safe to pickle across the result
        queue or dump to JSON."""
        with self._lock:
            events, self._events = self._events, []
            pending, self._pending = self._pending, []
            links = {f"{s}->{d}": dict(per)
                     for (s, d), per in sorted(self._link_bits.items())}
            self._link_bits.clear()
        if pending:
            import torch
            torch.cuda.synchronize()
            for start, end, args in pending:
                ms = start.elapsed_time(end) / len(args)
                for a in args:
                    a["device_ms"] = ms
        return {"label": self.label, "rank": self.rank,
                "epoch": self._epoch, "events": events,
                "link_bits": links}


# ---------------------------------------------------------------------------
# The process tracer.
# ---------------------------------------------------------------------------
_process_tracer: NullTracer | Tracer | None = None


def get_tracer():
    """The process tracer: a ``Tracer`` if ``TRIDENT_TRACE=1`` (or one was
    installed), else the shared ``NULL_TRACER``."""
    global _process_tracer
    if _process_tracer is None:
        _process_tracer = Tracer() if tracing_enabled() else NULL_TRACER
    return _process_tracer


def install_tracer(tracer):
    """Set the process tracer explicitly; returns the previous one (tests
    restore it).  Pass ``NULL_TRACER`` to disable, None to re-read the
    environment at the next ``get_tracer``.  Instrumented objects capture
    the tracer when they are made (``MeasuredTransport.__init__``), so
    install before building them."""
    global _process_tracer
    prev = _process_tracer
    _process_tracer = tracer
    return prev


# ---------------------------------------------------------------------------
# Instrumentation helpers.
# ---------------------------------------------------------------------------
def traced_protocol(name: str):
    """Decorate a runtime protocol entry point (``fn(rt, ...)``): the
    metrics registry counts every call and the CheckLedger verdicts the
    four parties recorded during it; when the runtime's tracer is
    enabled, the call also becomes a ``protocol`` span carrying its prep
    attribution (mode and PrepStore session) and the same check count."""
    from .registry import get_registry

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(rt, *args, **kwargs):
            reg = get_registry()
            reg.counter("trident_protocol_calls_total",
                        "runtime protocol entries", protocol=name).inc()
            checks0 = sum(len(p.ledger.checks) for p in rt.parties)
            tr = rt.tracer
            t0 = time.perf_counter() if tr.enabled else 0.0
            try:
                return fn(rt, *args, **kwargs)
            finally:
                checks = sum(len(p.ledger.checks)
                             for p in rt.parties) - checks0
                if checks:
                    reg.counter("trident_protocol_checks_total",
                                "CheckLedger verdicts recorded").inc(checks)
                if tr.enabled:
                    store = getattr(rt.prep, "store", None)
                    session = getattr(store, "meta", {}).get("session") \
                        if store is not None else None
                    tr.raw_span(name, "protocol", t0,
                                time.perf_counter() - t0,
                                prep=rt.prep.mode,
                                session=session, checks=checks)
        return wrapper
    return deco


@contextlib.contextmanager
def timed(stats, *attrs, span: str | None = None, cat: str = "serve",
          **span_args):
    """Accumulate the elapsed wall-clock into ``stats.<attr>`` for every
    attr named and -- when the process tracer is on -- record the same
    interval as a span."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        for attr in attrs:
            setattr(stats, attr, getattr(stats, attr) + dt)
        tr = get_tracer()
        if tr.enabled and span is not None:
            tr.raw_span(span, cat, t0, dt, **span_args)


class Stopwatch:
    """Tiny context-manager wall clock; ``.s`` is the elapsed seconds."""

    s = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.s = time.perf_counter() - self._t0


def stopwatch() -> Stopwatch:
    return Stopwatch()
