"""The traced run: the benchmark's spans, the profiler's device trace and
its reduction to the numbers the per-layer metrics read.

A span is a ``torch.profiler.record_function`` named ``portbench.<name>``
around a call of the program (a step, a prefill, a decode step, an SGD
update, each ring matmul).  The reduction keeps only plain tuples of the
trace, (kind, name, start_ns, end_ns, correlation, linked correlation),
and from them: the union of the device's busy intervals (kernels, copies
and fills; overlapping ones counted once), per span name the time the
spans took, the device time busy inside them and the device operations
that ran there, and the device time of every operation launched from
inside a ``ring_matmul`` span, attributed by the launch's host time (the
trace links each device operation to the host event that launched it).
The profiler's events are kept in memory and only this summary leaves the
process.
"""
from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict

PREFIX = "portbench."


def union(intervals, lo: int, hi: int) -> list:
    """The sorted, merged intervals of `intervals` clipped to [lo, hi)."""
    out = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def covered(intervals, lo: int, hi: int) -> int:
    return sum(e - s for s, e in union(intervals, lo, hi))


def gaps(merged, lo: int, hi: int) -> list:
    """The idle intervals of [lo, hi) between merged busy intervals."""
    out, t = [], lo
    for s, e in merged:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if t < hi:
        out.append((t, hi))
    return out


class SpanIndex:
    """Spans by name, and the innermost span at a host time."""

    def __init__(self, spans):
        self.spans = sorted(spans, key=lambda x: x[1])
        self.by_name = defaultdict(list)
        for name, s, e in self.spans:
            self.by_name[name].append((s, e))
        self.starts = [s for _, s, _ in self.spans]

    def at(self, t: int):
        """The name of the innermost span open at t (the latest started
        that has not ended), or None."""
        i = bisect.bisect_right(self.starts, t)
        best = None
        for j in range(i - 1, -1, -1):
            name, s, e = self.spans[j]
            if e > t:
                best = name
                break
            if t - s > 600_000_000_000:
                break
        return best

    def index(self, name: str, t: int):
        """The index of the span of `name` open at t, or None (spans of
        one name do not overlap)."""
        ranges = self.by_name.get(name)
        if not ranges:
            return None
        i = bisect.bisect_right(self._starts(name), t) - 1
        return i if i >= 0 and t < ranges[i][1] else None

    def inside(self, name: str, t: int) -> bool:
        return self.index(name, t) is not None

    def _starts(self, name: str) -> list:
        cache = self.__dict__.setdefault("_start_cache", {})
        if name not in cache:
            cache[name] = [s for s, _ in self.by_name[name]]
        return cache[name]


def reduce_events(events, phases=("step", "prefill", "decode")) -> dict:
    """The summary of a traced window from plain event tuples (kind "gpu"
    or "cpu", name, start_ns, end_ns, correlation, linked correlation)."""
    cpu = [e for e in events if e[0] == "cpu"]
    gpu = [e for e in events if e[0] == "gpu"]
    spans = SpanIndex([(e[1][len(PREFIX):], e[2], e[3]) for e in cpu
                       if e[1].startswith(PREFIX)])
    win = spans.by_name.get("window")
    if not win:
        raise ValueError("the trace holds no portbench.window span")
    lo, hi = win[0]
    host_of = {}
    for e in cpu:
        if e[4] > 0:
            host_of.setdefault(e[4], e[2])
    busy = union([(e[2], e[3]) for e in gpu], lo, hi)
    busy_ns = sum(e - s for s, e in busy)

    def launched_at(e):
        for c in (e[5], e[4]):
            if c > 0 and c in host_of:
                return host_of[c]
        return None

    unlinked = 0
    rm = defaultdict(int)              # phase -> ring matmul device ns
    for e in gpu:
        t = launched_at(e)
        if t is None:
            unlinked += 1
            continue
        if spans.inside("ring_matmul", t):
            for p in phases:
                if spans.inside(p, t):
                    rm[p] += e[3] - e[2]
    out = {"window_s": (hi - lo) * 1e-9, "busy_s": busy_ns * 1e-9,
           "device_ops": sum(1 for e in gpu if lo <= e[2] < hi),
           "unlinked_device_ops": unlinked, "phases": {}}
    for p in phases:
        ranges = spans.by_name.get(p, [])
        if not ranges:
            continue
        per_span = defaultdict(list)
        for e in gpu:
            i = spans.index(p, e[2])
            if i is not None:
                per_span[i].append((e[2], e[3]))
        out["phases"][p] = {
            "spans": len(ranges),
            "span_s": sum(f - s for s, f in ranges) * 1e-9,
            "busy_s": sum(covered(iv, *ranges[i])
                          for i, iv in per_span.items()) * 1e-9,
            "device_ops": sum(len(iv) for iv in per_span.values()),
            "ring_matmul_device_s": rm[p] * 1e-9}
    by_op = defaultdict(int)
    for e in gpu:
        if lo <= e[2] < hi:
            by_op[e[1]] += e[3] - e[2]
    idle = defaultdict(int)
    for s, e in gaps(busy, lo, hi):
        idle[spans.at(s) or "outside_spans"] += e - s
    out["breakdown"] = {
        "device_ops": [[n, t * 1e-9] for n, t in
                       sorted(by_op.items(), key=lambda x: -x[1])[:10]],
        "idle_gaps": [[n, t * 1e-9] for n, t in
                      sorted(idle.items(), key=lambda x: -x[1])[:10]]}
    return out


def kineto_tuples(prof) -> list:
    """The profiler's events as plain tuples (see ``reduce_events``)."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.profiler.kineto_results.events():
        kind = "gpu" if e.device_type() == DeviceType.CUDA else "cpu"
        if kind == "gpu" and e.name().startswith(PREFIX):
            continue          # a span's shadow on the device's timeline
        s = e.start_ns()
        out.append((kind, e.name(), s, s + e.duration_ns(),
                    e.correlation_id(), e.linked_correlation_id()))
    return out


@contextlib.contextmanager
def ring_matmul_spans(tracer, phases):
    """Inside the block each call of the program's ``ops.ring_matmul``
    runs in a ``ring_matmul`` span and adds its bound
    (``flops.ring_matmul_bound_s``) to the phase it was called in; yields
    {phase: bound seconds}.  The function is restored on the way out."""
    from repro_torch.kernels import ops

    from portbench import flops
    bound = dict.fromkeys(phases, 0.0)
    orig = ops.ring_matmul

    def ring_matmul(a, b):
        with tracer.span("ring_matmul"):
            out = orig(a, b)
        if tracer.phase in bound:
            bound[tracer.phase] += flops.ring_matmul_bound_s(
                a.shape, b.shape, a.element_size())
        return out

    ops.ring_matmul = ring_matmul
    try:
        yield bound
    finally:
        ops.ring_matmul = orig


class Tracer:
    """Spans for the traced run; every call a no-op when off."""

    def __init__(self, on: bool):
        self.on = on
        self.prof = None
        self.phase = None

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.on:
            yield
            return
        import torch
        with torch.profiler.record_function(PREFIX + name):
            yield

    @contextlib.contextmanager
    def phase_span(self, name: str):
        prev, self.phase = self.phase, name
        try:
            with self.span(name):
                yield
        finally:
            self.phase = prev

    def start(self):
        if self.on:
            import torch
            from torch.profiler import ProfilerActivity, profile
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.__enter__()

    def stop(self) -> dict | None:
        if self.prof is None:
            return None
        self.prof.__exit__(None, None, None)
        summary = reduce_events(kineto_tuples(self.prof))
        self.prof = None
        return summary
