"""The serving gateway: PartyCluster pools behind one dynamic-batching
front end (``repro/serve/gateway.py``).

One ``PartyCluster`` serves one task at a time, and ``submit`` blocks in
collect, so a query stream served cluster by cluster is bounded by one
task's latency.  The ``ServingGateway`` puts a pool behind one intake:

  * **dynamic batching** -- queries arriving within a ``max_wait_ms`` /
    ``max_batch`` window coalesce into ONE share batch a dispatch, padded
    with zero rows of the queries' dtype to exactly ``max_batch`` rows, so
    every dispatch runs the same program shape (in live prep, one dealer
    program for every session);
  * **async dispatch** -- ``PartyCluster.submit_nowait`` + ``collect``, one
    collector thread a member, so member A's collect overlaps member B's
    run and a member queues task k+1 behind task k;
  * **pool scheduling** -- a closed batch goes to the least-loaded ALIVE
    member (fewest submitted-but-uncollected tasks), ties to the member
    with the deepest live bank; a dynamic batch waits while that member
    has ``MAX_INFLIGHT`` tasks in flight (admission control: under load
    the window fills fuller batches instead of queueing singletons);
  * **eviction** -- a cluster member whose task fails, or whose daemons
    die while it is idle, is evicted loudly (a logged warning, ``report()``,
    ``health()``): its queued dynamic batches are re-dispatched to the
    survivors (no query is dropped), its explicit batch futures fail with
    its error, and in a live pool the shared dealer stops shipping to it;
    a pool the gateway booted itself in plain prep boots a replacement in
    the background.  With no member left, futures fail with "gateway pool
    exhausted".  An in-process ``LocalMember`` has no daemons to lose: a
    batch that raises there fails its own future, and the member stays.
    Nothing moves to the CPU or to a plain kernel.

Members are ``PartyCluster``s (``clusters=``, or ``pool`` booted by the
gateway, concurrently, on ``device``: CUDA unless the caller asks for the
CPU) or ``LocalMember``s, which run each batch in this process.
``PartyPredictionServer`` serves through one ``LocalMember`` and
``serve_over_sockets`` through a one-cluster pool, so the serve layer has
one dispatch and accounting implementation (``ServeMeter``, the
``trident_serve_*`` and ``trident_gateway_*`` metrics).  Queries and
predictions cross the daemons' processes as numpy (ring words as
``uint64``/``uint32``), never as tensors.

Live prep (``prep="live"``): the pool's clusters are live
(``live_prep=True``) and ONE ``DealerDaemon`` streams every session to
every member.  Each dynamic dispatch takes the next session of one global
count, at seed ``base_seed + session`` (the seed the dealer dealt it
from); every other member skips it, so each session is used once across
the pool.  The dealer ships a session only once every member's daemons can
take it, at most ``runtime.net.cluster.LIVE_LEAD`` sessions past their
cursor, so a member that is given no sessions holds the dealer back.  The
scheduler keeps every member moving: ties go to the member given a
session least recently, and a member whose last session lies
``LIVE_LEAD - 1 - (pool - 1)`` sessions back takes the next one, waiting
for its capacity if need be.
"""
from __future__ import annotations

import dataclasses
import functools
import logging
import queue as _queue
import threading
import time
from typing import Callable

import numpy as np

from ..obs import get_registry

_log = logging.getLogger(__name__)

DEFAULT_MAX_WAIT_MS = 2.0
# a dynamic batch waits for a member with fewer uncollected tasks than
# this: one running and one queued behind it
MAX_INFLIGHT = 2


def record_serve_metrics(n_queries: int, wall_s: float) -> None:
    """One served batch on the process's metrics registry: the serving
    counters and the batch latency histogram.  Every serving path lands
    here exactly once a batch."""
    reg = get_registry()
    reg.counter("trident_serve_queries_total",
                "queries served").inc(n_queries)
    reg.counter("trident_serve_batches_total", "batches served").inc()
    reg.histogram("trident_serve_batch_latency_us",
                  "per-batch serve wall clock (us)").observe(wall_s * 1e6)


def _pct(sorted_vals: list, q: float) -> float:
    """Nearest-rank percentile of an ascending list (0 when empty)."""
    if not sorted_vals:
        return 0.0
    k = max(0, min(len(sorted_vals) - 1,
                   int(round(q / 100.0 * (len(sorted_vals) - 1)))))
    return sorted_vals[k]


class ServeMeter:
    """Thread-safe serve-layer accounting: batch and query counts,
    per-batch walls, per-query latencies, and the registry increments
    (``record_serve_metrics``)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.queries = 0
        self.batches = 0
        self.batch_sizes: list = []       # real (unpadded) queries a batch
        self.batch_walls: list = []       # collect wall a batch (seconds)
        self.query_lat_s: list = []       # submit -> resolve (seconds)
        self.aborted = False
        self.t_first: float | None = None  # first submit (perf_counter)
        self.t_last: float | None = None   # last resolve

    def mark_submit(self) -> float:
        now = time.perf_counter()
        with self._lock:
            if self.t_first is None:
                self.t_first = now
        return now

    def record_batch(self, n: int, wall_s: float,
                     abort: bool = False) -> None:
        record_serve_metrics(n, wall_s)
        with self._lock:
            self.queries += n
            self.batches += 1
            self.batch_sizes.append(n)
            self.batch_walls.append(wall_s)
            self.aborted = self.aborted or abort
            self.t_last = time.perf_counter()

    def record_query_latency(self, seconds: float) -> None:
        get_registry().histogram(
            "trident_gateway_query_latency_us",
            "per-query submit->resolve latency (us)").observe(seconds * 1e6)
        with self._lock:
            self.query_lat_s.append(seconds)

    def span_s(self) -> float:
        """First submit to last resolve (0 before both)."""
        with self._lock:
            if self.t_first is None or self.t_last is None:
                return 0.0
            return max(self.t_last - self.t_first, 1e-9)

    def summary(self) -> dict:
        span = self.span_s()
        with self._lock:
            lats = sorted(self.query_lat_s)
            nb = max(self.batches, 1)
            return {
                "queries": self.queries,
                "batches": self.batches,
                "aborted": self.aborted,
                "avg_batch_size": sum(self.batch_sizes) / nb,
                "achieved_qps": (self.queries / span) if span else 0.0,
                "p50_ms": _pct(lats, 50) * 1e3,
                "p95_ms": _pct(lats, 95) * 1e3,
                "p99_ms": _pct(lats, 99) * 1e3,
            }


class QueryFuture:
    """Resolves to this query's prediction row (``ServingGateway.submit``)
    or to a ``BatchResult`` (``submit_batch``)."""

    def __init__(self, qid: int | None = None):
        self.qid = qid
        self._ev = threading.Event()
        self._value = None
        self._exc: BaseException | None = None

    def done(self) -> bool:
        return self._ev.is_set()

    def _resolve(self, value) -> None:
        self._value = value
        self._ev.set()

    def _fail(self, exc: BaseException) -> None:
        self._exc = exc
        self._ev.set()

    def result(self, timeout: float | None = None):
        if not self._ev.wait(timeout):
            raise TimeoutError(
                f"query {self.qid} not resolved within {timeout}s")
        if self._exc is not None:
            raise self._exc
        return self._value


@dataclasses.dataclass
class BatchResult:
    """What an explicit ``submit_batch`` future resolves to."""

    preds: object               # numpy (cluster) or the member's rows (local)
    results: list | None        # the four PartyResults (cluster members)
    abort: bool
    wall_s: float


@dataclasses.dataclass
class _Dispatch:
    """One batch en route through a pool member."""

    X: np.ndarray
    n: int                       # real (unpadded) queries
    seed: int
    prep: str | None
    session: int | None
    timeout: float | None
    entries: list | None         # [(future, x, t_enq)] dynamic batches
    future: QueryFuture | None   # explicit submit_batch
    handle: object = None        # the member backend's dispatch handle


def _predict_batch(rt, _rank, predict_fn=None, X=None):
    """Party-daemon task: one batch through predict_fn on this runtime
    (module-level: the daemons are spawned, so it travels by name; the
    result crosses back as numpy)."""
    return predict_fn(rt, X)


def _zero_predict_program(predict_fn, X0, rt):
    """Module-level deal twin of ``_predict_batch`` (shapes only)."""
    predict_fn(rt, X0)


def _gw_program_for_step(_step, *, predict_fn, X0):
    """Picklable ``step -> deal program`` for the shared live dealer:
    every dynamic batch is padded to one shape, so every session deals the
    same (data-independent) program."""
    return functools.partial(_zero_predict_program, predict_fn, X0)


class _ClusterMember:
    """Pool-member backend over a ``PartyCluster`` (async dispatch)."""

    local = False

    def __init__(self, cluster, predict_fn):
        self.cluster = cluster
        self.predict_fn = predict_fn
        self.dealer = None          # the shared live dealer, once started
        self.last_session = -1      # the last live session dispatched here

    @property
    def load(self) -> int:
        return self.cluster.inflight

    @property
    def bank_depth(self) -> int:
        """Sessions the shared dealer has streamed to this member past the
        last one dispatched to it (0 without a dealer): what its banks and
        control queues hold for it once its queued tasks ran, negative
        while those tasks still wait for the dealer.  The member given a
        session least recently has the deepest bank."""
        if self.dealer is None:
            return 0
        return self.dealer.dealt - (self.last_session + 1)

    def dispatch(self, d: _Dispatch):
        handle = self.cluster.submit_nowait(
            functools.partial(_predict_batch, predict_fn=self.predict_fn,
                              X=d.X),
            seed=d.seed, prep=d.prep, prep_session=d.session,
            timeout=d.timeout)
        if d.session is not None:
            self.last_session = d.session
        return handle

    def finish(self, handle):
        results = self.cluster.collect(handle)
        ref = results[0]
        for r in results[1:]:
            if r.totals != ref.totals or r.per_link != ref.per_link:
                raise RuntimeError(
                    "party processes disagree on measured traffic")
        preds = np.asarray(results[1].result)
        return preds, results, any(r.abort for r in results)

    def down(self) -> str | None:
        """Why the cluster can serve no more (poisoned, or daemons dead),
        or None."""
        if self.cluster.poisoned is not None:
            return f"poisoned: {self.cluster.poisoned}"
        dead = [r for r, up in self.cluster.alive().items() if not up]
        return f"party daemon(s) {dead} died" if dead else None

    def health(self) -> dict:
        return self.cluster.health()

    def close(self) -> None:
        self.cluster.close()


class LocalMember:
    """The in-process pool member: ``run_batch(X, n)`` runs each dispatched
    batch in the member's collector thread (so two LocalMembers still
    overlap) and its rows pass as they are; a batch that raises fails its
    own future and the member serves the next.  ``PartyPredictionServer``
    serves through one."""

    local = True
    bank_depth = 0

    def __init__(self, run_batch: Callable):
        self._run = run_batch
        self._inflight = 0
        self._lock = threading.Lock()

    @property
    def load(self) -> int:
        with self._lock:
            return self._inflight

    def dispatch(self, d: _Dispatch):
        with self._lock:
            self._inflight += 1
        return d

    def finish(self, d: _Dispatch):
        try:
            preds = self._run(d.X, d.n)
        finally:
            with self._lock:
                self._inflight -= 1
        return preds, None, False

    def down(self) -> str | None:
        return None

    def health(self) -> dict:
        return {"healthy": True, "local": True}

    def close(self) -> None:
        pass


@dataclasses.dataclass
class _Member:
    """Gateway-side record of one pool member."""

    idx: int
    backend: object
    q: object                    # _queue.Queue of _Dispatch (FIFO collect)
    thread: threading.Thread | None = None
    owned: bool = True           # the gateway booted it (and closes it)
    alive: bool = True
    tasks_done: int = 0
    busy_s: float = 0.0
    results_log: list = dataclasses.field(default_factory=list)
    dispatch_log: list = dataclasses.field(default_factory=list)


class _Flush:
    """Batcher-queue marker: close the pending partial batch now."""


class ServingGateway:
    """A pool of party clusters behind one dynamic-batching front end.

    ``predict_fn(rt, X_batch)`` is the ``serve_over_sockets`` contract (a
    module-level picklable callable returning the batch's opened rows).
    Queries enter by ``submit(x)`` (a ``QueryFuture`` of the row) from any
    number of threads; pre-formed batches by ``submit_batch`` (a future of
    a ``BatchResult``), which skips the window and admission control.

    The pool: ``clusters=[...]`` adopts existing ``PartyCluster``s,
    ``members=[...]`` takes other backends (``LocalMember``); otherwise the
    gateway boots ``pool`` clusters on `device` concurrently (``metrics``
    starts their exporters).  Adopted members stay up at ``close()``.
    ``max_wait_ms=None`` turns the timer off: batches close only when full
    or on ``flush()``.  Dynamic batch k's seed is ``base_seed + k`` (live:
    ``base_seed + session``).  ``keep_results`` logs every dispatch (its
    member, seed, session, query ids and padded batch) and every member's
    ``PartyResult``s.
    """

    def __init__(self, predict_fn: Callable | None = None, *,
                 pool: int = 2, max_batch: int = 8,
                 max_wait_ms: float | None = DEFAULT_MAX_WAIT_MS,
                 base_seed: int = 0, timeout: float = 120.0,
                 prep: str | None = None, device=None,
                 metrics: bool = False, keep_results: bool = False,
                 clusters=None, members=None):
        if prep not in (None, "live"):
            raise ValueError(f"unknown prep mode {prep!r}")
        self.predict_fn = predict_fn
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self.base_seed = base_seed
        self.timeout = timeout
        self.prep = prep
        self.keep_results = keep_results
        self.meter = ServeMeter()
        self.evictions: list = []
        self.dealer = None
        self._cluster_kwargs = dict(timeout=timeout, device=device,
                                    live_prep=(prep == "live"),
                                    metrics=metrics)
        # a replacement joins only a plain pool the gateway booted itself:
        # a live member's sessions cannot be dealt again, and adopted
        # members are the caller's
        self._replace = prep is None and clusters is None and members is None
        self._live_limit = None
        if prep == "live":
            from ..runtime.net.cluster import LIVE_LEAD
            # a session short of the lead: one of slack
            self._live_limit = LIVE_LEAD - 1
        self._lock = threading.RLock()
        self._members: list[_Member] = []
        self._next_member = 0
        self._qid = 0
        self._dispatch_ctr = 0          # plain-mode seeds
        self._session_ctr = 0           # live-mode global sessions
        self._outstanding = 0
        self._done_cond = threading.Condition(self._lock)
        self._closed = False
        self._in_q: _queue.Queue = _queue.Queue()
        self._reg = get_registry()
        self._g_pool = self._reg.gauge(
            "trident_gateway_pool_size", "alive pool members")
        self._g_depth = self._reg.gauge(
            "trident_gateway_queue_depth",
            "queries waiting in the batching window")
        if members is not None:
            for be in members:
                self._add_member(be, owned=False)
        elif clusters is not None:
            for c in clusters:
                if prep == "live" and not c.live_prep:
                    raise ValueError("prep='live' needs clusters built "
                                     "with PartyCluster(live_prep=True)")
                self._add_member(_ClusterMember(c, predict_fn), owned=False)
        else:
            self._boot_pool(pool)
        self._batcher = threading.Thread(target=self._batch_loop,
                                         daemon=True, name="gw-batcher")
        self._batcher.start()

    # -- pool construction --------------------------------------------------
    def _boot_pool(self, pool: int) -> None:
        from ..runtime.net.cluster import PartyCluster

        slots: list = [None] * pool
        errs: list = [None] * pool

        def boot(i):
            try:
                slots[i] = PartyCluster(**self._cluster_kwargs)
            except BaseException as e:       # noqa: BLE001 -- re-raised
                errs[i] = e

        threads = [threading.Thread(target=boot, args=(i,), daemon=True,
                                    name=f"gw-boot-{i}")
                   for i in range(pool)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if any(e is not None for e in errs):
            for c in slots:
                if c is not None:
                    c.close()
            raise next(e for e in errs if e is not None)
        for c in slots:
            self._add_member(_ClusterMember(c, self.predict_fn))

    def _add_member(self, backend, owned: bool = True) -> _Member:
        with self._lock:
            m = _Member(idx=self._next_member, backend=backend,
                        q=_queue.Queue(), owned=owned)
            self._next_member += 1
            m.thread = threading.Thread(target=self._collect_loop,
                                        args=(m,), daemon=True,
                                        name=f"gw-collect-{m.idx}")
            self._members.append(m)
            self._g_pool.set(sum(1 for x in self._members if x.alive))
        m.thread.start()
        return m

    @property
    def pool_size(self) -> int:
        with self._lock:
            return sum(1 for m in self._members if m.alive)

    # -- query intake -------------------------------------------------------
    def submit(self, x) -> QueryFuture:
        """Enqueue one query; returns a future of its prediction row.
        Thread-safe; queries coalesce into share batches inside the
        ``max_wait_ms``/``max_batch`` window."""
        if self._closed:
            raise RuntimeError("gateway is closed")
        t_enq = self.meter.mark_submit()
        with self._lock:
            self._qid += 1
            fut = QueryFuture(self._qid)
            self._outstanding += 1
        self._reg.counter("trident_gateway_queries_total",
                          "queries accepted by the gateway").inc()
        self._in_q.put((fut, np.asarray(x), t_enq))
        self._g_depth.set(self._in_q.qsize())
        return fut

    def submit_batch(self, X, *, n: int | None = None,
                     seed: int | None = None, prep: str | None = None,
                     prep_session: int | None = None,
                     timeout: float | None = None) -> QueryFuture:
        """Dispatch one PRE-FORMED batch (no padding, no window); returns a
        future of its ``BatchResult``.  The classic serving paths keep
        their batch composition, seeds and sessions through this."""
        if self._closed:
            raise RuntimeError("gateway is closed")
        X = np.asarray(X)
        self.meter.mark_submit()
        with self._lock:
            self._outstanding += 1
        fut = QueryFuture()
        self._dispatch(_Dispatch(
            X=X, n=n if n is not None else int(X.shape[0]),
            seed=self.base_seed if seed is None else seed, prep=prep,
            session=prep_session, timeout=timeout or self.timeout,
            entries=None, future=fut))
        return fut

    def flush(self) -> None:
        """Close the pending partial batch now (no wait for the window's
        timer or more arrivals)."""
        self._in_q.put(_Flush)

    def drain(self, timeout: float | None = None) -> None:
        """Block until every accepted query and batch has resolved."""
        self.flush()
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._done_cond:
            while self._outstanding > 0:
                budget = None if deadline is None \
                    else deadline - time.monotonic()
                if budget is not None and budget <= 0:
                    raise TimeoutError(
                        f"{self._outstanding} queries still in flight "
                        f"after {timeout}s")
                self._done_cond.wait(timeout=0.1 if budget is None
                                     else min(budget, 0.1))

    def _settled(self, k: int = 1) -> None:
        with self._done_cond:
            self._outstanding -= k
            self._done_cond.notify_all()

    # -- dynamic batching ---------------------------------------------------
    def _batch_loop(self) -> None:
        pending: list = []
        deadline = None
        while True:
            if pending and self.max_wait_ms is not None:
                budget = max(deadline - time.monotonic(), 0.0)
            else:
                budget = None
            try:
                item = self._in_q.get(timeout=budget)
            except _queue.Empty:
                self._close_batch(pending)
                pending, deadline = [], None
                continue
            if item is None:                       # close() sentinel
                self._close_batch(pending)
                return
            if item is _Flush:
                self._close_batch(pending)
                pending, deadline = [], None
                continue
            pending.append(item)
            self._g_depth.set(self._in_q.qsize())
            if len(pending) == 1 and self.max_wait_ms is not None:
                deadline = time.monotonic() + self.max_wait_ms / 1e3
            if len(pending) >= self.max_batch:
                self._close_batch(pending)
                pending, deadline = [], None

    def _close_batch(self, entries: list) -> None:
        if not entries:
            return
        X = np.stack([x for _, x, _ in entries])
        pad = self.max_batch - len(entries)
        if pad > 0:
            # one shape for every dispatch, however full the window was
            X = np.concatenate([X, np.zeros((pad,) + X.shape[1:], X.dtype)])
        self._dispatch(_Dispatch(X=X, n=len(entries), seed=0, prep=None,
                                 session=None, timeout=self.timeout,
                                 entries=list(entries), future=None))

    # -- pool scheduling ----------------------------------------------------
    def _pick_member(self, dynamic: bool):
        """The member for the next dispatch (the caller holds the lock):
        the least loaded, ties to the deepest live bank, then the lowest
        index.  In a live pool the member given a session least recently
        takes a dynamic batch once its last session lies the lead's limit
        (less one a further member) back, or the dealer would stall on
        it."""
        alive = [m for m in self._members if m.alive]
        if not alive:
            return None
        if dynamic and self._live_limit is not None:
            lru = min(alive, key=lambda m: (m.backend.last_session, m.idx))
            behind = self._session_ctr - lru.backend.last_session
            if behind >= self._live_limit - len(alive) + 1:
                return lru
        return min(alive, key=lambda m: (m.backend.load,
                                         -m.backend.bank_depth, m.idx))

    def _dispatch(self, d: _Dispatch) -> None:
        dynamic = d.entries is not None
        while True:
            with self._lock:
                member = self._pick_member(dynamic)
                if member is None:
                    last = (f" (last: {self.evictions[-1]['error']})"
                            if self.evictions else "")
                    self._fail_dispatch(d, RuntimeError(
                        "gateway pool exhausted: every member was "
                        f"evicted{last}"))
                    return
                if (dynamic and member.backend.load >= MAX_INFLIGHT
                        and not self._closed):
                    member = None       # no capacity: backpressure below
                else:
                    if dynamic:
                        # seed and session assigned AT dispatch, so a batch
                        # re-dispatched off an evicted member gets fresh,
                        # never-consumed material
                        if self.prep == "live":
                            d.session = self._session_ctr
                            self._session_ctr += 1
                            d.prep = "bank"
                            d.seed = self.base_seed + d.session
                            if self.dealer is None:
                                self._start_dealer(d.X)
                        else:
                            d.seed = self.base_seed + self._dispatch_ctr
                        self._dispatch_ctr += 1
                    try:
                        d.handle = member.backend.dispatch(d)
                    except BaseException as e:  # noqa: BLE001 -- evicted
                        self._evict(member, e, requeue=[])
                        continue
                    member.q.put(d)
                    self._reg.counter("trident_gateway_dispatches_total",
                                      "batches dispatched to the pool").inc()
                    self._reg.histogram(
                        "trident_gateway_batch_size",
                        "real queries per dispatched batch").observe(d.n)
                    if self.keep_results:
                        member.dispatch_log.append(
                            {"member": member.idx, "seed": d.seed,
                             "session": d.session, "n": d.n,
                             "qids": ([f.qid for f, _, _ in d.entries]
                                      if dynamic else None),
                             "X": np.array(d.X)})
                    return
            # every candidate is at MAX_INFLIGHT: wait (outside the lock)
            # for a collector to drain a task, then pick again; meanwhile
            # the window keeps coalescing arriving queries
            time.sleep(0.001)

    def _start_dealer(self, X_template: np.ndarray) -> None:
        """Start the SHARED dealer on the first live dispatch (its padded
        batch fixes the session program's shape).  The caller holds the
        lock."""
        from ..offline.live import DealerDaemon
        members = [m for m in self._members if m.alive]
        self.dealer = DealerDaemon(
            [m.backend.cluster for m in members],
            functools.partial(_gw_program_for_step,
                              predict_fn=self.predict_fn,
                              X0=np.zeros_like(X_template)),
            base_seed=self.base_seed)
        for m in members:
            m.backend.dealer = self.dealer

    # -- collection ---------------------------------------------------------
    def _collect_loop(self, member: _Member) -> None:
        while True:
            try:
                d = member.q.get(timeout=0.5)
            except _queue.Empty:
                # a member that went down while idle goes now, not when a
                # dispatch meets it: in a live pool a dead consumer would
                # hold the shared dealer back
                why = None if self._closed else member.backend.down()
                if why is not None:
                    self._evict(member, RuntimeError(
                        f"pool member {member.idx} went down while idle: "
                        f"{why}"), requeue=[])
                    return
                continue
            if d is None:
                return
            t0 = time.perf_counter()
            try:
                preds, results, abort = member.backend.finish(d.handle)
            except BaseException as e:     # noqa: BLE001 -- evicted
                if member.backend.local:
                    # an in-process member has no daemons to lose: the
                    # error is this batch's, and the member serves on
                    _log.warning("gateway: a batch on in-process member %d "
                                 "raised %s: %s", member.idx,
                                 type(e).__name__, e)
                    self._fail_dispatch(d, e)
                    continue
                self._evict(member, e, requeue=[d])
                return
            wall = time.perf_counter() - t0
            with self._lock:
                member.tasks_done += 1
                member.busy_s += wall
                if self.keep_results and results is not None:
                    member.results_log.append(results)
            self.meter.record_batch(d.n, wall, abort)
            now = time.perf_counter()
            if d.entries is not None:
                for i, (fut, _, t_enq) in enumerate(d.entries):
                    self.meter.record_query_latency(now - t_enq)
                    fut._resolve(preds[i])
                self._settled(len(d.entries))
            else:
                d.future._resolve(BatchResult(preds=preds, results=results,
                                              abort=abort, wall_s=wall))
                self._settled()

    # -- eviction -----------------------------------------------------------
    def _fail_dispatch(self, d: _Dispatch, exc: BaseException) -> None:
        if d.entries is not None:
            for fut, _, _ in d.entries:
                fut._fail(exc)
            self._settled(len(d.entries))
        else:
            d.future._fail(exc)
            self._settled()

    def _evict(self, member: _Member, exc: BaseException,
               requeue: list) -> None:
        """Take a failed member out of the pool: re-dispatch its queued
        dynamic batches to the survivors, fail its explicit batch futures,
        keep a shared dealer flowing past it, and (a plain pool the
        gateway booted) boot a replacement."""
        with self._lock:
            if not member.alive:
                return
            member.alive = False
            self.evictions.append({
                "member": member.idx,
                "error": f"{type(exc).__name__}: {exc}"[:500],
                "tasks_done": member.tasks_done,
            })
            self._g_pool.set(sum(1 for x in self._members if x.alive))
            self._reg.counter("trident_gateway_evictions_total",
                              "pool members evicted after a failure").inc()
        _log.warning("gateway: evicting pool member %d after %s: %s",
                     member.idx, type(exc).__name__, exc)
        if self.dealer is not None:
            self._drain_ctrl(member.backend.cluster)
        lost = list(requeue)
        while True:
            try:
                item = member.q.get_nowait()
            except _queue.Empty:
                break
            if item is not None:
                lost.append(item)
        for d in lost:
            if d.entries is not None:
                self._dispatch(d)          # re-dispatch: no query dropped
            else:
                self._fail_dispatch(d, exc)
        if member.owned:
            try:
                member.backend.close()
            except Exception as e:
                _log.warning("gateway: closing evicted member %d failed: "
                             "%s", member.idx, e)
        if self._replace and not self._closed:
            threading.Thread(target=self._boot_replacement, daemon=True,
                             name=f"gw-replace-{member.idx}").start()

    def _drain_ctrl(self, cluster) -> None:
        """Keep the SHARED dealer flowing past an evicted member: the
        dealer stops shipping to its daemons (also out of a put it is
        blocked in), and a thread discards what their control queues still
        hold.  The drain never blocks: a queue whose read lock a killed
        daemon took with it reads as empty."""
        self.dealer.drop(cluster)

        def drain():
            while not self._closed:
                idle = True
                for q in cluster.ctrl_queues:
                    # Empty is the idle case; OSError/ValueError mean the
                    # queue is torn down
                    try:
                        q.get_nowait()
                        idle = False
                    except (_queue.Empty, OSError, ValueError):
                        pass
                if idle:
                    time.sleep(0.05)

        threading.Thread(target=drain, daemon=True,
                         name="gw-drain-ctrl").start()

    def _boot_replacement(self) -> None:
        from ..runtime.net.cluster import PartyCluster
        try:
            cluster = PartyCluster(**self._cluster_kwargs)
        except BaseException as e:     # noqa: BLE001 -- logged
            _log.error("gateway: replacement cluster failed to boot: %s", e)
            return
        if self._closed:
            cluster.close()
            return
        m = self._add_member(_ClusterMember(cluster, self.predict_fn))
        _log.warning("gateway: replacement member %d joined the pool", m.idx)

    # -- reporting ----------------------------------------------------------
    def report(self) -> dict:
        """Throughput and latency (``ServeMeter.summary``), per-member
        utilization (collect wall over the stream's span) and the eviction
        count."""
        out = self.meter.summary()
        span = self.meter.span_s()
        with self._lock:
            out["pool_size"] = sum(1 for m in self._members if m.alive)
            out["evictions"] = len(self.evictions)
            out["per_member"] = {
                str(m.idx): {
                    "alive": m.alive,
                    "tasks": m.tasks_done,
                    "busy_s": m.busy_s,
                    "utilization": (m.busy_s / span) if span else 0.0,
                } for m in self._members}
            dealer = self.dealer
        if dealer is not None:
            out["live_sessions_streamed"] = dealer.dealt
        return out

    def health(self) -> dict:
        """Each member's health document (an evicted one marked so), the
        eviction log, and the verdict: healthy iff a member is alive, every
        alive member is healthy and the shared dealer (if any) has not
        failed.  Take it between tasks: the cluster probes are
        age-gated."""
        with self._lock:
            members = list(self._members)
            evictions = list(self.evictions)
            dealer = self.dealer
        pool = {}
        for m in members:
            if not m.alive:
                pool[str(m.idx)] = {"healthy": False, "evicted": True}
                continue
            try:
                pool[str(m.idx)] = m.backend.health()
            except Exception as e:
                pool[str(m.idx)] = {"healthy": False,
                                    "error": f"{type(e).__name__}: {e}"}
        alive = [h for h in pool.values() if not h.get("evicted")]
        failed = dealer.failed if dealer is not None else None
        return {
            "pool": pool,
            "evictions": evictions,
            "dealer_failed": failed,
            "healthy": (bool(alive)
                        and all(h.get("healthy", False) for h in alive)
                        and failed is None),
        }

    # -- lifecycle ----------------------------------------------------------
    def close(self) -> None:
        if self._closed:
            return
        try:
            self.drain(timeout=self.timeout)
        except Exception as e:
            _log.warning("gateway close: drain failed (%s); tearing down "
                         "anyway", e)
        self._closed = True
        self._in_q.put(None)
        self._batcher.join(timeout=5.0)
        with self._lock:
            members = list(self._members)
            dealer = self.dealer
        for m in members:
            m.q.put(None)
        for m in members:
            if m.thread is not None:
                m.thread.join(timeout=5.0)
        if dealer is not None:
            dealer.close()
        for m in members:
            if not m.owned:
                continue
            try:
                m.backend.close()
            except Exception as e:
                _log.warning("gateway close: member %d teardown failed: "
                             "%s", m.idx, e)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
