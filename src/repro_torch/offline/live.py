"""Live prep streaming: a dealer daemon feeding a RUNNING party cluster
(``repro/offline/live.py``).

  * ``LivePrepBank`` -- the daemon-side bank: the party daemon's control
    thread appends freshly streamed sessions while tasks consume them.
    Appends are watermarked (sessions arrive strictly in order), bounded
    (an append blocks while ``sessions_left >= ahead``, the look-ahead of
    ``offline/continuous.py``, so a stalled consumer backpressures the
    dealer), and a dealer failure poisons the bank, so a waiting task
    fails with the dealer's traceback rather than a generic timeout.

  * ``DealerDaemon`` -- the parent's handle on the dealer process: it
    wraps a ``ContinuousDealer`` (session k dealt from ``base_seed + k``,
    the step-indexed seed the online step k uses) on the cluster's device
    and ships each dealt session to every party daemon over the cluster's
    per-rank control queues.  The control channel is a multiprocessing
    queue, NOT the TCP mesh: the mesh still carries zero offline bits, and
    the daemons' transports still forbid offline sends during
    ``prep="bank"`` tasks.

Every daemon runs the replicated program (runtime/net/socket_transport.py)
and so needs the session's full four-record store.  A store dealt on the
card holds tensors on the dealer's card and a ``ready`` event; none of
that crosses the queue.  The dealer waits on ``ready``, moves the words to
host arrays in one batched copy per dtype (``PrepStore.to_arrays``) and
pickles them once (``store_to_blob``); each daemon rebuilds CPU tensors
(``store_from_blob``) and ``OnlinePrep(store, device)`` puts them on its
device as the task pops them.

A watcher thread in the parent monitors the dealer process: if it dies
without posting its own error (hard kill, out of memory), the watcher
poisons the party daemons' banks itself, so a blocked training step still
fails naming the dealer's death.

Observability follows the cluster's ``trace`` and ``metrics``
settings: the dealer process traces each session's ``session.deal`` and
``session.ship`` spans and sends its drained chunk to the parent after
every session (``trace_chunks``), so a killed dealer still leaves its
dealt sessions on the merged timeline.  Its registry counts sessions
dealt and shipped and keeps the watermark and ``trident_dealer_done``;
with ``metrics`` an HTTP exporter serves it, its port published before
the first session (``metrics_port``).  A dealer that finished its quota
keeps serving its exporter until it is closed, so a health document taken
at the end of a stream reads its final watermark and ``done``.
"""
from __future__ import annotations

import logging
import multiprocessing as mp
import pickle
import queue as _queue
import threading
import time
import traceback

from ..obs import (MetricsRegistry, Tracer, get_tracer, install_registry,
                   install_tracer)
from .store import PrepBank, PrepError, PrepMissingError, PrepStore

DEFAULT_AHEAD = 2

# a wait_for block longer than this is a watermark stall worth logging
# (the consumer outran the dealer)
STALL_LOG_S = 0.25

_log = logging.getLogger(__name__)


def store_to_blob(store: PrepStore) -> bytes:
    """A dealt store as bytes for another process (host arrays only)."""
    return pickle.dumps(store.to_arrays(), pickle.HIGHEST_PROTOCOL)


def store_from_blob(blob: bytes) -> PrepStore:
    """``store_to_blob``'s store, as CPU tensors.  Only blobs this
    program's dealer wrote are unpickled."""
    return PrepStore.from_arrays(pickle.loads(blob))


class LivePrepBank(PrepBank):
    """A PrepBank a daemon's control thread APPENDS into while tasks
    consume.  All mutation goes through one condition variable: ``append``
    (control thread) blocks while the unconsumed window is full,
    ``wait_for`` (task thread) blocks until the dealer's watermark passes
    the wanted session, moving the cursor up to it as the sessions before
    it arrive, and ``fail`` wakes every waiter with the dealer's
    traceback."""

    live = True

    def __init__(self, ahead: int = DEFAULT_AHEAD):
        super().__init__()
        if ahead < 1:
            raise ValueError(f"ahead {ahead} < 1")
        self._ahead = ahead
        self._cond = threading.Condition()
        self._failure: str | None = None
        self._finished: int | None = None   # the dealer's clean total

    # -- control-thread side ----------------------------------------------
    @property
    def watermark(self) -> int:
        """Sessions streamed so far (the next session to arrive)."""
        with self._cond:
            return len(self._stores)

    def append(self, session: int, store: PrepStore) -> None:
        """Add the streamed `session` (strictly in order); blocks while
        ``sessions_left >= ahead``."""
        with self._cond:
            if session != len(self._stores):
                raise PrepError(
                    f"live prep stream out of order: got session {session} "
                    f"at watermark {len(self._stores)}")
            while self.sessions_left >= self._ahead \
                    and self._failure is None:
                self._cond.wait(timeout=0.2)
            self._stores.append(store)
            self._cond.notify_all()

    def fail(self, tb: str) -> None:
        """Poison the bank with the dealer's traceback: every current and
        future waiter raises it instead of timing out."""
        with self._cond:
            self._failure = tb
            self._cond.notify_all()

    def finish(self, sessions: int) -> None:
        """The dealer completed cleanly after `sessions` sessions."""
        with self._cond:
            self._finished = sessions
            self._cond.notify_all()

    # -- task-thread side ---------------------------------------------------
    @property
    def next_session(self) -> int:
        with self._cond:
            return self._next

    def _raise_failure(self, session: int) -> None:
        raise PrepError(
            f"live prep session {session} will never arrive -- the "
            f"dealer daemon failed (watermark at {len(self._stores)}):\n"
            f"{self._failure}")

    def wait_for(self, session: int, timeout: float | None = 60.0) -> None:
        """Block until `session` has been streamed into the bank; a block
        longer than ``STALL_LOG_S`` (the consumer outran the dealer) is
        logged and traced as a ``prep.stall`` span."""
        t0 = time.perf_counter()
        try:
            self._wait_for(session, timeout)
        finally:
            stalled = time.perf_counter() - t0
            if stalled >= STALL_LOG_S:
                _log.warning(
                    "live prep watermark stall: waited %.3fs for session "
                    "%d (watermark %d) -- the dealer is behind the "
                    "consumer", stalled, session, len(self._stores))
                tracer = get_tracer()
                if tracer.enabled:
                    tracer.raw_span("prep.stall", "prep", t0, stalled,
                                    session=session,
                                    watermark=len(self._stores))

    def _wait_for(self, session: int, timeout: float | None) -> None:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while True:
                # the sessions below the wanted one can never be used here
                # (a pool member skips those its peers use): free them as
                # they arrive, or they fill the bounded window the wanted
                # one must come through.  A replay (session < cursor) is
                # left to seek, which raises it.
                reached = min(session, len(self._stores))
                if reached > self._next:
                    PrepBank.seek(self, reached)
                    self._cond.notify_all()
                if len(self._stores) > session:
                    return
                if self._failure is not None:
                    self._raise_failure(session)
                if self._finished is not None \
                        and session >= self._finished:
                    raise PrepMissingError(
                        f"live dealer finished after {self._finished} "
                        f"session(s); session {session} will never arrive")
                budget = None if deadline is None \
                    else deadline - time.monotonic()
                if budget is not None and budget <= 0:
                    raise PrepError(
                        f"timed out after {timeout}s waiting for live prep "
                        f"session {session} (dealer watermark at "
                        f"{len(self._stores)})")
                self._cond.wait(timeout=0.2 if budget is None
                                else min(budget, 0.2))

    def seek(self, session: int) -> None:
        with self._cond:
            if session > len(self._stores):
                if self._failure is not None:
                    self._raise_failure(session)
                raise PrepMissingError(
                    f"prep session {session} not dealt yet "
                    f"(dealer watermark at {len(self._stores)})")
            super().seek(session)
            self._cond.notify_all()     # freed skipped sessions: more room

    def next(self) -> PrepStore:
        with self._cond:
            if self._next >= len(self._stores) and self._failure is not None:
                self._raise_failure(self._next)
            store = super().next()
            self._cond.notify_all()     # consumed one: wake a full append
            return store


# ---------------------------------------------------------------------------
# The dealer daemon process.
# ---------------------------------------------------------------------------
def _ship(q, i: int, item, dropped) -> None:
    """Put `item` on consumer `i`'s control queue, blocking while the queue
    is full, unless the consumer is (or becomes) dropped."""
    while not dropped[i]:
        try:
            q.put(item, timeout=0.25)
            return
        except _queue.Full:
            pass


def _dealer_daemon_main(cfg, ctrl_qs, status_q, dropped):
    """Deal sessions continuously and stream them to the party daemons'
    control queues, skipping the consumers flagged in `dropped`.  Runs in
    its own spawned process, so ``cfg["program_for_step"]`` must be
    picklable (a module-level callable or a functools.partial of one)."""
    exporter = None
    try:
        if cfg["trace"]:
            install_tracer(Tracer("dealer"))
        tracer = get_tracer()
        # the registry is always on; with metrics its exporter's port goes
        # out BEFORE any session is dealt, so a dealer still warming up can
        # be scraped
        reg = MetricsRegistry("dealer")
        install_registry(reg)
        if cfg["metrics"]:
            from ..obs.exporter import MetricsExporter
            exporter = MetricsExporter(reg)
            status_q.put(("metrics_port", exporter.port))
        c_dealt = reg.counter("trident_dealer_sessions_dealt_total",
                              "sessions fully dealt by the dealer runtime")
        c_shipped = reg.counter(
            "trident_dealer_sessions_shipped_total",
            "sessions fanned out to every consuming party daemon")
        g_mark = reg.gauge("trident_dealer_watermark",
                           "next session the dealer will ship")
        g_done = reg.gauge("trident_dealer_done",
                           "1 once the dealer finished its quota cleanly")

        from ..runtime.net.cluster import boot_device
        device = boot_device(cfg["device"])

        from .continuous import ContinuousDealer

        with ContinuousDealer(cfg["program_for_step"], ring=cfg["ring"],
                              base_seed=cfg["base_seed"],
                              ahead=DEFAULT_AHEAD, total=cfg["total"],
                              device=device) as dealer:
            session = 0
            while cfg["total"] is None or session < cfg["total"]:
                t0 = time.perf_counter()
                store = dealer.next_store(timeout=None)
                t1 = time.perf_counter()
                c_dealt.inc()
                # every daemon simulates all four parties, so each gets the
                # full store: serialized once, the blob fanned out
                blob = store_to_blob(store)
                del store               # its device words are on the host
                for i, q in enumerate(ctrl_qs):
                    # bounded queue: a full window blocks the dealer here
                    _ship(q, i, ("prep", session, blob), dropped)
                status_q.put(("dealt", session, len(blob)))
                c_shipped.inc()
                g_mark.set(session + 1)
                if tracer.enabled:
                    now = time.perf_counter()
                    tracer.raw_span("session.deal", "prep", t0, t1 - t0,
                                    session=session)
                    tracer.raw_span("session.ship", "prep", t1, now - t1,
                                    session=session, bytes=len(blob))
                    status_q.put(("trace", tracer.drain()))
                session += 1
        g_done.set(1)
        status_q.put(("done", session))
        for i, q in enumerate(ctrl_qs):
            _ship(q, i, ("dealer_done", session), dropped)
        if exporter is not None:
            # the finished dealer stays scrapeable until close() ends it
            threading.Event().wait()
    except Exception:
        tb = traceback.format_exc()
        # best-effort delivery: OSError/ValueError mean the parent already
        # tore the queue down, Full that a consumer stalled; the watcher's
        # hard-death path covers anything undelivered
        try:
            status_q.put(("error", tb))
        except (OSError, ValueError):
            pass
        for i, q in enumerate(ctrl_qs):
            if dropped[i]:
                continue
            try:
                q.put(("dealer_error", tb), timeout=5.0)
            except (_queue.Full, OSError, ValueError):
                pass
    finally:
        if exporter is not None:
            exporter.close()


class DealerDaemon:
    """The parent's handle on the dealer process feeding a live cluster.

    ``cluster`` must have been built with ``live_prep=True``.
    ``program_for_step`` is the ``ContinuousDealer`` contract: a picklable
    ``step -> program`` callable; session k is dealt from ``base_seed +
    k``, so session k IS step k's preprocessing.  ``total=None`` streams
    until closed.  The dealer process runs on the cluster's device and
    ring.

    The lead.  The dealer ships session k once every consuming daemon can
    take it: a daemon whose next session is c holds c and c + 1 in its
    bank (``cluster.DEFAULT_LIVE_AHEAD``), c + 2 in its control thread's
    hand (an append blocked on the full bank) and c + 3 to c + 6 on its
    control queue (``cluster.CTRL_DEPTH``), so ``dealt`` runs at most
    ``cluster.LIVE_LEAD`` = 7 sessions past the slowest consumer's
    cursor; inside the dealer process ``ContinuousDealer`` deals
    ``DEFAULT_AHEAD`` more ahead of what it ships.  For the paper's
    784-128-128-10 NN at batch 128 a training step's session is
    117,211,465 bytes of host arrays and a served batch's 53,802,662
    (``chip_smoke.py`` phases cluster and gateway, on an H100 80GB HBM3 at
    700 W), so a full lead holds up to 7 x 117 MB = 0.82 GB of host memory
    a consuming daemon: three sessions in the daemon, four queued in the
    dealer process.

    Multi-consumer fan-out: ``cluster`` may be a SEQUENCE of live clusters
    (a pool).  Every consumer receives the full session stream -- each blob
    serialized once and put on every consuming daemon's control queue --
    and the pool's scheduler assigns each session to exactly ONE member
    (the others skip it: ``LivePrepBank.wait_for`` moves their cursors
    past it), so each session is used once across the pool.  The bounded
    control queues mean a member that stops consuming stalls the dealer
    once the stream is ``cluster.LIVE_LEAD`` sessions past its cursor;
    ``drop`` takes a dead member out of the fan-out.
    """

    def __init__(self, cluster, program_for_step, *, base_seed: int = 0,
                 total: int | None = None):
        clusters = (list(cluster) if isinstance(cluster, (list, tuple))
                    else [cluster])
        if not clusters:
            raise PrepError("DealerDaemon needs at least one live cluster")
        ctrl_qs = []
        for c in clusters:
            qs = getattr(c, "ctrl_queues", None)
            if not qs:
                raise PrepError(
                    "DealerDaemon needs a live cluster: build it with "
                    "PartyCluster(live_prep=True)")
            ctrl_qs.extend(qs)
        self._ctrl_qs = ctrl_qs
        self._clusters = clusters
        # the watcher thread writes these while the parent reads them
        self._slock = threading.Lock()
        self._dealt = 0
        self._done = False
        self._error: str | None = None
        self._closed = False
        # (session, blob bytes, perf_counter when the dealer shipped it)
        self.shipped: list = []
        # the clusters' settings (their flags or the environment), so one
        # flag covers the deployment; chunks arrive once per dealt
        # session, the exporter's port before the first
        self.trace = any(c.trace for c in clusters)
        self.metrics = any(c.metrics for c in clusters)
        self.trace_chunks: list = []
        self.metrics_port: int | None = None
        ctx = mp.get_context("spawn")
        self._status_q = ctx.Queue()
        # one flag a consuming daemon: 1 = dropped, skipped by the dealer
        self._dropped = ctx.RawArray("b", len(ctrl_qs))
        cfg = {
            "program_for_step": program_for_step,
            "ring": clusters[0].ring, "device": clusters[0].device,
            "base_seed": base_seed, "total": total,
            "trace": self.trace, "metrics": self.metrics,
        }
        self._proc = ctx.Process(target=_dealer_daemon_main,
                                 args=(cfg, list(ctrl_qs), self._status_q,
                                       self._dropped),
                                 daemon=True)
        self._proc.start()
        self._watcher = threading.Thread(target=self._watch, daemon=True,
                                         name="dealer-daemon-watch")
        self._watcher.start()

    # -- status -------------------------------------------------------------
    def _on_status(self, item) -> None:
        kind = item[0]
        with self._slock:
            if kind == "dealt":
                self._dealt = item[1] + 1
                self.shipped.append((item[1], item[2], time.perf_counter()))
            elif kind == "done":
                self._done = True
                self._dealt = item[1]
            elif kind == "error":
                self._error = item[1]
            elif kind == "trace":
                self.trace_chunks.append(item[1])
            elif kind == "metrics_port":
                self.metrics_port = item[1]

    def _watch(self) -> None:
        while True:
            try:
                self._on_status(self._status_q.get(timeout=0.2))
            except _queue.Empty:
                if not self._proc.is_alive():
                    break
        while True:                      # final drain after exit
            try:
                self._on_status(self._status_q.get_nowait())
            except _queue.Empty:
                break
        with self._slock:
            if self._closed or self._done:
                return
            if self._error is None:
                # hard death: the process never posted its own error
                self._error = (
                    f"dealer daemon died hard (exitcode "
                    f"{self._proc.exitcode}) after streaming {self._dealt} "
                    "session(s) -- no further live prep will arrive")
            dealt, error = self._dealt, self._error
        _log.error("dealer daemon failed after %d session(s); poisoning "
                   "the party daemons' live banks:\n%s", dealt, error)
        # on a soft failure this repeats the dealer's own poisoning
        # (bank.fail is idempotent); on a hard kill it is the only one
        self._poison_banks(error)

    def _poison_banks(self, msg: str) -> None:
        for rank, q in enumerate(self._ctrl_qs):
            deadline = time.monotonic() + 10.0   # per queue, not shared
            while not self._closed and not self._dropped[rank]:
                try:
                    q.put_nowait(("dealer_error", msg))
                    break
                except _queue.Full:
                    if time.monotonic() >= deadline:
                        _log.warning(
                            "could not poison consumer %d's live bank "
                            "(rank P%d; control queue full for 10 s); a "
                            "step blocked on streamed prep there will "
                            "time out instead of naming the dealer "
                            "failure", rank, rank % 4)
                        break
                    time.sleep(0.05)

    @property
    def dealt(self) -> int:
        """Sessions fully streamed to every consuming daemon."""
        with self._slock:
            return self._dealt

    @property
    def done(self) -> bool:
        """The dealer dealt and shipped its ``total`` sessions."""
        with self._slock:
            return self._done

    @property
    def failed(self) -> str | None:
        """The dealer's traceback (or death notice), if it failed."""
        with self._slock:
            return self._error

    def drop(self, cluster) -> None:
        """Take `cluster` (a pool member that died) out of the fan-out: the
        dealer skips its daemons' control queues from now on, also in a
        put it is blocked in, so a dead consumer never stalls the
        stream."""
        k = next(i for i, c in enumerate(self._clusters) if c is cluster)
        for i in range(4 * k, 4 * k + 4):
            self._dropped[i] = 1

    # -- lifecycle ----------------------------------------------------------
    def kill(self) -> None:
        """Kill the dealer process hard (death mid-stream); the watcher
        then poisons the party daemons' banks."""
        self._proc.kill()
        self._watcher.join(timeout=15.0)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._proc.is_alive():
            self._proc.terminate()
        self._proc.join(timeout=5.0)
        self._watcher.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
