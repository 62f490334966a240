"""Long-lived party daemons on one machine, plus the one-shot launcher
(``repro/runtime/net/cluster.py``).

``PartyCluster`` spawns one OS process per party; each builds its
``SocketTransport`` endpoint of the TCP mesh ONCE (optionally wrapped in a
``NetModelTransport``), optionally loads a saved ``PrepBank`` at startup,
and then serves **tasks** -- submitted protocol programs -- until closed.
The mesh, the loaded prep material and the loaded kernel libraries persist
across tasks, so a query stream pays connection set-up once, not per
batch.  Every daemon's runtime lives on the cluster's ``device``: CUDA
unless the caller asks for the CPU (the tests do); a daemon that cannot
reach the card fails its boot and never carries on on the CPU.  On the
card the parent builds the kernels before it spawns, so the daemons only
load the libraries; on the CPU each daemon keeps to one intra-op thread.

``cluster.submit(program)`` runs ``program(rt, rank)`` in every party
process on a fresh ``FourPartyRuntime`` over the persistent transport and
returns the four ``PartyResult``s; measured traffic and modeled time are
**per-task deltas**.  The result crosses back as numpy: ring-word tensors
become the JAX package's ``uint64``/``uint32`` words (``_to_np``).  A task
with ``prep="bank"`` consumes the next PrepBank session and runs
online-only: the daemon's transport *forbids* offline traffic for the span
of the task.

Live prep streaming (``live_prep=True``): each daemon starts with an EMPTY
``offline.live.LivePrepBank`` plus a control thread draining a per-rank
control queue -- a multiprocessing channel beside the TCP mesh.  A
``offline.live.DealerDaemon`` in the parent deals sessions continuously and
ships each one down every control queue, so ``submit(prep="bank",
prep_session=k)`` works for sessions dealt after start-up: a task blocks
until its session arrives (bounded look-ahead backpressures the dealer),
and the mesh still carries zero offline bits.  A dealer failure poisons
the live banks, so a waiting task fails with the dealer's traceback.

``submit`` is ``submit_nowait`` (enqueue one task on every daemon, return
a ``TaskHandle``) plus ``collect`` (gather that task's four results).  The
daemons serve their task queues in order, so several tasks may be in
flight on one cluster.  A failed or timed-out task leaves the lock-step
mesh undefined, so the cluster POISONS itself: the failing ``collect``
raises with the daemons' tracebacks, and every later ``submit`` or
``collect`` raises ``ClusterPoisoned`` at once.

Port allocation probes free ports by binding and releasing them, so another
process can take a port before the daemon binds it: boot fails fast on the
first daemon error and retries the whole mesh with fresh ports on
``EADDRINUSE``, up to ``PORT_RETRIES`` times.  Each boot attempt draws a
random mesh token that every hello carries, so a listener never takes
another cluster's dialer, come to its port, for one of its own parties.

``program`` must be a module-level callable (the processes are spawned, so
it travels by qualified name) and its arguments plain data (numpy arrays,
not tensors).  All four processes run the same program from the same seed,
so their PRF streams, message schedules and measured tallies agree.
Tamper rules are installed identically in every process: the sender's
process corrupts the wire copy, and every process mirrors the corruption
in its local simulation.

Observability.  Every daemon installs a labeled metrics registry before
its transport exists; ``metrics=True`` (or ``TRIDENT_METRICS=1``) also
starts an HTTP exporter in each daemon on a port the OS picks, published
in the daemon's ready ack (``metrics_ports``), and returns each task's
cumulative registry snapshot in ``PartyResult.metrics``.  ``scrape``
reads the four exporters, ``health`` folds them (and an attached dealer's)
into one health document (``obs.health``), ``alive`` and ``inflight``
feed it.  ``trace=True`` (or ``TRIDENT_TRACE=1``) installs a labeled
tracer in each daemon; each task's drained chunk returns in
``PartyResult.trace`` and joins ``trace_chunks``, and ``merged_trace`` /
``save_trace`` give one Chrome trace-event timeline of the four ranks
(plus the dealer's chunks, passed as ``extra_chunks``).
"""
from __future__ import annotations

import dataclasses
import logging
import multiprocessing as mp
import os
import queue as _queue
import socket
import threading
import time
import traceback

import torch

from ...core.context import resolve_device
from ...core.ring import RING64, Ring, words_to_numpy
from ...obs import (MetricsRegistry, Tracer, get_registry, get_tracer,
                    install_registry, install_tracer, metrics_enabled,
                    tracing_enabled)
from .socket_transport import TOKEN_BYTES

DEFAULT_TIMEOUT = 120.0
DEFAULT_LIVE_AHEAD = 2
PORT_RETRIES = 3

_log = logging.getLogger(__name__)


class ClusterPoisoned(RuntimeError):
    """A previous task failed or timed out, leaving the lock-step mesh in
    an undefined state; the cluster refuses further submits.  Tear it down
    and spawn a fresh one."""


@dataclasses.dataclass
class PartyResult:
    """One party process's view of one task."""

    rank: int
    result: object
    totals: dict
    per_link: dict
    abort: bool
    wall_s: float
    modeled_s: dict | None = None     # phase -> seconds (when net_model set)
    frames_sent: dict | None = None   # (src, dst) -> wire frames (this task)
    bytes_sent: dict | None = None    # (src, dst) -> bytes written (this task)
    task_id: int | None = None        # correlates results with submissions
    prep_wait_s: float = 0.0          # blocked on prep material (live banks)
    trace: dict | None = None         # this task's trace chunk (trace=True)
    metrics: dict | None = None       # daemon registry snapshot (metrics=True)


@dataclasses.dataclass
class TaskHandle:
    """A submitted task not yet collected (``submit_nowait``); pass it to
    ``PartyCluster.collect``."""

    task_id: int
    submitted_at: float          # perf_counter at submit (task_walls base)
    timeout: float


def _addr_in_use(text: str) -> bool:
    """Does a collected boot traceback name the bind port race?"""
    return "EADDRINUSE" in text or "Address already in use" in text


def _free_ports(n: int) -> list:
    socks = []
    try:
        for _ in range(n):
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            s.bind(("127.0.0.1", 0))
            socks.append(s)
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _to_np(tree):
    """A task result as plain data: ring-word tensors (int64/int32) become
    uint64/uint32 words, other tensors numpy arrays; dicts, lists and
    tuples are mapped; anything else passes."""
    if isinstance(tree, torch.Tensor):
        if tree.dtype in (torch.int64, torch.int32):
            return words_to_numpy(tree)
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _to_np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_np(v) for v in tree)
    return tree


def _delta(after: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v - before.get(k, 0)}


def _run_task(task, *, ring, device, transport, base, bank, out_q, rank,
              prep_wait: float = DEFAULT_TIMEOUT, metrics: bool = False):
    from ..runtime import FourPartyRuntime

    t_before = base.totals()
    l_before = {k: dict(v) for k, v in base.per_link().items()}
    f_before, b_before = dict(base.frames_sent), dict(base.bytes_sent)
    m_before = dict(transport._sec.total) if transport is not base else None

    tracer = get_tracer()
    reg = get_registry()
    reg.counter("trident_cluster_tasks_total",
                "tasks served by this party daemon").inc()
    g_inflight = reg.gauge("trident_cluster_tasks_inflight",
                           "tasks currently executing (0 or 1)")
    g_inflight.set(1)
    t_task0 = time.perf_counter()
    prep = None
    prep_wait_s = 0.0
    try:
        if task.get("prep") == "bank":
            from ...offline.store import OnlinePrep
            if bank is None:
                raise RuntimeError("task wants prep='bank' but the daemon "
                                   "has no PrepBank (load one at startup "
                                   "with prep_path= or stream one with "
                                   "live_prep=True)")
            session = task.get("prep_session")
            t_prep0 = time.perf_counter()
            if getattr(bank, "live", False):
                # the session may not have arrived yet: block until the
                # dealer's watermark passes it (a dead dealer raises its
                # traceback here instead of timing out)
                bank.wait_for(session if session is not None
                              else bank.next_session, timeout=prep_wait)
            if session is not None:
                # step-indexed consumption: a resumed run skips spent
                # sessions and a retried step raises PrepReplayError
                bank.seek(session)
            store = bank.next()
            prep_wait_s = time.perf_counter() - t_prep0
            reg.counter("trident_prep_sessions_consumed_total",
                        "PrepStore sessions consumed by tasks").inc()
            reg.counter("trident_prep_wait_us_total",
                        "wall-clock blocked acquiring prep material "
                        "(us)").inc(prep_wait_s * 1e6)
            reg.gauge("trident_prep_next_session",
                      "next prep session this daemon will consume").set(
                bank.next_session if getattr(bank, "live", False)
                else bank._next)
            reg.gauge("trident_live_bank_depth",
                      "unconsumed sessions buffered in the prep "
                      "bank").set(bank.sessions_left)
            if tracer.enabled:
                tracer.raw_span("prep.acquire", "prep", t_prep0,
                                prep_wait_s,
                                session=store.meta.get("session"))
            store.party = rank          # attribute store errors to P{rank}
            prep = OnlinePrep(store, device)
            base.forbid_phase("offline")
        try:
            rt = FourPartyRuntime(ring, seed=task["seed"],
                                  transport=transport, prep=prep,
                                  device=device)
            t0 = time.perf_counter()
            # the host copy of the result waits for the device
            result = _to_np(task["program"](rt, rank))
            wall = time.perf_counter() - t0
        finally:
            if prep is not None:
                base.allow_phase("offline")
    finally:
        # live even for a failing task: the gauge drops back and the
        # histogram records the attempt, so a scrape never sees a phantom
        # running task
        g_inflight.set(0)
        reg.histogram("trident_cluster_task_wall_us",
                      "per-task wall clock (us)").observe(
            (time.perf_counter() - t_task0) * 1e6)
    if tracer.enabled:
        tracer.raw_span(f"task#{task['id']}", "cluster.task", t_task0,
                        time.perf_counter() - t_task0, task_id=task["id"],
                        seed=task["seed"], prep=task.get("prep"),
                        session=task.get("prep_session"))

    t_after = base.totals()
    per_link = {}
    for link, bits in base.per_link().items():
        was = l_before.get(link, {p: 0 for p in bits})
        per_link[link] = {p: bits[p] - was[p] for p in bits}
    out_q.put(PartyResult(
        rank=rank,
        result=result,
        totals={p: {k: t_after[p][k] - t_before[p][k] for k in t_after[p]}
                for p in t_after},
        per_link=per_link,
        abort=bool(rt.abort_flag()),
        wall_s=wall,
        modeled_s=({p: transport._sec.total[p] - m_before[p]
                    for p in m_before} if m_before is not None else None),
        frames_sent=_delta(base.frames_sent, f_before),
        bytes_sent=_delta(base.bytes_sent, b_before),
        task_id=task["id"],
        prep_wait_s=prep_wait_s,
        # drain() resets the buffer, so each task's chunk stands alone
        trace=tracer.drain() if tracer.enabled else None,
        # the snapshot is cumulative (counters never reset): diff two
        # snapshots, or scrape the exporter, for a task's share
        metrics=reg.snapshot() if metrics else None,
    ))


def _ctrl_loop(ctrl_q, bank, rank):
    """Daemon-side control thread: drain the per-rank control queue into
    the live bank.  An append may block on the bank's bounded look-ahead
    (the backpressure reaching the dealer).  Any failure here poisons the
    bank, so a waiting task raises the cause instead of timing out."""
    from ...offline.live import store_from_blob
    tracer = get_tracer()
    reg = get_registry()
    g_depth = reg.gauge("trident_live_bank_depth",
                        "unconsumed sessions buffered in the prep bank")
    g_mark = reg.gauge("trident_live_bank_watermark",
                       "sessions streamed into the live bank so far")
    try:
        while True:
            # bounded wait, so a dealer killed without its sentinel cannot
            # park this thread for good
            try:
                item = ctrl_q.get(timeout=1.0)
            except _queue.Empty:
                continue
            if item is None:
                return
            kind = item[0]
            if kind == "prep":
                _, session, blob = item
                store = store_from_blob(blob)
                store.party = rank      # attribute store errors to P{rank}
                if tracer.enabled:
                    # the append may block on the bounded look-ahead: the
                    # span is the backpressure wait, the counter the depth
                    with tracer.span("prep.append", "prep",
                                     session=session):
                        bank.append(session, store)
                    tracer.counter("live_bank_depth", len(bank), "prep")
                else:
                    bank.append(session, store)
                g_depth.set(bank.sessions_left)
                g_mark.set(bank.watermark)
            elif kind == "dealer_error":
                bank.fail(item[1])
                return
            elif kind == "dealer_done":
                bank.finish(item[1])
                return
    except BaseException:
        bank.fail(f"P{rank} control thread died:\n"
                  f"{traceback.format_exc()}")
        raise


def boot_device(device: str) -> torch.device:
    """A spawned daemon's device, reached before it serves: on the card a
    context is made and every kernel library loaded (the parent built
    them); on the CPU one intra-op thread.  Raises if the card cannot be
    reached."""
    dev = torch.device(device)
    if dev.type == "cuda":
        from ...kernels import build
        torch.empty(1, device=dev)
        for name in build.SOURCES:
            build.library(name)
    else:
        torch.set_num_threads(1)
    return dev


def prepare_device(device) -> str:
    """The parent's half of ``boot_device``: resolve `device` (CUDA unless
    the caller asks for the CPU) and, on the card, build every kernel
    before any process is spawned.  Returns the name the children get."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        from ...kernels import build
        build.build_all()
    return str(dev)


def _daemon_main(rank, endpoints, cfg, task_q, ctrl_q, out_q):
    exporter = None
    try:
        # the labeled tracer and registry go in BEFORE the transport is
        # made, which captures them (cfg["trace"] holds TRIDENT_TRACE=1 too)
        if cfg["trace"]:
            install_tracer(Tracer(f"party-P{rank}", rank=rank))
        reg = MetricsRegistry(f"party-P{rank}", rank=rank)
        install_registry(reg)
        device = boot_device(cfg["device"])

        from .model import NetModelTransport
        from .socket_transport import SocketTransport

        base = SocketTransport(rank, endpoints, token=cfg["token"],
                               device=device,
                               timeout=cfg["timeout"],
                               connect_timeout=cfg["timeout"])
        for rule in cfg["tampers"]:
            base.tamper(**rule)
        transport = base
        if cfg["net_model"] is not None:
            transport = NetModelTransport(base, cfg["net_model"])
        bank = None
        if cfg["prep_path"] is not None:
            from ...offline.store import PrepBank
            bank = PrepBank.load(cfg["prep_path"])
        elif cfg["live_prep"]:
            from ...offline.live import LivePrepBank
            bank = LivePrepBank(ahead=DEFAULT_LIVE_AHEAD)
            threading.Thread(target=_ctrl_loop, args=(ctrl_q, bank, rank),
                             daemon=True, name=f"ctrl-P{rank}").start()
        metrics_port = None
        if cfg["metrics"]:
            # bound after the mesh formed: port 0 cannot take a port probed
            # for a listener of this mesh that is not bound yet
            from ...obs.exporter import MetricsExporter
            exporter = MetricsExporter(reg)
            metrics_port = exporter.port
        out_q.put(("ready", rank, metrics_port))
        while True:
            task = task_q.get()
            if task is None:
                break
            try:
                # the prep wait expires BEFORE the parent's collect clock
                # (started at submit), so a slow dealer surfaces as the
                # watermark-naming error, not a generic timeout
                budget = task.get("timeout") or cfg["timeout"]
                _run_task(task, ring=cfg["ring"], device=device,
                          transport=transport, base=base, bank=bank,
                          out_q=out_q, rank=rank,
                          prep_wait=max(1.0, 0.75 * budget),
                          metrics=cfg["metrics"])
            except Exception:
                # a failed task leaves the lock-step mesh undefined: report
                # and stop serving (the parent poisons the cluster)
                out_q.put(("error", rank, traceback.format_exc()))
                break
        base.close()
    except Exception:
        out_q.put(("error", rank, traceback.format_exc()))
    finally:
        if exporter is not None:
            exporter.close()


class PartyCluster:
    """Four long-lived party daemons over a persistent TCP mesh, every
    daemon's runtime on `device`."""

    def __init__(self, *, ring: Ring = RING64,
                 timeout: float = DEFAULT_TIMEOUT, tampers=(),
                 net_model=None, prep_path: str | None = None,
                 live_prep: bool = False, device=None,
                 trace: bool = False, metrics: bool = False):
        if live_prep and prep_path is not None:
            raise ValueError(
                "live_prep streams into an initially empty bank; "
                "prep_path loads a frozen one at startup -- pick one")
        self.device = prepare_device(device)
        ctx = mp.get_context("spawn")
        trace = trace or tracing_enabled()
        metrics = metrics or metrics_enabled()
        cfg = {
            "ring": ring, "timeout": timeout, "tampers": list(tampers),
            "net_model": net_model, "prep_path": prep_path,
            "live_prep": live_prep, "device": self.device,
            "trace": trace, "metrics": metrics,
        }
        self.ring = ring
        self.timeout = timeout
        self.net_model = net_model
        self.live_prep = live_prep
        self.trace = trace
        self.metrics = metrics
        # rank -> exporter port (metrics=True; from the ready acks)
        self.metrics_ports: dict = {}
        # every task's trace chunks, four a task (trace=True)
        self.trace_chunks: list = []
        # the parent's wall of every submit -> collect round trip
        # (PartyResult.wall_s is the program alone)
        self.task_walls: list = []
        self._closed = False
        self._poisoned: str | None = None
        self.tasks_run = 0
        self._task_id = 0
        # submit_nowait enqueues under _sub_lock (the four task queues must
        # agree on task order, or the lock-step mesh deadlocks); collect
        # routes the shared result queue into per-task buckets under
        # _res_lock
        self._sub_lock = threading.Lock()
        self._res_lock = threading.Lock()
        self._results: dict = {}         # task_id -> [PartyResult...]
        self._errors: dict = {}          # rank -> traceback text
        for attempt in range(1, PORT_RETRIES + 1):
            cfg["token"] = os.urandom(TOKEN_BYTES)
            self._task_qs = [ctx.Queue() for _ in range(4)]
            # bounded control queues: a dealer running ahead of
            # consumption blocks instead of buffering sessions in flight
            self.ctrl_queues = ([ctx.Queue(maxsize=2 * DEFAULT_LIVE_AHEAD)
                                 for _ in range(4)] if live_prep else None)
            self._out_q = ctx.Queue()
            endpoints = [("127.0.0.1", p) for p in _free_ports(4)]
            self._procs = [
                ctx.Process(target=_daemon_main,
                            args=(rank, endpoints, cfg, self._task_qs[rank],
                                  self.ctrl_queues[rank] if live_prep
                                  else None, self._out_q),
                            daemon=True)
                for rank in range(4)]
            for p in self._procs:
                p.start()
            try:
                self._collect_boot(self.timeout)
                break
            except Exception as e:
                self._teardown_procs()
                if attempt < PORT_RETRIES and _addr_in_use(str(e)):
                    _log.warning(
                        "cluster boot lost the free-port race "
                        "(EADDRINUSE); retrying with fresh ports "
                        "(attempt %d/%d)", attempt, PORT_RETRIES)
                    self._errors.clear()
                    continue
                self._closed = True
                raise

    def _teardown_procs(self) -> None:
        """Boot-retry teardown: stop whatever daemons of a failed attempt
        came up (those still dialing are terminated after a grace)."""
        for q in self._task_qs:
            try:
                q.put_nowait(None)
            except (OSError, ValueError, _queue.Full):
                pass
        for p in self._procs:
            p.join(timeout=0.5)
        for p in self._procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=1.0)

    def _collect_boot(self, timeout: float) -> None:
        """Wait for the four ready acks; raise on the FIRST daemon error
        (the others would keep dialing a dead listener until their
        connect timeout), on a silent death or on timeout."""
        self.metrics_ports.clear()
        answered: set[int] = set()
        deadline = time.monotonic() + timeout
        while len(answered) < 4:
            budget = deadline - time.monotonic()
            if budget <= 0:
                raise RuntimeError(
                    f"party daemons timed out after {timeout}s at boot "
                    f"(acks {sorted(answered)})")
            try:
                item = self._out_q.get(timeout=min(budget, 1.0))
            except _queue.Empty:
                dead = [i for i, p in enumerate(self._procs)
                        if not p.is_alive() and i not in answered]
                if dead and self._out_q.empty():
                    raise RuntimeError(f"party daemon(s) {dead} died at "
                                       "boot without a word") from None
                continue
            if item[0] == "error":
                raise RuntimeError(
                    f"party daemon failures:\n--- P{item[1]} ---\n{item[2]}")
            answered.add(item[1])
            self.metrics_ports[item[1]] = item[2]

    # -- task round trips --------------------------------------------------
    def _check_usable(self) -> None:
        if self._closed:
            raise RuntimeError("cluster is closed")
        if self._poisoned is not None:
            raise ClusterPoisoned(
                "cluster poisoned by an earlier task failure -- the "
                "lock-step mesh is undefined and the daemons have stopped "
                "serving; tear this cluster down and spawn a fresh one. "
                f"Original failure:\n{self._poisoned}")

    def submit_nowait(self, program, *, seed: int = 0,
                      prep: str | None = None,
                      prep_session: int | None = None,
                      timeout: float | None = None) -> TaskHandle:
        """Enqueue ``program(rt, rank)`` on all four daemons and return a
        ``TaskHandle`` at once (gather with ``collect``)."""
        self._check_usable()
        with self._sub_lock:
            self._check_usable()
            self._task_id += 1
            task = {"program": program, "seed": seed, "prep": prep,
                    "prep_session": prep_session,
                    "timeout": timeout or self.timeout,
                    "id": self._task_id}
            with self._res_lock:
                self._results[self._task_id] = []
            t0 = time.perf_counter()
            for q in self._task_qs:
                q.put(task)
        return TaskHandle(task_id=task["id"], submitted_at=t0,
                          timeout=timeout or self.timeout)

    def _route(self, item) -> None:
        """Route one result-queue item (the caller holds ``_res_lock``)."""
        if isinstance(item, tuple) and item[0] == "error":
            self._errors[item[1]] = item[2]
        elif isinstance(item, PartyResult):
            bucket = self._results.get(item.task_id)
            if bucket is not None:
                bucket.append(item)
            # else: a stale result of an abandoned (timed-out) task

    def _raise_errors(self) -> None:
        """Raise with every rank's traceback (the caller holds
        ``_res_lock``), after a short grace for the stragglers'."""
        grace = time.monotonic() + 1.0
        while len(self._errors) < 4 and time.monotonic() < grace:
            try:
                self._route(self._out_q.get(timeout=0.1))
            except _queue.Empty:
                if all(not p.is_alive() for p in self._procs):
                    break
        msgs = "\n".join(f"--- P{r} ---\n{tb}"
                         for r, tb in sorted(self._errors.items()))
        raise RuntimeError(f"party daemon failures:\n{msgs}")

    def collect(self, handle: TaskHandle,
                timeout: float | None = None) -> list:
        """Gather the four ``PartyResult``s of a ``submit_nowait`` task,
        ordered by rank.  Safe from several threads for different handles.
        A task failure, daemon death or timeout POISONS the cluster."""
        if self._closed:
            raise RuntimeError("cluster is closed")
        tid = handle.task_id
        deadline = time.monotonic() + (timeout or handle.timeout)
        try:
            while True:
                with self._res_lock:
                    if self._poisoned is not None:
                        raise ClusterPoisoned(
                            "cluster poisoned while this task was in "
                            f"flight:\n{self._poisoned}")
                    bucket = self._results.get(tid)
                    if bucket is None:
                        raise RuntimeError(
                            f"task {tid} was never submitted or was "
                            "already collected")
                    if len(bucket) == 4:
                        del self._results[tid]
                        results = sorted(bucket, key=lambda r: r.rank)
                        self.task_walls.append(
                            time.perf_counter() - handle.submitted_at)
                        self.tasks_run += 1
                        self.trace_chunks.extend(
                            r.trace for r in results if r.trace)
                        return results
                    if self._errors:
                        self._raise_errors()
                rem = deadline - time.monotonic()
                if rem <= 0:
                    raise RuntimeError(
                        f"party daemons timed out after "
                        f"{timeout or handle.timeout}s on task {tid} "
                        f"({len(self._results.get(tid) or [])}/4 results)")
                try:
                    item = self._out_q.get(timeout=min(rem, 0.25))
                except _queue.Empty:
                    with self._res_lock:
                        done = {r.rank for r in self._results.get(tid) or []}
                        dead = [i for i, p in enumerate(self._procs)
                                if not p.is_alive() and i not in done
                                and i not in self._errors]
                    if dead and self._out_q.empty():
                        raise RuntimeError(
                            f"party daemon(s) {dead} died without a "
                            f"result on task {tid}") from None
                    continue
                with self._res_lock:
                    self._route(item)
        except BaseException as e:
            with self._res_lock:
                if self._poisoned is None:
                    self._poisoned = f"{type(e).__name__}: {e}"
                self._results.pop(tid, None)
            raise

    def submit(self, program, *, seed: int = 0, prep: str | None = None,
               prep_session: int | None = None,
               timeout: float | None = None) -> list:
        """Run ``program(rt, rank)`` as one task across the four daemons;
        returns the per-rank ``PartyResult``s (this task's deltas).
        ``prep="bank"`` consumes the next PrepBank session online-only;
        ``prep_session`` pins the session index (session k is step k's
        material, so a resumed run seeks past spent sessions and a replay
        fails loudly)."""
        handle = self.submit_nowait(program, seed=seed, prep=prep,
                                    prep_session=prep_session,
                                    timeout=timeout)
        return self.collect(handle, timeout=timeout)

    @property
    def inflight(self) -> int:
        """Submitted tasks not yet collected."""
        with self._res_lock:
            return len(self._results)

    # -- observability -----------------------------------------------------
    def merged_trace(self, extra_chunks=()) -> dict:
        """One Chrome trace-event document over every chunk collected so
        far (all tasks, all four ranks) plus ``extra_chunks`` (e.g. the
        ``DealerDaemon``'s)."""
        from ...obs import merge_chunks
        return merge_chunks([*self.trace_chunks, *extra_chunks])

    def save_trace(self, path, extra_chunks=()) -> dict:
        """Merge and write the cluster timeline to ``path`` (Perfetto /
        chrome://tracing); returns the merged document."""
        from ...obs import write_chrome_trace
        return write_chrome_trace(path, [*self.trace_chunks, *extra_chunks])

    def alive(self) -> dict:
        """{rank: the daemon process is alive}: the liveness half of the
        health probes."""
        return {rank: p.is_alive() for rank, p in enumerate(self._procs)}

    def scrape(self, timeout: float = 2.0) -> dict:
        """Every daemon's exporter: {rank: snapshot or None} (None for a
        daemon that is down, or a cluster built without metrics)."""
        from ...obs.health import _try_scrape
        return {rank: _try_scrape(port, timeout)
                for rank, port in sorted(self.metrics_ports.items())}

    def health(self, dealer=None, **kw) -> dict:
        """One cluster health document: the four exporters (and the
        dealer's, when attached) scraped, the liveness, stall and lag
        probes evaluated (``obs.health.cluster_health``).  Take it between
        tasks: the probes are age-gated, and a task that closes no online
        round for ``stall_s`` reads as a stall."""
        from ...obs.health import cluster_health
        return cluster_health(self, dealer=dealer, **kw)

    # -- lifecycle ---------------------------------------------------------
    @property
    def poisoned(self) -> str | None:
        """The first failure's summary, if a task poisoned the cluster."""
        return self._poisoned

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for q in self._task_qs:
            try:
                q.put_nowait(None)
            except (OSError, ValueError, _queue.Full) as e:
                _log.warning("cluster close: could not signal a daemon to "
                             "stop (%s: %s); it will be terminated",
                             type(e).__name__, e)
        for q in self.ctrl_queues or ():
            try:
                q.put_nowait(None)
            except _queue.Full:
                pass        # a backpressured control stream: the daemons
                            # exit through their task queues
            except (OSError, ValueError) as e:
                _log.warning("cluster close: control queue teardown failed "
                             "(%s: %s)", type(e).__name__, e)
        for p in self._procs:
            p.join(timeout=10.0)
        for rank, p in enumerate(self._procs):
            if p.is_alive():
                _log.warning("party daemon P%d did not exit within 10 s; "
                             "terminating it", rank)
                p.terminate()
                p.join(timeout=2.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def run_four_parties(program, *, seed: int = 0,
                     timeout: float = DEFAULT_TIMEOUT, tampers=(),
                     device=None) -> list:
    """One-shot: spawn a cluster on `device`, run ``program(rt, rank)``,
    tear down.  Returns the four ``PartyResult``s ordered by rank.
    ``tampers`` is a sequence of keyword dicts for ``Transport.tamper`` in
    every process.  With ``TRIDENT_TRACE=1`` each ``PartyResult.trace``
    holds its rank's chunk (``obs.merge_chunks``)."""
    with PartyCluster(timeout=timeout, tampers=tampers,
                      device=device) as cluster:
        return cluster.submit(program, seed=seed, timeout=timeout)
