"""Continuous dealing (``repro/offline/continuous.py``): a background
dealer that refills a PrepBank across training steps instead of one
up-front ``deal_sessions`` call.

``ContinuousDealer`` keeps a bounded window of future sessions ready:
whenever the bank's unconsumed window drops below ``ahead``, the dealer
thread deals the next session (step k from seed ``base_seed + k``, the
seed ``train.trainer.seed_for_step`` gives the online step k, so session k
IS step k's preprocessing) and adds it to the bank.  The consumer blocks
in ``next_store`` / ``store_for_step`` until its session is ready.
Consumed sessions are tombstoned as they are handed out, so a long run
holds at most the look-ahead window; consuming a session twice (a retried
step) raises ``PrepReplayError`` naming it.

On the card the dealer thread deals on a CUDA stream of its own, as
``PrepPipeline``'s does; each store carries the event recorded after its
last write, which the consuming stream waits on (``OnlinePrep``), and the
consumer ``record_stream``s every tensor it pops.  Both threads run
Python and dispatch, so under the GIL the overlap is of device work with
host work.  The kernels' launch counters are shared by both threads.
"""
from __future__ import annotations

import threading

import torch

from ..core.ring import RING64, Ring
from ..runtime.runtime import resolve_device
from .dealer import deal
from .store import PrepBank, PrepError


class ContinuousDealer:
    """Background dealer refilling its ``bank`` (a PrepBank of its own) to
    ``ahead`` sessions past the consumer.

    ``program_for_step``: callable ``step -> program`` (the same program
    for every step in the common case: a training step's offline half
    depends on shapes, not data).  ``total`` bounds the number of sessions
    dealt (None: deal until closed).  Sessions are dealt on `device` (CUDA
    unless the caller asks for the CPU).
    """

    def __init__(self, program_for_step, *, ring: Ring = RING64,
                 base_seed: int = 0, ahead: int = 2, total: int | None = None,
                 device=None):
        if ahead < 1:
            raise ValueError(f"ahead {ahead} < 1")
        self._program_for_step = program_for_step
        self._ring = ring
        self._base_seed = base_seed
        self._ahead = ahead
        self._total = total
        self._device = resolve_device(device)
        # the dealer's own stream on the card (None on the CPU)
        self._stream = torch.cuda.Stream(self._device) \
            if self._device.type == "cuda" else None
        self.bank = PrepBank()
        self.reports: list = []
        self._dealt = 0
        self._error: BaseException | None = None
        self._stop = threading.Event()
        self._cond = threading.Condition()
        self._thread = threading.Thread(target=self._refill, daemon=True,
                                        name="continuous-dealer")
        self._thread.start()

    # -- producer ----------------------------------------------------------
    def _deal(self, step: int):
        return deal(self._program_for_step(step), ring=self._ring,
                    seed=self._base_seed + step, device=self._device,
                    meta={"step": step})

    def _refill(self) -> None:
        try:
            while not self._stop.is_set():
                with self._cond:
                    while (self.bank.sessions_left >= self._ahead
                           and not self._stop.is_set()):
                        self._cond.wait(timeout=0.2)
                    if self._stop.is_set():
                        return
                    if self._total is not None \
                            and self._dealt >= self._total:
                        return
                    step = self._dealt
                # deal OUTSIDE the lock (the slow part); sessions are
                # appended strictly in step order by this single thread
                if self._stream is None:
                    store, rep = self._deal(step)
                else:
                    with torch.cuda.stream(self._stream):
                        store, rep = self._deal(step)
                with self._cond:
                    self.bank.add(store)
                    self._dealt += 1
                    self.reports.append(rep)
                    self._cond.notify_all()
        except Exception as e:          # surfaced on the consumer side
            with self._cond:
                self._error = e
                self._cond.notify_all()

    # -- consumer ----------------------------------------------------------
    def next_store(self, timeout: float | None = 60.0):
        """The next session's PrepStore (blocking until dealt).  Raises
        the dealer's error, or PrepError on timeout / after close()."""
        with self._cond:
            while self.bank.sessions_left == 0:
                if self._error is not None:
                    raise self._error
                if self._total is not None and self._dealt >= self._total:
                    raise PrepError(
                        f"continuous dealer finished after {self._total} "
                        "sessions")
                if self._stop.is_set():
                    raise PrepError("continuous dealer is closed")
                if not self._cond.wait(timeout=timeout):
                    raise PrepError(
                        f"timed out after {timeout}s waiting for the "
                        f"continuous dealer (session {self.bank._next} "
                        "not yet dealt)")
            store = self.bank.next()
            self._cond.notify_all()     # wake the refill thread
            return store

    def store_for_step(self, step: int, timeout: float | None = 60.0):
        """Step-indexed consumption: seek the bank to `step` (skipping
        sessions a resumed run no longer needs; a backwards seek raises
        PrepReplayError) and return its store."""
        with self._cond:
            if step < self.bank._next:
                self.bank.seek(step)            # raises PrepReplayError
            if self._total is not None and step >= self._total:
                raise PrepError(
                    f"step {step} beyond the dealer's {self._total} "
                    "sessions")
            while self._dealt <= step:
                # discard the sessions this consumer is skipping as they
                # arrive, so the refill window keeps moving toward `step`
                reachable = min(step, self._dealt)
                if reachable > self.bank._next:
                    self.bank.seek(reachable)
                    self._cond.notify_all()
                if self._error is not None:
                    raise self._error
                if self._stop.is_set():
                    raise PrepError("continuous dealer is closed")
                if not self._cond.wait(timeout=timeout):
                    raise PrepError(
                        f"timed out after {timeout}s waiting for the "
                        f"continuous dealer (step {step} not yet dealt)")
            self.bank.seek(step)
            store = self.bank.next()
            self._cond.notify_all()
            return store

    # -- lifecycle ---------------------------------------------------------
    def close(self) -> None:
        """Stop dealing; waits for a session being dealt to finish."""
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        self._thread.join(timeout=60.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
