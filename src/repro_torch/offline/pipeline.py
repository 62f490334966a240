"""Offline/online pipelining (``repro/offline/pipeline.py``): a background
dealer streams PrepStores into a bounded queue while the online consumer
drains them.

The dealer runs one session ahead of the online run -- or as many as
``capacity`` allows -- so the online run does not wait on preprocessing;
the bounded queue stalls a dealer that gets too far ahead.  The dealer's
errors are raised on the consumer's side.

On the card the dealer thread deals on a CUDA stream of its own; each
store carries an event recorded after its last write, which the
consumer's stream waits on (``OnlinePrep``) -- no synchronization of the
whole device.  Both threads run Python and dispatch, so under the GIL the
overlap is of device work with host work, not of host work with host
work.  The kernels' launch counters (``kernels.ops``) are shared by both
threads: read them on deal and online runs made one after the other.
"""
from __future__ import annotations

import queue
import threading

import torch

from ..core.ring import RING64, Ring
from ..runtime.runtime import resolve_device
from .dealer import deal
from .store import PrepError

_DONE = object()


class PrepPipeline:
    """Producer/consumer pipeline over the sessions of ``programs``.

    ``programs``: one protocol program per session.  Session k is dealt
    from seed ``base_seed + k``, over a fresh LocalTransport, on `device`
    (CUDA unless the caller asks for the CPU), on `stream` (default: a new
    one; a caller that runs pipelines one after another passes one stream
    to all, so the caching allocator's blocks of the last pipeline serve
    the next).  Iterate
    ``stores()`` (or call ``next_store()``) to consume them in order.
    """

    def __init__(self, programs, *, ring: Ring = RING64, base_seed: int = 0,
                 capacity: int = 2, device=None, stream=None,
                 runtime_kwargs: dict | None = None):
        if capacity < 1:
            raise ValueError(f"capacity {capacity} < 1")
        self._programs = list(programs)
        self._ring = ring
        self._base_seed = base_seed
        self._device = resolve_device(device)
        self._runtime_kwargs = runtime_kwargs
        # the dealer's own stream on the card (None on the CPU)
        if self._device.type == "cuda" and stream is None:
            stream = torch.cuda.Stream(self._device)
        self._stream = stream
        self._q: queue.Queue = queue.Queue(maxsize=capacity)
        # written by the producer thread, raised on the consumer side
        self._err_lock = threading.Lock()
        self._error: Exception | None = None
        self._taken = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._produce, daemon=True,
                                        name="prep-dealer")
        self._thread.start()

    @property
    def sessions(self) -> int:
        return len(self._programs)

    def _offer(self, item) -> bool:
        """Bounded put that gives up when the pipeline is cancelled (an
        abandoned consumer must not leave the dealer parked in put())."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def _deal(self, k: int, program):
        return deal(program, ring=self._ring, seed=self._base_seed + k,
                    device=self._device,
                    runtime_kwargs=self._runtime_kwargs,
                    meta={"session": k})

    def _produce(self) -> None:
        try:
            for k, program in enumerate(self._programs):
                if self._stop.is_set():
                    return
                if self._stream is None:
                    store, report = self._deal(k, program)
                else:
                    with torch.cuda.stream(self._stream):
                        store, report = self._deal(k, program)
                if not self._offer((k, store, report)):
                    return
        except Exception as e:              # surfaced on the consumer side
            with self._err_lock:
                self._error = e
        finally:
            self._offer(_DONE)

    def next_store(self, timeout: float | None = None):
        """(session index, PrepStore, DealReport) of the next session;
        raises the producer's error, PrepError when exhausted, or
        PrepError on timeout (the dealer is still mid-session)."""
        try:
            item = self._q.get(timeout=timeout)
        except queue.Empty:
            raise PrepError(
                f"timed out after {timeout}s waiting for the dealer "
                f"(session {self._taken} not yet produced)") from None
        if item is _DONE:
            self._q.put(_DONE)              # stay terminal for later calls
            with self._err_lock:
                error = self._error
            if error is not None:
                raise error
            raise PrepError(
                f"prep pipeline exhausted after {self._taken} sessions")
        self._taken += 1
        return item

    def stores(self):
        """Iterate (k, store, report) over all remaining sessions."""
        while self._taken < len(self._programs):
            yield self.next_store()
        with self._err_lock:
            error = self._error
        if error is not None:
            raise error

    def close(self) -> None:
        """Cancel the producer: no further sessions are dealt, and a
        producer blocked on the bounded queue is released."""
        self._stop.set()
        self._thread.join(timeout=60.0)

    def join(self, timeout: float | None = None) -> None:
        self._thread.join(timeout=timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
