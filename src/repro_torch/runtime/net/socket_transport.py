"""TCP transport: each party in its own OS process, full mesh
(``repro/runtime/net/socket_transport.py``).

Execution model -- *replicated program, authoritative wire*: every party
process runs the same deterministic four-party protocol program (same seed
=> same PRF streams, same message schedule), but for every message the copy
that matters is the one on the wire:

  * when this process is the SENDER (``src == rank``) the payload is framed
    and written to the TCP link;
  * when this process is the RECEIVER (``dst == rank``) the payload is read
    back off the socket and *that* copy feeds the party's ledger checks and
    later computation -- a tampered wire flips this party's abort flag as
    it would in a deployment;
  * messages between two remote parties are carried by the local
    simulation queue so the lock-step program can continue.

Byte and round accounting is ``MeasuredTransport``'s, the same as
``LocalTransport``'s by construction.  Each peer connection has a reader
thread that demultiplexes frames into per-peer queues, which keeps the
send-then-receive choreography free of deadlock whatever the TCP buffer
sizes.

Payloads are ring-word tensors on the runtime's ``device``.  Outgoing
messages are buffered per destination and flushed as ONE multi-message
frame per (link, round): before this process blocks on a receive, when the
outermost round scope of a phase closes (``_round_flush``), and at
shutdown.  A flush moves all of a destination's buffered tensors to the
host in one copy per dtype (``core.ring.words_to_numpy_batch``), so a
round's sends cost one synchronisation with the device, not one per
message; a received body goes onto ``device`` with one host-to-device copy
per message.  ``frames_sent[(src, dst)]`` counts the wire frames and
``bytes_sent[(src, dst)]`` the bytes written, headers and the unbilled
hash copies included.

Mesh bring-up: every rank listens on its own endpoint, dials every lower
rank (with retry while the peer's listener comes up), then accepts the
higher ranks.  The hello carries the dialer's rank and the mesh's
``token``, a random value each boot draws: a listener closes and ignores a
connection whose token is not its own (a dialer of another mesh that took
the same port, or a stray), and keeps accepting its own peers.
"""
from __future__ import annotations

import errno
import logging
import queue
import socket
import threading
import time
from collections import defaultdict, deque

import numpy as np
import torch

from ...core.ring import words_from_numpy, words_to_numpy_batch
from ..transport import MeasuredTransport
from .framing import FramingError, recv_frame, send_frames

PARTIES = (0, 1, 2, 3)
TOKEN_BYTES = 8

_log = logging.getLogger(__name__)

# teardown errnos that only mean the peer hung up first
_QUIET_SHUTDOWN_ERRNOS = (errno.ENOTCONN, errno.EBADF, errno.EPIPE,
                          errno.ECONNRESET)


class TransportTimeout(RuntimeError):
    """No frame arrived within the timeout (peer died or deadlocked)."""


def _from_wire(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A received body as a tensor on `device`: ring words by a bit view
    of the frame's own buffer, then one host-to-device copy."""
    if arr.dtype in (np.uint64, np.uint32):
        return words_from_numpy(arr, device, copy=False)
    return torch.from_numpy(arr).to(device)


class SocketTransport(MeasuredTransport):
    """One party's endpoint of the four-way TCP mesh.

    endpoints: list of (host, port) per rank; this process serves
    ``endpoints[rank]`` and dials the others.  ``token``: the mesh's
    ``TOKEN_BYTES`` bytes, the same in all four processes.  Received
    payloads land on `device`.
    """

    def __init__(self, rank: int, endpoints, *, token: bytes, device,
                 timeout: float = 60.0, connect_timeout: float = 30.0):
        super().__init__()
        if rank not in PARTIES or len(endpoints) != len(PARTIES):
            raise ValueError(f"rank {rank} of endpoints {endpoints}")
        if len(token) != TOKEN_BYTES:
            raise ValueError(f"mesh token of {len(token)} bytes, not "
                             f"{TOKEN_BYTES}")
        self.rank = rank
        self.token = bytes(token)
        self.device = torch.device(device)
        self.timeout = timeout
        self._local: dict[tuple, deque] = defaultdict(deque)
        self._outbuf: dict[int, list] = defaultdict(list)
        self.frames_sent: dict[tuple, int] = defaultdict(int)
        self.bytes_sent: dict[tuple, int] = defaultdict(int)
        self._socks: dict[int, socket.socket] = {}
        self._inbox: dict[int, queue.Queue] = {
            p: queue.Queue() for p in PARTIES if p != rank}
        self._pending: dict[tuple, deque] = defaultdict(deque)
        self._readers: list[threading.Thread] = []
        self._reader_err: list[Exception] = []
        self._closed = False
        self._m_flush = self.metrics.counter(
            "trident_wire_flush_us_total",
            "wall-clock in flushes: the batched copy of the buffered "
            "payloads to the host and the socket writes (us)")
        self._m_d2h = self.metrics.counter(
            "trident_wire_d2h_us_total",
            "wall-clock of the flushes' batched copies to the host (us)")
        self._m_h2d = self.metrics.counter(
            "trident_wire_h2d_us_total",
            "wall-clock of received payloads' copies to the device (us)")
        self._connect_mesh(endpoints, connect_timeout)
        for peer, sock in self._socks.items():
            t = threading.Thread(target=self._reader_loop,
                                 args=(peer, sock), daemon=True)
            t.start()
            self._readers.append(t)

    # -- mesh bring-up -----------------------------------------------------
    def _connect_mesh(self, endpoints, connect_timeout: float) -> None:
        host, port = endpoints[self.rank]
        listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        listener.bind((host, port))
        listener.listen(len(PARTIES))
        try:
            for peer in range(self.rank):
                self._socks[peer] = self._dial(endpoints[peer],
                                               connect_timeout)
            expect = {p for p in PARTIES if p > self.rank}
            listener.settimeout(connect_timeout)
            while expect:
                conn, addr = listener.accept()
                peer = self._read_hello(conn, connect_timeout)
                if peer is None:
                    _log.warning("P%d refused a connection from %s: not a "
                                 "hello of this mesh", self.rank, addr)
                    conn.close()
                    continue
                if peer not in expect:
                    conn.close()
                    raise RuntimeError(f"unexpected hello from rank {peer}")
                self._tune(conn)
                expect.discard(peer)
                self._socks[peer] = conn
        finally:
            listener.close()

    def _read_hello(self, conn: socket.socket, timeout: float) -> int | None:
        """The dialer's rank, or None unless the hello carries this mesh's
        token (a short read, a closed or silent connection: None too)."""
        conn.settimeout(timeout)
        hello = b""
        try:
            while len(hello) < 1 + TOKEN_BYTES:
                chunk = conn.recv(1 + TOKEN_BYTES - len(hello))
                if not chunk:
                    return None
                hello += chunk
        except OSError:
            return None
        if hello[1:] != self.token:
            return None
        return hello[0]

    def _dial(self, endpoint, connect_timeout: float) -> socket.socket:
        deadline = time.monotonic() + connect_timeout
        while True:
            try:
                sock = socket.create_connection(endpoint, timeout=2.0)
                self._tune(sock)
                sock.sendall(bytes([self.rank]) + self.token)
                return sock
            except OSError as e:
                if time.monotonic() > deadline:
                    raise TransportTimeout(
                        f"P{self.rank} could not reach {endpoint}") from e
                time.sleep(0.05)

    @staticmethod
    def _tune(sock: socket.socket) -> None:
        sock.settimeout(None)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

    def _reader_loop(self, peer: int, sock: socket.socket) -> None:
        try:
            while True:
                for msg in recv_frame(sock):     # a frame may batch many
                    self._inbox[peer].put(msg)
        except (FramingError, OSError) as e:
            if not self._closed:
                self._reader_err.append(e)
            self._inbox[peer].put(None)          # EOF sentinel

    # -- message movement (MeasuredTransport hooks) ------------------------
    def _put(self, src: int, dst: int, tag: str, payload) -> None:
        if src == self.rank:
            # coalesce: one frame per (link, round), flushed lazily
            self._outbuf[dst].append((tag, payload))
        if dst != self.rank:
            self._local[(src, dst, tag)].append(payload)

    def _flush_out(self, dst: int | None = None) -> None:
        """Ship buffered outgoing messages, one multi-message frame per
        destination (in buffer order, so per-link FIFO is kept).  Every
        destination's tensors reach the host in one batched copy."""
        dsts = [d for d in ((dst,) if dst is not None else tuple(self._outbuf))
                if self._outbuf.get(d)]
        if not dsts:
            return
        t0 = time.perf_counter()
        items = [it for d in dsts for it in self._outbuf[d]]
        arrays = iter(words_to_numpy_batch([p for _, p in items]))
        self._m_d2h.inc((time.perf_counter() - t0) * 1e6)
        for d in dsts:
            frame = [(tag, next(arrays)) for tag, _ in self._outbuf[d]]
            self._outbuf[d] = []
            self.bytes_sent[(self.rank, d)] += send_frames(self._socks[d],
                                                           frame)
            self.frames_sent[(self.rank, d)] += 1
        self._m_flush.inc((time.perf_counter() - t0) * 1e6)

    def _round_flush(self, phase: str) -> None:
        self._flush_out()

    def _get(self, dst: int, src: int, tag: str):
        if dst != self.rank:
            q = self._local[(src, dst, tag)]
            if not q:
                raise RuntimeError(f"recv on empty simulated link "
                                   f"P{src}->P{dst} ({tag})")
            return q.popleft()
        pend = self._pending[(src, tag)]
        if pend:
            return self._to_device(pend.popleft())
        # about to block: everything we buffered must hit the wire first,
        # or the lock-step co-processes can never reach their sends
        self._flush_out()
        deadline = time.monotonic() + self.timeout
        while True:
            budget = deadline - time.monotonic()
            if budget <= 0:
                raise TransportTimeout(
                    f"P{self.rank} timed out waiting for {tag} from P{src}")
            try:
                frame = self._inbox[src].get(timeout=budget)
            except queue.Empty:
                continue
            if frame is None:
                err = self._reader_err[-1] if self._reader_err else "EOF"
                raise TransportTimeout(
                    f"P{self.rank} link to P{src} died waiting for {tag}: "
                    f"{err}")
            got_tag, arr = frame
            if got_tag == tag:
                return self._to_device(arr)
            self._pending[(src, got_tag)].append(arr)

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        t0 = time.perf_counter()
        t = _from_wire(arr, self.device)
        self._m_h2d.inc((time.perf_counter() - t0) * 1e6)
        return t

    # -- lifecycle ---------------------------------------------------------
    def close(self) -> None:
        self._closed = True
        try:
            self._flush_out()
        except OSError as e:
            # unflushed frames are data lost to a peer still mid-round
            _log.warning("P%d close: could not flush buffered frames "
                         "(%s: %s); peers may see a truncated stream",
                         self.rank, type(e).__name__, e)
        for peer, sock in self._socks.items():
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError as e:
                if e.errno not in _QUIET_SHUTDOWN_ERRNOS:
                    _log.warning("P%d close: shutdown of link to P%d "
                                 "failed (%s: %s)", self.rank, peer,
                                 type(e).__name__, e)
            sock.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
