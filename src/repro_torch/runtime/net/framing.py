"""Length-prefixed wire format for tagged ring-word messages
(``repro/runtime/net/framing.py``; the same bytes on the wire).

One frame is

    [4B header length, big-endian] [header JSON, utf-8] [payload bytes]

with the header carrying, per message, the demultiplexing tag plus the
dtype and shape that rebuild the array on the far side.  A frame carries
one message (header = object) or a batch (header = array of objects,
payload = the bodies concatenated in header order).  The port writes
batches only and reads both kinds (the JAX package's single-message
``send_frame`` writes the first):

    {"tag": "mult#1.p1", "dtype": "<u8", "shape": [2, 3], "nbytes": 48}
    [{...}, {...}, ...]

Frames hold numpy arrays.  Ring words travel as the JAX package's
unsigned words (``<u8`` for ell = 64, ``<u4`` for ell = 32): the sender
converts its tensors with ``core.ring.words_to_numpy`` (or its batched
twin) and the receiver rebuilds them with ``words_from_numpy``, so the
port's daemons and the JAX package's read each other's frames.  A
received body is a writable array over the buffer it was read into (no
second copy).

Framing is transport metadata: the tallied communication stays ``nbits *
count`` as the analytic lemmas count it; headers and hash copies ride
along unbilled.
"""
from __future__ import annotations

import json
import struct

import numpy as np

_LEN = struct.Struct(">I")
MAX_HEADER = 1 << 24          # batched headers: ~100 bytes per message


class FramingError(RuntimeError):
    """Malformed frame or closed connection mid-frame."""


def _read_exact(sock, n: int) -> bytearray:
    """`n` bytes from `sock` into one writable buffer."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if not k:
            raise FramingError(
                f"connection closed with {n - got} bytes outstanding")
        got += k
    return buf


def _describe(tag: str, payload) -> tuple:
    # np.asarray keeps a 0-d array 0-d (the JAX package's framing sends
    # one as shape [1])
    arr = np.asarray(payload, order="C")
    body = arr.tobytes()
    return {"tag": tag, "dtype": arr.dtype.str, "shape": list(arr.shape),
            "nbytes": len(body)}, body


def send_frames(sock, items) -> int:
    """Serialize a batch of (tag, ndarray) messages as ONE frame; returns
    the bytes written."""
    entries, bodies = [], []
    for tag, payload in items:
        ent, body = _describe(tag, payload)
        entries.append(ent)
        bodies.append(body)
    header = json.dumps(entries).encode("utf-8")
    frame = _LEN.pack(len(header)) + header + b"".join(bodies)
    sock.sendall(frame)
    return len(frame)


def _decode_entry(ent, sock) -> tuple:
    try:
        tag = ent["tag"]
        dtype = np.dtype(ent["dtype"])
        shape = tuple(ent["shape"])
        nbytes = int(ent["nbytes"])
    except (ValueError, KeyError, TypeError) as e:
        raise FramingError(f"malformed frame header: {e}") from e
    body = _read_exact(sock, nbytes)
    try:
        arr = np.frombuffer(body, dtype=dtype).reshape(shape)
    except ValueError as e:
        # nbytes not a multiple of the itemsize, or the shape's product
        # off: a framing error, so the reader thread posts its EOF
        raise FramingError(f"frame body does not match header: {e}") from e
    return tag, arr


def recv_frame(sock) -> list:
    """Read one frame; returns its messages as a list of (tag, ndarray)
    (a single-message frame gives a one-element list)."""
    (hlen,) = _LEN.unpack(_read_exact(sock, _LEN.size))
    if not 0 < hlen <= MAX_HEADER:
        raise FramingError(f"implausible header length {hlen}")
    try:
        header = json.loads(_read_exact(sock, hlen).decode("utf-8"))
    except ValueError as e:
        raise FramingError(f"malformed frame header: {e}") from e
    entries = header if isinstance(header, list) else [header]
    return [_decode_entry(ent, sock) for ent in entries]
