"""Length-prefixed binary frames: the streaming RPC wire format.

One frame = a fixed preamble, a JSON header, and zero or more raw
ndarray payload segments::

    MAGIC "DOSF" (4)  |  header_len u32 LE  |  payload_len u64 LE
    header JSON (header_len bytes)
    segment bytes (payload_len bytes, concatenated in header order)

The header is an ordinary JSON object carrying the SAME compat contract
as every other codec in this repo (``RuntimeConfig``/``HealthStatus``/
the manifest): readers take the keys they know and IGNORE the rest, and
the only hard gate is the frame-schema version ``v`` — a frame stamped
NEWER than :data:`FRAME_SCHEMA_VERSION` is refused (we cannot know what
its extra segments mean), while older/absent versions always decode.

Array segments are described in the header (``segs: [{dtype, shape},
...]``) and shipped as raw little-endian bytes — **no savetxt/parse on
the hot path**: encode hands the socket a list of buffers (the header
block plus one ``memoryview`` per array, no join/copy of the payload),
and decode reads the whole payload into ONE buffer and returns
``np.frombuffer`` views into it (zero-copy receive; callers that need
to mutate copy explicitly).

This module is the ONLY place in the package allowed to touch
``recv``/``sendall`` (the ``fifo-hygiene`` lint rule's socket half):
every transport failure mode — peer died mid-frame, reset, timeout,
garbage bytes — surfaces here as a typed, retryable
:class:`TransportError` instead of a hang or an attribute error three
layers up.

Frame kinds (the ``kind`` header key — unknown kinds are the RECEIVER'S
problem to skip, same tolerance rule):

``hello``   server -> client on accept: ``wid``, ``credit`` (the
            in-flight window the client may keep on this connection)
``req``     one batch: ``config`` (RuntimeConfig dict), ``diff``,
            segment 0 = queries ``int64 [Q, 2]``
``rep``     the answer: ``stats`` (the wire CSV line / sentinel),
            segments = cost/plen/fin (+ paths nodes/moves) when asked
``busy``    explicit backpressure: the server's credit window is spent
            — the client books BUSY instead of discovering a timeout
``ping``    liveness probe (the ``__DOS_PING__`` vocabulary on sockets)
``health``  the answer to ``ping``: ``status`` = HealthStatus dict
``telemetry``  server -> client push, no ``id``, no reply: ``tick`` =
            one telemetry snapshot (its OWN schema version inside —
            see ``obs.telemetry``); a client that predates it drops
            the frame as unmatched, by the unknown-kind rule

A copy of the JAX package's ``transport/frames.py``: encoded frames are
byte-equal, and each package decodes the other's.
"""

from __future__ import annotations

import json
import struct

import numpy as np

from ..obs import metrics as obs_metrics
from ..utils.log import get_logger

log = get_logger(__name__)

MAGIC = b"DOSF"
#: the frame-schema version this build speaks. Bump ONLY for changes an
#: old reader cannot safely ignore; header-key additions ride for free.
FRAME_SCHEMA_VERSION = 1
_PREAMBLE = struct.Struct("<4sIQ")

#: hard ceiling on one frame's header/payload: a torn preamble must not
#: be able to ask the receiver for a 2^60-byte allocation
MAX_HEADER_BYTES = 1 << 20
MAX_PAYLOAD_BYTES = 1 << 31

#: segments are padded to this boundary so an int64 segment following a
#: uint8 one still decodes as an ALIGNED zero-copy view
SEG_ALIGN = 8


def _aligned(n: int) -> int:
    return (n + SEG_ALIGN - 1) // SEG_ALIGN * SEG_ALIGN

M_SENT = obs_metrics.counter(
    "rpc_frames_sent_total", "frames written to RPC sockets")
M_RECEIVED = obs_metrics.counter(
    "rpc_frames_received_total", "frames decoded off RPC sockets")
M_TORN = obs_metrics.counter(
    "rpc_frames_torn_total",
    "frames that died mid-read (peer gone, reset, bad magic) — each "
    "one surfaced as a retryable TransportError, never a hang")


class TransportError(RuntimeError):
    """A socket-level failure (torn frame, reset, timeout, dead peer).

    Always RETRYABLE: the request may be re-sent on a fresh connection
    or failed over to a replica — the same contract as a FIFO transfer
    script dying, so it feeds the existing breaker/failover paths."""


class TornFrame(TransportError):
    """The peer vanished mid-frame (EOF/garbage inside a frame)."""


class FrameSchemaError(ValueError):
    """The peer speaks a NEWER frame schema than this build.

    NOT retryable (a reconnect meets the same peer): the caller should
    fail the lane loudly — mixed-version fleets gate here instead of
    misreading segments."""


class Frame:
    """One decoded frame: ``kind``, the raw header dict, and the
    payload arrays (zero-copy views into the receive buffer)."""

    __slots__ = ("kind", "header", "arrays")

    def __init__(self, kind: str, header: dict, arrays: list):
        self.kind = kind
        self.header = header
        self.arrays = arrays

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Frame({self.kind!r}, id={self.header.get('id')}, "
                f"{len(self.arrays)} seg(s))")


def encode_frame(header: dict, arrays=()) -> list:
    """Encode one frame as a list of send buffers.

    The first buffer is preamble+header; each array contributes its own
    ``memoryview`` — the payload is never joined/copied, so a multi-MB
    result batch costs zero host copies on the way out."""
    arrays = [np.ascontiguousarray(a) for a in arrays]
    header = dict(header)
    header.setdefault("v", FRAME_SCHEMA_VERSION)
    header["segs"] = [{"dtype": a.dtype.str, "shape": list(a.shape)}
                      for a in arrays]
    hdr = json.dumps(header).encode()
    if len(hdr) > MAX_HEADER_BYTES:
        raise ValueError(f"frame header too large: {len(hdr)} bytes")
    payload_len = sum(_aligned(a.nbytes) for a in arrays)
    if payload_len > MAX_PAYLOAD_BYTES:
        raise ValueError(f"frame payload too large: {payload_len} bytes")
    bufs = [_PREAMBLE.pack(MAGIC, len(hdr), payload_len) + hdr]
    for a in arrays:
        bufs.append(memoryview(a).cast("B"))
        pad = _aligned(a.nbytes) - a.nbytes
        if pad:
            bufs.append(b"\x00" * pad)
    return bufs


def decode_header(raw: bytes) -> dict:
    """Parse + version-gate a frame header. Unknown keys ride along
    untouched (the caller reads what it knows); only a NEWER ``v``
    refuses."""
    try:
        header = json.loads(raw)
    except ValueError as e:
        raise TornFrame(f"undecodable frame header: {e}") from e
    if not isinstance(header, dict):
        raise TornFrame(f"frame header is not an object: {header!r}")
    v = header.get("v", FRAME_SCHEMA_VERSION)
    if not isinstance(v, int):
        v = FRAME_SCHEMA_VERSION
    if v > FRAME_SCHEMA_VERSION:
        raise FrameSchemaError(
            f"frame schema v{v} is newer than this build's "
            f"v{FRAME_SCHEMA_VERSION} (upgrade this peer)")
    return header


def decode_payload(header: dict, payload) -> list:
    """Slice the payload buffer into the header's described arrays —
    ``np.frombuffer`` views, no copy. A header/payload length mismatch
    is a torn frame."""
    segs = header.get("segs") or []
    if not isinstance(segs, list):
        raise TornFrame(f"bad segs descriptor: {segs!r}")
    mv = memoryview(payload)
    arrays = []
    off = 0
    for seg in segs:
        try:
            dtype = np.dtype(seg["dtype"])
            shape = tuple(int(x) for x in seg["shape"])
        except (KeyError, TypeError, ValueError) as e:
            raise TornFrame(f"bad segment descriptor {seg!r}: {e}") from e
        n = int(np.prod(shape, dtype=np.int64)) if shape else 1
        nbytes = n * dtype.itemsize
        if off + nbytes > len(mv):
            raise TornFrame(
                f"payload truncated: segment needs {nbytes} bytes at "
                f"offset {off}, have {len(mv)}")
        arrays.append(np.frombuffer(mv[off:off + nbytes],
                                    dtype=dtype).reshape(shape))
        off += _aligned(nbytes)
    return arrays


class FrameWriter:
    """Serialize frames onto one socket. Thread-safe: concurrent callers
    (pipelined batches, a hedge sharing the socket) interleave at frame
    granularity, never mid-frame."""

    def __init__(self, sock, lock=None):
        import threading

        self._sock = sock
        # a plain mutex, not an OrderedLock: held only around the
        # kernel-buffer write below, no other lock is ever taken under
        # it, and the hot path should not pay witness-graph accounting
        self._lock = lock if lock is not None else threading.Lock()

    def send(self, header: dict, arrays=()) -> None:
        bufs = encode_frame(header, arrays)
        try:
            with self._lock:
                for b in bufs:
                    self._sock.sendall(b)
        except (OSError, ValueError) as e:
            # ValueError: write on a socket another thread just closed
            M_TORN.inc()
            raise TransportError(f"frame send failed: {e}") from e
        M_SENT.inc()


class FrameReader:
    """Deserialize frames off one socket.

    ``read()`` returns the next :class:`Frame`, ``None`` on a CLEAN
    end-of-stream (peer closed between frames), and raises
    :class:`TornFrame` when the peer dies mid-frame — the caller never
    sees a half-decoded request, and never blocks forever if the socket
    carries a timeout."""

    def __init__(self, sock):
        self._sock = sock

    def _recv_exact(self, n: int, allow_eof: bool = False):
        buf = bytearray(n)
        mv = memoryview(buf)
        got = 0
        while got < n:
            try:
                k = self._sock.recv_into(mv[got:])
            except (OSError, ValueError) as e:
                M_TORN.inc()
                raise TornFrame(f"socket died mid-frame: {e}") from e
            if k == 0:
                if allow_eof and got == 0:
                    return None
                M_TORN.inc()
                raise TornFrame(
                    f"peer closed mid-frame ({got}/{n} bytes)")
            got += k
        return buf

    def read(self):
        pre = self._recv_exact(_PREAMBLE.size, allow_eof=True)
        if pre is None:
            return None
        magic, header_len, payload_len = _PREAMBLE.unpack(bytes(pre))
        if magic != MAGIC:
            M_TORN.inc()
            raise TornFrame(f"bad frame magic {bytes(magic)!r}")
        if header_len > MAX_HEADER_BYTES or payload_len > \
                MAX_PAYLOAD_BYTES:
            M_TORN.inc()
            raise TornFrame(
                f"implausible frame lengths (header {header_len}, "
                f"payload {payload_len})")
        header = decode_header(bytes(self._recv_exact(header_len)))
        payload = self._recv_exact(payload_len) if payload_len else b""
        arrays = decode_payload(header, payload)
        M_RECEIVED.inc()
        kind = header.get("kind")
        return Frame(kind if isinstance(kind, str) else "",
                     header, arrays)
