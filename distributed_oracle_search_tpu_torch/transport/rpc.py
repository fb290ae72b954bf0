"""Persistent-socket RPC client: the streaming head↔worker data plane.

The FIFO/NFS transport (:mod:`.fifo`) pays multiple filesystem
round-trips per batch — a query file write, a bash transfer script, two
blocking FIFO rendezvous, a ``.results`` sidecar read — which PR 7/8
already had to de-fsync and de-collide. This module carries the SAME
wire contract over one persistent connection per worker instead:

* **frames, not files** (:mod:`.frames`): length-prefixed, JSON header
  (unknown-key tolerant, gate only on NEWER ``v``), ndarray payload
  segments shipped as raw bytes — no savetxt/parse on the hot path;
* **multiplexed in-flight batches**: every request frame carries an
  ``id`` and replies correlate by it, so pipelined batches and a hedge
  duplicate share one socket instead of one-file-one-FIFO each;
* **explicit backpressure**: the server advertises a credit window in
  its ``hello`` frame and answers over-window requests with a ``busy``
  frame — the serving queues consume that instead of discovering
  saturation by timeout;
* **heartbeats** ride the existing ping/:class:`~.wire.HealthStatus`
  vocabulary as ``ping``/``health`` frames (:func:`probe`), feeding
  the same breaker healing loops as FIFO probes;
* **membership + diff epoch gates** travel in the request's
  ``RuntimeConfig`` exactly as on the FIFO wire; a gated worker answers
  the ``STALE_EPOCH``/``STALE_DIFF`` sentinel in the reply's ``stats``
  line and the head fails over.

Knobs (``DOS_TRANSPORT`` selects the lane; all via :mod:`..utils.env`):
``DOS_TRANSPORT={fifo,rpc,auto}`` (default ``fifo`` — byte-identical
legacy), ``DOS_RPC_SOCKET_DIR`` (unix socket directory, default
``/tmp``), ``DOS_RPC_PORT`` (nonzero = TCP base port; worker ``w``
listens on ``port+w`` — the cross-host spelling), ``DOS_RPC_TIMEOUT_S``
(per-call bound, default 600 like the FIFO transport),
``DOS_RPC_MAX_INFLIGHT`` (client-side credit ceiling, default 8),
``DOS_RPC_CREDIT`` (server window, default 8),
``DOS_RPC_HEARTBEAT_S`` (client idle heartbeat cadence, 0 = off).

The server half (accept loop, request handling, fault-injection
points) lives beside the FIFO serve loop in
:mod:`..worker.server` — both share one :class:`~..worker.server
.FifoServer` (engine, epoch gates, health state).

A copy of the JAX package's ``transport/rpc.py``, so either package's
head drives the other's RPC servers.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import queue as _stdqueue
import socket
import threading
import time

import numpy as np

from .frames import (
    FrameReader, FrameSchemaError, FrameWriter, TransportError,
)
from .wire import HealthStatus, RuntimeConfig, StatsRow
from ..obs import metrics as obs_metrics
from ..obs import quantiles as obs_quantiles
from ..obs import trace as obs_trace
from ..testing import faults
from ..utils.env import env_cast, env_str
from ..utils.locks import OrderedLock
from ..utils.log import get_logger

log = get_logger(__name__)

#: same default as the FIFO transport: generous for a cold-compile
#: first batch, finite so a dead worker cannot hang a campaign
DEFAULT_TIMEOUT = 600.0

M_CONNECTS = obs_metrics.counter(
    "rpc_connects_total", "RPC connections established to workers")
M_RECONNECTS = obs_metrics.counter(
    "rpc_reconnects_total",
    "RPC connections re-established after a transport failure")
M_TRANSPORT_ERRORS = obs_metrics.counter(
    "rpc_transport_errors_total",
    "RPC calls failed by transport faults (torn frame, dead socket, "
    "timeout) — each one retryable, feeding the breaker/failover path")
M_BUSY = obs_metrics.counter(
    "rpc_busy_frames_total",
    "explicit BUSY backpressure frames (client+server sides book here)")
M_HEARTBEATS = obs_metrics.counter(
    "rpc_heartbeats_total",
    "ping frames sent over persistent RPC connections")


def shutdown_close(sock) -> None:
    """Tear a socket down so BLOCKED peers wake: ``close()`` alone does
    not interrupt a thread parked in ``recv``/``accept`` on the same fd
    (the classic Linux leak) — ``shutdown(SHUT_RDWR)`` first does."""
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass    # already reset/closed: shutdown has nothing to do
    try:
        sock.close()
    except OSError as e:
        log.debug("socket close failed: %s", e)


#: head-side sink for pushed ``telemetry`` frames (``obs.telemetry``'s
#: ingest installs itself here); None = drop, the pre-telemetry behavior
_telemetry_sink = None


def set_telemetry_sink(fn) -> None:
    """Install (or clear, with None) the callable that receives every
    pushed telemetry tick from every client's read loop."""
    global _telemetry_sink
    _telemetry_sink = fn


class RpcBusy(RuntimeError):
    """The server's credit window refused the request (explicit
    backpressure — NOT a failure of the worker)."""


class RpcUnavailable(TransportError):
    """No RPC listener at the endpoint (connect refused / socket file
    absent). ``DOS_TRANSPORT=auto`` callers fall back to FIFO on this;
    ``rpc`` callers book a failed batch."""


# -------------------------------------------------------------- endpoints

def resolve_transport() -> str:
    """The ``DOS_TRANSPORT`` knob: ``fifo`` (default, byte-identical
    legacy), ``rpc``, or ``auto`` (RPC with per-lane FIFO fallback).
    Malformed values degrade to ``fifo``, logged — never crash."""
    raw = (env_str("DOS_TRANSPORT", "fifo") or "fifo").strip().lower()
    if raw not in ("fifo", "rpc", "auto"):
        log.warning("ignoring malformed DOS_TRANSPORT=%r (using 'fifo')",
                    raw)
        return "fifo"
    return raw


def rpc_socket_path(wid: int) -> str:
    """Per-worker unix socket (the local-host analog of
    ``command_fifo_path``)."""
    d = env_str("DOS_RPC_SOCKET_DIR", "/tmp") or "/tmp"
    return os.path.join(d, f"dos-rpc-worker{wid}.sock")


def endpoint_for(wid: int, host: str = "localhost"):
    """Where worker ``wid`` listens: ``("tcp", host, port+wid)`` when
    ``DOS_RPC_PORT`` names a base port, else the unix socket (which
    only reaches local workers — cross-host fleets set the port)."""
    base = env_cast("DOS_RPC_PORT", 0, int)
    if base > 0:
        return ("tcp", host, base + int(wid))
    return ("unix", rpc_socket_path(wid), None)


def endpoint_str(ep) -> str:
    if ep[0] == "tcp":
        return f"tcp:{ep[1]}:{ep[2]}"
    return f"unix:{ep[1]}"


# ----------------------------------------------------------------- client

class RpcClient:
    """One persistent, multiplexed connection to one worker.

    Thread-safe: any number of callers :meth:`call` concurrently; a
    background reader thread routes reply frames to callers by frame
    id. A transport failure fails every in-flight call with a retryable
    :class:`~.frames.TransportError` and the next call reconnects."""

    def __init__(self, endpoint, timeout_s: float | None = None,
                 max_inflight: int | None = None,
                 connect_timeout_s: float = 10.0,
                 wid: int | None = None):
        self.endpoint = endpoint
        self.wid = wid          # labels this lane's heartbeat window
        self.timeout_s = (timeout_s if timeout_s is not None
                          else env_cast("DOS_RPC_TIMEOUT_S",
                                        DEFAULT_TIMEOUT, float))
        self.max_inflight = (max_inflight if max_inflight is not None
                             else max(1, env_cast("DOS_RPC_MAX_INFLIGHT",
                                                  8, int)))
        self.connect_timeout_s = connect_timeout_s
        self._seq = itertools.count()
        self._lock = OrderedLock("transport.RpcClient")
        self._pending: dict[int, _stdqueue.Queue] = {}
        self._sock = None
        self._writer: FrameWriter | None = None
        self._reader_thread: threading.Thread | None = None
        self._hb_thread: threading.Thread | None = None
        self._hb_stop = threading.Event()
        self._credit: threading.Semaphore | None = None
        self._window = 0
        self._inflight = 0
        self._closed = False
        self._connects = 0
        self.server_hello: dict = {}

    # ------------------------------------------------------- connection
    def _dial(self):
        """Blocking connect + hello handshake (no client lock held)."""
        try:
            if self.endpoint[0] == "tcp":
                sock = socket.create_connection(
                    (self.endpoint[1], self.endpoint[2]),
                    timeout=self.connect_timeout_s)
            else:
                sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                sock.settimeout(self.connect_timeout_s)
                sock.connect(self.endpoint[1])
        except OSError as e:
            raise RpcUnavailable(
                f"no RPC listener at {endpoint_str(self.endpoint)}: {e}"
            ) from e
        try:
            hello = FrameReader(sock).read()
        except (TransportError, FrameSchemaError):
            shutdown_close(sock)
            raise
        if hello is None or hello.kind != "hello":
            shutdown_close(sock)
            raise TransportError(
                f"peer at {endpoint_str(self.endpoint)} sent no hello "
                f"(got {getattr(hello, 'kind', None)!r})")
        sock.settimeout(None)   # per-call deadlines live on the reply
        # wait below, not on the socket (the reader blocks between
        # frames by design)
        return sock, hello.header

    def _ensure_conn(self) -> None:
        with self._lock:
            if self._closed:
                raise TransportError("rpc client is closed")
            if self._sock is not None:
                return
            reconnect = self._connects > 0
        sock, hello = self._dial()
        with self._lock:
            if self._closed or self._sock is not None:
                shutdown_close(sock)
                return
            self._sock = sock
            self._writer = FrameWriter(sock)
            self.server_hello = hello
            credit = hello.get("credit")
            if not isinstance(credit, int) or credit <= 0:
                credit = self.max_inflight
            self._window = min(self.max_inflight, credit)
            self._credit = threading.Semaphore(self._window)
            self._connects += 1
            t = threading.Thread(
                target=self._read_loop, args=(sock,), daemon=True,
                name=f"dos-rpc-read-{endpoint_str(self.endpoint)}")
            self._reader_thread = t
        t.start()
        (M_RECONNECTS if reconnect else M_CONNECTS).inc()
        hb_s = env_cast("DOS_RPC_HEARTBEAT_S", 0.0, float)
        if hb_s > 0 and self._hb_thread is None:
            self._hb_stop.clear()
            self._hb_thread = threading.Thread(
                target=self._hb_loop, args=(hb_s,), daemon=True,
                name=f"dos-rpc-hb-{endpoint_str(self.endpoint)}")
            self._hb_thread.start()
        log.info("rpc connected to %s (credit window %d)",
                 endpoint_str(self.endpoint), self._window)

    def _read_loop(self, sock) -> None:
        reader = FrameReader(sock)
        try:
            while True:
                fr = reader.read()
                if fr is None:
                    raise TransportError("server closed the connection")
                if fr.kind == "hello":
                    continue            # late/duplicate hello: ignore
                if fr.kind == "telemetry":
                    # fire-and-forget push (no id): hand the tick to
                    # the head's ingest if one is installed, else drop
                    sink = _telemetry_sink
                    if sink is not None:
                        try:
                            sink(fr.header.get("tick"))
                        except Exception as e:  # noqa: BLE001 — a bad
                            # tick must not kill the data-plane reader
                            log.warning("telemetry sink failed: %s", e)
                    continue
                fid = fr.header.get("id")
                with self._lock:
                    slot = self._pending.get(fid)
                if slot is not None:
                    slot.put(fr)
                else:
                    # a late reply to a timed-out call: by-id routing
                    # means it can never satisfy a newer call
                    log.debug("unmatched rpc frame id=%r kind=%r "
                              "dropped", fid, fr.kind)
        except (TransportError, FrameSchemaError) as e:
            self._fail_conn(sock, e)

    def _fail_conn(self, sock, exc) -> None:
        with self._lock:
            if self._sock is not sock:
                return                  # an older connection's reader
            self._sock = None
            self._writer = None
            pending = list(self._pending.values())
            self._pending.clear()
        shutdown_close(sock)
        if not self._closed:
            M_TRANSPORT_ERRORS.inc()
            log.warning("rpc connection to %s failed: %s (%d call(s) "
                        "in flight fail retryable)",
                        endpoint_str(self.endpoint), exc, len(pending))
        for slot in pending:
            slot.put(exc)

    def _hb_loop(self, interval_s: float) -> None:
        # heartbeats probe over an EPHEMERAL connection, never the
        # shared one: a ping queued behind a long engine batch on the
        # shared socket would time out and call()'s teardown would
        # fail the healthy in-flight batch — a livelock whenever batch
        # time exceeds the heartbeat interval. A fresh connection gets
        # its own server conn thread and answers even mid-batch.
        while not self._hb_stop.wait(interval_s):
            probe_client = RpcClient(self.endpoint,
                                     connect_timeout_s=min(
                                         interval_s, 10.0))
            try:
                t0 = time.perf_counter()
                probe_client.probe(timeout=interval_s)
                dt = time.perf_counter() - t0
                M_HEARTBEATS.inc()
                # the one continuous liveness signal, with latency
                # history the SLO engine can window (per worker when
                # the lane knows its wid, plus the fleet aggregate)
                obs_quantiles.observe("rpc_heartbeat_seconds", dt)
                if self.wid is not None:
                    obs_quantiles.observe(
                        f"rpc_heartbeat_seconds_w{self.wid}", dt)
            except (TransportError, RpcBusy) as e:
                log.warning("rpc heartbeat to %s failed: %s",
                            endpoint_str(self.endpoint), e)
            finally:
                probe_client.close(join_s=2.0)

    # ------------------------------------------------------------ calls
    def call(self, header: dict, arrays=(), timeout: float | None = None):
        """Send one frame, wait for its correlated reply.

        Raises :class:`~.frames.TransportError` (retryable) on any
        socket-level failure or timeout, :class:`RpcBusy` on an explicit
        backpressure frame, :class:`~.frames.FrameSchemaError` when the
        peer speaks a newer schema."""
        timeout = timeout if timeout is not None else self.timeout_s
        self._ensure_conn()
        with self._lock:
            credit = self._credit
            writer = self._writer
            sock0 = self._sock
        if writer is None or credit is None:
            raise TransportError("rpc connection lost before send")
        # the credit window IS the backpressure surface: a caller
        # blocks here (bounded) instead of piling frames on a saturated
        # worker and discovering it by timeout
        if not credit.acquire(timeout=timeout):
            M_BUSY.inc()
            raise RpcBusy(
                f"rpc credit window ({self._window}) exhausted at "
                f"{endpoint_str(self.endpoint)}")
        try:
            fid = next(self._seq)
            slot: _stdqueue.Queue = _stdqueue.Queue(maxsize=1)
            with self._lock:
                self._pending[fid] = slot
                self._inflight += 1
            try:
                writer.send({**header, "id": fid}, arrays)
                try:
                    got = slot.get(timeout=timeout)
                except _stdqueue.Empty:
                    M_TRANSPORT_ERRORS.inc()
                    raise TransportError(
                        f"rpc call {fid} to "
                        f"{endpoint_str(self.endpoint)} timed out "
                        f"after {timeout:.0f}s") from None
            finally:
                with self._lock:
                    self._pending.pop(fid, None)
                    self._inflight -= 1
            if isinstance(got, Exception):
                raise got
            if got.kind == "busy":
                M_BUSY.inc()
                raise RpcBusy(
                    f"worker at {endpoint_str(self.endpoint)} answered "
                    f"BUSY (server credit window)")
            return got
        except TransportError:
            # fail the shared connection so the next call reconnects
            # instead of every caller timing out one by one (identity-
            # checked: a reconnect raced in by another thread survives)
            if sock0 is not None:
                self._fail_conn(sock0, TransportError("call failed"))
            raise
        finally:
            credit.release()

    def probe(self, timeout: float = 10.0) -> HealthStatus:
        """Liveness over the persistent socket: the ``__DOS_PING__``
        vocabulary as a ``ping`` frame; the reply is the same
        :class:`~.wire.HealthStatus` a FIFO probe reads."""
        fr = self.call({"kind": "ping"}, timeout=timeout)
        status = fr.header.get("status")
        if fr.kind != "health" or not isinstance(status, dict):
            raise TransportError(
                f"ping to {endpoint_str(self.endpoint)} answered "
                f"{fr.kind!r}, not health")
        return HealthStatus.from_json(json.dumps(status))

    # ----------------------------------------------------------- status
    def statusz(self) -> dict:
        with self._lock:
            return {
                "endpoint": endpoint_str(self.endpoint),
                "connected": self._sock is not None,
                "inflight": int(self._inflight),
                "credit": int(self._window),
                # the starvation signal the control daemon reads: how
                # full this connection's credit window is (1.0 = every
                # further call would block or shed BUSY)
                "occupancy": (round(self._inflight / self._window, 4)
                              if self._window > 0 else 0.0),
                "connects": int(self._connects),
            }

    def close(self, join_s: float = 5.0) -> None:
        self._hb_stop.set()
        with self._lock:
            self._closed = True
            sock = self._sock
        if sock is not None:
            self._fail_conn(sock, TransportError("client closed"))
        for t in (self._reader_thread, self._hb_thread):
            if t is not None:
                t.join(timeout=join_s)
        self._reader_thread = self._hb_thread = None


# --------------------------------------------- campaign-path conveniences

_client_cache: dict = {}
_client_cache_lock = OrderedLock("transport.rpc.client_cache")


def client_for(wid: int, host: str = "localhost") -> RpcClient:
    """Process-lifetime client cache: the campaign head keeps ONE
    persistent connection per worker across every round (that is the
    point of the transport). ``close_clients()`` at campaign end."""
    key = (host, int(wid))
    with _client_cache_lock:
        c = _client_cache.get(key)
        if c is None:
            c = _client_cache[key] = RpcClient(
                endpoint_for(wid, host=host), wid=int(wid))
        return c


def close_clients() -> None:
    with _client_cache_lock:
        clients = list(_client_cache.values())
        _client_cache.clear()
    for c in clients:
        c.close()


def probe(wid: int, host: str = "localhost",
          timeout: float = 10.0) -> HealthStatus | None:
    """One-shot liveness probe over a FRESH connection (breaker healing
    loops call this on the cooldown cadence; an ephemeral connection
    also proves the accept loop itself is alive). None on any failure —
    the same contract as ``transport.fifo.probe``."""
    client = RpcClient(endpoint_for(wid, host=host),
                       connect_timeout_s=min(timeout, 10.0))
    try:
        return client.probe(timeout=timeout)
    except (TransportError, RpcBusy, FrameSchemaError) as e:
        log.warning("rpc probe of worker %d on %s failed: %s", wid,
                    host, e)
        return None
    finally:
        client.close(join_s=timeout)


def request_header(rconf: RuntimeConfig, diff: str,
                   wid: int | None = None) -> dict:
    """The ``req`` frame header for one batch. The ``corrupt-frame``
    fault point garbles the config here (the socket analog of the
    transfer-script corruption): the server must count it malformed and
    answer FAIL, never wedge."""
    config = json.loads(rconf.to_json())
    if faults.inject("corrupt-frame", wid=wid) is not None:
        config = "CORRUPT " + rconf.to_json()
    return {"kind": "req", "config": config, "diff": diff or "-"}


def decode_reply_row(fr) -> StatsRow:
    """The reply's stats line -> :class:`~.wire.StatsRow` (FAIL /
    STALE_* sentinels included); garbage decodes as a failed row."""
    try:
        return StatsRow.decode(str(fr.header.get("stats", "")))
    except ValueError as e:
        log.error("bad rpc stats line: %s", e)
        return StatsRow.failed()


def _materialize_sidecars(fr, sidecar_base: str) -> None:
    """Campaign compatibility: a reply's paths/trace payloads land as
    the SAME ``<base>.paths`` / ``<base>.trace`` sidecar files the
    collectors already read — the extraction and trace-merge tooling
    does not know the batch never touched the shared dir."""
    from .wire import paths_file_for, write_paths_file

    if fr.header.get("paths") and len(fr.arrays) >= 2:
        try:
            nodes, moves = fr.arrays[-2], fr.arrays[-1]
            write_paths_file(paths_file_for(sidecar_base),
                             np.asarray(nodes), np.asarray(moves))
        except (OSError, ValueError) as e:
            log.error("cannot write rpc paths sidecar for %s: %s",
                      sidecar_base, e)
    events = fr.header.get("trace")
    if isinstance(events, list) and events:
        try:
            obs_trace.write_events(
                obs_trace.trace_sidecar_for(sidecar_base), events)
        except OSError as e:
            log.error("cannot write rpc trace sidecar for %s: %s",
                      sidecar_base, e)


def send_batch(host: str, wid: int, queries, rconf: RuntimeConfig,
               diff: str, timeout: float | None = None,
               sidecar_base: str = "") -> StatsRow:
    """One campaign batch over the persistent connection: queries ride
    as a raw int64 segment (no query file), the stats line comes back
    in the reply header, and any paths/trace payloads materialize as
    the legacy sidecars next to ``sidecar_base``."""
    client = client_for(wid, host=host)
    q = np.ascontiguousarray(np.asarray(queries, np.int64).reshape(-1, 2))
    fr = client.call(request_header(rconf, diff, wid=wid), [q],
                     timeout=timeout)
    row = decode_reply_row(fr)
    if sidecar_base:
        _materialize_sidecars(fr, sidecar_base)
    return row


def send_batch_with_retry(host: str, wid: int, queries,
                          rconf: RuntimeConfig, diff: str,
                          timeout: float | None = None,
                          policy=None,
                          sidecar_base: str = "") -> StatsRow:
    """:func:`send_batch` under the FIFO transport's retry policy
    (same env knobs, same ``head_retries_total`` accounting). A missing
    listener raises :class:`RpcUnavailable` on the FIRST attempt only —
    that is the ``auto`` fallback signal; once a worker has answered on
    this transport, later transport deaths are worker failures and walk
    the normal retry/failover path."""
    from . import fifo as fifo_transport

    policy = policy or fifo_transport.RetryPolicy.from_env()
    seed = f"rpc:{host}:{wid}"
    row = StatsRow.failed()
    for attempt in range(policy.retries + 1):
        if attempt:
            fifo_transport.M_RETRIES.inc()
            delay = policy.backoff_s(attempt - 1, seed=seed)
            log.warning("retrying rpc batch to worker %d on %s "
                        "(attempt %d) in %.2fs", wid, host, attempt,
                        delay)
            time.sleep(delay)
        try:
            row = send_batch(host, wid, queries, rconf, diff,
                             timeout=timeout, sidecar_base=sidecar_base)
        except RpcUnavailable:
            if attempt == 0:
                raise
            row = StatsRow.failed()
        except (TransportError, RpcBusy) as e:
            log.error("rpc batch to worker %d on %s failed "
                      "(attempt %d): %s", wid, host, attempt, e)
            row = StatsRow.failed()
        if row.ok:
            return row
    return row


def config_from_wire(raw) -> RuntimeConfig:
    """Decode a request frame's ``config`` value with the standard
    codec tolerance (unknown keys filtered; non-dict garbage raises
    ``ValueError`` so the server books it malformed)."""
    if not isinstance(raw, dict):
        raise ValueError(f"config is not an object: {type(raw).__name__}")
    known = {f.name for f in dataclasses.fields(RuntimeConfig)}
    return RuntimeConfig(**{k: v for k, v in raw.items() if k in known})
