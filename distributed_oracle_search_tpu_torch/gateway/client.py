"""``DosClient`` — the client library for the gateway tier.

One LOGICAL connection per client, backed by whichever live frontend
discovery currently points at. The constructor resolves candidates —
explicit seed endpoints, plus the leased endpoint registry
(``gateway.json`` via ``registry_dir``) when given — connects to the
first that answers, reads the gateway ``hello`` (gating on a NEWER
schema, tolerating older), and sizes a local credit semaphore to the
advertised window so the client can never trip the gateway's BUSY
answer under its own steam — a ``busy`` frame still surfaces (another
client may have the window) as :class:`GatewayBusy`, which is
retryable by contract.

Frames multiplex: ``submit_*`` returns a handle immediately and a
background reader correlates reply frames back by ``id``, so a caller
can keep the whole credit window full (the bench's open-loop load
generator does; :func:`pair_rows` decodes a reply frame it collected
itself).
The sync conveniences (``query``, ``matrix``, ``alternatives``,
``reverse``) are submit + wait.

Failover: when the connection dies (reset, clean close, torn frame) —
or, for a client with somewhere else to go, when a reply stays overdue
past its wait budget (the half-open signature of an asymmetric
partition) — the client re-resolves discovery, connects to the next
live frontend, and RESUBMITS every unanswered in-flight frame under
its ORIGINAL id with ``resubmit`` stamped true. Safety comes from the
wire contract, not from guessing: every query frame carries this
client's identity token (``cid``), and a frontend that already
answered ``(cid, id)`` replays its memoized reply instead of
double-booking counters and cache inserts — exactly-once *accounting*
over at-least-once *execution*; answers are deterministic, so a
re-execution on a different frontend is bit-identical. Waits in
flight keep blocking across a failover and simply receive the
resubmitted answer. A request's deadline (``deadline_ms``) is pinned
at SUBMIT time: :meth:`wait` never grants a frame more total lifetime
than it asked for, however late the caller collects it.
"""

from __future__ import annotations

import socket
import threading
import time
import uuid

from . import protocol
from .registry import live_endpoints
from ..obs import metrics as obs_metrics
from ..obs import recorder as obs_recorder
from ..transport.frames import (FrameReader, FrameWriter,
                                FrameSchemaError, TornFrame,
                                TransportError)
from ..utils.locks import OrderedLock
from ..utils.log import get_logger

log = get_logger(__name__)

M_FAILOVERS = obs_metrics.counter(
    "gateway_client_failovers_total",
    "client connection moves to another live frontend (dead endpoint, "
    "half-open connection, or overdue reply), resubmitting unanswered "
    "frames under their original ids")


class GatewayBusy(Exception):
    """The gateway answered ``busy`` — the frame was shed at the credit
    window, nothing was enqueued; retry after backoff."""


class GatewayError(Exception):
    """The gateway answered a typed ``err`` frame."""


class _Slot:
    __slots__ = ("ev", "frame", "payload", "deadline")

    def __init__(self):
        self.ev = threading.Event()
        self.frame = None
        self.payload = None     # (header, arrays) kept for resubmission
        self.deadline = None    # monotonic absolute, pinned at submit


def _open_socket(endpoint: str, timeout_s: float):
    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    sock.settimeout(timeout_s)
    try:
        sock.connect(endpoint)
    except OSError:
        sock.close()
        raise
    return sock


def _close_sock(sock) -> None:
    if sock is None:
        return
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


class DosClient:
    """One logical connection to the gateway tier (see module
    docstring). ``endpoint`` alone preserves the single-endpoint
    shape exactly; ``endpoints`` (several seeds) and/or
    ``registry_dir`` (the ``gateway.json`` directory) arm discovery
    and failover."""

    def __init__(self, endpoint: str | None = None,
                 max_inflight: int | None = None,
                 connect_timeout_s: float = 5.0, *,
                 endpoints=None, registry_dir: str | None = None):
        self.seeds = [e for e in ([endpoint] if endpoint else [])
                      + list(endpoints or []) if e]
        self.registry_dir = registry_dir
        if not self.seeds and not registry_dir:
            raise ValueError("DosClient needs an endpoint, endpoints, "
                             "or a registry_dir to discover from")
        #: this client's identity token — rides every query frame so a
        #: frontend can dedup resubmissions by (cid, id)
        self.cid = uuid.uuid4().hex[:16]
        self.connect_timeout_s = float(connect_timeout_s)
        self._ha = bool(registry_dir) or len(self.seeds) > 1
        # lock order: conn before slots (witness names are per-class)
        self._conn_lock = OrderedLock("gateway.DosClient.conn")
        self._lock = OrderedLock("gateway.DosClient.slots")
        self._sock = None
        self._writer = None
        self._reader = None
        self._gen = 0           # bumps per (re)connect; guards failover
        self._closed = False
        self.endpoint = None
        self.frontend = -1
        self.epoch = 0
        self.diff_epoch = 0
        self.failovers = 0
        #: reply frames with no live waiter — a duplicate answer would
        #: land here, so the chaos drills pin this at zero
        self.unmatched = 0
        candidates = self._candidates()
        if not candidates:
            raise TransportError("gateway discovery found no endpoints "
                                 f"(registry_dir={registry_dir!r})")
        err = None
        for ep in candidates:
            try:
                with self._conn_lock:
                    self._connect_locked(ep)
                err = None
                break
            except (TransportError, TornFrame, FrameSchemaError,
                    OSError) as e:
                err = e
                log.debug("gateway %s unreachable at connect: %s", ep, e)
        if err is not None:
            if len(candidates) == 1:
                raise err     # single-endpoint shape: the real error
            raise TransportError(
                f"no gateway endpoint reachable (tried "
                f"{len(candidates)}): {err}")
        server_credit = self._server_credit
        self.credit = max(1, min(server_credit,
                                 max_inflight or server_credit))
        self._credits = threading.Semaphore(self.credit)
        self._slots: dict[int, _Slot] = {}
        self._next_id = 0       # monotone ACROSS reconnects: (cid, id)
        self._rthread = threading.Thread(
            target=self._read_loop, daemon=True,
            name=f"dos-client-{self.cid[:6]}")
        self._rthread.start()

    # --------------------------------------------------------- discovery
    def _candidates(self, skip: str | None = None) -> list:
        """Live endpoints, discovery order: registry leases (ascending
        fid) then seeds, with the endpoint we just abandoned demoted to
        last resort (it may have respawned under the same path)."""
        eps = live_endpoints(self.registry_dir, seeds=self.seeds)
        out = [e for e in eps if e != skip]
        if skip is not None and skip in eps:
            out.append(skip)
        return out

    def _connect_locked(self, ep: str) -> None:
        """Connect + hello-exchange with ``ep`` and swap it in as the
        live connection (closing the old socket, which wakes a reader
        blocked on it). Caller holds ``_conn_lock``."""
        sock = _open_socket(ep, self.connect_timeout_s)
        reader = FrameReader(sock)
        writer = FrameWriter(sock)
        try:
            hello = reader.read()     # connect timeout still armed
            if hello is None or hello.kind != "hello":
                raise TransportError(f"gateway {ep} sent no hello")
            protocol.check_hello(hello.header)  # gate-newer, tol-older
            writer.send({"kind": "hello",
                         "gv": protocol.GATEWAY_SCHEMA_VERSION,
                         "cid": self.cid})
        except Exception:
            _close_sock(sock)
            raise
        sock.settimeout(None)
        _close_sock(self._sock)
        self._sock, self._writer, self._reader = sock, writer, reader
        self.endpoint = ep
        self.frontend = int(hello.header.get("frontend", -1))
        self.epoch = int(hello.header.get("epoch", 0))
        self.diff_epoch = int(hello.header.get("diff_epoch", 0))
        self._server_credit = int(hello.header.get("credit", 1))

    def _failover(self, dead_gen: int, why: str = "") -> bool:
        """Move to the next live frontend and resubmit unanswered
        frames. ``dead_gen`` is the connection generation the caller
        saw die: if the client already moved on, this is a no-op
        success. False only when NO candidate would take us."""
        with self._conn_lock:
            if self._closed:
                return False
            if self._gen != dead_gen:
                return True       # another thread already moved us
            dead = self.endpoint
            for ep in self._candidates(skip=dead):
                try:
                    self._connect_locked(ep)
                except (TransportError, TornFrame, FrameSchemaError,
                        OSError) as e:
                    log.debug("gateway failover: %s unreachable (%s)",
                              ep, e)
                    continue
                self._gen += 1
                n = self._resubmit_locked()
                self.failovers += 1
                M_FAILOVERS.inc()
                obs_recorder.emit("gateway_failover",
                                  endpoint=str(ep),
                                  from_endpoint=str(dead),
                                  frontend=int(self.frontend),
                                  resubmitted=int(n), why=str(why))
                log.warning("gateway client failed over %s -> %s "
                            "(%d frame(s) resubmitted): %s", dead, ep,
                            n, why)
                return True
            log.warning("gateway client: no live endpoint to fail over "
                        "to from %s: %s", dead, why)
            return False

    def _resubmit_locked(self) -> int:
        """Resend every unanswered in-flight frame on the fresh
        connection, ORIGINAL ids, ``resubmit`` stamped — the server's
        (cid, id) memo replays what it already answered. Caller holds
        ``_conn_lock``; id order is preserved."""
        with self._lock:
            pending = sorted(
                (fid, s) for fid, s in self._slots.items()
                if not s.ev.is_set() and s.payload is not None)
        n = 0
        for _fid, slot in pending:
            header = dict(slot.payload[0])
            header["resubmit"] = True
            try:
                self._writer.send(header, slot.payload[1])
                n += 1
            except (TransportError, OSError) as e:
                # this connection is dying too; the reader notices and
                # the NEXT failover round resubmits the remainder
                log.debug("gateway resubmit stopped mid-way: %s", e)
                break
        return n

    # ----------------------------------------------------------- plumbing
    def _read_loop(self) -> None:
        while True:
            with self._conn_lock:
                gen, reader = self._gen, self._reader
            err: Exception | None = None
            try:
                while True:
                    fr = reader.read()
                    if fr is None:
                        raise TransportError(
                            "gateway closed the connection")
                    self._dispatch(fr)
            except (TransportError, TornFrame, FrameSchemaError,
                    OSError) as e:
                err = e
            if self._closed or not self._failover(gen, why=str(err)):
                if not self._closed:
                    log.debug("gateway client reader down: %s", err)
                break
        self._fail_pending()

    def _dispatch(self, fr) -> None:
        fid = protocol.frame_id(fr)
        with self._lock:
            slot = self._slots.get(fid)
        if slot is None or slot.ev.is_set():
            # unmatched, or the duplicate of an answer that raced a
            # failover resubmission — the first reply won, drop this one
            self.unmatched += 1
            log.debug("gateway client: unmatched frame id %d kind %r",
                      fid, fr.kind)
            return
        slot.frame = fr
        slot.ev.set()
        # the credit returns when the REPLY lands, not when a waiter
        # collects it — a caller that timed out early must not leak
        # its window slot forever
        self._credits.release()

    def _fail_pending(self) -> None:
        with self._lock:
            slots, self._slots = self._slots, {}
        for slot in slots.values():
            if not slot.ev.is_set():
                slot.ev.set()   # frame stays None → TransportError
                self._credits.release()

    def _submit(self, build, timeout: float | None = None,
                deadline_ms=None) -> int:
        """Acquire one credit, send one frame built by ``build(fid)``;
        returns the frame id to :meth:`wait` on. ``deadline_ms`` pins
        the request's total lifetime from NOW."""
        if self._closed:
            raise TransportError("client closed")
        if not self._credits.acquire(timeout=timeout):
            raise GatewayBusy("local credit window exhausted")
        with self._lock:
            fid = self._next_id
            self._next_id += 1
            slot = self._slots[fid] = _Slot()
        if deadline_ms is not None:
            slot.deadline = time.monotonic() + float(deadline_ms) / 1e3
        try:
            header, arrays = build(fid)
            # publish the payload and pick the connection ATOMICALLY:
            # a failover that lands before this block can't see the
            # slot (no payload yet), so we send on the writer it
            # installed; one that lands after resubmits the slot and
            # closes our captured writer, so our own send raises and
            # the gen check below recognises the frame as covered —
            # either way exactly one copy reaches a live frontend
            with self._conn_lock:
                slot.payload = (header, arrays)
                gen, writer = self._gen, self._writer
            try:
                writer.send(header, arrays)
            except (TransportError, OSError) as e:
                # the frame may or may not have left the socket; a
                # successful failover resubmits it either way and the
                # server-side (cid, id) memo absorbs the maybe
                if not self._failover(gen, why=f"submit: {e}"):
                    raise
        except Exception:
            with self._lock:
                self._slots.pop(fid, None)
            self._credits.release()
            raise
        return fid

    def wait(self, fid: int, timeout: float | None = None):
        """Block for frame ``fid``'s reply; returns the decoded frame.
        The wait budget is the SMALLER of ``timeout`` and what remains
        of the request's submit-time deadline — a frame submitted then
        waited-on late does not get a fresh full deadline. Raises
        :class:`GatewayBusy` on a ``busy`` answer,
        :class:`GatewayError` on a typed ``err``, ``TransportError``
        when the connection died with nowhere to fail over to, and
        ``TimeoutError`` past the budget. A timeout on a client WITH
        somewhere else to go (seeds/registry) treats the silent
        connection as half-open — fails over and resubmits — so a
        re-wait can still collect the answer."""
        with self._lock:
            slot = self._slots.get(fid)
        if slot is None:
            raise KeyError(f"no in-flight frame {fid}")
        budget = timeout
        if slot.deadline is not None:
            left = slot.deadline - time.monotonic()
            budget = left if budget is None else min(budget, left)
        if budget is not None:
            budget = max(0.0, budget)   # already-landed replies still
        if not slot.ev.wait(budget):    # return past a spent deadline
            if self._ha and not self._closed:
                with self._conn_lock:
                    gen = self._gen
                self._failover(gen, why=f"reply {fid} overdue")
            raise TimeoutError(f"gateway reply {fid} still pending")
        with self._lock:
            self._slots.pop(fid, None)
        fr = slot.frame
        if fr is None:
            raise TransportError("gateway connection closed mid-flight")
        self.epoch = int(fr.header.get("epoch", self.epoch))
        self.diff_epoch = int(fr.header.get("diff_epoch",
                                            self.diff_epoch))
        if fr.kind == "busy":
            raise GatewayBusy(f"gateway shed frame {fid}")
        if fr.kind == "err":
            raise GatewayError(str(fr.header.get("error", "")))
        return fr

    # ------------------------------------------------------------ submits
    def submit_pairs(self, pairs, deadline_ms=None,
                     timeout: float | None = None) -> int:
        return self._submit(
            lambda fid: protocol.encode_pairs(
                fid, pairs, deadline_ms=deadline_ms,
                epoch=self.epoch, diff_epoch=self.diff_epoch,
                cid=self.cid),
            timeout=timeout, deadline_ms=deadline_ms)

    def submit_rev(self, pairs, deadline_ms=None,
                   timeout: float | None = None) -> int:
        return self._submit(
            lambda fid: protocol.encode_pairs(
                fid, pairs, family="rev", deadline_ms=deadline_ms,
                epoch=self.epoch, diff_epoch=self.diff_epoch,
                cid=self.cid),
            timeout=timeout, deadline_ms=deadline_ms)

    def submit_mat(self, s: int, targets, deadline_ms=None,
                   timeout: float | None = None) -> int:
        return self._submit(
            lambda fid: protocol.encode_mat(
                fid, s, targets, deadline_ms=deadline_ms,
                epoch=self.epoch, diff_epoch=self.diff_epoch,
                cid=self.cid),
            timeout=timeout, deadline_ms=deadline_ms)

    def submit_alt(self, s: int, t: int, k: int, deadline_ms=None,
                   timeout: float | None = None) -> int:
        return self._submit(
            lambda fid: protocol.encode_alt(
                fid, s, t, k, deadline_ms=deadline_ms,
                epoch=self.epoch, diff_epoch=self.diff_epoch,
                cid=self.cid),
            timeout=timeout, deadline_ms=deadline_ms)

    # --------------------------------------------------- sync conveniences
    def query_batch(self, pairs, timeout: float | None = 30.0):
        """``[(status, cost, plen, finished, cached), ...]`` in request
        order — one frame, Q answers."""
        fr = self.wait(self.submit_pairs(pairs, timeout=timeout),
                       timeout=timeout)
        return pair_rows(fr)

    def query(self, s: int, t: int, timeout: float | None = 30.0):
        return self.query_batch([(s, t)], timeout=timeout)[0]

    def reverse_batch(self, pairs, timeout: float | None = 30.0):
        fr = self.wait(self.submit_rev(pairs, timeout=timeout),
                       timeout=timeout)
        return pair_rows(fr)

    def reverse(self, s: int, t: int, timeout: float | None = 30.0):
        return self.reverse_batch([(s, t)], timeout=timeout)[0]

    def matrix(self, s: int, targets, timeout: float | None = 30.0):
        """The MAT row: ``[cost, ...]`` target-ordered, −1 per
        unanswered target. A shed frame raises :class:`GatewayBusy`."""
        fr = self.wait(self.submit_mat(s, targets, timeout=timeout),
                       timeout=timeout)
        _raise_shed(fr)
        return [int(c) for c in fr.arrays[0]]

    def alternatives(self, s: int, t: int, k: int,
                     timeout: float | None = 30.0):
        """``[(cost, via), ...]`` ascending, distinct first edges."""
        fr = self.wait(self.submit_alt(s, t, k, timeout=timeout),
                       timeout=timeout)
        _raise_shed(fr)
        return list(zip((int(c) for c in fr.arrays[0]),
                        (int(v) for v in fr.arrays[1])))

    def ping(self, timeout: float | None = 5.0) -> dict:
        fid = self._submit(lambda fid: ({"kind": "ping", "id": fid,
                                         "cid": self.cid}, []),
                           timeout=timeout)
        return dict(self.wait(fid, timeout=timeout).header)

    def close(self) -> None:
        self._closed = True
        with self._conn_lock:
            _close_sock(self._sock)
        self._rthread.join(timeout=5.0)


def pair_rows(fr):
    statuses = fr.header.get("status") or []
    cached = fr.header.get("cached") or []
    cost, plen, fin = fr.arrays
    return [(statuses[i] if i < len(statuses) else "ERROR",
             int(cost[i]), int(plen[i]), bool(fin[i]),
             bool(cached[i]) if i < len(cached) else False)
            for i in range(len(cost))]


def _raise_shed(fr):
    status = fr.header.get("status")
    if isinstance(status, str) and status != "OK":
        raise GatewayBusy(f"{status}: {fr.header.get('detail', '')}")
