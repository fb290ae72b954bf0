"""The gateway accept loop and the N-replica tier runner.

One :class:`GatewayServer` is one stateless frontend replica facing
clients: a unix-socket accept loop speaking the
:mod:`.protocol` frame vocabulary over the shared
:mod:`..transport.frames` container, in front of ONE
:class:`~..serving.ServingFrontend` (admission, micro-batching,
hedging, breakers, L1 cache — the whole existing head stack). Replicas
share nothing but ``membership.json`` and the diff-epoch spool, both
already safe for concurrent readers, so :class:`GatewayTier` scales the
head horizontally by just running more of them.

Connection protocol: the gateway sends a ``hello`` advertising its
schema version, replica identity, and per-connection credit window.
Query frames past the window answer an explicit ``busy``; malformed
frames answer a typed ``err`` (never a torn connection) and book
``gateway_frames_malformed_total``. Replies drain through one writer
thread per connection in frame-arrival order — the frame ``id`` is the
multiplexing correlate, in-order completion just keeps the writer
trivially serial.

High availability: given a :class:`~.registry.GatewayRegistry`
the server registers its endpoint on start, renews the lease on a
heartbeat thread (a third of ``DOS_GATEWAY_LEASE_S``; the
``lease-freeze`` fault point makes a zombie), and unregisters on a
GRACEFUL stop only — an abrupt death leaves the lease to expire, which
is the detection signal. Replies to ``cid``-tokened query frames are
memoized per ``(cid, id)`` in a bounded ring: a failover client's
resubmission of an already-answered frame replays the stored reply and
books ``gateway_resubmits_deduped_total`` instead of double-booking
requests/queries/caches (exactly-once accounting). A CLEAN client
disconnect (EOF after every reply flushed) proves the client saw its
answers, so that connection's ``cid`` entries are purged from the memo
— only crashed clients (torn frames, reset sockets) leave replay state
behind, which keeps memo occupancy proportional to failures instead of
total traffic. The ``blackhole-conn`` fault point turns one connection
half-open — accepted, read, never answered — the asymmetric-partition
drill.
"""

from __future__ import annotations

import collections
import os
import socket
import threading
import queue
import time

from . import protocol
from .config import GatewayConfig
from ..obs import metrics as obs_metrics
from ..obs import recorder as obs_recorder
from ..testing import faults
from ..transport.frames import (FrameReader, FrameWriter, TornFrame,
                                TransportError)
from ..utils.locks import OrderedLock
from ..utils.log import get_logger

log = get_logger(__name__)

#: bounded reply memo per frontend: (cid, id) -> reply. Sized for many
#: full credit windows of history — a resubmission races the original
#: by seconds, not hours, so recency is the right eviction
DEDUP_MEMO_ENTRIES = 4096

M_REQS = obs_metrics.counter(
    "gateway_requests_total",
    "query frames admitted past the credit window")
M_QUERIES = obs_metrics.counter(
    "gateway_queries_total",
    "individual queries across batched gateway frames")
M_BUSY = obs_metrics.counter(
    "gateway_busy_total",
    "query frames answered BUSY at the credit window")
M_MALFORMED = obs_metrics.counter(
    "gateway_frames_malformed_total",
    "client frames answered a typed err frame (malformed family, bad "
    "payload, or newer schema) — never a torn connection")
G_CLIENTS = obs_metrics.gauge(
    "gateway_clients", "live client connections across local replicas")
M_DEDUP = obs_metrics.counter(
    "gateway_resubmits_deduped_total",
    "resubmitted query frames answered from the (cid, id) reply memo — "
    "counters and cache inserts not double-booked (exactly-once "
    "accounting over at-least-once execution)")
M_FAILOVER_FRAMES = obs_metrics.counter(
    "gateway_failover_frames_total",
    "resubmitted query frames this frontend had NOT answered before — "
    "a client failed over here mid-flight and the frame re-executed")


class GatewayServer:
    """One replica's client-facing accept loop (see module docstring)."""

    def __init__(self, frontend, families=None, fid: int = 0,
                 gconf: GatewayConfig | None = None,
                 socket_path: str | None = None, registry=None):
        self.frontend = frontend
        self.families = families
        self.fid = int(fid)
        self.gconf = gconf or GatewayConfig.from_env()
        self.socket_path = socket_path or self.gconf.socket_of(self.fid)
        self.registry = registry
        self._sock: socket.socket | None = None
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._conns: list[socket.socket] = []
        self._accept_thread: threading.Thread | None = None
        self._hb_thread: threading.Thread | None = None
        self._lease_frozen = False
        self._lease_renewed = 0.0
        # reply memo for resubmission dedup: (cid, id) -> (header,
        # arrays), bounded LRU-by-insertion
        self._dedup: collections.OrderedDict = collections.OrderedDict()
        self._dedup_lock = OrderedLock("gateway.GatewayServer.dedup")
        # plain tallies mutated under the GIL by the conn threads —
        # approximate reads in statusz are fine
        self.clients = 0
        self.served = 0
        self.busy = 0
        self.malformed = 0
        self.failovers = 0
        self.deduped = 0

    # ---------------------------------------------------------- lifecycle
    def start(self) -> "GatewayServer":
        if os.path.exists(self.socket_path):
            os.unlink(self.socket_path)
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.bind(self.socket_path)
        sock.listen(128)
        sock.settimeout(0.25)
        self._sock = sock
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name=f"gateway-f{self.fid}-accept")
        self._accept_thread.start()
        if self.registry is not None:
            self.registry.register(self.fid, self.socket_path)
            self._lease_renewed = time.time()
            self._hb_thread = threading.Thread(
                target=self._heartbeat_loop, daemon=True,
                name=f"gateway-f{self.fid}-lease")
            self._hb_thread.start()
        obs_recorder.emit("gateway_up", frontend=self.fid,
                          endpoint=self.socket_path,
                          credit=self.gconf.credit)
        log.info("gateway frontend %d serving on %s (credit %d)",
                 self.fid, self.socket_path, self.gconf.credit)
        return self

    def stop(self, join_s: float = 5.0, graceful: bool = True) -> None:
        """Drain and stop. ``graceful=False`` is the chaos drills'
        process-death stand-in: the endpoint lease is NOT unregistered,
        so readers watch it expire — exactly what a crashed frontend
        looks like from outside."""
        self._stop.set()
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=join_s)
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=join_s)
            self._hb_thread = None
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
        # sever established connections so blocked conn readers wake:
        # a crash (graceful=False) tears both directions — clients see
        # the socket die mid-conversation, exactly like a dead process;
        # a drain only shuts the READ side, so replies already queued
        # still flush before each conn loop closes its socket
        how = socket.SHUT_RD if graceful else socket.SHUT_RDWR
        for conn in list(self._conns):
            try:
                conn.shutdown(how)
            except OSError:
                pass
        for th in list(self._threads):
            th.join(timeout=join_s)
        if os.path.exists(self.socket_path):
            try:
                os.unlink(self.socket_path)
            except OSError:
                pass
        if graceful and self.registry is not None:
            try:
                self.registry.unregister(self.fid, self.socket_path)
            except (OSError, ValueError) as e:
                log.warning("gateway f%d unregister failed: %s",
                            self.fid, e)
        obs_recorder.emit("gateway_down", frontend=self.fid,
                          endpoint=self.socket_path, served=self.served,
                          graceful=bool(graceful))

    def _heartbeat_loop(self) -> None:
        interval = max(0.05, float(self.registry.lease_s) / 3.0)
        while not self._stop.wait(interval):
            if self._lease_frozen:
                continue
            if faults.inject("lease-freeze", wid=self.fid) is not None:
                # the zombie case: alive and serving, silent in the
                # registry — sticky for the rest of this server's life
                self._lease_frozen = True
                log.warning("gateway f%d lease renewals frozen (fault)",
                            self.fid)
                continue
            try:
                if not self.registry.renew(self.fid, self.socket_path):
                    # our row vanished (registry reset/sweep): reclaim
                    self.registry.register(self.fid, self.socket_path)
                self._lease_renewed = time.time()
            except Exception as e:  # noqa: BLE001 — a wedged registry
                # write must not kill serving; the lease just goes
                # stale and the control loop's sensor notices
                log.warning("gateway f%d lease renewal failed: %s",
                            self.fid, e)

    # ------------------------------------------------------------- serve
    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _addr = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            th = threading.Thread(
                target=self._conn_loop, args=(conn,), daemon=True,
                name=f"gateway-f{self.fid}-conn")
            th.start()
            self._threads.append(th)
            self._conns.append(conn)
            self._threads = [t for t in self._threads if t.is_alive()]
            self._conns = [c for c in self._conns if c.fileno() != -1]

    def _ident(self) -> dict:
        fe = self.frontend
        try:
            epoch = int(fe._membership_epoch())
        except Exception as e:  # noqa: BLE001 — identity is advisory
            log.debug("gateway f%d: membership epoch unreadable: %s",
                      self.fid, e)
            epoch = 0
        return {"frontend": self.fid, "epoch": epoch,
                "diff_epoch": int(getattr(fe, "_diff_epoch", 0))}

    def _conn_loop(self, conn: socket.socket) -> None:
        conn.settimeout(None)
        reader, writer = FrameReader(conn), FrameWriter(conn)
        pending: queue.Queue = queue.Queue()
        inflight = [0]   # mutated by reader, decremented by writer
        conn_state = {"blackholed": False, "cids": set(),
                      "clean_eof": False}
        wt = threading.Thread(
            target=self._writer_loop, args=(writer, pending, inflight),
            daemon=True, name=f"gateway-f{self.fid}-writer")
        self.clients += 1
        G_CLIENTS.add(1)
        try:
            writer.send(protocol.hello_header(
                self.fid, self.gconf.credit,
                **{k: v for k, v in self._ident().items()
                   if k != "frontend"}))
            wt.start()
            while not self._stop.is_set():
                try:
                    fr = reader.read()
                except TornFrame:
                    break        # client died mid-frame; nothing to
                    # answer — the typed-err contract covers frames
                    # that ARRIVED malformed, not half-sent ones
                if fr is None:
                    # clean EOF: the client closed AFTER reading its
                    # replies — its resubmission window is over, so its
                    # memo entries are purged below (crash paths — torn
                    # frames, reset sockets — keep theirs for failover)
                    conn_state["clean_eof"] = True
                    break
                if not self._serve_frame(fr, pending, inflight,
                                         conn_state):
                    break
        except (TransportError, OSError) as e:
            log.debug("gateway f%d connection dropped: %s", self.fid, e)
        finally:
            pending.put(None)
            if wt.is_alive():
                wt.join(timeout=5.0)
            try:
                conn.close()
            except OSError:
                pass
            if conn_state["clean_eof"]:
                # after the writer joined, so replies memoized during
                # the drain are purged too — nothing leaks back in
                self._dedup_purge(conn_state["cids"])
            self.clients -= 1
            G_CLIENTS.add(-1)

    def _writer_loop(self, writer: FrameWriter, pending: queue.Queue,
                     inflight: list) -> None:
        while True:
            item = pending.get()
            if item is None:
                return
            waiter, is_q, dedup_key = item
            try:
                header, arrays = waiter()
            except Exception as e:  # noqa: BLE001 — one bad frame must
                # not wedge the writer; answer it typed and move on
                log.warning("gateway f%d reply build failed: %s",
                            self.fid, e)
                header, arrays = protocol.error_frame(
                    -1, f"internal: {e}", **self._ident())
            if dedup_key is not None and header.get("kind") == "r":
                # memoize BEFORE the send: a client that dies mid-reply
                # resubmits, and the replay must cover exactly the
                # frames whose accounting already booked
                self._dedup_put(dedup_key, (header, arrays))
            try:
                writer.send(header, arrays)
            except (TransportError, OSError):
                return           # client is gone; reader will see EOF
            finally:
                if is_q:
                    inflight[0] -= 1
                    self.served += 1

    def _dedup_put(self, key, reply) -> None:
        with self._dedup_lock:
            self._dedup[key] = reply
            self._dedup.move_to_end(key)
            while len(self._dedup) > DEDUP_MEMO_ENTRIES:
                self._dedup.popitem(last=False)

    def _dedup_get(self, key):
        with self._dedup_lock:
            return self._dedup.get(key)

    def _dedup_purge(self, cids) -> None:
        """Drop every memo entry belonging to ``cids`` (a cleanly
        disconnected client cannot resubmit, so its replay state is
        dead weight crowding the bounded ring)."""
        if not cids:
            return
        with self._dedup_lock:
            stale = [k for k in self._dedup if k[0] in cids]
            for k in stale:
                del self._dedup[k]

    def _serve_frame(self, fr, pending: queue.Queue, inflight: list,
                     conn_state: dict) -> bool:
        """Dispatch one client frame; False ends the connection (only
        the schema gate does — malformed frames answer typed)."""
        if conn_state["blackholed"] or faults.inject(
                "blackhole-conn", wid=self.fid) is not None:
            # half-open partition: the socket stays accepted and
            # readable (the client's sends succeed) but nothing is
            # served or answered, sticky for the connection's life —
            # the client only learns via its own deadline + failover
            conn_state["blackholed"] = True
            return True
        ident = self._ident()
        if fr.kind == "hello":
            try:
                protocol.check_hello(fr.header)
            except protocol.GatewaySchemaError as e:
                M_MALFORMED.inc()
                self.malformed += 1
                detail = str(e)
                fid = protocol.frame_id(fr)
                pending.put((lambda: protocol.error_frame(
                    fid, detail, **ident), False, None))
                return False     # gate-newer: refuse service cleanly
            return True
        if fr.kind == "ping":
            h = dict(ident)
            h.update(kind="health", id=protocol.frame_id(fr),
                     ok=True, clients=self.clients, served=self.served)
            pending.put((lambda: (h, []), False, None))
            return True
        if fr.kind != "q":
            # unknown kinds are the receiver's to skip (the container
            # contract) — an older gateway ignores a newer client's
            # optional extras rather than erroring them
            log.debug("gateway f%d skipping unknown frame kind %r",
                      self.fid, fr.kind)
            return True
        fid = protocol.frame_id(fr)
        cid = protocol.frame_cid(fr)
        dedup_key = (cid, fid) if cid is not None else None
        if cid is not None:
            conn_state["cids"].add(cid)
        if dedup_key is not None:
            replay = self._dedup_get(dedup_key)
            if replay is not None:
                # already answered this logical request: replay the
                # memoized reply — no request/query counters, no
                # frontend submit, no cache inserts (exactly-once
                # accounting; the client just never saw the answer)
                M_DEDUP.inc()
                self.deduped += 1
                pending.put((lambda r=replay: r, False, None))
                return True
            if fr.header.get("resubmit"):
                # a failover arrival this frontend never answered:
                # executes normally (answers are deterministic), but
                # book the failover so the tier's HA columns show it
                M_FAILOVER_FRAMES.inc()
                self.failovers += 1
        if inflight[0] >= self.gconf.credit:
            M_BUSY.inc()
            self.busy += 1
            pending.put((lambda: protocol.busy_frame(fid, **ident),
                         False, None))
            return True
        try:
            family, payload = protocol.parse_query_frame(fr)
        except protocol.GatewayProtocolError as e:
            M_MALFORMED.inc()
            self.malformed += 1
            detail = str(e)
            pending.put((lambda: protocol.error_frame(
                fid, detail, **ident), False, None))
            return True
        M_REQS.inc()
        inflight[0] += 1
        deadline_s = self._deadline_s(fr.header)
        pending.put((self._submit(fid, family, payload, deadline_s),
                     True, dedup_key))
        return True

    def _deadline_s(self, header: dict) -> float:
        dl = header.get("deadline_ms")
        if isinstance(dl, (int, float)) and dl > 0:
            return min(float(dl), self.gconf.deadline_ms) / 1e3
        return self.gconf.deadline_s

    # ------------------------------------------------------- family plumb
    def _submit(self, fid: int, family: str, payload, deadline_s: float):
        """Submit NOW (on the reader thread — admission and routing are
        non-blocking), return the waiter the writer thread blocks on."""
        ident = self._ident()
        if family == "pair":
            M_QUERIES.inc(len(payload))
            futs = [self.frontend.submit(int(s), int(t))
                    for s, t in payload]
            pairs = [(int(s), int(t)) for s, t in payload]

            def wait_pairs():
                rows = _drain(futs, pairs, deadline_s)
                return protocol.reply_pairs(fid, "pair", rows, **ident)

            return wait_pairs
        # the typed families ride QueryFamilies.submit_line so they
        # inherit the brownout shed exactly like the line protocol
        fam = self.families
        if fam is None:
            def no_families():
                return protocol.reply_shed(
                    fid, family, "ERROR", "family-not-served", **ident)
            return no_families
        if family == "rev":
            M_QUERIES.inc(len(payload))
            futs, pairs = [], []
            for s, t in payload:
                futs.append(fam.submit_line("rev", (int(s), int(t))))
                pairs.append((int(s), int(t)))

            def wait_rev():
                rows = _drain_rev(futs, pairs, deadline_s)
                return protocol.reply_pairs(fid, "rev", rows, **ident)

            return wait_rev
        if family == "mat":
            s, targets = payload
            M_QUERIES.inc(len(targets))
            fut = fam.submit_line("mat", (int(s), [int(t)
                                                   for t in targets]))

            def wait_mat():
                res = _family_result(fut, deadline_s)
                if not hasattr(res, "costs"):   # shed/errored
                    return protocol.reply_shed(
                        fid, "mat", getattr(res, "status", "ERROR"),
                        getattr(res, "detail", ""), **ident)
                return protocol.reply_mat(fid, s, res.costs, **ident)

            return wait_mat
        # alt
        s, t, k = payload
        M_QUERIES.inc()
        fut = fam.submit_line("alt", (int(s), int(t), int(k)))

        def wait_alt():
            res = _family_result(fut, deadline_s)
            if not hasattr(res, "alternatives"):
                return protocol.reply_shed(
                    fid, "alt", getattr(res, "status", "ERROR"),
                    getattr(res, "detail", ""), **ident)
            return protocol.reply_alt(fid, s, t, res.alternatives,
                                      **ident)

        return wait_alt

    # --------------------------------------------------------------- obs
    def statusz(self) -> dict:
        fe_cache = getattr(self.frontend, "cache", None)
        out = {
            "frontend": self.fid,
            "endpoint": self.socket_path,
            "credit": self.gconf.credit,
            "clients": int(self.clients),
            "served": int(self.served),
            "busy": int(self.busy),
            "malformed": int(self.malformed),
            "failovers": int(self.failovers),
            "resubmits_deduped": int(self.deduped),
            "memo": {"entries": len(self._dedup),
                     "cap": DEDUP_MEMO_ENTRIES},
        }
        if self.registry is not None:
            out["lease"] = {
                "lease_s": float(self.registry.lease_s),
                "age_s": round(max(0.0, time.time()
                                   - self._lease_renewed), 3),
                "frozen": bool(self._lease_frozen),
            }
        if fe_cache is not None:
            out["l1_hits"] = int(fe_cache.hits)
            out["l1_misses"] = int(fe_cache.misses)
            out["l1_hit_rate"] = round(fe_cache.hit_rate(), 4)
        return out


def _drain(futs, pairs, deadline_s: float):
    """In-order pair results with ONE deadline budgeted across the
    frame (a stuck shard costs the frame one deadline, not one per
    row) — TimeoutError rows degrade to typed TIMEOUT results."""
    from ..serving.request import TIMEOUT, ServeResult

    end = time.monotonic() + deadline_s
    rows = []
    for fut, (s, t) in zip(futs, pairs):
        try:
            rows.append(fut.result(max(0.0, end - time.monotonic())))
        except TimeoutError:
            rows.append(ServeResult(TIMEOUT, s, t,
                                    detail="gateway-deadline"))
    return rows


def _drain_rev(futs, pairs, deadline_s: float):
    """Rev rows: unwrap each CompositeFuture's ReverseResult back to
    the underlying pair ServeResult (labeled with the ORIGINAL s, t the
    client asked about, like the REV sentence)."""
    from ..serving.request import TIMEOUT, ServeResult

    end = time.monotonic() + deadline_s
    rows = []
    for fut, (s, t) in zip(futs, pairs):
        try:
            res = fut.result(max(0.0, end - time.monotonic()))
        except TimeoutError:
            rows.append(ServeResult(TIMEOUT, s, t,
                                    detail="gateway-deadline"))
            continue
        inner = getattr(res, "result", res)   # ReverseResult | shed
        rows.append(ServeResult(
            inner.status, s, t, cost=int(inner.cost),
            plen=int(inner.plen), finished=bool(inner.finished),
            cached=bool(inner.cached), detail=inner.detail))
    return rows


def _family_result(fut, deadline_s: float):
    from ..serving.request import TIMEOUT, ServeResult

    try:
        return fut.result(deadline_s)
    except TimeoutError:
        return ServeResult(TIMEOUT, -1, -1, detail="gateway-deadline")


class GatewayTier:
    """N replicas under one roof: builds a :class:`GatewayServer` per
    ``(frontend, families)`` pair and aggregates their ``/statusz``
    into the ``gateway`` section ``dos-obs top`` renders. Replicas are
    independent — one replica's death leaves the others serving (the
    kill-one-frontend drill pins this)."""

    def __init__(self, replicas, gconf: GatewayConfig | None = None,
                 socket_paths=None, registry=None, fid_base: int = 0):
        self.gconf = gconf or GatewayConfig.from_env()
        self.registry = registry
        self.servers: list[GatewayServer] = []
        for i, (frontend, families) in enumerate(replicas):
            fid = int(fid_base) + i
            path = (socket_paths[i] if socket_paths is not None
                    else self.gconf.socket_of(fid))
            self.servers.append(GatewayServer(
                frontend, families=families, fid=fid, gconf=self.gconf,
                socket_path=path, registry=registry))

    @property
    def endpoints(self) -> list:
        return [srv.socket_path for srv in self.servers]

    def start(self) -> "GatewayTier":
        for srv in self.servers:
            srv.start()
        return self

    def stop(self, join_s: float = 5.0) -> None:
        for srv in self.servers:
            srv.stop(join_s=join_s)

    def statusz(self) -> dict:
        fes = {str(srv.fid): srv.statusz() for srv in self.servers}
        hits = sum(int(st.get("l1_hits", 0)) for st in fes.values())
        misses = sum(int(st.get("l1_misses", 0)) for st in fes.values())
        total = hits + misses
        out = {
            "replicas": len(self.servers),
            "clients": sum(int(st.get("clients", 0))
                           for st in fes.values()),
            "l1_hit_rate": round(hits / total, 4) if total else 0.0,
            "failovers": sum(int(st.get("failovers", 0))
                             for st in fes.values()),
            "resubmits_deduped": sum(
                int(st.get("resubmits_deduped", 0))
                for st in fes.values()),
            "frontends": fes,
        }
        if self.registry is not None:
            try:
                # peers counts the whole fleet (every --join process),
                # not just this process's replicas
                out["peers"] = len(self.registry.live())
            except Exception as e:  # noqa: BLE001 — status is advisory
                log.debug("gateway tier: registry read failed: %s", e)
            ages = [st["lease"]["age_s"] for st in fes.values()
                    if isinstance(st.get("lease"), dict)]
            if ages:
                out["lease_age_s"] = max(ages)
        return out
