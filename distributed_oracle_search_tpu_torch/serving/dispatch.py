"""Shard backends for the serving frontend.

A dispatcher answers one shard's batch:
``answer_batch(wid, queries [Q, 2], rconf, diff) -> (cost, plen,
finished)`` with each output aligned to ``queries``. Failures raise
:class:`DispatchError` (or anything else) — the frontend turns that
into per-request ``ERROR`` results and a circuit-breaker failure
record.

* :class:`EngineDispatcher` — in-process: one
  :class:`~..worker.engine.ShardEngine` per shard, built lazily on the
  shard's first batch on the dispatcher's ``device`` (None → ``cuda``,
  raising without a GPU unless ``"cpu"``: on the card every batch is
  walked by the hand kernel), and optionally building missing CPD shard
  files on the spot with the build kernels (K1/K2), which is what lets
  ``dos-serve --test`` run from a bare checkout.
* :class:`FifoDispatcher` — the campaign wire against resident
  ``worker.server`` processes: per-batch query file into the shared
  dir, request through the command FIFO via
  ``transport.send_with_retry`` (capped-backoff retries, per-attempt
  answer FIFOs), and per-query answers read back from the
  ``<queryfile>.results`` sidecar (``RuntimeConfig.results`` wire
  extension).
* :class:`RpcDispatcher` — the streaming data plane
  (``DOS_TRANSPORT=rpc``): one persistent multiplexed socket per
  worker (``transport.rpc``), queries and per-query answers riding as
  raw ndarray frame segments — no files, no FIFO rendezvous, no
  text parse on the hot path.
* :class:`AutoDispatcher` — ``DOS_TRANSPORT=auto``: RPC first, with a
  sticky per-lane fallback to the FIFO wire when a worker has no RPC
  listener (mixed fleets mid-rollout).
* :class:`CallableDispatcher` — adapter for tests and the bench's
  resident-oracle serving mode.

A copy of the JAX package's ``serving/dispatch.py``; only
:class:`EngineDispatcher` differs, by its ``device``.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import time
import zlib

import numpy as np

from ..integrity.fingerprint import (
    FingerprintError, M_FP_MISMATCH, answer_fingerprint,
)
from ..obs import metrics as obs_metrics
from ..parallel.partition import DistributionController
from ..testing import faults
from ..transport import fifo as fifo_transport
from ..transport import rpc as rpc_transport
from ..transport.fifo import answer_fifo_path, command_fifo_path
from ..transport.frames import TransportError
from ..transport.wire import (
    Request, RuntimeConfig, paths_file_for, read_paths_file,
    read_results_file, results_file_for, write_query_file,
)
from ..utils.config import ClusterConfig
from ..utils.locks import OrderedLock
from ..utils.log import get_logger

log = get_logger(__name__)

M_HEDGE_QFILE_REUSED = obs_metrics.counter(
    "serve_hedge_qfile_reused_total",
    "hedged FIFO dispatches that reused the primary attempt's already-"
    "written query file instead of paying a second filesystem write")
H_RPC_DISPATCH = obs_metrics.histogram(
    "rpc_dispatch_seconds",
    "one serving batch over the socket transport, send to decoded "
    "reply (the RPC twin of the FIFO lane inside "
    "serve_dispatch_seconds)")


class DispatchError(RuntimeError):
    """A shard batch could not be answered."""


class RpcUnavailableError(DispatchError):
    """The worker has no reachable RPC listener (connect refused /
    socket absent) — the ``auto`` transport's FIFO-fallback signal, as
    opposed to a worker that answered and failed."""


def _fp_guard(wid: int, cost, plen, fin, rconf):
    """In-process twin of the wire fingerprint check: fingerprint the
    answers the engine just returned, run them past the
    ``corrupt-answer`` fault point (the only way bytes can rot between
    an in-process engine and its caller is injection), and re-verify.
    A mismatch raises :class:`DispatchError` so the frontend's failover
    machinery retries — a corrupted answer is never handed up. No-op
    unless ``rconf.answer_fp``."""
    if not getattr(rconf, "answer_fp", False):
        return cost, plen, fin
    fp = answer_fingerprint(cost, plen, fin)
    if faults.inject("corrupt-answer", wid) is not None:
        cost = np.array(cost, np.int64, copy=True)
        if len(cost):
            cost[0] ^= 1
    if answer_fingerprint(cost, plen, fin) != fp:
        M_FP_MISMATCH.inc()
        raise DispatchError(
            f"shard {wid}: answer fingerprint mismatch on the "
            "in-process lane — corrupted answer suppressed")
    return cost, plen, fin


class EngineDispatcher:
    """In-process shard engines (the ``--backend inproc`` serving path
    and the smoke-test harness).

    ``answer_batch``'s ``via`` routes the batch through a REPLICA
    host's engine (failover off an open breaker, or the hedge's
    duplicate): engines are keyed ``(shard, via)`` so the primary's and
    each replica's row sets load independently — with ``build_missing``
    (the ``--test`` path) a missing replica block set is materialized
    lazily on first use (copied from the primary when it exists,
    recomputed otherwise), so R=2 serve tests need no pre-build step."""

    def __init__(self, conf: ClusterConfig, graph=None,
                 dc: DistributionController | None = None,
                 alg: str = "table-search", build_missing: bool = False,
                 build_chunk: int = 512, device=None):
        from ..data.graph import Graph
        from ..utils.device import resolve_device

        #: every engine (and every missing shard's build) lives here
        self.device = resolve_device(device)
        self.conf = conf
        self.graph = graph if graph is not None else Graph.from_xy(
            conf.xy_file)
        self.dc = dc if dc is not None else DistributionController(
            conf.partmethod, conf.partkey, conf.maxworker, self.graph.n,
            replication=conf.effective_replication())
        self.alg = alg
        self.build_missing = build_missing
        self.build_chunk = build_chunk
        self._engines: dict[tuple, object] = {}
        #: per-(shard, via) lane serialization: an ABANDONED hedge
        #: loser's thread can still be inside ``eng.answer`` when the
        #: batcher dispatches the next batch to the same lane — without
        #: the lane lock the loser's late return overwrites
        #: ``last_paths`` under the next batch's read and scoped
        #: invalidation re-keys entries with another batch's signatures
        self._lane_locks: dict[tuple, OrderedLock] = {}
        self._lock = OrderedLock("serving.EngineDispatcher")

    def _build_missing_shard(self, shard: int, replica: int) -> None:
        from ..models.cpd import (
            build_worker_shard, copy_replica_blocks,
        )

        log.info("no CPD %s for shard %d in %s; building in-process",
                 f"replica r{replica}" if replica else "shard", shard,
                 self.conf.outdir)
        os.makedirs(self.conf.outdir, exist_ok=True)
        if replica:
            copy_replica_blocks(self.dc, shard, replica,
                                self.conf.outdir)
        build_worker_shard(self.graph, self.dc, shard, self.conf.outdir,
                           chunk=self.build_chunk, replica=replica,
                           device=self.device)

    def _rank_for(self, wid: int, via: int) -> int:
        """Which block set lane ``(wid, via)`` serves from: the via
        worker's rank in the shard's replica chain — or the PRIMARY set
        when ``via`` is outside the chain (a membership-migration
        adopter answering dual-read traffic before its epoch commits,
        or after a commit reassigned ownership off-chain)."""
        if via == wid:
            return 0
        try:
            return self.dc.replica_rank(wid, via)
        except ValueError:
            return 0

    def _engine_for(self, wid: int, via: int | None = None):
        from ..worker.engine import ShardEngine

        via = wid if via is None else int(via)
        rank = self._rank_for(wid, via)
        with self._lock:
            eng = self._engines.get((wid, via))
            if eng is None:
                try:
                    eng = ShardEngine(self.graph, self.dc, via,
                                      self.conf.outdir, alg=self.alg,
                                      shard=wid, replica=rank,
                                      device=self.device)
                except (FileNotFoundError, ValueError):
                    # ValueError covers a PARTIAL block set (a killed
                    # lazy build left some blocks; the row count fails
                    # the partition check): the resumed build below
                    # recomputes exactly the missing tail. A genuine
                    # partition mismatch rebuilds to the same mismatch
                    # and the retry's raise propagates it.
                    if not self.build_missing:
                        raise
                    self._build_missing_shard(wid, rank)
                    eng = ShardEngine(self.graph, self.dc, via,
                                      self.conf.outdir, alg=self.alg,
                                      shard=wid, replica=rank,
                                      device=self.device)
                self._engines[(wid, via)] = eng
            return eng

    def _lane(self, wid: int, via: int | None):
        """The lane's engine plus its serialization lock."""
        via = wid if via is None else int(via)
        eng = self._engine_for(wid, via)
        with self._lock:
            lock = self._lane_locks.setdefault(
                (wid, via), OrderedLock("serving.EngineDispatcher.lane"))
        return eng, lock

    def answer_batch(self, wid: int, queries: np.ndarray,
                     rconf: RuntimeConfig, diff: str,
                     via: int | None = None):
        eng, lane = self._lane(wid, via)
        with lane:
            cost, plen, fin, _stats = eng.answer(queries, rconf, diff)
        return _fp_guard(wid, cost, plen, fin, rconf)

    def answer_batch_paths(self, wid: int, queries: np.ndarray,
                           rconf: RuntimeConfig, diff: str,
                           via: int | None = None):
        """``answer_batch`` plus the batch's path prefixes — the
        live-traffic frontend sets ``rconf.sig_k`` and keys scoped cache
        invalidation off them. Returns ``(cost, plen, fin, nodes,
        moves)``; the path halves are ``None`` when the engine captured
        none. The lane lock covers the answer AND the ``last_paths``
        read: the frontend keeps one batch in flight per lane, but an
        ABANDONED hedge loser is still running on its lane when the
        winner returns — without the lock its late return could
        overwrite ``last_paths`` under this batch's read."""
        eng, lane = self._lane(wid, via)
        with lane:
            cost, plen, fin, _stats = eng.answer(queries, rconf, diff)
            nodes, moves = eng.last_paths or (None, None)
        cost, plen, fin = _fp_guard(wid, cost, plen, fin, rconf)
        return cost, plen, fin, nodes, moves


class FifoDispatcher:
    """Wire dispatch to resident workers. Every batch gets UNIQUE
    ``query.serve.*`` / answer-FIFO names (pid + per-shard sequence):
    a timed-out batch's request stays queued in the worker's command
    FIFO with no way to cancel it, and its late ``.results`` write must
    land in that batch's own file — never be mistaken for (or tear the
    bytes of) a newer batch's sidecar. The previous batch's files are
    swept on the shard's next dispatch (one batch in flight per shard,
    so by then the old reply either landed or lost). Serving answer
    FIFOs stay disjoint from campaign ones (``answer.<host><wid>``) so
    a campaign sharing the nfs dir cannot cross replies with the
    frontend."""

    def __init__(self, conf: ClusterConfig,
                 timeout: float | None = None,
                 policy: fifo_transport.RetryPolicy | None = None,
                 host_of=None):
        self.conf = conf
        self.timeout = (timeout if timeout is not None
                        else fifo_transport.DEFAULT_TIMEOUT)
        self.policy = policy
        #: worker id -> ssh host. The default reads the conf's static
        #: roster (wrapping for ids past it — an elastic JOIN mints
        #: worker ids the conf never listed); a membership-aware caller
        #: passes the live roster resolver
        #: (``MembershipController.host_of``) instead.
        self.host_of = host_of or (
            lambda via: self.conf.workers[via % len(self.conf.workers)])
        self._seq = itertools.count()
        #: per dispatch lane ((shard, via) pair): the previous batch's
        #: query file and answer-FIFO base, swept on the lane's next
        #: dispatch / at close
        self._prev: dict[tuple, tuple[str, str]] = {}
        #: one mutex per lane: hedged dispatch broke the frontend's
        #: one-batch-per-shard invariant for THIS layer (a losing
        #: primary attempt can still be in flight when the runner
        #: thread dispatches the shard's next batch on the same lane),
        #: and the next batch's _sweep_prev must not unlink the loser's
        #: in-flight query file / answer FIFOs. The worker's command
        #: FIFO serializes same-worker batches anyway, so the lock adds
        #: ordering, not latency.
        self._lane_locks: dict[tuple, OrderedLock] = {}
        self._locks_guard = OrderedLock("serving.FifoDispatcher.guard")
        #: live shared query files keyed by batch content digest: a
        #: HEDGE duplicate dispatches the same (shard, queries, diff)
        #: while the primary attempt is still in flight — it reuses the
        #: primary's already-written query file instead of paying a
        #: second filesystem round-trip per candidate (ROADMAP item 3
        #: callout). Entry = ``[qfile, refs, orphaned, qbytes]``:
        #: refcounted so a LATER identical batch (skewed repeats)
        #: writes fresh (reuse is scoped to overlapping duplicates);
        #: ``qbytes`` is compared on every hit so a crc32 collision
        #: can never alias two different batches onto one file; and
        #: ``orphaned`` marks a file whose writer lane moved on while
        #: a reuser was still in flight — the LAST reference unlinks
        #: it instead of the writer's sweep.
        self._shared_q: dict[tuple, list] = {}

    def _lane_lock(self, lane: tuple) -> OrderedLock:
        with self._locks_guard:
            lock = self._lane_locks.get(lane)
            if lock is None:
                lock = self._lane_locks[lane] = OrderedLock(
                    "serving.FifoDispatcher.lane")
            return lock

    def _sweep_prev(self, lane: tuple) -> None:
        prev = self._prev.pop(lane, None)
        if not prev:
            return
        import glob as _glob
        import stat as _stat

        qfile, answer_base = prev
        if qfile:       # a hedge lane that REUSED the primary's query
            # file books (None, fifos): only the writer lane sweeps it
            with self._locks_guard:
                live = next((e for e in self._shared_q.values()
                             if e[0] == qfile and e[1] > 0), None)
                if live is not None:
                    # a hedge duplicate on ANOTHER lane still has this
                    # file in flight: defer the unlink to the last
                    # reference's release instead of tearing the
                    # in-flight attempt's read
                    live[2] = True
                    qfile = None
        if qfile:
            self._unlink_batch_files(qfile)
        # the per-attempt answer FIFOs (<base>.a<n>) are normally
        # removed by the transfer script's own `rm -f`; a script killed
        # on timeout never gets there, and an orphaned FIFO on the
        # shared dir outlives the service. Only FIFOs are touched.
        for p in _glob.glob(answer_base + ".a*"):
            try:
                if _stat.S_ISFIFO(os.stat(p).st_mode):
                    os.remove(p)
            except OSError:
                pass

    @staticmethod
    def _unlink_batch_files(qfile: str) -> None:
        for p in (qfile, results_file_for(qfile), paths_file_for(qfile)):
            try:
                os.remove(p)
            except OSError:
                pass

    def close(self) -> None:
        """Sweep every lane's last batch files — query file,
        ``.results`` sidecar AND any per-attempt ``answer.*`` FIFOs a
        timed-out transfer script orphaned (called by
        ``ServingFrontend.stop``; without it the FINAL batch's debris
        would outlive the service on the shared nfs dir). Lane locks
        are taken best-effort: a loser attempt still in flight at
        shutdown must not stall the stop for its full wire timeout."""
        for lane in list(self._prev):
            lock = self._lane_lock(lane)
            got = lock.acquire(timeout=2.0)
            try:
                self._sweep_prev(lane)
            finally:
                if got:
                    lock.release()

    def answer_batch(self, wid: int, queries: np.ndarray,
                     rconf: RuntimeConfig, diff: str,
                     via: int | None = None):
        return self._dispatch(wid, queries, rconf, diff, via,
                              want_paths=False)

    def answer_batch_paths(self, wid: int, queries: np.ndarray,
                           rconf: RuntimeConfig, diff: str,
                           via: int | None = None):
        """Wire twin of :meth:`EngineDispatcher.answer_batch_paths`:
        when ``rconf.sig_k`` (or ``extract``) made the server write a
        ``.paths`` sidecar, read it back next to the ``.results`` one.
        An old server that filtered the unknown key ships no sidecar —
        the path halves come back ``None`` and the cache degrades to
        conservative invalidation, never an error."""
        return self._dispatch(wid, queries, rconf, diff, via,
                              want_paths=True)

    def _dispatch(self, wid: int, queries: np.ndarray,
                  rconf: RuntimeConfig, diff: str,
                  via: int | None, want_paths: bool):
        via = wid if via is None else int(via)
        host = self.host_of(via)
        nfs = self.conf.nfs
        lane = (wid, via)
        qbytes = np.ascontiguousarray(queries, np.int64).tobytes()
        qkey = (wid, len(queries), zlib.crc32(qbytes), diff)
        with self._lane_lock(lane):
            self._sweep_prev(lane)
            tag = f"{os.getpid()}.{next(self._seq)}"
            answer_base = (answer_fifo_path(nfs, host, via)
                           + f".serve.{tag}")
            with self._locks_guard:
                shared = self._shared_q.get(qkey)
                # content check, not just the crc key: a 32-bit
                # collision must degrade to a fresh write, never alias
                # another batch's queries onto this dispatch
                if shared is not None and shared[3] == qbytes:
                    shared[1] += 1
                else:
                    shared = None
            if shared is not None:
                # a concurrent duplicate of this exact batch (the hedge
                # lane) — the primary's query file is still live on the
                # shared dir; reuse it and sweep only our own FIFOs
                qfile = shared[0]
                self._prev[lane] = (None, answer_base)
                M_HEDGE_QFILE_REUSED.inc()
            else:
                qfile = os.path.join(nfs,
                                     f"query.serve.{host}{via}.{tag}")
                self._prev[lane] = (qfile, answer_base)
                write_query_file(qfile, queries)
                with self._locks_guard:
                    self._shared_q[qkey] = [qfile, 1, False, qbytes]
            req = Request(
                dataclasses.replace(rconf, results=True), qfile,
                answer_base, diff)
            try:
                # dos-lint: disable=lock-scope -- holding the lane lock
                #   across the wire send is the invariant, not an
                #   accident: the lock exists to serialize same-lane
                #   batches so the next batch's _sweep_prev can't
                #   unlink THIS batch's in-flight files; the worker's
                #   command FIFO serializes same-worker sends anyway,
                #   so it adds ordering, not wait
                row = fifo_transport.send_with_retry(
                    host, req, command_fifo_path(via),
                    timeout=self.timeout, policy=self.policy, wid=via)
                if not row.ok:
                    detail = (
                        " (STALE_DIFF: worker behind the diff stream)"
                        if row.stale_diff else
                        " (STALE_EPOCH: worker behind the partition "
                        "table)" if row.stale_epoch else "")
                    raise DispatchError(
                        f"worker {via} on {host} failed a serving "
                        f"batch ({len(queries)} queries for shard "
                        f"{wid})" + detail)
                try:
                    cost, plen, fin = read_results_file(
                        results_file_for(qfile))
                except FingerprintError as e:
                    # the sidecar EXISTS but its answer bytes failed
                    # the crc32 check — a data fault, not a version
                    # skew; fail over without the legacy-server hint
                    raise DispatchError(
                        f"worker {via} on {host} returned a corrupted "
                        f"results sidecar: {e}") from e
                except (OSError, ValueError) as e:
                    # an old server (pre-`results` wire key) answers
                    # the stats line but writes no sidecar — a hard
                    # error here, not a silent all-zeros answer
                    raise DispatchError(
                        f"worker {via} on {host} returned no results "
                        f"sidecar (server predates the wire "
                        f"extension?): {e}") from e
                if len(cost) != len(queries):
                    raise DispatchError(
                        f"worker {via} results length {len(cost)} != "
                        f"batch {len(queries)}")
                if not want_paths:
                    return cost, plen, fin
                nodes = moves = None
                try:
                    nodes, moves = read_paths_file(
                        paths_file_for(qfile))
                except (OSError, ValueError):
                    pass   # old server / no extraction: signature-less
                return cost, plen, fin, nodes, moves
            finally:
                # this attempt no longer pins the shared query file; a
                # LATER identical batch must write its own. The file
                # itself is swept by the writer lane's next dispatch —
                # unless that sweep already came and went while a
                # reuser was in flight (orphaned): then the LAST
                # reference unlinks it here
                cleanup = None
                with self._locks_guard:
                    ent = self._shared_q.get(qkey)
                    if ent is not None and ent[0] == qfile:
                        ent[1] -= 1
                        if ent[1] <= 0:
                            self._shared_q.pop(qkey, None)
                            if ent[2]:
                                cleanup = ent[0]
                if cleanup:
                    self._unlink_batch_files(cleanup)


class RpcDispatcher:
    """The streaming data plane: one persistent, multiplexed socket per
    worker (``transport.rpc``), frames instead of files.

    Queries ship as a raw int64 payload segment, per-query answers come
    back as cost/plen/fin segments in the correlated reply frame, and
    path prefixes (``rconf.sig_k``) ride two more segments — the FIFO
    lane's query file, ``.results`` sidecar, ``.paths`` sidecar, and
    both blocking FIFO rendezvous all disappear from the hot path.
    Transport failures (dead socket, torn frame, timeout) and explicit
    ``busy`` backpressure frames raise :class:`DispatchError` flavors
    the frontend already treats as breaker failures + failover; a
    worker with no listener at all raises
    :class:`RpcUnavailableError` (the ``auto`` fallback signal)."""

    def __init__(self, conf: ClusterConfig,
                 timeout: float | None = None, host_of=None):
        self.conf = conf
        #: None = defer to DOS_RPC_TIMEOUT_S (resolved inside RpcClient)
        self.timeout = timeout
        self.host_of = host_of or (
            lambda via: self.conf.workers[via % len(self.conf.workers)])
        self._clients: dict[int, rpc_transport.RpcClient] = {}
        self._guard = OrderedLock("serving.RpcDispatcher")

    def _client(self, via: int) -> rpc_transport.RpcClient:
        # the endpoint is re-resolved on EVERY dispatch (the
        # FifoDispatcher host_of contract): a live-membership host
        # change retires the stale client and dials the worker's new
        # home instead of flapping on the dead one forever
        ep = rpc_transport.endpoint_for(via, host=self.host_of(via))
        stale = None
        with self._guard:
            c = self._clients.get(via)
            if c is not None and c.endpoint != ep:
                stale, c = c, None
            if c is None:
                c = self._clients[via] = rpc_transport.RpcClient(
                    ep, timeout_s=self.timeout)
        if stale is not None:
            log.info("worker %d rpc endpoint moved %s -> %s; "
                     "reconnecting", via,
                     rpc_transport.endpoint_str(stale.endpoint),
                     rpc_transport.endpoint_str(ep))
            stale.close(join_s=1.0)
        return c

    def answer_batch(self, wid: int, queries: np.ndarray,
                     rconf: RuntimeConfig, diff: str,
                     via: int | None = None):
        return self._dispatch(wid, queries, rconf, diff, via,
                              want_paths=False)

    def answer_batch_paths(self, wid: int, queries: np.ndarray,
                           rconf: RuntimeConfig, diff: str,
                           via: int | None = None):
        return self._dispatch(wid, queries, rconf, diff, via,
                              want_paths=True)

    def _dispatch(self, wid: int, queries: np.ndarray,
                  rconf: RuntimeConfig, diff: str,
                  via: int | None, want_paths: bool):
        via = wid if via is None else int(via)
        client = self._client(via)
        rc = dataclasses.replace(rconf, results=True)
        q = np.ascontiguousarray(
            np.asarray(queries, np.int64).reshape(-1, 2))
        t0 = time.monotonic()
        try:
            fr = client.call(
                rpc_transport.request_header(rc, diff, wid=via), [q])
        except rpc_transport.RpcUnavailable as e:
            raise RpcUnavailableError(
                f"worker {via} has no rpc listener: {e}") from e
        except rpc_transport.RpcBusy as e:
            raise DispatchError(
                f"worker {via} answered BUSY (rpc credit window): {e}"
            ) from e
        except TransportError as e:
            raise DispatchError(
                f"worker {via} rpc transport failed (retryable): {e}"
            ) from e
        H_RPC_DISPATCH.observe(time.monotonic() - t0)
        row = rpc_transport.decode_reply_row(fr)
        if not row.ok:
            detail = (" (STALE_DIFF: worker behind the diff stream)"
                      if row.stale_diff else
                      " (STALE_EPOCH: worker behind the partition "
                      "table)" if row.stale_epoch else "")
            raise DispatchError(
                f"worker {via} failed a serving batch over rpc "
                f"({len(queries)} queries for shard {wid})" + detail)
        if not fr.header.get("res") or len(fr.arrays) < 3:
            raise DispatchError(
                f"worker {via} rpc reply carried no result segments "
                f"(server predates the wire extension?)")
        cost = np.asarray(fr.arrays[0], np.int64)
        plen = np.asarray(fr.arrays[1], np.int64)
        fin = np.asarray(fr.arrays[2]) != 0
        if len(cost) != len(queries):
            raise DispatchError(
                f"worker {via} rpc results length {len(cost)} != "
                f"batch {len(queries)}")
        fp_want = fr.header.get("fp")
        if fp_want is not None:
            # RuntimeConfig.answer_fp wire extension: the server
            # fingerprinted the answer segments at birth; re-check
            # after the socket hop before trusting them
            got = answer_fingerprint(cost, plen, fin)
            if got != int(fp_want):
                M_FP_MISMATCH.inc()
                raise DispatchError(
                    f"worker {via} rpc reply failed the answer "
                    f"fingerprint check (header {int(fp_want):08x}, "
                    f"computed {got:08x}) — corrupted answer "
                    "suppressed")
        if not want_paths:
            return cost, plen, fin
        nodes = moves = None
        if fr.header.get("paths") and len(fr.arrays) >= 5:
            nodes = np.asarray(fr.arrays[3], np.int64)
            moves = np.asarray(fr.arrays[4], np.int64)
        return cost, plen, fin, nodes, moves

    def probe(self, via: int):
        """Breaker-healing hook: the ping/HealthStatus vocabulary over
        a fresh connection (None on failure, like the FIFO probe)."""
        return rpc_transport.probe(via, host=self.host_of(via))

    def statusz(self) -> dict:
        """The ``/statusz`` transport connection table."""
        with self._guard:
            return {
                "mode": "rpc",
                "connections": {str(via): c.statusz()
                                for via, c in self._clients.items()},
            }

    def close(self) -> None:
        with self._guard:
            clients, self._clients = list(self._clients.values()), {}
        for c in clients:
            c.close()


class AutoDispatcher:
    """``DOS_TRANSPORT=auto``: the streaming lane with a sticky
    per-worker FIFO fallback.

    Each lane tries RPC first; a worker with NO listener (connect
    refused — the pre-RPC half of a mixed fleet mid-rollout) drops that
    lane to the FIFO wire and stays there. A worker that ANSWERED on
    RPC and then failed is a worker failure, not a transport gap — it
    surfaces as the normal retryable DispatchError and walks the
    breaker/failover path without switching transports under a chaos
    drill."""

    def __init__(self, conf: ClusterConfig,
                 timeout: float | None = None, policy=None,
                 host_of=None):
        self.rpc = RpcDispatcher(conf, timeout=timeout,
                                 host_of=host_of)
        self.fifo = FifoDispatcher(conf, timeout=timeout, policy=policy,
                                   host_of=host_of)
        self._fifo_only: set[int] = set()
        self._guard = OrderedLock("serving.AutoDispatcher")

    @property
    def host_of(self):
        return self.rpc.host_of

    @host_of.setter
    def host_of(self, fn) -> None:
        self.rpc.host_of = fn
        self.fifo.host_of = fn

    def _route(self, meth: str, wid: int, queries, rconf, diff, via):
        key = wid if via is None else int(via)
        with self._guard:
            use_fifo = key in self._fifo_only
        if not use_fifo:
            try:
                return getattr(self.rpc, meth)(wid, queries, rconf,
                                               diff, via=via)
            except RpcUnavailableError as e:
                with self._guard:
                    self._fifo_only.add(key)
                log.warning("worker %d has no rpc listener (%s); lane "
                            "falls back to the FIFO wire", key, e)
        return getattr(self.fifo, meth)(wid, queries, rconf, diff,
                                        via=via)

    def answer_batch(self, wid: int, queries: np.ndarray,
                     rconf: RuntimeConfig, diff: str,
                     via: int | None = None):
        return self._route("answer_batch", wid, queries, rconf, diff,
                           via)

    def answer_batch_paths(self, wid: int, queries: np.ndarray,
                           rconf: RuntimeConfig, diff: str,
                           via: int | None = None):
        return self._route("answer_batch_paths", wid, queries, rconf,
                           diff, via)

    def statusz(self) -> dict:
        out = self.rpc.statusz()
        out["mode"] = "auto"
        with self._guard:
            out["fifo_fallback_lanes"] = sorted(self._fifo_only)
        return out

    def close(self) -> None:
        self.rpc.close()
        self.fifo.close()


class CallableDispatcher:
    """Wrap ``fn(wid, queries, rconf, diff) -> (cost, plen, finished)``.

    ``via`` is accepted for interface parity and ignored: a callable
    backend has no per-worker placement, so replica routing is a no-op
    (tests that need via-sensitive behavior implement ``answer_batch``
    directly)."""

    def __init__(self, fn):
        self.fn = fn

    def answer_batch(self, wid: int, queries: np.ndarray,
                     rconf: RuntimeConfig, diff: str,
                     via: int | None = None):
        return self.fn(wid, queries, rconf, diff)
