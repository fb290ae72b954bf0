"""Resident query server: the port's ``fifo_auto``.

Behavior parity with reference C3 (SURVEY.md §2.2) and the JAX package's
``worker/server.py``: on start, load the graph, this worker's CPD shard
(:class:`~.engine.ShardEngine`, on the card unless ``--device cpu``) and
the first diff's weights; create the command FIFO
``/tmp/worker<wid>.fifo`` (or ``--fifo``) and block on it. Per request:
parse the 2-line frame (JSON knobs + ``queryfile answerfifo difffile``),
read the query file, answer the batch with the table-search walk (or,
with ``--alg astar``, the batched A* search, which needs no index),
write ONE CSV stats line to the answer FIFO. Stays resident across
requests.

* ``__DOS_STOP__`` on the command FIFO shuts the server down cleanly;
  ``__DOS_PING__ <fifo>`` gets one health JSON line;
* an engine error (a refused kernel launch included) answers the
  ``FAIL`` sentinel, never a silent zero row, and never leaves the head
  blocked on ``cat <answer>``;
* the streaming RPC lane (:class:`RpcServeLoop`, the JAX package's): on
  under ``DOS_TRANSPORT=rpc``/``auto`` or with ``--rpc-socket`` /
  ``--rpc-port`` (``DOS_RPC_PORT`` + wid), it answers length-prefixed
  frames on a Unix socket (``DOS_RPC_SOCKET_DIR/dos-rpc-worker<wid>
  .sock``) or TCP port BESIDE the FIFO loop, from the same engine (so by
  B1/B1′ on the card), with a credit window (``DOS_RPC_CREDIT``) and
  explicit ``busy`` frames;
* fault points (``DOS_FAULTS``, ``testing.faults``): ``kill-mid-batch``
  (``mode=exit`` exits 86, ``mode=raise`` ends the loop),
  ``crash-engine`` (answered ``FAIL``), ``delay`` and ``drop-reply``, in
  both loops;
* observability: the serve loops' counters and histograms under the JAX
  package's names in ``obs.metrics.REGISTRY``; a request with a
  ``trace_id`` has its spans captured and shipped back (a
  ``<queryfile>.trace`` sidecar, or the RPC reply's ``trace`` header);
  ``--obs-port`` (``DOS_OBS_PORT``) serves ``/metrics``, ``/healthz``
  and ``/statusz``;
* ``--metrics-dump PATH`` writes ``REGISTRY``'s snapshot
  (``counters``/``gauges``/``histograms``) on clean shutdown, the kernel
  wrappers' launch and plain-run counts mirrored into ``counters`` under
  their names (``cuda_walk_batch.launches``, ...), beside the ``alg``,
  the ``device`` (its name and peak allocated bytes), the
  ``device_programs`` (``obs.device`` entries), ``wid`` and ``pid``.

    python -m distributed_oracle_search_tpu_torch.worker.server \\
        -c conf.json --workerid N [--alg astar] [--device cpu] \\
        [--metrics-dump m.json] [--rpc-socket S | --rpc-port P] \\
        [--obs-port P] [--traffic-dir D]

With ``replication`` R > 1 a batch whose targets all lie in a shard this
worker hosts as a replica is answered by an engine made on first use
from that shard's replica block set (:meth:`FifoServer.engine_for_shard`;
counted in ``server_replica_batches_total``) — the head's failover sends
them here. Elastic membership: a ``membership.json`` beside the index
overrides the conf's owners; a fresh joiner starts engine-less, a worker
adopting a shard in a migration window serves it from its primary block
set, and a request stamped with a newer epoch (``RuntimeConfig.epoch``)
than the worker sees, even after re-reading the state, is refused with
``STALE_EPOCH`` (fault point ``stale-epoch-reply``). ``--traffic-dir``
gates the diff epoch the same way (``STALE_DIFF``). ``DOS_GATEWAY_L2_
BYTES`` > 0 enables the shard-owner L2 result cache before the kernel
(``DOS_GATEWAY_L2_ADMIT``: ``all`` or ``second-hit``; rekeyed on a swap,
flushed on an epoch). ``answer_fp`` fingerprints the answers on the
results header or the RPC reply header (fault point ``corrupt-answer``).
``DOS_TELEMETRY_INTERVAL_S`` > 0 starts the telemetry publisher in
``main``: ticks go to the FIFO's ``.telemetry`` sidecar and, when the
RPC loop serves, as a ``telemetry`` frame on every live connection
(``RpcServeLoop.broadcast``); ``/statusz`` gains a ``telemetry`` column.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import errno
import fcntl
import json
import os
import select
import socket
import stat
import sys
import threading
import time

import numpy as np
import torch

from ..data.graph import Graph
from ..integrity.fingerprint import answer_fingerprint
from ..models.cpd import BuildLedger
from ..obs import device as obs_device
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from ..obs.http import start_obs_server
from ..ops.batched_astar import astar_batch, astar_batch_np
from ..ops.cuda_astar import astar_heuristic, astar_sweep
from ..ops.cuda_walk import cuda_walk_batch, cuda_walk_multi
from ..parallel import membership
from ..parallel.partition import DistributionController
from ..testing import faults
from ..transport import frames
from ..transport import rpc as rpc_transport
from ..transport.fifo import command_fifo_path
from ..transport.wire import (
    HealthStatus, PING_TOKEN, STOP_TOKEN, Request, StatsRow,
    paths_file_for, read_query_file, results_file_for, write_paths_file,
    write_results_file,
)
from ..utils.atomicio import atomic_write_json
from ..utils.config import ClusterConfig
from ..utils.env import env_cast
from ..utils.locks import OrderedLock
from ..utils.log import get_logger, set_verbosity, set_worker_id
from .engine import ShardEngine

log = get_logger(__name__)

# serve-loop health counters, declared at import so a snapshot shows the
# failure paths at zero even when they never fired
M_FRAMES = obs_metrics.counter(
    "server_frames_received_total", "frame starts seen on the command FIFO")
M_MALFORMED = obs_metrics.counter(
    "server_frames_malformed_total",
    "stray non-frame lines + undecodable 2-line requests")
M_HALF = obs_metrics.counter(
    "server_frames_half_total",
    "frames whose second line never arrived (timeout or config-only)")
M_BATCH_FAIL = obs_metrics.counter(
    "server_batches_failed_total", "engine exceptions answered with FAIL")
M_REPLIES = obs_metrics.counter(
    "server_replies_sent_total", "stats lines written to answer FIFOs")
M_DROPPED = obs_metrics.counter(
    "server_replies_dropped_total",
    "replies dropped: no reader within the deadline, or reader vanished")
M_REPLY_WAIT = obs_metrics.histogram(
    "server_reply_open_wait_seconds",
    "time a reply waited for the head to open its answer-FIFO reader")
M_STALE_EPOCH = obs_metrics.counter(
    "server_stale_epoch_total",
    "batches refused with STALE_EPOCH: the request was routed under a "
    "NEWER partition-table epoch than this worker has, even after a "
    "membership refresh")
M_STALE_DIFF = obs_metrics.counter(
    "server_stale_diff_total",
    "batches refused with STALE_DIFF: the request named a fused diff "
    "from a NEWER traffic epoch than this worker's segment stream "
    "shows, even after a refresh")
M_L2_HITS = obs_metrics.counter(
    "worker_l2_hits_total",
    "queries answered from the shard-owner L2 cache before the kernel")
M_L2_MISSES = obs_metrics.counter(
    "worker_l2_misses_total",
    "L2 lookups that fell through to the kernel")
M_L2_ADMIT_DENIED = obs_metrics.counter(
    "gateway_l2_admit_denied_total",
    "L2 inserts withheld by the second-hit admission doorkeeper "
    "(DOS_GATEWAY_L2_ADMIT=second-hit): first-miss keys only mark the "
    "ghost list, one-hit wonders never churn the byte budget")
M_PINGS = obs_metrics.counter(
    "server_pings_answered_total",
    "__DOS_PING__ control frames answered with a health line")
M_PING_DROPS = obs_metrics.counter(
    "server_ping_replies_dropped_total",
    "health replies dropped (prober gone) — kept separate from "
    "server_replies_dropped_total so data-plane drop alerts stay clean")
M_REPLICA_BATCHES = obs_metrics.counter(
    "server_replica_batches_total",
    "batches answered from a hosted REPLICA shard (failover/hedge "
    "traffic re-routed off the shard's primary)")
G_RPC_CONNS = obs_metrics.gauge(
    "rpc_server_connections",
    "live client connections on this worker's RPC accept loop")
M_RPC_BATCHES = obs_metrics.counter(
    "rpc_server_batches_total",
    "batches answered over the socket transport (the RPC twin of "
    "server_replies_sent_total)")
M_RPC_DROPPED = obs_metrics.counter(
    "rpc_server_replies_dropped_total",
    "RPC replies dropped (drop-reply fault, or the client vanished "
    "before the reply frame)")
M_RPC_MALFORMED = obs_metrics.counter(
    "rpc_server_frames_malformed_total",
    "request frames whose config was undecodable (answered FAIL, "
    "never a wedge) — the socket twin of server_frames_malformed_total")

#: the serve loops' per-server counts (``FifoServer.counters``), under
#: the JAX package's metric names. Each also adds to the registry
#: counter of its name, except the two the engine books there itself
COUNTER_NAMES = (
    "worker_batches_total",              # batches answered (not FAIL)
    "worker_queries_total",              # queries in those batches
    "server_frames_received_total",      # frame starts seen
    "server_frames_malformed_total",     # stray lines + undecodable frames
    "server_frames_half_total",          # frames whose line 2 never came
    "server_batches_failed_total",       # batches answered with FAIL
    "server_replies_sent_total",         # stats lines written
    "server_replies_dropped_total",      # replies with no reader in time
    "server_pings_answered_total",       # health lines written
    "server_replica_batches_total",      # batches a replica engine answered
)
_ENGINE_BOOKED = ("worker_batches_total", "worker_queries_total")


def kernel_counts() -> dict:
    """The kernel wrappers' launch and plain-run counts by name: the
    walk's (raw, pack4, plain), K4's and the A* kernels' (K6: the
    sweep, its launches without the skip, its gathers, the heuristic;
    the plain batch loop and heuristic; the batched search's sweeps)."""
    return {
        "cuda_walk_batch.launches": cuda_walk_batch.launches,
        "cuda_walk_batch.launches_pack4": cuda_walk_batch.launches_pack4,
        "cuda_walk_batch.plain": cuda_walk_batch.plain,
        "cuda_walk_multi.launches": cuda_walk_multi.launches,
        "cuda_walk_multi.plain": cuda_walk_multi.plain,
        "astar_sweep.launches": astar_sweep.launches,
        "astar_sweep.dense": astar_sweep.dense,
        "astar_sweep.gathers": astar_sweep.gathers,
        "astar_batch_np.sweeps": astar_batch_np.sweeps,
        "astar_batch.plain": astar_batch.plain,
        "astar_heuristic.launches": astar_heuristic.launches,
        "astar_heuristic.plain": astar_heuristic.plain,
    }


class FifoServer:
    """One worker's resident server over its command FIFO.

    ``device``: None → ``cuda`` (raises without a GPU unless ``"cpu"``);
    the shard, the graph and every walk live there. ``counters`` holds
    this server's serve-loop counts (:data:`COUNTER_NAMES`); each adds
    to ``obs.metrics.REGISTRY`` as well. The JAX server keeps the
    registry only. The port keeps both because the registry is one per
    process: in-thread fleets (several servers in one process, as the
    port's CPU tests run them against the JAX package's) need each
    server's own counts apart, and the health line reports them. An :class:`RpcServeLoop` may
    serve the same engines beside the FIFO loop: answers are serialized
    by :attr:`answer_lock`."""

    #: bound on the gap between a frame's two lines (one atomic writer
    #: write puts both in the pipe together; only garbage arrives alone)
    FRAME_TIMEOUT_S = 2.0
    #: reader-wait for best-effort malformed replies: a garbage frame's
    #: "answer FIFO" may be a stray path nobody reads
    MALFORMED_REPLY_DEADLINE_S = 2.0
    #: reader-wait for ping replies: the prober is already blocked on its
    #: answer FIFO when the ping lands
    PING_REPLY_DEADLINE_S = 5.0

    def __init__(self, conf: ClusterConfig, wid: int,
                 command_fifo: str | None = None,
                 alg: str = "table-search", device=None,
                 traffic_dir: str | None = None):
        if alg not in ("table-search", "astar"):
            raise ValueError(f"unknown algorithm {alg!r}")
        #: live-traffic gate (``--traffic-dir``): a gate-only epoch
        #: manager over the shared segment stream — it never materializes
        #: fused files (the head did), it only tracks the stream's epoch
        #: so a request stamped with a NEWER diff epoch triggers a
        #: refresh-then-refuse instead of a failed open() on a fused file
        #: this worker's filesystem view has not seen yet
        self.traffic = None
        if traffic_dir:
            from ..traffic import DiffEpochManager

            self.traffic = DiffEpochManager(traffic_dir, materialize=False)
            self.traffic.refresh()
        #: shard-owner L2 result cache (``DOS_GATEWAY_L2_BYTES``): hot
        #: (s, t) entries answered BEFORE the kernel, keyed like the
        #: frontend L1 (diff path + knob fingerprint + both epochs).
        #: Default 0 keeps the worker as it was
        from ..gateway.config import GatewayConfig
        from ..serving.cache import ResultCache

        gconf = GatewayConfig.from_env()
        self.l2 = ResultCache(gconf.l2_bytes)
        #: L2 admission policy (``DOS_GATEWAY_L2_ADMIT``): ``all`` inserts
        #: every miss; ``second-hit`` keeps a ghost list of once-missed
        #: keys and admits only on the second miss
        self._l2_admit = gconf.l2_admit
        self._l2_seen: collections.OrderedDict = collections.OrderedDict()
        self._l2_seen_lock = OrderedLock("worker.FifoServer.l2_admit")
        if self.l2.enabled and self.traffic is not None:
            # scoped invalidation LOCAL to the shard owning the updated
            # edges: the gate-only manager still computes each swap's
            # affected-edge delta, so the L2 re-keys its provably-safe
            # survivors exactly like the head's L1 does
            self._l2_prev = self.traffic.active()[:2]
            self.traffic.on_swap = self._l2_on_swap
        self.conf = conf
        self.wid = wid
        self.alg = alg
        self.counters = dict.fromkeys(COUNTER_NAMES, 0)
        self._counters_lock = threading.Lock()
        self.command_fifo = command_fifo or command_fifo_path(wid)
        self.graph = Graph.from_xy(conf.xy_file)
        self.dc = DistributionController(
            conf.partmethod, conf.partkey, conf.maxworker, self.graph.n,
            replication=conf.effective_replication())
        self.device = device
        # elastic membership: the durable assignment (epoch + shard
        # owners) beside the index overrides the conf's static identity
        # — absent for a static fleet (epoch 0)
        self._membership_state = membership.load_state(conf.outdir)
        if self._membership_state is not None:
            self.dc = membership.apply_state(self.dc,
                                             self._membership_state)
        self.epoch = self.dc.epoch
        #: engines by shard: the eager one, and the engines made on first
        #: use for the shards it hosts as a replica or is adopting
        self._replica_engines: dict[int, ShardEngine] = {}
        # the eager engine serves the first shard this worker OWNS (its
        # own wid on a static fleet). A fresh joiner owns nothing until
        # its first epoch commits: it starts engine-less and loads
        # adopted shards lazily through engine_for_shard
        own = next((sh for sh in range(self.dc.maxworker)
                    if self.dc.owner_of(sh) == wid), None)
        self.engine: ShardEngine | None = None
        if own is not None:
            self.engine = ShardEngine(self.graph, self.dc, wid, conf.outdir,
                                      alg=alg, device=device, shard=own)
            self._replica_engines[own] = self.engine
        else:
            log.info("worker %d owns no shard at epoch %d (fresh joiner); "
                     "engines load lazily on adoption traffic", wid,
                     self.epoch)
        #: serializes engine answers across the FIFO and RPC serve loops
        #: (one engine set, two transports over it)
        self.answer_lock = OrderedLock("worker.FifoServer.answer")
        #: the RPC serve loop beside the FIFO loop (its /statusz section)
        self.rpc_loop = None
        #: the telemetry publisher ``main`` starts (its /statusz column)
        self.telemetry = None
        self._t_start = time.monotonic()
        self._last_error = ""
        # preload the first diff's weights like the reference server
        # does (make_fifos.py:18 loads only diffs[0])
        if conf.diffs and self.engine is not None:
            self.engine.preload(conf.diffs[0])

    def _count(self, name: str, n: int = 1) -> None:
        """Add ``n`` to this server's count ``name`` and to the registry
        counter of that name (the engine books the two batch counts in
        the registry itself)."""
        with self._counters_lock:
            self.counters[name] += n
        if name not in _ENGINE_BOOKED:
            obs_metrics.counter(name).inc(n)

    def engine_for_shard(self, shard: int) -> ShardEngine:
        """The engine serving ``shard``'s rows: the eager engine for its
        shard, an engine made on first use for a shard this worker hosts
        as a replica, owns, or is ADOPTING during a membership migration
        window (``membership.hosted_shards``), and a routing-invariant
        error naming the hosted shards for any other. A hosted miss first
        re-reads the membership state: a window opens without an epoch
        bump, so a worker started before ``begin`` learns it is the
        adopter only when dual-read traffic lands here."""
        eng = self._replica_engines.get(shard)
        if eng is None:
            def _hosted():
                return membership.hosted_shards(
                    self._membership_state, self.dc, self.wid)

            hosted = _hosted()
            if shard not in hosted:
                self._refresh_membership()
                hosted = _hosted()
            if shard not in hosted:
                raise ValueError(
                    f"worker {self.wid} hosts no replica of shard {shard} "
                    f"(hosted: {sorted(hosted)}) — routing invariant "
                    "violated")
            log.info("worker %d: loading shard %d for failover/adoption "
                     "traffic", self.wid, shard)
            try:
                rank = self.dc.replica_rank(shard, self.wid)
            except ValueError:
                # mid-adoption: not in the shard's replica chain yet —
                # serve the primary block set the catch-up verified
                rank = 0
            eng = ShardEngine(self.graph, self.dc, self.wid,
                              self.conf.outdir, alg=self.alg,
                              device=self.device, shard=shard,
                              replica=rank)
            self._replica_engines[shard] = eng
        return eng

    # ------------------------------------------------------------ serving
    def _ensure_fifo(self) -> None:
        if os.path.exists(self.command_fifo):
            os.remove(self.command_fifo)
        os.mkfifo(self.command_fifo)

    def handle(self, req: Request) -> StatsRow:
        """One FIFO request. A ``trace_id`` on the wire (``obs.trace``)
        captures this batch's spans under it and ships them back as a
        ``<queryfile>.trace`` sidecar, like ``.paths``."""
        if req.config.trace_id:
            with obs_trace.capture(req.config.trace_id) as cap:
                stats = self._handle(req)
            try:
                obs_trace.write_events(
                    obs_trace.trace_sidecar_for(req.queryfile), cap.events)
            except OSError as e:
                log.error("cannot write trace sidecar for %s: %s",
                          req.queryfile, e)
            return stats
        return self._handle(req)

    def _handle(self, req: Request) -> StatsRow:
        with obs_trace.span("worker.receive", wid=self.wid,
                            queryfile=req.queryfile):
            queries = read_query_file(req.queryfile)
        cost, plen, fin, stats, paths = self.answer_queries(
            queries, req.config, req.difffile)
        if paths is not None:
            # extraction rides the shared dir, not the stats FIFO
            write_paths_file(paths_file_for(req.queryfile), *paths)
        if req.config.results and (len(queries)
                                   or self.engine is not None):
            # per-query answers for the online serving frontend (an
            # engine-less empty batch answers the empty row without a
            # sidecar, as in JAX)
            fp = None
            if req.config.answer_fp:
                # fingerprint at answer birth; the corrupt-answer fault
                # fires AFTER, so the head's verifier must catch the rot
                fp = answer_fingerprint(cost, plen, fin)
                if faults.inject("corrupt-answer", self.wid) is not None:
                    cost = np.array(cost, np.int64, copy=True)
                    if len(cost):
                        cost[0] ^= 1
            write_results_file(results_file_for(req.queryfile),
                               cost, plen, fin, fp=fp)
        return stats

    def answer_queries(self, queries: np.ndarray, config, difffile: str):
        """One batch on the engine of the shard its targets lie in:
        ``(cost, plen, fin, stats, paths)`` with ``paths =
        engine.last_paths`` (None unless extracting). Shared by the FIFO
        loop (query and sidecar files around it) and the RPC loop (the
        same outputs as reply segments). A batch for one shard this
        worker hosts as a replica goes to that shard's replica engine;
        any other batch meets its engine's routing invariant."""
        engine = self.engine
        queries = np.asarray(queries, np.int64).reshape(-1, 2)
        if len(queries):
            # the scan runs on every batch: it is also how a worker
            # started before a migration window learns it is the adopter
            # (engine_for_shard refreshes membership on a hosted miss)
            shards = np.unique(self.dc.worker_of(queries[:, 1]))
            if len(shards) == 1 and (engine is None
                                     or int(shards[0]) != engine.shard):
                engine = self.engine_for_shard(int(shards[0]))
                if (engine is not self.engine
                        and int(self.dc.owner_of(int(shards[0])))
                        != self.wid):
                    # only re-routed traffic: after a leave consolidates
                    # two OWNED shards here, the second one's batches
                    # are authoritative, not failover
                    self._count("server_replica_batches_total")
        if engine is None:
            if len(queries):
                # a fresh joiner got a multi-shard batch it has no engine
                # for: FAIL it so failover walks on
                raise ValueError(
                    f"worker {self.wid} owns no shard and the batch spans "
                    f"shards "
                    f"{np.unique(self.dc.worker_of(queries[:, 1])).tolist()}"
                    " — routing invariant violated")
            return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                    np.zeros(0, bool), StatsRow(), None)
        if self.l2.enabled and not (config.extract and config.k_moves > 0):
            # extraction batches need the REAL per-move prefixes on the
            # paths sidecar; everything else can short-circuit
            out = self._answer_l2(engine, queries, config, difffile)
        else:
            cost, plen, fin, stats = engine.answer(queries, config,
                                                   difffile)
            out = (cost, plen, fin, stats, engine.last_paths)
        self._count("worker_queries_total", len(queries))
        return out

    def _answer_l2(self, engine, queries: np.ndarray, config,
                   difffile: str):
        """The worker half of the two-level cache: per-query L2 lookups
        before the kernel, the kernel only over the misses, results
        merged back in query order. Keys mirror the frontend L1 (diff
        path, knob fingerprint, membership epoch, diff epoch) so an entry
        never outlives the state that computed it; for a caller asking
        for signatures a hit fabricates its paths row from the stored
        signature (``moves = -1`` when it cannot — the frontend then
        treats the entry as signature-less)."""
        from ..serving.cache import knob_fingerprint

        l2 = self.l2
        fp = knob_fingerprint(config)
        depoch = int(config.diff_epoch or 0)
        q = queries
        n = len(q)
        keys = [(int(q[i, 0]), int(q[i, 1]), str(difffile), fp,
                 int(self.epoch), depoch) for i in range(n)]
        sig_k = int(config.sig_k or 0)
        width = sig_k + 1 if sig_k > 0 else 0
        cost = np.zeros(n, np.int64)
        plen = np.zeros(n, np.int64)
        fin = np.zeros(n, bool)
        nodes = np.zeros((n, width), np.int64) if width else None
        moves = np.full(n, -1, np.int64) if width else None
        miss_idx = []
        for i, key in enumerate(keys):
            hit = l2.get_with_sig(key)
            if hit is None:
                miss_idx.append(i)
                continue
            (c, p, f), sig = hit
            cost[i], plen[i], fin[i] = int(c), int(p), bool(f)
            if (width and sig is not None and 0 < len(sig) <= width
                    and len(sig) - 1 == int(p)):
                srt = sorted(sig)
                nodes[i, :len(srt)] = srt
                moves[i] = len(srt) - 1
        M_L2_HITS.inc(n - len(miss_idx))
        M_L2_MISSES.inc(len(miss_idx))
        stats = StatsRow()
        if miss_idx:
            idx = np.asarray(miss_idx)
            c2, p2, f2, stats = engine.answer(
                np.ascontiguousarray(q[idx]), config, difffile)
            cost[idx], plen[idx], fin[idx] = c2, p2, f2
            lp = engine.last_paths
            lp_ok = (width and lp is not None
                     and lp[0].shape[1] == width)
            if lp_ok:
                nodes[idx] = lp[0]
                moves[idx] = lp[1]
            for j, i in enumerate(miss_idx):
                sig = None
                if lp_ok and int(lp[1][j]) == int(p2[j]):
                    sig = frozenset(
                        int(x) for x in lp[0][j, :int(lp[1][j]) + 1])
                if self._l2_admit_key(keys[i]):
                    l2.put(keys[i],
                           (int(c2[j]), int(p2[j]), bool(f2[j])), sig)
        paths = (nodes, moves) if width else None
        return cost, plen, fin, stats, paths

    def _l2_admit_key(self, key) -> bool:
        """Admission doorkeeper for one missed key: ``all`` admits
        everything; ``second-hit`` admits only a key whose FIRST miss
        already marked the ghost list (a bounded FIFO of keys)."""
        if self._l2_admit != "second-hit":
            return True
        cap = max(1024, int(self.l2.max_bytes) // 256)
        with self._l2_seen_lock:
            if self._l2_seen.pop(key, None) is not None:
                return True
            self._l2_seen[key] = True
            while len(self._l2_seen) > cap:
                self._l2_seen.popitem(last=False)
        M_L2_ADMIT_DENIED.inc()
        return False

    def _l2_on_swap(self, epoch: int, difffile: str, affected) -> None:
        """Diff-epoch swap hook (the gate-only epoch manager): scoped
        invalidation of this shard's L2 — entries whose cached walk
        provably avoids every updated edge re-key to the new fusion, the
        rest drop. Runs on whichever thread refreshed the stream,
        outside the manager's lock."""
        old_epoch, old_diff = int(self._l2_prev[0]), str(self._l2_prev[1])
        self._l2_prev = (epoch, difffile)
        dropped, kept, reason = self.l2.invalidate_scoped(
            affected, difffile, epoch, max_edges=self.traffic.scoped_max,
            old_diff=old_diff, old_depoch=old_epoch)
        log.info("worker %d L2 swap epoch %d -> %d: %d dropped (%s), "
                 "%d re-keyed", self.wid, old_epoch, epoch, dropped,
                 reason, kept)

    def _batch_failed(self, e: BaseException) -> StatsRow:
        """Book a batch whose answer raised; its ``FAIL`` row."""
        self._count("server_batches_failed_total")
        self._last_error = f"{type(e).__name__}: {e}"
        return StatsRow.failed()

    def serve_forever(self) -> None:
        """Framed request loop over a PERSISTENT command-FIFO read session.

        A naive open-to-EOF session per request re-inherits the
        reference's FIFO race (reference README.md:125-127): a writer
        that opens before the server sees the previous writer's EOF
        lands in the dying session and is dropped. So the server opens
        the FIFO once with ``O_RDWR`` (its own write end means reads
        never see EOF, only block) and parses frame by frame: exactly
        two newline-terminated lines each. A request under ``PIPE_BUF``
        is written atomically, so back-to-back writers queue and never
        interleave.
        """
        self._ensure_fifo()
        set_worker_id(self.wid)
        log.info("worker %d serving on %s", self.wid, self.command_fifo)
        self._t_start = time.monotonic()
        fd = os.open(self.command_fifo, os.O_RDWR)
        self._rdbuf = b""
        try:
            while True:
                line1 = self._next_line(fd)
                if STOP_TOKEN in line1:
                    log.info("worker %d: stop requested", self.wid)
                    return
                if not line1.strip():
                    continue
                if line1.lstrip().startswith(PING_TOKEN):
                    # single-line control frame: never a data frame
                    self._answer_ping(line1)
                    continue
                self._count("server_frames_received_total")
                if not line1.lstrip().startswith("{"):
                    # a config line is always a JSON object, a paths line
                    # never is: a stray line is handled alone so it can
                    # never eat the next writer's config line
                    log.error("stray non-frame line: %r", line1)
                    self._count("server_frames_malformed_total")
                    self._answer_malformed(line1)
                    continue
                line2 = self._next_line(fd, timeout=self.FRAME_TIMEOUT_S)
                if line2 is None:
                    log.error("half frame (no line 2 within %.1fs): %r",
                              self.FRAME_TIMEOUT_S, line1)
                    self._count("server_frames_half_total")
                    continue
                if STOP_TOKEN in line2:
                    # a stop chasing a truncated request still wins
                    log.info("worker %d: stop requested", self.wid)
                    return
                if line2.lstrip().startswith("{"):
                    # the previous writer truncated: this config line
                    # starts the next frame
                    log.error("config-only half frame: %r", line1)
                    self._count("server_frames_half_total")
                    self._rdbuf = line2.encode() + self._rdbuf
                    continue
                text = line1 + line2
                try:
                    req = Request.decode(text)
                except ValueError as e:
                    log.error("bad request: %s", e)
                    self._count("server_frames_malformed_total")
                    self._answer_malformed(text)
                    continue
                stale = (self._epoch_gate(req.config)
                         or self._traffic_gate(req.config))
                if stale is not None:
                    # version-gated refusal: the head routed this batch
                    # under a NEWER table than this worker can see —
                    # answer the sentinel so failover walks on
                    self._reply(req.answerfifo, stale.encode_wire() + "\n")
                    continue
                kill = faults.inject("kill-mid-batch", wid=self.wid)
                if kill is not None:
                    # the injected analog of a worker crash between
                    # reading a request and answering it
                    log.error("fault: worker %d dying mid-batch", self.wid)
                    if kill.mode == "exit":
                        os._exit(faults.KILL_EXIT_CODE)
                    return  # mode=raise: in-thread server dies quietly
                try:
                    if faults.inject("crash-engine",
                                     wid=self.wid) is not None:
                        raise RuntimeError("injected fault: crash-engine")
                    with self.answer_lock:
                        stats = self.handle(req)
                    self._count("worker_batches_total")
                except Exception as e:  # noqa: BLE001 — never leave the
                    # head blocked on `cat answer`: answer FAIL. A CUDA
                    # error is sticky, so every later batch fails too
                    log.exception("batch failed: %s", e)
                    stats = self._batch_failed(e)
                delay = faults.inject("delay", wid=self.wid)
                if delay is not None:
                    log.warning("fault: delaying reply %.2fs", delay.delay)
                    time.sleep(delay.delay)
                if faults.inject("drop-reply", wid=self.wid) is not None:
                    log.error("fault: dropping reply to %s", req.answerfifo)
                    self._count("server_replies_dropped_total")
                    continue
                self._reply(req.answerfifo, stats.encode_wire() + "\n")
        finally:
            os.close(fd)
            if os.path.exists(self.command_fifo):
                os.remove(self.command_fifo)

    def _next_line(self, fd: int, timeout: float | None = None):
        """Next newline-terminated line off the persistent FIFO fd (own
        buffering: a buffered file object would hide pipe data from
        ``select``). ``timeout`` bounds the TOTAL wait (None = forever),
        so a byte-trickling writer cannot hold a half-frame wait open.
        Returns None on timeout."""
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        while True:
            nl = self._rdbuf.find(b"\n")
            if nl >= 0:
                line = self._rdbuf[:nl + 1]
                self._rdbuf = self._rdbuf[nl + 1:]
                return line.decode(errors="replace")
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                ready, _, _ = select.select([fd], [], [], remaining)
                if not ready:
                    return None
            chunk = os.read(fd, 4096)
            if not chunk:       # cannot happen with our own O_RDWR write
                time.sleep(0.01)
            self._rdbuf += chunk

    @property
    def reply_deadline_s(self) -> float:
        """How long to wait for the head to open its answer-FIFO reader
        (``DOS_REPLY_DEADLINE_S``, default 30; a value ≤ 0 degrades to
        the default)."""
        v = env_cast("DOS_REPLY_DEADLINE_S", 30.0, float)
        return v if v > 0 else 30.0

    def _reply(self, answerfifo: str, line: str,
               deadline_s: float | None = None,
               data_plane: bool = True) -> bool:
        """Write one line without ever wedging the server: a blocking
        ``open(fifo, 'w')`` would hang forever if the head's ``cat`` died
        before opening its end. Non-blocking open with a bounded
        deadline; the reply is dropped (logged and counted) if no reader
        appears. ``data_plane`` False (a health reply) books a drop under
        ``server_ping_replies_dropped_total`` and a write under neither
        count, so data-plane drop alerts stay clean. Returns True iff the
        line was written."""
        wait_s = (deadline_s if deadline_s is not None
                  else self.reply_deadline_s)
        t_wait0 = time.monotonic()
        deadline = t_wait0 + wait_s

        def dropped():
            if data_plane:
                self._count("server_replies_dropped_total")
            else:
                M_PING_DROPS.inc()
            return False

        fd = -1
        while fd < 0:
            try:
                fd = os.open(answerfifo, os.O_WRONLY | os.O_NONBLOCK)
            except OSError as e:
                if (e.errno not in (errno.ENXIO, errno.ENOENT)
                        or time.monotonic() > deadline):
                    log.error("no reader on %s (%s); dropping reply",
                              answerfifo, e)
                    return dropped()
                time.sleep(0.05)
        M_REPLY_WAIT.observe(time.monotonic() - t_wait0)
        try:
            # reader present: restore blocking mode for the write itself
            fcntl.fcntl(fd, fcntl.F_SETFL,
                        fcntl.fcntl(fd, fcntl.F_GETFL) & ~os.O_NONBLOCK)
            os.write(fd, line.encode())
            if data_plane:
                self._count("server_replies_sent_total")
            return True
        except OSError as e:
            # reader vanished between open and write: drop, never crash
            log.error("reply to %s failed: %s", answerfifo, e)
            return dropped()
        finally:
            os.close(fd)

    def _answer_malformed(self, text: str) -> None:
        """Best effort: find an answer-FIFO path among the tokens of a
        malformed request and send the failure sentinel, so the head's
        ``cat <answer>`` never blocks forever."""
        for line in text.strip("\n").split("\n"):
            for tok in line.split():
                try:
                    if stat.S_ISFIFO(os.stat(tok).st_mode):
                        self._reply(
                            tok, StatsRow.failed().encode_wire() + "\n",
                            deadline_s=self.MALFORMED_REPLY_DEADLINE_S)
                        return
                except OSError:
                    continue

    def _answer_ping(self, line: str) -> None:
        """Answer ``__DOS_PING__ <answerfifo>`` with one health line."""
        toks = line.split()
        if len(toks) < 2:
            log.error("ping frame names no answer FIFO: %r", line)
            return
        if self._reply(toks[1], self._health_status().to_json() + "\n",
                       deadline_s=self.PING_REPLY_DEADLINE_S,
                       data_plane=False):
            self._count("server_pings_answered_total")

    def _health_status(self) -> HealthStatus:
        """One health truth for every probe: the ``__DOS_PING__`` line,
        the RPC ``health`` frame and ``/healthz``."""
        c = self.counters
        return HealthStatus(
            ok=True, wid=self.wid, pid=os.getpid(),
            uptime_s=time.monotonic() - self._t_start,
            batches=(c["worker_batches_total"]
                     + c["server_batches_failed_total"]),
            batch_failures=c["server_batches_failed_total"],
            dropped=c["server_replies_dropped_total"],
            last_error=self._last_error,
        )

    def health(self) -> dict:
        """``/healthz`` payload: the health line a ping gets."""
        return dataclasses.asdict(self._health_status())

    def statusz(self) -> dict:
        """``/statusz`` section: serve-loop health plus what this worker
        hosts — its shard, its lanes, its resident codec and bytes, the
        replica engines loaded (is failover traffic landing here?), the
        RPC loop's state and the build ledger's journaled blocks."""
        out = dict(self.health())
        eng = self.engine
        out["alg"] = self.alg
        out["command_fifo"] = self.command_fifo
        out["shard"] = self.wid
        out["mesh"] = {"devices": int(eng.n_lanes if eng else 1),
                       "axis": "lane"}
        out["resident"] = {
            "codec": str(eng.resident_codec if eng else "raw"),
            "bytes": int(eng.resident_bytes if eng else 0)}
        out["replica_shards_loaded"] = sorted(
            s for s in self._replica_engines if s != self.wid)
        if self.dc.replication > 1:
            out["replica_shards_hosted"] = sorted(
                int(s) for s in self.dc.replica_shards(self.wid))
        # which table version this worker serves under, its live-traffic
        # diff epoch (only when it gates the stream), its L2 (only when
        # enabled) and, during a reconfiguration, the window
        out["epoch"] = int(self.epoch)
        if self.traffic is not None:
            out["diff_epoch"] = int(self.traffic.epoch)
        if self.l2.enabled:
            out["l2"] = {
                "entries": len(self.l2),
                "max_bytes": self.l2.max_bytes,
                "hits": int(self.l2.hits),
                "misses": int(self.l2.misses),
                "hit_rate": round(self.l2.hit_rate(), 4),
                "admit": str(self._l2_admit),
            }
        state = self._membership_state
        if state is not None and state.migration is not None:
            out["migration"] = dict(state.migration)
        if self.rpc_loop is not None:
            out["transport"] = self.rpc_loop.statusz()
        # telemetry column: present only when this worker publishes
        # ticks (pre-telemetry workers omit it; consumers blank it)
        if self.telemetry is not None:
            out["telemetry"] = self.telemetry.statusz()
        try:
            out["build_ledger_blocks"] = len(
                BuildLedger(self.conf.outdir, self.wid).entries())
        except (OSError, ValueError):
            out["build_ledger_blocks"] = 0
        return out

    def stop_file(self) -> None:
        """Write the stop token into our own FIFO (for another process)."""
        stop_server(self.command_fifo)

    # -------------------------------------------------- membership gate
    def _epoch_gate(self, config) -> StatsRow | None:
        """The version gate on routing state: a request stamped with a
        NEWER partition-table epoch than ours first triggers a membership
        refresh (the commit may simply not have been read yet), and only
        if we are STILL older is it refused with ``STALE_EPOCH``. Requests
        from older epochs are always served (the dual-read window needs
        it). The ``stale-epoch-reply`` fault point refuses regardless.
        Returns the refusal row, or None to proceed."""
        if faults.inject("stale-epoch-reply", wid=self.wid) is not None:
            log.error("fault: worker %d replying STALE_EPOCH", self.wid)
            M_STALE_EPOCH.inc()
            return StatsRow(ok=False, stale_epoch=True)
        req_epoch = int(config.epoch or 0)
        if req_epoch <= self.epoch:
            return None
        self._refresh_membership()
        if req_epoch <= self.epoch:
            return None
        M_STALE_EPOCH.inc()
        log.warning("worker %d at epoch %d refusing batch from epoch %d "
                    "(membership state has no newer commit)", self.wid,
                    self.epoch, req_epoch)
        return StatsRow(ok=False, stale_epoch=True)

    def _traffic_gate(self, config) -> StatsRow | None:
        """The same rule on the DIFF epoch (``RuntimeConfig.diff_epoch``):
        a request fused at a NEWER traffic epoch than our segment stream
        shows first refreshes the stream, and only if we are STILL older
        is it refused with ``STALE_DIFF``. Workers without
        ``--traffic-dir`` never gate."""
        if self.traffic is None:
            return None
        req_depoch = int(config.diff_epoch or 0)
        if req_depoch <= self.traffic.epoch:
            return None
        self.traffic.refresh()
        if req_depoch <= self.traffic.epoch:
            return None
        M_STALE_DIFF.inc()
        log.warning("worker %d at diff epoch %d refusing batch from diff "
                    "epoch %d (segment stream has no newer segment)",
                    self.wid, self.traffic.epoch, req_depoch)
        return StatsRow(ok=False, stale_diff=True)

    def _refresh_membership(self) -> None:
        """Re-read the durable membership state and swap in a controller
        reflecting it. A same-epoch state still applies when its CONTENT
        changed (``begin`` opens a window without bumping the epoch, and
        the adopter must see it); an older epoch never applies. Loaded
        engines keep serving — the node→shard map never changes, only
        ownership. A new epoch flushes the L2 (its keys carry the
        epoch)."""
        try:
            state = membership.load_state(self.conf.outdir)
        except ValueError as e:
            log.error("membership refresh failed: %s", e)
            return
        if state is None or state.epoch < self.epoch:
            return
        cur = self._membership_state
        if cur is not None and state.to_dict() == cur.to_dict():
            return
        self._membership_state = state
        self.dc = membership.apply_state(self.dc, state)
        old_epoch = self.epoch
        self.epoch = state.epoch
        if self.l2.enabled and state.epoch != old_epoch:
            n = self.l2.invalidate()
            log.info("worker %d L2 flushed %d entries on epoch %d -> %d",
                     self.wid, n, old_epoch, state.epoch)
        log.info("worker %d refreshed membership (epoch %d%s)", self.wid,
                 self.epoch, ", migration window open"
                 if state.migration is not None else "")

    # ------------------------------------------------------------ metrics
    def metrics_snapshot(self) -> dict:
        """The ``--metrics-dump`` payload: ``obs.metrics.REGISTRY``'s
        snapshot with the kernel wrappers' counts mirrored into its
        ``counters`` (:func:`kernel_counts`), and beside it the
        algorithm, the device with its peak allocated bytes and the
        resident codec, the ``obs.device`` entries of the programs this
        process ran (``device_programs``), the worker id and the pid."""
        obs_metrics.mirror_counts(
            kernel_counts(), help="kernel wrapper launch / plain counts")
        eng = self.engine or next(iter(self._replica_engines.values()),
                                  None)
        dev = eng.device if eng is not None else torch.device(
            self.device or "cuda")
        on_card = dev.type == "cuda"
        return {
            **obs_metrics.REGISTRY.snapshot(),
            "alg": self.alg,
            "device": {
                "type": dev.type,
                "name": (torch.cuda.get_device_name(dev) if on_card
                         else "cpu"),
                "max_memory_allocated": (
                    int(torch.cuda.max_memory_allocated(dev)) if on_card
                    else 0),
                "resident_codec": eng.resident_codec if eng else "raw",
                "resident_bytes": eng.resident_bytes if eng else 0,
            },
            "device_programs": obs_device.snapshot(),
            "wid": self.wid,
            "pid": os.getpid(),
        }


class RpcServeLoop:
    """The socket accept loop beside the FIFO serve loop (the JAX
    package's, with the membership and diff epoch gates, the L2, answer
    fingerprints on the reply header and the telemetry broadcast).

    One :class:`FifoServer` (engines, health state, fault points) served
    over persistent connections: length-prefixed frames
    (:mod:`..transport.frames`), multiplexed by frame id, queries and
    answers as raw ndarray payload segments instead of shared-dir files.
    Each connection gets a ``hello`` frame advertising the credit window;
    requests past the window answer an explicit ``busy`` frame. ``ping``
    frames answer the same :class:`~..transport.wire.HealthStatus` the
    ``__DOS_PING__`` control frame does.

    The FIFO loop's fault points fire here too — ``crash-engine``
    (answered FAIL), ``delay``, ``drop-reply`` (the reply frame is
    withheld; the client times out, retryable), ``kill-mid-batch``
    (``mode=exit`` exits 86; ``mode=raise`` tears the transport down,
    the in-thread analog of a crash)."""

    def __init__(self, server: FifoServer, socket_path: str | None = None,
                 tcp_port: int | None = None, credit: int | None = None):
        self.fs = server
        self.socket_path = (socket_path if socket_path is not None
                            else rpc_transport.rpc_socket_path(server.wid))
        self.tcp_port = tcp_port
        self.credit = (credit if credit is not None
                       else max(1, env_cast("DOS_RPC_CREDIT", 8, int)))
        self.endpoint = ""
        self._listener = None
        self._threads: list = []
        self._conns: list = []
        self._writers: dict = {}    # sock -> FrameWriter (broadcasts)
        self._stop = threading.Event()
        self._lock = OrderedLock("worker.RpcServeLoop")
        self._inflight = 0
        self._served = 0

    # ---------------------------------------------------------- lifecycle
    def start(self) -> "RpcServeLoop":
        if self.tcp_port is not None:
            lst = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            lst.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            lst.bind(("0.0.0.0", int(self.tcp_port)))
            self.endpoint = f"tcp:*:{lst.getsockname()[1]}"
        else:
            if os.path.exists(self.socket_path):
                os.remove(self.socket_path)
            lst = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            lst.bind(self.socket_path)
            self.endpoint = f"unix:{self.socket_path}"
        lst.listen(16)
        self._listener = lst
        self.fs.rpc_loop = self     # the /statusz transport section
        t = threading.Thread(target=self._accept_loop, daemon=True,
                             name=f"dos-rpc-accept-w{self.fs.wid}")
        self._threads.append(t)
        t.start()
        log.info("worker %d rpc serving on %s (credit %d)", self.fs.wid,
                 self.endpoint, self.credit)
        return self

    def stop(self, join_s: float = 5.0) -> None:
        self._stop.set()
        lst, self._listener = self._listener, None
        if lst is not None:
            rpc_transport.shutdown_close(lst)
        with self._lock:
            conns, self._conns = list(self._conns), []
        for c in conns:
            rpc_transport.shutdown_close(c)
        with self._lock:
            threads, self._threads = list(self._threads), []
        for t in threads:
            t.join(timeout=join_s)
        if self.tcp_port is None and os.path.exists(self.socket_path):
            try:
                os.remove(self.socket_path)
            except OSError as e:
                log.debug("rpc socket unlink failed: %s", e)

    # ------------------------------------------------------------ serving
    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                sock, _ = self._listener.accept()
            except (OSError, AttributeError):
                return      # listener closed by stop()
            with self._lock:
                self._conns.append(sock)
            G_RPC_CONNS.add(1)
            t = threading.Thread(
                target=self._conn_loop, args=(sock,), daemon=True,
                name=f"dos-rpc-conn-w{self.fs.wid}")
            with self._lock:
                self._threads.append(t)
            t.start()

    def _conn_loop(self, sock) -> None:
        reader = frames.FrameReader(sock)
        writer = frames.FrameWriter(sock)
        with self._lock:
            self._writers[sock] = writer    # telemetry broadcast lane
        try:
            writer.send({"kind": "hello", "wid": self.fs.wid,
                         "credit": self.credit})
            while not self._stop.is_set():
                fr = reader.read()
                if fr is None:
                    return                  # clean client hangup
                if fr.kind == "ping":
                    self._answer_ping(fr, writer)
                elif fr.kind == "req":
                    if not self._serve_req(fr, writer):
                        return              # kill-mid-batch mode=raise
                else:
                    # unknown kinds are the schema-tolerance rule
                    # applied to frames: skip, never kill the session
                    log.warning("ignoring unknown rpc frame kind %r",
                                fr.kind)
        except frames.TransportError as e:
            log.warning("rpc connection to worker %d died: %s",
                        self.fs.wid, e)
        except frames.FrameSchemaError as e:
            log.error("rpc peer speaks a newer frame schema: %s", e)
        finally:
            rpc_transport.shutdown_close(sock)
            me = threading.current_thread()
            with self._lock:
                self._writers.pop(sock, None)
                if sock in self._conns:
                    self._conns.remove(sock)
                # prune this handler from the join list: every breaker
                # probe opens a fresh connection
                if me in self._threads:
                    self._threads.remove(me)
            G_RPC_CONNS.add(-1)

    def _answer_ping(self, fr, writer) -> None:
        status = self.fs._health_status()
        try:
            writer.send({"kind": "health", "id": fr.header.get("id"),
                         "status": json.loads(status.to_json())})
            self.fs._count("server_pings_answered_total")
        except frames.TransportError as e:
            log.warning("rpc health reply failed: %s", e)
            M_PING_DROPS.inc()

    def _serve_req(self, fr, writer) -> bool:
        """Answer one ``req`` frame; False tears the transport down (the
        ``kill-mid-batch`` in-thread analog)."""
        fs = self.fs
        fid = fr.header.get("id")
        with self._lock:
            busy = self._inflight >= self.credit
            if not busy:
                self._inflight += 1
        if busy:
            # explicit backpressure: the client books BUSY now instead
            # of discovering a saturated worker by timeout
            rpc_transport.M_BUSY.inc()
            try:
                writer.send({"kind": "busy", "id": fid})
            except frames.TransportError as e:
                log.warning("rpc busy reply failed: %s", e)
            return True
        try:
            try:
                rconf = rpc_transport.config_from_wire(
                    fr.header.get("config"))
                queries = (np.asarray(fr.arrays[0], np.int64)
                           .reshape(-1, 2) if fr.arrays
                           else np.zeros((0, 2), np.int64))
            except (ValueError, TypeError) as e:
                log.error("malformed rpc request: %s", e)
                M_RPC_MALFORMED.inc()
                self._reply(writer, {"kind": "rep", "id": fid,
                                     "stats": StatsRow.failed()
                                     .encode_wire()})
                return True
            diff = str(fr.header.get("diff") or "-")
            stale = fs._epoch_gate(rconf) or fs._traffic_gate(rconf)
            if stale is not None:
                self._reply(writer, {"kind": "rep", "id": fid,
                                     "stats": stale.encode_wire()})
                return True
            kill = faults.inject("kill-mid-batch", wid=fs.wid)
            if kill is not None:
                log.error("fault: worker %d dying mid-batch (rpc)", fs.wid)
                if kill.mode == "exit":
                    os._exit(faults.KILL_EXIT_CODE)
                # mode=raise: the in-thread server dies — stop accepting,
                # close the listener so new connects are refused; the
                # torn socket is the client's signal
                self._stop.set()
                lst, self._listener = self._listener, None
                if lst is not None:
                    rpc_transport.shutdown_close(lst)
                return False
            header = {"kind": "rep", "id": fid}
            arrays: list = []
            try:
                if faults.inject("crash-engine", wid=fs.wid) is not None:
                    raise RuntimeError("injected fault: crash-engine")
                cost, plen, fin, stats, paths = self._answer(
                    rconf, queries, diff, header)
                fs._count("worker_batches_total")
                if rconf.results:
                    header["res"] = True
                    cost = np.asarray(cost, np.int64)
                    plen = np.asarray(plen, np.int64)
                    fin_u8 = np.asarray(fin).astype(np.uint8)
                    if rconf.answer_fp:
                        # fingerprint the segments at birth, on the reply
                        # header; the corrupt-answer fault fires AFTER so
                        # the head's check is what must catch it
                        header["fp"] = answer_fingerprint(cost, plen,
                                                          fin_u8)
                        if faults.inject("corrupt-answer",
                                         fs.wid) is not None:
                            cost = cost.copy()
                            if len(cost):
                                cost[0] ^= 1
                    arrays += [cost, plen, fin_u8]
                if paths is not None:
                    header["paths"] = True
                    arrays += [np.asarray(paths[0], np.int64),
                               np.asarray(paths[1], np.int64)]
            except Exception as e:  # noqa: BLE001 — never leave the
                # client waiting on a reply that cannot come; FAIL it
                log.exception("rpc batch failed: %s", e)
                stats = fs._batch_failed(e)
                header = {"kind": "rep", "id": fid}
                arrays = []
            delay = faults.inject("delay", wid=fs.wid)
            if delay is not None:
                log.warning("fault: delaying rpc reply %.2fs", delay.delay)
                time.sleep(delay.delay)
            if faults.inject("drop-reply", wid=fs.wid) is not None:
                log.error("fault: dropping rpc reply id=%r", fid)
                M_RPC_DROPPED.inc()
                return True
            header["stats"] = stats.encode_wire()
            self._reply(writer, header, arrays)
            M_RPC_BATCHES.inc()
            with self._lock:
                self._served += 1
            return True
        finally:
            with self._lock:
                self._inflight -= 1

    def _answer(self, rconf, queries, diff, header):
        """The engine answer under the cross-transport mutex, with the
        worker's spans captured and shipped back IN the reply header
        (``trace`` events) instead of a ``.trace`` sidecar file."""
        fs = self.fs
        if rconf.trace_id:
            with obs_trace.capture(rconf.trace_id) as cap:
                with fs.answer_lock:
                    out = fs.answer_queries(queries, rconf, diff)
            header["trace"] = cap.events
            return out
        with fs.answer_lock:
            return fs.answer_queries(queries, rconf, diff)

    def _reply(self, writer, header, arrays=()) -> None:
        try:
            writer.send(header, arrays)
        except frames.TransportError as e:
            # client vanished before the reply: drop, never crash the
            # conn loop (its next recv sees the same dead socket)
            log.warning("rpc reply dropped: %s", e)
            M_RPC_DROPPED.inc()

    def broadcast(self, tick: dict) -> None:
        """Push one telemetry tick on every live connection — fire and
        forget, no ``id``, no reply. A dead socket just drops its copy
        (its conn loop is already on the way out); the FrameWriter lock
        keeps the push from interleaving with an in-flight reply."""
        with self._lock:
            writers = list(self._writers.values())
        for w in writers:
            try:
                w.send({"kind": "telemetry", "tick": tick})
            except frames.TransportError as e:
                log.debug("telemetry broadcast dropped: %s", e)

    # ------------------------------------------------------------- status
    def statusz(self) -> dict:
        with self._lock:
            return {
                "endpoint": self.endpoint,
                "connections": len(self._conns),
                "inflight": int(self._inflight),
                "credit": int(self.credit),
                "served": int(self._served),
            }


def stop_server(command_fifo: str, deadline_s: float = 2.0) -> bool:
    """Push the stop token; never wedge the caller.

    A blocking ``open(fifo, "w")`` hangs forever when the server is
    already dead (its FIFO left behind with no reader), so open
    non-blocking and give up, logged, after ``deadline_s``. Returns True
    iff the token was delivered."""
    deadline = time.monotonic() + deadline_s
    fd = -1
    while fd < 0:
        try:
            fd = os.open(command_fifo, os.O_WRONLY | os.O_NONBLOCK)
        except OSError as e:
            if e.errno == errno.ENOENT:
                log.info("no FIFO at %s; server already gone",
                         command_fifo)
                return False
            if e.errno != errno.ENXIO:
                log.error("cannot open %s to stop server: %s",
                          command_fifo, e)
                return False
            if time.monotonic() > deadline:
                log.warning("no server reading %s within %.1fs; "
                            "skipping stop", command_fifo, deadline_s)
                return False
            time.sleep(0.05)
    try:
        os.write(fd, (STOP_TOKEN + "\n").encode())
        return True
    except OSError as e:
        log.warning("stop token to %s failed: %s", command_fifo, e)
        return False
    finally:
        os.close(fd)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-c", default="./example-cluster-conf.json",
                   help="cluster config JSON")
    p.add_argument("-w", "--workerid", type=int, required=True)
    p.add_argument("--fifo", default=None,
                   help="command FIFO path override")
    p.add_argument("--alg", default="table-search",
                   choices=["table-search", "astar"],
                   help="serving algorithm: table-search (the "
                        "reference's, make_fifos.py:20) or astar (the "
                        "hscale/fscale weighted-A* family; batched on the "
                        "device, no index needed)")
    p.add_argument("--device", default="cuda",
                   help="torch device the shard is served from "
                        "(default: cuda; raises without a GPU)")
    p.add_argument("-v", "--verbose", action="count", default=0)
    p.add_argument("--metrics-dump", default="",
                   help="write the metrics registry's snapshot (with the "
                        "kernel launch counts), the device and its peak "
                        "device memory as JSON to this path on clean "
                        "shutdown")
    p.add_argument("--obs-port", type=int, default=None,
                   help="serve live /metrics /healthz /statusz on this "
                        "port (0 = ephemeral; default off; DOS_OBS_PORT)")
    p.add_argument("--rpc-socket", default=None,
                   help="unix socket for the streaming RPC serve loop "
                        "(default under DOS_TRANSPORT=rpc/auto: "
                        "DOS_RPC_SOCKET_DIR/dos-rpc-worker<wid>.sock)")
    p.add_argument("--rpc-port", type=int, default=None,
                   help="TCP port for the RPC serve loop (cross-host; "
                        "DOS_RPC_PORT+wid when the env base is set)")
    p.add_argument("--traffic-dir", default=None,
                   help="diff segment stream directory: refuse batches "
                        "fused at a newer diff epoch than the stream "
                        "shows (STALE_DIFF) and scope the L2's "
                        "invalidation to each swap's edges")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    set_verbosity(args.verbose)
    set_worker_id(args.workerid)
    conf = ClusterConfig.load(args.c)
    server = FifoServer(conf, args.workerid, command_fifo=args.fifo,
                        alg=args.alg, device=args.device,
                        traffic_dir=args.traffic_dir)
    # the streaming data plane serves BESIDE the FIFO loop (same
    # engines): on under DOS_TRANSPORT=rpc/auto or when an explicit
    # endpoint flag names one; off under the default DOS_TRANSPORT=fifo
    rpc_loop = None
    if (args.rpc_socket is not None or args.rpc_port is not None
            or rpc_transport.resolve_transport() != "fifo"):
        port = args.rpc_port
        if port is None:
            base = env_cast("DOS_RPC_PORT", 0, int)
            port = base + args.workerid if base > 0 else None
        rpc_loop = RpcServeLoop(server, socket_path=args.rpc_socket,
                                tcp_port=port).start()
    obs_srv = start_obs_server(
        args.obs_port, health_fn=server.health,
        status_providers={"worker": server.statusz})
    # fleet telemetry: push this worker's counters/gauges/windows to the
    # head on the DOS_TELEMETRY_INTERVAL_S cadence — over the RPC lane
    # when it serves (a `telemetry` frame on every live connection) and
    # always via the FIFO sidecar file the head polls
    from ..obs import telemetry as obs_telemetry
    publisher = None
    if obs_telemetry.interval_s() > 0:
        sinks = [obs_telemetry.sidecar_sink(
            server.command_fifo + obs_telemetry.SIDECAR_SUFFIX)]
        if rpc_loop is not None:
            sinks.append(rpc_loop.broadcast)
        publisher = obs_telemetry.TelemetryPublisher(
            source=f"w{args.workerid}", sinks=sinks).start()
        server.telemetry = publisher
    try:
        server.serve_forever()
    finally:
        if publisher is not None:
            publisher.stop()
        if rpc_loop is not None:
            rpc_loop.stop()
        if obs_srv is not None:
            obs_srv.close()
        if args.metrics_dump:
            atomic_write_json(args.metrics_dump, server.metrics_snapshot())
    return 0


if __name__ == "__main__":
    sys.exit(main())
