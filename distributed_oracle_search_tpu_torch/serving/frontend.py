"""The serving frontend: routing, admission control, cache, completion.

``submit(s, t)`` is the whole online request path:

1. validate the node ids against the graph;
2. consult the :class:`~.cache.ResultCache` — a hit completes
   immediately (``cached=True``), no queue, no batch;
3. route to the target-owner shard (``DistributionController`` — the
   same invariant the campaign partitioner uses: the worker owning the
   TARGET answers);
4. admission control: an OPEN circuit breaker for that shard's worker
   sheds ``UNAVAILABLE``; a full shard queue sheds ``BUSY``. Both are
   immediate — an overloaded frontend answers fast, it never hangs;
5. enqueue with a deadline; the shard's :class:`~.batcher.MicroBatcher`
   forms the batch and this frontend's dispatch callback answers it
   through the configured dispatcher, records the breaker outcome,
   fills the cache, and completes every future.

Every completion stamps the end-to-end latency histogram and (when
tracing is enabled) a ``serve.request`` span, so the online path is
observable from day one like the campaign path.
"""

from __future__ import annotations

import dataclasses
import queue as _stdqueue
import threading
import time

import numpy as np

from ..obs import metrics as obs_metrics
from ..obs import quantiles as obs_quantiles
from ..obs import recorder as obs_recorder
from ..obs import trace as obs_trace
from ..parallel.partition import DistributionController
from ..transport import resilience
from ..transport.wire import RuntimeConfig
from ..utils.log import get_logger
from .batcher import MicroBatcher
from .cache import ResultCache, knob_fingerprint
from .config import ServeConfig
from .hedge import HedgeConfig, HedgeTracker, M_BUDGET_DENIED, M_WON
from .queue import ShardQueue
from .request import (
    BUSY, ERROR, Future, OK, ServeRequest, ServeResult, TIMEOUT,
    UNAVAILABLE,
)

log = get_logger(__name__)

M_REQS = obs_metrics.counter(
    "serve_requests_total", "requests submitted to the frontend")
M_OK = obs_metrics.counter(
    "serve_requests_ok_total", "requests answered OK (cache or shard)")
M_BUSY = obs_metrics.counter(
    "serve_shed_busy_total", "requests shed BUSY: shard queue full")
M_UNAVAIL = obs_metrics.counter(
    "serve_shed_unavailable_total",
    "requests shed UNAVAILABLE: open breaker or shutdown")
M_TIMEOUTS = obs_metrics.counter(
    "serve_timeouts_total", "requests expired before dispatch")
M_ERRORS = obs_metrics.counter(
    "serve_errors_total", "requests failed by dispatch errors")
H_E2E = obs_metrics.histogram(
    "serve_request_seconds",
    "submit -> completion, end to end (cache hits included)")


class ServingFrontend:
    """One process's online oracle service over a set of shards.

    ``registry``/``breaker_key`` wire in the head-side circuit breakers
    (``transport.resilience``): ``breaker_key(wid)`` must return the
    same key the campaign path uses (``(host, wid)``) so breakers — and
    their background healing probes — are shared infrastructure, not a
    serving fork. The caller owns the registry's lifecycle
    (``registry.shutdown()``)."""

    def __init__(self, dc: DistributionController, dispatcher,
                 sconf: ServeConfig | None = None,
                 rconf: RuntimeConfig | None = None,
                 diff: str = "-", registry=None, breaker_key=None,
                 hconf: HedgeConfig | None = None, membership=None,
                 traffic=None):
        self.dc = dc
        self.dispatcher = dispatcher
        #: live-traffic hook (``traffic.epochs.DiffEpochManager`` or
        #: anything with ``refresh()``/``active()``/``statusz()`` and
        #: the ``poll_s``/``scoped_max``/``sig_moves`` knobs): when set,
        #: a pump thread polls the segment stream and swaps the active
        #: fused diff on the serve path WITHOUT restart — in-flight
        #: batches pinned the old fused file at dispatch and finish on
        #: the old epoch; the cache invalidates scoped to the swap's
        #: affected edges. None = the static-diff world, byte-for-byte
        #: the pre-traffic behavior (diff epoch stays 0 everywhere).
        self.traffic = traffic
        #: elastic-membership hook (``parallel.membership
        #: .MembershipController`` or anything with ``epoch``,
        #: ``candidates_for(shard)`` and ``statusz()``): when set, each
        #: batch's candidate chain comes from the LIVE assignment —
        #: during a migration window that is the dual-read order (old
        #: owner authoritative, adopter second) — and the committed
        #: epoch is stamped on the wire. None = the controller's static
        #: chain, byte-for-byte the pre-elastic behavior.
        self.membership = membership
        self.sconf = sconf or ServeConfig.from_env()
        self.rconf = rconf or RuntimeConfig()
        self.diff = diff
        #: active diff epoch (0 = static diff). Published AFTER
        #: ``_diff_epoch`` on a swap; a torn read at worst builds a key
        #: that matches nothing — a cache miss, never a wrong hit.
        self._diff_epoch = 0
        self._sig_k = 0
        #: the fused difffile the SWAP path last published — scoped
        #: invalidation matches survivors against this, NOT self.diff,
        #: which a manual set_diff() can point at an unrelated file
        #: whose entries were never computed under any fusion
        self._fused_diff = self.diff
        if traffic is not None:
            # catch up to the stream before serving: a frontend started
            # mid-campaign begins at the newest fused epoch instead of
            # replaying the whole history one swap at a time
            traffic.refresh()
            self._diff_epoch, self.diff, _ = traffic.active()
            self._fused_diff = self.diff
            self._sig_k = max(int(traffic.sig_moves), 0)
        self._traffic_stop = threading.Event()
        self._traffic_thread: threading.Thread | None = None
        self.registry = registry
        self._breaker_key = breaker_key or (lambda wid: wid)
        self._fp = knob_fingerprint(self.rconf)
        #: DOS_ANSWER_FP rides the rconf: when set, the dispatcher
        #: verifies reply fingerprints AND the cache re-checks stored
        #: entry fingerprints on every hit (integrity plane)
        self.cache = ResultCache(
            self.sconf.cache_bytes,
            fingerprint=getattr(self.rconf, "answer_fp", False))
        #: answer-integrity hooks (``integrity`` package), attached by
        #: the serve CLI when the DOS_AUDIT_*/DOS_SCRUB_* knobs enable
        #: them; None = byte-identical legacy behavior
        self.auditor = None
        self.scrubber = None
        #: hedged dispatch (replicated shards only): per-shard latency
        #: quantiles drive the duplicate-request delay, a rate budget
        #: bounds the duplicates
        self.hedge = HedgeTracker(hconf or HedgeConfig.from_env())
        #: typed query families currently shed by the control plane's
        #: brownout ladder (empty = everything admitted). Read by
        #: ``traffic.families.QueryFamilies`` before submit; plain s-t
        #: queries are never in this set.
        self.shed_families: frozenset = frozenset()
        self._queues: dict[int, ShardQueue] = {}
        self._batchers: dict[int, MicroBatcher] = {}
        for wid in range(dc.maxworker):
            q = ShardQueue(
                self.sconf.queue_depth,
                gauge=obs_metrics.gauge(
                    f"serve_queue_depth_w{wid}",
                    f"requests queued on shard {wid}'s queue (its "
                    "primary's lane; failover/hedges drain it via "
                    "replicas)") if dc.replication > 1 else None)
            self._queues[wid] = q
            self._batchers[wid] = MicroBatcher(
                wid, q,
                (lambda batch, _wid=wid:
                 self._dispatch_batch(_wid, batch)),
                max_batch=self.sconf.max_batch,
                max_wait_s=self.sconf.max_wait_s)
        self._started = False
        self._closed = False

    # ---------------------------------------------------------- lifecycle
    def start(self) -> "ServingFrontend":
        if not self._started:
            for b in self._batchers.values():
                b.start()
            self._started = True
            if self.traffic is not None:
                self._traffic_stop.clear()
                self._traffic_thread = threading.Thread(
                    target=self._traffic_loop, daemon=True,
                    name="dos-serve-traffic")
                self._traffic_thread.start()
            log.info("serving frontend up: %d shard(s), max_batch=%d, "
                     "max_wait=%.1fms, queue_depth=%d, cache=%dMB",
                     self.dc.maxworker, self.sconf.max_batch,
                     self.sconf.max_wait_ms, self.sconf.queue_depth,
                     self.sconf.cache_bytes >> 20)
        return self

    def stop(self, drain_s: float = 5.0) -> None:
        """Shed new requests, drain admitted ones (bounded), join the
        batcher threads. ``drain_s`` is ONE shared budget across all
        shards (queues close up front, shards drain concurrently), not
        a per-shard allowance — shutdown latency stays ~drain_s even
        with many busy shards. Idempotent."""
        self._closed = True
        # stop the epoch pump FIRST: a swap landing mid-drain would
        # re-key the cache under batches that will never complete
        self._traffic_stop.set()
        if self._traffic_thread is not None:
            self._traffic_thread.join(timeout=5.0)
            self._traffic_thread = None
        if self._started:
            for q in self._queues.values():
                q.close()
            deadline = time.monotonic() + max(drain_s, 0.0)
            for b in self._batchers.values():
                b.stop(drain_s=max(0.0, deadline - time.monotonic()))
            self._started = False
        close = getattr(self.dispatcher, "close", None)
        if close is not None:
            close()

    # ------------------------------------------------------------- submit
    def submit(self, s: int, t: int) -> Future:
        M_REQS.inc()
        now = time.monotonic()
        if self._closed or not self._started:
            M_UNAVAIL.inc()
            return self._immediate(ServeResult(
                UNAVAILABLE, int(s), int(t), detail="not-serving"), now)
        s, t = int(s), int(t)
        if not (0 <= s < self.dc.nodenum and 0 <= t < self.dc.nodenum):
            M_ERRORS.inc()
            return self._immediate(ServeResult(
                ERROR, s, t, detail="node-out-of-range"), now)
        # both epochs are in the key: a post-reshard hit must never
        # serve a result computed by a worker that no longer owns the
        # shard, and a post-swap hit must never serve an old fusion's
        # cost (scoped invalidation RE-KEYS provably-safe entries, so
        # survivors keep hitting)
        key = (s, t, self.diff, self._fp, self._membership_epoch(),
               int(self._diff_epoch))
        hit = self.cache.get(key)
        if hit is not None:
            cost, plen, fin = hit
            M_OK.inc()
            return self._immediate(ServeResult(
                OK, s, t, cost=cost, plen=plen, finished=fin,
                cached=True), now)
        wid = int(self.dc.worker_of(t))   # scalar index, no per-request
        # array allocation on the admission hot path
        if self.registry is not None:
            cands = self._candidates(wid)
            if len(cands) == 1:
                # single candidate: the pre-replication admission path,
                # byte for byte (allow() keeps its trial semantics);
                # the breaker belongs to the shard's LIVE owner — the
                # shard id itself until a membership epoch moves it
                # (self._candidates reads the live view, so an epoch
                # committed mid-serve re-keys admission too)
                if not self.registry.allow(
                        self._breaker_key(cands[0])):
                    M_UNAVAIL.inc()
                    return self._immediate(ServeResult(
                        UNAVAILABLE, s, t, detail="circuit-open"), now)
            elif not any(
                    self.registry.available(self._breaker_key(c))
                    for c in cands):
                # every candidate (replica chain, plus the adopter when
                # a dual-read window is open — >1 candidates can happen
                # even at R=1) is breaker-dead: shed NOW — queueing
                # would only turn a fast explicit answer into a
                # deadline'd hang
                M_UNAVAIL.inc()
                return self._immediate(ServeResult(
                    UNAVAILABLE, s, t, detail="no-live-replica"), now)
        req = ServeRequest(s=s, t=t, wid=wid, key=key, t_submit=now,
                           deadline=now + self.sconf.deadline_s)
        if not self._queues[wid].try_put(req):
            if self._queues[wid].closed:
                # stop() raced this submit past the _closed check: the
                # shed is a shutdown, not overload — label it so
                M_UNAVAIL.inc()
                return self._immediate(ServeResult(
                    UNAVAILABLE, s, t, detail="not-serving"), now)
            M_BUSY.inc()
            return self._immediate(ServeResult(
                BUSY, s, t, detail="queue-full"), now)
        return req.future

    def query(self, s: int, t: int,
              timeout: float | None = None) -> ServeResult:
        """Blocking convenience: submit and wait. The default timeout is
        the request deadline plus dispatch headroom — a broken shard
        still yields a terminal result, never a wedged caller."""
        if timeout is None:
            timeout = self.sconf.deadline_s + 30.0
        return self.submit(s, t).result(timeout)

    # --------------------------------------------------- brownout hooks
    # Mutators for the control plane's brownout ladder. Both configs
    # are frozen dataclasses, so each step swaps in a fresh immutable
    # snapshot (``dataclasses.replace``) rather than mutating shared
    # state under readers — a dispatch thread mid-request sees either
    # the old config or the new one, never a torn mix.
    def set_hedge_budget(self, budget: float) -> None:
        self.hedge.config = dataclasses.replace(
            self.hedge.config, budget=float(budget))

    def set_deadline_ms(self, ms: float) -> None:
        """Applies to requests admitted from now on; in-flight requests
        keep the absolute deadline stamped at submit."""
        self.sconf = dataclasses.replace(self.sconf, deadline_ms=float(ms))

    def set_family_shed(self, kinds) -> None:
        self.shed_families = frozenset(kinds)

    # ------------------------------------------------------------ statusz
    def statusz(self) -> dict:
        """Live serving state for the ``/statusz`` endpoint
        (``obs.http``): per-shard queue depths and replica/failover
        chains, breaker states, hedge rate + per-shard hedge delays,
        cache occupancy — the "which replica is absorbing failover"
        page a fleet operator reads first."""
        shards = {}
        for wid, q in self._queues.items():
            shards[str(wid)] = {
                "queue_depth": len(q),
                "queue_bound": q.depth,
                "closed": q.closed,
                # the LIVE candidate chain dispatch actually walks
                # (dual-read order during a migration window) — the
                # static construction-time chain would name the wrong
                # workers during exactly the incidents this page is for
                "replicas": [int(c) for c in self._candidates(wid)],
                "hedge_delay_ms": round(
                    self.hedge.delay_s(wid) * 1e3, 3),
            }
        out = {
            "serving": self._started and not self._closed,
            "diff": self.diff,
            "diff_epoch": int(self._diff_epoch),
            "replication": int(self.dc.replication),
            "epoch": int(self.membership.epoch
                         if self.membership is not None
                         else self.dc.epoch),
            "shards": shards,
            "hedge": {
                "enabled": self.hedge.config.enabled,
                "rate": round(self.hedge.hedge_rate(), 4),
                "budget": self.hedge.config.budget,
            },
            "cache": {
                "entries": len(self.cache),
                "max_bytes": self.cache.max_bytes,
            },
        }
        if self.shed_families:
            # only under an active brownout — the legacy statusz body
            # stays byte-identical when the control plane is off
            out["shed_families"] = sorted(self.shed_families)
        # integrity plane — sections appear only when a knob enabled
        # them (legacy statusz body unchanged otherwise)
        if self.cache.fingerprint:
            out["cache"]["fp_mismatches"] = self.cache.fp_mismatches
        if self.auditor is not None:
            out["audit"] = self.auditor.statusz()
        if self.scrubber is not None:
            out["scrub"] = self.scrubber.statusz()
        # worker mesh shape (DOS_MESH_DEVICES resolution) — reported
        # best-effort: a head whose backend cannot resolve devices
        # (host-wire frontend with no local accelerator runtime) shows
        # the single-device default rather than erroring the page
        try:
            from ..parallel.mesh import mesh_devices
            out["mesh"] = {"devices": int(mesh_devices()),
                           "axis": "lane"}
        except Exception as e:  # noqa: BLE001 — statusz must render;
            # the mesh cell degrades to absent (blank in `dos-obs top`)
            log.debug("mesh shape unavailable for statusz: %s", e)
        if self.membership is not None:
            mstat = self.membership.statusz()
            if "migration" in mstat:
                out["migration"] = mstat["migration"]
        if self.traffic is not None:
            out["traffic"] = self.traffic.statusz()
        if self.registry is not None:
            out["breakers"] = self.registry.statusz()
        # streaming-transport connection table (RPC/auto dispatchers):
        # per-worker persistent-socket state — connected, in-flight
        # frames, credit window. Absent for engine/FIFO backends;
        # `dos-obs top` renders blanks for the missing section
        tstat = getattr(self.dispatcher, "statusz", None)
        if tstat is not None:
            try:
                out["transport"] = tstat()
            except Exception as e:  # noqa: BLE001 — statusz must
                # render even when a dispatcher lane is mid-teardown
                log.debug("transport statusz unavailable: %s", e)
        return out

    def _membership_epoch(self) -> int:
        return int(self.membership.epoch if self.membership is not None
                   else self.dc.epoch)

    # ------------------------------------------------------ live traffic
    def _traffic_loop(self) -> None:
        """Epoch pump: poll the segment stream, swap on new epochs.
        Never dies — a failing poll keeps serving the current epoch."""
        while not self._traffic_stop.wait(self.traffic.poll_s):
            try:
                self.poll_traffic()
            except Exception as e:  # noqa: BLE001 — the pump outlives
                # any single bad segment batch
                log.exception("traffic epoch pump failed: %s", e)

    def poll_traffic(self) -> bool:
        """One pump step (also callable inline from tests/tools):
        returns True iff a new epoch was applied."""
        if self.traffic is None or not self.traffic.refresh():
            return False
        self._apply_swap()
        return True

    def _apply_swap(self) -> None:
        epoch, difffile, affected = self.traffic.active()
        if epoch == self._diff_epoch and difffile == self.diff:
            return
        old_epoch = self._diff_epoch
        # survivors must have been computed under the previous FUSION:
        # self.diff can be a manual set_diff() target whose entries the
        # swap's affected set says nothing about
        old_diff = self._fused_diff
        # epoch first, then diff: a torn read pairs the OLD diff with
        # the NEW epoch — a key that matches nothing (miss), never a
        # wrong hit; the caching guard in _dispatch_live pins both
        self._diff_epoch = epoch
        self.diff = difffile
        self._fused_diff = difffile
        dropped, kept, reason = self.cache.invalidate_scoped(
            affected, difffile, epoch,
            max_edges=self.traffic.scoped_max,
            old_diff=old_diff, old_depoch=old_epoch)
        log.info("diff epoch %d -> %d live swap: %d cache entries "
                 "dropped (%s), %d re-keyed survivors, %d edge(s) "
                 "affected", old_epoch, epoch, dropped, reason, kept,
                 len(affected))
        obs_recorder.emit("epoch_swap", old=old_epoch, new=epoch,
                          dropped=dropped, kept=kept)

    def set_diff(self, diff: str) -> None:
        """Switch the active congestion diff. The cache is invalidated
        wholesale: keys carry the diff so stale entries could never be
        *served*, but a diff path can be rewritten in place and the
        memory is better spent on the new round's traffic."""
        if diff != self.diff:
            n = self.cache.invalidate()
            log.info("diff change %s -> %s: %d cache entries dropped",
                     self.diff, diff, n)
            self.diff = diff

    def _candidates(self, wid: int) -> list[int]:
        """The shard's candidate chain from the LIVE assignment when a
        membership hook is wired (dual-read windows, epoch commits made
        by other processes), else the controller's static chain —
        byte-for-byte the pre-elastic behavior."""
        if self.membership is not None:
            return self.membership.candidates_for(wid)
        return self.dc.replica_workers(wid)

    # --------------------------------------------------------- completion
    def _immediate(self, res: ServeResult, t_submit: float) -> Future:
        res.t_done = time.monotonic()
        # only served requests (cache hits) land in the latency
        # histogram: near-zero BUSY/UNAVAILABLE shed samples would make
        # p50/p99 IMPROVE exactly when the service is overloaded
        if res.status == OK:
            H_E2E.observe(res.t_done - t_submit)
            obs_quantiles.observe("serve_request_seconds",
                                  res.t_done - t_submit)
        return Future.completed(res)

    def _finish(self, req: ServeRequest, res: ServeResult) -> None:
        res.t_done = time.monotonic()
        e2e = res.t_done - req.t_submit
        H_E2E.observe(e2e)
        # live sliding-window quantiles with an exemplar: the window's
        # worst request keeps the trace id its batch dispatched under,
        # so a bad p99 on the scrape links straight to its Perfetto
        # timeline
        obs_quantiles.observe("serve_request_seconds", e2e,
                              trace_id=req.trace_id)
        obs_trace.add_span("serve.request", e2e, wid=req.wid,
                           status=res.status,
                           **({"trace_id": req.trace_id}
                              if req.trace_id else {}))
        req.future.set(res)

    def _dispatch_batch(self, wid: int, batch: list[ServeRequest]) -> None:
        """MicroBatcher callback: expire, answer, record, fill, finish."""
        now = time.monotonic()
        live = []
        for r in batch:
            if r.expired(now):
                M_TIMEOUTS.inc()
                self._finish(r, ServeResult(TIMEOUT, r.s, r.t,
                                            detail="deadline"))
            else:
                live.append(r)
        if not live:
            return
        # with tracing on, every batch gets its own trace id: it rides
        # the wire (RuntimeConfig extension) so the worker ships its
        # spans back under it, it stamps each request (the quantile
        # exemplar key), and it tags this thread's log records — scoped
        # to this batch (the runner thread persists; a leaked id would
        # mislabel between-batch log records with the PREVIOUS batch)
        if obs_trace.enabled():
            tid = obs_trace.new_trace_id()
            obs_trace.set_trace_id(tid)
            for r in live:
                r.trace_id = tid
            try:
                self._dispatch_live(wid, live)
            finally:
                obs_trace.set_trace_id(None)
        else:
            self._dispatch_live(wid, live)

    def _dispatch_live(self, wid: int, live: list[ServeRequest]) -> None:
        queries = np.asarray([[r.s, r.t] for r in live], np.int64)
        # pin the (diff, diff epoch) actually dispatched: a set_diff or
        # epoch swap racing this batch must not let answers computed
        # under the NEW fusion be cached under requests' submit-time
        # (old-epoch) keys — and vice versa
        diff = self.diff
        depoch = int(self._diff_epoch)
        err = ""
        ok = False
        cost = plen = fin = None
        sigs = None
        candidates = self._candidates(wid)
        attempted = False
        failed_over = False
        for via in candidates:
            key = self._breaker_key(via)
            if (len(candidates) > 1 and self.registry is not None
                    and not self.registry.allow(key)):
                # dead replica: skip without a dispatch (R=1 keeps the
                # admission-time breaker semantics — no second gate)
                continue
            if attempted or via != candidates[0]:
                if not failed_over:
                    failed_over = True
                    resilience.M_FAILOVER.inc()
                log.warning("shard w%d batch failing over to replica "
                            "host w%d", wid, via)
            attempted = True
            try:
                cost, plen, fin, sigs = self._dispatch_hedged(
                    wid, via, candidates, queries, diff,
                    depoch=depoch, tid=live[0].trace_id)
                ok = True
            except Exception as e:  # noqa: BLE001 — any dispatch
                # failure becomes a breaker failure record (booked by
                # the attempt itself, see _dispatch_hedged) + (once the
                # chain is exhausted) per-request ERROR
                log.exception("shard w%d serving batch via w%d "
                              "failed: %s", wid, via, e)
                err = f"{type(e).__name__}: {e}"
            if ok:
                break
        if not ok:
            if not attempted:
                # every replica's breaker was open at dispatch time
                # (they half-opened away again since admission): shed
                # rather than hang — the admission guarantee holds at
                # dispatch too
                for r in live:
                    M_UNAVAIL.inc()
                    self._finish(r, ServeResult(
                        UNAVAILABLE, r.s, r.t, detail="no-live-replica"))
                return
            for r in live:
                M_ERRORS.inc()
                self._finish(r, ServeResult(ERROR, r.s, r.t, detail=err))
            return
        if self.auditor is not None:
            # OFF the reply path: the clients' answers complete below
            # regardless; the sampled dual execution decides whether to
            # keep trusting this engine (integrity.audit)
            self.auditor.maybe_submit(wid, via, candidates, queries,
                                      self.rconf, diff, cost, plen, fin)
        for i, r in enumerate(live):
            val = (int(cost[i]), int(plen[i]), bool(fin[i]))
            if (r.key[2] == diff
                    and (len(r.key) <= 5 or r.key[5] == depoch)):
                self.cache.put(r.key, val,
                               sig=sigs[i] if sigs is not None
                               else None)
            M_OK.inc()
            self._finish(r, ServeResult(OK, r.s, r.t, cost=val[0],
                                        plen=val[1], finished=val[2]))

    # ------------------------------------------------- hedged dispatch
    def _answer_once(self, wid: int, via: int, queries, diff: str,
                     depoch: int = 0, tid: str = ""):
        """One dispatch lane; returns ``(cost, plen, fin, sigs)`` where
        ``sigs`` is a per-query path-signature list (or None when no
        signatures were captured). ``tid`` is the batch's trace id: it
        tags this thread (hedge lanes run on fresh threads that would
        otherwise be untagged), rides the wire so a FIFO worker captures
        its spans under it, and labels the dispatch span."""
        rconf = self.rconf
        epoch = (self.membership.epoch if self.membership is not None
                 else self.dc.epoch)
        if epoch and not rconf.epoch:
            # the wire carries the table version the routing decision
            # was made under (elastic-membership wire extension)
            rconf = dataclasses.replace(rconf, epoch=epoch)
        if depoch and not rconf.diff_epoch:
            # the traffic twin: the diff epoch this batch's fused file
            # was pinned at (tolerate-older / gate-newer on the worker)
            rconf = dataclasses.replace(rconf, diff_epoch=int(depoch))
        if tid:
            obs_trace.set_trace_id(tid)
            if not rconf.trace_id:
                rconf = dataclasses.replace(rconf, trace_id=tid)
        want_sigs = (self._sig_k > 0 and self.cache.enabled
                     and hasattr(self.dispatcher,
                                 "answer_batch_paths"))
        with obs_trace.span("serve.dispatch", wid=via, shard=wid,
                            size=len(queries)):
            if want_sigs:
                rconf = dataclasses.replace(rconf, sig_k=self._sig_k)
                cost, plen, fin, nodes, moves = (
                    self.dispatcher.answer_batch_paths(
                        wid, queries, rconf, diff, via=via))
                return cost, plen, fin, self._build_sigs(
                    plen, nodes, moves)
            cost, plen, fin = self.dispatcher.answer_batch(
                wid, queries, rconf, diff, via=via)
            return cost, plen, fin, None

    def _build_sigs(self, plen, nodes, moves):
        """Per-query path signatures: the walked node set, or None when
        the capture is INCOMPLETE (path longer than ``sig_k`` — such an
        entry must invalidate conservatively on every swap)."""
        if nodes is None or moves is None:
            return None
        if len(nodes) != len(plen) or len(moves) != len(plen):
            # not this batch's capture (defense in depth next to the
            # dispatcher's lane lock): no signatures beats wrong ones
            return None
        sigs = []
        for i in range(len(plen)):
            if int(moves[i]) == int(plen[i]):
                sigs.append(frozenset(
                    int(x) for x in nodes[i, :int(moves[i]) + 1]))
            else:
                sigs.append(None)
        return sigs

    def _hedge_target(self, wid: int, via: int, candidates) -> int | None:
        """The replica a hedge would duplicate to: the first candidate
        other than ``via`` whose breaker looks live (read-only check —
        a duplicate must not consume half-open trial slots)."""
        for c in candidates:
            if c == via:
                continue
            if (self.registry is None
                    or self.registry.available(self._breaker_key(c))):
                return c
        return None

    def _record(self, target: int, ok: bool) -> None:
        if self.registry is not None:
            self.registry.record(self._breaker_key(target), ok)

    def _dispatch_hedged(self, wid: int, via: int, candidates,
                         queries, diff: str, depoch: int = 0,
                         tid: str = ""):
        """One batch through ``via``, hedged: if no answer lands within
        the shard's adaptive delay (recent latency quantile, floor
        ``DOS_HEDGE_MIN_MS``) and the hedge budget grants, a duplicate
        goes to a live replica — first answer wins, the loser's result
        is discarded (identical rows, deterministic kernels: redundant,
        never wrong). Raises only when every issued attempt raised.

        Breaker accounting happens PER LANE, by the attempt itself, at
        the moment that attempt completes — a hedge win must not book a
        success on the primary's breaker (a wedged primary would then
        never OPEN and budget-denied batches would keep hanging on it);
        a loser that eventually times out records its own failure from
        its background thread."""
        alt = None
        if self.hedge.config.enabled and len(candidates) > 1:
            if self.hedge.would_issue():
                alt = self._hedge_target(wid, via, candidates)
            else:
                # budget spent: this batch could never hedge — book the
                # denial and stay on the cheap inline path
                M_BUDGET_DENIED.inc()
        if alt is None:
            # unreplicated / hedging off / budget spent: dispatch
            # inline on the runner thread, exactly the pre-hedging path
            # (no per-batch thread spawn for batches that could never
            # hedge anyway)
            t0 = time.monotonic()
            try:
                out = self._answer_once(wid, via, queries, diff,
                                        depoch=depoch, tid=tid)
            except Exception:
                self._record(via, False)
                raise
            self._record(via, True)
            dt = time.monotonic() - t0
            self.hedge.observe(wid, dt)
            obs_quantiles.observe("serve_dispatch_seconds", dt,
                                  trace_id=tid)
            return out
        results: _stdqueue.Queue = _stdqueue.Queue()

        def run(target: int, is_hedge: bool) -> None:
            t0 = time.monotonic()
            try:
                r = self._answer_once(wid, target, queries, diff,
                                      depoch=depoch, tid=tid)
            except Exception as e:  # noqa: BLE001 — collected below
                self._record(target, False)
                results.put((is_hedge, None, e, time.monotonic() - t0))
                return
            self._record(target, True)
            results.put((is_hedge, r, None, time.monotonic() - t0))

        threading.Thread(
            target=run, args=(via, False), daemon=True,
            name=f"dos-serve-primary-w{wid}").start()
        inflight = 1
        try:
            got = results.get(timeout=self.hedge.delay_s(wid))
            inflight -= 1
        except _stdqueue.Empty:
            got = None
            if self.hedge.try_issue():
                log.info("shard w%d batch slow on w%d; hedging to "
                         "replica w%d", wid, via, alt)
                threading.Thread(
                    target=run, args=(alt, True), daemon=True,
                    name=f"dos-serve-hedge-w{wid}").start()
                inflight += 1
        primary_errored = got is not None and got[1] is None
        while got is None or (got[1] is None and inflight > 0):
            # no answer yet, or the first completion was an error and
            # another attempt is still in flight: keep collecting
            nxt = results.get()
            inflight -= 1
            if nxt[1] is None and not nxt[0]:
                primary_errored = True
            got = nxt if got is None or got[1] is None else got
        is_hedge, out, exc, duration = got
        if out is None:
            raise exc
        if is_hedge and not primary_errored:
            # a WIN is the replica beating a live primary; a hedge that
            # survived because the primary ERRORED is failover, and
            # must not inflate the hedge-effectiveness headline
            M_WON.inc()
        self.hedge.observe(wid, duration)
        obs_quantiles.observe("serve_dispatch_seconds", duration,
                              trace_id=tid)
        return out
