"""Sampled dual-execution audit: re-run served batches, compare answers.

Fingerprints (:mod:`integrity.fingerprint`) catch corruption *in
flight* — between the engine and the client. They cannot catch an
engine that *computes* the wrong answer: a bitflipped resident row, a
wrong-regime promotion, a kernel miscompile. The audit plane closes
that hole by re-executing ``DOS_AUDIT_RATE`` per-mille of served
batches on an **independent lane** and comparing element-wise, OFF the
reply critical path — the client already has its answer; the audit
decides whether to believe the engine going forward.

Lane choice mirrors ``ops.pallas_walk.choose_walk_kernel``'s
``(choice, why)`` contract (:func:`choose_audit_lane`):

``replica``
    another candidate worker for the same shard — an independent
    resident copy on independent hardware. The strongest check against
    resident-row rot, and the default whenever the membership offers a
    second candidate.
``reference``
    the CPU oracle (:mod:`models.reference`) — an independent
    *algorithm*, immune to kernel bugs too, but O(M log N) per distinct
    target; only batches of at most ``DOS_AUDIT_MAX_REFERENCE`` queries
    take it.
``recompute``
    the same worker, re-dispatched with ``no_cache=True`` so the L2
    key differs and the kernel genuinely re-executes — the weakest
    lane (same resident table), but it still catches transient compute
    faults and cache rot, and it is always available.

Only deadline-free batches (``RuntimeConfig.time == 0``) are sampled:
a deadline-truncated walk legitimately differs between executions and
would drown the signal in false divergences.

A divergence books ``audit_divergence_total``, lands a structured
``audit_divergence`` flight-recorder event carrying the (shard, epoch,
lane, codec/kernel) fingerprint, and surfaces per-shard counts through
:meth:`AnswerAuditor.snapshot` — the control loop's ``DivergenceWatch``
arm reads that to force-open the shard's breaker, trigger a scrub-now,
and re-admit only after clean probes.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time

import numpy as np

from ..obs import metrics as obs_metrics
from ..obs import recorder as obs_recorder
from ..utils.locks import OrderedLock
from ..utils.log import get_logger

log = get_logger(__name__)

M_AUDITED = obs_metrics.counter(
    "audit_batches_total",
    "served batches re-executed on an independent audit lane "
    "(DOS_AUDIT_RATE sampling)")
M_DIVERGENCE = obs_metrics.counter(
    "audit_divergence_total",
    "audited batches whose independent re-execution disagreed with the "
    "served answer — each lands an audit_divergence recorder event and "
    "feeds the control loop's DivergenceWatch arm")
M_AUDIT_DROPPED = obs_metrics.counter(
    "audit_dropped_total",
    "sampled batches dropped before auditing (queue full or auditor "
    "stopping) — the audit never blocks or backpressures serving")
M_AUDIT_SECONDS = obs_metrics.histogram(
    "audit_lane_seconds",
    "wall time of one audit re-execution + compare, by whichever lane "
    "choose_audit_lane picked")


def choose_audit_lane(candidates, via, nq: int, *,
                      have_reference: bool,
                      max_reference: int) -> tuple[str, str]:
    """Pick the audit lane for one sampled batch → ``(lane, why)``.

    Same shape as ``choose_walk_kernel``: the choice is a pure function
    of what is available, and the ``why`` string is human-readable
    policy provenance for the recorder event. Preference order is
    independence: ``replica`` (other resident copy) > ``reference``
    (other algorithm, small batches only) > ``recompute`` (same worker,
    uncached — always available).
    """
    others = [c for c in (candidates or ()) if c != via]
    if others:
        return "replica", (f"candidate {others[0]} offers an independent "
                           f"resident copy (served by {via})")
    if have_reference and 0 < nq <= max_reference:
        return "reference", (f"no second candidate; batch of {nq} fits "
                             f"the CPU oracle bound {max_reference}")
    return "recompute", ("no second candidate"
                         + ("" if have_reference else ", no reference fn")
                         + f"; batch of {nq} re-executes uncached on {via}")


def make_reference_fn(graph, *, max_fm_cache: int = 1024,
                      max_w_cache: int = 4):
    """Build the CPU-oracle lane: ``fn(queries, config, diff) -> (cost,
    plen, finished)`` int64/int64/bool arrays.

    CPDs are built FREE-FLOW and the congestion diff applies at query
    time (reference semantics, ``models.reference``), so the first-move
    columns are computed once per distinct target on free-flow weights
    and cached (bounded — each column is N int8), while the cost
    accumulates on ``graph.weights_with_diff(diff)`` (also cached per
    diff path, small: the serving plane cycles through few fusions).
    """
    from ..models.reference import first_move_to_target, table_search_walk

    fm_cache: dict[int, np.ndarray] = {}
    w_cache: dict[str, np.ndarray] = {}
    lock = OrderedLock("integrity.reference_fn")

    def _fm_col(t: int) -> np.ndarray:
        with lock:
            col = fm_cache.get(t)
        if col is None:
            col = first_move_to_target(graph, t)
            with lock:
                if len(fm_cache) >= max_fm_cache:
                    fm_cache.clear()
                fm_cache[t] = col
        return col

    def _w_query(diff) -> np.ndarray:
        key = diff if isinstance(diff, str) else "-"
        with lock:
            w = w_cache.get(key)
        if w is None:
            w = (graph.w if key == "-" or not key
                 else graph.weights_with_diff(key))
            with lock:
                if len(w_cache) >= max_w_cache:
                    w_cache.clear()
                w_cache[key] = w
        return w

    def reference(queries, config, diff):
        q = np.asarray(queries, np.int64).reshape(-1, 2)
        w = _w_query(diff)
        k_moves = int(getattr(config, "k_moves", -1) or -1)
        cost = np.zeros(len(q), np.int64)
        plen = np.zeros(len(q), np.int64)
        fin = np.zeros(len(q), bool)
        for i, (s, t) in enumerate(q):
            col = _fm_col(int(t))
            c, p, f, _path = table_search_walk(
                graph, lambda x, _t, col=col: col[x], int(s), int(t),
                w_query=w, k_moves=k_moves)
            cost[i], plen[i], fin[i] = c, p, f
        return cost, plen, fin

    return reference


class AnswerAuditor:
    """Samples served batches and re-executes them off the reply path.

    ``maybe_submit`` is the only call on the serving path: a
    deterministic per-mille accumulator (no RNG — ``DOS_AUDIT_RATE=10``
    audits EXACTLY every 100th eligible batch, so tests and drills are
    reproducible) plus a non-blocking put into a bounded queue. A full
    queue drops the sample (``audit_dropped_total``) — the audit plane
    must never backpressure serving.

    One daemon worker thread drains the queue, picks a lane
    (:func:`choose_audit_lane`), re-executes, compares element-wise,
    and on divergence books the counter, emits the recorder event, and
    bumps the per-shard tally that :meth:`snapshot` exposes to the
    control loop's ``DivergenceWatch``.
    """

    def __init__(self, dispatcher, rate_pm: int, *, reference_fn=None,
                 describe_fn=None, max_reference: int = 64,
                 queue_max: int = 64, clock=time.monotonic):
        self._dispatcher = dispatcher
        self.rate_pm = max(0, min(1000, int(rate_pm)))
        self._reference_fn = reference_fn
        self._describe_fn = describe_fn
        self.max_reference = int(max_reference)
        self._clock = clock
        self._q: queue.Queue = queue.Queue(maxsize=max(1, int(queue_max)))
        self._lock = OrderedLock("integrity.AnswerAuditor")
        self._acc = 0                # per-mille accumulator
        self._divergent: dict[int, int] = {}   # wid -> cumulative count
        self.audited = 0
        self.dropped = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        if self.rate_pm > 0:
            self._thread = threading.Thread(
                target=self._run, name="dos-audit", daemon=True)
            self._thread.start()

    # ------------------------------------------------------- serving path
    def maybe_submit(self, wid: int, via, candidates, queries, config,
                     diff, cost, plen, fin) -> bool:
        """Sample this served batch for audit; returns True if queued.

        Called AFTER the reply is on its way — nothing here can delay
        or fail the client's answer. Deadline-bounded batches
        (``config.time != 0``) are never sampled (legitimately
        nondeterministic under truncation).
        """
        if self.rate_pm <= 0 or self._stop.is_set():
            return False
        if getattr(config, "time", 0):
            return False
        with self._lock:
            self._acc += self.rate_pm
            if self._acc < 1000:
                return False
            self._acc -= 1000
        job = (int(wid), via, tuple(candidates or ()),
               np.array(queries, np.int64, copy=True), config, diff,
               np.asarray(cost).copy(), np.asarray(plen).copy(),
               np.asarray(fin).copy())
        try:
            self._q.put_nowait(job)
            return True
        except queue.Full:
            M_AUDIT_DROPPED.inc()
            with self._lock:
                self.dropped += 1
            return False

    # -------------------------------------------------------- audit lane
    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                job = self._q.get(timeout=0.2)
            except queue.Empty:
                continue
            try:
                self._audit(*job)
            except Exception as e:  # never kill the audit thread
                log.error("audit lane failed (batch dropped): %s", e)
                M_AUDIT_DROPPED.inc()
                with self._lock:
                    self.dropped += 1

    def _audit(self, wid, via, candidates, queries, config, diff,
               cost, plen, fin) -> None:
        lane, why = choose_audit_lane(
            candidates, via, len(queries),
            have_reference=self._reference_fn is not None,
            max_reference=self.max_reference)
        t0 = self._clock()
        if lane == "reference":
            c2, p2, f2 = self._reference_fn(queries, config, diff)
        else:
            lane_via = (next(c for c in candidates if c != via)
                        if lane == "replica" else via)
            # no_cache=True is part of the worker's L2 cache key, so the
            # audit can never be served the cached (possibly corrupt)
            # answer echoed back — the kernel genuinely re-executes
            rconf = dataclasses.replace(config, no_cache=True)
            c2, p2, f2 = self._dispatcher.answer_batch(
                wid, queries, rconf, diff, via=lane_via)
        M_AUDIT_SECONDS.observe(self._clock() - t0)
        M_AUDITED.inc()
        with self._lock:
            self.audited += 1
        bad = ((np.asarray(cost, np.int64)
                != np.asarray(c2, np.int64))
               | (np.asarray(plen, np.int64)
                  != np.asarray(p2, np.int64))
               | (np.asarray(fin, bool) != np.asarray(f2, bool)))
        n_bad = int(np.count_nonzero(bad))
        if not n_bad:
            return
        M_DIVERGENCE.inc()
        with self._lock:
            self._divergent[wid] = self._divergent.get(wid, 0) + 1
        fields = dict(wid=wid, via=str(via), lane=lane, why=why,
                      nq=int(len(queries)), mismatches=n_bad,
                      epoch=int(getattr(config, "epoch", -1) or -1),
                      diff_epoch=int(getattr(config, "diff_epoch", -1)
                                     or -1))
        if self._describe_fn is not None:
            try:
                fields.update(self._describe_fn(wid, via) or {})
            except Exception as e:
                log.debug("audit describe_fn failed: %s", e)
        obs_recorder.emit("audit_divergence", **fields)
        log.error("AUDIT DIVERGENCE shard %s: %d/%d answers differ on "
                  "the %s lane (%s)", wid, n_bad, len(queries), lane, why)

    # ---------------------------------------------------------- plumbing
    def snapshot(self) -> dict[int, int]:
        """Per-shard CUMULATIVE divergence counts — the control loop's
        ``SignalReader`` integrity provider polls this and DivergenceWatch
        acts on deltas."""
        with self._lock:
            return dict(self._divergent)

    def statusz(self) -> dict:
        with self._lock:
            return {
                "rate_pm": self.rate_pm,
                "max_reference": self.max_reference,
                "audited": self.audited,
                "dropped": self.dropped,
                "queued": self._q.qsize(),
                "divergent": {str(k): v
                              for k, v in sorted(self._divergent.items())},
            }

    def stop(self, join_s: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=join_s)
