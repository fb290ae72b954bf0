"""Head-side resilience: per-worker circuit breakers over the FIFO wire.

A dead or sick worker must not keep eating a campaign's time budget one
timeout at a time: after ``K`` consecutive batch failures the worker's
breaker OPENs and further sends short-circuit to an instant failure row.
An OPEN breaker half-opens two ways:

* **background probes** (preferred): the registry pings the worker on the
  cooldown cadence from a named daemon thread; the first healthy
  :class:`~.wire.HealthStatus` moves the breaker to HALF_OPEN;
* **cooldown fallback** (no ``probe_fn``): after ``cooldown_s`` the next
  ``allow()`` is granted as the trial.

HALF_OPEN admits exactly one trial send: success CLOSEs (consecutive
count reset), failure re-OPENs (and restarts the probe loop).

Env knobs: ``DOS_CIRCUIT_THRESHOLD`` (K, default 3),
``DOS_CIRCUIT_COOLDOWN_S`` (default 5), ``DOS_CIRCUIT_DISABLE=1``
(breakers always allow — the pre-PR-2 behavior).

Everything takes an injectable ``clock`` so tests drive the state machine
without sleeping; probe threads are named ``dos-probe-*`` and joined by
:meth:`BreakerRegistry.shutdown` so the test suite's leak check can prove
no campaign leaves one behind.

A copy of the JAX package's ``transport/resilience.py``.
"""

from __future__ import annotations

import threading
import time

from ..obs import metrics as obs_metrics
from ..obs import recorder as obs_recorder
from ..utils.env import env_cast, env_flag
from ..utils.locks import OrderedLock
from ..utils.log import get_logger

log = get_logger(__name__)

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half-open"

M_OPENED = obs_metrics.counter(
    "head_circuit_open_total", "breaker transitions to OPEN")
M_REJECTED = obs_metrics.counter(
    "head_circuit_rejected_total",
    "batch sends short-circuited by an OPEN breaker")
M_CLOSED = obs_metrics.counter(
    "head_circuit_closed_total", "breakers re-CLOSED after a good trial")
M_PROBE_HALF_OPEN = obs_metrics.counter(
    "head_circuit_half_open_total",
    "OPEN->HALF_OPEN transitions (probe success or cooldown lapse)")
G_OPEN = obs_metrics.gauge(
    "head_circuits_open", "breakers currently OPEN or HALF_OPEN")
M_FAILOVER = obs_metrics.counter(
    "failover_total",
    "batches re-routed from a dead/failed primary to a live replica "
    "(head campaign path and serving frontend both book here)")


class CircuitBreaker:
    """One worker's breaker (thread-safe; ``fan_out`` drives it from a
    pool thread while the probe loop half-opens it from another)."""

    def __init__(self, key, threshold: int = 3, cooldown_s: float = 5.0,
                 clock=time.monotonic):
        self.key = key
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self.clock = clock
        self.state = CLOSED
        self.consecutive_failures = 0
        self.opened_at = 0.0
        self._trial_in_flight = False
        #: control-plane quarantine pin: while True the breaker is held
        #: OPEN and nothing in the normal state machine — cooldown
        #: lapse, probe half-open, a lucky good record() — can heal it.
        #: Only :meth:`release` (the daemon's re-admission decision,
        #: after N clean probes) clears it.
        self.pinned = False
        self._lock = OrderedLock("resilience.CircuitBreaker")

    def allow(self) -> bool:
        """May the caller send a batch to this worker right now?"""
        # the transition event fires in the finally, AFTER the lock is
        # released: the recorder bus takes its own lock and must never
        # nest inside the breaker's
        ev = None
        try:
            with self._lock:
                if self.pinned:
                    M_REJECTED.inc()
                    return False
                if self.state == CLOSED:
                    return True
                if self.state == OPEN:
                    # cooldown fallback: without a probe loop the breaker
                    # still half-opens on its own after cooldown_s
                    if self.clock() - self.opened_at >= self.cooldown_s:
                        self._to_half_open_locked("cooldown")
                        ev = ("breaker_half_open", "cooldown")
                    else:
                        M_REJECTED.inc()
                        return False
                # HALF_OPEN: exactly one trial at a time
                if self._trial_in_flight:
                    M_REJECTED.inc()
                    return False
                self._trial_in_flight = True
                return True
        finally:
            if ev is not None:
                obs_recorder.emit(ev[0], key=str(self.key), why=ev[1])

    def record(self, ok: bool) -> None:
        ev = None
        try:
            with self._lock:
                trial = self._trial_in_flight
                self._trial_in_flight = False
                if self.pinned:
                    # outcomes recorded while quarantined must not heal
                    # (or further trip) the pinned state machine
                    return
                if ok:
                    self.consecutive_failures = 0
                    if self.state != CLOSED:
                        log.info("circuit for %s CLOSED (good %s)",
                                 self.key, "trial" if trial else "send")
                        self.state = CLOSED
                        M_CLOSED.inc()
                        G_OPEN.add(-1)
                        ev = ("breaker_close",
                              "trial" if trial else "send")
                    return
                self.consecutive_failures += 1
                if self.state == HALF_OPEN:
                    log.warning("circuit for %s trial failed; re-OPEN",
                                self.key)
                    self.state = OPEN
                    self.opened_at = self.clock()
                    M_OPENED.inc()
                    ev = ("breaker_open", "trial failed")
                elif (self.state == CLOSED
                      and self.consecutive_failures >= self.threshold):
                    log.error("circuit for %s OPEN after %d consecutive "
                              "failures", self.key,
                              self.consecutive_failures)
                    self.state = OPEN
                    self.opened_at = self.clock()
                    M_OPENED.inc()
                    G_OPEN.add(1)
                    ev = (
                        "breaker_open",
                        f"{self.consecutive_failures} consecutive "
                        f"failures")
        finally:
            if ev is not None:
                obs_recorder.emit(ev[0], key=str(self.key), why=ev[1])

    def would_allow(self) -> bool:
        """Read-only: could a send plausibly be admitted right now?
        Unlike :meth:`allow` this neither consumes the half-open trial
        slot nor books a rejection — the replicated frontend uses it to
        pick admission/hedge targets without disturbing the breaker's
        state machine."""
        with self._lock:
            if self.pinned:
                return False
            if self.state == OPEN:
                return self.clock() - self.opened_at >= self.cooldown_s
            return True

    def half_open(self, why: str = "probe") -> None:
        fired = False
        with self._lock:
            if self.state == OPEN and not self.pinned:
                self._to_half_open_locked(why)
                fired = True
        if fired:    # outside the breaker lock, like every transition
            obs_recorder.emit("breaker_half_open", key=str(self.key),
                              why=why)

    def _to_half_open_locked(self, why: str) -> None:
        log.info("circuit for %s HALF_OPEN (%s)", self.key, why)
        self.state = HALF_OPEN
        self._trial_in_flight = False
        M_PROBE_HALF_OPEN.inc()

    # ------------------------------------------------ control-plane pin
    def force_open(self, why: str = "quarantine") -> None:
        """Pin the breaker OPEN (sick-worker quarantine). Idempotent."""
        ev = None
        with self._lock:
            if self.pinned:
                return
            self.pinned = True
            if self.state == CLOSED:
                G_OPEN.add(1)
            if self.state != OPEN:
                self.state = OPEN
                self.opened_at = self.clock()
                self._trial_in_flight = False
                M_OPENED.inc()
                ev = ("breaker_open", f"pinned: {why}")
        if ev is not None:
            obs_recorder.emit(ev[0], key=str(self.key), why=ev[1])
        log.warning("circuit for %s pinned OPEN (%s)", self.key, why)

    def release(self, close: bool = True,
                why: str = "quarantine cleared") -> None:
        """Unpin. ``close=True`` (the daemon's post-probation
        re-admission) CLOSEs outright; ``close=False`` hands the worker
        back to the normal OPEN machinery (cooldown/probe trial)."""
        ev = None
        with self._lock:
            if not self.pinned:
                return
            self.pinned = False
            if close and self.state != CLOSED:
                self.state = CLOSED
                self.consecutive_failures = 0
                self._trial_in_flight = False
                M_CLOSED.inc()
                G_OPEN.add(-1)
                ev = ("breaker_close", why)
        if ev is not None:
            obs_recorder.emit(ev[0], key=str(self.key), why=ev[1])
        log.info("circuit for %s unpinned (%s, close=%s)", self.key,
                 why, close)


class BreakerRegistry:
    """Per-worker breakers keyed by ``(host, wid)`` + the probe loops.

    ``probe_fn(key) -> HealthStatus | None`` is supplied by the campaign
    driver (it knows the nfs dir and FIFO layout); when present, every
    OPEN transition starts one short-lived ``dos-probe-*`` daemon thread
    that pings on the cooldown cadence until the worker answers healthy
    (→ HALF_OPEN) or the registry shuts down.
    """

    def __init__(self, threshold: int | None = None,
                 cooldown_s: float | None = None,
                 probe_fn=None, enabled: bool | None = None,
                 clock=time.monotonic):
        self.threshold = (threshold if threshold is not None
                          else env_cast("DOS_CIRCUIT_THRESHOLD", 3, int))
        self.cooldown_s = (cooldown_s if cooldown_s is not None
                           else env_cast("DOS_CIRCUIT_COOLDOWN_S", 5.0,
                                         float))
        self.enabled = (enabled if enabled is not None
                        else not env_flag("DOS_CIRCUIT_DISABLE", False))
        self.probe_fn = probe_fn
        self.clock = clock
        self._breakers: dict = {}
        self._threads: list[threading.Thread] = []
        self._stop = threading.Event()
        self._lock = OrderedLock("resilience.BreakerRegistry")

    def get(self, key) -> CircuitBreaker:
        with self._lock:
            br = self._breakers.get(key)
            if br is None:
                br = CircuitBreaker(key, threshold=self.threshold,
                                    cooldown_s=self.cooldown_s,
                                    clock=self.clock)
                self._breakers[key] = br
            return br

    def allow(self, key) -> bool:
        return self.get(key).allow() if self.enabled else True

    def available(self, key) -> bool:
        """Read-only :meth:`CircuitBreaker.would_allow` (no breaker is
        created for an unseen key — unseen means healthy)."""
        if not self.enabled:
            return True
        with self._lock:
            br = self._breakers.get(key)
        return br is None or br.would_allow()

    def record(self, key, ok: bool) -> None:
        if not self.enabled:
            return
        br = self.get(key)
        was_open = br.state
        br.record(ok)
        if br.state == OPEN and was_open != OPEN:
            self._start_probe(br)

    def force_open(self, key, why: str = "quarantine") -> bool:
        """Control-plane quarantine: pin ``key``'s breaker OPEN. Returns
        False (no-op) when breakers are disabled."""
        if not self.enabled:
            return False
        self.get(key).force_open(why)
        return True

    def release(self, key, close: bool = True,
                why: str = "quarantine cleared") -> None:
        if not self.enabled:
            return
        with self._lock:
            br = self._breakers.get(key)
        if br is not None:
            br.release(close=close, why=why)

    # ------------------------------------------------------ probe loops
    def _start_probe(self, br: CircuitBreaker) -> None:
        if self.probe_fn is None or self._stop.is_set():
            return

        def loop():
            while not self._stop.wait(self.cooldown_s):
                if br.state != OPEN:
                    return
                try:
                    st = self.probe_fn(br.key)
                except Exception as e:  # noqa: BLE001 — a probe bug
                    # must not kill the loop that heals the breaker
                    log.warning("probe of %s raised: %s", br.key, e)
                    st = None
                if st is not None and getattr(st, "ok", False):
                    br.half_open("probe")
                    return

        t = threading.Thread(target=loop, daemon=True,
                             name=f"dos-probe-{br.key}")
        with self._lock:
            self._threads.append(t)
        t.start()

    def shutdown(self, join_s: float = 5.0) -> None:
        """Stop probe loops and join their threads (campaign end)."""
        self._stop.set()
        with self._lock:
            threads, self._threads = self._threads, []
        for t in threads:
            t.join(timeout=join_s)

    def snapshot(self) -> dict:
        """State of every breaker (for ``degraded.json`` and logs)."""
        with self._lock:
            return {repr(k): {"state": b.state,
                              "pinned": b.pinned,
                              "consecutive_failures":
                                  b.consecutive_failures}
                    for k, b in self._breakers.items()}

    def statusz(self) -> dict:
        """The ``/statusz`` section (``obs.http``): breaker states plus
        the registry's knobs and the open count — "which breaker is
        open" answered by a live scrape instead of a post-mortem
        ``degraded.json``."""
        breakers = self.snapshot()
        return {
            "enabled": self.enabled,
            "threshold": self.threshold,
            "cooldown_s": self.cooldown_s,
            "open": sum(1 for b in breakers.values()
                        if b["state"] != CLOSED),
            "breakers": breakers,
        }


def send_failover(candidates, send_fn, registry=None):
    """Walk a shard's replica chain until one worker answers.

    ``candidates`` is the failover order (primary first) of breaker
    keys; ``send_fn(key)`` attempts one candidate and returns an object
    with an ``ok`` attribute (a :class:`~.wire.StatsRow` on the
    campaign path). A candidate whose breaker is OPEN is skipped
    without a send — the short-circuit that makes a dead primary cost
    nothing per batch — and every attempted candidate's outcome is
    recorded on its own breaker, so replica health is tracked
    independently of primary health.

    Any dispatch to a non-primary candidate books ``failover_total``
    once per batch. Returns ``(row, served_key, reasons)``: ``row`` is
    the last attempt's result (or None when every candidate was
    short-circuited), ``served_key`` the candidate that answered OK (or
    None), and ``reasons`` the per-candidate failure list
    ``[(key, "circuit-open" | "send-failed"), ...]``.
    """
    reasons: list = []
    row = None
    failed_over = False
    for key in candidates:
        if registry is not None and not registry.allow(key):
            reasons.append((key, "circuit-open"))
            continue
        if reasons and not failed_over:
            # first dispatch off the primary: this batch failed over
            failed_over = True
            M_FAILOVER.inc()
        row = send_fn(key)
        if registry is not None:
            registry.record(key, row.ok)
        if row.ok:
            return row, key, reasons
        reasons.append((key, "send-failed"))
    return row, None, reasons
