"""Decide: declarative rules with trip/clear hysteresis and cooldowns.

The SLO engine's alerting pattern (trip at a threshold, clear only
below ``clear_frac`` of it) applied to *actions*: a rule fires its
trip edge once after ``hold_ticks`` consecutive over-threshold
observations, then cannot fire again until the signal has both cleared
and ``cooldown_s`` has elapsed — an oscillating signal produces a
bounded number of actions, never a flap storm. The
:class:`ActionBudget` is the last line: a fleet-wide cap on executed
actions per sliding window, so even a pathological policy cannot
reconfigure the fleet faster than an operator could follow."""

from __future__ import annotations

import collections
import time


class HysteresisRule:
    """Trip/clear edge detector over a scalar signal.

    ``observe(value, now)`` returns ``"trip"`` on the rising edge,
    ``"clear"`` on the falling edge, else ``None``. ``None`` values
    (sensor absent) hold the current state — missing data is not
    evidence of health."""

    def __init__(self, name: str, trip: float, *,
                 clear: float | None = None, clear_frac: float = 0.5,
                 hold_ticks: int = 2, cooldown_s: float = 0.0):
        self.name = name
        self.trip_at = float(trip)
        self.clear_at = float(clear if clear is not None
                              else trip * clear_frac)
        self.hold_ticks = max(1, int(hold_ticks))
        self.cooldown_s = float(cooldown_s)
        self.tripped = False
        self._above = 0
        self._below = 0
        self._last_fire = float("-inf")

    def observe(self, value: float | None,
                now: float | None = None) -> str | None:
        now = time.monotonic() if now is None else now
        if value is None:
            return None
        if not self.tripped:
            if value >= self.trip_at:
                self._above += 1
                if (self._above >= self.hold_ticks
                        and now - self._last_fire >= self.cooldown_s):
                    self.tripped = True
                    self._below = 0
                    self._last_fire = now
                    return "trip"
            else:
                self._above = 0
            return None
        if value <= self.clear_at:
            self._below += 1
            if self._below >= self.hold_ticks:
                self.tripped = False
                self._above = 0
                return "clear"
        else:
            self._below = 0
        return None


class ActionBudget:
    """Sliding-window cap on executed actions (fleet-wide)."""

    def __init__(self, budget: int, window_s: float):
        self.budget = max(1, int(budget))
        self.window_s = float(window_s)
        self._fired: collections.deque = collections.deque()

    def _prune(self, now: float) -> None:
        while self._fired and now - self._fired[0] > self.window_s:
            self._fired.popleft()

    def allow(self, now: float) -> bool:
        self._prune(now)
        return len(self._fired) < self.budget

    def book(self, now: float) -> None:
        self._prune(now)
        self._fired.append(now)

    def statusz(self, now: float | None = None) -> dict:
        now = time.monotonic() if now is None else now
        self._prune(now)
        return {"budget": self.budget, "window_s": self.window_s,
                "used": len(self._fired)}


class Cooldown:
    """Per-actuator minimum spacing between executions."""

    def __init__(self, cooldown_s: float):
        self.cooldown_s = float(cooldown_s)
        self._last: dict[str, float] = {}

    def ready(self, key: str, now: float) -> bool:
        return now - self._last.get(key, float("-inf")) >= self.cooldown_s

    def mark(self, key: str, now: float) -> None:
        self._last[key] = now


# --------------------------------------------------------------- brownout
#: ladder levels, least to most invasive. Each level's actions are the
#: union of everything up to it; stepping down undoes in reverse.
BROWNOUT_MAX_LEVEL = 3
#: hedge budget multiplier at level >= 1 (shrink speculative duplicates
#: first — they are pure extra load under overload)
BROWNOUT_HEDGE_SCALE = 0.25
#: families shed at level >= 2 (mat fan-out and alt-count cost the
#: most per request; plain s-t queries keep flowing)
BROWNOUT_SHED_FAMILIES = ("mat", "alt")
#: deadline multiplier at level 3 (shed the slowest tail explicitly
#: rather than letting it time out after consuming a slot)
BROWNOUT_DEADLINE_SCALE = 0.25


class BrownoutLadder:
    """Burn-rate driven admission ladder on the serving frontend.

    One hysteresis rule on the max fast burn; each trip steps the level
    up by one, each clear steps it down by one, with the rule's
    cooldown spacing consecutive steps. ``level`` is observable state;
    the daemon applies it through the actuators."""

    def __init__(self, *, burn_trip: float, clear_frac: float,
                 hold_ticks: int, cooldown_s: float):
        self.level = 0
        self._rule = HysteresisRule(
            "brownout_burn", burn_trip, clear_frac=clear_frac,
            hold_ticks=hold_ticks, cooldown_s=cooldown_s)
        self._hold_ticks = max(1, int(hold_ticks))
        self._cooldown_s = float(cooldown_s)
        self._above = 0
        self._last_step = float("-inf")

    def decide(self, fast_burn: float | None, now: float) -> int | None:
        """Returns the new target level, or None for no change."""
        edge = self._rule.observe(fast_burn, now)
        if edge == "trip" and self.level < BROWNOUT_MAX_LEVEL:
            self._above = 0
            self._last_step = now
            return self.level + 1
        if edge == "clear" and self.level > 0:
            # a clear steps all the way down: the burn is back under
            # the clear threshold, holding degraded admission longer
            # only sheds users for no reason
            self._above = 0
            self._last_step = now
            return 0
        # sustained overload escalates: the rule stays tripped (its
        # trip edge cannot re-fire), so a burn HOLDING at/over the
        # threshold — overload the current level did not relieve —
        # steps one more rung, with the same hold/cooldown spacing as
        # the entry edge
        if (self._rule.tripped and fast_burn is not None
                and fast_burn >= self._rule.trip_at
                and self.level < BROWNOUT_MAX_LEVEL):
            self._above += 1
            if (self._above >= self._hold_ticks
                    and now - self._last_step >= self._cooldown_s):
                self._above = 0
                self._last_step = now
                return self.level + 1
        else:
            self._above = 0
        return None


# -------------------------------------------------------------- quarantine
Q_OK = "ok"
Q_QUARANTINED = "quarantined"
Q_LEFT = "left"


class WorkerState:
    """One worker's quarantine state machine."""

    def __init__(self, wid: int):
        self.wid = wid
        self.state = Q_OK
        self.since = 0.0
        self.clean = 0
        self.why = ""
        self.readmitted_at = float("-inf")


class QuarantineManager:
    """Sick-worker detection and re-admission bookkeeping.

    ``decide(signals, now)`` returns a list of decisions the daemon
    executes: ``("quarantine", wid, why)``, ``("readmit", wid)``,
    ``("leave", wid, why)``. Probing is the daemon's job (it owns the
    probe function); this class only tracks state so decisions stay
    unit-testable without a fleet."""

    def __init__(self, *, unhealthy_pings: int, clean_probes: int,
                 dead_after_s: float, telemetry_lag_s: float,
                 readmit_grace_s: float = 5.0):
        self.unhealthy_pings = int(unhealthy_pings)
        self.clean_probes = int(clean_probes)
        self.dead_after_s = float(dead_after_s)
        self.telemetry_lag_s = float(telemetry_lag_s)
        #: sick signals ignored this long after a re-admission: the
        #: supervisor's ping-failure counter and the telemetry lag both
        #: trail a genuinely healed worker by one publish interval, and
        #: re-quarantining on that stale echo would flap
        self.readmit_grace_s = float(readmit_grace_s)
        self.workers: dict[int, WorkerState] = {}

    def _get(self, wid: int) -> WorkerState:
        if wid not in self.workers:
            self.workers[wid] = WorkerState(wid)
        return self.workers[wid]

    def quarantined(self) -> list[int]:
        return sorted(w.wid for w in self.workers.values()
                      if w.state == Q_QUARANTINED)

    def _sick_reason(self, sig, wid: int) -> str | None:
        if sig.worker_running.get(wid) is False:
            return "process dead"
        pf = sig.ping_failures.get(wid, 0)
        if pf >= self.unhealthy_pings:
            return f"{pf} consecutive ping failures"
        lag = sig.telemetry_lag_s.get(wid)
        if lag is not None and lag >= self.telemetry_lag_s:
            return f"telemetry silent {lag:.0f}s"
        return None

    def decide(self, sig, now: float) -> list[tuple]:
        out = []
        for wid in sorted(sig.known_workers()):
            ws = self._get(wid)
            if ws.state == Q_OK:
                if now - ws.readmitted_at < self.readmit_grace_s:
                    continue
                why = self._sick_reason(sig, wid)
                if why is not None:
                    ws.state = Q_QUARANTINED
                    ws.since = now
                    ws.clean = 0
                    ws.why = why
                    out.append(("quarantine", wid, why))
            elif ws.state == Q_QUARANTINED:
                if now - ws.since >= self.dead_after_s:
                    ws.state = Q_LEFT
                    out.append(("leave", wid,
                                f"unhealthy {now - ws.since:.0f}s"))
        return out

    def quarantine_now(self, wid: int, now: float, why: str = "") -> None:
        """Force a worker into quarantine from OUTSIDE the sick-signal
        scan — the DivergenceWatch arm's entry point: an audit
        divergence is direct evidence of wrong answers, not a health
        inference, so it bypasses ``_sick_reason``. The worker then
        earns re-admission through the SAME probation loop (N clean
        probes) as every other quarantine."""
        ws = self._get(wid)
        if ws.state == Q_QUARANTINED:
            return
        ws.state = Q_QUARANTINED
        ws.since = now
        ws.clean = 0
        ws.why = why

    def probe_result(self, wid: int, ok: bool) -> bool:
        """Book one probe outcome for a quarantined worker; True when
        the worker has earned re-admission (caller executes it and then
        calls :meth:`readmitted`)."""
        ws = self._get(wid)
        if ws.state != Q_QUARANTINED:
            return False
        ws.clean = ws.clean + 1 if ok else 0
        return ws.clean >= self.clean_probes

    def readmitted(self, wid: int, now: float | None = None) -> None:
        ws = self._get(wid)
        ws.state = Q_OK
        ws.clean = 0
        ws.why = ""
        ws.readmitted_at = time.monotonic() if now is None else now


# ----------------------------------------------------------------- repair
class RepairScaler:
    """Elastic repair decisions: capacity and placement, not health.

    * Sustained fleet-wide queue saturation trips the *starvation* rule
      → ``("join", host)`` when a join target is configured, else
      ``("scale_advise",)`` (lane widening needs a worker restart with
      a wider ``DOS_MESH_DEVICES``; the daemon cannot re-exec workers,
      so it books the advisory for the operator/orchestrator).
    * A single shard holding more than ``hot_frac`` of all queued work
      while the fleet is busy trips the *hot-shard* rule →
      ``("replicate", shard)`` — raise that shard's replication via
      chained declustering instead of fleet-wide R."""

    def __init__(self, *, starve_frac: float, hot_frac: float,
                 clear_frac: float, hold_ticks: int, cooldown_s: float,
                 join_host: str = ""):
        self.join_host = join_host
        self._starve = HysteresisRule(
            "starvation", starve_frac, clear_frac=clear_frac,
            hold_ticks=hold_ticks, cooldown_s=cooldown_s)
        self._hot = HysteresisRule(
            "hot_shard", hot_frac, clear_frac=clear_frac,
            hold_ticks=hold_ticks, cooldown_s=cooldown_s)

    def decide(self, sig, now: float) -> list[tuple]:
        out = []
        # starvation evidence comes from BOTH admission sensors when
        # present: shard queue saturation (FIFO/engine lanes queue in
        # the frontend) and RPC credit-window occupancy (streaming
        # lanes queue in the worker — a starved RPC fleet shows full
        # windows, not deep frontend queues). Either alone is an
        # observation; neither reporting holds the rule's state (0.0
        # from an absent sensor must not clear it, but a genuinely
        # drained fleet must be able to)
        evidence = []
        if sig.queue_depths:
            evidence.append(sig.queue_frac)
        if getattr(sig, "credit_occupancy", None):
            evidence.append(sig.credit_frac)
        frac = max(evidence) if evidence else None
        if self._starve.observe(frac, now) == "trip":
            if self.join_host:
                out.append(("join", self.join_host))
            else:
                out.append(("scale_advise",))
        # only meaningful when there is real queued work to be skewed
        hot = sig.hot_frac if sum(sig.queue_depths.values()) >= 4 else None
        if (self._hot.observe(hot, now) == "trip"
                and sig.hot_shard is not None):
            out.append(("replicate", sig.hot_shard))
        return out


class DivergenceWatch:
    """Answer-audit divergences → quarantine decisions.

    The auditor already verified the divergence on an independent lane,
    so — like :class:`GatewayWatch` — this arm needs no trip/clear
    hysteresis: ONE confirmed wrong answer is evidence enough. It acts
    on DELTAS of the auditor's per-shard cumulative counts, with a
    per-shard cooldown so a stream of divergences from one rotten shard
    yields one quarantine per window. The high-water mark advances only
    when the decision is actually emitted (cooldown-ready): a
    divergence that arrives mid-cooldown is re-considered on the next
    ready tick rather than silently forgotten."""

    def __init__(self, *, cooldown_s: float = 30.0):
        self._cooldown = Cooldown(cooldown_s)
        self._seen: dict[int, int] = {}

    def decide(self, sig, now: float) -> list[tuple]:
        out = []
        for wid, count in sorted(sig.audit_divergent.items()):
            wid, count = int(wid), int(count)
            fresh = count - self._seen.get(wid, 0)
            if fresh <= 0:
                continue
            key = f"diverge:{wid}"
            if not self._cooldown.ready(key, now):
                continue
            self._cooldown.mark(key, now)
            self._seen[wid] = count
            out.append(("divergence_quarantine", wid,
                        f"{fresh} audit divergence(s) "
                        f"({count} cumulative)"))
        return out


class GatewayWatch:
    """Gateway frontend liveness: turn expired endpoint leases into
    kick decisions.

    The lease TTL already encodes the detection hysteresis (a frontend
    is only in ``sig.gateway_dead`` after a full TTL of silence), so
    this arm needs no trip/clear edge — just a per-frontend cooldown so
    one dead replica yields one kick per window, not one per tick, and
    a respawn gets a full lease of grace to re-register before the
    daemon considers it dead again."""

    def __init__(self, *, cooldown_s: float = 30.0):
        self._cooldown = Cooldown(cooldown_s)

    def decide(self, sig, now: float) -> list[tuple]:
        out = []
        for fid in sig.gateway_dead:
            key = f"gwkick:{int(fid)}"
            if self._cooldown.ready(key, now):
                self._cooldown.mark(key, now)
                stale = sig.gateway_lease_stale_s.get(int(fid))
                why = (f"endpoint lease stale {stale:.1f}s"
                       if isinstance(stale, (int, float))
                       else "endpoint lease expired")
                out.append(("kick", int(fid), why))
        return out
