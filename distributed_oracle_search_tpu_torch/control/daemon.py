"""The policy daemon: one thread, sense -> decide -> act, journaled.

Every decision flows through :meth:`ControlDaemon._decide`, which is
where the safety envelope lives: ``DOS_CONTROL_DRY_RUN`` books the
decision (metric + flight-recorder event) without calling the
actuator; the global :class:`~.policy.ActionBudget` caps executed
actions per sliding window; actuator exceptions are counted and the
loop keeps ticking. The flight recorder gets one structured event per
decision (``control_*`` kinds) so ``dos-obs replay`` renders the
causal incident timeline: detect -> quarantine -> respawn -> probe ->
readmit, interleaved with the faults and SLO alerts that caused them.
"""

from __future__ import annotations

import threading
import time

from ..obs import metrics as obs_metrics
from ..obs import recorder as obs_recorder
from ..utils.log import get_logger
from .actuators import Actuators
from .config import ControlConfig
from .policy import (ActionBudget, BrownoutLadder, Cooldown,
                     DivergenceWatch, GatewayWatch, QuarantineManager,
                     RepairScaler)
from .signals import SignalReader

log = get_logger(__name__)

M_TICKS = obs_metrics.counter(
    "control_ticks_total", "sense->decide->act loop passes")
M_DECISIONS = obs_metrics.counter(
    "control_decisions_total",
    "policy decisions reached (executed, dry-run, or budget-denied)")
M_ACTIONS = obs_metrics.counter(
    "control_actions_total", "reconfiguration actions executed")
M_BUDGET_DENIED = obs_metrics.counter(
    "control_budget_denied_total",
    "decisions not executed: global action budget exhausted")
M_ERRORS = obs_metrics.counter(
    "control_errors_total", "actuator executions that raised")
M_QUARANTINES = obs_metrics.counter(
    "control_quarantines_total",
    "sick workers removed from routing (breaker pin + respawn kick)")
M_READMISSIONS = obs_metrics.counter(
    "control_readmissions_total",
    "quarantined workers re-admitted after N clean probes")
M_BROWNOUT_SHIFTS = obs_metrics.counter(
    "control_brownout_shifts_total", "brownout ladder level changes")
G_BROWNOUT = obs_metrics.gauge(
    "control_brownout_level",
    "current brownout ladder level (0 = full service)")
M_REPAIRS = obs_metrics.counter(
    "control_repairs_total",
    "elastic repairs executed (plan_join / plan_leave / replication)")
M_SCALE_ADVISED = obs_metrics.counter(
    "control_scale_advised_total",
    "scale-up advisories booked (no join host / lane widening needs a "
    "worker restart)")
M_WARMS = obs_metrics.counter(
    "control_warms_total",
    "predictive warm actions (next diff epoch pre-fused, warmers run)")
M_GATEWAY_KICKS = obs_metrics.counter(
    "control_gateway_kicks_total",
    "dead gateway frontends kicked for respawn (expired endpoint "
    "lease in gateway.json)")
M_DIVERGENCE_Q = obs_metrics.counter(
    "control_divergence_quarantines_total",
    "shards pulled from routing on a confirmed audit divergence "
    "(breaker force-open + scrub-now; re-admitted after clean probes)")


class ControlDaemon:
    """Sense->decide->act loop over injectable providers (all optional;
    see :class:`~.signals.SignalReader` and
    :class:`~.actuators.Actuators` for what each enables).

    ``probe_fn(wid) -> bool`` is the quarantine probation check; when
    absent it falls back to the supervisor's probe, then to "process is
    running" — the weakest evidence that still beats none."""

    def __init__(self, config: ControlConfig | None = None, *,
                 slo=None, frontend=None, supervisor=None,
                 registry=None, breaker_key=None, membership=None,
                 ingest=None, replicate_fn=None, warm_fns=(),
                 probe_fn=None, gateway=None, gateway_respawn_fn=None,
                 integrity=None, scrub_fn=None, clock=time.monotonic):
        self.config = config or ControlConfig.from_env()
        self.clock = clock
        self.signals = SignalReader(
            ingest=ingest, slo=slo, frontend=frontend,
            supervisor=supervisor, registry=registry,
            breaker_key=breaker_key or (
                getattr(frontend, "_breaker_key", None)),
            gateway=gateway, integrity=integrity, clock=clock)
        self.actuators = Actuators(
            frontend=frontend, supervisor=supervisor, registry=registry,
            breaker_key=breaker_key, membership=membership,
            replicate_fn=replicate_fn, warm_fns=warm_fns,
            gateway_respawn_fn=gateway_respawn_fn, scrub_fn=scrub_fn)
        self.supervisor = supervisor
        self.probe_fn = probe_fn
        cfg = self.config
        self.budget = ActionBudget(cfg.budget, cfg.budget_window_s)
        self.cooldowns = Cooldown(cfg.cooldown_s)
        self.brownout = BrownoutLadder(
            burn_trip=cfg.brownout_burn, clear_frac=cfg.clear_frac,
            hold_ticks=cfg.hold_ticks, cooldown_s=cfg.cooldown_s)
        self.quarantine = QuarantineManager(
            unhealthy_pings=cfg.unhealthy_pings,
            clean_probes=cfg.clean_probes,
            dead_after_s=cfg.dead_after_s,
            telemetry_lag_s=cfg.telemetry_lag_s,
            readmit_grace_s=max(cfg.cooldown_s, 3 * cfg.interval_s))
        self.repair = RepairScaler(
            starve_frac=cfg.starve_frac, hot_frac=cfg.hot_shard_frac,
            clear_frac=cfg.clear_frac, hold_ticks=cfg.hold_ticks,
            cooldown_s=cfg.cooldown_s, join_host=cfg.join_host)
        self.gateway_watch = GatewayWatch(cooldown_s=cfg.cooldown_s)
        self.divergence_watch = DivergenceWatch(cooldown_s=cfg.cooldown_s)
        self.last_action = ""
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # ------------------------------------------------- decision plumbing
    def _decide(self, kind: str, counter, fn, now: float,
                **fields) -> bool:
        """One decision through the safety envelope. Returns True when
        the action actually executed."""
        M_DECISIONS.inc()
        executed = False
        if self.config.dry_run:
            mode = "dry-run"
        elif not self.budget.allow(now):
            M_BUDGET_DENIED.inc()
            mode = "budget-denied"
        else:
            try:
                fn()
                executed = True
                self.budget.book(now)
                M_ACTIONS.inc()
                if counter is not None:
                    counter.inc()
                mode = "executed"
            except Exception as e:  # noqa: BLE001 — one broken
                # actuator must not stop the loop that heals the fleet
                M_ERRORS.inc()
                mode = "error"
                fields["error"] = str(e).split("\n")[0]
                log.exception("control: %s failed", kind)
        desc = " ".join(f"{k}={v}" for k, v in sorted(fields.items()))
        self.last_action = f"{kind}({mode}) {desc}".strip()
        log.info("control: %s", self.last_action)
        obs_recorder.emit(f"control_{kind}", mode=mode,
                          executed=executed, **fields)
        return executed

    # -------------------------------------------------------------- tick
    def tick(self, now: float | None = None) -> None:
        now = self.clock() if now is None else now
        M_TICKS.inc()
        sig = self.signals.read(now)
        self._tick_divergence(sig, now)
        self._tick_quarantine(sig, now)
        self._tick_brownout(sig, now)
        self._tick_repair(sig, now)
        self._tick_gateway(sig, now)
        self._tick_warm(now)

    def _tick_divergence(self, sig, now: float) -> None:
        """DivergenceWatch runs BEFORE the health quarantine scan: a
        shard pulled here enters the same QuarantineManager state, so
        the probation loop below probes it this very tick and the
        normal N-clean-probes re-admission applies. Re-admission is
        gated on the scrub having had its say: ``divergence_quarantine``
        triggered a scrub-now, and a corrupt resident table either
        healed (clean probes follow) or keeps diverging (the next delta
        re-quarantines after readmit_grace)."""
        for decision in self.divergence_watch.decide(sig, now):
            _, wid, why = decision
            if self._decide(
                    "divergence_quarantine", M_DIVERGENCE_Q,
                    lambda w=wid, y=why:
                    self.actuators.divergence_quarantine(w, y),
                    now, wid=wid, why=why):
                self.quarantine.quarantine_now(wid, now, why)

    def _tick_quarantine(self, sig, now: float) -> None:
        for decision in self.quarantine.decide(sig, now):
            if decision[0] == "quarantine":
                _, wid, why = decision
                self._decide(
                    "quarantine", M_QUARANTINES,
                    lambda w=wid, y=why: self.actuators.quarantine(w, y),
                    now, wid=wid, why=why)
            elif decision[0] == "leave":
                _, wid, why = decision
                live = {w for w in sig.known_workers()
                        if w != wid
                        and w not in self.quarantine.quarantined()}
                self._decide(
                    "leave", M_REPAIRS,
                    lambda w=wid, lv=live: self.actuators.leave(w, lv),
                    now, wid=wid, why=why)
        # probation: probe every quarantined worker once per tick; N
        # consecutive clean probes earn re-admission
        for wid in self.quarantine.quarantined():
            ok = self._probe(wid)
            if self.quarantine.probe_result(wid, ok):
                if self._decide(
                        "readmit", M_READMISSIONS,
                        lambda w=wid: self.actuators.readmit(w),
                        now, wid=wid,
                        clean_probes=self.config.clean_probes):
                    self.quarantine.readmitted(wid, now)

    def _probe(self, wid: int) -> bool:
        try:
            if self.probe_fn is not None:
                return bool(self.probe_fn(wid))
            sup = self.supervisor
            if sup is not None:
                w = next((x for x in sup._snapshot() if x.wid == wid),
                         None)
                if w is None or w.proc is None or w.proc.poll() is not None:
                    return False
                st = sup.probe_fn(w)
                return st is not None and getattr(st, "ok", False)
        except Exception as e:  # noqa: BLE001 — a probe bug reads as sick
            log.debug("probe of w%d failed: %s", wid, e)
            return False
        return False

    def _tick_brownout(self, sig, now: float) -> None:
        target = self.brownout.decide(sig.fast_burn, now)
        if target is None:
            return
        prev = self.brownout.level
        if self._decide(
                "brownout", M_BROWNOUT_SHIFTS,
                lambda lv=target: self.actuators.apply_brownout(lv),
                now, level=target, prev=prev,
                burn=round(sig.fast_burn, 2)
                if sig.fast_burn is not None else None):
            self.brownout.level = target
            G_BROWNOUT.set(float(target))
        elif self.config.dry_run:
            # the ladder's hysteresis state must advance in dry-run too
            # (otherwise it re-books the same step every tick forever)
            self.brownout.level = target

    def _tick_repair(self, sig, now: float) -> None:
        for decision in self.repair.decide(sig, now):
            if decision[0] == "join":
                self._decide(
                    "join", M_REPAIRS,
                    lambda h=decision[1]: self.actuators.join(h),
                    now, host=decision[1],
                    queue_frac=round(sig.queue_frac, 3))
            elif decision[0] == "replicate":
                self._decide(
                    "replicate", M_REPAIRS,
                    lambda s=decision[1]: self.actuators.replicate(s),
                    now, shard=decision[1],
                    hot_frac=round(sig.hot_frac, 3))
            elif decision[0] == "scale_advise":
                # an advisory is a booked decision with a no-op action:
                # widening DOS_MESH_DEVICES lanes requires a worker
                # restart this daemon does not own
                M_DECISIONS.inc()
                M_SCALE_ADVISED.inc()
                self.last_action = ("scale_advise "
                                    f"queue_frac={sig.queue_frac:.3f}")
                obs_recorder.emit(
                    "control_scale_advise", mode="advisory",
                    executed=False,
                    queue_frac=round(sig.queue_frac, 3))

    def _tick_gateway(self, sig, now: float) -> None:
        for decision in self.gateway_watch.decide(sig, now):
            _, fid, why = decision
            self._decide(
                "gateway_kick", M_GATEWAY_KICKS,
                lambda f=fid: self.actuators.kick_frontend(f),
                now, fid=fid, why=why)

    def _tick_warm(self, now: float) -> None:
        # warming bypasses the action budget: it is a read-mostly local
        # materialization (fuse the already-streamed next epoch, run
        # registered warmers), not a fleet reconfiguration — and it
        # must not be able to starve a quarantine out of budget slots
        fe = self.actuators.frontend
        warmable = ((fe is not None
                     and getattr(fe, "traffic", None) is not None)
                    or self.actuators.warm_fns)
        if not warmable or not self.cooldowns.ready("warm", now):
            return
        self.cooldowns.mark("warm", now)
        M_DECISIONS.inc()
        if self.config.dry_run:
            self.last_action = "warm(dry-run)"
            obs_recorder.emit("control_warm", mode="dry-run",
                              executed=False)
            return
        try:
            warmed = self.actuators.warm()
        except Exception as e:  # noqa: BLE001
            M_ERRORS.inc()
            obs_recorder.emit("control_warm", mode="error",
                              executed=False,
                              error=str(e).split("\n")[0])
            return
        if warmed:
            M_ACTIONS.inc()
            M_WARMS.inc()
            self.last_action = "warm(executed)"
            obs_recorder.emit("control_warm", mode="executed",
                              executed=True)

    # ---------------------------------------------------------- statusz
    def statusz(self) -> dict:
        now = self.clock()
        return {
            "enabled": self.config.enabled,
            "dry_run": self.config.dry_run,
            "interval_s": self.config.interval_s,
            "brownout_level": self.brownout.level,
            "quarantined": self.quarantine.quarantined(),
            "last_action": self.last_action,
            "budget": self.budget.statusz(now),
        }

    # -------------------------------------------------------- lifecycle
    def start(self) -> "ControlDaemon":
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.config.interval_s):
                try:
                    self.tick()
                except Exception as e:  # noqa: BLE001 — the control
                    # loop outlives any one bad tick
                    log.exception("control tick failed: %s", e)

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="dos-control")
        self._thread.start()
        log.info("control daemon up: interval=%.1fs dry_run=%s",
                 self.config.interval_s, self.config.dry_run)
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        self.actuators.stop()


def maybe_daemon(**providers) -> ControlDaemon | None:
    """``DOS_CONTROL`` gate used by both CLIs: None (and nothing
    constructed — byte-identical legacy behavior) unless enabled."""
    cfg = ControlConfig.from_env()
    if not cfg.enabled:
        return None
    return ControlDaemon(cfg, **providers).start()
