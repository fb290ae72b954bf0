"""Closed-loop control plane: sense -> decide -> act.

The fleet grew every sensor (telemetry bus, SLO burn-rate engine,
heartbeat RTT windows, breaker states) and every actuator (supervisor
respawn, replication/hedging, drain-free ``plan_join``/``plan_leave``)
before anything connected them; until this package a hung worker or a
zipf hotspot degraded service until an operator noticed. The
:class:`~distributed_oracle_search_tpu.control.daemon.ControlDaemon`
closes the loop: a single background thread runs on a
``DOS_CONTROL_INTERVAL_S`` cadence, reads the sensors
(:mod:`.signals`), evaluates declarative rules with trip/clear
hysteresis and per-actuator cooldowns (:mod:`.policy`), and executes
recovery actions (:mod:`.actuators`) under a global action budget.
``DOS_CONTROL_DRY_RUN=1`` books every decision (metrics + flight
recorder) without executing anything; ``DOS_CONTROL=0`` (the default)
never constructs the daemon, keeping legacy behavior byte-identical.

Escalation ladder, least to most invasive:

1. **Brownout** — shrink the hedge budget, shed the ``mat``/``alt``
   query families, tighten deadlines; entered and exited by SLO burn
   rate so overload degrades quality before availability.
2. **Quarantine** — a worker failing pings or leaking burn is removed
   from routing (breaker force-open), supervisor-respawned, and
   re-admitted only after N clean probes.
3. **Repair/scale** — sustained starvation executes ``plan_join``
   (or books a lane-widening advisory where a membership move costs
   more); a permanently dead worker executes ``plan_leave`` through
   the dual-read window; zipf-hot shards get selective replication
   raised.
4. **Warming** — the next diff epoch's fused delta is materialized
   ahead of the pump cadence so swap stall never hits a user.
"""

from .config import ControlConfig
from .daemon import ControlDaemon, maybe_daemon

__all__ = ["ControlConfig", "ControlDaemon", "maybe_daemon"]
