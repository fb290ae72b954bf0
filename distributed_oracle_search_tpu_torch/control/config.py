"""Control-plane knobs (``DOS_CONTROL*``), one frozen dataclass.

Same policy home as :class:`serving.config.ServeConfig`: every knob is
read through :mod:`utils.env` (malformed values degrade to defaults,
logged), ``validate()`` raises on impossible combinations, and the
daemon only ever sees an immutable snapshot — mid-flight env edits
cannot half-apply."""

from __future__ import annotations

import dataclasses

from ..utils.env import env_cast, env_flag, env_str
from ..utils.log import get_logger

log = get_logger(__name__)


@dataclasses.dataclass(frozen=True)
class ControlConfig:
    """Policy daemon configuration. ``enabled`` gates construction
    entirely: when False the daemon object is never built and no
    ``control_*`` metric or statusz section exists (byte-identical
    legacy behavior)."""

    enabled: bool = False        #: DOS_CONTROL — master switch
    interval_s: float = 2.0      #: DOS_CONTROL_INTERVAL_S — tick cadence
    dry_run: bool = False        #: DOS_CONTROL_DRY_RUN — book, don't act
    budget: int = 12             #: DOS_CONTROL_BUDGET — actions / window
    budget_window_s: float = 300.0  #: DOS_CONTROL_BUDGET_WINDOW_S
    cooldown_s: float = 15.0     #: DOS_CONTROL_COOLDOWN_S — per actuator
    hold_ticks: int = 2          #: consecutive ticks before a rule trips
    clear_frac: float = 0.5      #: clear threshold = trip * clear_frac
    brownout_burn: float = 14.4  #: DOS_CONTROL_BROWNOUT_BURN — fast-burn
    #: ping failures before a running worker is deemed sick (mirrors the
    #: supervisor's DOS_SUPERVISOR_UNHEALTHY_PINGS but trips the
    #: *routing* quarantine, which is safe even when the supervisor's
    #: opt-in kill path is disarmed)
    unhealthy_pings: int = 2     #: DOS_CONTROL_UNHEALTHY_PINGS
    clean_probes: int = 2        #: DOS_CONTROL_CLEAN_PROBES — re-admission
    dead_after_s: float = 120.0  #: DOS_CONTROL_DEAD_AFTER_S — plan_leave
    starve_frac: float = 0.9     #: DOS_CONTROL_STARVE_FRAC — queue frac
    telemetry_lag_s: float = 30.0  #: DOS_CONTROL_TELEMETRY_LAG_S
    hot_shard_frac: float = 0.6  #: DOS_CONTROL_HOT_FRAC — zipf hotspot
    join_host: str = ""          #: DOS_CONTROL_JOIN_HOST — scale target

    @classmethod
    def from_env(cls) -> "ControlConfig":
        cfg = cls(
            enabled=env_flag("DOS_CONTROL", False),
            interval_s=env_cast("DOS_CONTROL_INTERVAL_S", 2.0, float),
            dry_run=env_flag("DOS_CONTROL_DRY_RUN", False),
            budget=env_cast("DOS_CONTROL_BUDGET", 12, int),
            budget_window_s=env_cast(
                "DOS_CONTROL_BUDGET_WINDOW_S", 300.0, float),
            cooldown_s=env_cast("DOS_CONTROL_COOLDOWN_S", 15.0, float),
            hold_ticks=env_cast("DOS_CONTROL_HOLD_TICKS", 2, int),
            clear_frac=env_cast("DOS_CONTROL_CLEAR_FRAC", 0.5, float),
            brownout_burn=env_cast(
                "DOS_CONTROL_BROWNOUT_BURN", 14.4, float),
            unhealthy_pings=env_cast(
                "DOS_CONTROL_UNHEALTHY_PINGS", 2, int),
            clean_probes=env_cast("DOS_CONTROL_CLEAN_PROBES", 2, int),
            dead_after_s=env_cast("DOS_CONTROL_DEAD_AFTER_S", 120.0,
                                  float),
            starve_frac=env_cast("DOS_CONTROL_STARVE_FRAC", 0.9, float),
            telemetry_lag_s=env_cast(
                "DOS_CONTROL_TELEMETRY_LAG_S", 30.0, float),
            hot_shard_frac=env_cast("DOS_CONTROL_HOT_FRAC", 0.6, float),
            join_host=env_str("DOS_CONTROL_JOIN_HOST", "") or "",
        )
        try:
            cfg.validate()
        except ValueError as e:
            log.warning("control config invalid (%s); disabling daemon",
                        e)
            cfg = dataclasses.replace(cfg, enabled=False)
        return cfg

    def validate(self) -> None:
        if self.interval_s <= 0:
            raise ValueError("interval_s must be > 0")
        if self.budget < 1:
            raise ValueError("budget must be >= 1")
        if self.budget_window_s <= 0:
            raise ValueError("budget_window_s must be > 0")
        if self.cooldown_s < 0:
            raise ValueError("cooldown_s must be >= 0")
        if self.hold_ticks < 1:
            raise ValueError("hold_ticks must be >= 1")
        if not (0.0 < self.clear_frac <= 1.0):
            raise ValueError("clear_frac must be in (0, 1]")
        if self.clean_probes < 1:
            raise ValueError("clean_probes must be >= 1")
        if not (0.0 < self.starve_frac <= 1.0):
            raise ValueError("starve_frac must be in (0, 1]")
        if not (0.0 < self.hot_shard_frac <= 1.0):
            raise ValueError("hot_shard_frac must be in (0, 1]")
