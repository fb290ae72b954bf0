"""SLO burn-rate engine: declarative objectives over the fleet store.

An SLO here is a declarative spec evaluated against the telemetry
timeseries (:mod:`.timeseries`), Google-SRE style multi-window burn
rates: the **burn rate** is how fast the error budget is being spent
(1.0 = exactly on budget; 14.4 over a 5-minute window means a 30-day
99.9% budget gone in ~2 days). Two windows per spec:

* **fast** (``DOS_SLO_FAST_S``, default 300 s, trip threshold
  ``DOS_SLO_FAST_BURN`` = 14.4) — pages on sudden incineration;
* **slow** (``DOS_SLO_SLOW_S``, default 3600 s, threshold
  ``DOS_SLO_SLOW_BURN`` = 6.0) — catches the slow leak the fast window
  averages away.

Alerting has **hysteresis**: a spec trips when its fast burn crosses
the fast threshold, and clears only when the fast burn falls below
``clear_frac`` (default 0.5) of it — a burn oscillating around the
line must not flap the alert.

Spec kinds:

* ``availability`` — bad-event counters (shed/timeout/error series)
  over a total counter, as per-window rates from the store's delta
  series. Burn = (bad/total) / (1 - objective).
* ``latency`` — a quantile-window series (``serve_request_seconds``)
  against a threshold. The bad fraction is estimated from the
  fleet-merged window's quantile ladder (threshold above p99 → within
  budget; below p50 → most requests are slow), which is exactly the
  resolution the windows ship — coarse, monotone, and enough to flip
  a 14.4× burn alert when a fault lands.

Specs come from ``DOS_SLO_SPECS`` (a JSON file of spec objects —
unknown keys tolerated, the annotation contract) or default to the
serving availability + latency pair. Results are exposed three ways:
``slo_*`` gauges on ``/metrics``, the ``/slo`` JSON endpoint
(``obs.http``), and ``dos-obs slo``. Alert transitions land on the
flight-recorder bus (:func:`.recorder.emit`).
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time

from ..utils.env import env_cast, env_str
from ..utils.locks import OrderedLock
from ..utils.log import get_logger
from . import metrics as obs_metrics
from . import recorder as obs_recorder

log = get_logger(__name__)

M_EVALS = obs_metrics.counter(
    "slo_evaluations_total", "burn-rate evaluation passes")
M_ALERTS = obs_metrics.counter(
    "slo_alerts_total", "specs that transitioned into alerting")

#: default bad-event counters for the serving availability SLO — the
#: frontend's shed/degrade paths (obs map: "admission control")
_DEFAULT_BAD = ("serve_shed_busy_total", "serve_shed_unavailable_total",
                "serve_timeouts_total", "serve_errors_total")


@dataclasses.dataclass
class SLOSpec:
    """One declarative objective. ``kind`` is ``availability`` (bad
    counters / total counter) or ``latency`` (quantile window vs
    threshold)."""

    name: str
    kind: str = "availability"
    objective: float = 0.999          # good fraction promised
    # availability inputs
    total: str = "serve_requests_total"
    bad: tuple = _DEFAULT_BAD
    # latency inputs
    window: str = "serve_request_seconds"
    threshold_s: float = 0.5

    @property
    def budget(self) -> float:
        """The error budget (bad fraction allowed)."""
        return max(1.0 - float(self.objective), 1e-9)


def default_specs() -> list[SLOSpec]:
    return [
        SLOSpec(name="serve_availability", kind="availability",
                objective=0.999),
        SLOSpec(name="serve_latency", kind="latency", objective=0.99,
                threshold_s=env_cast("DOS_SLO_LATENCY_THRESHOLD_S",
                                     0.5, float)),
    ]


def parse_specs(doc) -> list[SLOSpec]:
    """Spec objects from a JSON document (list of dicts). Unknown keys
    are tolerated per entry; a malformed entry is skipped with a log
    line — one typo must not disarm the whole SLO page."""
    out = []
    if not isinstance(doc, list):
        raise ValueError("SLO spec document must be a JSON list")
    fields = {f.name for f in dataclasses.fields(SLOSpec)}
    for i, entry in enumerate(doc):
        if not isinstance(entry, dict) or not entry.get("name"):
            log.warning("skipping malformed SLO spec #%d: %r", i, entry)
            continue
        kw = {k: v for k, v in entry.items() if k in fields}
        if isinstance(kw.get("bad"), list):
            kw["bad"] = tuple(kw["bad"])
        try:
            out.append(SLOSpec(**kw))
        except (TypeError, ValueError) as e:
            log.warning("skipping malformed SLO spec #%d: %s", i, e)
    return out


def load_specs() -> list[SLOSpec]:
    """Specs from ``DOS_SLO_SPECS`` (JSON file path), defaulting to the
    serving pair. Unreadable file degrades to the defaults, logged —
    the knob policy."""
    path = env_str("DOS_SLO_SPECS")
    if not path:
        return default_specs()
    try:
        with open(path) as f:
            return parse_specs(json.load(f))
    except (OSError, ValueError) as e:
        log.warning("ignoring DOS_SLO_SPECS=%r (%s); using defaults",
                    path, e)
        return default_specs()


def _bad_fraction_from_window(snap: dict, threshold_s: float) -> float:
    """Estimate the slow-request fraction from a quantile ladder:
    monotone steps at the quantiles the window ships. Threshold above
    p99 → 0 (unresolvable below 1%, which is within a 99% objective's
    budget); below p50 → 0.75 (most of the window is slow)."""
    qs = snap.get("quantiles") or {}
    bad = 0.0
    for q, frac in (("p99", 0.01), ("p95", 0.05), ("p50", 0.75)):
        v = qs.get(q)
        if isinstance(v, (int, float)) and threshold_s < v:
            bad = frac
    return bad


class SLOEngine:
    """Evaluates every spec's fast/slow burn against the store and
    keeps the ``slo_*`` gauges, the ``/slo`` payload, and the alert
    state machine current."""

    def __init__(self, store, specs: list[SLOSpec] | None = None,
                 fast_s: float | None = None,
                 slow_s: float | None = None,
                 fast_threshold: float | None = None,
                 slow_threshold: float | None = None,
                 clear_frac: float = 0.5, clock=time.time):
        self.store = store
        self.specs = list(specs) if specs is not None else load_specs()
        self.fast_s = float(fast_s if fast_s is not None
                            else env_cast("DOS_SLO_FAST_S", 300.0,
                                          float))
        self.slow_s = float(slow_s if slow_s is not None
                            else env_cast("DOS_SLO_SLOW_S", 3600.0,
                                          float))
        self.fast_threshold = float(
            fast_threshold if fast_threshold is not None
            else env_cast("DOS_SLO_FAST_BURN", 14.4, float))
        self.slow_threshold = float(
            slow_threshold if slow_threshold is not None
            else env_cast("DOS_SLO_SLOW_BURN", 6.0, float))
        self.clear_frac = float(clear_frac)
        self.clock = clock
        self._alerting: dict[str, float] = {}   # name -> trip ts
        self._last: dict = {}
        self._lock = OrderedLock("slo.SLOEngine")
        self._gauges = {}
        for spec in self.specs:
            self._gauges[spec.name] = (
                obs_metrics.gauge(
                    f"slo_fast_burn_{spec.name}",
                    f"fast-window burn rate of SLO {spec.name}"),
                obs_metrics.gauge(
                    f"slo_slow_burn_{spec.name}",
                    f"slow-window burn rate of SLO {spec.name}"),
                obs_metrics.gauge(
                    f"slo_alerting_{spec.name}",
                    f"1 while SLO {spec.name} is in alert"))
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # --------------------------------------------------------- evaluate
    def _burn(self, spec: SLOSpec, window_s: float,
              now: float) -> float | None:
        """One spec's burn over one window; None with no data."""
        if spec.kind == "latency":
            snap = self.store.fleet_window(
                spec.window, max_age_s=max(window_s, 60.0), now=now)
            if snap is None:
                return None
            bad = _bad_fraction_from_window(snap, spec.threshold_s)
            return bad / spec.budget
        total = self.store.rate(spec.total, window_s, now=now)
        if total <= 0:
            return None
        bad = sum(self.store.rate(name, window_s, now=now)
                  for name in spec.bad)
        return (bad / total) / spec.budget

    def evaluate(self, now: float | None = None) -> dict:
        """One pass over every spec: update gauges, run the hysteresis
        state machine, return the ``/slo`` payload."""
        now = self.clock() if now is None else now
        M_EVALS.inc()
        out = {}
        transitions = []
        with self._lock:
            for spec in self.specs:
                fast = self._burn(spec, self.fast_s, now)
                slow = self._burn(spec, self.slow_s, now)
                g_fast, g_slow, g_alert = self._gauges[spec.name]
                g_fast.set(fast or 0.0)
                g_slow.set(slow or 0.0)
                tripped = spec.name in self._alerting
                if (not tripped and fast is not None
                        and fast >= self.fast_threshold):
                    self._alerting[spec.name] = now
                    tripped = True
                    M_ALERTS.inc()
                    transitions.append(("slo_alert", spec, fast))
                elif tripped and (
                        fast is None
                        or fast <= self.fast_threshold
                        * self.clear_frac):
                    del self._alerting[spec.name]
                    tripped = False
                    transitions.append(("slo_clear", spec, fast))
                g_alert.set(1.0 if tripped else 0.0)
                out[spec.name] = {
                    "kind": spec.kind,
                    "objective": spec.objective,
                    "fast_burn": fast,
                    "slow_burn": slow,
                    "fast_window_s": self.fast_s,
                    "slow_window_s": self.slow_s,
                    "fast_threshold": self.fast_threshold,
                    "slow_threshold": self.slow_threshold,
                    "alerting": tripped,
                    "alert_since": self._alerting.get(spec.name),
                }
                if spec.kind == "latency":
                    out[spec.name]["threshold_s"] = spec.threshold_s
            self._last = out
        for kind, spec, burn in transitions:
            # emitted OUTSIDE the engine lock: the bus appends to its
            # own ring and may write the on-disk tape
            log.warning("%s: %s (fast burn %.2f, threshold %.2f)",
                        kind, spec.name, burn or 0.0,
                        self.fast_threshold)
            obs_recorder.emit(kind, slo=spec.name,
                              burn=round(burn, 3) if burn is not None
                              else None,
                              threshold=self.fast_threshold, ts=now)
        return out

    # ----------------------------------------------------------- access
    def payload(self) -> dict:
        """The ``/slo`` endpoint body (evaluates fresh — a scrape sees
        the current burn, not the last eval tick's)."""
        return self.evaluate()

    def alerting(self) -> list[str]:
        with self._lock:
            return sorted(self._alerting)

    def statusz(self) -> dict:
        with self._lock:
            last = dict(self._last)
            alerting = sorted(self._alerting)
        return {"specs": [s.name for s in self.specs],
                "alerting": alerting,
                "fast_window_s": self.fast_s,
                "slow_window_s": self.slow_s,
                "burn": {name: {"fast": v.get("fast_burn"),
                                "slow": v.get("slow_burn"),
                                "alerting": v.get("alerting")}
                         for name, v in last.items()}}

    # -------------------------------------------------------- lifecycle
    def start(self, interval_s: float | None = None) -> "SLOEngine":
        """Background evaluation loop (``DOS_SLO_EVAL_S``, default 5 s)
        so gauges and the alert state machine advance even between
        scrapes."""
        if self._thread is not None:
            return self
        interval = float(interval_s if interval_s is not None
                         else env_cast("DOS_SLO_EVAL_S", 5.0, float))
        if interval <= 0:
            return self
        self._stop.clear()

        def loop():
            while not self._stop.wait(interval):
                try:
                    self.evaluate()
                except Exception as e:  # noqa: BLE001 — the eval loop
                    # outlives any one bad pass
                    log.exception("slo evaluation failed: %s", e)

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="dos-slo-eval")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
