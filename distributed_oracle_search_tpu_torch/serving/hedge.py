"""Hedged dispatch: tail-latency insurance for replicated shards.

"The Tail at Scale" recipe: when a batch has been in flight on its
primary longer than the shard's recent latency quantile says it should
be, issue a DUPLICATE request to a replica and take whichever answer
lands first. The slow primary (GC pause, wedged FIFO reader, overloaded
host) stops defining the batch's latency; the duplicate work is bounded
by a hedge-rate budget so hedging can never amplify an overload (a
saturated cluster makes everything slow — hedging *more* there would be
gasoline).

Pieces:

* :class:`HedgeConfig` — the ``DOS_HEDGE_*`` env knobs (same
  degrade-don't-crash policy as ``DOS_SERVE_*``):
  ``DOS_HEDGE_QUANTILE`` (which latency quantile arms the hedge,
  default 0.95), ``DOS_HEDGE_MIN_MS`` (delay floor — also the cold
  default before enough samples exist), ``DOS_HEDGE_BUDGET`` (max
  fraction of dispatched batches that may hedge, default 0.1),
  ``DOS_HEDGE_WINDOW`` (per-shard latency samples kept),
  ``DOS_HEDGE_DISABLE=1`` (failover still works, no duplicates).
* :class:`HedgeTracker` — per-shard latency ring buffers (the adaptive
  delay) plus the budget accounting. Thread-safe; one per frontend.

The frontend drives it: primary dispatch starts, and if no answer lands
within ``tracker.delay_s(wid)`` AND ``tracker.try_issue()`` grants
budget, a duplicate goes to the next live replica; first answer
completes the batch (``hedges_won_total`` when the replica beat the
primary). The loser's thread finishes in the background and its result
is discarded — the wire/engine layers are idempotent (same rows, same
deterministic kernels), so a duplicate answer is merely redundant,
never wrong.
"""

from __future__ import annotations

import dataclasses
from collections import deque

from ..obs import metrics as obs_metrics
from ..utils.env import env_cast
from ..utils.locks import OrderedLock
from ..utils.log import get_logger

log = get_logger(__name__)

M_ISSUED = obs_metrics.counter(
    "hedges_issued_total",
    "duplicate (hedged) batch dispatches sent to a replica")
M_WON = obs_metrics.counter(
    "hedges_won_total",
    "hedged dispatches whose replica answered before the primary")
M_BUDGET_DENIED = obs_metrics.counter(
    "hedges_budget_denied_total",
    "hedge opportunities declined because the hedge-rate budget was "
    "spent (the overload-amplification guard)")


@dataclasses.dataclass(frozen=True)
class HedgeConfig:
    """Hedged-dispatch tunables (``DOS_HEDGE_*`` family)."""

    enabled: bool = True
    quantile: float = 0.95
    min_delay_ms: float = 2.0
    budget: float = 0.1
    window: int = 128

    @classmethod
    def from_env(cls, **overrides) -> "HedgeConfig":
        vals = dict(
            enabled=env_cast("DOS_HEDGE_DISABLE", 0, int) != 1,
            quantile=env_cast("DOS_HEDGE_QUANTILE", cls.quantile, float),
            min_delay_ms=env_cast("DOS_HEDGE_MIN_MS", cls.min_delay_ms,
                                  float),
            budget=env_cast("DOS_HEDGE_BUDGET", cls.budget, float),
            window=env_cast("DOS_HEDGE_WINDOW", cls.window, int),
        )
        vals.update({k: v for k, v in overrides.items()
                     if v is not None})
        return cls(**vals).validate()

    def validate(self) -> "HedgeConfig":
        if not 0.0 < self.quantile < 1.0:
            raise ValueError(
                f"hedge quantile must be in (0, 1), got {self.quantile}")
        if self.min_delay_ms < 0:
            raise ValueError("hedge min delay must be >= 0")
        if not 0.0 <= self.budget <= 1.0:
            raise ValueError(
                f"hedge budget must be a fraction in [0, 1], got "
                f"{self.budget}")
        if self.window <= 0:
            raise ValueError("hedge window must be positive")
        return self


class HedgeTracker:
    """Per-shard dispatch-latency quantiles + the hedge-rate budget.

    ``observe(wid, seconds)`` feeds winners' dispatch latencies;
    ``delay_s(wid)`` answers "how long may this shard's batch run
    before it counts as slow" — the configured quantile over the last
    ``window`` samples, floored at ``min_delay_ms`` (which is also the
    cold-start answer before :data:`MIN_SAMPLES` observations exist,
    so a fresh shard doesn't hedge off noise).

    The budget is global (not per shard): ``try_issue`` grants a hedge
    while ``hedges <= budget * dispatches`` over this tracker's
    lifetime, with a small constant grace so the very first slow batch
    of a run can still hedge.
    """

    #: samples required before the measured quantile replaces the floor
    MIN_SAMPLES = 8
    #: hedges allowed before the proportional budget kicks in
    BUDGET_GRACE = 2

    def __init__(self, config: HedgeConfig | None = None):
        self.config = config or HedgeConfig()
        self._lat: dict[int, deque] = {}
        self._dispatches = 0
        self._hedges = 0
        self._lock = OrderedLock("serving.HedgeTracker")

    # ------------------------------------------------------------ stats
    def observe(self, wid: int, seconds: float) -> None:
        with self._lock:
            self._dispatches += 1
            buf = self._lat.get(wid)
            if buf is None:
                buf = self._lat[wid] = deque(maxlen=self.config.window)
            buf.append(float(seconds))

    def delay_s(self, wid: int) -> float:
        floor = self.config.min_delay_ms / 1e3
        with self._lock:
            buf = self._lat.get(wid)
            if buf is None or len(buf) < self.MIN_SAMPLES:
                return floor
            data = sorted(buf)
        # nearest-rank quantile: index ceil(q*n) - 1
        n = len(data)
        idx = max(0, min(n - 1,
                         int(-(-self.config.quantile * n // 1)) - 1))
        return max(floor, data[idx])

    # ----------------------------------------------------------- budget
    def would_issue(self) -> bool:
        """Read-only budget check (no grant, no counters): could a
        hedge fire right now? The frontend uses it to skip the
        thread-spawning dispatch path entirely while the budget is
        spent — batches that could never hedge stay on the cheap
        inline path."""
        if not self.config.enabled or self.config.budget <= 0:
            return False
        with self._lock:
            return (self._hedges < self.BUDGET_GRACE
                    + self.config.budget * self._dispatches)

    def try_issue(self) -> bool:
        """Grant one hedge if the rate budget allows; books the grant."""
        if not self.config.enabled or self.config.budget <= 0:
            return False
        with self._lock:
            allowed = (self._hedges < self.BUDGET_GRACE
                       + self.config.budget * self._dispatches)
            if allowed:
                self._hedges += 1
                M_ISSUED.inc()
            else:
                M_BUDGET_DENIED.inc()
            return allowed

    def hedge_rate(self) -> float:
        """Hedged fraction of dispatched batches so far (the budget's
        observable)."""
        with self._lock:
            return self._hedges / max(self._dispatches, 1)
