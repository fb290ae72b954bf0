"""Sliding-window streaming quantiles with trace exemplars.

The registry's histograms (``obs.metrics``) are process-lifetime
cumulative — perfect for offline snapshots, useless for "what is p99
*right now*" on a resident ``dos-serve``: after a day of traffic one
slow minute vanishes into millions of old samples. This module is the
live half: a :class:`SlidingQuantiles` keeps a ring of rotating time
buckets (window/bucket granularity, default 60 s over 6 buckets), and
quantile reads sort only the samples that fell inside the window — the
scrape endpoint (``obs.http``) exposes them as
``<name>_window{quantile="0.99"}`` gauges next to the cumulative
histogram series.

**Exemplars:** every window additionally remembers the single
worst-case observation it saw and the ``trace_id`` that observation was
stamped with (the same id ``obs.trace`` propagates over the wire and
into Perfetto sidecars). A bad p99 on the scrape is therefore one copy-
paste away from its timeline: open the merged trace and search for the
exemplar's id. Observations without an id still count toward the
quantiles; they just can't win the exemplar slot while an identified
observation is worse-or-equal-visible (an id-less worst is kept too —
better an anonymous exemplar than none).

Cost discipline: ``observe`` is a lock + list append (bounded by
reservoir sampling at ``max_samples`` per bucket), cheap enough to run
unconditionally next to the histogram's ``observe`` on the serve hot
path. Sorting happens only on read (scrape/statusz cadence, not request
cadence).

Instrumented names (the standing windows every process feeds):
``serve_request_seconds`` (frontend end-to-end),
``serve_dispatch_seconds`` (frontend dispatch lanes, hedges included),
``worker_search_seconds`` (engine steady-state search).

Env knobs: ``DOS_OBS_WINDOW_S`` (window length, default 60),
``DOS_OBS_WINDOW_BUCKETS`` (rotation granularity, default 6).

A copy of the JAX package's ``obs/quantiles.py`` (the reservoir's
generator is seeded as there, so one seed gives the same windows).
"""

from __future__ import annotations

import math
import random
import time

from ..utils.env import env_cast
from ..utils.locks import OrderedLock

#: the quantiles every window reports (scrape + statusz)
DEFAULT_QUANTILES = (0.5, 0.95, 0.99)


class _Bucket:
    """One rotation slot: samples + the worst observation seen."""

    __slots__ = ("epoch", "samples", "seen", "worst", "worst_trace")

    def __init__(self):
        self.reset(-1)

    def reset(self, epoch: int) -> None:
        self.epoch = epoch
        self.samples: list[float] = []
        self.seen = 0
        self.worst = None
        self.worst_trace = ""


class SlidingQuantiles:
    """Streaming quantiles over the last ``window_s`` seconds.

    A ring of ``buckets`` time slots, each ``window_s / buckets`` wide;
    an ``observe`` lands in the slot of its epoch (stale slots are
    recycled in place, so rotation is O(1) and needs no timer thread).
    Reads collect every in-window slot's samples and answer
    nearest-rank quantiles; with more than ``max_samples`` observations
    per slot, reservoir sampling keeps an unbiased subset (the exemplar
    is exact regardless — the worst observation always wins its slot).
    """

    def __init__(self, window_s: float = 60.0, buckets: int = 6,
                 max_samples: int = 512, clock=time.monotonic):
        if window_s <= 0 or buckets <= 0 or max_samples <= 0:
            raise ValueError("window_s, buckets, max_samples must be > 0")
        self.window_s = float(window_s)
        self.n_buckets = int(buckets)
        self.bucket_s = self.window_s / self.n_buckets
        self.max_samples = int(max_samples)
        self.clock = clock
        self._ring = [_Bucket() for _ in range(self.n_buckets)]
        self._rng = random.Random(0x0b5)
        self._lock = OrderedLock("quantiles.SlidingQuantiles")

    # ------------------------------------------------------------ write
    def observe(self, v: float, trace_id: str | None = None,
                now: float | None = None) -> None:
        now = self.clock() if now is None else now
        epoch = int(now // self.bucket_s)
        with self._lock:
            b = self._ring[epoch % self.n_buckets]
            if b.epoch != epoch:
                b.reset(epoch)
            b.seen += 1
            if len(b.samples) < self.max_samples:
                b.samples.append(v)
            else:
                # reservoir: every observation keeps an equal chance of
                # being in the retained subset
                i = self._rng.randrange(b.seen)
                if i < self.max_samples:
                    b.samples[i] = v
            if b.worst is None or v > b.worst or (
                    v == b.worst and trace_id and not b.worst_trace):
                b.worst = v
                b.worst_trace = trace_id or ""

    # ------------------------------------------------------------- read
    def _live_locked(self, now: float) -> list[_Bucket]:
        epoch = int(now // self.bucket_s)
        lo = epoch - self.n_buckets + 1
        return [b for b in self._ring if lo <= b.epoch <= epoch]

    def count(self, now: float | None = None) -> int:
        now = self.clock() if now is None else now
        with self._lock:
            return sum(b.seen for b in self._live_locked(now))

    def quantiles(self, qs=DEFAULT_QUANTILES,
                  now: float | None = None) -> dict[float, float] | None:
        """Nearest-rank quantiles over the window; None when empty."""
        now = self.clock() if now is None else now
        with self._lock:
            data = [v for b in self._live_locked(now) for v in b.samples]
        if not data:
            return None
        data.sort()
        n = len(data)
        out = {}
        for q in qs:
            # nearest-rank: ceil(q*n) - 1
            idx = max(0, min(n - 1, math.ceil(q * n) - 1))
            out[q] = data[idx]
        return out

    def worst(self, now: float | None = None):
        """``(value, trace_id)`` of the window's worst observation, or
        None when the window is empty. The trace_id may be ``""`` when
        the worst observation carried none."""
        now = self.clock() if now is None else now
        with self._lock:
            live = [b for b in self._live_locked(now)
                    if b.worst is not None]
            if not live:
                return None
            b = max(live, key=lambda b: b.worst)
            return (b.worst, b.worst_trace)

    def snapshot(self, now: float | None = None) -> dict:
        now = self.clock() if now is None else now
        qs = self.quantiles(now=now)
        w = self.worst(now=now)
        out = {
            "window_s": self.window_s,
            "count": self.count(now=now),
            "quantiles": ({f"p{int(q * 100)}": v for q, v in qs.items()}
                          if qs else {}),
        }
        if w is not None:
            out["worst"] = {"value": w[0], "trace_id": w[1]}
        return out


class QuantileWindows:
    """Name-keyed registry of :class:`SlidingQuantiles` — the live-
    quantile analog of :class:`~.metrics.MetricsRegistry`. Windows are
    get-or-create so instrumented modules can observe without
    declaring; the scrape endpoint renders every window that has ever
    observed."""

    def __init__(self, window_s: float | None = None,
                 buckets: int | None = None, max_samples: int = 512,
                 clock=time.monotonic):
        self.window_s = (window_s if window_s is not None
                         else env_cast("DOS_OBS_WINDOW_S", 60.0, float))
        self.buckets = (buckets if buckets is not None
                        else env_cast("DOS_OBS_WINDOW_BUCKETS", 6, int))
        self.max_samples = max_samples
        self.clock = clock
        self._windows: dict[str, SlidingQuantiles] = {}
        self._lock = OrderedLock("quantiles.QuantileWindows")

    def window(self, name: str) -> SlidingQuantiles:
        with self._lock:
            w = self._windows.get(name)
            if w is None:
                w = SlidingQuantiles(self.window_s, self.buckets,
                                     self.max_samples, clock=self.clock)
                self._windows[name] = w
            return w

    def observe(self, name: str, v: float,
                trace_id: str | None = None) -> None:
        self.window(name).observe(v, trace_id=trace_id)

    def snapshot(self) -> dict:
        with self._lock:
            windows = dict(self._windows)
        return {name: w.snapshot() for name, w in sorted(windows.items())}

    def to_prometheus(self) -> str:
        """Live-quantile gauges: ``<name>_window{quantile="0.99"}``
        samples plus a ``<name>_window_worst`` exemplar sample whose
        ``trace_id`` label links the worst observation to its Perfetto
        timeline, and a ``<name>_window_count`` volume gauge."""
        with self._lock:
            windows = dict(self._windows)
        lines = []
        for name, w in sorted(windows.items()):
            qs = w.quantiles()
            lines.append(f"# TYPE {name}_window gauge")
            lines.append(
                f"# HELP {name}_window live quantiles over the last "
                f"{w.window_s:g}s")
            if qs:
                for q, v in sorted(qs.items()):
                    lines.append(
                        f'{name}_window{{quantile="{q:g}"}} {v:.9g}')
            lines.append(f"{name}_window_count {w.count()}")
            worst = w.worst()
            if worst is not None:
                v, tid = worst
                lines.append(
                    f'{name}_window_worst{{trace_id="{tid}"}} {v:.9g}')
        return "\n".join(lines) + ("\n" if lines else "")

    def reset(self) -> None:
        """Drop every window (tests only)."""
        with self._lock:
            self._windows.clear()


#: process-wide default windows — instrumented modules and the scrape
#: endpoint share it unless a test injects its own
WINDOWS = QuantileWindows()


def observe(name: str, v: float, trace_id: str | None = None) -> None:
    WINDOWS.observe(name, v, trace_id=trace_id)
