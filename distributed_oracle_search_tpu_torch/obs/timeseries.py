"""Head-side fleet timeseries: bounded rings of telemetry samples.

The telemetry bus (:mod:`.telemetry`) streams each worker's counters,
gauges and window snapshots to the head on a fixed cadence; this module
is where those ticks land — a queryable, *bounded* in-memory store the
SLO burn-rate engine (:mod:`.slo`) and ``dos-obs top`` read instead of
polling ``/statusz`` across the fleet.

Layout: one fixed-capacity ring per series, keyed ``(worker, name)``.
Appends are O(1) (preallocated ``array`` pairs of timestamp + value,
head index wraps); timestamps are bucketed to absolute ``bucket_s``
boundaries so samples from different workers land in comparable
buckets — two samples of one series in one bucket merge (counters sum
their deltas, gauges keep the last write) rather than burning ring
slots on a fast publisher.

Byte budget: ``DOS_TELEMETRY_BYTES`` caps the whole store. When a new
series would cross the budget, the least-recently-written series is
evicted (and counted) — a fleet that grows series faster than the head
budgeted for degrades to shorter memory, never to OOM.

Series kinds:

* ``"delta"`` — per-tick counter increments (the ingest layer already
  clamped monotonic resets); :meth:`TimeseriesStore.rate` sums them
  over a trailing window;
* ``"gauge"`` — point-in-time values; :meth:`latest` / :meth:`query`;
* window snapshots are stored whole (latest per ``(worker, name)``)
  plus their p99 as a ``<name>:p99`` gauge series, so both "the
  worker's own view" and "the fleet trend" are queryable.
"""

from __future__ import annotations

import time
from array import array

from ..utils.env import env_cast
from ..utils.locks import OrderedLock
from ..utils.log import get_logger
from . import metrics as obs_metrics

log = get_logger(__name__)

M_POINTS = obs_metrics.counter(
    "telemetry_points_total", "samples appended to the fleet store")
M_EVICTED = obs_metrics.counter(
    "telemetry_series_evicted_total",
    "series dropped by the DOS_TELEMETRY_BYTES budget")
G_SERIES = obs_metrics.gauge(
    "telemetry_series", "live series rings in the fleet store")
G_BYTES = obs_metrics.gauge(
    "telemetry_store_bytes", "bytes held by the fleet store's rings")

#: per-ring sample capacity — ts+value doubles, ~16 B/slot; 360 slots
#: at a 5 s cadence is half an hour of memory per series
DEFAULT_CAPACITY = 360


class SeriesRing:
    """One series' fixed-capacity ring: O(1) append, oldest-first read."""

    __slots__ = ("capacity", "kind", "_ts", "_val", "_head", "_n",
                 "last_write")

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 kind: str = "gauge"):
        self.capacity = int(capacity)
        self.kind = kind
        self._ts = array("d", [0.0]) * self.capacity
        self._val = array("d", [0.0]) * self.capacity
        self._head = 0          # next write slot
        self._n = 0
        self.last_write = 0.0

    def append(self, ts: float, value: float) -> None:
        if self._n:
            last = (self._head - 1) % self.capacity
            if self._ts[last] == ts:
                # same absolute bucket: merge instead of spending a slot
                if self.kind == "delta":
                    self._val[last] += value
                else:
                    self._val[last] = value
                self.last_write = ts
                return
        self._ts[self._head] = ts
        self._val[self._head] = value
        self._head = (self._head + 1) % self.capacity
        self._n = min(self._n + 1, self.capacity)
        self.last_write = ts

    def points(self, since: float | None = None) -> list[tuple]:
        """Oldest-first ``(ts, value)`` pairs (``since`` filters)."""
        start = (self._head - self._n) % self.capacity
        out = []
        for i in range(self._n):
            j = (start + i) % self.capacity
            if since is None or self._ts[j] >= since:
                out.append((self._ts[j], self._val[j]))
        return out

    def latest(self) -> tuple | None:
        if not self._n:
            return None
        j = (self._head - 1) % self.capacity
        return (self._ts[j], self._val[j])

    @property
    def nbytes(self) -> int:
        return self._ts.itemsize * self.capacity * 2

    def __len__(self) -> int:
        return self._n


class TimeseriesStore:
    """The fleet store: ``(worker, name)``-keyed rings + latest window
    snapshots, byte-budgeted."""

    def __init__(self, max_bytes: int | None = None,
                 capacity: int = DEFAULT_CAPACITY,
                 bucket_s: float | None = None, clock=time.time):
        self.max_bytes = int(
            max_bytes if max_bytes is not None
            else env_cast("DOS_TELEMETRY_BYTES", 8 << 20, int))
        self.capacity = int(capacity)
        self.bucket_s = float(
            bucket_s if bucket_s is not None
            else env_cast("DOS_TELEMETRY_BUCKET_S", 5.0, float))
        if self.bucket_s <= 0:
            self.bucket_s = 5.0
        self.clock = clock
        self._series: dict[tuple, SeriesRing] = {}
        self._windows: dict[tuple, tuple] = {}   # (worker,name)->(ts,snap)
        self._bytes = 0
        self._lock = OrderedLock("timeseries.TimeseriesStore")

    # ------------------------------------------------------------- write
    def bucket(self, ts: float) -> float:
        return (ts // self.bucket_s) * self.bucket_s

    def _ring_locked(self, worker: str, name: str,
                     kind: str) -> SeriesRing:
        key = (worker, name)
        ring = self._series.get(key)
        if ring is None:
            ring = SeriesRing(self.capacity, kind=kind)
            while (self._series
                   and self._bytes + ring.nbytes > self.max_bytes):
                victim = min(self._series,
                             key=lambda k: self._series[k].last_write)
                self._bytes -= self._series.pop(victim).nbytes
                M_EVICTED.inc()
                log.warning("telemetry store over budget: evicted "
                            "series %s/%s", victim[0], victim[1])
            self._series[key] = ring
            self._bytes += ring.nbytes
            G_SERIES.set(len(self._series))
            G_BYTES.set(self._bytes)
        return ring

    def append(self, worker: str, name: str, ts: float, value: float,
               kind: str = "gauge") -> None:
        with self._lock:
            self._ring_locked(worker, name, kind).append(
                self.bucket(ts), float(value))
        M_POINTS.inc()

    def put_window(self, worker: str, name: str, ts: float,
                   snap: dict) -> None:
        """Latest window snapshot per ``(worker, name)``, plus its p99
        and count as trend series."""
        with self._lock:
            self._windows[(worker, name)] = (float(ts), dict(snap))
        qs = snap.get("quantiles") or {}
        p99 = qs.get("p99")
        if isinstance(p99, (int, float)):
            self.append(worker, f"{name}:p99", ts, float(p99))
        count = snap.get("count")
        if isinstance(count, (int, float)):
            self.append(worker, f"{name}:count", ts, float(count))

    # -------------------------------------------------------------- read
    def workers(self) -> list[str]:
        with self._lock:
            return sorted({w for w, _ in self._series}
                          | {w for w, _ in self._windows})

    def query(self, name: str, worker: str | None = None,
              since: float | None = None) -> dict[str, list]:
        """``{worker: [(ts, value), ...]}`` for one series name."""
        with self._lock:
            keys = [(w, n) for (w, n) in self._series
                    if n == name and (worker is None or w == worker)]
            return {w: self._series[(w, n)].points(since=since)
                    for w, n in keys}

    def latest(self, name: str,
               worker: str | None = None) -> dict[str, tuple]:
        with self._lock:
            keys = [(w, n) for (w, n) in self._series
                    if n == name and (worker is None or w == worker)]
            out = {}
            for w, n in keys:
                p = self._series[(w, n)].latest()
                if p is not None:
                    out[w] = p
            return out

    def rate(self, name: str, window_s: float,
             worker: str | None = None,
             now: float | None = None) -> float:
        """Summed delta-series increments over the trailing window,
        per second, across the selected workers (the fleet rate when
        ``worker`` is None)."""
        now = self.clock() if now is None else now
        since = self.bucket(now - window_s)
        total = 0.0
        for pts in self.query(name, worker=worker,
                              since=since).values():
            total += sum(v for _, v in pts)
        return total / window_s if window_s > 0 else 0.0

    def window(self, name: str,
               worker: str | None = None) -> dict[str, dict]:
        """Latest stored window snapshots ``{worker: snap}``."""
        with self._lock:
            return {w: snap for (w, n), (_, snap)
                    in self._windows.items()
                    if n == name and (worker is None or w == worker)}

    def fleet_window(self, name: str,
                     max_age_s: float | None = None,
                     now: float | None = None) -> dict | None:
        """The fleet-merged view of one quantile window: counts sum,
        each quantile takes the worst (max) across workers — a
        conservative fleet p99 that can never hide a slow replica
        behind a fast one. None when no worker has reported."""
        now = self.clock() if now is None else now
        with self._lock:
            snaps = [(ts, snap) for (w, n), (ts, snap)
                     in self._windows.items() if n == name]
        if max_age_s is not None:
            snaps = [(ts, s) for ts, s in snaps if now - ts <= max_age_s]
        live = [s for _, s in snaps if s.get("count")]
        if not live:
            return None
        out = {"count": sum(int(s.get("count", 0)) for s in live),
               "workers": len(live),
               "window_s": max(float(s.get("window_s", 0.0))
                               for s in live),
               "quantiles": {}}
        for q in ("p50", "p95", "p99"):
            vals = [s["quantiles"][q] for s in live
                    if isinstance((s.get("quantiles") or {}).get(q),
                                  (int, float))]
            if vals:
                out["quantiles"][q] = max(vals)
        return out

    # ------------------------------------------------------------ status
    def statusz(self) -> dict:
        with self._lock:
            return {"series": len(self._series),
                    "windows": len(self._windows),
                    "bytes": self._bytes,
                    "max_bytes": self.max_bytes,
                    "bucket_s": self.bucket_s}
