"""Zero-dependency metrics: counters, gauges, histograms.

The registry is the numeric half of the observability layer (``obs/``):
every hot-path event the serve loop can hit — frames received, malformed
frames, dropped replies, per-phase latencies — increments a named metric
here, and campaigns/benches snapshot the registry next to their other
artifacts. Two export forms:

* :meth:`MetricsRegistry.snapshot` — a JSON-able dict
  (``{"counters": ..., "gauges": ..., "histograms": ...}``), written by
  ``--metrics-dump PATH`` and embedded in ``BENCH_DETAIL.json``;
* :meth:`MetricsRegistry.to_prometheus` — Prometheus text exposition
  (version 0.0.4), so a scrape endpoint or textfile collector can serve
  the same numbers without any new dependency.

Everything is thread-safe under one lock per metric family; increments
are a dict lookup + integer add, cheap enough to stay unconditional (no
enable flag — unlike spans, counters have no per-event allocation).
Metrics are get-or-create by name, so instrumented modules can declare
their counters at import time and a snapshot shows them at zero even
when the failure path never fired.

A copy of the JAX package's ``obs/metrics.py``: after the same
operations a registry's ``snapshot()`` and ``to_prometheus()`` are
equal to that module's, byte for byte. One addition,
:func:`mirror_counts`, carries counts kept elsewhere (the kernel
wrappers' launch counts, ``models.cpd.COUNTERS``) into the registry.
"""

from __future__ import annotations

import json
import re

from ..utils.locks import OrderedLock

#: default latency buckets (seconds) — tuned for the serve path, where a
#: batch spans ~100us (warm gather) to minutes (cold XLA compile)
DEFAULT_BUCKETS = (0.0001, 0.001, 0.01, 0.1, 0.5, 1.0, 5.0, 30.0, 120.0)


class Counter:
    """Monotonic counter."""

    __slots__ = ("name", "help", "_value", "_lock")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._value = 0
        self._lock = OrderedLock("metrics.Counter")

    def inc(self, n: int | float = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self):
        return self._value


class Gauge:
    """Last-write-wins value."""

    __slots__ = ("name", "help", "_value", "_lock")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._value = 0.0
        self._lock = OrderedLock("metrics.Gauge")

    def set(self, v: float) -> None:
        with self._lock:
            self._value = v

    def add(self, v: float) -> None:
        with self._lock:
            self._value += v

    @property
    def value(self):
        return self._value


class Histogram:
    """Cumulative-bucket histogram (Prometheus semantics: each bucket
    counts observations ``<= le``; ``+Inf`` is the total count)."""

    __slots__ = ("name", "help", "buckets", "_counts", "_sum", "_count",
                 "_lock")

    def __init__(self, name: str, help: str = "",
                 buckets: tuple = DEFAULT_BUCKETS):
        self.name = name
        self.help = help
        self.buckets = tuple(sorted(buckets))
        self._counts = [0] * len(self.buckets)
        self._sum = 0.0
        self._count = 0
        self._lock = OrderedLock("metrics.Histogram")

    def observe(self, v: float) -> None:
        with self._lock:
            self._sum += v
            self._count += 1
            # per-bucket raw counts; as_dict cumulates on export
            for i, le in enumerate(self.buckets):
                if v <= le:
                    self._counts[i] += 1
                    break

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def as_dict(self) -> dict:
        with self._lock:
            cum = 0
            buckets = {}
            for le, c in zip(self.buckets, self._counts):
                cum += c
                buckets[repr(le)] = cum
            return {"count": self._count, "sum": self._sum,
                    "buckets": buckets}


class MetricsRegistry:
    """Thread-safe, name-keyed registry of the three metric kinds.

    ``counter``/``gauge``/``histogram`` are get-or-create: the first
    caller fixes the kind (a name reused across kinds raises), so modules
    can idempotently declare metrics at import time.
    """

    def __init__(self):
        self._metrics: dict[str, object] = {}
        self._lock = OrderedLock("metrics.MetricsRegistry")

    def _get_or_create(self, name: str, kind, **kwargs):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = kind(name, **kwargs)
                self._metrics[name] = m
            elif not isinstance(m, kind):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {kind.__name__}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(name, Counter, help=help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(name, Gauge, help=help)

    def histogram(self, name: str, help: str = "",
                  buckets: tuple = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(name, Histogram, help=help,
                                   buckets=buckets)

    # ---------------------------------------------------------- export
    def snapshot(self) -> dict:
        """JSON-able dump of every registered metric, grouped by kind."""
        with self._lock:
            metrics = dict(self._metrics)
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for name, m in sorted(metrics.items()):
            if isinstance(m, Counter):
                out["counters"][name] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][name] = m.value
            else:
                out["histograms"][name] = m.as_dict()
        return out

    def dump_json(self, path: str) -> None:
        """Atomic snapshot write (tmp+fsync+rename): a concurrent
        scrape, NFS copy, or fleet-aggregation pass never reads a torn
        JSON file. Lazy import — ``utils.atomicio`` imports this module
        for its own counters."""
        from ..utils.atomicio import atomic_write_bytes
        atomic_write_bytes(
            path, (json.dumps(self.snapshot(), indent=1) + "\n").encode())

    def to_prometheus(self) -> str:
        """Text exposition format 0.0.4 (``# TYPE`` lines + samples).

        Dynamically-suffixed per-worker metrics (``serve_queue_depth_w3``
        — the replicated frontend's per-shard gauges) are folded into
        proper labels (``serve_queue_depth{worker="3"}``) so a scrape
        sees one metric family per name instead of unbounded name
        cardinality; JSON snapshots keep the flat names for backward
        compatibility."""
        with self._lock:
            metrics = dict(self._metrics)
        # (family, worker-label) in family order, labeled samples last so
        # each family's TYPE/HELP is emitted once, before its samples
        families: dict[str, list] = {}
        for name, m in metrics.items():
            fam, labels = name, ""
            mt = re.fullmatch(r"(.+)_w(\d+)", name)
            if mt:
                fam, labels = mt.group(1), f'worker="{mt.group(2)}"'
            families.setdefault(fam, []).append((labels, m, name))
        # a fold is only valid within one metric kind: a name that merely
        # LOOKS per-worker but collides with a different-kinded family
        # falls back to its flat name
        for fam in list(families):
            kinds = {type(m) for _, m, _ in families[fam]}
            if len(kinds) > 1:
                members = families.pop(fam)
                for labels, m, name in members:
                    families.setdefault(name, []).append(("", m, name))
        lines = []
        for fam in sorted(families):
            samples = sorted(families[fam], key=lambda s: s[0])
            kind = samples[0][1]
            helps = [m.help for _, m, _ in samples if m.help]
            if helps:
                lines.append(f"# HELP {fam} {helps[0]}")
            if isinstance(kind, Counter):
                lines.append(f"# TYPE {fam} counter")
            elif isinstance(kind, Gauge):
                lines.append(f"# TYPE {fam} gauge")
            else:
                lines.append(f"# TYPE {fam} histogram")
            for labels, m, _name in samples:
                sfx = f"{{{labels}}}" if labels else ""
                if isinstance(m, (Counter, Gauge)):
                    lines.append(f"{fam}{sfx} {m.value}")
                    continue
                extra = f",{labels}" if labels else ""
                d = m.as_dict()
                for le, c in d["buckets"].items():
                    lines.append(
                        f'{fam}_bucket{{le="{le}"{extra}}} {c}')
                lines.append(
                    f'{fam}_bucket{{le="+Inf"{extra}}} {d["count"]}')
                lines.append(f"{fam}_sum{sfx} {d['sum']}")
                lines.append(f"{fam}_count{sfx} {d['count']}")
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        """Zero every metric IN PLACE (tests only — production metrics
        are process-lifetime monotonic). The metric handles stay
        registered: instrumented modules hold them from import time, and
        dropping them from the registry would leave those handles
        incrementing objects no snapshot can see."""
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            with m._lock:
                if isinstance(m, Histogram):
                    m._counts = [0] * len(m.buckets)
                    m._sum = 0.0
                    m._count = 0
                elif isinstance(m, Counter):
                    m._value = 0
                else:
                    m._value = 0.0


#: process-wide default registry — instrumented modules and exporters
#: share it unless a test injects its own
REGISTRY = MetricsRegistry()


def counter(name: str, help: str = "") -> Counter:
    return REGISTRY.counter(name, help=help)


def gauge(name: str, help: str = "") -> Gauge:
    return REGISTRY.gauge(name, help=help)


def histogram(name: str, help: str = "",
              buckets: tuple = DEFAULT_BUCKETS) -> Histogram:
    return REGISTRY.histogram(name, help=help, buckets=buckets)


def mirror_counts(counts: dict, registry: MetricsRegistry | None = None,
                  help: str = "") -> None:
    """Set one registry counter per ``counts`` entry to its value: counts
    that their owners keep elsewhere (a kernel wrapper's launch count
    attribute, ``models.cpd.COUNTERS``) show in the registry's snapshot,
    dump and exposition under the names they have there. The owner's
    count is the truth; a mirror is refreshed by calling this again."""
    reg = registry or REGISTRY
    for name, value in counts.items():
        c = reg.counter(name, help=help)
        with c._lock:
            c._value = value
