"""Fleet telemetry bus: push-based metric snapshots, worker → head.

Every process already keeps a metrics registry and live quantile
windows; until now the head could only see them by polling ``/statusz``
or merging dump files after the fact. This module is the push half:
workers and supervisors publish **ticks** — delta-encoded snapshots of
their counters, gauges, window quantiles and pending flight-recorder
events — on a ``DOS_TELEMETRY_INTERVAL_S`` cadence, and the head
ingests them into the fleet timeseries store (:mod:`.timeseries`) the
SLO engine (:mod:`.slo`) and ``dos-obs top`` read.

Two lanes, mirroring the data plane:

* **RPC** — a ``telemetry`` frame (``transport.frames``) pushed on
  every live serve connection; the head's :class:`~..transport.rpc
  .RpcClient` read loop hands it to the registered sink. No request
  id, no reply — pure fire-and-forget on an already-open socket.
* **FIFO sidecar** — a ``<fifo>.telemetry`` JSONL file of the last few
  ticks, atomically replaced each tick; the head polls the directory.
  A torn tail line is skipped (the reader may race a non-atomic NFS
  copy), mirroring the frame codec's torn-tail tolerance.

Tick schema (its own version, independent of the frame schema): the
usual compat contract — unknown keys tolerated, ONLY newer versions
refused (:class:`TelemetrySchemaError`). Delta encoding is on the *key
set*: after the first (``full``) tick, counters and gauges ship only
the entries that changed since the previous tick; values stay
**absolute** so the head can detect monotonic resets (a respawned
worker's counters restart at zero — the ingest layer clamps the
negative delta and books the new absolute value from zero, never a
negative rate). A full tick rides every ``DOS_TELEMETRY_FULL_EVERY``
ticks (default 12) so a head that attached late converges.

Env knobs: ``DOS_TELEMETRY_INTERVAL_S`` (publish cadence, default 5 s,
``0`` = off), ``DOS_TELEMETRY_FULL_EVERY``,
``DOS_TELEMETRY_SIDECAR_KEEP`` (ticks kept per sidecar, default 16),
``DOS_TELEMETRY_BUSY_STORM`` (BUSY sheds per tick that flag a storm
event, default 50). The head-side store budget is
``DOS_TELEMETRY_BYTES`` (see :mod:`.timeseries`).
"""

from __future__ import annotations

import glob
import json
import os
import threading
import time

from ..utils.atomicio import atomic_replace_bytes
from ..utils.env import env_cast
from ..utils.locks import OrderedLock
from ..utils.log import get_logger
from . import metrics as obs_metrics
from . import quantiles as obs_quantiles
from . import recorder as obs_recorder

log = get_logger(__name__)

#: the tick schema this build writes; readers tolerate unknown keys and
#: refuse ONLY newer versions (the wire/manifest compat contract)
TELEMETRY_SCHEMA_VERSION = 1

#: sidecar filename suffix next to a worker's command FIFO
SIDECAR_SUFFIX = ".telemetry"

M_PUBLISHED = obs_metrics.counter(
    "telemetry_ticks_published_total", "ticks built and handed to sinks")
M_PUB_ERRORS = obs_metrics.counter(
    "telemetry_publish_errors_total",
    "telemetry sinks that raised (tick dropped on that lane only)")
H_PUBLISH = obs_metrics.histogram(
    "telemetry_publish_seconds",
    "one tick: snapshot + delta-encode + every sink")
M_INGESTED = obs_metrics.counter(
    "telemetry_ticks_ingested_total", "ticks accepted by the head")
M_DROPPED = obs_metrics.counter(
    "telemetry_ticks_dropped_total",
    "ticks the head dropped: replays, schema refusals, malformed")
M_RESETS = obs_metrics.counter(
    "telemetry_counter_resets_total",
    "monotonic counter resets clamped at ingest (worker respawns)")


class TelemetrySchemaError(ValueError):
    """A tick written by a NEWER schema than this reader understands.
    Deliberately not a transport error: reconnecting meets the same
    peer."""


def interval_s() -> float:
    """The publish cadence (0 = telemetry off)."""
    return max(env_cast("DOS_TELEMETRY_INTERVAL_S", 5.0, float), 0.0)


# ------------------------------------------------------------ tick codec

def decode_tick(raw) -> dict:
    """A tick from wire bytes / str / an already-parsed frame header.
    Unknown keys pass through untouched; ONLY a newer ``v`` refuses."""
    if isinstance(raw, (bytes, bytearray)):
        raw = raw.decode("utf-8", errors="replace")
    if isinstance(raw, str):
        try:
            raw = json.loads(raw)
        except ValueError as e:
            raise ValueError(f"undecodable telemetry tick: {e}")
    if not isinstance(raw, dict):
        raise ValueError(f"telemetry tick must be an object, got "
                         f"{type(raw).__name__}")
    v = raw.get("v", 0)
    if not isinstance(v, int) or isinstance(v, bool):
        v = 0           # annotation, not a gate — degrade like frames
    if v > TELEMETRY_SCHEMA_VERSION:
        raise TelemetrySchemaError(
            f"telemetry tick schema v{v} is newer than this reader "
            f"(v{TELEMETRY_SCHEMA_VERSION}); upgrade the head")
    return raw


def encode_tick(tick: dict) -> bytes:
    return json.dumps(tick, sort_keys=True, default=str).encode()


# --------------------------------------------------------------- sidecar

def write_sidecar(path: str, ticks: list[dict]) -> None:
    """The last few ticks as JSONL, atomically replaced (transient
    telemetry: rename-atomic visibility without paying fsync per
    tick)."""
    atomic_replace_bytes(
        path, b"".join(encode_tick(t) + b"\n" for t in ticks))


def read_sidecar(path: str) -> list[dict]:
    """Ticks from a sidecar. A torn TAIL line is skipped (a reader may
    race a non-atomic copy of the file); an undecodable line anywhere
    else — or a newer schema — raises, mirroring the frame codec's
    torn-vs-corrupt split. A missing file is simply no ticks."""
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except FileNotFoundError:
        return []
    lines = raw.split(b"\n")
    if lines and lines[-1] == b"":
        lines.pop()
    out = []
    for i, line in enumerate(lines):
        try:
            out.append(decode_tick(line))
        except TelemetrySchemaError:
            raise
        except ValueError:
            if i == len(lines) - 1:
                log.debug("skipping torn telemetry sidecar tail in %s",
                          path)
                continue
            raise ValueError(
                f"{path}: undecodable telemetry tick mid-file "
                f"(line {i + 1})")
    return out


def sidecar_sink(path: str, keep: int | None = None):
    """A publisher sink writing the rolling sidecar file at ``path``."""
    keep = int(keep if keep is not None
               else env_cast("DOS_TELEMETRY_SIDECAR_KEEP", 16, int))
    ring: list[dict] = []

    def sink(tick: dict) -> None:
        ring.append(tick)
        del ring[:-keep]
        write_sidecar(path, ring)

    return sink


# ------------------------------------------------------------- publisher

class TelemetryPublisher:
    """One process's tick maker + publish loop.

    ``sinks`` are callables taking the tick dict: the RPC broadcast,
    the sidecar writer, or (head self-ingest) the ingest itself. A sink
    that raises loses that lane's tick only — publishing keeps going on
    the others, and the error is counted, never raised into the serve
    path."""

    def __init__(self, source: str, sinks=(),
                 interval: float | None = None,
                 registry: obs_metrics.MetricsRegistry | None = None,
                 windows: obs_quantiles.QuantileWindows | None = None,
                 full_every: int | None = None, clock=time.time):
        self.source = str(source)
        self.sinks = list(sinks)
        self.interval = float(interval if interval is not None
                              else interval_s())
        self.registry = registry or obs_metrics.REGISTRY
        self.windows = windows or obs_quantiles.WINDOWS
        self.full_every = int(
            full_every if full_every is not None
            else env_cast("DOS_TELEMETRY_FULL_EVERY", 12, int))
        self.clock = clock
        #: process incarnation: lets the head tell a respawn (fresh
        #: counters) from a counter that actually went backwards
        self.incarnation = f"{os.getpid():x}-{int(time.monotonic() * 1e3):x}"
        self._seq = 0
        self._last_counters: dict[str, float] = {}
        self._last_gauges: dict[str, float] = {}
        self._lock = OrderedLock("telemetry.TelemetryPublisher")
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def add_sink(self, sink) -> None:
        self.sinks.append(sink)

    # ----------------------------------------------------------- ticking
    def _changed(self, cur: dict, last: dict, full: bool) -> dict:
        if full:
            return dict(cur)
        return {k: v for k, v in cur.items() if last.get(k) != v}

    def tick_once(self) -> dict:
        """Build and publish one tick; returns it (tests and the bench
        drive this inline)."""
        t0 = time.perf_counter()
        with self._lock:
            full = (self._seq % max(self.full_every, 1)) == 0
            snap = self.registry.snapshot()
            counters = {k: float(v) for k, v
                        in snap.get("counters", {}).items()}
            gauges = {k: float(v) for k, v
                      in snap.get("gauges", {}).items()}
            tick = {
                "v": TELEMETRY_SCHEMA_VERSION,
                "source": self.source,
                "incarnation": self.incarnation,
                "seq": self._seq,
                "ts": float(self.clock()),
                "full": full,
                "counters": self._changed(counters,
                                          self._last_counters, full),
                "gauges": self._changed(gauges, self._last_gauges,
                                        full),
                "windows": {name: s for name, s
                            in self.windows.snapshot().items()
                            if s.get("count")},
                "events": obs_recorder.drain_pending(),
            }
            self._last_counters = counters
            self._last_gauges = gauges
            self._seq += 1
        for sink in self.sinks:
            try:
                sink(tick)
            except Exception as e:  # noqa: BLE001 — one dead lane must
                # not stop the others (or the serve path) from ticking
                M_PUB_ERRORS.inc()
                log.debug("telemetry sink failed: %s", e)
        M_PUBLISHED.inc()
        H_PUBLISH.observe(time.perf_counter() - t0)
        return tick

    # --------------------------------------------------------- lifecycle
    def start(self) -> "TelemetryPublisher":
        if self._thread is not None or self.interval <= 0:
            return self
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.interval):
                try:
                    self.tick_once()
                except Exception as e:  # noqa: BLE001 — the publish
                    # loop outlives any one bad tick
                    log.exception("telemetry tick failed: %s", e)

        self._thread = threading.Thread(
            target=loop, daemon=True,
            name=f"dos-telemetry-{self.source}")
        self._thread.start()
        log.info("telemetry publisher up: source=%s interval=%.1fs "
                 "sinks=%d", self.source, self.interval,
                 len(self.sinks))
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def statusz(self) -> dict:
        with self._lock:
            return {"source": self.source, "seq": self._seq,
                    "interval_s": self.interval,
                    "incarnation": self.incarnation,
                    "sinks": len(self.sinks)}


# ---------------------------------------------------------------- ingest

class TelemetryIngest:
    """The head's tick consumer: dedupe, delta, store, record.

    Per ``(source, incarnation)`` it tracks the last seq (replayed
    sidecar reads drop silently) and the last absolute counter values
    (per-tick deltas go to the store; a NEW incarnation or a value
    below the last one is a monotonic reset — the new absolute value
    books from zero, never a negative delta)."""

    def __init__(self, store, recorder=None, clock=time.time):
        self.store = store
        self.recorder = recorder
        self.clock = clock
        self.busy_storm = env_cast("DOS_TELEMETRY_BUSY_STORM", 50.0,
                                   float)
        self._sources: dict[str, dict] = {}
        self._lock = OrderedLock("telemetry.TelemetryIngest")

    def ingest(self, raw) -> bool:
        """One tick (bytes / str / dict). True when accepted; replays
        and malformed/newer ticks are dropped-and-counted — a bad
        publisher must not crash the head's ingest lane."""
        try:
            tick = decode_tick(raw)
        except ValueError as e:
            M_DROPPED.inc()
            log.warning("dropping telemetry tick: %s", e)
            return False
        source = tick.get("source")
        if not isinstance(source, str) or not source:
            M_DROPPED.inc()
            return False
        ts = tick.get("ts")
        ts = float(ts) if isinstance(ts, (int, float)) else self.clock()
        seq = tick.get("seq")
        seq = int(seq) if isinstance(seq, int) else -1
        inc = str(tick.get("incarnation", ""))
        events = []
        with self._lock:
            st = self._sources.get(source)
            if st is not None and st["incarnation"] == inc \
                    and seq >= 0 and seq <= st["seq"]:
                M_DROPPED.inc()    # a sidecar poll re-read this tick
                return False
            reset = st is None or st["incarnation"] != inc
            if reset and st is not None:
                M_RESETS.inc()
                log.info("telemetry source %s reincarnated (%s -> %s)",
                         source, st["incarnation"], inc)
                events.append({"ts": ts, "kind": "source_restart",
                               "source": source})
            last = {} if reset else st["counters"]
            counters = tick.get("counters")
            counters = counters if isinstance(counters, dict) else {}
            deltas = {}
            for name, val in counters.items():
                if not isinstance(val, (int, float)) \
                        or isinstance(val, bool):
                    continue
                prev = last.get(name)
                if prev is None or val < prev:
                    if prev is not None:
                        M_RESETS.inc()
                    delta = float(val)   # reset clamp: book from zero
                else:
                    delta = float(val) - float(prev)
                last[name] = float(val)
                if delta:
                    deltas[name] = delta
            self._sources[source] = {
                "incarnation": inc, "seq": seq, "counters": last,
                "ts": ts, "recv_ts": self.clock(),
            }
        # store writes happen OUTSIDE the ingest lock: the store has
        # its own lock and the sidecar poller / rpc read loops must
        # not serialize behind each other's appends
        for name, delta in deltas.items():
            self.store.append(source, name, ts, delta, kind="delta")
        gauges = tick.get("gauges")
        if isinstance(gauges, dict):
            for name, val in gauges.items():
                if isinstance(val, (int, float)) \
                        and not isinstance(val, bool):
                    self.store.append(source, name, ts, float(val),
                                      kind="gauge")
        windows = tick.get("windows")
        if isinstance(windows, dict):
            for name, snap in windows.items():
                if isinstance(snap, dict):
                    self.store.put_window(source, name, ts, snap)
        raw_events = tick.get("events")
        if isinstance(raw_events, list):
            events.extend(e for e in raw_events if isinstance(e, dict))
        busy = deltas.get("serve_shed_busy_total", 0.0) \
            + deltas.get("rpc_busy_frames_total", 0.0)
        if self.busy_storm > 0 and busy >= self.busy_storm:
            events.append({"ts": ts, "kind": "busy_storm",
                           "source": source, "sheds": busy})
        rec = self.recorder or obs_recorder.get_recorder()
        if rec is not None:
            try:
                rec.record_tick(tick)
                for ev in events:
                    ev.setdefault("source", source)
                    rec.record_event(ev)
            except Exception as e:  # noqa: BLE001 — tape trouble must
                # not fail the metrics path
                log.warning("flight recorder ingest write failed: %s", e)
        M_INGESTED.inc()
        return True

    def statusz(self) -> dict:
        """Per-source freshness for ``/statusz`` and ``dos-obs top``:
        lag (now - last tick's publish ts), seq, incarnation."""
        now = self.clock()
        with self._lock:
            sources = {
                src: {"lag_s": round(now - st["ts"], 3),
                      "seq": st["seq"],
                      "incarnation": st["incarnation"]}
                for src, st in sorted(self._sources.items())}
        return {"sources": sources, "store": self.store.statusz()}


class SidecarPoller:
    """Head-side FIFO-lane collector: scan a directory for
    ``*.telemetry`` sidecars on the telemetry cadence and feed every
    tick to the ingest (its seq dedupe makes re-reads free)."""

    def __init__(self, dirname: str, ingest: TelemetryIngest,
                 interval: float | None = None):
        self.dirname = dirname
        self.ingest = ingest
        self.interval = float(interval if interval is not None
                              else max(interval_s(), 0.5))
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def poll_once(self) -> int:
        n = 0
        for path in sorted(glob.glob(os.path.join(
                self.dirname, f"*{SIDECAR_SUFFIX}"))):
            try:
                ticks = read_sidecar(path)
            except ValueError as e:
                M_DROPPED.inc()
                log.warning("unreadable telemetry sidecar %s: %s",
                            path, e)
                continue
            for tick in ticks:
                if self.ingest.ingest(tick):
                    n += 1
        return n

    def start(self) -> "SidecarPoller":
        if self._thread is not None or self.interval <= 0:
            return self
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.interval):
                try:
                    self.poll_once()
                except Exception as e:  # noqa: BLE001 — keep polling
                    log.exception("telemetry sidecar poll failed: %s", e)

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="dos-telemetry-poll")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
