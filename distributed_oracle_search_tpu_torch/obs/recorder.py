"""Black-box flight recorder: a bounded on-disk ring of what happened.

Metrics answer "how much"; traces answer "where did one batch go"; what
an incident review needs first is *what happened, in order* — the fault
fired, the burn alert tripped, the breaker opened, the supervisor
respawned. This module is that tape:

* a module-level **event bus** (:func:`emit`) every subsystem posts
  structured events to — epoch swaps (``serving.frontend``), breaker
  transitions (``transport.resilience``), respawns
  (``worker.supervisor``), membership commits, BUSY storms and SLO
  alert flips (``obs.slo`` / telemetry ingest), fault-harness fires
  (``testing.faults``). Events are plain dicts ``{"ts", "kind", ...}``
  — unknown fields are the reader's to ignore, the annotation contract
  of every other codec here;
* a bounded in-memory ring of recent events (:func:`drain_pending`) the
  telemetry publisher drains into its ticks, so a *worker's* events
  reach the head's tape even across a process boundary;
* :class:`FlightRecorder` — the on-disk ring: JSONL segments
  (``rec-<seq>.jsonl``) written atomically (``utils.atomicio``), rotated
  at ``DOS_RECORDER_SEGMENT_BYTES`` and capped at
  ``DOS_RECORDER_BYTES`` total (oldest segments deleted first — a
  flight recorder overwrites its own tail, it never fills a disk);
* :func:`replay` — read the ring back into one timestamp-ordered
  timeline, skipping a torn tail line (a crash mid-flush must not make
  the tape unreadable; that is the tape's whole job), and
  :func:`render_timeline` — the ``dos-obs replay`` text view, with
  Perfetto trace events merged in by ``trace_id``.

Env knobs: ``DOS_RECORDER_BYTES`` (ring budget, default 4 MiB),
``DOS_RECORDER_SEGMENT_BYTES`` (rotation size, default 64 KiB),
``DOS_RECORDER_FLUSH_EVERY`` (records buffered between disk flushes,
default 16).

A copy of the JAX package's ``obs/recorder.py``: tapes are byte-equal.
``dos-serve --recorder-dir`` and ``dos-gateway --recorder-dir`` install
it; the telemetry publisher drains the pending ring.
"""

from __future__ import annotations

import collections
import glob
import json
import os
import re
import time

from ..utils.atomicio import atomic_replace_bytes, atomic_write_bytes
from ..utils.env import env_cast
from ..utils.locks import OrderedLock
from ..utils.log import get_logger
from . import metrics as obs_metrics

log = get_logger(__name__)

M_EVENTS = obs_metrics.counter(
    "recorder_events_total", "structured events posted to the bus")
M_RECORDS = obs_metrics.counter(
    "recorder_records_total", "records written to the on-disk ring")
M_SEGMENTS = obs_metrics.counter(
    "recorder_segments_total", "ring segments finalized (rotations)")
M_TORN = obs_metrics.counter(
    "recorder_torn_lines_total",
    "torn tail lines skipped while replaying the ring")
G_BYTES = obs_metrics.gauge(
    "recorder_ring_bytes", "bytes currently held by the on-disk ring")

#: segment filename pattern — the seq number orders the ring on disk
_SEG_RE = re.compile(r"rec-(\d{8})\.jsonl$")


# ------------------------------------------------------------- event bus

#: recent events awaiting a telemetry tick (bounded: an idle publisher
#: must not grow memory; the tape on disk is the durable copy)
_PENDING_MAX = 256
_pending: collections.deque = collections.deque(maxlen=_PENDING_MAX)
_pending_lock = OrderedLock("recorder.pending")

_recorder: "FlightRecorder | None" = None


def set_recorder(rec: "FlightRecorder | None") -> None:
    """Install the process's on-disk recorder (None detaches). Events
    emitted before a recorder exists still reach the pending ring."""
    global _recorder
    _recorder = rec


def get_recorder() -> "FlightRecorder | None":
    return _recorder


def emit(kind: str, ts: float | None = None, **fields) -> dict:
    """Post one structured event to the bus: it lands in the pending
    ring (for the next telemetry tick) and, when an on-disk recorder is
    installed, on the tape. Cheap and never raises — instrumentation
    must not add failure modes to the paths it watches."""
    ev = {"ts": float(ts if ts is not None else time.time()),
          "kind": str(kind)}
    ev.update(fields)
    M_EVENTS.inc()
    with _pending_lock:
        _pending.append(ev)
    rec = _recorder
    if rec is not None:
        try:
            rec.record_event(ev)
        except Exception as e:  # noqa: BLE001 — a full disk must not
            # crash the breaker/supervisor path that emitted
            log.warning("flight recorder write failed: %s", e)
    return ev


def drain_pending() -> list[dict]:
    """Take (and clear) the pending events — the telemetry publisher's
    per-tick drain."""
    with _pending_lock:
        out = list(_pending)
        _pending.clear()
    return out


# ------------------------------------------------------------- the tape

class FlightRecorder:
    """Bounded on-disk ring of telemetry ticks + structured events.

    Records buffer in memory and flush as atomic segment rewrites
    (``atomic_replace_bytes`` — transient-by-design: the ring
    overwrites itself, fsync durability buys nothing here) every
    ``flush_every`` records; a finalized segment gets the durable
    ``atomic_write_bytes`` treatment once, at rotation. A crash loses
    at most the unflushed buffer — and :func:`replay` skips a torn
    tail line, so a crash mid-rename never makes the tape unreadable.
    """

    def __init__(self, dirname: str, max_bytes: int | None = None,
                 segment_bytes: int | None = None,
                 flush_every: int | None = None, clock=time.time):
        self.dirname = dirname
        self.max_bytes = int(max_bytes if max_bytes is not None else
                             env_cast("DOS_RECORDER_BYTES", 4 << 20, int))
        self.segment_bytes = int(
            segment_bytes if segment_bytes is not None else
            env_cast("DOS_RECORDER_SEGMENT_BYTES", 64 << 10, int))
        self.flush_every = int(
            flush_every if flush_every is not None else
            env_cast("DOS_RECORDER_FLUSH_EVERY", 16, int))
        self.clock = clock
        os.makedirs(dirname, exist_ok=True)
        self._lock = OrderedLock("recorder.FlightRecorder")
        existing = self._segments()
        self._seq = (self._seg_seq(existing[-1]) + 1) if existing else 0
        self._lines: list[str] = []     # current segment, in memory
        self._cur_bytes = 0
        self._unflushed = 0
        self._records = 0
        G_BYTES.set(self._disk_bytes())

    # ------------------------------------------------------------ layout
    def _segments(self) -> list[str]:
        paths = glob.glob(os.path.join(self.dirname, "rec-*.jsonl"))
        return sorted(p for p in paths if _SEG_RE.search(p))

    @staticmethod
    def _seg_seq(path: str) -> int:
        m = _SEG_RE.search(path)
        return int(m.group(1)) if m else -1

    def _seg_path(self, seq: int) -> str:
        return os.path.join(self.dirname, f"rec-{seq:08d}.jsonl")

    def _disk_bytes(self) -> int:
        total = 0
        for p in self._segments():
            try:
                total += os.path.getsize(p)
            except OSError:
                pass
        return total

    # ------------------------------------------------------------- write
    def record_event(self, ev: dict) -> None:
        self._record({"rec": "event", **ev})

    def record_tick(self, tick: dict) -> None:
        """One telemetry tick on the tape — the window snapshots are
        dropped (the timeseries store is their home; the tape keeps the
        tick's identity, counters and events for replay context)."""
        slim = {k: v for k, v in tick.items() if k != "windows"}
        self._record({"rec": "tick",
                      "ts": float(tick.get("ts") or self.clock()),
                      **slim})

    def _record(self, rec: dict) -> None:
        line = json.dumps(rec, sort_keys=True, default=str) + "\n"
        with self._lock:
            self._lines.append(line)
            self._cur_bytes += len(line)
            self._unflushed += 1
            self._records += 1
            M_RECORDS.inc()
            if self._cur_bytes >= self.segment_bytes:
                self._rotate_locked()
            elif self._unflushed >= self.flush_every:
                self._flush_locked(durable=False)

    def _flush_locked(self, durable: bool) -> None:
        if not self._lines:
            return
        data = "".join(self._lines).encode()
        write = atomic_write_bytes if durable else atomic_replace_bytes
        write(self._seg_path(self._seq), data)
        self._unflushed = 0
        G_BYTES.set(self._disk_bytes())

    def _rotate_locked(self) -> None:
        self._flush_locked(durable=True)
        M_SEGMENTS.inc()
        self._seq += 1
        self._lines = []
        self._cur_bytes = 0
        # ring bound: oldest segments fall off first
        segs = self._segments()
        total = self._disk_bytes()
        while segs and total > self.max_bytes:
            victim = segs.pop(0)
            try:
                total -= os.path.getsize(victim)
                os.remove(victim)
                log.info("flight recorder ring: dropped %s",
                         os.path.basename(victim))
            except OSError as e:
                log.warning("cannot drop ring segment %s: %s", victim, e)
                break
        G_BYTES.set(max(total, 0))

    def flush(self) -> None:
        with self._lock:
            self._flush_locked(durable=False)

    def close(self) -> None:
        with self._lock:
            self._flush_locked(durable=True)

    # ------------------------------------------------------------ status
    def statusz(self) -> dict:
        with self._lock:
            segs = self._segments()
            return {"dir": self.dirname,
                    "segments": len(segs) + (1 if self._lines else 0),
                    "records": self._records,
                    "bytes": self._disk_bytes(),
                    "max_bytes": self.max_bytes,
                    "seq": self._seq}


# ------------------------------------------------------------- replay

def segment_paths(dirname: str) -> list[str]:
    """The ring's segment files, oldest first."""
    paths = glob.glob(os.path.join(dirname, "rec-*.jsonl"))
    return sorted(p for p in paths if _SEG_RE.search(p))


def replay(dirname: str, since: float | None = None,
           until: float | None = None) -> list[dict]:
    """Read the ring back as one timestamp-ordered record list. A torn
    tail line (crash mid-flush) is skipped and counted; an undecodable
    line mid-segment raises — that is corruption, not a torn tail, and
    must not silently vanish from an incident review."""
    records: list[dict] = []
    for path in segment_paths(dirname):
        with open(path, "rb") as f:
            raw = f.read()
        lines = raw.split(b"\n")
        if lines and lines[-1] == b"":
            lines.pop()
        for i, line in enumerate(lines):
            try:
                rec = json.loads(line)
            except ValueError:
                if i == len(lines) - 1:
                    M_TORN.inc()
                    log.warning("replay: skipping torn tail line in %s",
                                os.path.basename(path))
                    continue
                raise ValueError(
                    f"{path}: undecodable record mid-segment "
                    f"(line {i + 1})")
            if not isinstance(rec, dict):
                continue
            ts = rec.get("ts")
            if not isinstance(ts, (int, float)):
                continue
            if since is not None and ts < since:
                continue
            if until is not None and ts > until:
                continue
            records.append(rec)
    records.sort(key=lambda r: r.get("ts", 0.0))
    return records


def _trace_entries(trace_paths, trace_ids: set) -> list[dict]:
    """Perfetto events from ``merge_traces``-style inputs whose
    ``trace_id`` matches a record on the tape, as timeline rows
    (trace ``ts`` is wall-clock microseconds)."""
    from .fleet import _events_of
    out = []
    for path in trace_paths:
        paths = (sorted(glob.glob(os.path.join(path, "*.trace")))
                 if os.path.isdir(path) else [path])
        for p in paths:
            for ev in _events_of(p):
                if not isinstance(ev, dict):
                    continue
                tid = (ev.get("args") or {}).get("trace_id", "")
                if not tid or tid not in trace_ids:
                    continue
                ts = ev.get("ts")
                if not isinstance(ts, (int, float)):
                    continue
                out.append({"rec": "span", "ts": ts / 1e6,
                            "kind": ev.get("name", "span"),
                            "trace_id": tid,
                            "dur_ms": round(
                                float(ev.get("dur", 0)) / 1e3, 3)})
    return out


def render_timeline(records: list[dict],
                    trace_paths: list[str] | None = None) -> str:
    """The ``dos-obs replay`` text view: one line per record, relative
    timestamps, event fields inline. With ``trace_paths``, Perfetto
    spans whose ``trace_id`` appears on the tape are merged in — the
    incident's batches next to the incident's events."""
    rows = list(records)
    if trace_paths:
        ids = {r["trace_id"] for r in rows
               if isinstance(r.get("trace_id"), str) and r["trace_id"]}
        rows.extend(_trace_entries(trace_paths, ids))
        rows.sort(key=lambda r: r.get("ts", 0.0))
    if not rows:
        return "(empty tape)"
    t0 = rows[0].get("ts", 0.0)
    lines = []
    skip = ("ts", "rec", "kind")
    for r in rows:
        rec = r.get("rec", "event")
        kind = r.get("kind", r.get("source", "?"))
        rest = " ".join(f"{k}={r[k]}" for k in sorted(r)
                        if k not in skip and not isinstance(
                            r[k], (dict, list)))
        lines.append(f"+{r.get('ts', t0) - t0:9.3f}s  "
                     f"{rec:5s} {kind:18s} {rest}".rstrip())
    return "\n".join(lines)
