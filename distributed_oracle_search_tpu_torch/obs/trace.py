"""Nested span tracing with Chrome trace-event export.

The timing half of the observability layer (``obs/``): phases of a query
batch — head-side prepare/partition/send, worker-side
receive/weights/search — run inside :func:`span` context managers, and
the collected events serialize as Chrome trace-event JSON
(``{"traceEvents": [...]}``, "X" complete events) loadable in Perfetto or
``chrome://tracing``.

Head and worker are separate processes in host mode, so spans join
across the FIFO wire via a **trace id**: the head stamps each batch's
``RuntimeConfig.trace_id`` (a backward-compatible wire extension — old
servers filter the unknown key), the worker captures its spans for that
batch under the same id and materializes them as a ``<queryfile>.trace``
sidecar (the same shared-dir channel the ``.paths`` extension rides),
and the head ingests the sidecars into one merged trace file.

Clock discipline: event **timestamps** are epoch microseconds
(``time.time_ns``) so events from different processes land on one
timeline without negotiation; **durations** come from the monotonic
``perf_counter_ns`` so a span is immune to wall-clock steps.

Cost discipline: tracing is off by default, and a disabled :func:`span`
returns one shared no-op context manager — no allocation, no clock
read — so instrumented hot paths are no-op-cheap unless ``--trace``
turns collection on process-wide, an incoming ``trace_id`` opens a
per-thread :class:`capture` for one batch, or a ``torch.profiler``
session records in the process.

Inside a ``torch.profiler`` session a span also opens
``torch.profiler.record_function(name)``, so it lands in the profiler's
host timeline, on the clock of the device's kernel events (the benchmark
reads that trace). Whatever turned it on, a recorded span adds its
seconds and one to running totals by name, :data:`span_seconds` and
:data:`span_count` (``getattr(span_seconds, "build.csr")``), which a
reader takes the difference of over a window, as of a launch count.

A copy of the JAX package's ``obs/trace.py``, with the profiler's
annotations and the totals added: events, sidecars and trace files have
the same structure, so either package's head merges the other's
sidecars.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
import uuid

from ..utils.counts import bump

_lock = threading.Lock()
_events: list[dict] = []
_enabled = False
_tls = threading.local()


def enable(on: bool = True) -> None:
    """Turn span collection on/off process-wide."""
    global _enabled
    _enabled = on


def enabled() -> bool:
    return _enabled


def new_trace_id() -> str:
    return uuid.uuid4().hex[:16]


def set_trace_id(trace_id: str | None) -> None:
    """Set the current thread's trace id (stamped on every span it
    opens; explicit ``trace_id=`` span args override)."""
    _tls.trace_id = trace_id


def current_trace_id() -> str | None:
    return getattr(_tls, "trace_id", None)


class _NullSpan:
    """Shared do-nothing context manager: the disabled fast path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **args) -> None:
        """Nothing: a span that does not record keeps no args."""


_NULL_SPAN = _NullSpan()


class _Totals:
    """Running totals by span name, read as attributes; a name no span
    has recorded reads 0."""

    def __getattr__(self, name: str):
        if name.startswith("__"):
            raise AttributeError(name)
        return 0


#: the seconds and the number of the spans recorded, by name, since the
#: process started (:func:`utils.counts.bump`: exact under threads)
span_seconds = _Totals()
span_count = _Totals()


def _profiler():
    """``torch.autograd.profiler`` while a ``torch.profiler`` session
    records in this process, else None. Looked up, never imported: a
    process that has not imported torch is not profiled."""
    prof = sys.modules.get("torch.autograd.profiler")
    if prof is not None and getattr(prof, "_is_profiler_enabled", False):
        return prof
    return None


def _active() -> bool:
    """Spans record when tracing is on process-wide, this thread is
    inside a :class:`capture` block, or a ``torch.profiler`` session
    records."""
    return (_enabled or getattr(_tls, "capture", None) is not None
            or _profiler() is not None)


def _add_total(name: str, seconds: float) -> None:
    bump(span_seconds, name, seconds)
    bump(span_count, name)


def _emit(ev: dict) -> None:
    """Route a finished event: to the thread's capture buffer when one
    is open (per-request worker capture), else the global buffer."""
    buf = getattr(_tls, "capture", None)
    if buf is not None:
        buf.append(ev)
        return
    with _lock:
        _events.append(ev)


def _make_event(name: str, ts_us: int, dur_us: int, args: dict) -> dict:
    if "trace_id" not in args:
        tid = current_trace_id()
        if tid is not None:
            args = {**args, "trace_id": tid}
    return {
        "name": name,
        "ph": "X",
        "ts": ts_us,
        "dur": dur_us,
        "pid": os.getpid(),
        "tid": threading.get_ident() & 0x7FFFFFFF,
        "args": args,
    }


class _Span:
    __slots__ = ("name", "args", "_t0_wall_us", "_t0_perf", "_annotation")

    def __init__(self, name: str, args: dict):
        self.name = name
        self.args = args

    def set(self, **args) -> None:
        """Add ``args`` to the event's (what is known only at the end)."""
        self.args.update(args)

    def __enter__(self):
        prof = _profiler()
        self._annotation = (None if prof is None
                            else prof.record_function(self.name))
        if self._annotation is not None:
            self._annotation.__enter__()
        self._t0_wall_us = time.time_ns() // 1000
        self._t0_perf = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dur_ns = time.perf_counter_ns() - self._t0_perf
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
        _emit(_make_event(self.name, self._t0_wall_us, dur_ns // 1000,
                          self.args))
        _add_total(self.name, dur_ns / 1e9)
        return False


def span(name: str, **args):
    """Context manager timing one phase. ``args`` land in the event's
    ``args`` dict (``trace_id`` defaults to the thread's current id).
    Returns a shared no-op when tracing is disabled; either has
    ``set(**args)``, which adds args known only at the span's end."""
    if not _active():
        return _NULL_SPAN
    return _Span(name, args)


def add_span(name: str, duration_s: float, **args) -> None:
    """Record an already-measured phase as a complete event ending now.

    For code that times itself with ``perf_counter`` deltas (the engine's
    stats-field timers): the event's start is back-dated by the duration.
    Host-side only: it opens no profiler annotation. No-op when tracing
    is disabled."""
    if not _active():
        return
    dur_us = int(duration_s * 1e6)
    _emit(_make_event(name, time.time_ns() // 1000 - dur_us, dur_us,
                      args))
    _add_total(name, duration_s)


def events() -> list[dict]:
    with _lock:
        return list(_events)


def clear() -> None:
    with _lock:
        _events.clear()


def ingest(evs: list[dict]) -> None:
    """Merge externally collected events (e.g. a worker sidecar) into
    this process's buffer."""
    with _lock:
        _events.extend(evs)


class capture:
    """Divert the spans THIS THREAD opens during the ``with`` block into
    ``self.events`` (activating span collection for the thread if
    tracing was otherwise off).

    The worker server uses this per request: an incoming ``trace_id``
    turns collection on for exactly that batch, the captured events are
    stamped with the id and shipped back via the batch's sidecar — they
    deliberately bypass the global buffer, so an in-process server (test
    harnesses run head + workers in one process) never double-reports a
    span both directly and through the sidecar the head ingests.
    Captures nest per thread; other threads are unaffected.
    """

    def __init__(self, trace_id: str | None = None):
        self.trace_id = trace_id
        self.events: list[dict] = []

    def __enter__(self) -> "capture":
        self._prev_buf = getattr(_tls, "capture", None)
        _tls.capture = self.events
        if self.trace_id is not None:
            self._prev_tid = current_trace_id()
            set_trace_id(self.trace_id)
        return self

    def __exit__(self, *exc) -> bool:
        _tls.capture = self._prev_buf
        if self.trace_id is not None:
            set_trace_id(self._prev_tid)
        return False


# --------------------------------------------------------------- files

def trace_sidecar_for(queryfile: str) -> str:
    """Where a worker materializes a batch's span events for the head to
    collect (the ``.paths`` pattern: rides the shared dir, not the
    stats FIFO)."""
    return queryfile + ".trace"


def write_events(path: str, evs: list[dict]) -> None:
    """Atomic sidecar write: the head (or a fleet-aggregation pass)
    polls for sidecars over NFS and must never ingest a torn JSON list.
    Lazy import — ``utils.atomicio`` registers its own obs counters."""
    from ..utils.atomicio import atomic_write_bytes
    atomic_write_bytes(path, json.dumps(evs).encode())


def read_events(path: str) -> list[dict]:
    with open(path) as f:
        out = json.load(f)
    if not isinstance(out, list):
        raise ValueError(f"{path}: expected a JSON list of events")
    return out


def write_trace(path: str, extra_events: list[dict] | None = None) -> None:
    """Write the full Chrome trace-event file (buffered events plus any
    ``extra_events``), loadable in Perfetto / chrome://tracing."""
    evs = events()
    if extra_events:
        evs = evs + list(extra_events)
    from ..utils.atomicio import atomic_write_bytes
    atomic_write_bytes(path, json.dumps(
        {"traceEvents": evs, "displayTimeUnit": "ms"}, indent=1).encode())
