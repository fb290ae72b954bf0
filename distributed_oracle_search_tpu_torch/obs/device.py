"""Per-program device cost capture for the port's hand kernels.

The JAX package's ``obs/device.py`` AOT-lowers each jitted program the
engine runs and reads XLA's ``cost_analysis`` / ``memory_analysis``. The
port has no XLA. It keeps that module's interface and fills each
program key's entry from the kernels themselves:

* ``flops`` and ``bytes_accessed`` — the closed-form count the kernel's
  wrapper gives for one launch (``ops.cuda_walk.walk_launch_cost`` for
  B1 and B1′). These are
  upper counts of one launch's reads and writes at its move budget, not
  the distinct-sector bound ``chip_smoke.py`` replays from a run's data;
* ``hbm_bytes`` — the bytes of the launch's operand and output tensors;
* ``kernel_ms`` — one extra launch timed with CUDA events on the card
  (``timer: "cuda-events"``), or with ``time.perf_counter`` around the
  plain version on the CPU (``timer: "perf_counter"``). The launch is
  made once per key, outside the caller's timed interval, and counts in
  the wrapper's launch counts like any other.

:func:`capture` records one entry per key (``worker.engine`` calls it on
the first batch of each walk program key: raw, pack4 and lanes, after
the batch's timed interval, as the JAX engine does; like the JAX
package, the in-process oracle's walks record none).
The store exports as in the JAX package: :func:`snapshot` (JSON),
:func:`to_prometheus` (``device_program_{flops,bytes_accessed,
hbm_bytes}`` labeled gauges on ``/metrics``) and the
``device_programs_analyzed`` registry gauge. The values differ from the
JAX package's by design (XLA's analysis against a closed form); the keys
of an entry and the exposition's names are the same, with ``kernel_ms``,
``device`` and ``timer`` added.

``DOS_DEVICE_COSTS=0`` disables capture entirely.
"""

from __future__ import annotations

import threading
import time

from ..utils.env import env_flag
from ..utils.log import get_logger
from . import metrics as obs_metrics

log = get_logger(__name__)

G_PROGRAMS = obs_metrics.gauge(
    "device_programs_analyzed",
    "compiled programs with a captured XLA cost/memory analysis")

_COSTS: dict[str, dict] = {}
#: guards ``_COSTS``; ``capture`` holds it across its launch, so threads
#: that reach one program key at once (the serving frontend's batcher
#: threads, one a shard) make one timed launch between them, not one
#: each — the launch counts stay "batches + program keys" under threads
_lock = threading.Lock()


def enabled() -> bool:
    return env_flag("DOS_DEVICE_COSTS", True)


def time_launch(fn, *args, device=None, **kwargs) -> tuple[float, str]:
    """``(ms, timer)`` of one call of ``fn(*args, **kwargs)``: CUDA events
    around it on ``device`` when that is a CUDA device, else
    ``time.perf_counter``."""
    import torch

    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type == "cuda":
        with torch.cuda.device(dev):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args, **kwargs)
            stop.record()
            stop.synchronize()
            return float(start.elapsed_time(stop)), "cuda-events"
    t0 = time.perf_counter()
    fn(*args, **kwargs)
    return (time.perf_counter() - t0) * 1e3, "perf_counter"


def analyze(fn, *args, cost: dict | None = None, device=None,
            **kwargs) -> dict | None:
    """The entry of one launch ``fn(*args, **kwargs)``: the closed-form
    ``cost`` (``flops``, ``bytes_accessed``, ``hbm_bytes``) with the
    launch timed (:func:`time_launch`). A failure returns None with a
    debug log, never an exception into the serving path."""
    try:
        ms, timer = time_launch(fn, *args, device=device, **kwargs)
    except Exception as e:  # noqa: BLE001 — capture is advisory
        log.debug("program capture failed: %s", e)
        return None
    out = dict(cost or {})
    out["kernel_ms"] = ms
    out["timer"] = timer
    out["device"] = str(device) if device is not None else "cpu"
    return out


def capture(key, fn, *args, cost: dict | None = None, device=None,
            **kwargs) -> dict | None:
    """Analyze once per ``key`` and record the result. Returns the stored
    entry (existing or new), or None when disabled/failed."""
    if not enabled():
        return None
    skey = key if isinstance(key, str) else repr(key)
    with _lock:
        if skey not in _COSTS:
            entry = analyze(fn, *args, cost=cost, device=device, **kwargs)
            if entry is None:
                return None
            _COSTS[skey] = entry
            G_PROGRAMS.set(len(_COSTS))
        return _COSTS[skey]


def derive_bandwidth(entry: dict | None, seconds: float,
                     peak_gbps: float | None) -> dict | None:
    """Fold a measured wall-clock into a captured entry: achieved GB/s
    off ``bytes_accessed`` plus the utilization fraction against a peak
    rate (the JAX package's arithmetic, unchanged). Mutates and returns
    ``entry``; None in (no entry / no timing) degrades to None out."""
    if not entry or seconds <= 0 or "bytes_accessed" not in entry:
        return entry
    gbps = entry["bytes_accessed"] / seconds / 1e9
    entry["achieved_gbps"] = round(gbps, 2)
    if peak_gbps and peak_gbps > 0:
        entry["hbm_bw_utilization"] = round(gbps / peak_gbps, 4)
    return entry


def record(key, entry: dict) -> None:
    """Store an externally computed entry under ``key``."""
    with _lock:
        _COSTS[key if isinstance(key, str) else repr(key)] = dict(entry)
        G_PROGRAMS.set(len(_COSTS))


def snapshot() -> dict:
    """``{program_key: {flops, bytes_accessed, hbm_bytes, kernel_ms,
    ...}}``."""
    with _lock:
        return {k: dict(v) for k, v in sorted(_COSTS.items())}


def to_prometheus() -> str:
    """Labeled per-program gauges for the scrape endpoint."""
    with _lock:
        costs = {k: dict(v) for k, v in sorted(_COSTS.items())}
    if not costs:
        return ""
    lines = []
    for field, help_ in (
            ("flops", "closed-form operations of one kernel launch"),
            ("bytes_accessed",
             "closed-form bytes one kernel launch reads and writes"),
            ("hbm_bytes", "operand + output device tensor bytes")):
        samples = [(k, v[field]) for k, v in costs.items()
                   if field in v]
        if not samples:
            continue
        lines.append(f"# TYPE device_program_{field} gauge")
        lines.append(f"# HELP device_program_{field} {help_}")
        for key, val in samples:
            esc = key.replace("\\", "\\\\").replace('"', '\\"')
            lines.append(
                f'device_program_{field}{{program="{esc}"}} {val:.10g}')
    return "\n".join(lines) + ("\n" if lines else "")


def reset() -> None:
    """Drop every captured program (tests only)."""
    with _lock:
        _COSTS.clear()
        G_PROGRAMS.set(0)
