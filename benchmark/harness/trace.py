"""The traced window: ``torch.profiler`` over the measured calls, reduced
to device time by kernel, the device's busy time, and the idle gaps by
what the host was doing.

Kernel names come from the trace as the compiler demangled them
(``void relax_jacobi_kernel<2>(int const*, ...)``); :func:`base_name`
keeps the function's name, by which the metric readers look them up.
Every operation on the device counts as busy: kernels, copies, fills.
"""

from __future__ import annotations

import bisect
import contextlib
import re

#: what the breakdown lists keep
TOP = 10
#: the span the harness opens around the measured window
WINDOW_SPAN = "bench.window"

_QUALIFIED = re.compile(r"^(?:void\s+)?((?:\(anonymous namespace\)::)?[\w:]+)")


def base_name(name: str) -> str:
    """The function name of a demangled kernel name (``relax_jacobi_kernel``
    of ``void (anonymous namespace)::relax_jacobi_kernel<2>(int const*,
    ...)``); a copy or fill keeps its first word (``Memcpy`` of ``Memcpy
    DtoH (Device -> Pinned)``)."""
    m = _QUALIFIED.match(name)
    if not m:
        return name
    return m.group(1).rsplit("::", 1)[-1]


@contextlib.contextmanager
def profiled(enabled: bool):
    """A ``torch.profiler`` session over the block when ``enabled`` (CPU
    and CUDA activity), else nothing; yields the profiler or None."""
    if not enabled:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(WINDOW_SPAN):
            yield prof


def _union(intervals):
    """Merged, sorted ``[start, end]`` intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


#: host operations looked at, back from a gap, for the one open there
LOOK_BACK = 4096


def _innermost(starts, ends, names, t: int) -> str:
    """The latest-starting host operation open at ``t``."""
    i = bisect.bisect_right(starts, t) - 1
    stop = max(i - LOOK_BACK, -1)
    while i > stop:
        if ends[i] >= t:
            return names[i]
        i -= 1
    return "host code outside torch operations"


def reduce(prof) -> dict:
    """From the profiler's events inside the :data:`WINDOW_SPAN` span:
    ``window_s``, ``kernels`` (base name -> ``{"seconds",
    "launches"}``), ``busy_s`` (the union of device operations),
    ``device_ops`` and ``idle_gaps`` (the :data:`TOP` largest, as
    ``[name, seconds]``: device time by operation; idle time by the
    innermost host operation open at each gap's middle)."""
    events = prof.profiler.kineto_results.events()
    span = [ev for ev in events if ev.name() == WINDOW_SPAN
            and "cuda" not in str(ev.device_type()).lower()]
    if len(span) != 1:
        raise RuntimeError(f"the trace holds {len(span)} {WINDOW_SPAN} "
                           "spans, not one")
    t0 = span[0].start_ns()
    t1 = t0 + span[0].duration_ns()
    dev, host = [], []
    for ev in events:
        s = ev.start_ns()
        e = s + ev.duration_ns()
        if e < t0 or s > t1:
            continue
        if ev.is_user_annotation():
            continue            # the harness's own spans, on either side
        if "cuda" in str(ev.device_type()).lower():
            dev.append((max(s, t0), min(e, t1), ev.name()))
        else:
            host.append((s, e, ev.name()))
    kernels: dict[str, dict] = {}
    for s, e, name in dev:
        k = kernels.setdefault(base_name(name), {"seconds": 0.0,
                                                 "launches": 0})
        k["seconds"] += (e - s) / 1e9
        k["launches"] += 1
    busy = _union([(s, e) for s, e, _ in dev])
    gaps = []
    edge = t0
    for s, e in busy + [[t1, t1]]:
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, e)
    host.sort()
    starts = [h[0] for h in host]
    ends = [h[1] for h in host]
    names = [h[2] for h in host]
    idle: dict[str, float] = {}
    for gs, ge in gaps:
        label = _innermost(starts, ends, names, (gs + ge) // 2)
        idle[label] = idle.get(label, 0.0) + (ge - gs) / 1e9
    by_time = sorted(((n, k["seconds"]) for n, k in kernels.items()),
                     key=lambda x: -x[1])
    return {"window_s": (t1 - t0) / 1e9,
            "busy_s": sum(e - s for s, e in busy) / 1e9,
            "kernels": kernels,
            "device_ops": [[n, s] for n, s in by_time[:TOP]],
            "idle_gaps": [[n, s] for n, s in
                          sorted(idle.items(), key=lambda x: -x[1])[:TOP]]}
