"""Wall-clock phase timers.

Role parity: the reference wraps its read/partition/send phases in a
context-manager timer and reports intervals in both seconds and nanoseconds
(reference ``timer.py:20-26``, ``process_query.py:93-111``). This is a fresh
implementation with the same jobs: ``with``-block timing, accumulation, and
human-readable formatting.
"""

from __future__ import annotations

import time


class Timer:
    """Context-manager wall-clock timer.

    >>> with Timer() as t:
    ...     do_work()
    >>> t.interval      # seconds (float)
    >>> t.interval_ns   # integer nanoseconds

    ``interval`` is only set on block exit (it reads 0.0 mid-block);
    ``elapsed`` also works inside the ``with`` block, returning the time
    since entry, and equals ``interval`` after exit.
    """

    __slots__ = ("interval", "_start", "_running")

    def __init__(self, interval: float = 0.0):
        self.interval = float(interval)
        self._running = False

    def __enter__(self) -> "Timer":
        self._start = time.perf_counter()
        self._running = True
        return self

    def __exit__(self, *exc) -> None:
        self.interval = time.perf_counter() - self._start
        self._running = False

    @property
    def elapsed(self) -> float:
        """Seconds since block entry while inside the ``with`` block;
        the final ``interval`` once the block has exited."""
        if self._running:
            return time.perf_counter() - self._start
        return self.interval

    @property
    def interval_ns(self) -> int:
        return int(self.interval * 1e9)

    def __add__(self, other) -> "Timer":
        other_s = other.interval if isinstance(other, Timer) else float(other)
        return Timer(self.interval + other_s)

    __radd__ = __add__

    def __str__(self) -> str:
        s = self.interval
        if s >= 1e-2:
            return f"{s:.3f}s"
        if s >= 1e-5:
            return f"{s * 1e3:.3f}ms"
        if s >= 1e-8:
            return f"{s * 1e6:.3f}us"
        return f"{s * 1e9:.0f}ns"

    def __repr__(self) -> str:
        return f"Timer({self.interval!r})"
