"""Kernel launch counters that several threads may bump at once.

Each kernel wrapper counts its launches (and each plain run on CPU
tensors) on attributes of its own function object —
``cuda_walk_batch.launches``, ``relax_jacobi.plain``, ... — which the
smoke, the ``--metrics-dump`` snapshots and the tests read and reset by
name. ``fn.attr += 1`` is a read, an add and a write: two threads that
launch at once (the serving frontend's batcher and hedge threads, a
membership catch-up healing blocks beside them) can lose an increment.
:func:`bump` does the same update under one process-wide lock, so the
counts stay exact under any number of threads.
"""

from __future__ import annotations

import threading

_LOCK = threading.Lock()


def bump(fn, name: str, n: int = 1) -> None:
    """Add ``n`` to the counter attribute ``name`` of ``fn``."""
    with _LOCK:
        setattr(fn, name, getattr(fn, name) + n)
