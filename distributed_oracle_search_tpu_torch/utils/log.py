"""Logging helpers.

The reference drives a module logger off a counted ``-v`` flag
(``args.py:7,190-196``); we do the same but per-named-logger and without
touching the host application's root logger at import time (library
convention: handlers are attached to our own namespace only).

Multi-worker runs interleave all workers' records on one stream, so
every record carries a worker id: ``set_worker_id`` tags the **current
thread**, and the handler's filter stamps ``[w<id>]`` into the format —
``-`` for untagged threads. While a traced batch is in flight the tag
carries its trace id too (``[w3 t:5f1c...]``), the key of its spans in
Perfetto.
"""

from __future__ import annotations

import logging
import threading

_ROOT = "dos_torch"

_ctx = threading.local()


def set_worker_id(wid: int | str | None) -> None:
    """Tag this thread's subsequent log records with a worker id
    (``None`` untags)."""
    _ctx.wid = wid


def get_worker_id() -> int | str | None:
    return getattr(_ctx, "wid", None)


class _WorkerIdFilter(logging.Filter):
    """Stamp the thread's worker id (``-`` if unset) and, when a traced
    batch is in flight, its trace id onto every record."""

    def filter(self, record: logging.LogRecord) -> bool:
        wid = getattr(_ctx, "wid", None)
        record.worker = "-" if wid is None else wid
        # lazy import: obs.trace is further up the import graph and the
        # filter must work even if the obs package is mid-import
        try:
            from ..obs.trace import current_trace_id
            tid = current_trace_id()
        except ImportError:
            tid = None
        record.trace = f" t:{tid}" if tid else ""
        return True


def get_logger(name: str = "") -> logging.Logger:
    return logging.getLogger(f"{_ROOT}.{name}" if name else _ROOT)


def _ensure_handler(root: logging.Logger) -> None:
    if not root.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s [w%(worker)s%(trace)s] %(levelname)s: "
            "%(message)s"))
        handler.addFilter(_WorkerIdFilter())
        root.addHandler(handler)
        root.propagate = False


def set_verbosity(verbose: int) -> None:
    """Map a counted -v flag to a log level (0→WARN, 1→INFO, ≥2→DEBUG)."""
    root = logging.getLogger(_ROOT)
    _ensure_handler(root)
    level = logging.WARNING
    if verbose == 1:
        level = logging.INFO
    elif verbose >= 2:
        level = logging.DEBUG
    root.setLevel(level)
