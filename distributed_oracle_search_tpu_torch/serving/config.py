"""Serving knobs (``DOS_SERVE_*`` env family).

One frozen dataclass holds every tunable of the online path so the
frontend, queues, batchers, and cache agree on a single source of truth,
and ``from_env`` follows the repo-wide env policy (``utils.env``): a
malformed value degrades to the default with a log line, never a crash.
"""

from __future__ import annotations

import dataclasses

from ..utils.env import env_cast
from ..utils.log import get_logger

log = get_logger(__name__)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Online-serving tunables.

    * ``queue_depth`` — bound of each shard's request queue; a full
      queue sheds ``BUSY`` immediately (admission control, never a
      silent hang). Env: ``DOS_SERVE_QUEUE_DEPTH``.
    * ``max_batch`` — flush threshold of the micro-batcher. MUST be a
      power of two: batches pad to the next power of two inside
      ``ShardEngine.answer``, so a pow2 cap means steady-state traffic
      reuses the handful of compiled programs the engine keys on
      ``qpad`` instead of compiling per batch size. Env:
      ``DOS_SERVE_MAX_BATCH``.
    * ``max_wait_ms`` — how long the micro-batcher lets the FIRST
      request of a forming batch wait before flushing a partial batch:
      the few milliseconds of waiting traded for fuller compiled-program
      batches. Env: ``DOS_SERVE_MAX_WAIT_MS``.
    * ``cache_bytes`` — budget of the LRU result cache; ``0`` disables
      caching. Env: ``DOS_SERVE_CACHE_BYTES``.
    * ``deadline_ms`` — per-request deadline from submit; a request
      still queued past it completes ``TIMEOUT`` instead of occupying
      a batch slot. Env: ``DOS_SERVE_DEADLINE_MS``.
    """

    queue_depth: int = 256
    max_batch: int = 64
    max_wait_ms: float = 5.0
    cache_bytes: int = 16 << 20
    deadline_ms: float = 10_000.0

    @classmethod
    def from_env(cls, **overrides) -> "ServeConfig":
        """Env-derived config; keyword overrides (CLI flags) win when
        not ``None``. Env policy (``utils.env``): a well-typed but
        INVALID env value (e.g. ``DOS_SERVE_MAX_BATCH=48``, not a power
        of two) degrades to the default with a log line like an
        unparseable one — only explicit overrides raise."""
        vals = dict(
            queue_depth=env_cast("DOS_SERVE_QUEUE_DEPTH",
                                 cls.queue_depth, int),
            max_batch=env_cast("DOS_SERVE_MAX_BATCH", cls.max_batch, int),
            max_wait_ms=env_cast("DOS_SERVE_MAX_WAIT_MS",
                                 cls.max_wait_ms, float),
            cache_bytes=env_cast("DOS_SERVE_CACHE_BYTES",
                                 cls.cache_bytes, int),
            deadline_ms=env_cast("DOS_SERVE_DEADLINE_MS",
                                 cls.deadline_ms, float),
        )
        for field, value in list(vals.items()):
            try:
                cls(**{field: value}).validate()
            except ValueError as e:
                log.warning("ignoring invalid DOS_SERVE_%s=%r (%s); "
                            "using %r", field.upper(), value, e,
                            getattr(cls, field))
                vals[field] = getattr(cls, field)
        vals.update({k: v for k, v in overrides.items() if v is not None})
        return cls(**vals).validate()

    def validate(self) -> "ServeConfig":
        if self.queue_depth <= 0:
            raise ValueError("queue_depth must be positive")
        if self.max_batch <= 0 or self.max_batch & (self.max_batch - 1):
            raise ValueError(
                f"max_batch must be a positive power of two (got "
                f"{self.max_batch}): batches pad to pow2 in the engine, "
                "and a pow2 cap keeps the compiled-program set small")
        if self.max_wait_ms < 0:
            raise ValueError("max_wait_ms must be >= 0")
        if self.cache_bytes < 0:
            raise ValueError("cache_bytes must be >= 0")
        if self.deadline_ms <= 0:
            raise ValueError("deadline_ms must be positive")
        return self

    @property
    def max_wait_s(self) -> float:
        return self.max_wait_ms / 1e3

    @property
    def deadline_s(self) -> float:
        return self.deadline_ms / 1e3
