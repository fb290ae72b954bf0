"""Integrity-plane knobs (``DOS_SCRUB_*`` / ``DOS_AUDIT_*`` /
``DOS_ANSWER_FP``), one frozen dataclass.

Same policy home as :class:`control.config.ControlConfig`: every knob
is read through :mod:`utils.env` (malformed values degrade to
defaults, logged), ``validate()`` raises on impossible combinations,
and consumers only ever see an immutable snapshot. Every default is
OFF — an unconfigured process builds nothing and behaves byte-
identically to pre-integrity code."""

from __future__ import annotations

import dataclasses

from ..utils.env import env_cast, env_flag
from ..utils.log import get_logger

log = get_logger(__name__)


@dataclasses.dataclass(frozen=True)
class IntegrityConfig:
    """Answer-integrity plane configuration.

    ``scrub_interval_s == 0`` disables the scrubber thread entirely;
    ``audit_rate == 0`` disables the audit sampler; ``answer_fp=False``
    keeps replies and cache entries fingerprint-free."""

    #: DOS_SCRUB_INTERVAL_S — seconds between resident-scrub passes
    #: (0 = scrubber off; the background thread is never started)
    scrub_interval_s: float = 0.0
    #: DOS_SCRUB_BLOCKS_PER_PASS — max blocks checked per engine per
    #: pass (0 = the whole shard each pass); a bounded pass resumes at
    #: a cursor so big shards scrub incrementally at low priority
    scrub_blocks_per_pass: int = 0
    #: DOS_AUDIT_RATE — per-mille of served batches re-executed on an
    #: independent lane (0 = audit off, 1000 = every batch)
    audit_rate: int = 0
    #: DOS_AUDIT_MAX_REFERENCE — largest batch the CPU reference lane
    #: will take (the per-query heap oracle is O(M log N) per distinct
    #: target; bigger batches audit on a replica lane instead)
    audit_max_reference: int = 64
    #: DOS_ANSWER_FP — replies carry a crc32 answer fingerprint
    #: (verified at the dispatcher) and cache entries re-check theirs
    #: on every hit
    answer_fp: bool = False

    @property
    def any_enabled(self) -> bool:
        return (self.scrub_interval_s > 0 or self.audit_rate > 0
                or self.answer_fp)

    @classmethod
    def from_env(cls) -> "IntegrityConfig":
        cfg = cls(
            scrub_interval_s=env_cast("DOS_SCRUB_INTERVAL_S", 0.0,
                                      float),
            scrub_blocks_per_pass=env_cast(
                "DOS_SCRUB_BLOCKS_PER_PASS", 0, int),
            audit_rate=env_cast("DOS_AUDIT_RATE", 0, int),
            audit_max_reference=env_cast(
                "DOS_AUDIT_MAX_REFERENCE", 64, int),
            answer_fp=env_flag("DOS_ANSWER_FP", False),
        )
        try:
            cfg.validate()
        except ValueError as e:
            log.warning("integrity config invalid (%s); disabling the "
                        "integrity plane", e)
            cfg = cls()
        return cfg

    def validate(self) -> None:
        if self.scrub_interval_s < 0:
            raise ValueError("scrub_interval_s must be >= 0")
        if self.scrub_blocks_per_pass < 0:
            raise ValueError("scrub_blocks_per_pass must be >= 0")
        if not (0 <= self.audit_rate <= 1000):
            raise ValueError("audit_rate must be in [0, 1000] "
                             "(per-mille)")
        if self.audit_max_reference < 0:
            raise ValueError("audit_max_reference must be >= 0")
