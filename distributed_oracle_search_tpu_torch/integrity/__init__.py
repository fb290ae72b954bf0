"""Answer-integrity plane, the part the serving stack needs: the
knobs (:class:`IntegrityConfig`, ``DOS_SCRUB_*`` / ``DOS_AUDIT_*`` /
``DOS_ANSWER_FP``) and the crc32 answer fingerprints
(:mod:`.fingerprint`). Copies of the JAX package's modules.

With ``DOS_ANSWER_FP`` set, replies carry a checksum over their answer
segments (the ``RuntimeConfig.answer_fp`` wire extension) that the
dispatcher verifies, and serving-cache entries re-check their stored
fingerprint on every hit — a corrupted answer is dropped and
recomputed, never served.

Not ported (ROADMAP.md A14.5): the resident scrubber (:mod:`.scrub`)
and the sampled dual-execution audit (:mod:`.audit`); importing either
raises an error naming that item.
"""

from .config import IntegrityConfig
from .fingerprint import (
    FingerprintError, M_FP_MISMATCH, answer_fingerprint, value_fingerprint,
)

__all__ = ["FingerprintError", "IntegrityConfig", "M_FP_MISMATCH",
           "answer_fingerprint", "value_fingerprint"]
