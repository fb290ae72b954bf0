"""Answer-integrity plane: is the oracle still telling the truth?

PRs 4/5/8/14 made the *disk* path verifiable end to end — crc32
manifests, heal-on-load, replica anti-entropy, codec-aware adoption —
but a shard that loaded clean is then resident in device/host memory
for days, and nothing ever re-checked it: a bitflip in the resident
rows, a wrong-regime promotion, or a rotted cache entry serves a wrong
answer silently and forever. At fleet scale silent data corruption is
an operational fact, not a tail risk; this package is the defense in
depth:

:mod:`integrity.scrub`
    A low-priority background pass (``DOS_SCRUB_INTERVAL_S``, default
    off) re-reads each resident shard's block files through the same
    digest-verified load path the engine booted from, decodes them
    (pack4/RLE via ``models.resident``), and crc32-compares the dense
    rows against what is actually resident — base table AND any
    epoch-promoted index. Disk-side rot heals through the shared
    ``heal_block`` quarantine path; resident-side rot triggers an
    atomic table rebind that never drops an in-flight batch.

:mod:`integrity.audit`
    A sampled dual-execution audit (``DOS_AUDIT_RATE`` per-mille):
    served batches re-execute on an independent lane — a replica
    engine, an uncached re-execution, or the CPU reference oracle for
    small batches, chosen by :func:`integrity.audit.choose_audit_lane`
    (mirroring ``ops.pallas_walk.choose_walk_kernel``'s (choice, why)
    contract) — and compare element-wise OFF the reply critical path.
    A divergence books ``audit_divergence_total``, lands a structured
    ``audit_divergence`` flight-recorder event, and feeds the control
    loop's ``DivergenceWatch`` arm: breaker force-open, scrub-now,
    probed re-admission.

:mod:`integrity.fingerprint`
    Optional crc32 answer fingerprints (``DOS_ANSWER_FP``): replies
    carry a checksum over their answer segments (RuntimeConfig wire
    extension, unknown-key tolerant) verified at the dispatcher, and
    serving-cache entries re-check their stored fingerprint on every
    hit — a corrupted entry is dropped and recomputed, never served.

Every knob defaults off: with none set, no thread starts, no metric
family appears, and behavior is byte-identical legacy.

The port of the JAX package's ``integrity/``: ``config``,
``fingerprint`` and ``audit`` are copies; ``scrub`` reads and re-binds
the resident table on the engine's device (see there). The audit's
replica and recompute lanes launch B1 (B1′ under pack4) from the audit
thread, counted like every other launch.
"""

from .config import IntegrityConfig
from .fingerprint import (
    FingerprintError, M_FP_MISMATCH, answer_fingerprint, value_fingerprint,
)

__all__ = ["FingerprintError", "IntegrityConfig", "M_FP_MISMATCH",
           "answer_fingerprint", "value_fingerprint"]
