"""Answer fingerprints: crc32 over a reply's answer segments.

The fingerprint is computed ONCE where the answer is born (the worker,
right after the engine returns) and re-checked wherever the answer is
about to be trusted — the dispatcher after a wire hop, the serving
cache on every hit. The canonical byte layout (int64 cost ‖ int64 plen
‖ uint8 finished) is deliberately independent of transport: the FIFO
results file, the RPC reply frame, and the in-process dispatcher all
fingerprint the same bytes, so one mismatch counter means the same
thing on every lane.

A mismatch is a *data* fault, not an availability fault: verifiers
book ``answer_fp_mismatch_total`` and raise their transport's dispatch
error so the frontend's existing failover machinery retries the batch
on another candidate — a corrupted answer is never handed to a client.
"""

from __future__ import annotations

import zlib

import numpy as np

from ..obs import metrics as obs_metrics

class FingerprintError(ValueError):
    """An answer fingerprint failed verification — data corruption on
    the wire or in a cache, not an availability fault. Subclasses
    ``ValueError`` so pre-integrity decode-error handlers (the FIFO
    dispatcher's results-sidecar wrap) still fail the batch over to
    another candidate instead of crashing."""


M_FP_MISMATCH = obs_metrics.counter(
    "answer_fp_mismatch_total",
    "replies whose crc32 answer fingerprint failed verification at a "
    "dispatcher (DOS_ANSWER_FP) — the batch is retried on another "
    "candidate, never served")


def answer_fingerprint(cost, plen, finished) -> int:
    """crc32 over a batch's canonical answer bytes (int64 cost ‖ int64
    plen ‖ uint8 finished). Stable across transports and dtypes the
    callers actually hold (device arrays, lists, np arrays)."""
    h = zlib.crc32(np.ascontiguousarray(
        np.asarray(cost, np.int64)).tobytes())
    h = zlib.crc32(np.ascontiguousarray(
        np.asarray(plen, np.int64)).tobytes(), h)
    h = zlib.crc32(np.ascontiguousarray(
        np.asarray(finished).astype(np.uint8)).tobytes(), h)
    return h & 0xFFFFFFFF


def value_fingerprint(value) -> int:
    """Fingerprint of ONE query's cached answer tuple ``(cost, plen,
    finished)`` — what L1/L2 cache entries store and re-check on every
    hit (:mod:`serving.cache`)."""
    c, p, f = value
    return answer_fingerprint([int(c)], [int(p)], [bool(f)])
