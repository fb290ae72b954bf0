"""Live traffic plane: streaming congestion diffs and new query families.

The reference answers queries "optionally on a congestion-perturbed
graph supplied as a ``.diff`` file" — one static file fixed for a whole
campaign or serve session. Production congestion is a *stream*: edge
weights change every few minutes, and the questions are heterogeneous
(ETA matrices, alternative routes, reverse routing), not just single
s–t walks. This package makes the **workload** dynamic the way
``parallel.membership`` made the **fleet** dynamic:

* :mod:`.segments` — the epoch-tagged diff *segment* codec: one JSON
  header line (unknown-key tolerant, rejects only NEWER schema
  versions — the repo-wide wire-compat contract) followed by
  ``src dst new_w`` entries, written atomically;
* :mod:`.stream` — :class:`~.stream.DiffStream` sources: watch a
  segment directory (the shared-nfs deployment) or tail a single
  append-only spool file, tolerating the torn tail a non-atomic
  producer leaves mid-write;
* :mod:`.epochs` — :class:`~.epochs.DiffEpochManager`: merges pending
  segments into ONE fused diff per swap (the fused multi-diff insight —
  bench measures 3.7× fused vs sequential — applied to ingestion: N
  queued segments cost one weights upload, not N), materializes it as
  an ordinary ``.diff`` file the whole existing wire/engine machinery
  serves unchanged, and reports the affected-edge set that drives
  *scoped* cache invalidation. The diff epoch rides ``RuntimeConfig``
  next to the membership epoch with the same tolerate-older /
  gate-newer rule;
* :mod:`.families` — the new query families on the same shard oracle:
  one-to-many ETA matrices (``mat``), k-alternative routes via
  penalized re-walks over distinct first edges (``alt``), and reverse
  source-owner routing (``rev``), each a typed request on the serve
  line protocol;
* :mod:`.scenarios` — the workload generator: grid / road / power-law
  topologies, zipf hotspot query pools, and rush-hour replay traces
  that emit timed diff segments for the bench and the chaos drills.

Knobs (all through ``utils.env``; malformed values degrade, logged):

=============================  ========  ================================
env var                        default   meaning
=============================  ========  ================================
``DOS_TRAFFIC_POLL_MS``        200       epoch-pump poll interval
``DOS_TRAFFIC_KEEP_EPOCHS``    2         fused diff FILES kept in the
                                         spool — >= 2 so a batch pinned
                                         to the previous epoch can
                                         still read its file
``DOS_TRAFFIC_WEIGHT_EPOCHS``  4         per-diff DEVICE weight buffers
                                         the engine keeps resident
                                         (LRU; floor 2 = the swap
                                         double buffer: in-flight
                                         batches finish on the old
                                         epoch's buffer)
``DOS_TRAFFIC_SCOPED_MAX``     4096      affected-edge count above which
                                         scoped invalidation falls back
                                         to a full cache flush
``DOS_TRAFFIC_SIG_MOVES``      64        path-signature moves captured
                                         per cached entry (entries with
                                         longer paths invalidate
                                         conservatively)
=============================  ========  ================================
"""

from .epochs import DiffEpochManager
from .families import QueryFamilies, parse_family_line
from .segments import (
    DiffSegment, SEGMENT_SCHEMA, list_segments, read_segment,
    segment_path, write_segment,
)
from .stream import DiffStream, TailDiffStream

__all__ = [
    "DiffEpochManager", "DiffSegment", "DiffStream", "QueryFamilies",
    "SEGMENT_SCHEMA", "TailDiffStream", "list_segments",
    "parse_family_line", "read_segment", "segment_path",
    "write_segment",
]
