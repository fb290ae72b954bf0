"""The engine's per-batch records, as on the head↔worker wire.

Ported: the two dataclasses :class:`~..worker.engine.ShardEngine` takes
and returns — the runtime config (wire line 1 of a request, reference
``process_query.py:149-160``, plus the JAX package's wire extensions)
and the batch stats row (field order of reference
``process_query.py:198-213``) — and the stats CSV header the campaign
writes. Their wire codecs and the FIFO/RPC transports are not ported.
"""

from __future__ import annotations

import dataclasses

#: engine-side stats fields, in wire order
ENGINE_STAT_FIELDS = (
    "n_expanded", "n_inserted", "n_touched", "n_updated", "n_surplus",
    "plen", "finished", "t_receive", "t_astar", "t_search",
)
#: head-side appended fields
HEAD_STAT_FIELDS = ("t_prepare", "t_partition", "size")

#: full per-row CSV header (reference ``process_query.py:198-213`` plus the
#: leading experiment index the print path shows)
STATS_HEADER = ["expe", *ENGINE_STAT_FIELDS, *HEAD_STAT_FIELDS]


@dataclasses.dataclass
class RuntimeConfig:
    """Per-batch engine knobs (wire line 1). Same fields and defaults as
    the JAX package's; of them the port's engine reads ``time``,
    ``itrs``, ``k_moves``, ``no_cache`` and ``extract``."""

    hscale: float = 1.0
    fscale: float = 0.0
    time: int = 0            # ns budget; 0 = unlimited
    itrs: int = 1
    k_moves: int = -1
    threads: int = 0         # 0 = all
    verbose: int = 0
    debug: bool = False
    thread_alloc: int = 0
    no_cache: bool = False
    extract: bool = False
    trace_id: str = ""
    results: bool = False
    epoch: int = 0
    diff_epoch: int = 0
    sig_k: int = 0
    answer_fp: bool = False


@dataclasses.dataclass
class StatsRow:
    """One batch's engine stats (wire CSV line)."""

    n_expanded: int = 0
    n_inserted: int = 0
    n_touched: int = 0
    n_updated: int = 0
    n_surplus: int = 0
    plen: int = 0
    finished: int = 0
    t_receive: float = 0.0
    t_astar: float = 0.0
    t_search: float = 0.0

    def as_list(self, t_prepare: float = 0.0, t_partition: float = 0.0,
                size: int = 0) -> list:
        """Full head-side row (engine fields + appended head fields)."""
        return ([getattr(self, f) for f in ENGINE_STAT_FIELDS]
                + [t_prepare, t_partition, size])
