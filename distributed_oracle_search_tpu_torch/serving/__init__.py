"""Online serving layer: request queues, adaptive micro-batching, and a
result cache on top of the shard oracle.

The campaign drivers (``cli.process_query``) answer a *closed* workload:
a whole scenario file partitioned once, one batch per worker per diff
round, then exit. This package is the *open*-workload shape — the
standard online-inference frontend (continuous/adaptive batching a la
Orca / Clipper-style prediction-serving), built on the transport,
resilience, and observability layers the campaign path already uses:

* :class:`~.frontend.ServingFrontend` — accepts single ``s t`` queries,
  routes each to its target-owner shard via the
  ``DistributionController``, and applies admission control: a full
  per-shard queue sheds ``BUSY``, an OPEN circuit breaker sheds
  ``UNAVAILABLE`` — never a silent hang;
* :class:`~.queue.ShardQueue` — bounded per-shard request queue with
  per-request deadlines (expired requests complete ``TIMEOUT``);
* :class:`~.batcher.MicroBatcher` — per-shard adaptive micro-batcher:
  flushes when the batch hits the power-of-two ``max_batch`` (so
  workers reuse the handful of compiled programs ``ShardEngine`` keys
  on ``qpad``) or when ``max_wait_ms`` elapses, and keeps exactly ONE
  batch in flight per shard so host-side batch forming pipelines with
  device execution;
* :class:`~.cache.ResultCache` — bounded LRU keyed on
  ``(s, t, diff, knob fingerprint)``, short-circuiting repeats on
  skewed traffic; invalidated on diff change;
* :mod:`~.dispatch` — the shard backends: in-process
  :class:`~.dispatch.EngineDispatcher` (one ``ShardEngine`` per shard)
  and :class:`~.dispatch.FifoDispatcher` (the campaign wire +
  ``transport.send_with_retry``, per-query answers returned via the
  ``RuntimeConfig.results`` sidecar extension);
* :mod:`~.ingress` — the line protocol (stdin / unix socket /
  file-tail): one ``s t`` per line in, one result line out, responses
  in request order.

With shard replication (``DOS_REPLICATION`` / conf ``replication`` >
1) the frontend is replica-aware: admission sheds ``UNAVAILABLE`` only
when EVERY replica of the target shard is breaker-dead, dispatch fails
over to the next live replica (``failover_total``), and slow batches
are hedged — a duplicate to a replica after the shard's adaptive
latency-quantile delay, first answer wins, bounded by a hedge-rate
budget (:mod:`~.hedge`, ``DOS_HEDGE_*`` knobs).

Entry point: ``python -m distributed_oracle_search_tpu_torch.cli.serve``
(``dos-serve``). Env knobs: ``DOS_SERVE_QUEUE_DEPTH``,
``DOS_SERVE_MAX_BATCH``, ``DOS_SERVE_MAX_WAIT_MS``,
``DOS_SERVE_CACHE_BYTES``, ``DOS_SERVE_DEADLINE_MS`` (see
:class:`~.config.ServeConfig`); ``DOS_HEDGE_QUANTILE``,
``DOS_HEDGE_MIN_MS``, ``DOS_HEDGE_BUDGET``, ``DOS_HEDGE_WINDOW``,
``DOS_HEDGE_DISABLE`` (see :class:`~.hedge.HedgeConfig`).
"""

from .batcher import MicroBatcher
from .cache import ResultCache, knob_fingerprint
from .config import ServeConfig
from .dispatch import (
    AutoDispatcher, CallableDispatcher, DispatchError, EngineDispatcher,
    FifoDispatcher, RpcDispatcher, RpcUnavailableError,
)
from .frontend import ServingFrontend
from .hedge import HedgeConfig, HedgeTracker
from .queue import ShardQueue
from .request import (
    BUSY, ERROR, Future, OK, ServeRequest, ServeResult, TIMEOUT,
    UNAVAILABLE,
)

__all__ = [
    "AutoDispatcher", "BUSY", "CallableDispatcher", "DispatchError",
    "ERROR", "EngineDispatcher", "FifoDispatcher", "Future",
    "HedgeConfig", "RpcDispatcher", "RpcUnavailableError",
    "HedgeTracker", "MicroBatcher", "OK",
    "ResultCache", "ServeConfig", "ServeRequest", "ServeResult",
    "ServingFrontend", "ShardQueue", "TIMEOUT", "UNAVAILABLE",
    "knob_fingerprint",
]
