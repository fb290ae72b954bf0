"""Observability: the metrics registry, span tracing and device costs.

The port of the JAX package's ``obs/``. The head (``cli.process_query``)
fans batches to the shard workers (FIFO wire or the RPC lane →
``worker.server`` → ``worker.engine``, B1/B1′ on the card); this package
is the instrumentation every layer books into:

* :mod:`.metrics` — counters, gauges and histograms with a JSON snapshot
  (``--metrics-dump PATH``, ``obs_metrics.json`` beside ``parts.csv``)
  and Prometheus text; per-worker suffixes (``_w3``) fold into
  ``{worker="3"}`` labels on the text exposition;
* :mod:`.trace` — nested spans exported as Chrome trace-event JSON
  (``--trace PATH``, open in Perfetto), with a per-batch ``trace_id`` on
  the wire so the workers' spans join the head's timeline;
* :mod:`.quantiles` — sliding-window p50/p95/p99 with a worst-case
  trace-id exemplar (``DOS_OBS_WINDOW_S``);
* :mod:`.http` — ``/metrics``, ``/healthz``, ``/statusz`` on
  ``--obs-port`` / ``DOS_OBS_PORT``;
* :mod:`.recorder` — the flight recorder's event bus and tape (breaker
  transitions and fault fires post to it);
* :mod:`.device` — one entry a walk program key: the kernel wrapper's
  closed-form flops and bytes, the operand bytes and one launch timed
  with CUDA events (the JAX package reads XLA's cost analysis instead).

Metric names are the JAX package's wherever the meaning carries, so an
``obs_metrics.json`` of either package reads the same. What the port
books:

* head — ``head_batches_total``, ``head_batches_failed_total``,
  ``head_prepare_seconds``, ``head_send_seconds``,
  ``head_partition_seconds``, ``head_search_seconds``; FIFO lane
  ``head_retries_total``, ``head_stale_fifos_cleaned_total``,
  ``head_probes_total``, ``head_probe_failures_total``;
* breakers and failover (``transport.resilience``) —
  ``head_circuit_open_total``, ``head_circuit_rejected_total``,
  ``head_circuit_closed_total``, ``head_circuit_half_open_total``,
  ``head_circuits_open`` (gauge), ``failover_total`` (batches the head
  sent off a dead or failed primary to a replica holder);
* worker serve loops (``worker.server``) — ``server_frames_received_total``,
  ``server_frames_malformed_total``, ``server_frames_half_total``,
  ``server_batches_failed_total``, ``server_replies_sent_total``,
  ``server_replies_dropped_total``, ``server_reply_open_wait_seconds``,
  ``server_pings_answered_total``, ``server_ping_replies_dropped_total``,
  ``server_replica_batches_total`` (batches a replica engine answered);
* engine (``worker.engine``; the wire stats fields ``t_receive`` /
  ``t_astar`` / ``t_search``) — ``worker_receive_seconds``,
  ``worker_weights_load_seconds``, ``worker_search_seconds``,
  ``worker_jit_compile_seconds`` (the first batch at a new program key:
  the kernel's load and first launch), ``worker_batches_total``,
  ``worker_queries_total``, ``worker_duplicate_queries_total``,
  ``walk_compressed_batches_total``, ``cpd_decompress_seconds``,
  ``cpd_resident_bytes`` (gauge), ``cpd_resident_degraded_total``;
  ``walk_pallas_batches_total`` counts the batches the HAND KERNEL
  answered (B1/B1′ on the card: the port's counterpart of the Pallas
  walk) and ``walk_xla_batches_total`` those the plain walk answered
  (CPU tensors); ``mesh_devices`` (gauge) and
  ``mesh_walk_batches_total`` (batches split over worker lanes);
* kernel launches — the wrappers' counts under their own names
  (``cuda_walk_batch.launches``, ``cuda_walk_batch.launches_pack4``,
  ``cuda_walk_batch.plain``, ``astar_sweep.launches``, ...), mirrored
  into the registry by the worker's dumps (``metrics.mirror_counts``);
* RPC lane (``transport.frames`` / ``transport.rpc`` and the worker's
  accept loop) — ``rpc_frames_sent_total``,
  ``rpc_frames_received_total``, ``rpc_frames_torn_total``,
  ``rpc_connects_total``, ``rpc_reconnects_total``,
  ``rpc_transport_errors_total``, ``rpc_heartbeats_total``,
  ``rpc_busy_frames_total``, ``rpc_server_connections`` (gauge),
  ``rpc_server_batches_total``, ``rpc_server_replies_dropped_total``,
  ``rpc_server_frames_malformed_total``;
* membership and version gates (``parallel.membership``,
  ``worker.server``) — ``reshard_epoch`` (gauge),
  ``reshard_migrations_total``, ``reshard_shards_moved_total``,
  ``reshard_aborted_total``, ``reshard_leave_refused_total``,
  ``reshard_catchup_seconds``; ``server_stale_epoch_total``,
  ``server_stale_diff_total``; the worker L2 ``worker_l2_hits_total``,
  ``worker_l2_misses_total``, ``gateway_l2_admit_denied_total``;
* online serving (``serving``) — ``serve_requests_total``,
  ``serve_requests_ok_total``, ``serve_request_seconds``,
  ``serve_queue_depth`` (gauge), ``serve_batches_total``,
  ``serve_batches_in_flight`` (gauge), ``serve_batch_fill``,
  ``serve_time_to_flush_seconds``, ``serve_flush_full_total``,
  ``serve_flush_wait_total``, ``serve_dispatch_seconds``,
  ``serve_shed_busy_total``, ``serve_shed_unavailable_total``,
  ``serve_shed_family_total``, ``serve_timeouts_total``,
  ``serve_errors_total``; the cache ``serve_cache_hits_total``,
  ``serve_cache_misses_total``, ``serve_cache_evictions_total``,
  ``serve_cache_entries`` and ``serve_cache_bytes`` (gauges),
  ``serve_cache_invalidated_scoped_total``,
  ``serve_cache_invalidated_full_total``, ``serve_cache_rekeyed_total``;
  hedging ``hedges_issued_total``, ``hedges_won_total``,
  ``hedges_budget_denied_total``; the dispatchers
  ``serve_hedge_qfile_reused_total``, ``rpc_dispatch_seconds``;
  families ``serve_matrix_requests_total``, ``serve_alt_requests_total``,
  ``serve_reverse_requests_total``;
* live traffic (``traffic``) — ``traffic_epoch`` (gauge),
  ``traffic_segments_applied_total``, ``traffic_edges_updated_total``,
  ``traffic_swap_seconds``;
* integrity — ``answer_fp_mismatch_total``,
  ``cache_fingerprint_mismatch_total``;
* fault harness — ``faults_injected_total``;
* artifacts — ``artifacts_swept_total``; the index counters of
  ``models.cpd.COUNTERS`` (``cpd_blocks_*``, ``build_*``,
  ``replica_*``) in the build's dump;
* flight recorder — ``recorder_events_total``,
  ``recorder_records_total``, ``recorder_segments_total``,
  ``recorder_torn_lines_total``, ``recorder_ring_bytes``;
* scrapes and device costs — ``obs_scrapes_total``,
  ``device_programs_analyzed`` (gauge) and the ``device_program_*``
  labeled gauges on ``/metrics``.

Not ported (ROADMAP.md A14.5): :mod:`.fleet`, :mod:`.slo`,
:mod:`.telemetry` and :mod:`.timeseries` — reaching for one raises an
error naming that item — and so the telemetry bus and ``/slo``.
"""

from . import device, metrics, quantiles, trace
from .metrics import REGISTRY, counter, gauge, histogram
from .quantiles import WINDOWS
from .trace import span

#: imported lazily (PEP 562): ``recorder`` uses ``utils.atomicio``, which
#: itself registers metrics — an eager import here would close an import
#: cycle through the package __init__
_LAZY = ("recorder",)
#: the JAX package's modules of this package that are not ported yet
_NOT_PORTED = ("fleet", "slo", "telemetry", "timeseries")


def __getattr__(name):
    if name in _LAZY:
        import importlib
        return importlib.import_module(f".{name}", __name__)
    if name in _NOT_PORTED:
        raise AttributeError(f"obs.{name} is not ported (ROADMAP.md "
                             "A14.5)")
    raise AttributeError(f"module {__name__!r} has no attribute "
                         f"{name!r}")


__all__ = ["device", "metrics", "quantiles", "recorder", "trace",
           "REGISTRY", "WINDOWS", "counter", "gauge", "histogram",
           "span"]
