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
  transitions, fault fires, scrub and audit findings and control
  actions post to it; ``--recorder-dir`` / ``DOS_RECORDER_DIR``);
* :mod:`.telemetry` and :mod:`.timeseries` — the fleet telemetry bus
  (``DOS_TELEMETRY_INTERVAL_S``): workers publish delta snapshots over
  the RPC lane's telemetry frames or FIFO ``.telemetry`` sidecars, the
  head ingests them into a byte-budgeted ring store;
* :mod:`.slo` — multi-window burn-rate objectives (``DOS_SLO_SPECS``),
  served on ``/slo``;
* :mod:`.fleet` — snapshot merges, ``top`` rendering and the bench
  comparison, driven by the ``dos-obs`` CLI (``cli.obs``);
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
  ``mesh_walk_batches_total`` (batches split over worker lanes); the
  oracle's ``mesh_collective_seconds`` (``query_mat``'s join);
* kernel launches — the wrappers' counts under their own names
  (``cuda_walk_batch.launches``, ``cuda_walk_batch.launches_pack4``,
  ``cuda_walk_batch.plain``, ``astar_sweep.launches``, ...), mirrored
  into the registry by the worker's dumps (``metrics.mirror_counts``);
  beside them the work the kernels did where it depends on the data:
  ``relax_jacobi.active_pairs`` (the (node, column group) pairs K1
  relaxed, in the build's dump), ``astar_sweep.gathers`` (the in-edge
  slots K6 read a source's row for) and ``astar_batch_np.sweeps`` (the
  batched A* loop's sweeps, in the worker's dump);
* kernel-path spans (``trace``; recorded under ``--trace`` or while a
  ``torch.profiler`` session records, then also in the profiler's trace,
  with running totals in ``trace.span_seconds`` and
  ``trace.span_count``) — the build's ``build.shard`` (a
  ``build_fm_sharded`` call), ``build.csr`` (the CSR and its visit
  order), ``build.relax`` (a relax loop) with ``build.step_launch`` and
  ``build.flag_read`` a step in it, ``build.first_moves``; batched A*'s
  ``astar.chunk`` (a chunk of ``astar_batch_np``) with
  ``astar.flags_read`` (a group of K6 sweeps' flags read) in it;
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
  ``serve_queue_depth`` (gauge) and its per-shard
  ``serve_queue_depth_w<wid>`` gauges, ``serve_batches_total``,
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

Gateway tier (``gateway/`` — N stateless frontends behind a binary
client protocol, plus the shard-owner L2 result cache,
``DOS_GATEWAY_*``; README "Gateway tier"):

* client ingress — ``gateway_requests_total`` (frames received on
  client connections: queries, hellos, pings),
  ``gateway_queries_total`` (individual queries inside batched query
  frames, all families), ``gateway_clients`` (gauge: live client
  connections across this process's frontends);
* backpressure — ``gateway_busy_total`` (query frames refused with an
  explicit BUSY because the connection's credit window was full — the
  gateway twin of ``rpc_busy_frames_total``);
* protocol hygiene — ``gateway_frames_malformed_total`` (client
  frames that failed to decode and were answered with a typed ERROR
  frame instead of a torn connection);
* shard-owner L2 cache — ``worker_l2_hits_total`` (queries answered
  from the worker's ``(s, t, diff-epoch)`` cache before the kernel)
  and ``worker_l2_misses_total`` (L2 lookups that fell through to the
  kernel); ``gateway_l2_admit_denied_total`` (inserts withheld by the
  second-hit admission doorkeeper,
  ``DOS_GATEWAY_L2_ADMIT=second-hit``); entry counts and per-replica
  hit rates ride ``/statusz``, not the registry;
* high availability (leased endpoint registry + client failover,
  README "Gateway HA") — ``gateway_lease_renewals_total`` (endpoint
  lease heartbeats written to ``gateway.json``),
  ``gateway_live_frontends`` (gauge: frontends with an unexpired
  lease at the last registry read), ``gateway_client_failovers_total``
  (client connection moves to another live frontend, unanswered
  frames resubmitted under their original ids),
  ``gateway_resubmits_deduped_total`` (resubmitted frames a frontend
  had already answered, replayed from the ``(cid, id)`` memo — the
  exactly-once accounting guarantee), and
  ``gateway_failover_frames_total`` (resubmitted frames re-executed
  on a frontend that had NOT answered them — the at-least-once
  execution half; answers stay bit-identical).

Fleet telemetry bus (``obs.telemetry`` + ``obs.timeseries`` — workers
push delta-encoded metric snapshots to the head over the RPC wire or
the FIFO lane's ``.telemetry`` sidecar, ``DOS_TELEMETRY_INTERVAL_S``;
README "Fleet telemetry & SLOs"):

* publisher — ``telemetry_ticks_published_total`` (snapshots emitted
  on the cadence), ``telemetry_publish_errors_total`` (sinks that
  raised; per-sink, the tick still reaches the others),
  ``telemetry_publish_seconds`` (one tick build+fan-out — the bench's
  publish-overhead numerator), ``rpc_heartbeat_seconds`` window
  (heartbeat round-trips per connection, plus the per-worker
  ``rpc_heartbeat_seconds_w<wid>`` twins);
* head ingest — ``telemetry_ticks_ingested_total`` /
  ``telemetry_ticks_dropped_total`` (undecodable or wrong-shape
  ticks), ``telemetry_counter_resets_total`` (source restarts
  detected by incarnation change or counter regression — deltas clamp
  to absolute-from-zero, never negative);
* timeseries store (byte-budgeted ring, ``DOS_TELEMETRY_BYTES``) —
  ``telemetry_points_total`` (points appended),
  ``telemetry_series_evicted_total`` (rings dropped by the budget,
  oldest-written first), ``telemetry_series`` / ``telemetry_store_bytes``
  (gauges: live ring count and retained bytes).

SLO burn-rate engine (``obs.slo`` — declarative objectives evaluated
as multi-window burn rates with hysteresis, ``DOS_SLO_SPECS``; the
``/slo`` endpoint and ``dos-obs slo``):

* ``slo_evaluations_total`` / ``slo_alerts_total`` (evaluation passes,
  and alerts that TRIPPED — clears don't count);
* per-objective gauges ``slo_fast_burn_<name>`` / ``slo_slow_burn_<name>``
  (burn = bad-fraction / error-budget over the fast/slow windows) and
  ``slo_alerting_<name>`` (1 while tripped; hysteresis clears at half
  the trip threshold).

Black-box flight recorder (``obs.recorder`` — bounded on-disk ring of
telemetry ticks + structured events, ``DOS_RECORDER_DIR``; ``dos-obs
record`` / ``dos-obs replay``):

* ``recorder_events_total`` (structured events emitted fleet-wide:
  epoch swaps, breaker transitions, respawns, membership commits,
  BUSY storms, fault injections, SLO alerts/clears),
  ``recorder_records_total`` (records written to the tape),
  ``recorder_segments_total`` (segment rotations),
  ``recorder_torn_lines_total`` (torn tail lines skipped at replay),
  ``recorder_ring_bytes`` (gauge: on-disk ring footprint).

Closed-loop control (``control/`` — the policy daemon that turns the
sensors above into automatic recovery actions, ``DOS_CONTROL``;
README "Closed-loop control"):

* loop — ``control_ticks_total`` (sense->decide->act passes),
  ``control_decisions_total`` (decisions reached: executed, dry-run,
  or budget-denied), ``control_actions_total`` (actions executed),
  ``control_budget_denied_total`` (decisions past the global action
  budget), ``control_errors_total`` (actuator executions that raised);
* quarantine — ``control_quarantines_total`` (sick workers removed
  from routing: breaker pin + respawn kick),
  ``control_readmissions_total`` (re-admitted after N clean probes);
* brownout — ``control_brownout_shifts_total`` (ladder level changes),
  ``control_brownout_level`` (gauge: current level, 0 = full service);
* repair / scale — ``control_repairs_total`` (plan_join / plan_leave /
  hot-shard replication executed), ``control_scale_advised_total``
  (scale-up advisories booked where the daemon owns no actuator:
  no join host configured, or lane widening needing a worker restart);
* warming — ``control_warms_total`` (next diff epoch pre-fused /
  registered warmers run ahead of the pump cadence);
* gateway HA arm — ``control_gateway_kicks_total`` (dead gateway
  frontends kicked for respawn after their ``gateway.json`` endpoint
  lease expired: the actuator calls a ``gateway_respawn_fn`` when one
  is passed — as in the JAX package no caller passes one — else the
  worker supervisor's ``kick``);
* supervision (``worker.supervisor``, ``make_fifos --supervise``) —
  ``supervisor_respawns_total``, ``supervisor_pings_total``,
  ``supervisor_ping_failures_total``, ``supervisor_workers_alive``
  (gauge); the daemon's quarantine kick clears a dead worker's backoff
  through the supervisor's ``kick``.

Answer-integrity plane (``integrity/`` — resident-table scrubbing,
sampled dual-execution audit, and wire/cache answer fingerprints,
``DOS_SCRUB_*`` / ``DOS_AUDIT_*`` / ``DOS_ANSWER_FP``; README "Answer
integrity & auditing"):

* resident scrubber — ``scrub_blocks_checked_total`` (resident blocks
  crc32-compared against their digest-verified on-disk truth),
  ``scrub_blocks_corrupt_total`` (blocks whose resident rows diverged
  — silent in-memory corruption; the table re-binds from disk),
  ``scrub_passes_total`` / ``scrub_pass_seconds`` (pass cadence and
  wall cost — the overhead numerator the bench's integrity section
  holds under its budget);
* dual-execution audit — ``audit_batches_total`` (served batches
  re-executed on an independent lane: replica, CPU reference, or
  uncached recompute), ``audit_divergence_total`` (audits whose
  re-execution DISAGREED with the served answer — the wrong-answer
  alarm feeding the control loop's divergence-quarantine arm),
  ``audit_dropped_total`` (samples dropped at the bounded queue — the
  audit plane never backpressures serving), ``audit_lane_seconds``
  (one re-execution + compare, by whichever lane ran);
* answer fingerprints — ``answer_fp_mismatch_total`` (replies whose
  crc32 answer fingerprint failed verification at a dispatcher or
  results-sidecar decode; the batch fails over instead of serving
  corrupted answers), ``cache_fingerprint_mismatch_total`` (cache
  hits whose stored entry no longer matches its insertion-time
  fingerprint — dropped and recomputed, never served);
* control arm — ``control_divergence_quarantines_total`` (shards
  pulled from routing on a confirmed audit divergence: breaker
  force-open + scrub-now, re-admitted only after clean probes).
"""

from . import device, fleet, metrics, quantiles, trace
from .metrics import REGISTRY, counter, gauge, histogram
from .quantiles import WINDOWS
from .trace import span

#: imported lazily (PEP 562): these modules use ``utils.atomicio``,
#: which itself registers metrics — an eager import here would close
#: an import cycle through the package __init__
_LAZY = ("recorder", "slo", "telemetry", "timeseries")


def __getattr__(name):
    if name in _LAZY:
        import importlib
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute "
                         f"{name!r}")


__all__ = ["device", "fleet", "metrics", "quantiles", "recorder",
           "slo", "telemetry", "timeseries", "trace",
           "REGISTRY", "WINDOWS", "counter", "gauge", "histogram",
           "span"]
