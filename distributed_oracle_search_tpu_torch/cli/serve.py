"""Always-on oracle service: the online counterpart of the campaign
drivers (``dos-serve``), on the card.

A copy of the JAX package's ``cli/serve.py`` over the port's engines:
``--device`` (default ``cuda``; raises without a GPU unless ``cpu``)
places every in-process shard engine, so each batch the frontend
dispatches is walked by the hand kernel (B1/B1′) on the card.

Where ``cli.process_query`` answers a whole scenario file and exits,
this entry point keeps a :class:`~..serving.ServingFrontend` resident
and feeds it from a line-protocol ingress (stdin by default; a unix
socket or a tailed file for external producers). Two backends:

* ``--backend inproc`` (default) — shard engines live in this process
  (one :class:`~..worker.engine.ShardEngine` per worker; missing CPD
  shards are built on first use so ``--test`` works from a bare
  checkout);
* ``--backend host`` — the campaign wire against resident
  ``worker.server`` processes (launch them with ``dos-make-fifos``),
  with the per-worker circuit breakers + background healing probes the
  campaign path uses; per-query answers return via the
  ``RuntimeConfig.results`` sidecar wire extension.

Serving knobs come from ``DOS_SERVE_*`` env vars, overridable by flags
(``--max-batch``, ``--max-wait-ms``, ``--queue-depth``,
``--cache-bytes``, ``--deadline-ms``). ``--metrics-dump PATH`` writes
the obs snapshot on shutdown — queue depths, batch-fill and
time-to-flush histograms, cache hit/miss counters, end-to-end request
latencies — and the ``obs.device`` entries of the walk programs this
process ran; with ``--backend inproc`` also the kernel wrappers' launch
counts mirrored into its ``counters`` and the device (its name and peak
allocated bytes).

``--traffic-dir`` swaps congestion diffs live, the membership hook
follows ``membership.json`` (a static fleet included), and
``DOS_ANSWER_FP`` fingerprints answers. The planes are the JAX
package's: the resident scrubber (``DOS_SCRUB_INTERVAL_S``; it reads
and re-binds the engines' tables on their device) and the answer audit
(``DOS_AUDIT_RATE``; its replica and recompute lanes walk with B1 from
the audit thread), the telemetry bus (``DOS_TELEMETRY_INTERVAL_S``;
``/statusz`` ``telemetry``), the SLO engine (``DOS_SLO_SPECS``;
``/slo``), the control daemon (``DOS_CONTROL``) and the flight recorder
(``--recorder-dir``, ``DOS_RECORDER_DIR``).
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import threading

from ..obs import device as obs_device
from ..obs import metrics as obs_metrics
from ..serving import (
    AutoDispatcher, EngineDispatcher, FifoDispatcher, RpcDispatcher,
    ServeConfig, ServingFrontend,
)
from ..serving import ingress
from ..transport import fifo as fifo_transport
from ..transport import resilience
from ..transport import rpc as rpc_transport
from ..transport.fifo import command_fifo_path
from ..transport.wire import HealthStatus, RuntimeConfig
from ..utils.atomicio import atomic_write_json
from ..utils.config import ClusterConfig, test_config
from ..utils.env import env_flag
from ..utils.log import get_logger, set_verbosity

log = get_logger(__name__)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="serve", description=__doc__.splitlines()[0])
    p.add_argument("-c", default="./example-cluster-conf.json",
                   help="cluster config JSON")
    p.add_argument("-t", "--test", action="store_true",
                   help="serve the canned synthetic dataset (builds "
                        "missing CPD shards in-process)")
    p.add_argument("-v", "--verbose", action="count", default=0)
    p.add_argument("--backend", default="inproc",
                   choices=["inproc", "host"],
                   help="inproc: shard engines in this process; host: "
                        "FIFO wire to resident worker servers")
    p.add_argument("--alg", default="table-search",
                   choices=["table-search", "astar"],
                   help="serving algorithm (inproc backend)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the in-process shard engines "
                        "(default: cuda; raises without a GPU)")
    p.add_argument("--diff", default=None,
                   help="active congestion diff (default: the conf's "
                        "first diff, '-' = free flow)")
    p.add_argument("--ingress", default="stdin",
                   choices=["stdin", "socket", "tail"],
                   help="where 's t' request lines come from")
    p.add_argument("--socket", default="/tmp/dos-serve.sock",
                   help="unix socket path (--ingress socket)")
    p.add_argument("--tail", default=None,
                   help="request file to follow (--ingress tail); "
                        "answers append to <file>.answers")
    p.add_argument("--queue-depth", type=int, default=None,
                   help="per-shard queue bound (DOS_SERVE_QUEUE_DEPTH)")
    p.add_argument("--max-batch", type=int, default=None,
                   help="micro-batch flush size, power of two "
                        "(DOS_SERVE_MAX_BATCH)")
    p.add_argument("--max-wait-ms", type=float, default=None,
                   help="micro-batch wait bound (DOS_SERVE_MAX_WAIT_MS)")
    p.add_argument("--cache-bytes", type=int, default=None,
                   help="result-cache budget, 0 disables "
                        "(DOS_SERVE_CACHE_BYTES)")
    p.add_argument("--deadline-ms", type=float, default=None,
                   help="per-request deadline (DOS_SERVE_DEADLINE_MS)")
    p.add_argument("--traffic-dir", default=None,
                   help="diff segment stream directory: swap the "
                        "active congestion diff LIVE as epoch-tagged "
                        "segments land (no restart; scoped cache "
                        "invalidation)")
    p.add_argument("--traffic-spool", default=None,
                   help="where fused per-epoch diff files materialize "
                        "(default <traffic-dir>/fused; must be "
                        "worker-visible for --backend host)")
    p.add_argument("--metrics-dump", default="",
                   help="write a JSON metrics snapshot here on shutdown")
    p.add_argument("--obs-port", type=int, default=None,
                   help="serve live /metrics /healthz /statusz on this "
                        "port (0 = OS-assigned ephemeral; default off; "
                        "DOS_OBS_PORT env)")
    p.add_argument("--recorder-dir", default=None,
                   help="flight-recorder tape directory: keep a bounded "
                        "on-disk ring of telemetry ticks + structured "
                        "events for dos-obs replay (DOS_RECORDER_DIR "
                        "env; default off)")
    return p


def build_frontend(conf: ClusterConfig, args):
    """Frontend + (for the host backend) the breaker registry the
    caller must shut down."""
    sconf = ServeConfig.from_env(
        queue_depth=args.queue_depth, max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms, cache_bytes=args.cache_bytes,
        deadline_ms=args.deadline_ms)
    # the answer-integrity plane (DOS_SCRUB_* / DOS_AUDIT_* /
    # DOS_ANSWER_FP) — every default is off, in which case nothing is
    # constructed and the wire stays byte-identical legacy
    from ..integrity import IntegrityConfig
    icfg = IntegrityConfig.from_env()
    rconf = RuntimeConfig(answer_fp=icfg.answer_fp)
    diff = args.diff if args.diff is not None else (
        conf.diffs[0] if conf.diffs else "-")
    registry = None
    breaker_key = None
    if args.backend == "host":
        if conf.is_tpu:
            raise SystemExit(
                "--backend host needs host-mode workers; partmethod=tpu "
                "shards live on the device mesh (use --backend inproc)")
        # DOS_TRANSPORT selects the host-backend data plane: `fifo`
        # (default — the campaign wire, byte-identical legacy), `rpc`
        # (persistent multiplexed sockets, no per-batch files), `auto`
        # (rpc with sticky per-lane fifo fallback for mixed fleets)
        transport = rpc_transport.resolve_transport()
        if transport == "rpc":
            dispatcher = RpcDispatcher(conf)
            probe_fn = lambda key: rpc_transport.probe(  # noqa: E731
                key[1], host=key[0])
        elif transport == "auto":
            dispatcher = AutoDispatcher(conf)

            def probe_fn(key):
                st = rpc_transport.probe(key[1], host=key[0])
                if st is not None:
                    return st
                return fifo_transport.probe(
                    key[0], key[1],
                    command_fifo=command_fifo_path(key[1]),
                    nfs=conf.nfs)
        else:
            dispatcher = FifoDispatcher(conf)
            probe_fn = lambda key: fifo_transport.probe(  # noqa: E731
                key[0], key[1], command_fifo=command_fifo_path(key[1]),
                nfs=conf.nfs)
        if transport != "fifo":
            log.info("host backend data plane: DOS_TRANSPORT=%s",
                     transport)
        registry = resilience.BreakerRegistry(probe_fn=probe_fn)
        breaker_key = lambda wid: (conf.workers[wid], wid)  # noqa: E731
    else:
        dispatcher = EngineDispatcher(conf, alg=args.alg,
                                      build_missing=args.test,
                                      device=args.device)
        registry, breaker_key = _inproc_breakers()
    dc = dispatcher.dc if args.backend == "inproc" else _dc_for(conf)
    # elastic membership: a committed epoch's owner table (and any
    # in-flight migration's dual-read window) overrides the conf's
    # static identity; absent membership.json = the pre-elastic world
    from ..parallel import membership as fleet
    mstate = fleet.load_state(conf.outdir)
    if mstate is not None:
        dc = fleet.apply_state(dc, mstate)
        if args.backend == "inproc":
            dispatcher.dc = dc
    # the controller is wired even on a static fleet: its throttled
    # refresh() picks up a membership.json that appears AFTER startup,
    # so a long-lived serve observes later join/leave commits instead
    # of routing to drained workers forever (epoch 0 keeps the wire and
    # admission byte-identical — the epoch stamp is gated on nonzero)
    mc = fleet.MembershipController(
        conf, dc, device=args.device if args.backend == "inproc"
        else None)
    if args.backend == "host":
        # a joined worker's id is past the conf's static roster;
        # resolve hosts (dispatch AND breaker keys) from the live
        # membership roster instead
        dispatcher.host_of = mc.host_of
        breaker_key = lambda wid: (mc.host_of(wid), wid)  # noqa: E731
    if mstate is not None:
        log.info("serving under membership epoch %d", mc.epoch)
    # live traffic: a segment stream turns the static --diff into the
    # BASE of a rolling fusion; the frontend's epoch pump swaps fused
    # epochs without restart
    traffic = None
    if getattr(args, "traffic_dir", None):
        from ..traffic import DiffEpochManager

        traffic = DiffEpochManager(args.traffic_dir, base_diff=diff,
                                   spool_dir=args.traffic_spool)
        log.info("live traffic enabled: stream %s, spool %s",
                 args.traffic_dir, traffic.spool)
    frontend = ServingFrontend(
        dc, dispatcher, sconf=sconf, rconf=rconf, diff=diff,
        registry=registry, breaker_key=breaker_key, membership=mc,
        traffic=traffic)
    # typed query families (mat/alt/rev) on the same frontend; the alt
    # planner loads the graph lazily on its first query
    from ..traffic import QueryFamilies
    if args.backend == "inproc":
        families = QueryFamilies(
            frontend, graph=dispatcher.graph, traffic=traffic,
            oracle=_mesh_mat_oracle(conf, dispatcher, traffic))
    else:
        from ..data.graph import Graph
        families = QueryFamilies(
            frontend,
            graph_provider=lambda: Graph.from_xy(conf.xy_file),
            traffic=traffic)
    _build_integrity(frontend, dispatcher, icfg, args.backend)
    return frontend, registry, families


def _inproc_breakers():
    """The in-process backend's breaker registry: one when the control
    daemon is on (``DOS_CONTROL``), else none (the JAX package's inproc
    frontend never has one). The daemon quarantines a shard by forcing
    its breaker open, and the JAX package's ``--backend inproc`` serve
    has no breaker to force, so its divergence quarantine fails; here
    each shard id is its own breaker key, and a probe answers healthy:
    the engines live in this process, with no worker to lose. A
    re-admitted shard whose table still diverges is quarantined again
    by the next audit."""
    from ..control import ControlConfig

    if not ControlConfig.from_env().enabled:
        return None, None
    reg = resilience.BreakerRegistry(
        probe_fn=lambda key: HealthStatus(ok=True, wid=int(key)))
    return reg, (lambda wid: wid)


def _build_integrity(frontend, dispatcher, icfg, backend: str) -> None:
    """Construct whatever slice of the integrity plane is enabled and
    hang it off the frontend (``frontend.auditor`` /
    ``frontend.scrubber`` — ``/statusz`` and the control daemon's
    providers read them there). With every knob at its default this
    constructs nothing."""
    if not icfg.any_enabled:
        return
    if icfg.scrub_interval_s > 0:
        if backend == "inproc":
            from ..integrity.scrub import TableScrubber

            # the dispatcher builds engines lazily on first dispatch;
            # re-listing every pass picks up late arrivals
            scrubber = TableScrubber(
                lambda: list(dispatcher._engines.values()),
                icfg.scrub_interval_s, icfg.scrub_blocks_per_pass)
            scrubber.start()
            frontend.scrubber = scrubber
            log.info("resident scrubber on: every %.1fs, %s blocks/pass",
                     icfg.scrub_interval_s,
                     icfg.scrub_blocks_per_pass or "all")
        else:
            log.warning("DOS_SCRUB_INTERVAL_S ignored: the host "
                        "backend's resident tables live in the worker "
                        "processes, not here")
    if icfg.audit_rate > 0:
        from ..integrity.audit import AnswerAuditor, make_reference_fn

        reference_fn = describe_fn = None
        if backend == "inproc":
            reference_fn = make_reference_fn(dispatcher.graph)

            def describe_fn(wid, via):
                eng = dispatcher._engines.get((int(wid), via))
                return {"codec": getattr(eng, "resident_codec", None)
                        } if eng is not None else {}
        frontend.auditor = AnswerAuditor(
            dispatcher, icfg.audit_rate, reference_fn=reference_fn,
            describe_fn=describe_fn,
            max_reference=icfg.audit_max_reference)
        log.info("answer audit on: %d per mille, reference lane %s",
                 icfg.audit_rate,
                 "available" if reference_fn else "unavailable")
    if icfg.answer_fp:
        log.info("answer fingerprints on: replies and cache entries "
                 "carry crc32 checks")


def _mesh_mat_oracle(conf: ClusterConfig, dispatcher, traffic=None):
    """``DOS_MESH_MAT``: load a mesh-resident oracle so the ``mat``
    family answers each row with ONE on-mesh collective
    (``CPDOracle.query_mat`` — walk + psum join on device) instead of
    one frontend future per target. Inproc backend only (the oracle
    needs the full index on the local mesh); any load failure logs and
    degrades to the fan-out/join path, never a startup outage.

    Disabled under live traffic (``--traffic-dir``), as in JAX: an
    engine promoted to a delta-rebuilt index (``ShardEngine.
    promote_index``) would walk new-regime rows while this oracle's
    startup table kept the old ones (no caller promotes on a swap today:
    a swap serves its fused ``.diff`` through the engines' weight LRU)."""
    if not env_flag("DOS_MESH_MAT", False):
        return None
    if traffic is not None:
        log.warning("DOS_MESH_MAT ignored under --traffic-dir: the "
                    "mesh oracle cannot follow epoch-promoted delta "
                    "indexes; mat serves via fan-out/join")
        return None
    try:
        from ..models.cpd import CPDOracle

        oracle = CPDOracle(dispatcher.graph, dispatcher.dc,
                           device=dispatcher.device)
        oracle.load(conf.outdir)
        log.info("DOS_MESH_MAT: mat family serving via on-mesh "
                 "collectives (index %s)", conf.outdir)
        return oracle
    except Exception as e:  # noqa: BLE001 — an optimization path must
        # not take the serve down with it
        log.warning("DOS_MESH_MAT: cannot load mesh oracle from %s: %s "
                    "(mat serves via fan-out/join)", conf.outdir, e)
        return None


def _dc_for(conf: ClusterConfig):
    from ..data.formats import xy_node_count
    from ..parallel.partition import DistributionController

    return DistributionController(conf.partmethod, conf.partkey,
                                  conf.maxworker,
                                  xy_node_count(conf.xy_file),
                                  replication=conf
                                  .effective_replication())


def metrics_snapshot(dispatcher) -> dict:
    """The ``--metrics-dump`` payload: ``obs.metrics.REGISTRY``'s
    snapshot, the ``obs.device`` entries of the walk programs this
    process ran (``device_programs``) and the pid; with in-process
    engines also the kernel wrappers' counts mirrored into its
    ``counters`` (``worker.server.kernel_counts``) and their device (its
    name and peak allocated bytes). The host backend's engines live in
    the worker processes, whose own dumps hold theirs: its ``device`` is
    ``host`` (and this process never imports torch)."""
    dev = getattr(dispatcher, "device", None)
    if dev is None:
        device = {"type": "host", "name": "", "max_memory_allocated": 0}
    else:
        import torch

        from ..worker.server import kernel_counts

        obs_metrics.mirror_counts(
            kernel_counts(), help="kernel wrapper launch / plain counts")
        on_card = dev.type == "cuda"
        device = {
            "type": dev.type,
            "name": torch.cuda.get_device_name(dev) if on_card else "cpu",
            "max_memory_allocated": (
                int(torch.cuda.max_memory_allocated(dev)) if on_card
                else 0),
        }
    return {**obs_metrics.REGISTRY.snapshot(), "device": device,
            "device_programs": obs_device.snapshot(), "pid": os.getpid()}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    set_verbosity(args.verbose)
    if args.test:
        from ..data.synth import ensure_synth_dataset

        # the canned tpu-partition config: contiguous shards that match
        # the checked-in synth index layout; the inproc backend serves
        # any partmethod (shard engines only need the block files)
        conf = test_config()
        ensure_synth_dataset(os.path.dirname(conf.xy_file) or "./data")
    else:
        conf = ClusterConfig.load(args.c)
    frontend, registry, families = build_frontend(conf, args)
    frontend.start()
    obs_srv = None
    head_pub = poller = slo_engine = recorder = daemon = None
    # graceful drain: SIGTERM (the orchestrator's stop signal) and
    # SIGINT both stop ingress — the event ends the socket/tail loops,
    # the exception unwinds a blocking stdin read — then the finally
    # block drains the bounded queues, flushes in-flight micro-batches
    # (frontend.stop: every admitted request is answered or shed, never
    # silently dropped), writes the final metrics dump, and exits 0.
    stop_evt = threading.Event()

    def _on_signal(signum, frame):
        if stop_evt.is_set():
            return     # repeat signal mid-drain: keep draining
        log.info("received %s; stopping ingress and draining",
                 signal.Signals(signum).name)
        stop_evt.set()
        raise KeyboardInterrupt

    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, _on_signal)
    try:
        # live observability plane (opt-in): /metrics answers Prometheus
        # text with the sliding-window p50/p95/p99 gauges + exemplars,
        # /healthz flips 503 once draining starts, /statusz reports
        # breaker + queue + replica + hedge + membership state and the
        # walk programs' device costs. Inside the try: a bind failure
        # (port taken) must drain the started frontend, not leave its
        # batcher threads running behind a traceback
        from ..obs import recorder as obs_recorder
        from ..obs import slo as obs_slo
        from ..obs import telemetry as obs_telemetry
        from ..obs import timeseries as obs_timeseries
        from ..obs.http import start_obs_server
        from ..utils.env import env_str
        # the fleet telemetry plane: workers push ticks here (telemetry
        # frames on the RPC lane, polled .telemetry sidecars on the
        # FIFO lane), the head publishes its OWN serve-side windows and
        # shed counters into the same store, and the SLO engine burns
        # budgets against the merged view. All of it optional: with
        # DOS_TELEMETRY_INTERVAL_S=0 the serve runs exactly as before.
        store = obs_timeseries.TimeseriesStore()
        recorder = None
        rec_dir = args.recorder_dir or env_str("DOS_RECORDER_DIR")
        if rec_dir:
            recorder = obs_recorder.FlightRecorder(rec_dir)
            obs_recorder.set_recorder(recorder)
        tele_ingest = obs_telemetry.TelemetryIngest(store,
                                                    recorder=recorder)
        rpc_transport.set_telemetry_sink(tele_ingest.ingest)
        poller = None
        if args.backend == "host":
            poller = obs_telemetry.SidecarPoller(
                os.path.dirname(command_fifo_path(0)) or ".",
                tele_ingest).start()
        head_pub = None
        if obs_telemetry.interval_s() > 0:
            head_pub = obs_telemetry.TelemetryPublisher(
                source="head", sinks=[tele_ingest.ingest]).start()
        slo_engine = obs_slo.SLOEngine(store).start()
        # closed-loop control (DOS_CONTROL=1): the policy daemon senses
        # this head's SLO burn, queues, breakers and worker telemetry,
        # and executes the brownout/quarantine/repair/warming ladder
        # against the same in-process handles. Off by default: nothing
        # is constructed and serving is byte-identical legacy.
        from ..control import maybe_daemon
        probe_fn = None
        if registry is not None and registry.probe_fn is not None:
            def probe_fn(wid):
                st = registry.probe_fn(frontend._breaker_key(wid))
                return st is not None and getattr(st, "ok", False)
        daemon = maybe_daemon(
            slo=slo_engine, frontend=frontend, registry=registry,
            membership=frontend.membership, ingest=tele_ingest,
            probe_fn=probe_fn, integrity=frontend.auditor,
            scrub_fn=(frontend.scrubber.scrub_now
                      if frontend.scrubber is not None else None))
        status_providers = {
            "serving": frontend.statusz,
            "device_programs": obs_device.snapshot,
            "telemetry": tele_ingest.statusz,
            "slo": slo_engine.statusz,
        }
        if daemon is not None:
            status_providers["control"] = daemon.statusz
        if (frontend.auditor is not None
                or frontend.scrubber is not None):
            def _integrity_status(fe=frontend):
                out = {}
                if fe.auditor is not None:
                    out["audit"] = fe.auditor.statusz()
                if fe.scrubber is not None:
                    out["scrub"] = fe.scrubber.statusz()
                return out
            status_providers["integrity"] = _integrity_status
        obs_srv = start_obs_server(
            args.obs_port,
            health_fn=lambda: {
                "ok": frontend._started and not frontend._closed,
                "role": "dos-serve", "backend": args.backend},
            status_providers=status_providers,
            slo_provider=slo_engine.payload)
        if args.ingress == "stdin":
            n = ingress.serve_stdin(frontend, families=families)
        elif args.ingress == "socket":
            ingress.serve_unix_socket(frontend, args.socket,
                                      stop=stop_evt, families=families)
            n = None
        else:
            if not args.tail:
                raise SystemExit("--ingress tail needs --tail FILE")
            n = ingress.tail_file(frontend, args.tail, stop=stop_evt,
                                  families=families)
        if n is not None:
            log.info("ingress closed after %d request(s)", n)
    except KeyboardInterrupt:
        log.info("interrupted; draining")
    finally:
        stop_evt.set()
        if daemon is not None:
            daemon.stop()
        frontend.stop()
        # integrity plane after the frontend: no new batches are being
        # served, so the auditor drains its queue tail and exits
        if frontend.auditor is not None:
            frontend.auditor.stop()
        if frontend.scrubber is not None:
            frontend.scrubber.stop()
        if obs_srv is not None:
            obs_srv.close()
        # telemetry plane teardown: stop the loops, detach the global
        # sinks (they outlive main() otherwise), seal the tape durably
        rpc_transport.set_telemetry_sink(None)
        for t in (head_pub, poller, slo_engine):
            if t is not None:
                t.stop()
        if recorder is not None:
            from ..obs import recorder as obs_recorder
            obs_recorder.set_recorder(None)
            recorder.close()
        if registry is not None:
            registry.shutdown()
        if args.metrics_dump:
            atomic_write_json(args.metrics_dump,
                              metrics_snapshot(frontend.dispatcher))
        log.info("drained and stopped cleanly")
    return 0


if __name__ == "__main__":
    sys.exit(main())
