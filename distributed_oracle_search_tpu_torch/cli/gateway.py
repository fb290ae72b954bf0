"""Gateway tier: N stateless binary-protocol frontends (``dos-gateway``).

Where ``dos-serve`` keeps ONE :class:`~..serving.ServingFrontend`
behind a line-protocol ingress, this entry point runs a horizontal
tier: ``--replicas`` frontends in one process, each with its own
admission/batcher/hedge stack over the SAME worker pool, each listening
on its own unix socket speaking the binary gateway protocol
(:mod:`..gateway.protocol` — multiplexed batched query frames for all
families, credit-window backpressure, hello version negotiation).
Replicas share nothing but ``membership.json`` and the diff-epoch
spool, so killing one loses no state — clients reconnect to a sibling.

Clients use :class:`~..gateway.DosClient`; sockets land at
``<socket-dir>/dos-gateway-f<fid>.sock``. Knobs come from
``DOS_GATEWAY_*`` env vars, overridable by flags. ``--obs-port`` serves
``/statusz`` with a ``gateway`` section (per-replica client counts and
L1 hit rates) that ``dos-obs top`` renders as the tier's columns.

High availability: ``--registry-dir`` (default: the conf's index
directory) points at the leased endpoint registry ``gateway.json``
(:mod:`..gateway.registry`) — every replica registers its socket there
and renews on a heartbeat, so clients discover and fail over by
reading the file. ``--join`` claims fresh frontend ids ABOVE whatever
the registry has seen, letting a second ``dos-gateway --join`` process
(same registry, same worker pool) widen the tier horizontally: one
logical tier spanning processes, bit-identical answers from every
replica.

The port of the JAX package's ``cli/gateway.py``: ``--device`` (default
``cuda``; raises without a GPU unless ``cpu``) goes to
``cli.serve.build_frontend``, as ``dos-serve``'s does, so each replica's
in-process engines walk its batches with the hand kernel (B1/B1′) on the
card. Each replica builds its own dispatcher, so R replicas hold R
copies of every shard their traffic reaches, as in JAX.
``--metrics-dump`` writes ``cli.serve.metrics_snapshot``: the registry
with the kernel wrappers' launch counts of the whole process, its
device and the walk programs' ``obs.device`` entries.
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading

from ..gateway import GatewayConfig, GatewayTier
from ..utils.atomicio import atomic_write_json
from ..utils.log import get_logger, set_verbosity

log = get_logger(__name__)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gateway", description=__doc__.splitlines()[0])
    p.add_argument("-c", default="./example-cluster-conf.json",
                   help="cluster config JSON")
    p.add_argument("-t", "--test", action="store_true",
                   help="serve the canned synthetic dataset (builds "
                        "missing CPD shards in-process)")
    p.add_argument("-v", "--verbose", action="count", default=0)
    p.add_argument("--backend", default="inproc",
                   choices=["inproc", "host"],
                   help="inproc: shard engines in this process; host: "
                        "FIFO/RPC wire to resident worker servers")
    p.add_argument("--device", default="cuda",
                   help="torch device of the in-process shard engines "
                        "(default: cuda; raises without a GPU)")
    p.add_argument("--alg", default="table-search",
                   choices=["table-search", "astar"])
    p.add_argument("--diff", default=None,
                   help="active congestion diff (default: the conf's "
                        "first diff, '-' = free flow)")
    p.add_argument("--replicas", type=int, default=None,
                   help="frontend replica count (DOS_GATEWAY_REPLICAS)")
    p.add_argument("--socket-dir", default=None,
                   help="where replica sockets land "
                        "(DOS_GATEWAY_SOCKET_DIR)")
    p.add_argument("--credit", type=int, default=None,
                   help="per-connection credit window "
                        "(DOS_GATEWAY_CREDIT)")
    p.add_argument("--registry-dir", default=None,
                   help="leased endpoint registry directory holding "
                        "gateway.json (default: the conf's index "
                        "directory)")
    p.add_argument("--lease-s", type=float, default=None,
                   help="endpoint lease TTL seconds "
                        "(DOS_GATEWAY_LEASE_S)")
    p.add_argument("--join", action="store_true",
                   help="join an existing tier: claim fresh frontend "
                        "ids from the registry instead of starting at "
                        "f0 (replicas spanning processes)")
    p.add_argument("--queue-depth", type=int, default=None,
                   help="per-shard queue bound (DOS_SERVE_QUEUE_DEPTH)")
    p.add_argument("--max-batch", type=int, default=None,
                   help="micro-batch flush size (DOS_SERVE_MAX_BATCH)")
    p.add_argument("--max-wait-ms", type=float, default=None,
                   help="micro-batch wait bound (DOS_SERVE_MAX_WAIT_MS)")
    p.add_argument("--cache-bytes", type=int, default=None,
                   help="per-replica L1 result-cache budget, 0 disables "
                        "(DOS_SERVE_CACHE_BYTES)")
    p.add_argument("--deadline-ms", type=float, default=None,
                   help="per-request deadline (DOS_SERVE_DEADLINE_MS)")
    p.add_argument("--traffic-dir", default=None,
                   help="diff segment stream directory (live epoch "
                        "swaps; scoped L1 invalidation per replica)")
    p.add_argument("--traffic-spool", default=None,
                   help="fused per-epoch diff spool (shared with "
                        "workers for --backend host)")
    p.add_argument("--metrics-dump", default="",
                   help="write a JSON metrics snapshot here on shutdown")
    p.add_argument("--obs-port", type=int, default=None,
                   help="serve /metrics /healthz /statusz on this port "
                        "(0 = ephemeral; default off; DOS_OBS_PORT)")
    p.add_argument("--recorder-dir", default=None,
                   help="flight-recorder tape directory "
                        "(DOS_RECORDER_DIR; default off)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    set_verbosity(args.verbose)
    if args.test:
        import os

        from ..data.synth import ensure_synth_dataset
        from ..utils.config import test_config

        conf = test_config()
        ensure_synth_dataset(os.path.dirname(conf.xy_file) or "./data")
    else:
        from ..utils.config import ClusterConfig

        conf = ClusterConfig.load(args.c)
    gconf = GatewayConfig.from_env(
        replicas=args.replicas, socket_dir=args.socket_dir,
        credit=args.credit, lease_s=args.lease_s)
    # the leased endpoint registry lives beside membership.json unless
    # pointed elsewhere; every replica leases its socket there so
    # clients discover/fail over and the control loop sees death
    from ..gateway import GatewayRegistry
    reg_dir = args.registry_dir or getattr(conf, "outdir", None)
    endpoint_registry = (GatewayRegistry(reg_dir, lease_s=gconf.lease_s)
                         if reg_dir else None)
    fid_base = 0
    if args.join:
        if endpoint_registry is None:
            log.error("--join needs a registry directory (the conf has "
                      "no index dir; pass --registry-dir)")
            return 2
        fid_base = endpoint_registry.claim(gconf.replicas,
                                           endpoint_of=gconf.socket_of)
    # each replica is a full serving stack from the SAME constructor
    # dos-serve uses — admission, micro-batcher, hedging, breakers,
    # membership refresh, live-traffic epoch pump — so gateway replicas
    # and the single-head line-protocol serve stay behaviorally
    # identical per request
    from . import serve as serve_cli
    replicas = []
    registries = []
    for i in range(gconf.replicas):
        frontend, registry, families = serve_cli.build_frontend(
            conf, args)
        frontend.start()
        replicas.append((frontend, families))
        if registry is not None:
            registries.append(registry)
        log.info("frontend replica %d up (%s backend)", fid_base + i,
                 args.backend)
    tier = GatewayTier(replicas, gconf=gconf,
                       registry=endpoint_registry, fid_base=fid_base)
    stop_evt = threading.Event()

    def _on_signal(signum, frame):
        if not stop_evt.is_set():
            log.info("received %s; draining the tier",
                     signal.Signals(signum).name)
        stop_evt.set()

    for s in (signal.SIGTERM, signal.SIGINT):
        signal.signal(s, _on_signal)
    obs_srv = recorder = None
    try:
        from ..obs import recorder as obs_recorder
        from ..obs.http import start_obs_server
        from ..utils.env import env_str

        rec_dir = args.recorder_dir or env_str("DOS_RECORDER_DIR")
        if rec_dir:
            recorder = obs_recorder.FlightRecorder(rec_dir)
            obs_recorder.set_recorder(recorder)
        tier.start()
        for ep in tier.endpoints:
            log.info("gateway listening at %s", ep)
        status_providers = {"gateway": tier.statusz}
        for fid, (fe, _fam) in enumerate(replicas):
            status_providers[f"serving_f{fid}"] = fe.statusz
        obs_srv = start_obs_server(
            args.obs_port,
            health_fn=lambda: {"ok": not stop_evt.is_set(),
                               "role": "dos-gateway",
                               "replicas": gconf.replicas},
            status_providers=status_providers)
        while not stop_evt.wait(0.5):
            pass
    except KeyboardInterrupt:
        log.info("interrupted; draining the tier")
    finally:
        stop_evt.set()
        tier.stop()
        for fe, _fam in replicas:
            fe.stop()
        if obs_srv is not None:
            obs_srv.close()
        if recorder is not None:
            from ..obs import recorder as obs_recorder
            obs_recorder.set_recorder(None)
            recorder.close()
        for registry in registries:
            registry.shutdown()
        if args.metrics_dump:
            atomic_write_json(args.metrics_dump, serve_cli.metrics_snapshot(
                replicas[0][0].dispatcher if replicas else None))
        log.info("gateway tier drained and stopped cleanly")
    return 0


if __name__ == "__main__":
    sys.exit(main())
