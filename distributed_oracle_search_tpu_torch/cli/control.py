"""``dos-control``: run the closed-loop policy daemon standalone.

The daemon is normally *embedded* — ``dos-serve`` wires it to the
in-process frontend/breakers and ``dos-make-fifos --supervise`` to the
worker supervisor, where every actuator is live. Standalone mode
attaches from outside a running fleet with the handles that cross
process boundaries:

* **sense** — worker telemetry sidecars polled from the FIFO
  directory, SLO burn rates over the merged store, liveness probes on
  the FIFO wire;
* **act** — elastic membership moves (``plan_leave`` of a permanently
  dead worker operates on the shared ``membership.json``), scale
  advisories, and the full decision journal. In-process actuators
  (breaker pins, hedge/deadline brownout, respawn kicks) have no
  remote surface; a decision needing one is booked as an actuator
  error — visible, counted, and a reason to run embedded instead.

``--dry-run`` (or ``DOS_CONTROL_DRY_RUN=1``) books every decision
without executing anything. The daemon runs regardless of
``DOS_CONTROL`` here — invoking this CLI *is* the opt-in.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

from ..utils.config import ClusterConfig, test_config
from ..utils.log import get_logger, set_verbosity

log = get_logger(__name__)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dos-control",
        description="closed-loop reconfiguration daemon (standalone)")
    p.add_argument("-c", default="cluster.conf",
                   help="cluster config (default cluster.conf)")
    p.add_argument("--test", action="store_true",
                   help="use the canned test config + synth dataset")
    p.add_argument("--fifo-dir", default=None,
                   help="worker FIFO/telemetry directory (default: "
                        "derived from the worker-0 command FIFO path)")
    p.add_argument("--interval", type=float, default=None,
                   help="tick cadence override (DOS_CONTROL_INTERVAL_S)")
    p.add_argument("--dry-run", action="store_true",
                   help="book decisions without executing")
    p.add_argument("--obs-port", type=int, default=None,
                   help="serve /metrics /statusz for the daemon itself")
    p.add_argument("--once", action="store_true",
                   help="run a single tick and exit (cron-style)")
    p.add_argument("-v", "--verbose", action="count", default=0)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    set_verbosity(args.verbose)
    conf = test_config() if args.test else ClusterConfig.load(args.c)

    from ..control import ControlConfig, ControlDaemon
    from ..obs import slo as obs_slo
    from ..obs import telemetry as obs_telemetry
    from ..obs import timeseries as obs_timeseries
    from ..obs.http import start_obs_server
    from ..parallel import membership as fleet
    from ..transport import fifo as fifo_transport
    from ..transport.fifo import command_fifo_path

    cfg = ControlConfig.from_env()
    cfg = dataclasses.replace(
        cfg, enabled=True,
        dry_run=cfg.dry_run or args.dry_run,
        interval_s=(args.interval if args.interval is not None
                    else cfg.interval_s))
    cfg.validate()

    fifo_dir = (args.fifo_dir
                or os.path.dirname(command_fifo_path(0)) or ".")
    store = obs_timeseries.TimeseriesStore()
    ingest = obs_telemetry.TelemetryIngest(store)
    poller = obs_telemetry.SidecarPoller(fifo_dir, ingest).start()
    slo_engine = obs_slo.SLOEngine(store)
    from ..data.formats import xy_node_count
    from ..parallel.partition import DistributionController

    dc = DistributionController(conf.partmethod, conf.partkey,
                                conf.maxworker,
                                xy_node_count(conf.xy_file),
                                replication=conf
                                .effective_replication())
    mstate = fleet.load_state(conf.outdir)
    if mstate is not None:
        dc = fleet.apply_state(dc, mstate)
    mc = fleet.MembershipController(conf, dc)

    def probe_fn(wid: int) -> bool:
        try:
            host = mc.host_of(wid)
        except Exception as e:  # noqa: BLE001
            log.debug("probe: no roster host for w%d: %s", wid, e)
            return False
        st = fifo_transport.probe(host, wid,
                                  command_fifo=command_fifo_path(wid),
                                  nfs=conf.nfs)
        return st is not None and getattr(st, "ok", False)

    daemon = ControlDaemon(cfg, slo=slo_engine, membership=mc,
                           ingest=ingest, probe_fn=probe_fn)
    obs_srv = None
    try:
        if args.obs_port is not None:
            obs_srv = start_obs_server(
                args.obs_port,
                health_fn=lambda: {"ok": True, "role": "dos-control"},
                status_providers={"control": daemon.statusz})
        if args.once:
            daemon.tick()
            print(daemon.last_action or "no action")
            return 0
        daemon.start()
        print(f"dos-control up: interval={cfg.interval_s:.1f}s "
              f"dry_run={cfg.dry_run} fifo_dir={fifo_dir}; "
              "Ctrl-C to stop")
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        log.info("dos-control: interrupted")
    finally:
        daemon.stop()
        poller.stop()
        if obs_srv is not None:
            obs_srv.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
