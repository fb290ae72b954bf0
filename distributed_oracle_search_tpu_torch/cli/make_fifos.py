"""Resident query-server launcher: the port's ``make_fifos.py``.

Role parity with reference P3 (SURVEY.md §2.1) and the JAX package's
``cli/make_fifos.py``: for each worker, start a resident query server
(``worker.server``) that loads the graph, the first diff and its CPD
shard onto ``--device`` (default ``cuda``), then blocks on its command
FIFO ``/tmp/worker<wid>.fifo``. ``--alg`` passes through to every
server: ``table-search`` (the default, as in the reference, hard-coded
there at ``make_fifos.py:20``) or ``astar``, the hscale/fscale
weighted-A* family, whose servers load no CPD shard.

* host partmethods: one ``worker.server`` process per worker — ssh +
  detached tmux for remote hosts (reference ``make_fifos.py:22``),
  detached tmux or a tracked local subprocess for localhost. Session
  name ``fifo-<wid>``. The launcher returns at once; a server is ready
  when it answers a ping (``transport.fifo.probe``).
* ``partmethod=tpu``: servers are unnecessary — the campaign answers
  in-process; this launcher says so and exits 0 (``--backend host``
  forces FIFO servers anyway).

Stop a server with ``echo __DOS_STOP__ > /tmp/worker<wid>.fifo``
(``worker.server.stop_server``). ``--metrics-dump PATH`` has each server
write its counters, walk launches, device and peak device memory to
``PATH.w<wid>.json`` when it stops.

Not ported, and refused with the ``ROADMAP.md`` item that ports each:
``--supervise`` (A15, ``worker/supervisor.py``), ``--engine native`` and
``--alg ch`` (A15).

    python -m distributed_oracle_search_tpu_torch.cli.make_fifos -c conf.json
"""

from __future__ import annotations

import subprocess
import sys

from .args import parse_args
from ..transport.fifo import command_fifo_path
from ..transport.launch import launch, session_name, worker_logfile
from ..utils.config import ClusterConfig, test_config
from ..utils.log import get_logger, set_verbosity

log = get_logger(__name__)


def worker_server_cmd(wid: int, conf_path: str, verbose: int = 0,
                      device: str = "cuda", metrics_dump: str = "",
                      alg: str = "table-search") -> str:
    """The shell command of worker ``wid``'s resident server: the port's
    ``worker.server`` serving ``alg`` on ``device``, on the command FIFO
    :func:`~..transport.fifo.command_fifo_path` names (passed
    explicitly, so head and server agree on it), with its metrics dump
    at ``<metrics_dump>.w<wid>.json`` when ``metrics_dump`` is set."""
    cmd = (f"{sys.executable} -m "
           "distributed_oracle_search_tpu_torch.worker.server"
           f" -c {conf_path} --workerid {wid} --alg {alg}"
           f" --fifo {command_fifo_path(wid)} --device {device}")
    if metrics_dump:
        cmd += f" --metrics-dump {metrics_dump}.w{wid}.json"
    if verbose:
        cmd += " -" + "v" * verbose
    return cmd


def call_worker(wid: int, conf: ClusterConfig, conf_path: str,
                verbose: int = 0, device: str = "cuda",
                metrics_dump: str = "", track: bool = False,
                alg: str = "table-search"):
    """Launch worker ``wid``'s server. Returns its Popen handle when it
    runs as a tracked local subprocess (``track``, or no tmux), else
    None (tmux/ssh detached)."""
    host = conf.workers[wid]
    cmd = worker_server_cmd(wid, conf_path, verbose, device=device,
                            metrics_dump=metrics_dump, alg=alg)
    log.info("launch server w%d on %s: %s", wid, host, cmd)
    session = session_name("fifo", wid)
    # a tracked local server (no tmux) logs beside the query files
    return launch(host, session, cmd, projectdir=conf.projectdir,
                  logfile=worker_logfile(conf, session), prefer_track=track)


def launch_servers(conf: ClusterConfig, conf_path: str, worker: int = -1,
                   verbose: int = 0, device: str = "cuda",
                   metrics_dump: str = "", track: bool = False,
                   alg: str = "table-search"
                   ) -> list[tuple[int, subprocess.Popen]]:
    """Start the resident server of every worker (or only ``worker``);
    returns ``[(wid, Popen)]`` for the tracked local ones. ``track=True``
    runs local servers as tracked subprocesses even where tmux exists,
    for a caller that stops them itself and needs their exit codes."""
    procs = []
    for wid in range(conf.maxworker):
        if worker != -1 and wid != worker:
            continue
        proc = call_worker(wid, conf, conf_path, verbose, device=device,
                           metrics_dump=metrics_dump, track=track, alg=alg)
        if proc is not None:
            procs.append((wid, proc))
    return procs


def main(argv=None) -> int:
    args = parse_args(argv, prog="make_fifos")
    set_verbosity(args.verbose)
    if args.test:
        conf, conf_path = test_config(), None
    else:
        conf, conf_path = ClusterConfig.load(args.c), args.c
    if args.backend != "host" and conf.is_tpu:
        print("partmethod=tpu: queries run in-process on the device; "
              "no resident servers needed. (Use --backend host to force "
              "FIFO servers.)")
        return 0
    if conf_path is None:
        raise SystemExit("host-mode servers need a conf file (-c), "
                         "not -t test mode")
    if args.supervise:
        raise SystemExit("--supervise is not ported (ROADMAP.md A15)")
    if args.engine != "python":
        raise SystemExit("--engine native is not ported (ROADMAP.md A15)")
    if args.alg == "ch":
        raise SystemExit("--alg ch is served by the native engine, which "
                         "is not ported (ROADMAP.md A15)")
    # servers are resident: tracked local subprocesses are NOT awaited
    launch_servers(conf, conf_path, args.worker, args.verbose,
                   device=args.device, metrics_dump=args.metrics_dump,
                   alg=args.alg)
    print(f"launched {conf.maxworker if args.worker == -1 else 1} "
          f"query server(s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
