"""CPD precompute launcher: the port's ``make_cpds.py``.

Role parity with reference P2 (SURVEY.md §2.1) and the JAX package's
``cli/make_cpds.py``: read the cluster conf, build every worker's CPD
rows, save the index to the conf's ``outdir`` with its manifest.

* ``partmethod: "tpu"`` (or ``--backend tpu``): the build runs
  in-process — one :class:`~..models.cpd.CPDOracle` builds the whole
  ``[W, R, N]`` table on one device (``--device``, default ``cuda``) and
  saves it.
* host partmethods (``div``/``mod``/``alloc``, or ``--backend host``):
  one ``worker.build`` process per worker — ssh + detached tmux for
  remote hosts (the reference's mechanism, ``make_cpds.py:21``), tracked
  local subprocesses for localhost, each building on ``--device``. Local
  builds are awaited and the index manifest is written when every shard
  is present (the reference has no completion signal). With
  ``--metrics-dump PATH`` each build writes its seconds, kernel launches
  and peak device memory to ``PATH.w<wid>.json``.

``-t`` builds the canned smoke config (``utils.config.test_config`` with
8 workers, the shape of the checked-in ``data/index``: one card holds
every worker), generating the synthetic dataset under ``./data`` if it
is absent; ``-w N`` restricts a host build to one worker.

Not ported, and refused with the ``ROADMAP.md`` item that ports each:
``--verify`` and ``--scrub`` (A4), ``--delta-from`` (A10), and on the
host backend ``--engine native`` (A15), ``--no-resume`` and replication
above 1 (A4-rest).

    python -m distributed_oracle_search_tpu_torch.cli.make_cpds -c conf.json
"""

from __future__ import annotations

import os
import sys

from .args import parse_args
from ..transport.launch import launch, session_name, worker_logfile
from ..utils.atomicio import sweep_stale_artifacts
from ..utils.config import ClusterConfig, mesh_layout, test_config
from ..utils.log import get_logger, set_verbosity

log = get_logger(__name__)


def run_tpu(conf: ClusterConfig, args) -> None:
    """In-process build of every worker's rows on one device."""
    from ..data.graph import Graph
    from ..models.cpd import CPDOracle
    from ..parallel.partition import DistributionController

    # debris of killed builds goes before the new blocks are written
    sweep_stale_artifacts(conf.outdir)
    mesh_layout(conf)
    graph = Graph.from_xy(conf.xy_file)
    dc = DistributionController(conf.partmethod, conf.partkey,
                                conf.maxworker, graph.n)
    oracle = CPDOracle(graph, dc, device=args.device)
    oracle.build(chunk=args.chunk)
    oracle.save(conf.outdir, codec=args.codec)
    print(f"built the CPD for {graph.n} nodes over {conf.maxworker} "
          f"workers on {oracle.device} -> {conf.outdir}")


def worker_build_cmd(wid: int, conf: ClusterConfig, chunk: int = 0,
                     codec: str | None = None, device: str = "cuda",
                     metrics_dump: str = "") -> str:
    """The shell command a host-mode worker runs (our ``make_cpd_auto``):
    the port's ``worker.build`` on ``device``, with its metrics dump at
    ``<metrics_dump>.w<wid>.json`` when ``metrics_dump`` is set."""
    partkey = (" ".join(str(b) for b in conf.partkey)
               if isinstance(conf.partkey, (list, tuple))
               else str(conf.partkey))
    cmd = (f"{sys.executable} -m "
           "distributed_oracle_search_tpu_torch.worker.build"
           f" --input {conf.xy_file} --partmethod {conf.partmethod}"
           f" --partkey {partkey} --workerid {wid}"
           f" --maxworker {conf.maxworker} --outdir {conf.outdir}")
    if chunk:
        cmd += f" --chunk {chunk}"
    if codec:
        cmd += f" --codec {codec}"
    if metrics_dump:
        cmd += f" --metrics-dump {metrics_dump}.w{wid}.json"
    return cmd + f" --device {device}"


def call_worker(wid: int, conf: ClusterConfig, chunk: int = 0,
                codec: str | None = None, device: str = "cuda",
                metrics_dump: str = ""):
    """Launch one worker's build (parity: reference ``make_cpds.py:10-25``).

    Returns a Popen handle when the build runs as a tracked local
    subprocess, else None (tmux/ssh detached)."""
    host = conf.workers[wid]
    cmd = worker_build_cmd(wid, conf, chunk, codec=codec, device=device,
                           metrics_dump=metrics_dump)
    log.info("launch build w%d on %s: %s", wid, host, cmd)
    session = session_name("worker", wid)
    # prefer_track: builds are finite jobs — await local ones so the index
    # manifest can be finalized when they all complete; each logs beside
    # the query files
    return launch(host, session, cmd, projectdir=conf.projectdir,
                  logfile=worker_logfile(conf, session),
                  prefer_track=True)


def run_host(conf: ClusterConfig, args) -> None:
    """One ``worker.build`` process per worker; the manifest once every
    local build has exited 0."""
    if args.engine != "python":
        raise SystemExit("--engine native is not ported (ROADMAP.md A15)")
    if args.no_resume:
        raise SystemExit("--no-resume is not ported (ROADMAP.md A4-rest)")
    if conf.effective_replication() > 1:
        raise SystemExit("replicated host builds (replication > 1) are not "
                         "ported (ROADMAP.md A4-rest)")
    from ..data.formats import xy_node_count
    from ..models.cpd import write_index_manifest
    from ..parallel.partition import DistributionController

    # sweep BEFORE any worker launches: once builds are running, their
    # own in-flight *.tmp files must not be swept out from under them
    sweep_stale_artifacts(conf.outdir)
    procs = []
    for wid in range(conf.maxworker):
        if args.worker != -1 and wid != args.worker:
            continue
        proc = call_worker(wid, conf, chunk=args.chunk, codec=args.codec,
                           device=args.device,
                           metrics_dump=args.metrics_dump)
        if proc is not None:
            procs.append((wid, proc))
    failures = 0
    for wid, proc in procs:
        if proc.wait() != 0:
            log.error("worker %d build failed (rc=%d)", wid, proc.returncode)
            failures += 1
    if procs and not failures and args.worker == -1:
        dc = DistributionController(conf.partmethod, conf.partkey,
                                    conf.maxworker,
                                    xy_node_count(conf.xy_file))
        write_index_manifest(conf.outdir, dc)
        print(f"index complete -> {conf.outdir}")
    if failures:
        raise SystemExit(f"{failures} worker build(s) failed")


def main(argv=None) -> int:
    args = parse_args(argv, prog="make_cpds")
    set_verbosity(args.verbose)
    if args.test:
        from ..data.synth import ensure_synth_dataset

        conf = test_config(n_workers=8)
        ensure_synth_dataset(os.path.dirname(conf.xy_file) or "./data")
    else:
        conf = ClusterConfig.load(args.c)
    if args.scrub or args.verify:
        raise SystemExit("--verify/--scrub (verify_index) is not ported "
                         "(ROADMAP.md A4)")
    if args.delta_from:
        raise SystemExit("--delta-from (delta rebuilds) is not ported "
                         "(ROADMAP.md A10)")
    if args.backend == "tpu" or (args.backend == "auto" and conf.is_tpu):
        run_tpu(conf, args)
    else:
        run_host(conf, args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
