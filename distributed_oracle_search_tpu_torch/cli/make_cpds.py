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

``--verify`` runs a check-only integrity pass over the conf's index
instead of building: one JSON report line, exit 0/3/4 (clean / degraded /
corrupt). ``--scrub`` repeats that pass ``--scrub-passes`` times,
``--scrub-interval`` seconds apart, and exits with the worst code seen.
On the host backend ``--no-resume`` rebuilds every block, and a conf with
``replication`` R > 1 (or ``DOS_REPLICATION``) builds each worker's
hosted replica sets too, then writes the replicated manifest and runs one
anti-entropy pass over it.

``--delta-from OLD --diff FUSED [--delta-epoch N]`` runs a delta
rebuild on ``--device`` instead of building
(``models.cpd.delta_build_index``): the epoch index lands under
``OLD/epoch-e<N>``, byte-equal to a build from scratch on the retimed
graph; one JSON report line, exit 0, or 4 when ``OLD`` has no readable
manifest.

On the host backend ``--engine native`` runs the repo's C++ builder,
``make_cpd_auto`` (``native/``, built by ``make -C native fast`` or
``./install.sh``; found by ``utils.nativebin``), one process a worker on
the host's cores: its blocks are byte-equal to ``worker.build``'s. It
ignores ``--chunk``, ``--codec`` and ``--device``, and writes primaries
only (a replicated conf's replica sets are built here afterwards).

    python -m distributed_oracle_search_tpu_torch.cli.make_cpds -c conf.json
"""

from __future__ import annotations

import json
import os
import sys
import time

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
                     metrics_dump: str = "", resume: bool = True,
                     engine: str = "python") -> str:
    """The shell command a host-mode worker runs (our ``make_cpd_auto``):
    the port's ``worker.build`` on ``device``, with its metrics dump at
    ``<metrics_dump>.w<wid>.json`` when ``metrics_dump`` is set; with
    ``engine="native"`` the native ``make_cpd_auto`` binary."""
    partkey = (" ".join(str(b) for b in conf.partkey)
               if isinstance(conf.partkey, (list, tuple))
               else str(conf.partkey))
    if engine == "native":
        from ..utils.nativebin import require_binary
        if chunk:
            log.warning("--chunk is a device-builder staging knob; the "
                        "native builder works block-by-block and ignores "
                        "it")
        if codec:
            log.warning("--codec is a device-builder knob; the native "
                        "builder writes raw blocks and ignores it")
        return (f"{require_binary('make_cpd_auto')}"
                f" --input {conf.xy_file} --partmethod {conf.partmethod}"
                f" --partkey {partkey} --workerid {wid}"
                f" --maxworker {conf.maxworker} --outdir {conf.outdir}")
    cmd = (f"{sys.executable} -m "
           "distributed_oracle_search_tpu_torch.worker.build"
           f" --input {conf.xy_file} --partmethod {conf.partmethod}"
           f" --partkey {partkey} --workerid {wid}"
           f" --maxworker {conf.maxworker} --outdir {conf.outdir}")
    if chunk:
        cmd += f" --chunk {chunk}"
    if not resume:
        cmd += " --no-resume"
    if codec:
        cmd += f" --codec {codec}"
    repl = conf.effective_replication()
    if repl > 1:
        cmd += f" --replication {repl}"
    if metrics_dump:
        cmd += f" --metrics-dump {metrics_dump}.w{wid}.json"
    return cmd + f" --device {device}"


def call_worker(wid: int, conf: ClusterConfig, chunk: int = 0,
                codec: str | None = None, device: str = "cuda",
                metrics_dump: str = "", resume: bool = True,
                engine: str = "python"):
    """Launch one worker's build (parity: reference ``make_cpds.py:10-25``).

    Returns a Popen handle when the build runs as a tracked local
    subprocess, else None (tmux/ssh detached)."""
    host = conf.workers[wid]
    cmd = worker_build_cmd(wid, conf, chunk, codec=codec, device=device,
                           metrics_dump=metrics_dump, resume=resume,
                           engine=engine)
    log.info("launch build w%d on %s: %s", wid, host, cmd)
    session = session_name("worker", wid)
    # prefer_track: builds are finite jobs — await local ones so the index
    # manifest can be finalized when they all complete; each logs beside
    # the query files
    return launch(host, session, cmd, projectdir=conf.projectdir,
                  logfile=worker_logfile(conf, session),
                  prefer_track=True)


def run_verify(conf: ClusterConfig) -> int:
    """Check-only integrity pass: digest/shape-verify every manifest
    block (replicas included) in place, print one JSON report line,
    return 0/3/4 (clean / degraded / corrupt — ``process_query``'s
    convention)."""
    from ..data.formats import xy_node_count
    from ..models.cpd import read_manifest, verify_exit_code, verify_index
    from ..parallel.partition import DistributionController

    # verify against the manifest's own block_size and replication (a
    # worker.build --block-size or replicated index is still a valid
    # index); the partition quadruple is still cross-checked
    dc_kw = {}
    try:
        man = read_manifest(conf.outdir)
        bs = int(man.get("block_size", 0))
        if bs > 0:
            dc_kw["block_size"] = bs
        repl = int(man.get("replication", 1))
        if repl > 1:
            dc_kw["replication"] = repl
    except (OSError, ValueError):
        pass            # verify_index reports the unusable manifest
    try:
        dc = DistributionController(conf.partmethod, conf.partkey,
                                    conf.maxworker,
                                    xy_node_count(conf.xy_file), **dc_kw)
    except ValueError as e:
        # e.g. a manifest replication above this conf's maxworker: a
        # manifest/conf mismatch is exit 4, never a traceback
        log.error("verify fatal: %s", e)
        print(json.dumps({"index": conf.outdir, "exit_code": 4,
                          "fatal": str(e)}))
        return 4
    report = verify_index(conf.outdir, dc=dc)
    for fname in report["missing"]:
        log.error("missing block: %s", fname)
    for ent in report["corrupt"]:
        log.error("corrupt block: %s (%s)", ent["file"], ent["reason"])
    if report.get("fatal"):
        log.error("verify fatal: %s", report["fatal"])
    code = verify_exit_code(report)
    print(json.dumps({"index": conf.outdir, "exit_code": code,
                      **{k: report[k] for k in
                         ("total", "ok", "unverified", "missing",
                          "corrupt")},
                      **({"fatal": report["fatal"]}
                         if report.get("fatal") else {})}))
    return code


def run_scrub(conf: ClusterConfig, args) -> int:
    """``--scrub``: repeat the ``--verify`` pass ``--scrub-passes`` times
    (0: until interrupted), ``--scrub-interval`` seconds apart, and
    return the WORST code any pass gave (degradation seen once is
    degradation, even if a later pass no longer sees it)."""
    worst = passes = 0
    budget = max(0, int(args.scrub_passes))
    try:
        while True:
            worst = max(worst, run_verify(conf))
            passes += 1
            log.info("scrub pass %d done (worst exit so far: %d)",
                     passes, worst)
            if budget and passes >= budget:
                break
            time.sleep(max(0.0, float(args.scrub_interval)))
    except KeyboardInterrupt:
        log.info("scrub interrupted after %d pass(es)", passes)
    return worst


def run_delta(conf: ClusterConfig, args) -> int:
    """``--delta-from OLD_INDEX --diff FUSED``: old index + fused diff
    epoch → a new epoch index on ``--device``
    (``models.cpd.delta_build_index``), with the old manifest's
    ``block_size`` and ``replication``. Prints one JSON report line;
    returns 0, 2 without ``--diff``, 4 when the old index has no readable
    manifest."""
    from ..data.graph import Graph
    from ..models.cpd import delta_build_index, read_manifest
    from ..parallel.partition import DistributionController

    if not args.diff:
        log.error("--delta-from needs the fused diff file (--diff)")
        return 2
    dc_kw = {}
    try:
        man = read_manifest(args.delta_from)
        bs = int(man.get("block_size", 0))
        if bs > 0:
            dc_kw["block_size"] = bs
        repl = int(man.get("replication", 1))
        if repl > 1:
            dc_kw["replication"] = repl
    except (OSError, ValueError) as e:
        log.error("delta fatal: no readable manifest in %s: %s",
                  args.delta_from, e)
        print(json.dumps({"index": args.delta_from, "exit_code": 4,
                          "fatal": str(e)}))
        return 4
    graph = Graph.from_xy(conf.xy_file)
    dc = DistributionController(conf.partmethod, conf.partkey,
                                conf.maxworker, graph.n, **dc_kw)
    report = delta_build_index(
        graph, dc, args.delta_from, args.diff, epoch=args.delta_epoch,
        chunk=args.chunk, resume=not args.no_resume, device=args.device)
    print(json.dumps({"exit_code": 0, **report}))
    return 0


def run_host(conf: ClusterConfig, args) -> None:
    """One ``worker.build`` process per worker; the manifest once every
    local build has exited 0 (with R > 1: any replica set still missing
    built here, the replicated manifest, one anti-entropy pass)."""
    from ..data.formats import xy_node_count
    from ..data.graph import Graph
    from ..models.cpd import (
        anti_entropy, build_replica_shards, shard_block_name,
        write_index_manifest,
    )
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
                           metrics_dump=args.metrics_dump,
                           resume=not args.no_resume, engine=args.engine)
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
                                    xy_node_count(conf.xy_file),
                                    replication=conf.effective_replication())
        graph = None
        if dc.replication > 1:
            # backstop for replica sets a worker's build left missing on
            # disk (the native engine writes primaries only; an existence
            # scan only: the builds digest-checked
            # what they wrote, the anti-entropy pass below checks all)
            graph = Graph.from_xy(conf.xy_file)
            bs = dc.block_size
            for host in range(conf.maxworker):
                if any(not os.path.exists(os.path.join(
                        conf.outdir, shard_block_name(
                            shard, bid, dc.replica_rank(shard, host))))
                       for shard in dc.replica_shards(host)[1:]
                       for bid in range((dc.n_owned(shard) + bs - 1)
                                        // bs)):
                    build_replica_shards(graph, dc, host, conf.outdir,
                                         chunk=args.chunk,
                                         device=args.device)
        manifest = write_index_manifest(conf.outdir, dc)
        if dc.replication > 1:
            report = anti_entropy(conf.outdir, dc, graph=graph,
                                  manifest=manifest, device=args.device)
            print(f"anti-entropy: {report['checked']} replica block(s) "
                  f"cross-checked, {len(report['mismatched'])} divergent, "
                  f"{len(report['healed'])} healed")
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
    if args.scrub:
        return run_scrub(conf, args)
    if args.verify:
        return run_verify(conf)
    if args.delta_from:
        return run_delta(conf, args)
    if args.backend == "tpu" or (args.backend == "auto" and conf.is_tpu):
        run_tpu(conf, args)
    else:
        run_host(conf, args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
