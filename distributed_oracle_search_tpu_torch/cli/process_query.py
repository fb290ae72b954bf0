"""Query campaign CLI: the port's ``process_query.py``.

Role parity with reference P4 (SURVEY.md §2.1, call stack §3.3) and the
JAX package's ``cli/process_query.py``: read the scenario, route queries
by the worker owning each **target** node, run one round per congestion
diff, collect per-worker stats rows, and write the campaign artifacts.

The in-process backend (``partmethod: "tpu"`` or ``--backend tpu``) is
the one ported: a :class:`~..models.cpd.CPDOracle` holds every worker's
rows on one device (``--device``, default ``cuda``) and each diff round
is ONE walk over all workers (``CPDOracle.query``; on the card the CUDA
walk kernel). Per-worker stats rows are recovered from the routed
results, so ``parts.csv`` has the JAX CLI's columns. Rounds run one per
diff; the JAX CLI's fused multi-diff walk (``query_multi``, ROADMAP.md
A9) gives bit-identical answers.

Artifacts (``-o DIR``): ``metrics.json`` (phase timings), ``data.json``
(full arg dump), ``parts.csv`` (per-worker rows) and, with ``--extract
-k K``, ``paths.csv`` — reference ``process_query.py:230-239``, with its
multi-worker CSV crash fixed.

Not ported, and refused with the ``ROADMAP.md`` item that ports each:
the host backend (FIFO and RPC, A6), ``--alg astar`` (A12), ``--alg ch``
(native engine, host backend only), the streamed memory plan (A11),
multi-host confs (A13), and ``--trace``/``--metrics-dump``/
``--profile``/``--obs-port`` with ``obs_metrics.json`` (A14).

    python -m distributed_oracle_search_tpu_torch.cli.process_query \\
        -c conf.json -o out/
"""

from __future__ import annotations

import csv
import os
import sys

import numpy as np

from .args import parse_args
from ..data.formats import read_diff, read_scen, xy_node_count
from ..parallel.partition import DistributionController
from ..transport.wire import STATS_HEADER, StatsRow
from ..utils.atomicio import (
    atomic_write_json, atomic_writer, sweep_stale_artifacts,
)
from ..utils.config import ClusterConfig, mesh_layout, test_config
from ..utils.env import env_cast, env_flag
from ..utils.log import get_logger, set_verbosity
from ..utils.timer import Timer

log = get_logger(__name__)

#: campaign exit codes — distinct so operators and CI can tell a fully
#: clean run from a degraded one and from a total failure. 1 and 2 are
#: left to Python tracebacks and argparse respectively.
EXIT_CLEAN = 0
EXIT_DEGRADED = 3
EXIT_FAILED = 4


def effective_partition(conf: ClusterConfig, args):
    """CLI ``--div/--mod/--alloc`` override the conf's partmethod (the
    reference's modus group, ``args.py:175-183``)."""
    if args.div is not None:
        return "div", args.div
    if args.mod is not None:
        return "mod", args.mod
    if args.alloc is not None:
        return "alloc", list(args.alloc)
    return conf.partmethod, conf.partkey


def run_tpu(conf: ClusterConfig, args, queries, dc, diffs):
    """All diff rounds in-process on one device; per-worker rows
    recovered from the routed results.

    Per-worker timing semantics: one walk answers the whole round, so a
    per-worker wall clock does not exist. Each row's ``t_astar``/
    ``t_search`` (and ``t_receive``/``t_prepare``) carry the worker's
    SHARE of the round interval, apportioned by walked moves (by batch
    size when no moves) — rows of a round sum to the measured round
    time."""
    from ..data.graph import Graph
    from ..models.cpd import CPDOracle

    if args.alg == "astar":
        raise SystemExit("--alg astar is not ported (ROADMAP.md A12)")
    if args.alg == "ch":
        raise SystemExit(
            "--alg ch is served by the native engine only, on the host "
            "backend (ROADMAP.md A6)")
    graph = Graph.from_xy(conf.xy_file)
    # debris of killed atomic writes goes before the build-if-missing
    # path below can trip on it
    sweep_stale_artifacts(conf.outdir)
    # memory plan: the resident oracle when a worker's fm shard fits the
    # per-device budget, as the JAX CLI decides it
    fm_gb = env_cast("DOS_FM_BUDGET_GB", 8.0, float)
    est_shard = dc.max_owned * graph.n            # int8 fm bytes
    if env_flag("DOS_SERVE_STREAMED", False) or est_shard > fm_gb * 1e9:
        raise SystemExit(
            f"per-worker fm shard {est_shard / 1e9:.2f} GB vs budget "
            f"{fm_gb:.1f} GB (DOS_FM_BUDGET_GB), or DOS_SERVE_STREAMED "
            "set: the streamed memory plan is not ported (ROADMAP.md A11)")
    oracle = CPDOracle(graph, dc, device=args.device)
    try:
        oracle.load(conf.outdir)
    except FileNotFoundError:
        log.info("no index at %s; building in-process", conf.outdir)
        oracle.build(chunk=args.chunk)
        oracle.save(conf.outdir)

    owner = dc.worker_of(queries[:, 1])
    stats = []
    paths = None
    for diff in diffs:
        active = (np.ones(len(queries), bool) if args.worker == -1
                  else owner == args.worker)
        with Timer() as prep:
            w_query = (None if diff == "-"
                       else graph.weights_with_diff(read_diff(diff)))
        with Timer() as search:
            cost, plen, fin = oracle.query(
                queries, w_query=w_query, k_moves=args.k_moves,
                active_worker=args.worker)
        total_moves = int(plen[active].sum())
        total_size = int(active.sum())
        rows = []
        for wid in range(dc.maxworker):
            if args.worker != -1 and wid != args.worker:
                continue
            mask = owner == wid
            size = int(mask.sum())
            if size == 0:
                continue
            moves = int(plen[mask].sum())
            share = (moves / total_moves if total_moves
                     else size / max(total_size, 1))
            row = StatsRow(
                n_expanded=moves,
                n_touched=size,
                plen=moves,
                finished=int(fin[mask].sum()),
                t_receive=prep.interval * share,
                t_astar=search.interval * share,
                t_search=search.interval * share,
            )
            rows.append(row.as_list(t_prepare=prep.interval * share,
                                    t_partition=0.0, size=size))
        stats.append(rows)
    if args.extract and args.k_moves > 0:
        # moves always follow the FREE-FLOW first-move table (reference
        # semantics), so path prefixes are diff-invariant: extract once
        nodes, moves = oracle.query_paths(queries, k=args.k_moves,
                                          active_worker=args.worker)
        paths = np.concatenate([queries, moves[:, None], nodes], axis=1)
    return stats, paths


def run(conf: ClusterConfig, args):
    """The campaign: returns ``(data, stats, paths)`` with the
    reference's shapes (reference ``process_query.py:132-194``)."""
    if args.order:
        # reordering relabels node ids everywhere (graph, index, scen,
        # diffs); the supported flow reorders the dataset once, up front
        raise SystemExit(
            "--order is applied at dataset-preparation time, not per "
            "campaign: reorder the dataset once and point the conf at the "
            "reordered files")
    if conf.multihost:
        raise SystemExit("multi-host campaigns are not ported "
                         "(ROADMAP.md A13)")
    scen = conf.scenfile or args.scenario
    with Timer() as t_read:
        queries = read_scen(scen)
    log.info("read %d queries from %s", len(queries), scen)

    with Timer() as t_workload:
        partmethod, partkey = effective_partition(conf, args)
        nodenum = xy_node_count(conf.xy_file)
        if not (args.backend == "tpu" or (args.backend == "auto"
                                          and partmethod == "tpu")):
            raise SystemExit(
                f"the host backend (partmethod {partmethod!r}: FIFO/RPC "
                "workers) is not ported (ROADMAP.md A6); use partmethod "
                "'tpu' or --backend tpu for the in-process campaign")
        mesh_layout(conf)
        # replication is a host-wire concept: the in-process campaign
        # routes every query to its primary owner
        if conf.effective_replication() > 1:
            log.info("replication=%d ignored on the in-process campaign "
                     "(queries route to primary owners only)",
                     conf.effective_replication())
        dc = DistributionController(partmethod, partkey, conf.maxworker,
                                    nodenum)
    diffs = list(conf.diffs) if conf.diffs else list(args.diffs)
    with Timer() as t_process:
        stats, paths = run_tpu(conf, args, queries, dc, diffs)

    data = {
        "num_queries": int(len(queries)),
        "num_partitions": conf.maxworker,
        "t_read": t_read.interval,
        "t_workload": t_workload.interval,
        "t_process": t_process.interval,
        "failed_batches": [],     # in-process rounds have no wire
    }
    return data, stats, paths


def campaign_exit_code(data, stats) -> int:
    """Clean / degraded / failed from the collected failure records."""
    failures = data.get("failed_batches", [])
    if not failures:
        return EXIT_CLEAN
    total = sum(len(expe) for expe in stats)
    return EXIT_FAILED if len(failures) >= total else EXIT_DEGRADED


def output(data, stats, args, paths=None) -> None:
    """Print, or write the artifacts (reference
    ``process_query.py:196-239`` with the CSV bug fixed), plus
    ``paths.csv`` when ``--extract`` collected prefixes: one row per
    query, ``s, t, moves, n0..nk`` (free-flow, diff-invariant)."""
    if args.output is None:
        print(data)
        print(STATS_HEADER)
        for i, expe in enumerate(stats):
            for row in expe:
                print(i, row)
        if paths is not None:
            k = paths.shape[1] - 4
            print(["s", "t", "moves"] + [f"n{j}" for j in range(k + 1)])
            for row in paths[:10]:
                print(list(row))
            if len(paths) > 10:
                print(f"... {len(paths)} path rows (use -o DIR for all)")
        return
    dirname = args.output
    os.makedirs(dirname, exist_ok=True)
    atomic_write_json(os.path.join(dirname, "metrics.json"), data)
    atomic_write_json(os.path.join(dirname, "data.json"), vars(args))
    with atomic_writer(os.path.join(dirname, "parts.csv")) as f:
        writer = csv.writer(f, quoting=csv.QUOTE_MINIMAL)
        writer.writerow(STATS_HEADER)
        writer.writerows([i, *row] for i, expe in enumerate(stats)
                         for row in expe)
    if paths is not None:
        k = paths.shape[1] - 4
        with atomic_writer(os.path.join(dirname, "paths.csv")) as f:
            writer = csv.writer(f, quoting=csv.QUOTE_MINIMAL)
            writer.writerow(["s", "t", "moves"]
                            + [f"n{j}" for j in range(k + 1)])
            writer.writerows(paths.tolist())


def test(args):
    """Canned smoke campaign on the synthetic dataset (parity: reference
    ``process_query.py:241-256``): ``test_config`` with 8 workers, the
    shape of the checked-in ``data/index``."""
    from ..data.synth import ensure_synth_dataset

    conf = test_config(n_workers=8)
    ensure_synth_dataset(os.path.dirname(conf.xy_file) or "./data")
    data, stats, paths = run(conf, args)
    output(data, stats, args, paths)
    return data, stats


def main(argv=None) -> int:
    args = parse_args(argv, prog="process_query")
    set_verbosity(args.verbose)
    if args.debug:
        # deterministic repro mode (parity: reference offline.py:143-147)
        args.omp, args.verbose = 1, max(args.verbose, 2)
    for flag, value in (("--trace", args.trace),
                        ("--metrics-dump", args.metrics_dump),
                        ("--profile", args.profile),
                        ("--obs-port", args.obs_port is not None)):
        if value:
            raise SystemExit(f"{flag} (observability) is not ported "
                             "(ROADMAP.md A14)")
    if args.test:
        data, stats = test(args)
    else:
        conf = ClusterConfig.load(args.c)
        data, stats, paths = run(conf, args)
        output(data, stats, args, paths)
    return campaign_exit_code(data, stats)


if __name__ == "__main__":
    sys.exit(main())
