"""Query campaign CLI: the port's ``process_query.py``.

Role parity with reference P4 (SURVEY.md §2.1, call stack §3.3) and the
JAX package's ``cli/process_query.py``: read the scenario, route queries
by the worker owning each **target** node, run one round per congestion
diff, collect per-worker stats rows, and write the campaign artifacts.
Two backends behind one stats schema:

* in-process (``partmethod: "tpu"`` or ``--backend tpu``): a
  :class:`~..models.cpd.CPDOracle` holds every worker's rows on one
  device (``--device``, default ``cuda``) and each diff round is ONE
  walk over all workers (``CPDOracle.query``; on the card the CUDA walk
  kernel). Per-worker stats rows are recovered from the routed results.
  When that table (``W * R * N`` bytes) would pass ``DOS_FM_BUDGET_GB``
  (default 8), or with ``DOS_SERVE_STREAMED=1``, the rounds are served
  streamed from the on-disk index instead
  (``models.streamed.StreamedCPDOracle``: one walk launch a row-chunk),
  with the same answers.
  ``--alg astar`` searches the graph with no index: the batched search
  on ``--device`` (``ops.batched_astar``; K6 on the card) by default,
  the per-query heap engine (``models.astar``) with
  ``DOS_ASTAR_DEVICE=0``. The JAX package routes the other way round,
  because its device search was the slower one; on the card K6 is the
  faster (``PERF.md``).
  With two or more diffs and no ``-k`` budget every round is answered by
  ONE fused walk (``CPDOracle.query_multi``; on the card the fused walk
  kernel), bit-identical to one round per diff; ``-k`` campaigns run one
  round per diff.
* host (``div``/``mod``/``alloc``, or ``--backend host``): the
  reference mechanism — query files to the conf's ``nfs`` dir, the
  2-line request through each worker's command FIFO, one CSV stats line
  back (``transport.fifo``), driven concurrently by a thread pool, with
  explicit failure rows and retries. The resident ``worker.server``
  processes (``make_fifos``) answer on their own devices. A failed batch
  is booked in ``degraded.json`` and sets the exit code.

Artifacts (``-o DIR``): ``metrics.json`` (phase timings), ``data.json``
(full arg dump), ``parts.csv`` (per-worker rows), ``degraded.json`` when
a batch failed and, with ``--extract -k K``, ``paths.csv`` — reference
``process_query.py:230-239``, with its multi-worker CSV crash fixed.

Multi-controller campaigns (a ``multihost`` key in the conf, the process
id from it or ``$DOS_PROCESS_ID``; ``parallel.multihost``, gloo): every
process runs the same campaign. On the resident plan process p holds and
walks its contiguous block of W/P workers; on the streamed plan it
streams the workers with ``wid % P == p``. The answers merge on every
process by an all-gather, and only process 0 writes the artifacts. A
missing index is built process-sharded into a directory every process
must share. The conf's ``mesh_shape`` lays the resident oracle over a
``[D, W]`` grid of the process's cards (``parallel.mesh``); on one card
every cell names it and a round stays one walk.

Not ported, and refused with the ``ROADMAP.md`` item that ports each:
``--alg ch`` (native engine, A15) in-process,
``--trace``/``--metrics-dump``/``--profile``/``--obs-port`` with
``obs_metrics.json`` (A14), and on the host backend the RPC lanes
(``DOS_TRANSPORT=rpc/auto``), breakers, membership re-reads and the
failover over replicas that replication above 1 needs (A14).

    python -m distributed_oracle_search_tpu_torch.cli.process_query \\
        -c conf.json -o out/
"""

from __future__ import annotations

import csv
import os
import sys
import time

import numpy as np

from .args import get_time_ns, parse_args
from ..data.formats import read_diff, read_scen, xy_node_count
from ..ops.batched_astar import astar_batch_np
from ..parallel.mesh import device_pool, mesh_from_config
from ..parallel.multihost import (
    barrier, gather_to_host, initialize_from_conf, is_primary, process_info,
)
from ..parallel.partition import DistributionController
from ..transport import fifo as fifo_transport
from ..transport.fifo import answer_fifo_path, command_fifo_path, fan_out
from ..transport.wire import (
    STATS_HEADER, Request, RuntimeConfig, StatsRow, paths_file_for,
    read_paths_file, write_query_file,
)
from ..utils.atomicio import (
    atomic_write_json, atomic_writer, sweep_stale_artifacts,
)
from ..utils.config import ClusterConfig, mesh_layout, test_config
from ..utils.env import env_cast, env_flag, env_str
from ..utils.log import get_logger, set_verbosity
from ..utils.timer import Timer

log = get_logger(__name__)

#: campaign exit codes — distinct so operators and CI can tell a fully
#: clean run from a degraded one and from a total failure. 1 and 2 are
#: left to Python tracebacks and argparse respectively.
EXIT_CLEAN = 0
EXIT_DEGRADED = 3
EXIT_FAILED = 4


def runtime_config(args) -> RuntimeConfig:
    """Per-batch engine knobs from CLI args (parity: reference
    ``process_query.py:149-160``)."""
    extract = bool(getattr(args, "extract", False))
    if extract and args.k_moves <= 0:
        raise SystemExit("--extract needs -k/--k-moves > 0")
    return RuntimeConfig(
        hscale=args.h_scale, fscale=args.f_scale, time=get_time_ns(args),
        itrs=args.itrs, k_moves=args.k_moves, threads=args.omp,
        verbose=args.verbose, debug=args.debug,
        thread_alloc=args.thread_alloc, no_cache=args.no_cache,
        extract=extract,
    )


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


def _astar_heap_campaign(graph, queries, w_query, hscale, fscale,
                         deadline):
    """Per-query heap A* over a batch (``models.astar``, taken with
    ``DOS_ASTAR_DEVICE=0``). The ns deadline truncates between queries;
    the first always runs."""
    from ..models.astar import AstarStats, astar, min_cost_per_unit

    w = graph.w if w_query is None else w_query
    cpu = min_cost_per_unit(graph, w)
    st = AstarStats()
    cost = np.zeros(len(queries), np.int64)
    plen = np.zeros(len(queries), np.int64)
    fin = np.zeros(len(queries), bool)
    for i, (s, t) in enumerate(queries):
        if i and deadline is not None and time.perf_counter() > deadline:
            break
        cost[i], plen[i], fin[i] = astar(
            graph, int(s), int(t), w, hscale=hscale, fscale=fscale,
            cpu=cpu, stats=st)
    return cost, plen, fin, dict(
        n_expanded=st.n_expanded, n_inserted=st.n_inserted,
        n_touched=st.n_touched, n_updated=st.n_updated,
        n_surplus=st.n_surplus)


class _StreamedServe:
    """Stand-in for ``CPDOracle`` in :func:`run_tpu` when the resident
    table would not fit the card: the campaign is served from the
    on-disk block files by :class:`~..models.streamed.StreamedCPDOracle`
    (chunks cached on the device, RLE/4-bit packed uploads), on
    ``device``, with the ``-w`` filter applied on the host.

    Multi-controller runs SHARD the streamed campaign: process p serves
    only the workers with ``wid % process_count == p`` — it streams only
    those workers' rows, and the disjoint partial results merge with one
    all-gather (int64 words travel as they are: gloo gathers int64). A
    missing index is built process-sharded: each process writes its own
    workers' block files, a barrier precedes process 0's manifest and
    another follows it. Whether the index is missing is decided by all
    the processes together (any one missing it builds), and a process
    that finds no manifest after the second barrier fails: the build
    needs an index directory every process shares. ``bytes_streamed``
    and ``row_chunks`` sum this process's uploads over its calls."""

    def __init__(self, graph, dc, outdir: str, chunk: int, device):
        from ..models.cpd import build_worker_shard, write_index_manifest
        from ..models.streamed import StreamedCPDOracle

        self.pidx, self.pcount = process_info()
        #: bool [W] — workers THIS controller serves (all of them on a
        #: single-controller run)
        self.my_workers = (np.arange(dc.maxworker) % self.pcount
                           == self.pidx)
        manifest = os.path.join(outdir, "index.json")
        missing = not os.path.exists(manifest)
        if self.pcount > 1:
            missing = bool(gather_to_host(np.array(missing)).any())
        if missing:
            log.info("no index at %s; building %s block files "
                     "in-process", outdir,
                     "this process's workers'" if self.pcount > 1
                     else "per-worker")
            for wid in np.flatnonzero(self.my_workers):
                build_worker_shard(graph, dc, int(wid), outdir, chunk=chunk,
                                   device=device)
            barrier("dos-streamed-build")
            if self.pidx == 0:
                write_index_manifest(outdir, dc)
            barrier("dos-streamed-manifest")
            if not os.path.exists(manifest):
                raise RuntimeError(
                    f"process {self.pidx}: no index manifest at {manifest} "
                    "after process 0 wrote it: a multi-controller build "
                    "needs an index directory every process shares")
        self.dc = dc
        row_chunk = env_cast("DOS_STREAM_ROW_CHUNK", 4096, int)
        self.st = StreamedCPDOracle(graph, dc, outdir, row_chunk=row_chunk,
                                    device=device)
        self.bytes_streamed = 0
        self.row_chunks = 0

    def _split(self, queries, active_worker):
        queries = np.asarray(queries)
        owner = self.dc.worker_of(queries[:, 1])
        active = self.my_workers[owner]
        if active_worker != -1:
            active = active & (owner == active_worker)
        return active, queries[active]

    def _tally(self):
        self.bytes_streamed += int(self.st.last_stats["bytes_streamed"])
        self.row_chunks += int(self.st.last_stats["row_chunks"])

    def _merge(self, *arrays):
        """Combine the processes' disjoint partial results (zeros/False
        outside each process's workers) into the whole campaign answer
        on every controller: one all-gather an array, summed (bools:
        any); a no-op on one controller."""
        if self.pcount == 1:
            return arrays
        out = []
        for a in arrays:
            g = gather_to_host(a)
            out.append(g.any(axis=0) if a.dtype == np.bool_
                       else g.sum(axis=0, dtype=a.dtype))
        return tuple(out)

    def query(self, queries, w_query=None, k_moves=-1, active_worker=-1,
              max_steps=0):
        active, part = self._split(queries, active_worker)
        got = self.st.query(part, w_query=w_query, k_moves=k_moves,
                            max_steps=max_steps)
        self._tally()
        out = [np.zeros(len(queries), np.int64),
               np.zeros(len(queries), np.int64),
               np.zeros(len(queries), bool)]
        for o, g in zip(out, got):
            o[active] = g
        return self._merge(*out)

    def query_multi(self, queries, w_diffs, active_worker=-1, max_steps=0):
        active, part = self._split(queries, active_worker)
        c, p, f = self.st.query_multi(part, w_diffs, max_steps=max_steps)
        self._tally()
        out_c = np.zeros((len(w_diffs), len(queries)), np.int64)
        out_p = np.zeros(len(queries), np.int64)
        out_f = np.zeros(len(queries), bool)
        out_c[:, active], out_p[active], out_f[active] = c, p, f
        return self._merge(out_c, out_p, out_f)

    def query_paths(self, queries, k, active_worker=-1):
        """Path prefixes from the streamed index: the chunks the cost
        rounds cached serve the extraction too."""
        active, part = self._split(queries, active_worker)
        nodes, moves = self.st.query_paths(part, k=k)
        self._tally()
        out_nodes = np.zeros((len(queries), k + 1), np.int64)
        out_moves = np.zeros(len(queries), np.int64)
        out_nodes[active], out_moves[active] = nodes, moves
        return self._merge(out_nodes, out_moves)


def _load_oracle(conf: ClusterConfig, args, graph, dc):
    """The campaign's oracle on ``--device``: the resident one of the
    workers this process holds, loaded from the conf's index or built
    and saved when there is none, or the streamed one when that table
    would not fit.

    Memory plan: the JAX CLI holds one worker's shard (``max_owned * N``
    bytes) against ``DOS_FM_BUDGET_GB`` (default 8), since its mesh
    spreads the workers over devices. The port's resident oracle puts
    every worker this process holds on its card(s), so their whole table
    (``W/P * R * N``, every worker on one controller) is held against
    the budget. ``DOS_SERVE_STREAMED=1`` forces the streamed plan.
    Answers are the same under either plan.

    Multi-controller: whether the index is missing is decided by all the
    processes together (any one missing it, all build their workers and
    save it collectively)."""
    from ..models.cpd import CPDOracle

    _pidx, pcount = process_info()
    fm_gb = env_cast("DOS_FM_BUDGET_GB", 8.0, float)
    need = (dc.maxworker // pcount) * max(dc.max_owned, 1) * graph.n
    forced = env_flag("DOS_SERVE_STREAMED", False)
    if forced or need > fm_gb * 1e9:
        log.info("serving streamed%s: the resident fm table %.2f GB vs "
                 "budget %.1f GB (DOS_FM_BUDGET_GB)",
                 " (forced by DOS_SERVE_STREAMED=1)" if forced else "",
                 need / 1e9, fm_gb)
        return _StreamedServe(graph, dc, conf.outdir, args.chunk,
                              args.device)
    layout = mesh_layout(conf)
    cells = layout["data"] * layout["worker"]
    oracle = CPDOracle(graph, dc, mesh=mesh_from_config(
        conf, devices=device_pool(cells, args.device)))
    try:
        oracle.load(conf.outdir)
        found = True
    except FileNotFoundError:
        found = False
    if pcount > 1:
        found = bool(gather_to_host(np.array(found)).all())
    if not found:
        log.info("no index at %s; building in-process", conf.outdir)
        oracle.build(chunk=args.chunk)
        oracle.save(conf.outdir)
    return oracle


def run_tpu(conf: ClusterConfig, args, queries, dc, diffs):
    """All diff rounds in-process on the oracle's device(s) — fused into
    one walk when there are several and no ``-k`` budget; per-worker rows
    recovered from the routed results. ``--alg astar`` rounds search the
    graph with no index (the batched search on ``--device``, or the
    heap engine under ``DOS_ASTAR_DEVICE=0``), the ``--ms-lim``/
    ``--us-lim`` budget a round's deadline.

    Per-worker timing semantics: one call answers the whole round, so a
    per-worker wall clock does not exist. Each row's ``t_astar``/
    ``t_search`` (and ``t_receive``/``t_prepare``) carry the worker's
    SHARE of the round interval, apportioned by walked moves (by batch
    size when no moves) — rows of a round sum to the measured round
    time. A* rows share the round's counters by the same rule."""
    from ..data.graph import Graph

    if args.alg == "ch":
        raise SystemExit(
            "--alg ch is served by the native engine only, which is not "
            "ported (ROADMAP.md A15)")
    graph = Graph.from_xy(conf.xy_file)
    if process_info()[1] == 1:
        # debris of killed atomic writes goes before the build-if-missing
        # path below can trip on it; not multi-controller, where a peer
        # may have an atomic write in flight in the shared index dir
        sweep_stale_artifacts(conf.outdir)
    use_astar = args.alg == "astar"
    if use_astar:
        # A* searches the graph itself: no index. The batched search on
        # --device is the default (on the card K6 answers hundreds of
        # times faster than the heap engine); DOS_ASTAR_DEVICE=0 takes
        # the heap engine
        astar_device = env_flag("DOS_ASTAR_DEVICE", True)
        log.info("--alg astar served by the %s",
                 f"batched search on {args.device} (DOS_ASTAR_DEVICE=0 "
                 "for the heap engine)" if astar_device else
                 "heap engine (DOS_ASTAR_DEVICE=0)")
        astar_ctx: dict = {}
        oracle = None
    else:
        oracle = _load_oracle(conf, args, graph, dc)

    owner = dc.worker_of(queries[:, 1])
    time_ns = get_time_ns(args)
    stats = []
    paths = None
    # fused multi-diff: trajectories are diff-independent (moves follow
    # the FREE-FLOW first-move table), so a multi-diff campaign walks ONCE
    # and sums every round's costs (CPDOracle.query_multi). Answers are
    # bit-identical to sequential rounds; each round's timers carry an
    # equal share of the fused interval. k_moves budgets fall back to
    # sequential rounds (the fused walk serves the unlimited default).
    fused = None
    if not use_astar and len(diffs) > 1 and args.k_moves < 0:
        with Timer() as fprep:
            w_list = [None if d == "-"
                      else graph.weights_with_diff(read_diff(d))
                      for d in diffs]
        with Timer() as fsearch:
            f_cost, f_plen, f_fin = oracle.query_multi(
                queries, w_list, active_worker=args.worker)
        fused = (f_cost, f_plen, f_fin, fprep.interval / len(diffs),
                 fsearch.interval / len(diffs))
        log.info("fused %d diff rounds in one walk (%.3fs)", len(diffs),
                 fsearch.interval)
    for di, diff in enumerate(diffs):
        counters = {}
        active = (np.ones(len(queries), bool) if args.worker == -1
                  else owner == args.worker)
        if fused is not None:
            cost, plen, fin = fused[0][di], fused[1], fused[2]
            prep_iv, search_iv = fused[3], fused[4]
        else:
            with Timer() as prep:
                w_query = (None if diff == "-"
                           else graph.weights_with_diff(read_diff(diff)))
            with Timer() as search:
                if use_astar:
                    deadline = (time.perf_counter() + time_ns / 1e9
                                if time_ns else None)
                    cost = np.zeros(len(queries), np.int64)
                    plen = np.zeros(len(queries), np.int64)
                    fin = np.zeros(len(queries), bool)
                    if astar_device:
                        c, p, f, counters = astar_batch_np(
                            graph, queries[active], w=w_query,
                            hscale=args.h_scale, fscale=args.f_scale,
                            deadline=deadline, ctx=astar_ctx,
                            w_key=diff if not args.no_cache else None,
                            device=args.device)
                    else:
                        c, p, f, counters = _astar_heap_campaign(
                            graph, queries[active], w_query,
                            args.h_scale, args.f_scale, deadline)
                    cost[active], plen[active], fin[active] = c, p, f
                else:
                    cost, plen, fin = oracle.query(
                        queries, w_query=w_query, k_moves=args.k_moves,
                        active_worker=args.worker)
            prep_iv, search_iv = prep.interval, search.interval
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
            # A* rows carry the round's priority-queue counters by the
            # same share rule as the timers (one batch has no per-worker
            # counters); table-search rows keep their walk counters
            row = StatsRow(
                n_expanded=(int(counters.get("n_expanded", 0) * share)
                            if use_astar else moves),
                n_inserted=int(counters.get("n_inserted", 0) * share),
                n_touched=(int(counters.get("n_touched", 0) * share)
                           if use_astar else size),
                n_updated=int(counters.get("n_updated", 0) * share),
                n_surplus=int(counters.get("n_surplus", 0) * share),
                plen=moves,
                finished=int(fin[mask].sum()),
                t_receive=prep_iv * share,
                t_astar=search_iv * share,
                t_search=search_iv * share,
            )
            rows.append(row.as_list(t_prepare=prep_iv * share,
                                    t_partition=0.0, size=size))
        stats.append(rows)
    if args.extract and args.k_moves > 0:
        if use_astar:
            # reference semantics: "K-moves are only available with
            # extractions while hScale only influences A*" (args.py:28)
            log.warning("--extract is a table-search feature; ignored "
                        "for --alg astar")
        else:
            # moves always follow the FREE-FLOW first-move table
            # (reference semantics), so path prefixes are diff-invariant:
            # extract once
            nodes, moves = oracle.query_paths(queries, k=args.k_moves,
                                              active_worker=args.worker)
            paths = np.concatenate([queries, moves[:, None], nodes], axis=1)
    if isinstance(oracle, _StreamedServe):
        pidx, pcount = process_info()
        log.info("streamed: process %d/%d streamed %d wire bytes in %d "
                 "row chunk(s)", pidx, pcount, oracle.bytes_streamed,
                 oracle.row_chunks)
    return stats, paths


# ----------------------------------------------------------------- host path

def send_queries(host: str, wid: int, part: np.ndarray, rconf: RuntimeConfig,
                 nfs: str, diff: str, t_partition: float = 0.0,
                 timeout: float | None = fifo_transport.DEFAULT_TIMEOUT,
                 round_idx: int = 0,
                 policy: fifo_transport.RetryPolicy | None = None):
    """One shard's batch: write the query file, push the request through
    the command FIFO, read the stats line (parity: reference
    ``process_query.py:82-111``). The batch goes to the shard's primary
    worker only.

    Returns ``(row_list, failure)``: ``failure`` is None on success, else
    a dict describing the failed batch for ``degraded.json``."""
    qfile = os.path.join(nfs, f"query.{host}{wid}")
    with Timer() as prep:
        write_query_file(qfile, part)
    req = Request(rconf, qfile, answer_fifo_path(nfs, host, wid), diff)
    row = fifo_transport.send_with_retry(
        host, req, command_fifo_path(wid), timeout=timeout, policy=policy)
    out = row.as_list(t_prepare=prep.interval, t_partition=t_partition,
                      size=len(part))
    if row.ok:
        return out, None
    log.error("worker %d on %s failed its batch (round %d)", wid, host,
              round_idx)
    return out, {"wid": wid, "host": host, "round": round_idx,
                 "diff": diff, "size": int(len(part)),
                 "reason": "send-failed"}


def send_timeout_s(args) -> float:
    """Transport timeout: independent of the per-query search budget (a
    short ``--ms-lim`` must not kill the FIFO round trip itself; a long
    budget extends the allowance proportionally). ``DOS_SEND_TIMEOUT_S``
    overrides outright, so a dead worker is found in seconds rather than
    after the 10-minute default."""
    override = env_cast("DOS_SEND_TIMEOUT_S", None, float)
    if override is not None:
        return override
    return max(fifo_transport.DEFAULT_TIMEOUT,
               (get_time_ns(args) / 1e9) * 10)


def run_host(conf: ClusterConfig, args, queries, dc, diffs,
             t_partition: float = 0.0):
    """Every diff round over the resident FIFO servers, each round's
    batches sent concurrently; returns ``(stats, paths, failures)``."""
    transport = (env_str("DOS_TRANSPORT", "fifo") or "fifo").strip().lower()
    if transport in ("rpc", "auto"):
        raise SystemExit(f"DOS_TRANSPORT={transport}: the RPC lanes are "
                         "not ported (ROADMAP.md A14)")
    rconf = runtime_config(args)
    groups = dc.group_queries(queries, active_worker=args.worker)
    timeout = send_timeout_s(args)
    policy = fifo_transport.RetryPolicy.from_env()
    # a killed transfer script never reaches its `rm -f`: stale answer
    # FIFOs go before the first batch, stale build debris with them
    fifo_transport.clean_stale_answer_fifos(conf.nfs)
    sweep_stale_artifacts(conf.outdir)
    jobs = [(conf.workers[wid], wid, part)
            for wid, part in sorted(groups.items())]
    stats, paths, failures = [], None, []
    for di, diff in enumerate(diffs):
        results = fan_out(jobs, lambda j: send_queries(
            j[0], j[1], j[2], rconf, conf.nfs, diff,
            t_partition=t_partition, timeout=timeout, round_idx=di,
            policy=policy))
        stats.append([row for row, _failure in results])
        failures.extend(f for _row, f in results if f is not None)
        if rconf.extract and paths is None:
            # prefixes follow free-flow moves -> diff-invariant; collect
            # each worker's .paths file from the first round only
            parts = []
            for host, wid, part in jobs:
                pfile = paths_file_for(
                    os.path.join(conf.nfs, f"query.{host}{wid}"))
                try:
                    nodes, moves = read_paths_file(pfile)
                except (OSError, ValueError) as e:
                    log.error("no paths from worker %d (%s); skipping", wid,
                              e)
                    continue
                parts.append(np.concatenate(
                    [part, moves[:, None], nodes], axis=1))
            if parts:
                paths = np.concatenate(parts, axis=0)
    if failures:
        log.error("campaign degraded: %d failed batch(es) across "
                  "workers %s", len(failures),
                  sorted({f["wid"] for f in failures}))
    return stats, paths, failures


def run(conf: ClusterConfig, args):
    """The campaign: returns ``(data, stats, paths)`` with the
    reference's shapes (reference ``process_query.py:132-194``)."""
    if args.order:
        # reordering relabels node ids everywhere (graph, index, scen,
        # diffs); the supported flow reorders the dataset once, up front
        raise SystemExit(
            "--order is applied at dataset-preparation time, not per "
            "campaign: run `python -m distributed_oracle_search_tpu_torch."
            f"cli.reorder --input {conf.xy_file} --order {args.order} "
            "-o <out.xy> --scen <in> <out>` once and point the conf at "
            "the reordered files (build + serve then agree by "
            "construction).")
    scen = conf.scenfile or args.scenario
    with Timer() as t_read:
        queries = read_scen(scen)
    log.info("read %d queries from %s", len(queries), scen)

    with Timer() as t_workload:
        partmethod, partkey = effective_partition(conf, args)
        nodenum = xy_node_count(conf.xy_file)
        use_tpu = args.backend == "tpu" or (args.backend == "auto"
                                            and partmethod == "tpu")
        if use_tpu:
            mesh_layout(conf)
            # replication is a host-wire concept: the in-process
            # campaign routes every query to its primary owner
            if conf.effective_replication() > 1:
                log.info("replication=%d ignored on the in-process "
                         "campaign (queries route to primary owners "
                         "only)", conf.effective_replication())
        else:
            if conf.effective_replication() > 1:
                raise SystemExit("replicated host campaigns (replication "
                                 "> 1: the head's failover over replicas) "
                                 "are not ported (ROADMAP.md A14)")
            if os.path.exists(os.path.join(conf.outdir, "membership.json")):
                raise SystemExit("elastic membership (membership.json) is "
                                 "not ported (ROADMAP.md A14)")
        dc = DistributionController(partmethod, partkey, conf.maxworker,
                                    nodenum)
    diffs = list(conf.diffs) if conf.diffs else list(args.diffs)
    if use_tpu:
        initialize_from_conf(conf)
    elif conf.multihost:
        raise SystemExit("a multihost conf drives the in-process campaign "
                         "(partmethod tpu or --backend tpu); the host "
                         "backend runs one head")
    with Timer() as t_process:
        if use_tpu:
            stats, paths = run_tpu(conf, args, queries, dc, diffs)
            failures = []     # in-process rounds have no wire
        else:
            stats, paths, failures = run_host(
                conf, args, queries, dc, diffs,
                t_partition=t_workload.interval)

    data = {
        "num_queries": int(len(queries)),
        "num_partitions": conf.maxworker,
        "t_read": t_read.interval,
        "t_workload": t_workload.interval,
        "t_process": t_process.interval,
        "failed_batches": failures,
    }
    return data, stats, paths


def campaign_exit_code(data, stats) -> int:
    """Clean / degraded / failed from the collected failure records."""
    failures = data.get("failed_batches", [])
    if not failures:
        return EXIT_CLEAN
    total = sum(len(expe) for expe in stats)
    return EXIT_FAILED if len(failures) >= total else EXIT_DEGRADED


def write_degraded_manifest(dirname: str, data, stats) -> str:
    """``degraded.json`` next to the other campaign artifacts: which
    batches failed, on which workers, and why — the machine-readable
    companion of the non-zero exit code."""
    failures = data.get("failed_batches", [])
    manifest = {
        "exit_code": campaign_exit_code(data, stats),
        "total_batches": sum(len(expe) for expe in stats),
        "failed_count": len(failures),
        "failed_workers": sorted({f["wid"] for f in failures}),
        "failed_batches": failures,
    }
    path = os.path.join(dirname, "degraded.json")
    atomic_write_json(path, manifest)
    return path


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
    if data.get("failed_batches"):
        path = write_degraded_manifest(dirname, data, stats)
        log.error("degraded campaign: manifest written to %s", path)
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
        # multi-controller: every process ran the identical campaign;
        # only process 0 writes or prints the shared artifacts
        if is_primary():
            output(data, stats, args, paths)
    return campaign_exit_code(data, stats)


if __name__ == "__main__":
    sys.exit(main())
