"""Shared CLI parser for the port's campaign CLIs.

A copy of the JAX package's ``cli/args.py`` (flag-surface parity with the
reference's shared argparse namespace, reference ``args.py:1-188``, minus
its dead Spark/broadcast/streaming/server groups): the same command lines
parse in both packages, unknown flags pass through
(``parse_known_args``), and the defaults are the same. One flag is added,
``--device {cuda,cpu}`` (default ``cuda``), the device the in-process
CLIs build and walk on.

Flags whose machinery is not ported still parse; the CLIs refuse them
where they would have acted. ``--profile`` records with
``torch.profiler`` (a Chrome trace in the directory) where the JAX
package uses ``jax.profiler``.
"""

from __future__ import annotations

import argparse
import os


def build_parser(prog: str | None = None) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=prog, conflict_handler="resolve")
    p.add_argument("-v", "--verbose", action="count", default=0)
    p.add_argument("-t", "--test", action="store_true",
                   help="Run the canned smoke-test config.")
    p.add_argument("-c", type=str, default="./example-cluster-conf.json",
                   help="Cluster config JSON.")
    p.add_argument("-D", "--debug", action="store_true",
                   help="Deterministic single-threaded repro mode.")
    p.add_argument("-w", "--worker", type=int, default=-1,
                   help="Restrict the run to one worker id.")

    part = p.add_argument_group("partitioning")
    part.add_argument("-p", "--num-partitions", type=int, default=0,
                      help="Number of partitions (0 = one per worker).")
    part.add_argument("-s", "--size-partitions", type=int, default=0,
                      help="Target partition size (overrides -p).")
    part.add_argument("--group", type=str,
                      choices=["all", "mod", "div"],
                      help="Partition generation scheme; default is by "
                           "range.")
    part.add_argument("--sort", action="store_true",
                      help="Sort partitions on targets before sending.")
    modus = part.add_mutually_exclusive_group()
    modus.add_argument("--div", type=int,
                       help="Assign nodes to worker = target / div.")
    modus.add_argument("--mod", type=int,
                       help="Assign nodes to worker = target %% mod.")
    modus.add_argument("--alloc", type=int, nargs="+",
                       help="Ascending range bounds, one per worker.")

    path = p.add_argument_group("search")
    path.add_argument("-k", "--k-moves", type=int, default=-1,
                      help="Number of moves to extract; -1 = all.")
    path.add_argument("--extract", action="store_true",
                      help="Materialize each query's first k-moves path "
                           "nodes (needs -k > 0): workers write "
                           "<queryfile>.paths, the campaign collects "
                           "paths.csv. Wire extension; the reference "
                           "computed prefixes but never returned them.")
    path.add_argument("--h-scale", default=1.0, type=float,
                      help="Heuristic tolerance factor for A*.")
    path.add_argument("--f-scale", default=0.0, type=float,
                      help="Sub-optimality factor for A*.")
    path.add_argument("--itrs", default=1, type=int,
                      help="Search iterations per batch.")
    path.add_argument("--s-lim", default=0, type=int,
                      help="Time limit in seconds.")
    path.add_argument("--ms-lim", default=0, type=int,
                      help="Time limit in milliseconds.")
    path.add_argument("--us-lim", default=0, type=int,
                      help="Time limit in microseconds.")
    path.add_argument("--ns-lim", default=0, type=int,
                      help="Time limit in nanoseconds.")

    batch = p.add_argument_group("batching")
    batch.add_argument("-o", "--output",
                       help="Directory to write campaign artifacts to.")
    batch.add_argument("--omp", type=int, default=0,
                       help="Worker thread count (wire parity; a no-op "
                            "on the device).")

    files = p.add_argument_group("files")
    files.add_argument("-b", "--base", type=str, default=".",
                       help="Base directory the code is run from.")
    files.add_argument("-d", "--dir", type=str, default="data",
                       help="Directory containing map/scenario files.")
    files.add_argument("-m", "--map", type=str, default="",
                       help="Graph (.xy) to use.")
    files.add_argument("--scenario", type=str, default="",
                       help="Scenario file to read from.")
    files.add_argument("--diff", type=str,
                       help="Travel-time diff file for the search.")
    files.add_argument("--order", type=str, default=None,
                       help="Node ordering: bfs | rcm | order-file "
                            "(reference args.py:119 NodeOrdering). "
                            "Datasets are reordered up front by "
                            "cli.reorder; this flag names the ordering "
                            "that produced them.")

    rand = p.add_argument_group("random")
    rand.add_argument("-R", "--random", action="store_true",
                      help="Randomise the seed.")
    rand.add_argument("--seed", type=int, default=562410645)

    fifo = p.add_argument_group("fifo")
    fifo.add_argument("--fifo", type=str, default="/tmp/warthog.fifo",
                      help="Command FIFO path (offline/local mode).")
    fifo.add_argument("--local", action="store_true",
                      help="Force the local no-ssh path.")
    fifo.add_argument("--cutoff", type=int, default=0,
                      help="Below this many queries, run locally.")
    fifo.add_argument("--thread-alloc", type=int, default=0,
                      help="Receiver-thread pinning (wire parity no-op).")
    fifo.add_argument("--nfs", type=str, default="/tmp",
                      help="Shared directory for query files.")
    fifo.add_argument("--diffs", type=str, nargs="+", default=["-"],
                      help="Diff files for congestion; '-' = free flow.")
    fifo.add_argument("--no-cache", action="store_true",
                      help="Disable the workers' runtime cache.")
    fifo.add_argument("--supervise", action="store_true",
                      help="make_fifos: stay resident as a worker "
                           "supervisor — launch the servers as "
                           "subprocesses, ping them via the "
                           "__DOS_PING__ liveness frame, and respawn "
                           "crashed ones with capped exponential "
                           "backoff (local hosts only; see "
                           "worker.supervisor).")
    fifo.add_argument("--traffic-dir", default=None,
                      help="make_fifos --supervise: diff segment "
                           "stream directory passed to every spawned "
                           "worker.server, so supervised workers gate "
                           "requests from diff epochs their filesystem "
                           "view has not seen yet (STALE_DIFF) instead "
                           "of failing the fused-file open.")
    fifo.add_argument("--alg", default="table-search",
                      choices=["table-search", "astar", "ch"],
                      help="Serving algorithm. The reference "
                           "hard-codes table-search (make_fifos.py:20); "
                           "astar serves the hscale/fscale family, ch the "
                           "congestion-free contraction hierarchy "
                           "(native engine only: make_fifos --engine "
                           "native, process_query --backend host).")

    new = p.add_argument_group("in-process backend (new in this framework)")
    new.add_argument("--backend", choices=["auto", "tpu", "host"],
                     default="auto",
                     help="Execution backend; auto follows the cluster "
                          "conf's partmethod ('tpu' = the in-process "
                          "device path, the name conf files carry).")
    new.add_argument("--profile", type=str, default="",
                     help="Write a torch.profiler Chrome trace of the "
                          "campaign to this directory.")
    new.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                     help="Device the in-process CLIs build and walk "
                          "on (default: cuda; raises without a GPU).")
    new.add_argument("--chunk", type=int, default=0,
                     help="CPD build: target rows per build step "
                          "(0 = all owned rows at once).")
    new.add_argument("--no-resume", action="store_true",
                     help="make_cpds: rebuild every block from scratch "
                          "instead of resuming off the per-worker build "
                          "ledger (default: resume — only blocks whose "
                          "ledger digest no longer matches the file are "
                          "recomputed).")
    new.add_argument("--delta-from", type=str, default=None,
                     metavar="OLD_INDEX",
                     help="make_cpds: DELTA rebuild — given this "
                          "existing index plus a fused diff (--diff), "
                          "recompute only the rows whose first-move "
                          "entries can change (tense-edge pass), byte-"
                          "copy untouched blocks, and write an epoch-"
                          "tagged index under OLD_INDEX/epoch-e<N> "
                          "that the serve path can promote without "
                          "restart. Bit-identical to a from-scratch "
                          "build on the retimed graph.")
    new.add_argument("--delta-epoch", type=int, default=None,
                     help="diff epoch tag for --delta-from (default: "
                          "parsed from the fused diff's "
                          "fused-e<N>.diff name, else the old "
                          "manifest's diff_epoch + 1).")
    new.add_argument("--verify", action="store_true",
                     help="make_cpds: check-only integrity pass over the "
                          "conf's index — every manifest block is digest/"
                          "shape-verified in place; exits 0 clean, 3 "
                          "degraded (some blocks bad), 4 corrupt (no "
                          "usable manifest or no block survived), "
                          "mirroring process_query's exit codes.")
    new.add_argument("--scrub", action="store_true",
                     help="make_cpds: at-rest scrub cadence — repeat "
                          "the --verify check-only pass every "
                          "--scrub-interval seconds for --scrub-passes "
                          "passes, exiting with the WORST pass code "
                          "(0 clean / 3 degraded / 4 corrupt). The "
                          "offline counterpart of the serve-side "
                          "resident scrubber (DOS_SCRUB_INTERVAL_S).")
    new.add_argument("--scrub-interval", type=float, default=60.0,
                     help="--scrub: seconds between passes "
                          "(default 60).")
    new.add_argument("--scrub-passes", type=int, default=1,
                     help="--scrub: number of passes; 0 repeats until "
                          "interrupted (default 1).")
    new.add_argument("--engine", choices=["python", "native"],
                     default="python",
                     help="Host-mode worker engine: the shard engine or "
                          "the native C++ binaries (./install.sh).")
    new.add_argument("--codec", choices=["raw", "pack4", "rle", "auto"],
                     default=None,
                     help="make_cpds: persist CPD blocks compressed "
                          "(models.resident RLE/pack4 containers; "
                          "per-block degrade to raw when not viable). "
                          "Default: the DOS_CPD_RESIDENT knob, whose "
                          "raw default keeps the legacy block format.")

    obs = p.add_argument_group("observability")
    obs.add_argument("--trace", type=str, default="",
                     help="Write a merged Chrome trace-event JSON of the "
                          "campaign's head + worker spans to this path "
                          "(open in Perfetto or chrome://tracing); the "
                          "per-batch trace_id rides the FIFO wire as a "
                          "RuntimeConfig extension.")
    obs.add_argument("--metrics-dump", type=str, default="",
                     help="Write a JSON snapshot of the obs.metrics "
                          "registry (counters / gauges / histograms) to "
                          "this path at campaign end.")
    obs.add_argument("--obs-port", type=int, default=None,
                     help="Serve live /metrics /healthz /statusz scrape "
                          "endpoints on this port for the process's "
                          "lifetime (0 = OS-assigned; default off; "
                          "DOS_OBS_PORT env).")
    return p


def parse_args(argv=None, prog: str | None = None) -> argparse.Namespace:
    """Parse, tolerating unknown flags (parity with the reference's
    ``parse_known_args`` pass-through, ``args.py:188``)."""
    args, _unknown = build_parser(prog).parse_known_args(argv)
    return args


def get_time_ns(args) -> int:
    """Resolve the ``--s/ms/us/ns-lim`` family to one ns budget (parity:
    reference ``args.py:210-221``)."""
    tlim = args.ns_lim
    if args.s_lim > 0:
        tlim = int(args.s_lim * 1e9)
    elif args.ms_lim > 0:
        tlim = int(args.ms_lim * 1e6)
    elif args.us_lim > 0:
        tlim = int(args.us_lim * 1e3)
    return tlim


def process_filename(fname: str, base: str = ".", dirname: str = "") -> str:
    """Resolve a data filename directly or under ``base/dir`` (parity:
    reference ``args.py:198-207``)."""
    if os.path.isfile(fname):
        return fname
    with_dir = os.path.join(base, dirname, fname)
    if os.path.isfile(with_dir):
        return with_dir
    raise IOError(f"File {fname} not found, searched {with_dir}.")
