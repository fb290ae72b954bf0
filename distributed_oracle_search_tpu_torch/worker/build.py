"""Per-worker CPD build program: the port's ``make_cpd_auto``.

CLI parity with the JAX package's ``worker.build`` (reference C1, invoked
at reference ``make_cpds.py:20``)::

    python -m distributed_oracle_search_tpu_torch.worker.build \\
        --input <xy> --partmethod <div|mod|alloc|tpu> --partkey <int...> \\
        --workerid <int> --maxworker <int> [--outdir <dir>] [--chunk N] \\
        [--block-size N] [--codec raw|pack4|rle|auto] [--device cuda|cpu]
        [--method auto|sweep|shift|frontier|ellsplit|ell]
        [--no-resume] [--replication R] [--adopt-shard SHARD]
        [--metrics-dump PATH]

Computes the first-move rows for the node subset owned by ``workerid``
with the batched min-plus build on one device (the card unless
``--device cpu``), through the distance stage ``--method`` names (``auto``
picks by the graph's structure, ``models.cpd.pick_build_kernel``; every
method writes the same blocks), and writes one ``.npy`` per block
(``bid``/``bidx`` scheme of the distribution controller). ``--codec``
persists each block as a compressed container (``models.resident``; a
block the codec cannot take is written raw). Re-running resumes at block
granularity (``--no-resume`` recomputes every block). ``--replication R``
(default ``DOS_REPLICATION`` or 1) then builds the replica block sets
this worker hosts, copied from digest-valid primaries or recomputed.
``--adopt-shard SHARD`` builds nothing of its own: it digest-verifies the
named shard's primary blocks and heals any that are missing or corrupt
(``models.cpd.adopt_shard_blocks``). ``--metrics-dump`` writes, on exit,
the metrics registry's snapshot (``counters``/``gauges``/``histograms``)
with the build kernels' launches and the index counters
(``models.cpd.COUNTERS``) mirrored into its ``counters`` under their
names, beside the build's seconds, blocks and rows, the device and its
peak allocated bytes, as JSON. ``DOS_FAULTS="crash-build;wid=W"`` ends
the build of worker W after a block lands (exit code 86); the rerun
resumes from the ledger.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

from ..data.graph import Graph
from ..models import cpd
from ..obs import metrics as obs_metrics
from ..ops import cuda_build_kernels as cbk
from ..parallel.partition import DistributionController
from ..utils.atomicio import atomic_write_json
from ..utils.device import resolve_device
from ..utils.env import env_cast
from ..utils.log import get_logger, set_verbosity

log = get_logger(__name__)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--input", required=True, help="graph .xy file")
    p.add_argument("--partmethod", required=True,
                   choices=["div", "mod", "alloc", "tpu"])
    p.add_argument("--partkey", type=int, nargs="+", default=[1])
    p.add_argument("--workerid", type=int, required=True)
    p.add_argument("--maxworker", type=int, required=True)
    p.add_argument("--outdir", default=None,
                   help="default: the input file's directory "
                        "(reference README.md:93)")
    p.add_argument("--chunk", type=int, default=0,
                   help="build-step rows (0 = whole shard at once)")
    p.add_argument("--block-size", type=int, default=0,
                   help="rows per block FILE (0 = the controller default, "
                        "which is what the serving side expects)")
    p.add_argument("--codec", default=None,
                   choices=["raw", "pack4", "rle", "auto"],
                   help="persist blocks compressed (RLE/pack4 containers; "
                        "per-block degrade to raw when not viable). "
                        "Default: the DOS_CPD_RESIDENT knob (raw)")
    p.add_argument("--method", default="auto",
                   choices=["auto", "sweep", "shift", "frontier",
                            "ellsplit", "ell"],
                   help="relaxation kernel: fast-sweeping grid scans, "
                        "shift relaxation, delta-stepping frontier "
                        "queue, ELL+COO split (degree-skewed graphs), "
                        "padded-ELL relaxation, or auto by structure "
                        "gates (models.cpd.pick_build_kernel)")
    p.add_argument("--no-resume", action="store_true",
                   help="rebuild every block (default: resume — skip "
                        "blocks the build ledger records as complete "
                        "with a matching on-disk digest)")
    p.add_argument("--replication", type=int, default=None,
                   help="R-way shard replication: after the primary rows, "
                        "also build this worker's hosted replica block "
                        "sets (rank r of shard (wid - r) %% W; copied from "
                        "digest-valid primaries, recomputed otherwise). "
                        "Default: DOS_REPLICATION or 1")
    p.add_argument("--adopt-shard", type=int, default=None,
                   metavar="SHARD",
                   help="instead of building this worker's rows, "
                        "digest-verify the named shard's primary blocks "
                        "and heal (rebuild) any missing or corrupt one")
    p.add_argument("--device", default="cuda",
                   help="torch device to build on (default: cuda)")
    p.add_argument("--metrics-dump", default="",
                   help="write the build's seconds, blocks, build kernel "
                        "launches, index counters (in the metrics "
                        "registry's snapshot), device and peak device "
                        "memory as JSON to this path on exit")
    p.add_argument("-v", "--verbose", action="count", default=0)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    set_verbosity(args.verbose)
    outdir = args.outdir or os.path.dirname(os.path.abspath(args.input))
    partkey = args.partkey if args.partmethod == "alloc" else args.partkey[0]
    replication = args.replication
    if replication is None:
        replication = env_cast("DOS_REPLICATION", 1, int)
    if not 1 <= replication <= args.maxworker:
        # env policy: degrade, don't crash — as the head ignores an
        # out-of-range DOS_REPLICATION (ClusterConfig.effective_replication)
        log.warning("ignoring replication=%d outside [1, maxworker=%d]"
                    "; building primaries only", replication,
                    args.maxworker)
        replication = 1
    graph = Graph.from_xy(args.input)
    dc_kw = ({"block_size": args.block_size} if args.block_size > 0
             else {})
    dc = DistributionController(args.partmethod, partkey, args.maxworker,
                                graph.n, replication=replication, **dc_kw)
    t0 = time.perf_counter()
    if args.adopt_shard is not None:
        report = cpd.adopt_shard_blocks(graph, dc, args.adopt_shard, outdir,
                                        device=args.device)
        written = report["healed"]
        log.info("worker %d: adopted shard %d (%d block(s): %d ok, %d "
                 "unverified, %d healed)", args.workerid, args.adopt_shard,
                 report["blocks"], report["ok"], report["unverified"],
                 len(written))
        summary = (f"worker {args.workerid}: adopted shard "
                   f"{args.adopt_shard} ({report['blocks']} block(s), "
                   f"{len(written)} healed) -> {outdir}")
    else:
        written = cpd.build_worker_shard(
            graph, dc, args.workerid, outdir, chunk=args.chunk,
            device=args.device, codec=args.codec, method=args.method,
            resume=not args.no_resume)
        n_replica = 0
        if dc.replication > 1:
            n_replica = sum(len(v) for v in cpd.build_replica_shards(
                graph, dc, args.workerid, outdir, chunk=args.chunk,
                resume=not args.no_resume, method=args.method,
                device=args.device).values())
        log.info("worker %d: wrote %d primary block(s)%s to %s",
                 args.workerid, len(written),
                 f" + {n_replica} replica block(s)" if n_replica else "",
                 outdir)
        summary = (f"worker {args.workerid}: {len(written)} block(s)"
                   + (f" + {n_replica} replica block(s)"
                      if dc.replication > 1 else "") + f" -> {outdir}")
    seconds = time.perf_counter() - t0
    if args.metrics_dump:
        dev = resolve_device(args.device)
        on_card = dev.type == "cuda"
        obs_metrics.mirror_counts(
            {**{f"{fn.__name__}.launches": fn.launches
                for fn in (cbk.relax_jacobi, cbk.first_moves,
                           cbk.grid_sweep)},
             "relax_jacobi.active_pairs": cbk.relax_jacobi.active_pairs,
             **cpd.COUNTERS})
        atomic_write_json(args.metrics_dump, {
            **obs_metrics.REGISTRY.snapshot(),
            "wid": args.workerid, "pid": os.getpid(), "seconds": seconds,
            "blocks": len(written), "rows": dc.n_owned(args.workerid),
            "device": {
                "type": dev.type,
                "name": (torch.cuda.get_device_name(dev) if on_card
                         else "cpu"),
                "max_memory_allocated": (
                    int(torch.cuda.max_memory_allocated(dev)) if on_card
                    else 0)},
        })
    print(summary)
    return 0


if __name__ == "__main__":
    sys.exit(main())
