"""Per-worker CPD build program: the port's ``make_cpd_auto``.

CLI parity with the JAX package's ``worker.build`` (reference C1, invoked
at reference ``make_cpds.py:20``)::

    python -m distributed_oracle_search_tpu_torch.worker.build \\
        --input <xy> --partmethod <div|mod|alloc|tpu> --partkey <int...> \\
        --workerid <int> --maxworker <int> [--outdir <dir>] [--chunk N] \\
        [--block-size N] [--device cuda|cpu]

Computes the first-move rows for the node subset owned by ``workerid``
with the batched min-plus build on one device (the card unless
``--device cpu``) and writes one ``.npy`` per block (``bid``/``bidx``
scheme of the distribution controller). Re-running resumes at block
granularity.
"""

from __future__ import annotations

import argparse
import os
import sys

from ..data.graph import Graph
from ..models.cpd import build_worker_shard
from ..parallel.partition import DistributionController
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
    p.add_argument("--device", default="cuda",
                   help="torch device to build on (default: cuda)")
    p.add_argument("-v", "--verbose", action="count", default=0)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    set_verbosity(args.verbose)
    outdir = args.outdir or os.path.dirname(os.path.abspath(args.input))
    partkey = args.partkey if args.partmethod == "alloc" else args.partkey[0]
    graph = Graph.from_xy(args.input)
    dc_kw = ({"block_size": args.block_size} if args.block_size > 0
             else {})
    dc = DistributionController(args.partmethod, partkey, args.maxworker,
                                graph.n, **dc_kw)
    written = build_worker_shard(graph, dc, args.workerid, outdir,
                                 chunk=args.chunk, device=args.device)
    log.info("worker %d: wrote %d block(s) to %s", args.workerid,
             len(written), outdir)
    print(f"worker {args.workerid}: {len(written)} block(s) -> {outdir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
