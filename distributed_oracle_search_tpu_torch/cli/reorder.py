"""Node reordering — the reference's ``--order`` NodeOrdering, as a tool.

The reference accepts ``--order <file>`` to overwrite warthog's internal
NodeOrdering (reference ``args.py:119``). Here node ids are load-bearing
for BUILD SPEED: the build policy keys on id locality
(``models.cpd.pick_build_kernel``: shift coverage, the grid gates and the
frontier queue's locality), so an arbitrarily-ordered real graph (e.g.
DIMACS) should be reordered once, up front, by BFS or reverse
Cuthill–McKee.

Reordering relabels nodes EVERYWHERE, so this tool rewrites the whole
dataset consistently — graph, scenario, diffs — plus a ``.order`` file
(line k = old id of new node k) for mapping external ids later. Build and
serve then agree by construction. A port of the JAX package's
``cli/reorder.py``; its output files are byte-equal to that tool's.

    python -m distributed_oracle_search_tpu_torch.cli.reorder \\
        --input ny.xy --order rcm -o ny-rcm.xy \\
        [--scen full.scen reordered.scen] [--diff ny.diff ny-rcm.diff]

``--order`` takes ``bfs``, ``rcm``, or a file of node ids (one per line,
line k = old id of new node k — the same format this tool emits).
"""

from __future__ import annotations

import sys

import numpy as np

from ..data.formats import (
    read_diff, read_scen, write_diff, write_scen, write_xy,
)
from ..data.graph import Graph


def resolve_order(graph: Graph, spec: str) -> np.ndarray:
    """``bfs`` / ``rcm`` / path-to-file → permutation (new → old)."""
    if spec == "bfs":
        return graph.bfs_order()
    if spec == "rcm":
        return graph.rcm_order()
    perm = np.loadtxt(spec, dtype=np.int64, ndmin=1)
    if len(perm) != graph.n:
        raise ValueError(
            f"order file {spec} has {len(perm)} ids, graph has {graph.n}")
    return perm


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--input", required=True, help="input .xy graph")
    p.add_argument("--order", required=True,
                   help="bfs | rcm | order-file (line k = old id of new "
                        "node k)")
    p.add_argument("-o", "--output", required=True, help="output .xy")
    p.add_argument("--scen", nargs=2, metavar=("IN", "OUT"), default=None,
                   help="also remap a scenario file")
    p.add_argument("--diff", nargs=2, metavar=("IN", "OUT"), default=None,
                   action="append",
                   help="also remap a diff file (repeatable)")
    args = p.parse_args(argv)

    g = Graph.from_xy(args.input)
    perm = resolve_order(g, args.order)
    g2 = g.reorder(perm)
    inv = np.empty(g.n, np.int64)
    inv[perm] = np.arange(g.n)

    write_xy(args.output, g2.xs, g2.ys, g2.src, g2.dst, g2.w)
    np.savetxt(args.output + ".order", perm, fmt="%d")
    if args.scen:
        q = read_scen(args.scen[0])
        write_scen(args.scen[1], inv[q],
                   comment=f"reordered by {args.order}")
    for pair in (args.diff or []):
        dsrc, ddst, dw = read_diff(pair[0])
        write_diff(pair[1], inv[dsrc], inv[ddst], dw)
    from ..ops.shift_relax import split_coverage

    _, w_shift, _, w_left = g2.shift_split()
    cov = split_coverage(w_shift, w_left)
    print(f"{args.output}: {g2.n} nodes reordered ({args.order}); "
          f"shift coverage {cov:.1%}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
