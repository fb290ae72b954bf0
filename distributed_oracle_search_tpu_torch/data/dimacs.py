"""DIMACS 9th-challenge road-network format (.gr / .co) support.

The reference's scale-up config is DIMACS ``USA-road-d.NY`` (BASELINE.md
configs[5]): CPD build + 10M random queries. The actual files are absent
from the snapshot, but the format is standard and public:

``.gr`` (graph)::

    c <comments>
    p sp <n_nodes> <n_arcs>
    a <u> <v> <weight>          (directed arc, nodes 1-indexed)

``.co`` (coordinates)::

    c <comments>
    p aux sp co <n_nodes>
    v <id> <x> <y>              (1-indexed; x/y are signed integers,
                                 longitude/latitude * 10^6 in the road set)

This module reads both into the port's :class:`Graph` (0-indexed) and
converts to the ``.xy`` wire format so every downstream tool — Python or
native — consumes DIMACS data unchanged:

    python -m distributed_oracle_search_tpu_torch.data.dimacs \
        --gr USA-road-d.NY.gr --co USA-road-d.NY.co -o ny.xy
"""

from __future__ import annotations

import numpy as np

from .formats import INT_WEIGHT_DTYPE, write_xy
from .graph import Graph, INF


def read_gr(path: str):
    """Parse a DIMACS ``.gr`` file → (n, src, dst, w), 0-indexed."""
    n = m = -1
    src = dst = w = None
    ei = 0
    with open(path) as f:
        for line in f:
            tag = line[:1]
            if tag == "a":
                if src is None or ei >= m:
                    raise ValueError(
                        f"{path}: arc before 'p sp' line" if src is None
                        else f"{path}: more than {m} arcs (bad header)")
                _, u, v, ww = line.split()
                src[ei] = int(u) - 1
                dst[ei] = int(v) - 1
                wi = int(ww)
                # mirror the endpoint check: a weight at/over INF (or
                # negative) would wrap the int32 min-plus arithmetic
                # downstream (INF+INF < int32 max is the invariant)
                if not 0 <= wi < int(INF):
                    raise ValueError(
                        f"{path}: arc {u}->{v} weight {wi} outside "
                        f"[0, {int(INF)})")
                w[ei] = wi
                ei += 1
            elif tag == "p":
                toks = line.split()
                if len(toks) != 4 or toks[1] != "sp":
                    raise ValueError(f"{path}: bad problem line {line!r}")
                n, m = int(toks[2]), int(toks[3])
                src = np.empty(m, np.int64)
                dst = np.empty(m, np.int64)
                w = np.empty(m, INT_WEIGHT_DTYPE)
            elif tag in ("c", "", "\n"):
                continue
    if n < 0:
        raise ValueError(f"{path}: no 'p sp' problem line")
    if ei != m:
        raise ValueError(f"{path}: header says {m} arcs, found {ei}")
    if len(src) and (src.min() < 0 or dst.min() < 0
                     or src.max() >= n or dst.max() >= n):
        raise ValueError(f"{path}: arc endpoint out of [1, {n}]")
    return n, src, dst, w


def read_co(path: str):
    """Parse a DIMACS ``.co`` file → (n, xs, ys), 0-indexed by id."""
    n = -1
    xs = ys = None
    seen = 0
    with open(path) as f:
        for line in f:
            tag = line[:1]
            if tag == "v":
                if xs is None:
                    raise ValueError(
                        f"{path}: vertex before 'p aux sp co' line")
                _, i, x, y = line.split()
                idx = int(i) - 1
                if not 0 <= idx < n:
                    raise ValueError(
                        f"{path}: vertex id {i} out of [1, {n}] "
                        "(DIMACS ids are 1-indexed)")
                xs[idx] = int(x)
                ys[idx] = int(y)
                seen += 1
            elif tag == "p":
                toks = line.split()
                if toks[-2:-1] == ["co"] or (len(toks) == 5
                                             and toks[3] == "co"):
                    n = int(toks[-1])
                else:
                    raise ValueError(f"{path}: bad aux line {line!r}")
                xs = np.zeros(n, np.int64)
                ys = np.zeros(n, np.int64)
            elif tag in ("c", "", "\n"):
                continue
    if n < 0:
        raise ValueError(f"{path}: no 'p aux sp co' line")
    if seen != n:
        raise ValueError(f"{path}: header says {n} nodes, found {seen}")
    return n, xs, ys


def graph_from_dimacs(gr_path: str, co_path: str | None = None) -> Graph:
    """Load a DIMACS graph (+ optional coordinates) as a :class:`Graph`.

    Without a ``.co`` file, coordinates default to zeros — everything
    works except coordinate-based query ordering
    (``CPDOracle._length_estimate`` degrades to no sort) and geometric
    heuristics (A*'s h ≡ 0 = plain Dijkstra, still correct).
    """
    n, src, dst, w = read_gr(gr_path)
    if co_path:
        nc, xs, ys = read_co(co_path)
        if nc != n:
            raise ValueError(
                f"{gr_path} has {n} nodes but {co_path} has {nc}")
    else:
        xs = np.zeros(n, np.int64)
        ys = np.zeros(n, np.int64)
    return Graph(xs, ys, src, dst, w)


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        description="Convert DIMACS .gr/.co to the .xy wire format")
    p.add_argument("--gr", required=True, help="DIMACS .gr graph file")
    p.add_argument("--co", default=None, help="DIMACS .co coordinate file")
    p.add_argument("-o", "--output", required=True, help=".xy output path")
    args = p.parse_args(argv)
    g = graph_from_dimacs(args.gr, args.co)
    write_xy(args.output, g.xs, g.ys, g.src, g.dst, g.w)
    print(f"{args.output}: {g.n} nodes, {g.m} arcs")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
