"""Single-machine driver: the port's ``offline.py``.

Role parity with reference P6 (SURVEY.md §2.1) and the JAX package's
``cli/offline.py``: the no-cluster-conf entry point — partitioning
computed in Python (schemes ``all``/``mod``/``div``/``alloc``/range +
``--sort``), one resident engine instead of a worker fleet, a true local
path without ssh, and ``--cutoff`` forcing the in-process path for small
batches. ``--debug`` forces single-threaded deterministic repro with one
part (reference ``offline.py:143-147``).

The resident engine is in-process by default: a one-worker
:class:`~..models.cpd.CPDOracle` over the whole graph on ``--device``
(default ``cuda``; raises without a GPU unless ``--device cpu``), built
on the device (on the card by the build kernels) and never saved, which
answers each part as one walk (on the card one launch of the CUDA walk
kernel). With ``--local`` and a resident FIFO server listening on
``--fifo`` (a ``worker.server`` of a one-worker conf, started by hand or
by ``make_fifos``), parts go through the reference's FIFO protocol
instead — the same wire, the same stats.

``make_parts`` is the executable spec of the partition schemes
(reference ``offline.py:36-67``) with its two known bugs fixed, a copy of
the JAX package's.

    python -m distributed_oracle_search_tpu_torch.cli.offline \\
        -m graph.xy --scenario queries.scen -p 4 -o out/
"""

from __future__ import annotations

import os
import sys

import numpy as np

from .args import parse_args, process_filename
from .process_query import output, runtime_config
from ..data.formats import read_diff, read_scen
from ..transport.fifo import send_with_retry
from ..transport.wire import Request, StatsRow, write_query_file
from ..utils.log import get_logger, set_verbosity
from ..utils.timer import Timer

log = get_logger(__name__)

DEFAULT_ANSWER_FIFO = "/tmp/warthog.fifo.answer"


def make_parts(reqs: np.ndarray, args, num_parts: int) -> list[np.ndarray]:
    """Split queries into parts (executable spec: reference
    ``offline.py:36-67``). Schemes:

    * ``all``  — group by destination, then greedily fill parts up to the
      target size (overflow opens a new part instead of walking off the
      list — the reference's bug);
    * ``mod``  — part = target % num_parts;
    * ``div``  — contiguous target ranges of equal width;
    * ``alloc``— explicit ascending bounds (``--alloc``), one per part;
    * default  — chunk the request list by range into equal counts.

    ``--sort`` then sorts each part by target (reference ``offline.py:219``).
    """
    reqs = np.asarray(reqs, np.int64)
    n = len(reqs)
    t = reqs[:, 1]
    parts: list[np.ndarray]
    if args.group == "all":
        size = max(1, -(-n // num_parts))
        parts = []
        cur: list[np.ndarray] = []
        cur_n = 0
        # group queries sharing a destination, keep groups intact
        order = np.argsort(t, kind="stable")
        bounds = np.nonzero(np.diff(t[order]))[0] + 1
        for grp in np.split(order, bounds):
            if cur_n >= size and cur:
                parts.append(reqs[np.concatenate(cur)])
                cur, cur_n = [], 0
            cur.append(grp)
            cur_n += len(grp)
        if cur:
            parts.append(reqs[np.concatenate(cur)])
    elif args.group == "mod":
        key = args.mod if args.mod else num_parts
        parts = [reqs[t % key == i] for i in range(key)]
    elif args.group == "div":
        key = args.div if args.div else max(1, -(-int(t.max() + 1) // num_parts))
        parts = [reqs[t // key == i] for i in range(-(-int(t.max() + 1) // key))]
    elif args.alloc is not None:
        bounds = np.asarray(args.alloc, np.int64)
        idx = np.searchsorted(bounds, t, side="right")
        if (idx == len(bounds)).any():
            # loud failure, matching DistributionController: silently
            # dropping out-of-range targets would shrink campaign totals
            bad = int(t[idx == len(bounds)][0])
            raise ValueError(
                f"alloc bounds {list(bounds)} do not cover target {bad}")
        parts = [reqs[idx == i] for i in range(len(bounds))]
    else:  # by range: equal-count chunks of the request list
        parts = [chunk for chunk in np.array_split(reqs, num_parts)]
    parts = [p for p in parts if len(p)]
    if args.sort:
        parts = [p[np.argsort(p[:, 1], kind="stable")] for p in parts]
    return parts


class LocalEngine:
    """One-worker in-process oracle over the whole graph on ``device``
    (the offline driver's resident engine), loaded from ``outdir`` when
    it holds an index, else built (and saved there when given)."""

    def __init__(self, xy_file: str, outdir: str | None, chunk: int = 0,
                 device=None):
        from ..data.graph import Graph
        from ..models.cpd import CPDOracle
        from ..parallel.partition import DistributionController

        self.graph = Graph.from_xy(xy_file)
        dc = DistributionController("tpu", None, 1, self.graph.n)
        self.oracle = CPDOracle(self.graph, dc, device=device)
        loaded = False
        if outdir:
            try:
                self.oracle.load(outdir)
                loaded = True
            except FileNotFoundError:
                pass
        if not loaded:
            self.oracle.build(chunk=chunk)
            if outdir:
                self.oracle.save(outdir)

    def answer(self, part: np.ndarray, args, w_query) -> list:
        with Timer() as search:
            cost, plen, fin = self.oracle.query(
                part, w_query=w_query, k_moves=args.k_moves)
        row = StatsRow(
            n_expanded=int(plen.sum()), n_touched=len(part),
            plen=int(plen.sum()), finished=int(fin.sum()),
            t_astar=search.interval, t_search=search.interval)
        return row.as_list(size=len(part))


def send_fifo(part: np.ndarray, args, diff: str, nfs: str) -> list:
    """Send one part through the resident server's FIFO pair (reference
    ``offline.py:70-82`` local path — no ssh)."""
    with Timer() as prep:
        qfile = os.path.join(nfs, f"query.offline{os.getpid()}")
        write_query_file(qfile, part)
    req = Request(runtime_config(args), qfile, DEFAULT_ANSWER_FIFO, diff)
    row = send_with_retry("localhost", req, args.fifo)
    return row.as_list(t_prepare=prep.interval, size=len(part))


def main(argv=None) -> int:
    args = parse_args(argv, prog="offline")
    set_verbosity(args.verbose)
    if args.debug:
        args.omp, args.verbose = 1, max(args.verbose, 2)
        args.num_partitions = 1

    scen = process_filename(args.scenario, args.base, args.dir)
    xy = process_filename(args.map, args.base, args.dir)
    with Timer() as t_read:
        reqs = read_scen(scen)

    num_parts = args.num_partitions or 1
    if args.size_partitions:
        num_parts = max(1, -(-len(reqs) // args.size_partitions))
    if args.debug:
        num_parts = 1
    with Timer() as t_workload:
        parts = make_parts(reqs, args, num_parts)

    diffs = args.diffs if args.diffs else ["-"]
    use_fifo = (args.local and os.path.exists(args.fifo)
                and not (args.cutoff and len(reqs) < args.cutoff))
    stats = []
    with Timer() as t_process:
        if use_fifo:
            for diff in diffs:
                stats.append([send_fifo(p, args, diff, args.nfs)
                              for p in parts])
        else:
            engine = LocalEngine(xy, outdir=None, chunk=args.chunk,
                                 device=args.device)
            for diff in diffs:
                w_query = (None if diff == "-" else
                           engine.graph.weights_with_diff(read_diff(diff)))
                stats.append([engine.answer(p, args, w_query)
                              for p in parts])

    data = {
        "num_queries": int(len(reqs)),
        "num_partitions": len(parts),
        "t_read": t_read.interval,
        "t_workload": t_workload.interval,
        "t_process": t_process.interval,
    }
    output(data, stats, args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
