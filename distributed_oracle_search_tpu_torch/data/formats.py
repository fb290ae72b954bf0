"""On-disk formats: .xy graphs, .scen scenarios, .diff congestion files.

The reference consumes warthog's formats, whose full specs live in the absent
C++ submodule. The Python side pins down only these structural facts, which we
preserve exactly:

* **xy**: the node count is the 2nd whitespace token of the 4th line
  (reference ``process_query.py:126-130``).
* **scen**: query lines start with ``q`` followed by integer fields; readers
  keep ``[s, t]`` (reference ``process_query.py:22-32``).
* **diff**: a per-edge travel-time perturbation applied at query time only,
  never at CPD-build time (reference ``make_fifos.py:18,21`` vs
  ``make_cpds.py:20``); ``"-"`` means no perturbation (``args.py:169``).

Concrete grammar used by this framework (self-describing, versioned):

xy::

    xy graph
    v 1
    header end
    p <n_nodes> <n_edges> 0          <- 4 tokens, 2nd = node count
    v <x> <y>                        (n_nodes lines; ids implicit 0..n-1)
    e <src> <dst> <weight>           (n_edges lines; weight = int travel time)

scen::

    c <free-form comment lines>
    q <s> <t>                        (one query per line)

diff::

    d <n_entries>
    <src> <dst> <new_weight>         (replaces the weight of edge src->dst)
"""

from __future__ import annotations

import numpy as np

from ..utils.atomicio import atomic_write_bytes

XY_MAGIC = "xy graph"
INT_WEIGHT_DTYPE = np.int32


def write_xy(path: str, xs: np.ndarray, ys: np.ndarray,
             src: np.ndarray, dst: np.ndarray, w: np.ndarray) -> None:
    n, m = len(xs), len(src)
    out = [f"{XY_MAGIC}\nv 1\nheader end\np {n} {m} 0"]
    out += ["v %d %d" % (x, y) for x, y in zip(xs, ys)]
    out += ["e %d %d %d" % (u, v, ww) for u, v, ww in zip(src, dst, w)]
    atomic_write_bytes(path, ("\n".join(out) + "\n").encode())


def xy_node_count(path: str) -> int:
    """Node count from the 4th line, 2nd token — the one structural contract
    the reference relies on (``process_query.py:126-130``)."""
    with open(path) as f:
        for i, line in enumerate(f):
            if i == 3:
                return int(line.split()[1])
    raise ValueError(f"{path}: fewer than 4 header lines")


def read_xy(path: str):
    """Parse an xy graph → (xs, ys, src, dst, w) numpy arrays."""
    with open(path) as f:
        lines = f.read().split("\n")
    if not lines or lines[0].strip() != XY_MAGIC:
        raise ValueError(f"{path}: bad magic (expected {XY_MAGIC!r})")
    toks = lines[3].split()
    n, m = int(toks[1]), int(toks[2])
    xs = np.empty(n, np.int64)
    ys = np.empty(n, np.int64)
    src = np.empty(m, np.int64)
    dst = np.empty(m, np.int64)
    w = np.empty(m, INT_WEIGHT_DTYPE)
    vi = ei = 0
    for line in lines[4:]:
        if not line:
            continue
        tag = line[0]
        if tag == "v":
            _, x, y = line.split()
            xs[vi], ys[vi] = int(x), int(y)
            vi += 1
        elif tag == "e":
            _, u, v, ww = line.split()
            src[ei], dst[ei], w[ei] = int(u), int(v), int(ww)
            ei += 1
    if vi != n or ei != m:
        raise ValueError(f"{path}: header says {n} nodes/{m} edges, "
                         f"found {vi}/{ei}")
    return xs, ys, src, dst, w


def write_scen(path: str, queries: np.ndarray, comment: str = "") -> None:
    out = ["c tpu-oracle scenario v1"]
    if comment:
        out.append(f"c {comment}")
    out += ["q %d %d" % (s, t) for s, t in queries]
    atomic_write_bytes(path, ("\n".join(out) + "\n").encode())


def read_scen(path: str) -> np.ndarray:
    """Read a point-to-point scenario → int64 array [Q, 2] of (s, t).

    Same acceptance rule as the reference reader: only lines whose first
    character is ``q`` count; every other line is ignored
    (``process_query.py:22-32``).
    """
    ss, ts = [], []
    with open(path) as f:
        for line in f:
            if not line.strip() or line[0] != "q":
                continue
            fields = line.split()[1:]
            ss.append(int(fields[0]))
            ts.append(int(fields[1]))
    return np.stack([np.asarray(ss, np.int64), np.asarray(ts, np.int64)],
                    axis=1) if ss else np.zeros((0, 2), np.int64)


def write_diff(path: str, src: np.ndarray, dst: np.ndarray,
               new_w: np.ndarray) -> None:
    out = [f"d {len(src)}"]
    out += ["%d %d %d" % (u, v, ww) for u, v, ww in zip(src, dst, new_w)]
    atomic_write_bytes(path, ("\n".join(out) + "\n").encode())


def read_diff(path: str):
    """Parse a diff file → (src, dst, new_w). ``"-"`` / empty → no entries."""
    if path in ("-", "", None):
        z = np.zeros(0, np.int64)
        return z, z, np.zeros(0, INT_WEIGHT_DTYPE)
    with open(path) as f:
        header = f.readline().split()
        k = int(header[1])
        src = np.empty(k, np.int64)
        dst = np.empty(k, np.int64)
        w = np.empty(k, INT_WEIGHT_DTYPE)
        for i in range(k):
            u, v, ww = f.readline().split()
            src[i], dst[i], w[i] = int(u), int(v), int(ww)
    return src, dst, w
