"""CPU reference oracle (pure NumPy + heapq).

Role parity: the reference designates the C++ warthog library as its compute
engine — Dijkstra sweeps for CPD construction and ``table-search`` first-move
walks for queries (SURVEY.md §C5; the submodule is absent from the snapshot,
contracts reconstructed from call sites). This module is the port's
**correctness oracle** — a copy of the JAX package's: a small,
obviously-correct implementation used to generate golden answers for the
device path's tests and the chip smoke, and the semantic spec for
tie-breaking.

Not a performance path; the device path (``ops/``) is the production path.

Conventions shared with the device path (must stay in lock-step):

* Distances are int32; unreachable = ``INF`` (``data.graph.INF``).
* A **first move** is an *out-edge slot index* in the graph's padded ELL
  layout (``Graph.ell("out")``), not a neighbor id: slots are ordered by
  ascending edge id, ties on path cost break toward the smallest slot.
  ``-1`` = no move (node is the target, or the target is unreachable).
"""

from __future__ import annotations

import heapq

import numpy as np

from ..data.graph import Graph, INF


def dijkstra(graph: Graph, source: int, w: np.ndarray | None = None,
             reverse: bool = False) -> np.ndarray:
    """Single-source shortest-path distances (int64 [N]).

    ``reverse=True`` runs on the transposed graph, i.e. returns the distance
    *from every node to* ``source`` along directed edges — the sweep the CPD
    build does once per owned target (reference ``README.md:95``: one sweep
    per owned node, all threads).
    """
    w = graph.w if w is None else np.asarray(w)
    dist = np.full(graph.n, int(INF), np.int64)
    dist[source] = 0
    pq = [(0, source)]
    edges = graph.in_edges if reverse else graph.out_edges
    while pq:
        d, u = heapq.heappop(pq)
        if d > dist[u]:
            continue
        nbrs, eids = edges(u)
        for v, e in zip(nbrs, eids):
            nd = d + int(w[e])
            if nd < dist[v]:
                dist[v] = nd
                heapq.heappush(pq, (nd, v))
    return dist


def dist_to_target(graph: Graph, target: int,
                   w: np.ndarray | None = None) -> np.ndarray:
    """d(x → target) for all x."""
    return dijkstra(graph, target, w, reverse=True)


def first_move_to_target(graph: Graph, target: int,
                         w: np.ndarray | None = None,
                         dist: np.ndarray | None = None) -> np.ndarray:
    """First-move column: int8 [N] of out-edge **slot** toward ``target``.

    ``fm[x]`` is the slot k (in ``Graph.ell("out")``) minimizing
    ``w[eid[x,k]] + d(nbr[x,k] → target)``; ties break to the smallest k.
    ``fm[target] = -1`` and ``fm[x] = -1`` when target is unreachable from x.
    """
    w = graph.w if w is None else np.asarray(w)
    if dist is None:
        dist = dist_to_target(graph, target, w)
    nbr, eid = graph.ell("out")
    if nbr.shape[1] > 127:
        raise ValueError(
            f"max out-degree {nbr.shape[1]} exceeds the int8 first-move slot "
            "range; road graphs should be far below this")
    w_pad = np.concatenate([np.asarray(w, np.int64), [int(INF)]])
    # [N, K] candidate costs through each slot
    cand = w_pad[eid] + dist[nbr]
    np.minimum(cand, int(INF), out=cand)
    best = cand.min(axis=1)
    fm = np.argmax(cand == best[:, None], axis=1).astype(np.int8)  # first min slot
    fm[best >= int(INF)] = -1
    fm[target] = -1
    return fm


def first_move_matrix(graph: Graph, targets: np.ndarray,
                      w: np.ndarray | None = None) -> np.ndarray:
    """int8 [len(targets), N] first-move table — one column per target.

    Toy-scale only (O(T · M log N)); this is what a worker's CPD shard
    contains, rows indexed by *owned index* of the target.
    """
    return np.stack([first_move_to_target(graph, int(t), w) for t in targets])


def table_search_walk(graph: Graph, fm_of, s: int, t: int,
                      w_query: np.ndarray | None = None,
                      k_moves: int = -1):
    """Reference ``table-search``: iterated first-move lookup from ``s``
    toward ``t``, accumulating cost on the (possibly congestion-perturbed)
    query-time weights ``w_query`` while following the free-flow first moves
    (reference behavior: CPDs are built free-flow, ``fifo_auto`` applies the
    diff at query time — ``make_fifos.py:18,21`` vs ``make_cpds.py:20``).

    ``fm_of(x, t) -> slot`` abstracts where the first-move table lives.
    ``k_moves`` bounds the number of extracted moves (-1 = unbounded,
    reference ``args.py:31-36``).

    Returns ``(cost, plen, finished, path)``.
    """
    w_query = graph.w if w_query is None else np.asarray(w_query)
    nbr, eid = graph.ell("out")
    x = int(s)
    cost = 0
    path = [x]
    steps = 0
    limit = graph.n if k_moves < 0 else k_moves
    while x != t and steps < limit:
        slot = int(fm_of(x, t))
        if slot < 0:
            break
        cost += int(w_query[eid[x, slot]])
        x = int(nbr[x, slot])
        path.append(x)
        steps += 1
    finished = x == t
    return cost, steps, finished, path
