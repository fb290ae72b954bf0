"""Weighted A* point-to-point search with full priority-queue telemetry.

A copy of the JAX package's ``models/astar.py`` (host numpy and heapq;
the port keeps its own copy, since it imports nothing of that package).
The A*-family the reference's knobs imply (``--h-scale --f-scale``,
reference ``args.py:30-57``; counter vocabulary ``n_expanded /
n_inserted / n_touched / n_updated / n_surplus`` from the response
schema, ``process_query.py:198-213``):

* heuristic: euclidean distance × the graph's minimum cost-per-coordinate-
  unit (a lower bound over edges, so admissible), scaled by ``hscale`` —
  ``hscale ≤ 1`` keeps optimality, ``hscale > 1`` trades it for speed;
* ``fscale > 0`` additionally prunes nodes whose f exceeds
  ``(1 + fscale) ×`` the best-known goal cost;
* counters: ``n_expanded`` = nodes popped and relaxed, ``n_inserted`` =
  pushes, ``n_touched`` = edge relaxations attempted, ``n_updated`` =
  decrease-key events, ``n_surplus`` = stale pops discarded.

It is the in-process campaign's default A* engine (``cli.process_query``)
and the engine's ``debug`` path (``worker.engine``); the batched search on
the card is ``ops.batched_astar``.
"""

from __future__ import annotations

import dataclasses
import heapq
import math

import numpy as np

from ..data.graph import Graph, INF


@dataclasses.dataclass
class AstarStats:
    n_expanded: int = 0
    n_inserted: int = 0
    n_touched: int = 0
    n_updated: int = 0
    n_surplus: int = 0
    plen: int = 0
    finished: int = 0

    def __iadd__(self, o: "AstarStats") -> "AstarStats":
        for f in dataclasses.fields(self):
            setattr(self, f.name, getattr(self, f.name) + getattr(o, f.name))
        return self


def min_cost_per_unit(graph: Graph, w: np.ndarray | None = None) -> float:
    """Lower bound of edge-cost per coordinate distance (heuristic scale)."""
    w = graph.w if w is None else np.asarray(w)
    dx = graph.xs[graph.src] - graph.xs[graph.dst]
    dy = graph.ys[graph.src] - graph.ys[graph.dst]
    length = np.sqrt(dx * dx + dy * dy)
    mask = length > 0
    if not mask.any():
        return 0.0
    return float((w[mask] / length[mask]).min())


def astar(graph: Graph, s: int, t: int, w: np.ndarray | None = None,
          hscale: float = 1.0, fscale: float = 0.0,
          cpu: float | None = None,
          stats: AstarStats | None = None):
    """Weighted A* from ``s`` to ``t``. Returns ``(cost, plen, finished)``.

    ``cpu`` = precomputed :func:`min_cost_per_unit` (recomputed if None).
    ``stats`` accumulates telemetry in place when provided.
    """
    w = graph.w if w is None else np.asarray(w)
    if cpu is None:
        cpu = min_cost_per_unit(graph, w)
    st = stats if stats is not None else AstarStats()
    xs, ys = graph.xs, graph.ys

    def h(x: int) -> int:
        return int(math.hypot(float(xs[x] - xs[t]), float(ys[x] - ys[t]))
                   * cpu * hscale)

    gcost = np.full(graph.n, int(INF), np.int64)
    parent_edge = np.full(graph.n, -1, np.int64)
    gcost[s] = 0
    open_pq = [(h(s), s)]
    st.n_inserted += 1
    goal_cost = int(INF)
    while open_pq:
        f, u = heapq.heappop(open_pq)
        if f > gcost[u] + h(u):
            st.n_surplus += 1
            continue
        if u == t:
            goal_cost = int(gcost[u])
            break
        # fscale prune against the incumbent: gcost[t] is live as soon as
        # any relaxation reaches t, before t is ever popped
        if fscale > 0 and gcost[t] < int(INF) \
                and f > (1.0 + fscale) * int(gcost[t]):
            st.n_surplus += 1
            continue
        st.n_expanded += 1
        nbrs, eids = graph.out_edges(u)
        for v, e in zip(nbrs, eids):
            st.n_touched += 1
            ng = int(gcost[u]) + int(w[e])
            if ng < gcost[v]:
                if gcost[v] < int(INF):
                    st.n_updated += 1
                gcost[v] = ng
                parent_edge[v] = e
                heapq.heappush(open_pq, (ng + h(v), int(v)))
                st.n_inserted += 1

    finished = goal_cost < int(INF)
    plen = 0
    if finished:
        x = t
        while x != s:
            plen += 1
            x = int(graph.src[parent_edge[x]])
    st.plen += plen
    st.finished += 1 if finished else 0
    return (goal_cost if finished else 0), plen, finished
