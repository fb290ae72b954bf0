"""Scenario generator: topologies, hotspot query pools, rush-hour
replay traces.

Every new workload needs a headline number (ROADMAP item 5c), so the
generator is deterministic end to end — same seed, same topology, same
queries, same segment bytes — and emits the SAME artifacts the serving
plane consumes (graphs via ``data.synth``/local builders, segments via
``traffic.segments``), never a parallel bench-only format.

* :func:`make_topology` — ``grid`` (street grid city), ``road``
  (degree-skewed DIMACS stand-in), ``powerlaw`` (preferential-
  attachment hub network: the "every trip goes through downtown"
  regime where congestion on a few hub edges touches most routes —
  the worst case for scoped cache invalidation, on purpose);
* :func:`zipf_queries` — zipf-ranked hotspot pools (repeated (s, t)
  pairs are what give result caches and the engine's dedup something
  to do);
* :func:`rush_hour_trace` — a timed list of diff segments following a
  tent profile over a congested corridor: weights ramp up to a peak
  multiplier and back down, epoch by epoch — the replay input for the
  live-swap bench and the chaos drill;
* :func:`replay` — write a trace into a stream directory on schedule
  (interval 0 = as fast as the consumer can swap).
"""

from __future__ import annotations

import time

import numpy as np

from ..data.graph import Graph
from ..data.synth import synth_city_graph, synth_road_network
from ..utils.log import get_logger
from .segments import write_segment

log = get_logger(__name__)


def powerlaw_graph(n: int, m_edges: int = 2, seed: int = 0) -> Graph:
    """Preferential-attachment hub network (Barabási–Albert flavor),
    two-way edges, travel times scaled by coordinate distance like the
    grid city so length estimates stay meaningful."""
    if n < 3:
        raise ValueError("powerlaw topology needs n >= 3")
    rng = np.random.default_rng(seed)
    xs = rng.integers(0, 100_000, n)
    ys = rng.integers(0, 100_000, n)
    su, sv = [0, 1], [1, 2]            # seed chain
    targets_pool = [0, 1, 1, 2]        # degree-weighted sampling pool
    for u in range(3, n):
        picks = set()
        while len(picks) < min(m_edges, u):
            picks.add(int(targets_pool[rng.integers(0,
                                                    len(targets_pool))]))
        for v in picks:
            su.append(u)
            sv.append(v)
            targets_pool.extend([u, v])
    su = np.asarray(su, np.int64)
    sv = np.asarray(sv, np.int64)
    src = np.concatenate([su, sv])
    dst = np.concatenate([sv, su])
    dx = xs[src] - xs[dst]
    dy = ys[src] - ys[dst]
    dist = np.sqrt((dx * dx + dy * dy).astype(np.float64))
    w = np.maximum(1, (dist * 0.01 * (1.0 + 0.3 * rng.random(len(src))))
                   .astype(np.int64)).astype(np.int32)
    return Graph(xs, ys, src, dst, w)


def make_topology(kind: str, n: int = 500, seed: int = 0) -> Graph:
    """One of the three workload topologies by name."""
    if kind == "grid":
        width = max(2, int(np.sqrt(n)))
        return synth_city_graph(width, max(2, n // width), seed=seed)
    if kind == "road":
        return synth_road_network(max(n, 64), seed=seed)
    if kind == "powerlaw":
        return powerlaw_graph(n, seed=seed)
    raise ValueError(f"unknown topology {kind!r} "
                     "(want grid|road|powerlaw)")


def zipf_queries(n_nodes: int, n_queries: int, a: float = 1.3,
                 seed: int = 0) -> np.ndarray:
    """Hotspot query pool: sources and targets drawn from a zipf rank
    distribution over a seeded node permutation (rank 1 = the hottest
    "downtown" node). Self-pairs are re-rolled onto a neighbor rank so
    every query does real work."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n_nodes)
    ranks_s = rng.zipf(a, n_queries).clip(1, n_nodes) - 1
    ranks_t = rng.zipf(a, n_queries).clip(1, n_nodes) - 1
    same = ranks_s == ranks_t
    ranks_t[same] = (ranks_t[same] + 1) % n_nodes
    return np.stack([perm[ranks_s], perm[ranks_t]], axis=1)


def pick_corridor(graph: Graph, frac: float = 0.02,
                  seed: int = 0) -> np.ndarray:
    """Edge ids of a congestion corridor: the busiest fraction of edges
    by endpoint degree (hub-adjacent streets — where rush hour actually
    lands), at least one edge."""
    deg = np.diff(graph.out_ptr)
    score = deg[graph.src] + deg[graph.dst]
    k = max(1, int(graph.m * frac))
    rng = np.random.default_rng(seed)
    # jitter breaks degree ties deterministically so corridors differ
    # across seeds even on regular grids
    order = np.argsort(score + rng.random(graph.m), kind="stable")
    return order[-k:]


def rush_hour_trace(graph: Graph, epochs: int = 6, frac: float = 0.02,
                    peak: float = 4.0, seed: int = 0,
                    start_epoch: int = 1) -> list[dict]:
    """Timed segment trace over a corridor: multipliers follow a tent
    profile (ramp to ``peak``, ramp back to free flow) across
    ``epochs`` segments. Returns ``[{"epoch", "src", "dst", "w"}, ...]``
    ready for :func:`replay` (or direct ``write_segment`` calls)."""
    if epochs < 1:
        raise ValueError("epochs must be >= 1")
    eids = pick_corridor(graph, frac=frac, seed=seed)
    src = graph.src[eids]
    dst = graph.dst[eids]
    base = graph.w[eids].astype(np.float64)
    trace = []
    for i in range(epochs):
        # tent profile peaking mid-trace; the last epoch returns to ~free
        # flow so a full replay ends where it began
        x = i / max(epochs - 1, 1)
        factor = 1.0 + (peak - 1.0) * (1.0 - abs(2.0 * x - 1.0))
        w = np.maximum(1, (base * factor)).astype(np.int64)
        trace.append({"epoch": int(start_epoch + i), "src": src.copy(),
                      "dst": dst.copy(), "w": w})
    return trace


def replay(trace: list[dict], dirname: str, interval_s: float = 0.0,
           stop=None) -> int:
    """Write a trace's segments into a stream directory on schedule;
    returns how many were written (a set ``stop`` event ends the replay
    early). ``interval_s=0`` emits as fast as the files can be written —
    the consumer's fused ingestion collapses whatever backlog forms."""
    n = 0
    for seg in trace:
        if stop is not None and stop.is_set():
            break
        write_segment(dirname, seg["epoch"], seg["src"], seg["dst"],
                      seg["w"])
        n += 1
        if interval_s > 0:
            if stop is not None:
                if stop.wait(interval_s):
                    break
            else:
                time.sleep(interval_s)
    return n
