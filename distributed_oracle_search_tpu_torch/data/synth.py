"""Deterministic synthetic road networks, scenarios, and congestion diffs.

The reference's data files (``data/melb-both.xy``, ``.diff``, ``full.scen``)
are not part of this repository, so benchmarks and tests run on
generated city-like graphs instead: a W×H street
grid with jittered coordinates, integer travel times proportional to jittered
euclidean length, optional random arterial shortcuts, and every street
two-way — which keeps the graph strongly connected by construction, like a
real road network under the free-flow assumption.
"""

from __future__ import annotations

import numpy as np

from .graph import Graph


def synth_city_graph(width: int, height: int, seed: int = 0,
                     shortcut_frac: float = 0.02,
                     weight_jitter: float = 0.3) -> Graph:
    """Grid city: ``width*height`` intersections, two-way streets.

    Travel times are int32 in ~[80, 160] per block edge (scaled euclidean
    with multiplicative jitter). ``shortcut_frac`` adds that fraction of
    extra random two-way "arterial" edges with proportionally longer times.
    """
    rng = np.random.default_rng(seed)
    n = width * height
    ids = np.arange(n, dtype=np.int64)
    gx, gy = ids % width, ids // width
    xs = gx * 100 + rng.integers(-20, 21, n)
    ys = gy * 100 + rng.integers(-20, 21, n)

    # grid streets: right and up neighbors, both directions
    right = ids[gx < width - 1]
    up = ids[gy < height - 1]
    su = np.concatenate([right, up])
    sv = np.concatenate([right + 1, up + width])

    if shortcut_frac > 0 and n > 4:
        k = int(len(su) * shortcut_frac)
        a = rng.integers(0, n, k)
        hop = rng.integers(2, 6, k)
        b = np.clip(a + hop * rng.choice([1, -1, width, -width], k), 0, n - 1)
        keep = a != b
        su = np.concatenate([su, a[keep]])
        sv = np.concatenate([sv, b[keep]])

    # both directions
    src = np.concatenate([su, sv])
    dst = np.concatenate([sv, su])
    # drop duplicate directed edges (shortcuts may collide with grid edges)
    key = src * n + dst
    _, uniq = np.unique(key, return_index=True)
    src, dst = src[uniq], dst[uniq]

    dx = xs[src] - xs[dst]
    dy = ys[src] - ys[dst]
    dist = np.sqrt((dx * dx + dy * dy).astype(np.float64))
    jitter = 1.0 + weight_jitter * rng.random(len(src))
    w = np.maximum(1, (dist * jitter).astype(np.int64)).astype(np.int32)
    return Graph(xs, ys, src, dst, w)


def synth_road_network(n: int, seed: int = 0) -> Graph:
    """Non-grid, degree-skewed, planar-ish road network — the DIMACS
    stand-in (BASELINE.md configs[5] is USA-road-d.NY, 264k nodes; the
    real file is absent from the snapshot).

    Topology-realistic where the grid city is not: towns of clustered
    density, a connected backbone of local roads whose edges are bridges
    (long detours when congested), a long-tailed degree distribution
    (hub intersections), and a sparse highway layer between town centers.
    NOT id-ordered for the fast build kernels on purpose — the point of
    the DIMACS regime is that ``grid_split`` fails and shift coverage is
    poor until a BFS/RCM reorder (``Graph.rcm_order``) restores id
    locality, exactly like real road inputs.
    """
    rng = np.random.default_rng(seed)
    n_towns = max(4, n // 2000)
    centers = rng.uniform(0, 4_000_000, (n_towns, 2))
    town = rng.integers(0, n_towns, n)
    spread = rng.gamma(2.0, 12_000, n)
    ang = rng.uniform(0, 2 * np.pi, n)
    xs = (centers[town, 0] + spread * np.cos(ang)).astype(np.int64)
    ys = (centers[town, 1] + spread * np.sin(ang)).astype(np.int64)

    # spatial snake order (bands of y, then x) gives a locality window
    # without a kd-tree; ids are then SHUFFLED so the stored graph has no
    # exploitable id structure (that is what reordering is for)
    band = ys // 25_000
    space = np.lexsort((xs, band))

    # connected backbone: each node (in space order) links to a random
    # earlier node within a short window -> spanning tree of local roads
    i = np.arange(1, n)
    back = i - 1 - np.minimum(rng.geometric(0.3, n - 1) - 1, np.minimum(i - 1, 63))
    su = [space[i], ]
    sv = [space[back], ]

    # degree skew: a long-tailed number of extra local edges per node
    # (most 0-1, hubs up to ~12)
    extra = np.minimum(rng.zipf(2.2, n) - 1, 12)
    tot = int(extra.sum())
    owner = np.repeat(np.arange(n), extra)          # position in space order
    off = rng.integers(1, 48, tot)
    nbr = np.clip(owner - off, 0, n - 1)
    keep = nbr != owner
    su.append(space[owner[keep]])
    sv.append(space[nbr[keep]])

    # highway layer: town centers chained by proximity order + a few
    # random long links
    hub = np.empty(n_towns, np.int64)
    d2 = (xs - centers[town, 0]) ** 2 + (ys - centers[town, 1]) ** 2
    for t in range(n_towns):                        # one pass, small loop
        members = np.nonzero(town == t)[0]
        hub[t] = members[np.argmin(d2[members])] if len(members) else 0
    horder = np.lexsort((centers[:, 0], centers[:, 1] // 400_000))
    su.append(hub[horder[:-1]])
    sv.append(hub[horder[1:]])
    k_long = max(1, n_towns // 8)
    su.append(hub[rng.integers(0, n_towns, k_long)])
    sv.append(hub[rng.integers(0, n_towns, k_long)])

    su = np.concatenate(su)
    sv = np.concatenate(sv)
    ok = su != sv
    su, sv = su[ok], sv[ok]
    src = np.concatenate([su, sv])
    dst = np.concatenate([sv, su])
    key = src * n + dst
    _, uniq = np.unique(key, return_index=True)
    src, dst = src[uniq], dst[uniq]

    dx = (xs[src] - xs[dst]).astype(np.float64)
    dy = (ys[src] - ys[dst]).astype(np.float64)
    dist = np.sqrt(dx * dx + dy * dy)
    jitter = 1.0 + 0.3 * rng.random(len(src))
    w = np.maximum(1, (dist * jitter / 100.0).astype(np.int64))
    w = np.minimum(w, 2_000_000).astype(np.int32)

    # destroy id locality: real DIMACS inputs arrive in arbitrary order
    shuf = rng.permutation(n)
    return Graph(xs, ys, src, dst, w).reorder(shuf)


def synth_scenario(n_nodes: int, n_queries: int, seed: int = 1) -> np.ndarray:
    """Random s–t pairs with s != t, int64 [Q, 2]."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n_nodes, n_queries)
    t = rng.integers(0, n_nodes, n_queries)
    clash = s == t
    t[clash] = (t[clash] + 1) % n_nodes
    return np.stack([s, t], axis=1).astype(np.int64)


def synth_diff(graph: Graph, frac: float = 0.1, seed: int = 2,
               factor_range: tuple[float, float] = (1.5, 4.0)):
    """Congestion diff: slow down a random ``frac`` of edges.

    Returns ``(src, dst, new_w)`` suitable for ``write_diff`` /
    ``Graph.weights_with_diff``.
    """
    rng = np.random.default_rng(seed)
    k = max(1, int(graph.m * frac))
    eids = rng.choice(graph.m, size=k, replace=False)
    factor = rng.uniform(*factor_range, k)
    new_w = np.maximum(1, (graph.w[eids] * factor).astype(np.int64)).astype(np.int32)
    return graph.src[eids], graph.dst[eids], new_w


def ensure_synth_dataset(datadir: str, width: int = 24, height: int = 18,
                         n_queries: int = 512, seed: int = 0) -> dict:
    """Materialize the canned smoke-test dataset on disk (idempotent).

    The no-cluster analog of the reference's demo data: writes
    ``synth-city.xy``, ``synth.scen``, ``synth-city.xy.diff`` under
    ``datadir`` if absent, matching the paths ``utils.config.test_config``
    points at. Returns the path dict.
    """
    import os

    from .formats import write_diff, write_scen, write_xy

    os.makedirs(datadir, exist_ok=True)
    xy = os.path.join(datadir, "synth-city.xy")
    scen = os.path.join(datadir, "synth.scen")
    diff = os.path.join(datadir, "synth-city.xy.diff")
    if not os.path.exists(xy):
        g = synth_city_graph(width, height, seed=seed)
        write_xy(xy, g.xs, g.ys, g.src, g.dst, g.w)
    if not os.path.exists(scen):
        g = Graph.from_xy(xy)
        write_scen(scen, synth_scenario(g.n, n_queries, seed=seed + 1),
                   comment="synthetic smoke-test scenario")
    if not os.path.exists(diff):
        g = Graph.from_xy(xy)
        src, dst, new_w = synth_diff(g, seed=seed + 2)
        write_diff(diff, src, dst, new_w)
    return {"xy": xy, "scen": scen, "diff": diff}
