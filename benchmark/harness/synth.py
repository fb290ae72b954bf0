"""The benchmark's own inputs, made from the seed.

A frozen copy of the generators the port ships in ``data/synth.py``
(``synth_road_network``, ``synth_diff``), kept here so that a later
change to the program's generators cannot move the yardstick, and
:func:`road_network_sized`, the same layout cut to a published arc
count. They return plain arrays, ``(xs, ys, src, dst, w)``: the
harness hands the same arrays to the program (its ``Graph``) and to the
plain reference. The random draws, their order and every formula are the
program's, so the same seed gives the same graph in both copies.
"""

from __future__ import annotations

import numpy as np


def _dedupe(src, dst, n):
    key = src * n + dst
    _, uniq = np.unique(key, return_index=True)
    return src[uniq], dst[uniq]


def _road_layout(n: int, seed: int):
    """:func:`road_network`'s draws up to its roads: ``(rng, xs, ys,
    backbone, local, highways)``, each road group an ``(su, sv)`` pair."""
    rng = np.random.default_rng(seed)
    n_towns = max(4, n // 2000)
    centers = rng.uniform(0, 4_000_000, (n_towns, 2))
    town = rng.integers(0, n_towns, n)
    spread = rng.gamma(2.0, 12_000, n)
    ang = rng.uniform(0, 2 * np.pi, n)
    xs = (centers[town, 0] + spread * np.cos(ang)).astype(np.int64)
    ys = (centers[town, 1] + spread * np.sin(ang)).astype(np.int64)
    band = ys // 25_000
    space = np.lexsort((xs, band))
    i = np.arange(1, n)
    back = i - 1 - np.minimum(rng.geometric(0.3, n - 1) - 1,
                              np.minimum(i - 1, 63))
    backbone = (space[i], space[back])
    extra = np.minimum(rng.zipf(2.2, n) - 1, 12)
    tot = int(extra.sum())
    owner = np.repeat(np.arange(n), extra)
    off = rng.integers(1, 48, tot)
    nbr = np.clip(owner - off, 0, n - 1)
    keep = nbr != owner
    local = (space[owner[keep]], space[nbr[keep]])
    hub = np.empty(n_towns, np.int64)
    d2 = (xs - centers[town, 0]) ** 2 + (ys - centers[town, 1]) ** 2
    for t in range(n_towns):
        members = np.nonzero(town == t)[0]
        hub[t] = members[np.argmin(d2[members])] if len(members) else 0
    horder = np.lexsort((centers[:, 0], centers[:, 1] // 400_000))
    k_long = max(1, n_towns // 8)
    highways = (np.concatenate([hub[horder[:-1]],
                                hub[rng.integers(0, n_towns, k_long)]]),
                np.concatenate([hub[horder[1:]],
                                hub[rng.integers(0, n_towns, k_long)]]))
    return rng, xs, ys, backbone, local, highways


def _road_finish(rng, xs, ys, su, sv):
    """Every road two-way, travel times from jittered lengths, node ids
    shuffled: the graph's arrays."""
    n = len(xs)
    ok = su != sv
    su, sv = su[ok], sv[ok]
    src, dst = _dedupe(np.concatenate([su, sv]), np.concatenate([sv, su]), n)
    dx = (xs[src] - xs[dst]).astype(np.float64)
    dy = (ys[src] - ys[dst]).astype(np.float64)
    dist = np.sqrt(dx * dx + dy * dy)
    jitter = 1.0 + 0.3 * rng.random(len(src))
    w = np.maximum(1, (dist * jitter / 100.0).astype(np.int64))
    w = np.minimum(w, 2_000_000).astype(np.int32)
    # relabel: new id i is old node shuf[i]
    shuf = rng.permutation(n)
    inv = np.empty(n, np.int64)
    inv[shuf] = np.arange(n)
    return xs[shuf], ys[shuf], inv[src], inv[dst], w


def road_network(n: int, seed: int):
    """A degree-skewed, planar-ish road network of ``n`` nodes: towns of
    clustered density, a spanning backbone of local roads, long-tailed
    extra local edges, a highway layer between town centres; every road
    two-way; node ids shuffled, as a DIMACS file's arbitrary order."""
    rng, xs, ys, *groups = _road_layout(n, seed)
    su = np.concatenate([g[0] for g in groups])
    sv = np.concatenate([g[1] for g in groups])
    return _road_finish(rng, xs, ys, su, sv)


def _roads(su, sv, n):
    """The distinct two-way roads of ``(su, sv)`` as sorted keys
    ``min * n + max``, loops dropped."""
    a, b = np.minimum(su, sv), np.maximum(su, sv)
    return np.unique((a * n + b)[a != b])


def road_network_sized(n: int, arcs: int, seed: int):
    """:func:`road_network`'s layout with exactly ``arcs`` arcs
    (``arcs / 2`` two-way roads), as a published road graph states its
    node and arc counts: the spanning backbone and the highways all
    kept, and local roads drawn from the seed to make up the count."""
    rng, xs, ys, backbone, local, highways = _road_layout(n, seed)
    kept = _roads(np.concatenate([backbone[0], highways[0]]),
                  np.concatenate([backbone[1], highways[1]]), n)
    spare = np.setdiff1d(_roads(*local, n), kept, assume_unique=True)
    need = arcs // 2 - len(kept)
    if arcs % 2 or not 0 <= need <= len(spare):
        raise ValueError(f"{arcs} arcs cannot be made two-way on the "
                         f"{n}-node layout ({len(kept)} roads kept, "
                         f"{len(spare)} to draw from)")
    roads = np.concatenate([kept, np.sort(rng.choice(spare, need,
                                                     replace=False))])
    return _road_finish(rng, xs, ys, roads // n, roads % n)
def congestion(m: int, w: np.ndarray, frac: float, seed: int,
               factor_range=(1.5, 4.0)):
    """A congestion diff: ``(eids, new_w)``, a random ``frac`` of the
    ``m`` edges slowed by a factor drawn from ``factor_range``."""
    rng = np.random.default_rng(seed)
    k = max(1, int(m * frac))
    eids = rng.choice(m, size=k, replace=False)
    factor = rng.uniform(*factor_range, k)
    new_w = np.maximum(1, (w[eids] * factor).astype(np.int64)).astype(np.int32)
    return eids, new_w


GENERATORS = {"road_network_sized": road_network_sized}


def relabel_perm(n: int, seed: int, classes: int) -> np.ndarray:
    """A permutation of ``n`` node ids drawn from ``seed`` that keeps every
    id's residue mod ``classes``: ids trade places only with ids of their
    own residue, so a ``mod`` partition over ``classes`` workers gives
    each worker the same nodes under new names."""
    rng = np.random.default_rng(seed)
    perm = np.arange(n, dtype=np.int64)
    for r in range(classes):
        perm[r::classes] = rng.permutation(perm[r::classes])
    return perm


def relabel(arrays, perm: np.ndarray):
    """The same graph with new id i for old node ``perm[i]``; edges keep
    their order."""
    xs, ys, src, dst, w = arrays
    inv = np.empty(len(xs), np.int64)
    inv[perm] = np.arange(len(xs))
    return xs[perm], ys[perm], inv[src], inv[dst], w


def make_graph(spec: dict, seed: int, classes: int = 1):
    """The configuration's graph (``spec``: its ``graph`` entry, whose
    ``seed`` fixes the graph itself, a deployment's one road network),
    its nodes renamed by the run's ``seed`` within their ids' residues
    mod ``classes`` (:func:`relabel_perm`), and the map from the drawn ids
    to the new ones: ``((xs, ys, src, dst, w), new_id)``. Edges keep
    their order, so an edge id names the same road under every seed."""
    kw = {k: v for k, v in spec.items() if k not in ("generator", "seed")}
    arrays = GENERATORS[spec["generator"]](seed=spec["seed"], **kw)
    n = len(arrays[0])
    perm = relabel_perm(n, seed, classes)
    new_id = np.empty(n, np.int64)
    new_id[perm] = np.arange(n)
    return relabel(arrays, perm), new_id
