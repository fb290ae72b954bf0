"""The plain reference against the port run on the CPU (``device="cpu"``)
on tiny graphs, the harness's frozen generator against the port's, and
the configuration's graph against its published counts."""

import json
import os

import numpy as np
import pytest
import torch

from bench_support import BENCH
from harness import synth
from reference import paths

from distributed_oracle_search_tpu_torch.data import synth as port_synth
from distributed_oracle_search_tpu_torch.data.graph import Graph
from distributed_oracle_search_tpu_torch.models.cpd import pick_build_kernel
from distributed_oracle_search_tpu_torch.ops.batched_astar import (
    astar_batch_np,
)
from distributed_oracle_search_tpu_torch.ops.device_graph import DeviceGraph
from distributed_oracle_search_tpu_torch.parallel.sharded import (
    build_fm_sharded,
)

GRAPHS = {
    "road": lambda seed: port_synth.synth_road_network(2_000, seed),
    "road_sized": lambda seed: Graph(*synth.road_network_sized(
        2_000, 5_552, seed)),
    "grid": lambda seed: port_synth.synth_city_graph(24, 24, seed,
                                                     shortcut_frac=0.0),
}


def edges(g, w=None):
    return tuple(torch.as_tensor(np.asarray(a, np.int64)) for a in
                 (g.src, g.dst, g.w if w is None else w))


@pytest.mark.parametrize("seed", [0, 5])
def test_frozen_generators_equal_the_ports(seed):
    g = port_synth.synth_road_network(2_000, seed)
    got = synth.road_network(2_000, seed)
    for a, b in zip(got, (g.xs, g.ys, g.src, g.dst, g.w)):
        np.testing.assert_array_equal(a, b)


def test_the_configurations_graph_has_its_published_counts():
    """Every node and arc the configuration states, every road two-way,
    one connected network, and the same graph for every run's seed."""
    with open(os.path.join(BENCH, "configs", "ny-w32.json")) as f:
        cfg = json.load(f)
    (xs, ys, src, dst, w), _ = synth.make_graph(cfg["graph"], 3, 32)
    n = len(xs)
    assert (n, len(src)) == (cfg["nodes"], cfg["arcs"])
    key = src * n + dst
    assert len(np.unique(key)) == len(key)
    assert np.array_equal(np.sort(key), np.sort(dst * n + src))
    assert (src != dst).all() and (w > 0).all()
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components

    adj = sp.coo_matrix((np.ones(len(src)), (src, dst)), shape=(n, n))
    assert connected_components(adj)[0] == 1
    other, _ = synth.make_graph(cfg["graph"], 4, 32)
    assert np.array_equal(np.bincount(src, minlength=n)[0::32].sum(),
                          np.bincount(other[2], minlength=n)[0::32].sum())
    assert sorted(w) == sorted(other[4])


@pytest.mark.parametrize("kind", sorted(GRAPHS))
def test_first_move_rows_equal_the_ports_build(kind):
    g = GRAPHS[kind](3)
    targets = np.arange(0, g.n, 37, dtype=np.int32)[None, :]
    kernel = pick_build_kernel(g, "auto")
    fm = build_fm_sharded(DeviceGraph.from_graph(g, device="cpu"), targets,
                          kernel=kernel)
    want = paths.first_moves(g.n, *edges(g),
                             torch.as_tensor(targets[0], dtype=torch.int64))
    assert torch.equal(fm[0], want)
    assert int((want >= 0).sum()) > 0.9 * want.numel()


@pytest.mark.parametrize("kind", sorted(GRAPHS))
def test_astar_answers_equal_the_ports_under_a_diff(kind):
    g = GRAPHS[kind](4)
    eids, new_w = synth.congestion(g.m, g.w, 0.1, 9)
    w = g.w.copy()
    w[eids] = new_w
    rng = np.random.default_rng(1)
    q = np.stack([rng.integers(0, g.n, 96), rng.integers(0, g.n, 96)], 1)
    cost, plen, fin, _ = astar_batch_np(g, q, w, chunk=64, device="cpu")
    want = paths.route_answers(g.n, *edges(g, w), torch.as_tensor(q[:, 0]),
                               torch.as_tensor(q[:, 1]))
    np.testing.assert_array_equal(cost, want[0].numpy())
    np.testing.assert_array_equal(plen, want[1].numpy())
    np.testing.assert_array_equal(fin, want[2].numpy())
    assert fin.all() and (plen > 0).sum() > 90


def test_relabel_keeps_each_workers_nodes():
    spec = {"generator": "road_network_sized", "n": 2_000, "arcs": 5_552,
            "seed": 0}
    (xs, ys, src, dst, w), new_id = synth.make_graph(spec, 11, classes=8)
    base = synth.road_network_sized(2_000, 5_552, 0)
    assert (new_id % 8 == np.arange(2_000) % 8).all()
    assert not (new_id == np.arange(2_000)).all()
    np.testing.assert_array_equal(src, new_id[base[2]])
    np.testing.assert_array_equal(xs[new_id], base[0])
    np.testing.assert_array_equal(w, base[4])


def test_int16_saturates_what_int32_holds():
    g = GRAPHS["road_sized"](2)
    t = torch.tensor([0, 1, 2])
    full = paths.first_moves(g.n, *edges(g), t)
    low = paths.first_moves(g.n, *edges(g), t, paths.INT16_CAP)
    assert int((full != low).sum()) > 0
    d = paths.to_targets(g.n, *edges(g), t, paths.INT16_CAP)
    assert int(d.max()) == paths.INT16_CAP


def test_every_seed_routes_the_same_queries_renamed():
    """The A* pool under two seeds: the same drawn queries, each seed's
    in its own names, every target the worker's."""
    import importlib.util

    path = os.path.join(BENCH, "drivers", "astar_batches.py")
    spec = importlib.util.spec_from_file_location("astar_batches", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with open(os.path.join(BENCH, "traffic", "astar_diff.json")) as f:
        traffic = json.load(f)
    graph = {"generator": "road_network_sized", "n": 2_000, "arcs": 5_552,
             "seed": 0}
    cfg = {"partition": {"method": "mod", "workers": 8}, "worker": 0}
    owned = np.arange(0, 2_000, 8)
    drawn = []
    for seed in (1, 2 ** 40 + 3):
        _, new_id = synth.make_graph(graph, seed, 8)
        pool = mod.query_pool(traffic, 2_000, owned, new_id)
        assert pool.shape == (traffic["pool_batches"], traffic["batch"], 2)
        assert (pool[..., 1] % 8 == cfg["worker"]).all()
        old_id = np.argsort(new_id)
        drawn.append(old_id[pool])
    np.testing.assert_array_equal(drawn[0], drawn[1])
    assert len({b.tobytes() for b in drawn[0]}) == traffic["pool_batches"]
