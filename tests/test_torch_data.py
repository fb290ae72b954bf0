"""PyTorch port, host data layer: the port's copies of the graph, formats,
synthetic generators and partition controller hold the same arrays as
the JAX package's, and its DeviceGraph the same tables (bit-identical)."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)

from distributed_oracle_search_tpu import data as jdata  # noqa: E402
from distributed_oracle_search_tpu.ops import DeviceGraph as JDeviceGraph  # noqa: E402
from distributed_oracle_search_tpu.parallel import partition as jpart  # noqa: E402
from distributed_oracle_search_tpu_torch import data as tdata  # noqa: E402
from distributed_oracle_search_tpu_torch.ops import DeviceGraph  # noqa: E402
from distributed_oracle_search_tpu_torch.parallel import partition as tpart  # noqa: E402

DATA = os.path.join(os.path.dirname(os.path.dirname(__file__)), "data")


def _graph_pairs():
    xy = os.path.join(DATA, "synth-city.xy")
    return {
        "synth-city.xy": (jdata.Graph.from_xy(xy), tdata.Graph.from_xy(xy)),
        "city": (jdata.synth_city_graph(9, 7, seed=3),
                 tdata.synth_city_graph(9, 7, seed=3)),
        "road": (jdata.synth_road_network(3000, seed=0),
                 tdata.synth_road_network(3000, seed=0)),
    }


@pytest.fixture(scope="module")
def graph_pairs():
    return _graph_pairs()


@pytest.mark.parametrize("name", ["synth-city.xy", "city", "road"])
def test_graph_arrays_identical(graph_pairs, name):
    jg, tg = graph_pairs[name]
    assert (jg.n, jg.m, jg.max_out_degree) == (tg.n, tg.m, tg.max_out_degree)
    for attr in ("xs", "ys", "src", "dst", "w", "out_ptr", "out_eid",
                 "in_ptr", "in_eid"):
        a, b = getattr(jg, attr), getattr(tg, attr)
        assert a.dtype == b.dtype, attr
        np.testing.assert_array_equal(a, b, err_msg=attr)
    for direction in ("out", "in"):
        for a, b in zip(jg.ell(direction), tg.ell(direction)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(jg.padded_weights(), tg.padded_weights())
    diff = jdata.synth_diff(jg, frac=0.2, seed=5)
    np.testing.assert_array_equal(jg.weights_with_diff(diff),
                                  tg.weights_with_diff(diff))
    perm = np.random.default_rng(1).permutation(jg.n)
    jr, tr = jg.reorder(perm), tg.reorder(perm)
    for a, b in zip(jr.ell("out"), tr.ell("out")):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["synth-city.xy", "road"])
def test_device_graph_tables_identical(graph_pairs, name):
    jg, tg = graph_pairs[name]
    jd = JDeviceGraph.from_graph(jg)
    td = DeviceGraph.from_graph(tg, device="cpu")
    assert (td.n, td.k) == (jd.n, jd.k)
    for a, b in zip(jd, td):
        assert b.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    w = tg.weights_with_diff(tdata.synth_diff(tg, seed=4))
    td2 = td.with_weights(tg.padded_weights(w))
    np.testing.assert_array_equal(
        td2.w_pad.numpy(), np.asarray(jd.with_weights(jg.padded_weights(w))
                                      .w_pad))


def test_file_formats_round_trip_across_packages(tmp_path):
    g = tdata.synth_city_graph(5, 4, seed=2)
    xy, scen, diff = (str(tmp_path / f) for f in ("g.xy", "q.scen",
                                                  "g.diff"))
    tdata.write_xy(xy, g.xs, g.ys, g.src, g.dst, g.w)
    tdata.write_scen(scen, tdata.synth_scenario(g.n, 20, seed=1))
    tdata.write_diff(diff, *tdata.synth_diff(g, seed=2))
    for a, b in zip(jdata.read_xy(xy), tdata.read_xy(xy)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(jdata.read_scen(scen),
                                  tdata.read_scen(scen))
    for a, b in zip(jdata.read_diff(diff), tdata.read_diff(diff)):
        np.testing.assert_array_equal(a, b)
    assert tdata.xy_node_count(xy) == jdata.xy_node_count(xy) == g.n
    np.testing.assert_array_equal(
        jdata.synth_scenario(g.n, 50, seed=3),
        tdata.synth_scenario(g.n, 50, seed=3))


@pytest.mark.parametrize("method,key,workers", [
    ("div", 100, 5), ("mod", 8, 8), ("mod", 32, 32),
    ("alloc", [40, 300, 432], 3), ("tpu", 8, 8),
])
def test_partition_maps_identical(method, key, workers):
    n = 432
    jd = jpart.DistributionController(method, key, workers, n,
                                      block_size=16)
    td = tpart.DistributionController(method, key, workers, n,
                                      block_size=16)
    nodes = np.arange(n)
    np.testing.assert_array_equal(jd.worker_of(nodes), td.worker_of(nodes))
    np.testing.assert_array_equal(jd.owned_index_of(nodes),
                                  td.owned_index_of(nodes))
    np.testing.assert_array_equal(jd.table(), td.table())
    for w in range(workers):
        np.testing.assert_array_equal(jd.owned(w), td.owned(w))
    assert jd.max_owned == td.max_owned
    conf = jd.format_conf()
    assert td.format_conf() == conf
    a, b = jpart.parse_conf(conf), tpart.parse_conf(conf)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    q = np.stack([nodes[::-1], nodes], axis=1)
    ga, gb = jd.group_queries(q), td.group_queries(q)
    assert ga.keys() == gb.keys()
    for k in ga:
        np.testing.assert_array_equal(ga[k], gb[k])
