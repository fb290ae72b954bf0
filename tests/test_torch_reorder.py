"""PyTorch port, node reordering: ``Graph.bfs_order``/``rcm_order`` and
the ``cli.reorder`` tool against the JAX package's. Held equal, exactly:
the permutations element by element (several BFS starts; road, city,
one-way and multi-component graphs), the tool's output files byte for
byte (``.xy``, ``.order``, ``.scen``, two ``.diff``s; order given as
``bfs``, ``rcm`` and a file), and the build kind ``pick_build_kernel``
resolves before and after a reorder. The campaign's ``--order`` refusal
names the port's reorder tool."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)

from distributed_oracle_search_tpu.cli import reorder as j_reorder  # noqa: E402
from distributed_oracle_search_tpu.data.graph import Graph as JGraph  # noqa: E402
from distributed_oracle_search_tpu.models.cpd import (  # noqa: E402
    pick_build_kernel as j_pick,
)
from distributed_oracle_search_tpu_torch.cli import reorder as t_reorder  # noqa: E402
from distributed_oracle_search_tpu_torch.cli import process_query as t_pq  # noqa: E402
from distributed_oracle_search_tpu_torch.cli.args import parse_args  # noqa: E402
from distributed_oracle_search_tpu_torch.data import (  # noqa: E402
    Graph, synth_city_graph, synth_diff, synth_road_network, synth_scenario,
    write_diff, write_scen, write_xy,
)
from distributed_oracle_search_tpu_torch.models.cpd import (  # noqa: E402
    pick_build_kernel,
)
from distributed_oracle_search_tpu_torch.ops import frontier_relax  # noqa: E402
from distributed_oracle_search_tpu_torch.ops.device_graph import (  # noqa: E402
    DeviceGraph,
)
from distributed_oracle_search_tpu_torch.parallel.sharded import (  # noqa: E402
    chunk_compute,
)
from distributed_oracle_search_tpu_torch.utils.config import (  # noqa: E402
    ClusterConfig,
)


def _one_way(n: int = 300, seed: int = 4) -> Graph:
    """A directed ring plus random one-way chords: no edge has its
    reverse, so the ordering's symmetrization is what connects it."""
    rng = np.random.default_rng(seed)
    src = np.concatenate([np.arange(n), rng.integers(0, n, n // 2)])
    dst = np.concatenate([(np.arange(n) + 1) % n,
                          rng.integers(0, n, n // 2)])
    keep = src != dst
    xs = rng.integers(0, 1000, n).astype(np.int32)
    ys = rng.integers(0, 1000, n).astype(np.int32)
    w = rng.integers(1, 50, keep.sum()).astype(np.int32)
    return Graph(xs, ys, src[keep], dst[keep], w)


def _components() -> Graph:
    """Three components of different shapes, the ids interleaved so each
    BFS restart has to skip visited seeds."""
    parts = [synth_city_graph(6, 5, seed=1), synth_road_network(200, seed=2),
             synth_city_graph(3, 3, seed=3)]
    xs, ys, src, dst, w, off = [], [], [], [], [], 0
    for g in parts:
        xs.append(g.xs), ys.append(g.ys), w.append(g.w)
        src.append(g.src + off), dst.append(g.dst + off)
        off += g.n
    g = Graph(np.concatenate(xs), np.concatenate(ys), np.concatenate(src),
              np.concatenate(dst), np.concatenate(w))
    return g.reorder(np.random.default_rng(9).permutation(g.n))


GRAPHS = {
    "road": lambda: synth_road_network(3000, seed=0),
    "city": lambda: synth_city_graph(40, 30, seed=5),
    "one-way": _one_way,
    "components": _components,
}


def _jax_graph(g: Graph) -> JGraph:
    return JGraph(g.xs, g.ys, g.src, g.dst, g.w)


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("start", [0, 7, -1])
def test_bfs_order_equals_jax(name, start):
    g = GRAPHS[name]()
    start = start % g.n
    got = g.bfs_order(start)
    want = _jax_graph(g).bfs_order(start)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert np.array_equal(np.sort(got), np.arange(g.n))


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_rcm_order_equals_jax(name):
    g = GRAPHS[name]()
    got = g.rcm_order()
    np.testing.assert_array_equal(got, _jax_graph(g).rcm_order())
    assert np.array_equal(np.sort(got), np.arange(g.n))


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_undirected_csr_and_frontier_equal_jax(name):
    g = GRAPHS[name]()
    ptr, nbr = g._undirected_csr()
    jptr, jnbr = _jax_graph(g)._undirected_csr()
    np.testing.assert_array_equal(ptr, jptr)
    np.testing.assert_array_equal(nbr, jnbr)
    frontier = np.arange(0, g.n, 5)
    np.testing.assert_array_equal(
        Graph.frontier_neighbors(ptr, nbr, frontier),
        JGraph.frontier_neighbors(jptr, jnbr, frontier))


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("reorder-data")
    g = synth_road_network(2000, seed=3)
    xy = str(d / "road.xy")
    write_xy(xy, g.xs, g.ys, g.src, g.dst, g.w)
    scen = str(d / "road.scen")
    write_scen(scen, synth_scenario(g.n, 300, seed=4))
    diffs = []
    for k in range(2):
        p = str(d / f"c{k}.diff")
        write_diff(p, *synth_diff(g, frac=0.1, seed=5 + k))
        diffs.append(p)
    order = str(d / "given.order")
    np.savetxt(order, np.random.default_rng(6).permutation(g.n), fmt="%d")
    return d, xy, scen, diffs, order


@pytest.mark.parametrize("spec", ["bfs", "rcm", "file"])
def test_reorder_tool_files_equal_jax(dataset, spec, capsys):
    d, xy, scen, diffs, order = dataset
    spec = order if spec == "file" else spec
    outs = {}
    for name, tool in (("jax", j_reorder), ("torch", t_reorder)):
        o = d / f"out-{name}-{os.path.basename(spec)}"
        o.mkdir(exist_ok=True)
        argv = ["--input", xy, "--order", spec, "-o", str(o / "g.xy"),
                "--scen", scen, str(o / "g.scen")]
        for k, p in enumerate(diffs):
            argv += ["--diff", p, str(o / f"g{k}.diff")]
        assert tool.main(argv) == 0
        outs[name] = (o, capsys.readouterr().out)
    (jo, jout), (to, tout) = outs["jax"], outs["torch"]
    names = ["g.xy", "g.xy.order", "g.scen", "g0.diff", "g1.diff"]
    for f in names:
        with open(jo / f, "rb") as a, open(to / f, "rb") as b:
            assert a.read() == b.read(), f
    assert tout.replace(str(to), "") == jout.replace(str(jo), "")
    # the rewritten files describe the same graph, relabelled
    g = Graph.from_xy(xy)
    perm = np.loadtxt(to / "g.xy.order", dtype=np.int64)
    g2 = Graph.from_xy(str(to / "g.xy"))
    np.testing.assert_array_equal(g2.xs, g.xs[perm])


def test_reorder_order_file_of_wrong_length_raises(dataset, tmp_path):
    _, xy, _, _, _ = dataset
    bad = str(tmp_path / "short.order")
    np.savetxt(bad, np.arange(5), fmt="%d")
    with pytest.raises(ValueError, match="has 5 ids"):
        t_reorder.resolve_order(Graph.from_xy(xy), bad)


@pytest.mark.parametrize("n,order", [
    (3000, "none"), (3000, "rcm"), (32_768, "none"), (32_768, "rcm"),
    (32_768, "bfs"),
])
def test_pick_build_kernel_same_kind_as_jax(n, order):
    """The kind ``auto`` resolves follows the ids: at 32,768 road nodes
    the raw ids give ``ellsplit`` and an RCM or BFS reorder gives
    ``frontier`` — in both packages."""
    g = synth_road_network(n, seed=0)
    if order != "none":
        g = g.reorder(t_reorder.resolve_order(g, order))
    kind = pick_build_kernel(g, "auto")[0]
    assert kind == j_pick(_jax_graph(g), "auto")[0]
    if n == 32_768:
        assert kind == ("ellsplit" if order == "none" else "frontier")


@pytest.mark.parametrize("order", ["rcm", "bfs"])
def test_frontier_build_on_reordered_graph_equals_ellsplit(order):
    """The reordered cell's build: the frontier queue's table equals the
    ``ellsplit`` one byte for byte, and the queue reports its pops."""
    g = synth_road_network(1500, seed=2)
    g = g.reorder(t_reorder.resolve_order(g, order))
    dg = DeviceGraph.from_graph(g, device="cpu")
    t = torch.as_tensor(np.arange(0, g.n, 37, dtype=np.int32))
    fms = {m: chunk_compute(dg, pick_build_kernel(g, m))(t)
           for m in ("frontier", "ellsplit")}
    assert torch.equal(fms["frontier"], fms["ellsplit"])
    stats = {}
    fg = pick_build_kernel(g, "frontier")[1]
    frontier_relax.dist_to_targets_frontier(dg, fg, t, stats=stats)
    assert stats["pops"] > 0
    cut = {}
    frontier_relax.dist_to_targets_frontier(dg, fg, t, max_iters=2,
                                            stats=cut)
    assert cut["pops"] == 2


def test_order_flag_names_the_reorder_tool(dataset, tmp_path):
    _, xy, scen, _, _ = dataset
    conf = ClusterConfig(workers=["tpu"], partmethod="tpu", partkey=1,
                         outdir=str(tmp_path / "index"), xy_file=xy,
                         scenfile=scen, diffs=["-"]).validate()
    with pytest.raises(SystemExit,
                       match="distributed_oracle_search_tpu_torch.cli"
                             ".reorder"):
        t_pq.run(conf, parse_args(["--order", "rcm", "--device", "cpu"]))
