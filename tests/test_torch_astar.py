"""PyTorch port, the heap A* (``models/astar.py``, a copy of the JAX
package's): on the same graph and queries its cost, plen, finished and
``AstarStats`` equal JAX ``models.astar``'s exactly, over hscale, fscale
and diff weights; ``min_cost_per_unit`` is equal."""

import numpy as np
import pytest
import torch_threads  # noqa: E402,F401  (one intra-op thread)

from distributed_oracle_search_tpu.data import Graph as JGraph  # noqa: E402
from distributed_oracle_search_tpu.data import read_diff as j_read_diff  # noqa: E402
from distributed_oracle_search_tpu.models.astar import (  # noqa: E402
    AstarStats as JAstarStats, astar as j_astar, min_cost_per_unit as j_mcpu,
)
from distributed_oracle_search_tpu_torch.data import (  # noqa: E402
    Graph, ensure_synth_dataset, read_diff, read_scen, synth_road_network,
)
from distributed_oracle_search_tpu_torch.models import (  # noqa: E402
    AstarStats, astar, dist_to_target, min_cost_per_unit,
)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("astar-data"))
    paths = ensure_synth_dataset(d, width=9, height=7, n_queries=48,
                                 seed=41)
    return (Graph.from_xy(paths["xy"]), JGraph.from_xy(paths["xy"]),
            read_scen(paths["scen"]), paths["diff"])


def _run(fn, stats_cls, g, queries, **kw):
    st = stats_cls()
    out = [fn(g, int(s), int(t), stats=st, **kw) for s, t in queries]
    return out, st


@pytest.mark.parametrize("hscale,fscale", [
    (1.0, 0.0), (0.7, 0.0), (1.5, 0.0), (1.0, 0.1), (1.5, 0.5), (3.0, 0.1),
])
@pytest.mark.parametrize("diff", [False, True], ids=["free", "diff"])
def test_heap_astar_equals_jax(dataset, hscale, fscale, diff):
    g, jg, queries, diff_path = dataset
    w = g.weights_with_diff(read_diff(diff_path)) if diff else None
    jw = jg.weights_with_diff(j_read_diff(diff_path)) if diff else None
    cpu = min_cost_per_unit(g, w)
    assert cpu == j_mcpu(jg, jw)
    got, st = _run(astar, AstarStats, g, queries, w=w, hscale=hscale,
                   fscale=fscale, cpu=cpu)
    want, jst = _run(j_astar, JAstarStats, jg, queries, w=jw,
                     hscale=hscale, fscale=fscale)
    assert got == want
    assert vars(st) == vars(jst)
    assert st.finished == len(queries) and st.n_expanded > 0


def test_heap_astar_optimal_at_hscale_1(dataset):
    g, _, queries, _ = dataset
    for s, t in queries[:12]:
        cost, plen, fin = astar(g, int(s), int(t))
        assert fin and cost == dist_to_target(g, int(t))[int(s)]
        assert plen >= (s != t)


def test_min_cost_per_unit_equals_jax_on_road():
    g = synth_road_network(2048, seed=3)
    jg = JGraph(g.xs, g.ys, g.src, g.dst, g.w)
    assert min_cost_per_unit(g) == j_mcpu(jg)
    w = g.w * 3 + 1
    assert min_cost_per_unit(g, w) == j_mcpu(jg, w)
    flat = Graph(np.zeros(2), np.zeros(2), [0], [1], [5])
    assert min_cost_per_unit(flat) == 0.0


def test_stats_add_in_place():
    a = AstarStats(n_expanded=2, plen=3, finished=1)
    a += AstarStats(n_expanded=5, n_touched=7, finished=1)
    assert vars(a) == vars(AstarStats(n_expanded=7, n_touched=7, plen=3,
                                      finished=2))
