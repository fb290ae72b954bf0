"""PyTorch port, the walk's pair table built once per weight set: the
plain walk and the walk wrapper given ``pair=walk_pairs(dg, w)`` answer
exactly as without it — raw and pack4, on a grid and on a road graph
whose walks take out-slots >= 4 and >= 8 — and as the JAX XLA walk on the
same numpy-seeded inputs. ``ShardEngine`` keeps one pair table per cached
weight vector: the same tensor across calls with one diff, a new one
after LRU eviction and under ``no_cache``, passed to every walk call
(each ns-budget chunk included), with answers equal to the JAX engine's
on ``data/index``."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)

from distributed_oracle_search_tpu.data import Graph as JGraph  # noqa: E402
from distributed_oracle_search_tpu.data import read_scen  # noqa: E402
from distributed_oracle_search_tpu.data import synth_city_graph, synth_diff  # noqa: E402
from distributed_oracle_search_tpu.data import synth_road_network  # noqa: E402
from distributed_oracle_search_tpu.ops import DeviceGraph as JDeviceGraph  # noqa: E402
from distributed_oracle_search_tpu.ops import build_fm_columns as jbuild  # noqa: E402
from distributed_oracle_search_tpu.ops import table_search as jts  # noqa: E402
from distributed_oracle_search_tpu.parallel.partition import (  # noqa: E402
    DistributionController as JDC,
)
from distributed_oracle_search_tpu.transport.wire import (  # noqa: E402
    RuntimeConfig as JConfig,
)
from distributed_oracle_search_tpu.worker.engine import (  # noqa: E402
    ShardEngine as JEngine,
)
from distributed_oracle_search_tpu_torch.data import Graph  # noqa: E402
from distributed_oracle_search_tpu_torch.data import write_diff  # noqa: E402
from distributed_oracle_search_tpu_torch.models.resident import encode_pack4  # noqa: E402
from distributed_oracle_search_tpu_torch.ops import (  # noqa: E402
    DeviceGraph, cuda_walk_batch,
)
from distributed_oracle_search_tpu_torch.ops.table_search import (  # noqa: E402
    table_search_batch, walk_pairs,
)
from distributed_oracle_search_tpu_torch.parallel import (  # noqa: E402
    DistributionController,
)
from distributed_oracle_search_tpu_torch.transport import RuntimeConfig  # noqa: E402
from distributed_oracle_search_tpu_torch.worker import engine as eng  # noqa: E402

DATA = os.path.join(os.path.dirname(os.path.dirname(__file__)), "data")
INDEX = os.path.join(DATA, "index")
XY = os.path.join(DATA, "synth-city.xy")
DIFF = os.path.join(DATA, "synth-city.xy.diff")


class Case:
    """A graph, the first-move rows of some targets (JAX build) and
    their pack4 form where every slot fits a nibble."""

    def __init__(self, g, targets: np.ndarray):
        self.g = g
        self.targets = np.asarray(targets, np.int32)
        self.fm = np.array(jbuild(JDeviceGraph.from_graph(g),
                                  jnp.asarray(self.targets)))
        self.packed = encode_pack4(self.fm)
        self.jdg = JDeviceGraph.from_graph(g)
        self.tdg = DeviceGraph.from_graph(
            Graph(g.xs, g.ys, g.src, g.dst, g.w), device="cpu")

    def queries(self, seed: int, n: int = 200):
        """Row, source and target per query: random sources towards the
        case's targets, with s == t lanes."""
        rng = np.random.default_rng(seed)
        rows = rng.integers(0, len(self.targets), n).astype(np.int32)
        s = rng.integers(0, self.g.n, n).astype(np.int32)
        t = self.targets[rows]
        s[:4] = t[:4]
        return rows, s, t

    def slots_taken(self, rows, s, t) -> np.ndarray:
        """Every out-slot the walks of these queries move through."""
        nbr, _ = self.g.ell("out")
        taken = []
        for r, x, tt in zip(rows, s, t):
            for _ in range(self.g.n):
                slot = int(self.fm[r, x])
                if slot < 0 or x == tt:
                    break
                taken.append(slot)
                x = int(nbr[x, slot])
        return np.asarray(taken)

    def run(self, rows, s, t, w=None, packed4=False, **kw):
        """(JAX XLA walk on the raw rows, port walk building its pairs,
        port walk given them, wrapper given them) as numpy triples."""
        wp = self.g.padded_weights(w)
        tw = torch.as_tensor(wp)
        targs = [torch.as_tensor(a) for a in (rows, s, t)]
        table = torch.as_tensor(self.packed if packed4 else self.fm)
        pair = walk_pairs(self.tdg, tw)
        outs = [jts.table_search_batch(
                    self.jdg, jnp.asarray(self.fm),
                    *(jnp.asarray(a) for a in (rows, s, t)),
                    jnp.asarray(wp, jnp.int32), **kw),
                table_search_batch(self.tdg, table, *targs, tw,
                                   packed4=packed4, **kw),
                table_search_batch(self.tdg, table, *targs, tw,
                                   packed4=packed4, pair=pair, **kw),
                cuda_walk_batch(self.tdg, table, *targs, tw,
                                packed4=packed4, pair=pair, **kw)]
        return [tuple(np.asarray(a) for a in o) for o in outs]


def assert_same(outs):
    for o in outs[1:]:
        for a, b in zip(outs[0], o):
            assert a.dtype == b.dtype, (a.dtype, b.dtype)
            np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def grid():
    g = synth_city_graph(9, 7, seed=5)
    return Case(g, np.arange(g.n))


def _road_targets(g) -> np.ndarray:
    rng = np.random.default_rng(0)
    return np.sort(rng.choice(g.n, 48, replace=False))


@pytest.fixture(scope="module")
def road():
    """A road graph of a few thousand nodes (out-degree up to 18): walks
    take slots past the first 4 and the first 8."""
    g = synth_road_network(3000, seed=0)
    assert g.max_out_degree > 8
    return Case(g, _road_targets(g))


@pytest.fixture(scope="module")
def road13():
    """The same road graph with each node's out-edges past its first 13
    dropped, so every slot fits a pack4 nibble; slots >= 8 remain."""
    g = synth_road_network(3000, seed=0)
    _, eid = g.ell("out")
    keep = np.sort(eid[:, :13][eid[:, :13] < g.m])
    g13 = JGraph(g.xs, g.ys, g.src[keep], g.dst[keep], g.w[keep])
    case = Case(g13, _road_targets(g13))
    assert case.packed is not None
    return case


@pytest.mark.parametrize("packed4", [False, True])
@pytest.mark.parametrize("k_moves", [-1, 0, 1, 5])
@pytest.mark.parametrize("diffed", [False, True])
def test_grid_pair_given_equals_built(grid, packed4, k_moves, diffed):
    w = (grid.g.weights_with_diff(synth_diff(grid.g, frac=0.3, seed=2))
         if diffed else None)
    outs = grid.run(*grid.queries(seed=1), w=w, packed4=packed4,
                    k_moves=k_moves)
    assert_same(outs)
    assert outs[1][2][4:].any()


@pytest.mark.parametrize("packed4", [False, True])
@pytest.mark.parametrize("k_moves", [-1, 0, 1, 5])
@pytest.mark.parametrize("diffed", [False, True])
def test_road_pair_given_equals_built(road, road13, packed4, k_moves,
                                     diffed):
    case = road13 if packed4 else road
    w = (case.g.weights_with_diff(synth_diff(case.g, frac=0.2, seed=4))
         if diffed else None)
    outs = case.run(*case.queries(seed=3), w=w, packed4=packed4,
                    k_moves=k_moves)
    assert_same(outs)
    if k_moves < 0 and not packed4:
        assert outs[1][2].all()                 # a strongly connected graph


@pytest.mark.parametrize("capped", [False, True])
def test_road_walks_take_high_slots(road, road13, capped):
    """The road cases exercise the head of a pair row and past it."""
    case = road13 if capped else road
    taken = case.slots_taken(*case.queries(seed=3))
    assert (taken >= 4).sum() > 0 and (taken >= 8).sum() > 0
    assert taken.max() < (13 if capped else case.g.max_out_degree)


@pytest.fixture(scope="module")
def road19():
    """A road graph whose widest node has 19 out-edges: an ELL width that
    the pair table pads to 20."""
    g = synth_road_network(4000, seed=0)
    assert g.max_out_degree % 4
    return Case(g, _road_targets(g))


@pytest.mark.parametrize("which", ["road", "road19", "grid"])
def test_walk_pairs_layout(road, road19, grid, which):
    """Planar int32 ``[2, N, K']``: ``pair[0, x, j] = out_nbr[x, j]``,
    ``pair[1, x, j] = w[out_eid[x, j]]``, ``K'`` the ELL width rounded up
    to a multiple of 4; ELL padding slots, and the slots the rounding
    adds, point at x itself with the INF weight."""
    case = {"road": road, "road19": road19, "grid": grid}[which]
    g = case.g
    w = torch.as_tensor(g.padded_weights())
    pair = walk_pairs(case.tdg, w)
    nbr, eid = g.ell("out")
    k = nbr.shape[1]
    kp = -(-k // 4) * 4
    assert pair.dtype == torch.int32 and pair.is_contiguous()
    assert tuple(pair.shape) == (2, g.n, kp)
    np.testing.assert_array_equal(pair[0, :, :k].numpy(), nbr)
    np.testing.assert_array_equal(pair[1, :, :k].numpy(), w.numpy()[eid])
    pad = eid == g.m
    assert (nbr[pad] == np.nonzero(pad)[0]).all()
    np.testing.assert_array_equal(
        pair[0, :, k:].numpy(), np.repeat(np.arange(g.n)[:, None], kp - k, 1))
    assert (pair[1, :, k:] == w[-1]).all()


@pytest.mark.parametrize("k_moves", [-1, 0, 1, 5])
def test_odd_width_pair_given_equals_built(road19, k_moves):
    outs = road19.run(*road19.queries(seed=5), k_moves=k_moves)
    assert_same(outs)


# ------------------------------------------------------------- engine
@pytest.fixture(scope="module")
def setup():
    jg, tg = JGraph.from_xy(XY), Graph.from_xy(XY)
    tdc = DistributionController("tpu", 8, 8, tg.n)
    groups = tdc.group_queries(read_scen(os.path.join(DATA, "synth.scen")))
    return jg, tg, JDC("tpu", 8, 8, jg.n), tdc, groups


@pytest.fixture
def recorded(monkeypatch):
    """The ``pair`` of every walk call the engine makes."""
    seen = []
    real = eng.cuda_walk_batch

    def walk(*a, **kw):
        seen.append(kw["pair"])
        return real(*a, **kw)

    monkeypatch.setattr(eng, "cuda_walk_batch", walk)
    return seen


@pytest.mark.parametrize("difffile", ["-", DIFF])
def test_engine_keeps_one_pair_table_per_diff(setup, recorded, difffile):
    jg, tg, jdc, tdc, groups = setup
    te = eng.ShardEngine(tg, tdc, 3, INDEX, device="cpu")
    je = JEngine(jg, jdc, 3, INDEX)
    want = je.answer(groups[3], JConfig(), difffile)
    for _ in range(2):
        got = te.answer(groups[3], RuntimeConfig(), difffile)
        for a, b in zip(want[:3], got[:3]):
            np.testing.assert_array_equal(a, b)
    assert len(recorded) == 2 and recorded[0] is recorded[1]
    w_pad, pair = te._weight_cache[difffile]
    assert pair is recorded[0]
    torch.testing.assert_close(pair, walk_pairs(te.dg, w_pad), rtol=0,
                               atol=0)


def test_engine_pair_table_evicted_with_its_weights(setup, recorded,
                                                    tmp_path, monkeypatch):
    _, tg, _, tdc, groups = setup
    monkeypatch.setenv("DOS_TRAFFIC_WEIGHT_EPOCHS", "2")
    te = eng.ShardEngine(tg, tdc, 0, INDEX, device="cpu")
    diffs = []
    for seed in range(3):
        p = str(tmp_path / f"d{seed}.diff")
        write_diff(p, *synth_diff(tg, frac=0.3, seed=seed))
        diffs.append(p)
    first = te.answer(groups[0], RuntimeConfig(), diffs[0])[0]
    te.answer(groups[0], RuntimeConfig(), diffs[1])
    te.answer(groups[0], RuntimeConfig(), diffs[1])
    assert recorded[1] is recorded[2] and recorded[0] is not recorded[1]
    te.answer(groups[0], RuntimeConfig(), diffs[2])    # evicts diffs[0]
    assert list(te._weight_cache) == diffs[1:]
    again = te.answer(groups[0], RuntimeConfig(), diffs[0])[0]
    np.testing.assert_array_equal(again, first)
    assert recorded[-1] is not recorded[0]
    assert all(recorded[-1] is not p for p in recorded[:-1])


def test_engine_no_cache_builds_pairs_per_call(setup, recorded):
    _, tg, _, tdc, groups = setup
    te = eng.ShardEngine(tg, tdc, 4, INDEX, device="cpu")
    a = te.answer(groups[4], RuntimeConfig(), DIFF)
    b = te.answer(groups[4], RuntimeConfig(no_cache=True), DIFF)
    c = te.answer(groups[4], RuntimeConfig(no_cache=True), DIFF)
    assert not te._weight_cache
    assert len({id(p) for p in recorded}) == 3
    for x, y in zip(a[:3], b[:3]):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(a[:3], c[:3]):
        np.testing.assert_array_equal(x, y)


def test_engine_ns_budget_chunks_share_the_pair_table(setup, recorded):
    """Under an ns budget each deadline-checked chunk walks with the one
    pair table of the batch's weight set."""
    jg, tg, jdc, tdc, groups = setup
    te = eng.ShardEngine(tg, tdc, 2, INDEX, device="cpu")
    je = JEngine(jg, jdc, 2, INDEX)
    te.time_chunk = je.astar_chunk = 16
    cfg = {"time": 10 ** 13, "k_moves": 4}
    want = je.answer(groups[2], JConfig(**cfg), DIFF)
    got = te.answer(groups[2], RuntimeConfig(**cfg), DIFF)
    for a, b in zip(want[:3], got[:3]):
        np.testing.assert_array_equal(a, b)
    assert len(recorded) > 1
    assert all(p is recorded[0] for p in recorded)
    assert recorded[0] is te._weight_cache[DIFF][1]
