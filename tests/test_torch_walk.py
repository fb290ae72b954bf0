"""PyTorch port, table-search walk: the walk wrapper (``cuda_walk_batch``)
on CPU tensors — its plain torch walk — answers bit-identically to the
JAX XLA walk (``table_search_batch``), to the Pallas kernel it replaces
(``pallas_walk_batch`` in interpret mode) and to the CPU reference walk,
over the cases of ``tests/test_pallas_walk.py`` plus a cyclic row that
pins the ``ceil(limit / unroll) * unroll`` step bound."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from distributed_oracle_search_tpu.data import synth_diff  # noqa: E402
from distributed_oracle_search_tpu.models import table_search_walk  # noqa: E402
from distributed_oracle_search_tpu.ops import DeviceGraph as JDeviceGraph  # noqa: E402
from distributed_oracle_search_tpu.ops import build_fm_columns as jbuild  # noqa: E402
from distributed_oracle_search_tpu.ops import pallas_walk_batch  # noqa: E402
from distributed_oracle_search_tpu.ops import table_search as jts  # noqa: E402
from distributed_oracle_search_tpu_torch.data.graph import Graph  # noqa: E402
from distributed_oracle_search_tpu_torch.ops import (  # noqa: E402
    DeviceGraph, cuda_walk_batch,
)
from distributed_oracle_search_tpu_torch.ops import table_search as tts  # noqa: E402


class Case:
    """One graph + fm table, held by both packages."""

    def __init__(self, g, fm: np.ndarray):
        self.g = g
        self.fm = np.array(fm)             # writable copy for torch
        self.jdg = JDeviceGraph.from_graph(g)
        self.tdg = DeviceGraph.from_graph(
            Graph(g.xs, g.ys, g.src, g.dst, g.w), device="cpu")

    def w_pads(self, w):
        wp = self.g.padded_weights(w)
        return jnp.asarray(wp, jnp.int32), torch.as_tensor(wp)

    def run(self, queries, w=None, rows=None, valid=None, pallas=False,
            **kw):
        """(jax, port[, pallas]) answers as numpy triples."""
        q = np.asarray(queries, np.int64).reshape(-1, 2)
        rows = q[:, 1] if rows is None else rows
        jw, tw = self.w_pads(w)
        jargs = [jnp.asarray(a, jnp.int32) for a in (rows, q[:, 0], q[:, 1])]
        targs = [torch.as_tensor(np.asarray(a, np.int32))
                 for a in (rows, q[:, 0], q[:, 1])]
        jv = None if valid is None else jnp.asarray(valid)
        tv = None if valid is None else torch.as_tensor(valid)
        outs = [jts.table_search_batch(self.jdg, jnp.asarray(self.fm),
                                       *jargs, jw, valid=jv, **kw),
                cuda_walk_batch(self.tdg, torch.as_tensor(self.fm), *targs,
                                tw, valid=tv, **kw)]
        if pallas:
            outs.append(pallas_walk_batch(self.jdg, jnp.asarray(self.fm),
                                          *jargs, jw, valid=jv,
                                          interpret=True, **kw))
        return [tuple(np.asarray(a) for a in o) for o in outs]


def assert_same(outs):
    ref = outs[0]
    for o in outs[1:]:
        for a, b in zip(ref, o):
            assert a.dtype == b.dtype, (a.dtype, b.dtype)
            np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def toy(toy_graph):
    fm = np.asarray(jbuild(JDeviceGraph.from_graph(toy_graph),
                           jnp.arange(toy_graph.n, dtype=jnp.int32)))
    return Case(toy_graph, fm)


@pytest.fixture(scope="module")
def walk_queries(toy_queries):
    """The scenario plus zero-length (s==t) and duplicate pairs."""
    q = np.asarray(toy_queries, np.int64)
    extra = np.array([[3, 3], [0, 0], q[0].tolist(), q[0].tolist(),
                      q[5].tolist()], np.int64)
    return np.concatenate([q, extra], axis=0)


@pytest.fixture(scope="module")
def w_diff(toy_graph):
    return toy_graph.weights_with_diff(synth_diff(toy_graph, frac=0.2,
                                                  seed=3))


@pytest.mark.parametrize("k_moves", [-1, 0, 1, 3])
@pytest.mark.parametrize("diffed", [False, True])
def test_bit_identical_vs_xla(toy, walk_queries, w_diff, k_moves, diffed):
    assert_same(toy.run(walk_queries, w=w_diff if diffed else None,
                        k_moves=k_moves))


@pytest.mark.parametrize("k_moves,max_steps", [(-1, 0), (3, 0), (-1, 5),
                                               (2, 5)])
def test_bit_identical_vs_pallas_interpret(toy, walk_queries, w_diff,
                                           k_moves, max_steps):
    """The TPU kernel itself (interpret mode) against the port, with
    diffed weights and pad lanes."""
    valid = np.ones(len(walk_queries), bool)
    valid[-6:] = False
    outs = toy.run(walk_queries, w=w_diff, valid=valid, pallas=True,
                   k_moves=k_moves, max_steps=max_steps)
    assert_same(outs)
    for arr in outs[1]:
        assert not arr[-6:].any()          # pad lanes zero / unfinished


@pytest.mark.parametrize("max_steps", [1, 5, 9])
def test_max_steps_and_pad_lanes(toy, walk_queries, max_steps):
    valid = np.ones(len(walk_queries), bool)
    valid[::3] = False
    assert_same(toy.run(walk_queries, valid=valid, max_steps=max_steps))


def test_parity_vs_cpu_reference(toy, walk_queries, w_diff):
    for w in (None, w_diff):
        _, (cost, plen, fin) = toy.run(walk_queries, w=w)
        for i, (s, t) in enumerate(walk_queries):
            c, p, f, _ = table_search_walk(
                toy.g, lambda x, tt: toy.fm[tt, x], int(s), int(t),
                w_query=w)
            assert (int(cost[i]), int(plen[i]), bool(fin[i])) == (c, p, f)


def test_unreachable_minus_one_rows():
    from distributed_oracle_search_tpu.data.graph import Graph as JGraph

    n = 8
    g = JGraph(np.arange(n), np.zeros(n), np.arange(n),
               np.array([1, 2, 3, 0, 5, 6, 7, 4]), np.full(8, 10, np.int32))
    fm = np.asarray(jbuild(JDeviceGraph.from_graph(g),
                           jnp.arange(n, dtype=jnp.int32)))
    case = Case(g, fm)
    queries = np.array([[0, 5], [6, 2], [0, 3], [4, 7], [5, 5]], np.int64)
    outs = case.run(queries)
    assert_same(outs)
    cost, plen, fin = outs[1]
    assert not fin[0] and plen[0] == 0
    assert fin[2] and cost[2] == 30


@pytest.mark.parametrize("max_steps,k_moves,unroll,want", [
    (0, -1, 8, 16),       # unlimited: ceil(11 / 8) * 8 steps, not 11
    (0, -1, 4, 12),       # ceil(11 / 4) * 4
    (0, 5, 8, 5),         # k_moves budget
    (13, -1, 8, 13),      # max_steps budget
    (3, 7, 8, 7),         # k_moves wins over max_steps, loop runs 8
])
def test_cyclic_row_step_bound(max_steps, k_moves, unroll, want):
    """A corrupted row that cycles 0 -> 1 -> 0 never halts: the lane
    takes exactly the loop's step bound (weights 7 and 9: the cost pins
    the step count too)."""
    from distributed_oracle_search_tpu.data.graph import Graph as JGraph

    n = 11
    src = np.array([0, 1] + list(range(2, n - 1)))
    dst = np.array([1, 0] + list(range(3, n)))
    w = np.array([7, 9] + [1] * (n - 3), np.int32)
    g = JGraph(np.arange(n), np.zeros(n), src, dst, w)
    fm = np.full((1, n), -1, np.int8)
    fm[0, 0] = fm[0, 1] = 0           # each node's only out-slot
    case = Case(g, fm)
    outs = case.run(np.array([[0, n - 1], [1, n - 1]]), rows=[0, 0],
                    max_steps=max_steps, k_moves=k_moves, unroll=unroll)
    assert_same(outs)
    cost, plen, fin = outs[1]
    assert plen.tolist() == [want, want] and not fin.any()
    assert cost[0] == 7 * ((want + 1) // 2) + 9 * (want // 2)


def test_empty_batch(toy):
    outs = toy.run(np.zeros((0, 2), np.int64))
    assert_same(outs)
    assert all(a.shape == (0,) for a in outs[1])


def test_cpu_tensors_do_not_launch(toy, walk_queries):
    before = cuda_walk_batch.launches
    toy.run(walk_queries)
    assert cuda_walk_batch.launches == before


@pytest.mark.parametrize("k", [1, 4, 12])
def test_extract_paths_identical(toy, walk_queries, k):
    q = walk_queries
    jn, jm = jts.extract_paths(toy.jdg, jnp.asarray(toy.fm),
                               *(jnp.asarray(a, jnp.int32)
                                 for a in (q[:, 1], q[:, 0], q[:, 1])), k=k)
    tn, tm = tts.extract_paths(toy.tdg, torch.as_tensor(toy.fm),
                               *(torch.as_tensor(a.astype(np.int32))
                                 for a in (q[:, 1], q[:, 0], q[:, 1])), k=k)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


@pytest.mark.parametrize("q", [0, 1, 7, 97, 4099, 65536])
@pytest.mark.parametrize("n_buckets", [0, 1, 3, 64])
def test_pick_buckets_identical(q, n_buckets):
    assert tts.pick_buckets(q, n_buckets) == jts.pick_buckets(q, n_buckets)
