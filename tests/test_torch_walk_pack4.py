"""PyTorch port, pack4 table-search walk: ``cuda_walk_batch(packed4=True)``
on CPU tensors — its plain torch walk, which reads each slot as a nibble
of the pack4 row — answers bit-identically to the TPU kernel it replaces
(``pallas_walk_batch(packed4=True)`` in interpret mode), to the JAX XLA
walk on the raw rows and to the port's raw walk: free flow, diffed
weights, move budgets, pad lanes, s==t, -1 rows, an odd node count and
the cyclic-row step bound."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)

from distributed_oracle_search_tpu.data import synth_city_graph, synth_diff  # noqa: E402
from distributed_oracle_search_tpu.data.graph import Graph as JGraph  # noqa: E402
from distributed_oracle_search_tpu.models import resident as jres  # noqa: E402
from distributed_oracle_search_tpu.ops import DeviceGraph as JDeviceGraph  # noqa: E402
from distributed_oracle_search_tpu.ops import build_fm_columns as jbuild  # noqa: E402
from distributed_oracle_search_tpu.ops import pallas_walk_batch  # noqa: E402
from distributed_oracle_search_tpu.ops import table_search as jts  # noqa: E402
from distributed_oracle_search_tpu_torch.data.graph import Graph  # noqa: E402
from distributed_oracle_search_tpu_torch.models import resident  # noqa: E402
from distributed_oracle_search_tpu_torch.ops import (  # noqa: E402
    DeviceGraph, cuda_walk_batch,
)
from distributed_oracle_search_tpu_torch.ops import table_search as tts  # noqa: E402


class Case:
    """One graph with its raw fm table and the table's pack4 form."""

    def __init__(self, g, fm: np.ndarray):
        self.g = g
        self.fm = np.array(fm)
        self.packed = resident.encode_pack4(self.fm)
        assert self.packed is not None
        np.testing.assert_array_equal(self.packed,
                                      jres.encode_pack4(self.fm))
        self.jdg = JDeviceGraph.from_graph(g)
        self.tdg = DeviceGraph.from_graph(
            Graph(g.xs, g.ys, g.src, g.dst, g.w), device="cpu")

    def run(self, queries, w=None, rows=None, valid=None, pallas=True,
            **kw):
        """Answers as numpy triples: JAX XLA walk on the raw rows, port
        pack4 walk, port raw walk[, Pallas pack4 kernel in interpret
        mode]."""
        q = np.asarray(queries, np.int64).reshape(-1, 2)
        rows = q[:, 1] if rows is None else rows
        wp = self.g.padded_weights(w)
        jw, tw = jnp.asarray(wp, jnp.int32), torch.as_tensor(wp)
        jargs = [jnp.asarray(a, jnp.int32) for a in (rows, q[:, 0], q[:, 1])]
        targs = [torch.as_tensor(np.asarray(a, np.int32))
                 for a in (rows, q[:, 0], q[:, 1])]
        jv = None if valid is None else jnp.asarray(valid)
        tv = None if valid is None else torch.as_tensor(valid)
        outs = [jts.table_search_batch(self.jdg, jnp.asarray(self.fm),
                                       *jargs, jw, valid=jv, **kw),
                cuda_walk_batch(self.tdg, torch.as_tensor(self.packed),
                                *targs, tw, valid=tv, packed4=True, **kw),
                cuda_walk_batch(self.tdg, torch.as_tensor(self.fm), *targs,
                                tw, valid=tv, **kw)]
        if pallas:
            outs.append(pallas_walk_batch(
                self.jdg, jnp.asarray(self.packed), *jargs, jw, valid=jv,
                interpret=True, packed4=True, **kw))
        return [tuple(np.asarray(a) for a in o) for o in outs]


def assert_same(outs):
    ref = outs[0]
    for o in outs[1:]:
        for a, b in zip(ref, o):
            assert a.dtype == b.dtype, (a.dtype, b.dtype)
            np.testing.assert_array_equal(a, b)


def _fm(g):
    return np.asarray(jbuild(JDeviceGraph.from_graph(g),
                             jnp.arange(g.n, dtype=jnp.int32)))


@pytest.fixture(scope="module")
def toy(toy_graph):
    return Case(toy_graph, _fm(toy_graph))


@pytest.fixture(scope="module")
def odd():
    g = synth_city_graph(5, 3)
    assert g.n % 2 == 1
    return Case(g, _fm(g))


def _queries(g, seed: int, n: int = 40):
    """Random pairs plus zero-length (s==t) and duplicate pairs."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, g.n, size=(n, 2))
    extra = np.array([[3, 3], [0, 0], q[0].tolist(), q[0].tolist(),
                      [g.n - 1, g.n - 1]], np.int64)
    return np.concatenate([q, extra], axis=0)


@pytest.fixture(scope="module")
def w_diff(toy_graph):
    return toy_graph.weights_with_diff(synth_diff(toy_graph, frac=0.2,
                                                  seed=3))


@pytest.mark.parametrize("k_moves", [-1, 0, 1, 3])
@pytest.mark.parametrize("diffed", [False, True])
def test_pack4_walk_bit_identical(toy, w_diff, k_moves, diffed):
    assert_same(toy.run(_queries(toy.g, 11), w=w_diff if diffed else None,
                        k_moves=k_moves))


@pytest.mark.parametrize("k_moves,max_steps", [(-1, 0), (3, 0), (-1, 5),
                                               (2, 5)])
def test_pack4_walk_valid_masks(toy, w_diff, k_moves, max_steps):
    """Pad lanes come back zeroed and unfinished, as in the TPU kernel."""
    q = _queries(toy.g, 12)
    valid = np.ones(len(q), bool)
    valid[::4] = False
    outs = toy.run(q, w=w_diff, valid=valid, k_moves=k_moves,
                   max_steps=max_steps)
    assert_same(outs)
    for arr in outs[1]:
        assert not arr[~valid].any()


@pytest.mark.parametrize("diffed", [False, True])
def test_pack4_walk_odd_node_count(odd, diffed):
    """The last byte of each row holds one real slot and the pad marker."""
    w = (odd.g.weights_with_diff(synth_diff(odd.g, frac=0.3, seed=1))
         if diffed else None)
    q = np.array([[s, t] for s in range(odd.g.n) for t in (odd.g.n - 1, 0)],
                 np.int64)
    outs = odd.run(q, w=w)
    assert_same(outs)
    assert outs[1][2].all()              # a strongly connected grid


def test_pack4_walk_unreachable_rows():
    n = 8
    g = JGraph(np.arange(n), np.zeros(n), np.arange(n),
               np.array([1, 2, 3, 0, 5, 6, 7, 4]), np.full(8, 10, np.int32))
    case = Case(g, _fm(g))
    q = np.array([[0, 5], [6, 2], [0, 3], [4, 7], [5, 5]], np.int64)
    outs = case.run(q)
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
def test_pack4_cyclic_row_step_bound(max_steps, k_moves, unroll, want):
    """A corrupted row that cycles 0 -> 1 -> 0 never halts: the lane
    takes exactly the loop's step bound (odd n = 11, so the row's last
    byte carries the pad marker)."""
    n = 11
    src = np.array([0, 1] + list(range(2, n - 1)))
    dst = np.array([1, 0] + list(range(3, n)))
    w = np.array([7, 9] + [1] * (n - 3), np.int32)
    g = JGraph(np.arange(n), np.zeros(n), src, dst, w)
    fm = np.full((1, n), -1, np.int8)
    fm[0, 0] = fm[0, 1] = 0
    case = Case(g, fm)
    outs = case.run(np.array([[0, n - 1], [1, n - 1]]), rows=[0, 0],
                    max_steps=max_steps, k_moves=k_moves, unroll=unroll)
    assert_same(outs)
    cost, plen, fin = outs[1]
    assert plen.tolist() == [want, want] and not fin.any()
    assert cost[0] == 7 * ((want + 1) // 2) + 9 * (want // 2)


def test_pack4_empty_batch(toy):
    outs = toy.run(np.zeros((0, 2), np.int64))
    assert_same(outs)
    assert all(a.shape == (0,) for a in outs[1])


def test_pack4_cpu_tensors_do_not_launch(toy):
    before = (cuda_walk_batch.launches, cuda_walk_batch.launches_pack4)
    toy.run(_queries(toy.g, 13), pallas=False)
    assert (cuda_walk_batch.launches,
            cuda_walk_batch.launches_pack4) == before


def test_fm_slot_reads_nibbles(toy):
    """The plain walk's slot read on packed rows equals the raw entry for
    every (row, node)."""
    r, n = toy.fm.shape
    rows = torch.arange(r).repeat_interleave(n)
    x = torch.arange(n).repeat(r)
    got = tts.fm_slot(torch.as_tensor(toy.packed), rows, x, packed4=True)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().reshape(r, n), toy.fm)
