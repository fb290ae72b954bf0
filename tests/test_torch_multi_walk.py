"""PyTorch port, the fused multi-diff walk: the port's plain
``table_search_multi`` against the JAX package's (jitted XLA, the stage
the card's K4 kernel serves) on the same fm rows, lanes and weights, made
from numpy seeds. Held exactly (no tolerance: integer sums): D = 1, 2, 3
weight sets, ``valid`` masks, targets a lane cannot reach (sinks in the
graph), ``max_steps`` 0, 1 and 5; row d equals the port's single walk
under weight set d; the wrapper ``cuda_walk_multi`` takes the plain walk
on CPU tensors and counts it; the edge-id pair table's layout. The card
case (K4 against the plain walk on CUDA tensors) is in
``test_torch_cuda_serving.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)

import jax.numpy as jnp  # noqa: E402

from distributed_oracle_search_tpu.data import Graph as JGraph  # noqa: E402
from distributed_oracle_search_tpu.ops import DeviceGraph as JDG  # noqa: E402
from distributed_oracle_search_tpu.ops.table_search import (  # noqa: E402
    table_search_multi as j_multi,
)
from distributed_oracle_search_tpu_torch.data import (  # noqa: E402
    Graph, synth_city_graph, synth_road_network,
)
from distributed_oracle_search_tpu_torch.ops import (  # noqa: E402
    DeviceGraph, build_fm_columns, cuda_walk_multi, table_search_batch,
    table_search_multi,
)
from distributed_oracle_search_tpu_torch.ops.table_search import (  # noqa: E402
    walk_eid_pairs, weights_t, weights_width,
)


def _graph(kind: str, seed: int) -> Graph:
    """A small city grid, or a road graph whose every 7th node keeps no
    out-edge (a sink: no target but itself is reachable from it)."""
    if kind == "city":
        return synth_city_graph(7, 6, seed=seed)
    g = synth_road_network(300, seed=seed)
    keep = g.src % 7 != 3
    return Graph(g.xs, g.ys, g.src[keep], g.dst[keep], g.w[keep])


def _case(kind: str, seed: int, d: int):
    g = _graph(kind, seed)
    rng = np.random.default_rng(seed)
    targets = np.sort(rng.choice(g.n, min(g.n, 40), replace=False)
                      ).astype(np.int32)
    dg = DeviceGraph.from_graph(g, device="cpu")
    fm = build_fm_columns(dg, targets).numpy()
    q = 257
    s = rng.integers(0, g.n, q).astype(np.int32)
    rows = rng.integers(0, len(targets), q).astype(np.int32)
    t = targets[rows]
    s[:5] = t[:5]                                   # zero-length lanes
    valid = rng.random(q) > 0.15
    w_pads = np.stack([g.padded_weights(
        None if i == 0 else (g.w * rng.uniform(1.0, 4.0, g.m)).astype(
            np.int32)) for i in range(d)]).astype(np.int32)
    return g, fm, rows, s, t, valid, w_pads


@pytest.mark.parametrize("max_steps", [0, 1, 5])
@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("kind", ["city", "sinks"])
def test_multi_walk_equals_jax(kind, d, max_steps):
    g, fm, rows, s, t, valid, w_pads = _case(kind, 11 + d, d)
    jg = JGraph(g.xs, g.ys, g.src, g.dst, g.w)
    want = j_multi(JDG.from_graph(jg), jnp.asarray(fm), jnp.asarray(rows),
                   jnp.asarray(s), jnp.asarray(t), jnp.asarray(w_pads),
                   valid=jnp.asarray(valid), max_steps=max_steps)
    dg = DeviceGraph.from_graph(g, device="cpu")
    got = table_search_multi(
        dg, torch.from_numpy(fm), torch.from_numpy(rows),
        torch.from_numpy(s), torch.from_numpy(t), torch.from_numpy(w_pads),
        valid=torch.from_numpy(valid), max_steps=max_steps)
    assert got[0].shape == (d, len(s)) and got[0].dtype == torch.int32
    assert got[1].dtype == torch.int32 and got[2].dtype == torch.bool
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if kind == "sinks" and max_steps == 0:
        fin = got[2].numpy()
        assert (~fin & valid).any() and (fin & valid).any()


@pytest.mark.parametrize("max_steps", [0, 5])
def test_multi_rows_equal_single_walks(max_steps):
    g, fm, rows, s, t, valid, w_pads = _case("sinks", 3, 3)
    dg = DeviceGraph.from_graph(g, device="cpu")
    args = (dg, torch.from_numpy(fm), torch.from_numpy(rows),
            torch.from_numpy(s), torch.from_numpy(t))
    v = torch.from_numpy(valid)
    cost, plen, fin = table_search_multi(*args, torch.from_numpy(w_pads),
                                         valid=v, max_steps=max_steps)
    for i in range(3):
        c1, p1, f1 = table_search_batch(*args, torch.from_numpy(w_pads[i]),
                                        valid=v, max_steps=max_steps)
        assert torch.equal(cost[i], c1)
        assert torch.equal(plen, p1) and torch.equal(fin, f1)


def test_wrapper_takes_plain_walk_on_cpu():
    g, fm, rows, s, t, valid, w_pads = _case("city", 5, 2)
    dg = DeviceGraph.from_graph(g, device="cpu")
    args = (dg, torch.from_numpy(fm), torch.from_numpy(rows),
            torch.from_numpy(s), torch.from_numpy(t),
            torch.from_numpy(w_pads))
    before = (cuda_walk_multi.plain, cuda_walk_multi.launches)
    got = cuda_walk_multi(*args, valid=torch.from_numpy(valid))
    want = table_search_multi(*args, valid=torch.from_numpy(valid))
    assert (cuda_walk_multi.plain, cuda_walk_multi.launches) == (
        before[0] + 1, before[1])
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    meta = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no walk"):
        cuda_walk_multi(dg, args[1], meta, meta, meta, args[5])


def test_eid_pairs_layout():
    g = synth_road_network(200, seed=2)
    dg = DeviceGraph.from_graph(g, device="cpu")
    pair = walk_eid_pairs(dg)
    kp = dg.k + -dg.k % 4
    assert pair.shape == (2, g.n, kp) and pair.dtype == torch.int32
    assert pair.is_contiguous()
    assert torch.equal(pair[0, :, :dg.k], dg.out_nbr)
    assert torch.equal(pair[1, :, :dg.k], dg.out_eid)
    assert (pair[1, :, dg.k:] == g.m).all()
    w_pads = torch.from_numpy(np.stack([g.padded_weights()] * 3))
    w_t = weights_t(w_pads)
    assert w_t.shape == (g.m + 1, 3) and w_t.is_contiguous()


@pytest.mark.parametrize("d", [1, 4, 5, 8, 9, 17, 33])
def test_padded_weights_t_layout(d):
    """The fused walk kernel's weights: ``[M+1, dp]``, the weight of edge
    e under set i at ``[e, i]``, zero past D; dp is D rounded up to 8."""
    g = synth_road_network(200, seed=2)
    rng = np.random.default_rng(d)
    w_pads = torch.from_numpy(np.stack([g.padded_weights(
        (g.w * rng.uniform(1.0, 3.0, g.m)).astype(np.int32))
        for _ in range(d)]).astype(np.int32))
    dp = weights_width(d)
    assert dp == -(-d // 8) * 8
    w_t = weights_t(w_pads, dp)
    assert w_t.shape == (g.m + 1, dp) and w_t.dtype == torch.int32
    assert w_t.is_contiguous()
    assert torch.equal(w_t[:, :d], w_pads.T)
    assert (w_t[:, d:] == 0).all()
    assert torch.equal(weights_t(w_pads), w_pads.T)
