"""PyTorch port, walk kernels on the card: the raw and pack4 CUDA walks
(``csrc/table_search_walk.cu``) answer bit-identically to the plain torch
walk on the same CUDA tensors — grids (an odd node count among them),
road graphs whose walks take out-slots past the head the kernel reads
with each move, move budgets of 0 and 1, a corrupted cyclic row that
runs to the exact step bound, and a pair table passed in or built by the
wrapper — each launch is counted under its variant, and the wrapper
refuses a table of the wrong type or width. A raw table past 2^31 bytes
is walked from rows beyond that offset, and the whole-index oracle
(``CPDOracle``, every worker's rows in one walk) answers on the card as
on the CPU.

Needs an NVIDIA GPU and ``nvcc``; skips without them. This file imports
the port only (no JAX), so it runs on a machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_walk.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)

from distributed_oracle_search_tpu_torch.data import (  # noqa: E402
    Graph, synth_city_graph, synth_road_network,
)
from distributed_oracle_search_tpu_torch.models.cpd import CPDOracle  # noqa: E402
from distributed_oracle_search_tpu_torch.models.resident import encode_pack4  # noqa: E402
from distributed_oracle_search_tpu_torch.ops import (  # noqa: E402
    DeviceGraph, build_fm_columns, cuda_walk_batch, table_search_batch,
)
from distributed_oracle_search_tpu_torch.ops.table_search import (  # noqa: E402
    walk_pairs,
)
from distributed_oracle_search_tpu_torch.parallel import (  # noqa: E402
    DistributionController,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _road(n: int, seed: int, cap: int = 0) -> Graph:
    """``synth_road_network(n)``; ``cap`` > 0 keeps each node's first
    ``cap`` out-edges only, so every first-move slot fits a nibble."""
    g = synth_road_network(n, seed=seed)
    if cap:
        _, eid = g.ell("out")
        keep = np.sort(eid[:, :cap][eid[:, :cap] < g.m])
        g = Graph(g.xs, g.ys, g.src[keep], g.dst[keep], g.w[keep])
    return g


def _case(width: int, height: int, dev, seed: int, road_cap: int = -1):
    """A grid of ``width`` x ``height``, or with ``road_cap`` >= 0 a road
    graph of ``width * height`` nodes (out-degree capped when > 0): the
    first-move rows of 96 targets and 512 lanes towards them."""
    if road_cap >= 0:
        g = _road(width * height, seed, road_cap)
        targets = np.sort(np.random.default_rng(seed).choice(
            g.n, 96, replace=False)).astype(np.int32)
    else:
        g = synth_city_graph(width, height, seed=seed)
        targets = np.arange(g.n, dtype=np.int32)
    fm = build_fm_columns(DeviceGraph.from_graph(g, device="cpu"),
                          targets).numpy()
    rng = np.random.default_rng(seed)
    q = 512
    s = rng.integers(0, g.n, q).astype(np.int32)
    rows = rng.integers(0, len(targets), q).astype(np.int32)
    t = targets[rows]
    s[:8] = t[:8]                                  # zero-length lanes
    valid = rng.random(q) > 0.1
    w = (g.w * rng.uniform(1.0, 3.0, len(g.w))).astype(np.int32)
    on = {"dg": DeviceGraph.from_graph(g, device=dev),
          "rows": torch.as_tensor(rows, device=dev),
          "s": torch.as_tensor(s, device=dev),
          "t": torch.as_tensor(t, device=dev),
          "valid": torch.as_tensor(valid, device=dev),
          "w": torch.as_tensor(g.padded_weights(w), dtype=torch.int32,
                               device=dev)}
    return g, fm, on


#: (shape, road_cap): grids — (5, 3) has an odd node count, so each
#: packed row's last byte holds a pad nibble — and road graphs of 40 x 50
#: nodes, whole (out-degree up to 18, raw only: slots past 14 do not fit
#: a nibble) or capped at 13 out-edges (pack4)
CASES = [((8, 6), -1), ((5, 3), -1), ((33, 21), -1), ((40, 50), 0),
         ((40, 50), 13)]


@pytest.mark.parametrize("packed4", [False, True])
@pytest.mark.parametrize("shape,road_cap", CASES)
@pytest.mark.parametrize("k_moves", [-1, 0, 1, 3])
@pytest.mark.parametrize("given_pair", [False, True])
def test_kernel_equals_plain_walk(dev, packed4, shape, road_cap, k_moves,
                                  given_pair):
    if packed4 and road_cap == 0:
        pytest.skip("the whole road graph has slots past a nibble")
    g, fm, on = _case(*shape, dev, seed=shape[0], road_cap=road_cap)
    table = encode_pack4(fm) if packed4 else fm
    assert table is not None
    table = torch.as_tensor(table, device=dev)
    args = (on["dg"], table, on["rows"], on["s"], on["t"], on["w"])
    kw = {"valid": on["valid"], "k_moves": k_moves, "packed4": packed4}
    if given_pair:
        kw["pair"] = walk_pairs(on["dg"], on["w"])
    before = (cuda_walk_batch.launches, cuda_walk_batch.launches_pack4)
    ker = cuda_walk_batch(*args, **kw)
    torch.cuda.synchronize()
    plain = table_search_batch(*args, **{k: v for k, v in kw.items()
                                         if k != "pair"})
    for a, b in zip(ker, plain):
        assert a.dtype == b.dtype and torch.equal(a, b)
    if k_moves != 0:
        assert ker[2][on["valid"]].any()
    assert int(ker[1].max()) <= (k_moves if k_moves >= 0 else g.n)
    after = (cuda_walk_batch.launches, cuda_walk_batch.launches_pack4)
    assert after == ((before[0], before[1] + 1) if packed4
                     else (before[0] + 1, before[1]))


@pytest.mark.parametrize("packed4", [False, True])
def test_road_walks_leave_the_pair_head(dev, packed4):
    """The road cases move through slots past the 8 the kernel reads with
    each move, which it reads with a second, dependent load."""
    _, fm, on = _case(40, 50, dev, seed=40, road_cap=13 if packed4 else 0)
    nbr = on["dg"].out_nbr.cpu().numpy()
    rows, s, t = (on[k].cpu().numpy() for k in ("rows", "s", "t"))
    taken = []
    for r, x, tt in zip(rows, s, t):
        while fm[r, x] >= 0 and x != tt:
            taken.append(int(fm[r, x]))
            x = nbr[x, fm[r, x]]
    assert max(taken) >= 8


@pytest.mark.parametrize("packed4", [False, True])
@pytest.mark.parametrize("max_steps,k_moves,unroll,want", [
    (0, -1, 8, 16),       # unlimited: ceil(11 / 8) * 8 steps, not 11
    (0, -1, 4, 12),       # ceil(11 / 4) * 4
    (0, 5, 8, 5),         # k_moves budget
    (13, -1, 8, 13),      # max_steps budget
])
def test_cyclic_row_runs_to_the_step_bound(dev, packed4, max_steps, k_moves,
                                           unroll, want):
    """A corrupted row that cycles 0 -> 1 -> 0 never halts: the kernel's
    lane takes exactly the loop's step bound (odd n = 11)."""
    n = 11
    src = np.array([0, 1] + list(range(2, n - 1)))
    dst = np.array([1, 0] + list(range(3, n)))
    w = np.array([7, 9] + [1] * (n - 3), np.int32)
    g = Graph(np.arange(n), np.zeros(n), src, dst, w)
    fm = np.full((1, n), -1, np.int8)
    fm[0, 0] = fm[0, 1] = 0
    table = torch.as_tensor(encode_pack4(fm) if packed4 else fm, device=dev)
    dg = DeviceGraph.from_graph(g, device=dev)
    lanes = [torch.as_tensor(np.asarray(a, np.int32), device=dev)
             for a in ([0, 0], [0, 1], [n - 1, n - 1])]
    args = (dg, table, *lanes, dg.w_pad)
    kw = {"max_steps": max_steps, "k_moves": k_moves, "unroll": unroll,
          "packed4": packed4}
    ker = cuda_walk_batch(*args, **kw)
    torch.cuda.synchronize()
    plain = table_search_batch(*args, **kw)
    for a, b in zip(ker, plain):
        assert torch.equal(a, b)
    cost, plen, fin = (a.cpu().numpy() for a in ker)
    assert plen.tolist() == [want, want] and not fin.any()
    assert cost[0] == 7 * ((want + 1) // 2) + 9 * (want // 2)


def test_wrapper_refuses_wrong_tables(dev):
    g, fm, on = _case(8, 6, dev, seed=1)
    args = (on["rows"], on["s"], on["t"], on["w"])
    with pytest.raises(TypeError, match="dtype"):
        cuda_walk_batch(on["dg"], torch.as_tensor(fm, device=dev).to(
            torch.uint8), *args)
    with pytest.raises(ValueError, match="fm must be"):
        cuda_walk_batch(on["dg"], torch.as_tensor(fm, device=dev), *args,
                        packed4=True)
    with pytest.raises(TypeError, match="dtype"):
        cuda_walk_batch(on["dg"], torch.as_tensor(
            encode_pack4(fm), device=dev).to(torch.int8), *args,
            packed4=True)


def test_wrapper_refuses_wrong_pair_tables(dev):
    """The kernel reads the planar ``[2, N, K']`` table in 16-byte
    loads: an interleaved table, or one off a 16-byte boundary, is
    refused before launch."""
    g, fm, on = _case(8, 6, dev, seed=1)
    args = (on["dg"], torch.as_tensor(fm, device=dev), on["rows"], on["s"],
            on["t"], on["w"])
    pair = walk_pairs(on["dg"], on["w"])
    with pytest.raises(ValueError, match="pair has shape"):
        cuda_walk_batch(*args, pair=pair.permute(1, 2, 0).contiguous())
    shifted = torch.empty(pair.numel() + 1, dtype=torch.int32, device=dev)
    shifted[1:] = pair.reshape(-1)
    with pytest.raises(ValueError, match="16 bytes"):
        cuda_walk_batch(*args, pair=shifted[1:].view(pair.shape))


def test_rows_past_two_gigabytes(dev):
    """A raw ``[33_000, 65_536]`` table is 2.16 GB: rows from 32,768 on
    start past byte 2^31, so a 32-bit row offset would read elsewhere.
    Lanes walk 64 real target rows placed there; the answers equal the
    plain walk on the same table and the kernel on the rows alone."""
    g = synth_city_graph(256, 256, seed=3)
    assert g.n == 65_536
    rng = np.random.default_rng(3)
    targets = rng.choice(g.n, 64, replace=False).astype(np.int32)
    dg = DeviceGraph.from_graph(g, device=dev)
    rows_fm = build_fm_columns(dg, torch.as_tensor(targets, device=dev))
    big = torch.full((33_000, g.n), -1, dtype=torch.int8, device=dev)
    at = 33_000 - 64 - 7                 # rows 32,929 .. 32,992
    assert at * g.n > 2 ** 31
    big[at:at + 64] = rows_fm
    q = 4096
    pick = rng.integers(0, 64, q)
    s = torch.as_tensor(rng.integers(0, g.n, q).astype(np.int32), device=dev)
    t = torch.as_tensor(targets[pick], device=dev)
    valid = torch.as_tensor(rng.random(q) > 0.05, device=dev)
    pair = walk_pairs(dg, dg.w_pad)
    far = torch.as_tensor((pick + at).astype(np.int32), device=dev)
    near = torch.as_tensor(pick.astype(np.int32), device=dev)
    ker = cuda_walk_batch(dg, big, far, s, t, dg.w_pad, valid=valid,
                          pair=pair)
    alone = cuda_walk_batch(dg, rows_fm, near, s, t, dg.w_pad, valid=valid,
                            pair=pair)
    torch.cuda.synchronize()
    plain = table_search_batch(dg, big, far, s, t, dg.w_pad, valid=valid,
                               pair=pair)
    for a, b, c in zip(ker, plain, alone):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert bool(ker[2][valid].all()) and int(ker[1].max()) > 100
    assert not bool(ker[2][~valid].any()) and int(ker[0][~valid].abs().sum()) == 0


@pytest.mark.parametrize("k_moves", [-1, 5])
def test_oracle_on_the_card_equals_the_cpu(dev, k_moves):
    """``CPDOracle`` over 8 workers: the build, one round's answers (one
    kernel launch over every worker's rows, pad lanes included) and the
    path prefixes are the same on the card as on the CPU."""
    g = synth_city_graph(33, 21, seed=5)
    dc = DistributionController("tpu", 8, 8, g.n)
    cpu = CPDOracle(g, dc, device="cpu").build(chunk=40)
    card = CPDOracle(g, dc, device=dev).build(chunk=40)
    assert torch.equal(card.fm.cpu(), cpu.fm)
    rng = np.random.default_rng(5)
    queries = rng.integers(0, g.n, (3000, 2))
    w = (g.w * rng.uniform(1.0, 3.0, g.m)).astype(np.int32)
    before = cuda_walk_batch.launches
    for w_query in (None, w):
        got = card.query(queries, w_query=w_query, k_moves=k_moves)
        want = cpu.query(queries, w_query=w_query, k_moves=k_moves)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert cuda_walk_batch.launches == before + 2
    for a, b in zip(card.query_paths(queries, k=8),
                    cpu.query_paths(queries, k=8)):
        np.testing.assert_array_equal(a, b)
