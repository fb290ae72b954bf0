"""PyTorch port, serving kernels on the card: the fused multi-diff walk
(K4, ``csrc/table_search_walk.cu`` entry ``table_search_walk_multi``)
answers bit-identically to the plain multi walk on the same CUDA tensors
— D = 1 to 33 weight sets (one thread a query up to 8, then 2, 4 and 8
threads), step cuts 0, 1 and 5, targets a lane cannot reach — and
refuses operands of the wrong shape or type; K5's on-chip doubling
(``csrc/pointer_doubling.cu`` entry ``doubling_rows``) equals the plain
``double_rows`` at sweep caps 1, 2, 3 and at convergence, on its own
count and on a fixed one, at one to eight cost sets, on rows of one
block and rows a cluster of blocks holds, random records (cycles and
wrapping sums) included; a row no cluster holds is refused; the wide
path's sweep (``doubling_sweep``) equals the plain sweep sweep by sweep
and refuses an in-place or unaligned sweep; the tables either path
builds equal the CPU's, on corrupted rows with cycles too; and the
oracle's serving methods on the card (``query_multi``, ``query_mat``,
``query_dist``, ``query_table(_multi)``) answer as on the CPU. Each
launch is counted.

Needs an NVIDIA GPU and ``nvcc``; skips without them. This file imports
the port only (no JAX), so it runs on a machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_serving.py
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)

from distributed_oracle_search_tpu_torch.data import (  # noqa: E402
    Graph, read_diff, synth_road_network,
)
from distributed_oracle_search_tpu_torch.models.cpd import CPDOracle  # noqa: E402
from distributed_oracle_search_tpu_torch.ops import (  # noqa: E402
    DeviceGraph, build_fm_columns, cuda_walk_multi, doubling_rows,
    doubling_sweep, table_search_multi,
)
from distributed_oracle_search_tpu_torch.ops import cuda_doubling as tcd  # noqa: E402
from distributed_oracle_search_tpu_torch.ops import pointer_doubling as tpd  # noqa: E402
from distributed_oracle_search_tpu_torch.parallel import (  # noqa: E402
    DistributionController,
)
from torch_doubling_cases import plant_cycles  # noqa: E402

pytestmark = pytest.mark.cuda

DATA = os.path.join(os.path.dirname(os.path.dirname(__file__)), "data")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _sinks(seed: int) -> Graph:
    """A road graph whose every 7th node keeps no out-edge (a sink)."""
    g = synth_road_network(300, seed=seed)
    keep = g.src % 7 != 3
    return Graph(g.xs, g.ys, g.src[keep], g.dst[keep], g.w[keep])


def _case(seed: int, d: int):
    """The sink graph, the first-move rows of 40 targets, 257 lanes and
    ``d`` padded weight sets (the first free flow)."""
    g = _sinks(seed)
    rng = np.random.default_rng(seed)
    targets = np.sort(rng.choice(g.n, 40, replace=False)).astype(np.int32)
    fm = build_fm_columns(DeviceGraph.from_graph(g, device="cpu"),
                          targets).numpy()
    q = 257
    s = rng.integers(0, g.n, q).astype(np.int32)
    rows = rng.integers(0, len(targets), q).astype(np.int32)
    t = targets[rows]
    s[:5] = t[:5]
    valid = rng.random(q) > 0.15
    w_pads = np.stack([g.padded_weights(
        None if i == 0 else (g.w * rng.uniform(1.0, 4.0, g.m)).astype(
            np.int32)) for i in range(d)]).astype(np.int32)
    return g, targets, fm, rows, s, t, valid, w_pads


@pytest.mark.parametrize("d", [1, 2, 5, 8, 9, 16, 17, 33])
@pytest.mark.parametrize("max_steps", [0, 1, 5])
def test_k4_equals_plain(dev, d, max_steps):
    g, _, fm, rows, s, t, valid, w_pads = _case(20 + d, d)
    dg = DeviceGraph.from_graph(g, device=dev)
    args = [torch.from_numpy(a).to(dev) for a in (fm, rows, s, t, w_pads)]
    v = torch.from_numpy(valid).to(dev)
    before = cuda_walk_multi.launches
    got = cuda_walk_multi(dg, *args, valid=v, max_steps=max_steps)
    torch.cuda.synchronize()
    assert cuda_walk_multi.launches == before + 1
    want = table_search_multi(dg, *args, valid=v, max_steps=max_steps)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_k4_refuses_bad_operands(dev):
    g, _, fm, rows, s, t, _, w_pads = _case(4, 2)
    dg = DeviceGraph.from_graph(g, device=dev)
    args = [torch.from_numpy(a).to(dev) for a in (fm, rows, s, t, w_pads)]
    with pytest.raises(ValueError, match="w_pads rows"):
        cuda_walk_multi(dg, *args[:4], args[4][:, :-1].contiguous())
    with pytest.raises(TypeError):
        cuda_walk_multi(dg, args[0].to(torch.int32), *args[1:])


@pytest.mark.parametrize("d", [1, 2, 5, 7])
def test_k5_equals_plain_each_sweep(dev, d):
    g, targets, fm, *_, w_pads = _case(30 + d, d)
    dg = DeviceGraph.from_graph(g, device=dev)
    rec = tpd.initial_records(dg, torch.from_numpy(fm).to(dev),
                              torch.from_numpy(w_pads).to(dev))
    out = torch.empty_like(rec)
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    for _ in range(tpd.n_sweeps(g.n)):
        want, changed = tpd.sweep_records(rec)
        flag.zero_()
        before = doubling_sweep.launches
        doubling_sweep(rec, out, flag)
        torch.cuda.synchronize()
        assert doubling_sweep.launches == before + 1
        assert torch.equal(out, want) and bool(flag.item()) == changed
        rec, out = out, rec


def _random_records(r: int, n: int, d: int, seed: int, dev):
    """Records ``[r, n, record_width(d)]``: successors of random forests
    (each node points at a node earlier in a random order, some at
    themselves) with a few random successors (cycles), random plen and
    full-range costs (the sums wrap), zero padding."""
    rng = np.random.default_rng(seed)
    rec = np.zeros((r, n, tpd.record_width(d)), np.int32)
    for i in range(r):
        order = rng.permutation(n)
        parent = order[(rng.random(n) * np.arange(n)).astype(np.int64)]
        succ = np.empty(n, np.int64)
        succ[order] = parent
        succ[rng.random(n) < 0.05] = -1
        succ = np.where(succ < 0, np.arange(n), succ)
        if i % 3 == 2:
            hit = rng.random(n) < 0.001
            succ[hit] = rng.integers(0, n, int(hit.sum()))
        rec[i, :, 0] = succ
    rec[..., 1] = rng.integers(0, 3, (r, n))
    rec[..., 2:2 + d] = rng.integers(-2**31, 2**31, (r, n, d),
                                     dtype=np.int64)
    return torch.from_numpy(rec).to(dev)


@pytest.mark.parametrize("n", [300, 65536], ids=["block", "cluster"])
@pytest.mark.parametrize("d", [1, 2, 5, 7, 8])
def test_k5_rows_equal_plain(dev, n, d):
    rec0 = _random_records(6, n, d, 40 + d, dev)
    limit = tpd.n_sweeps(n)
    plan = tcd.rows_plan(n, d, dev)
    assert plan[0] >= 1, plan
    for cap, fixed in ((1, False), (2, False), (3, False), (limit, False),
                       (3, True), (limit, True)):
        got = rec0.clone()
        before = doubling_rows.launches
        settled, live = doubling_rows(got, d, cap, fixed)
        torch.cuda.synchronize()
        assert doubling_rows.launches == before + 1
        want = rec0.clone()
        s_want, l_want = tpd.double_rows(want, d, cap, fixed)
        assert torch.equal(got, want), (cap, fixed)
        assert torch.equal(settled, s_want) and torch.equal(live, l_want)


def test_k5_rows_refuse(dev):
    rec = torch.zeros((2, 8, 3), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="record_width"):
        doubling_rows(rec, 1, 3)
    with pytest.raises(ValueError, match="16 bytes"):
        flat = torch.zeros(2 * 8 * 4 + 1, dtype=torch.int32, device=dev)
        doubling_rows(flat[1:].view(2, 8, 4), 1, 3)
    big = 1 << 22                        # 4,194,304 nodes x 16 B: 64 MiB
    assert tcd.rows_plan(big, 1, dev)[0] == 0
    with pytest.raises(ValueError, match="wide path"):
        doubling_rows(torch.zeros((1, big, 4), dtype=torch.int32,
                                  device=dev), 1, 3)


@pytest.mark.parametrize("path", ["rows", "wide"])
@pytest.mark.parametrize("cyclic", [False, True], ids=["paths", "cycles"])
@pytest.mark.parametrize("multi", [False, True])
def test_tables_on_card_equal_cpu(dev, multi, cyclic, path, monkeypatch):
    g, targets, fm, *_, w_pads = _case(9, 3)
    targets[4] = -1
    fm[4] = -1
    if cyclic:
        plant_cycles(g, fm, 1, 2)
    if path == "wide":
        real = tcd.rows_plan
        monkeypatch.setattr(
            tcd, "rows_plan", lambda n, d, device: (0, 0, 0, 0)
            if device.type == "cuda" else real(n, d, device))
    before = (doubling_rows.launches, doubling_sweep.launches)
    out = []
    for device in ("cpu", dev):
        dg = DeviceGraph.from_graph(g, device=device)
        args = (dg, torch.from_numpy(fm).to(device),
                torch.from_numpy(targets).to(device))
        w = torch.from_numpy(w_pads).to(device)
        order = tpd.record_order(g, device)
        got = (tpd.doubled_tables_multi(*args, w, order=order) if multi
               else tpd.doubled_tables(*args, w[0], order=order))
        out.append([x.cpu() for x in got])
    for a, b in zip(*out):
        assert a.dtype == b.dtype and torch.equal(a, b)
    launched = (doubling_rows.launches - before[0],
                doubling_sweep.launches - before[1])
    if path == "wide":
        assert launched[0] == 0 and launched[1] >= 1
    else:
        assert launched[1] == 0 and launched[0] == (2 if cyclic else 1)


def test_k5_refuses_in_place(dev):
    rec = torch.zeros((2, 8, 4), dtype=torch.int32, device=dev)
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="double-buffered"):
        doubling_sweep(rec, rec, flag)
    with pytest.raises(ValueError, match="4 v"):
        doubling_sweep(rec[..., :3].contiguous(),
                       rec[..., :3].contiguous(), flag)
    with pytest.raises(ValueError, match="16 bytes"):
        flat = torch.zeros(2 * 8 * 4 + 1, dtype=torch.int32, device=dev)
        doubling_sweep(flat[1:].view(2, 8, 4), rec, flag)


def test_oracle_serving_on_card_equals_cpu(dev, tmp_path):
    g = Graph.from_xy(os.path.join(DATA, "synth-city.xy"))
    w_diff = g.weights_with_diff(read_diff(os.path.join(
        DATA, "synth-city.xy.diff")))
    rng = np.random.default_rng(3)
    q = np.stack([rng.integers(0, g.n, 600), rng.integers(0, g.n, 600)], 1)
    ws = [None, w_diff, (g.w * 2).astype(np.int32)]
    got = {}
    for device in ("cpu", dev):
        o = CPDOracle(g, DistributionController("tpu", 8, 8, g.n),
                      device=device).build(chunk=20, store_dists=True)
        got[str(device)] = [
            o.query_multi(q, ws), o.query_multi(q, ws[:2], active_worker=3),
            o.query_mat(7, q[:37, 1], w_query=w_diff, w_key="d"),
            o.query_dist(q),
            o.query_table(o.prepare_weights(w_diff, chunk=16), q),
            o.query_table_multi(o.prepare_weights_multi(ws, chunk=16), q)]
    for a, b in zip(got["cpu"], got[str(dev)]):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
