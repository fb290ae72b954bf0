"""PyTorch port, serving kernels on the card: the fused multi-diff walk
(K4, ``csrc/table_search_walk.cu`` entry ``table_search_walk_multi``)
answers bit-identically to the plain multi walk on the same CUDA tensors
— D = 1 to 9 weight sets (9 past the kernel's register sums), step cuts
0, 1 and 5, targets a lane cannot reach — and refuses operands of the
wrong shape or type; the doubling sweep (K5, ``csrc/pointer_doubling.cu``)
equals the plain sweep sweep by sweep at one to seven cost sets (one and
two 16-byte vectors a record, and a wider one), refuses an in-place or
unaligned sweep, and the tables it builds equal the CPU's; and the
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

from distributed_oracle_search_tpu_torch.data import (  # noqa: E402
    Graph, read_diff, synth_road_network,
)
from distributed_oracle_search_tpu_torch.models.cpd import CPDOracle  # noqa: E402
from distributed_oracle_search_tpu_torch.ops import (  # noqa: E402
    DeviceGraph, build_fm_columns, cuda_walk_multi, doubling_sweep,
    table_search_multi,
)
from distributed_oracle_search_tpu_torch.ops import pointer_doubling as tpd  # noqa: E402
from distributed_oracle_search_tpu_torch.parallel import (  # noqa: E402
    DistributionController,
)

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


@pytest.mark.parametrize("d", [1, 2, 5, 8, 9])
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


@pytest.mark.parametrize("multi", [False, True])
def test_tables_on_card_equal_cpu(dev, multi):
    g, targets, fm, *_, w_pads = _case(9, 3)
    targets[4] = -1
    fm[4] = -1
    out = []
    for device in ("cpu", dev):
        dg = DeviceGraph.from_graph(g, device=device)
        args = (dg, torch.from_numpy(fm).to(device),
                torch.from_numpy(targets).to(device))
        w = torch.from_numpy(w_pads).to(device)
        got = (tpd.doubled_tables_multi(*args, w) if multi
               else tpd.doubled_tables(*args, w[0]))
        out.append([x.cpu() for x in got])
    for a, b in zip(*out):
        assert a.dtype == b.dtype and torch.equal(a, b)


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
