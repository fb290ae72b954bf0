"""PyTorch port, batched A* on the card (K6, ``csrc/batched_astar.cu``):
the heuristic entry equals the plain table bit for bit; K6's loop equals
the plain copy of the JAX loop (``astar_batch_plain``) on the same CUDA
tensors at sweep cuts 1, 2, 3 and at convergence — cost, plen,
finished, the sweep count and the five counters — over hscale and
fscale, padded lanes and s == t; ``astar_batch_np`` on the card answers
as on the CPU; an in-place sweep is refused. Each launch is counted.

Needs an NVIDIA GPU and ``nvcc``; skips without them. This file imports
the port only (no JAX), so it runs on a machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_astar.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from distributed_oracle_search_tpu_torch.data import (  # noqa: E402
    synth_city_graph, synth_road_network,
)
from distributed_oracle_search_tpu_torch.models.astar import (  # noqa: E402
    min_cost_per_unit,
)
from distributed_oracle_search_tpu_torch.ops import (  # noqa: E402
    astar_batch, astar_batch_np,
)
from distributed_oracle_search_tpu_torch.ops import batched_astar as tba  # noqa: E402
from distributed_oracle_search_tpu_torch.ops import cuda_astar as tca  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _case(g, nq, seed, dev, pad=0):
    rng = np.random.default_rng(seed)
    q = np.stack([rng.integers(0, g.n, nq), rng.integers(0, g.n, nq)], 1)
    q[0, 0] = q[0, 1]
    in_nbr, in_eid = g.ell("in")
    valid = np.ones(nq + pad, bool)
    valid[nq:] = False
    q = np.concatenate([q, np.zeros((pad, 2), np.int64)])

    def T(a, dt):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=dev)

    return dict(in_nbr=T(in_nbr, torch.int32), in_eid=T(in_eid, torch.int32),
                w_pad=T(g.padded_weights(), torch.int32),
                xs=T(np.asarray(g.xs, np.float32), torch.float32),
                ys=T(np.asarray(g.ys, np.float32), torch.float32),
                s=T(q[:, 0], torch.int32), t=T(q[:, 1], torch.int32),
                valid=T(valid, torch.bool)), min_cost_per_unit(g)


@pytest.mark.parametrize("hscale", [1.0, 1.5])
def test_heuristic_equals_plain(dev, hscale):
    g = synth_road_network(4096, seed=0)
    args, cpu = _case(g, 300, 1, dev)
    before = tca.astar_heuristic.launches
    got = tca.astar_heuristic(args["xs"], args["ys"], args["t"], cpu, hscale)
    want = tba.heuristic_plain(args["xs"], args["ys"], args["t"], cpu,
                               hscale)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert tca.astar_heuristic.launches == before + 1


@pytest.mark.parametrize("graph", ["city", "road"])
@pytest.mark.parametrize("hscale,fscale", [(1.0, 0.0), (0.7, 0.5),
                                           (1.5, 0.1)])
@pytest.mark.parametrize("max_iters", [1, 2, 3, 0])
def test_k6_equals_plain(dev, graph, hscale, fscale, max_iters):
    g = (synth_city_graph(20, 15, seed=2) if graph == "city"
         else synth_road_network(4096, seed=1))
    args, cpu = _case(g, 200, 3, dev, pad=56)
    info, pinfo = {}, {}
    before = tca.astar_sweep.launches
    got = astar_batch(**args, hscale=hscale, fscale=fscale, cpu=cpu,
                      max_iters=max_iters, info=info)
    want = tba.astar_batch_plain(**args, hscale=hscale, fscale=fscale,
                                 cpu=cpu, max_iters=max_iters, info=pinfo)
    torch.cuda.synchronize()
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a, b)
    assert got[3] == want[3]
    assert info["sweeps"] == pinfo["sweeps"]
    np.testing.assert_array_equal(info["counts"], pinfo["counts"])
    assert tca.astar_sweep.launches - before == info["launches"]
    if max_iters:
        assert info["sweeps"] == max_iters
    else:
        assert got[2][:200].all() and not got[2][200:].any()


def test_np_on_card_equals_cpu(dev):
    g = synth_road_network(2048, seed=4)
    rng = np.random.default_rng(5)
    q = np.stack([rng.integers(0, g.n, 700), rng.integers(0, g.n, 700)], 1)
    got = astar_batch_np(g, q, hscale=1.5, fscale=0.1, chunk=256,
                         device="cuda")
    want = astar_batch_np(g, q, hscale=1.5, fscale=0.1, chunk=256,
                          device="cpu")
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a, b)
    assert got[3] == want[3]


def test_sweep_refuses_in_place(dev):
    g = synth_city_graph(6, 5, seed=1)
    args, _ = _case(g, 8, 1, dev)
    n, q = g.n, 8
    w_in = args["w_pad"][args["in_eid"].long()]
    h = torch.zeros((n, q), dtype=torch.int32, device=dev)
    st, hops = (torch.zeros((n, q), dtype=torch.int32, device=dev)
                for _ in range(2))
    ch = torch.zeros((n, q), dtype=torch.uint8, device=dev)
    flag = torch.ones(1, dtype=torch.int32, device=dev)
    counts = torch.zeros(8, dtype=torch.int64, device=dev)
    with pytest.raises(ValueError, match="double-buffered"):
        tca.astar_sweep(args["in_nbr"], w_in, h, args["t"],
                        args["valid"].to(torch.uint8), st, hops, ch, st,
                        torch.empty_like(hops), torch.empty_like(ch), 0.0,
                        flag, flag, counts)


def test_loop_groups_sweeps_between_flag_reads(dev):
    """The K6 loop queues groups of sweeps (4, 8, ... up to 64) and reads
    the flags once a group: every sweep after the last one that changed
    a node is a launch that returns at once, and the state is read from
    the buffer the last sweep wrote."""
    g = synth_road_network(4096, seed=1)
    args, cpu = _case(g, 200, 3, dev, pad=56)
    info, pinfo = {}, {}
    before = tca.astar_sweep.launches
    got = astar_batch(**args, hscale=1.0, fscale=0.0, cpu=cpu, info=info)
    want = tba.astar_batch_plain(**args, hscale=1.0, fscale=0.0, cpu=cpu,
                                 info=pinfo)
    torch.cuda.synchronize()
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a, b)
    assert info["sweeps"] == pinfo["sweeps"]
    np.testing.assert_array_equal(info["counts"], pinfo["counts"])
    assert tca.astar_sweep.launches - before == info["launches"]
    assert info["launches"] >= info["sweeps"] + 1
    ends, total, group = set(), 0, tca.GROUP_FIRST
    while total < g.n:
        total += group
        ends.add(total)
        group = min(2 * group, tca.GROUP_MAX)
    assert info["launches"] in ends
