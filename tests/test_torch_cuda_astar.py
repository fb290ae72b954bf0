"""PyTorch port, batched A* on the card (K6, ``csrc/batched_astar.cu``):
the heuristic entry equals the plain table bit for bit (Q = 1, 2, 3, 4,
300, 1,024: the int4 rows and the scalar tail); each sweep, with the
skip and without it (``skip=False``), equals ``sweep_plain`` after
sweeps 1-3 (g, hops, improved, the dirty groups, the counts and the
flag), and K6's loop (every sweep with the skip) and its sweeps at
skip 0 chained one by one equal the plain copy of the JAX loop
(``astar_batch_plain``) at convergence, on city and road graphs at Q =
1, 2, 8, 32, 1,024, with weights of 0, ``2^31 - 1 - JINF`` and above it
among them; K6's loop also equals it at sweep cuts 1, 2, 3 and at
convergence — cost, plen, finished, the sweep count and the five
counters — over hscale and fscale, padded lanes and s == t;
``astar_batch_np`` on the card answers as on the CPU; an in-place sweep
and aliased group buffers are refused. Each launch is counted, the
launches without the skip also in ``astar_sweep.dense``.

Needs an NVIDIA GPU and ``nvcc``; skips without them. This file imports
the port only (no JAX), so it runs on a machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_astar.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)

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


def _case(g, nq, seed, dev, pad=0, w=None):
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
                w_pad=T(g.padded_weights(w), torch.int32),
                xs=T(np.asarray(g.xs, np.float32), torch.float32),
                ys=T(np.asarray(g.ys, np.float32), torch.float32),
                s=T(q[:, 0], torch.int32), t=T(q[:, 1], torch.int32),
                valid=T(valid, torch.bool)), min_cost_per_unit(g, w)


@pytest.mark.parametrize("nq", [1, 2, 3, 4, 300, 1024])
@pytest.mark.parametrize("hscale", [1.0, 1.5])
def test_heuristic_equals_plain(dev, hscale, nq):
    g = synth_road_network(4096, seed=0)
    args, cpu = _case(g, nq, 1, dev)
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


def _graph(name):
    return (synth_city_graph(20, 15, seed=2) if name == "city"
            else synth_road_network(4096, seed=1))


def _weights(g, kind):
    """Free flow, or ``heavy``: a tenth of the edges at 0, a tenth at
    ``SKIP_W_MAX`` and a tenth just above it (sums past it wrap int32:
    those slots are always gathered)."""
    if kind == "free":
        return None
    rng = np.random.default_rng(9)
    w = g.w.copy()
    pick = rng.random(g.m)
    w[pick < 0.1] = 0
    w[(pick >= 0.1) & (pick < 0.2)] = tba.SKIP_W_MAX
    w[(pick >= 0.2) & (pick < 0.3)] = tba.SKIP_W_MAX + 1
    return w


def _pad(nq):
    """Padded (invalid) lanes of an ``nq``-lane chunk: an eighth, one at
    2, none at 1."""
    return nq // 8 if nq >= 8 else nq - 1


@pytest.mark.parametrize("weights", ["free", "heavy"])
@pytest.mark.parametrize("nq", [1, 2, 8, 32, 1024])
@pytest.mark.parametrize("graph", ["city", "road"])
def test_sweeps_equal_plain_with_and_without_skip(dev, graph, nq, weights):
    """Sweeps 1-3 from the plain iterate, each launched at skip 1 and at
    skip 0 on the same state: g, hops, improved, the dirty groups, the
    five counts and the flag equal ``sweep_plain``'s."""
    g = _graph(graph)
    w = _weights(g, weights)
    pad = _pad(nq)
    args, cpu = _case(g, nq - pad, 11, dev, pad=pad, w=w)
    n = g.n
    q = args["s"].shape[0]
    w_in = args["w_pad"][args["in_eid"].long()]
    deg = tba.in_degree(args["in_eid"], g.m)
    h = tca.astar_heuristic(args["xs"], args["ys"], args["t"], cpu, 1.0)
    valid8 = args["valid"].to(torch.uint8)
    pg, phops, pch, pgrp = tba.init_state(n, args["s"], args["valid"])
    one = torch.ones(1, dtype=torch.int32, device=dev)
    for sweep in range(3):
        want = tba.sweep_plain(args["in_nbr"], w_in, h, args["t"],
                               args["valid"], pg, phops, pch, 0.0)
        for skip in (True, False):
            before = (tca.astar_sweep.launches, tca.astar_sweep.dense)
            out = (torch.empty_like(pg), torch.empty_like(phops),
                   torch.empty((n, q), dtype=torch.uint8, device=dev),
                   torch.empty_like(pgrp))
            flag = torch.zeros(1, dtype=torch.int32, device=dev)
            counts = torch.zeros(tca.COUNT_SLOTS, dtype=torch.int64,
                                 device=dev)
            tca.astar_sweep(args["in_nbr"], w_in, deg, h, args["t"], valid8,
                            pg, phops, pch.to(torch.uint8), pgrp, *out, 0.0,
                            one, flag, counts, skip=skip)
            torch.cuda.synchronize()
            tag = f"sweep {sweep + 1} skip {skip}"
            assert torch.equal(out[0], want[0]), tag
            assert torch.equal(out[1], want[1]), tag
            assert torch.equal(out[2].bool(), want[2]), tag
            assert torch.equal(out[3], tba.groups_plain(want[2])), tag
            assert torch.equal(counts[:5], want[3]), tag
            assert bool(flag[0]) == bool(want[2].any()), tag
            assert (tca.astar_sweep.launches - before[0],
                    tca.astar_sweep.dense - before[1]) == (1, int(not skip))
        pg, phops, pch, _ = want
        pgrp = tba.groups_plain(pch)


def _dense_chain(args, cpu, limit):
    """K6's sweeps at skip 0 chained as ``astar_loop`` chains them (the
    flag of each sweep read before the next): ``(cost, plen, finished,
    counters)`` and ``(sweeps, every sweep's counts)``."""
    n, k = args["in_nbr"].shape
    q = args["s"].shape[0]
    dev = args["s"].device
    h = tca.astar_heuristic(args["xs"], args["ys"], args["t"], cpu, 1.0)
    w_in = args["w_pad"][args["in_eid"].long()]
    deg = tba.in_degree(args["in_eid"], args["w_pad"].shape[0] - 1)
    g, hops, changed, groups = tba.init_state(n, args["s"], args["valid"])
    bufs = [(g, hops, changed.to(torch.uint8), groups),
            (torch.empty_like(g), torch.empty_like(hops),
             torch.empty((n, q), dtype=torch.uint8, device=dev),
             torch.empty_like(groups))]
    valid8 = args["valid"].to(torch.uint8)
    flag_in = args["valid"].any().to(torch.int32).reshape(1)
    rows = []
    while len(rows) < (limit or n - 1) and bool(flag_in[0]):
        flag = torch.zeros(1, dtype=torch.int32, device=dev)
        counts = torch.zeros(tca.COUNT_SLOTS, dtype=torch.int64, device=dev)
        tca.astar_sweep(args["in_nbr"], w_in, deg, h, args["t"], valid8,
                        *bufs[0], *bufs[1], 0.0, flag_in, flag, counts,
                        skip=False)
        rows.append(counts[:5].cpu().numpy())
        bufs.reverse()
        flag_in = flag
    counts = np.array(rows, np.int64).reshape(-1, 5)
    out = tba.finish(bufs[0][0], bufs[0][1], args["t"], args["valid"])
    return (*out, tba.fold_counts(counts, k)), (len(rows), counts)


@pytest.mark.parametrize("skip", [True, False])
@pytest.mark.parametrize("weights", ["free", "heavy"])
@pytest.mark.parametrize("nq", [1, 2, 8, 32, 1024])
@pytest.mark.parametrize("graph", ["city", "road"])
def test_loop_equals_plain_with_and_without_skip(dev, graph, nq, weights,
                                                 skip):
    """At convergence, against the plain loop (heavy weights on the road
    graph: 64 sweeps, their sums keep wrapping): K6's loop (every sweep
    with the skip) and, at skip 0, K6's sweeps chained one by one —
    cost, plen, finished, the sweeps and every sweep's counts."""
    g = _graph(graph)
    pad = _pad(nq)
    args, cpu = _case(g, nq - pad, 12, dev, pad=pad, w=_weights(g, weights))
    cut = 64 if (graph, weights) == ("road", "heavy") else 0
    info, pinfo = {}, {}
    before = (tca.astar_sweep.launches, tca.astar_sweep.dense)
    if skip:
        got = tca.astar_loop(**args, hscale=1.0, fscale=0.0, cpu=cpu,
                             max_iters=cut, info=info)
        sweeps, counts = info["sweeps"], info["counts"]
        launches = info["launches"]
    else:
        got, (sweeps, counts) = _dense_chain(args, cpu, cut)
        launches = sweeps
    want = tba.astar_batch_plain(**args, hscale=1.0, fscale=0.0, cpu=cpu,
                                 max_iters=cut, info=pinfo)
    torch.cuda.synchronize()
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a, b)
    assert got[3] == want[3]
    assert sweeps == pinfo["sweeps"]
    np.testing.assert_array_equal(counts, pinfo["counts"])
    assert (tca.astar_sweep.launches - before[0],
            tca.astar_sweep.dense - before[1]) == (
                launches, 0 if skip else launches)


def _sweep_buffers(dev, n=30, q=8):
    z = [torch.zeros((n, q), dtype=torch.int32, device=dev)
         for _ in range(4)]
    z8 = [torch.zeros((n, q), dtype=torch.uint8, device=dev)
          for _ in range(2)]
    grp = [torch.zeros((n, tba.n_groups(q)), dtype=torch.uint8, device=dev)
           for _ in range(2)]
    return z, z8, grp


def _refused_sweep(dev, state, out):
    g = synth_city_graph(6, 5, seed=1)
    args, _ = _case(g, 8, 1, dev)
    w_in = args["w_pad"][args["in_eid"].long()]
    deg = tba.in_degree(args["in_eid"], g.m)
    h = torch.zeros((g.n, 8), dtype=torch.int32, device=dev)
    flag = torch.ones(1, dtype=torch.int32, device=dev)
    counts = torch.zeros(8, dtype=torch.int64, device=dev)
    with pytest.raises(ValueError, match="double-buffered"):
        tca.astar_sweep(args["in_nbr"], w_in, deg, h, args["t"],
                        args["valid"].to(torch.uint8), *state, *out, 0.0,
                        flag, flag, counts)


def test_sweep_refuses_in_place(dev):
    z, z8, grp = _sweep_buffers(dev)
    _refused_sweep(dev, (z[0], z[1], z8[0], grp[0]),
                   (z[0], z[2], z8[1], grp[1]))


def test_sweep_refuses_aliased_groups(dev):
    z, z8, grp = _sweep_buffers(dev)
    _refused_sweep(dev, (z[0], z[1], z8[0], grp[0]),
                   (z[2], z[3], z8[1], grp[0]))


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
