"""PyTorch port, CPD build kernels on the card (``csrc/cpd_build.cu``):
the Jacobi relax (K1), the first-move extraction (K2) and the grid sweep
(K3) equal their plain torch versions on the same inputs — K1 one step
at every column group width, the nodes in the CSR's visit order or by
id (no changed map: every pair relaxed), the
loop with its settled-tile skip at ``max_iters`` cuts, a mid cut and at
convergence with the plain loop's step count for B from 1 to 4,096, the
changed map, flag and relaxed-pair count equal to the CPU branch's
step by step, and as the sweep's two-launch off-lattice stage (shift
planes, then stragglers on the result); K2
byte for byte with unreachable nodes, target columns and pad targets,
and writing rows past byte 2^31 of a larger table; K3 after one and two
cycles and at convergence, one launch a chunk on a lattice alone and
one a cycle with off-lattice edges, for every count of columns a block,
rows split over several warps, and rows swept in pieces on a lattice
6,000 cells wide. Every build method
gives the CPU's table on the card, each launch is counted, and a kernel
that fails to build or launch raises instead of falling back. A shard
build on the card adds the CPU loop's relaxed pairs to
``relax_jacobi.active_pairs``, and under the benchmark's profiler each
K1 kernel starts after its step's ``build.step_launch`` span began,
while the trace's reduction names no span of the program as a kernel.

Needs an NVIDIA GPU and ``nvcc``; skips without them. This file imports
the port only (no JAX), so it runs on a machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_build.py
"""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)

from distributed_oracle_search_tpu_torch.data import (  # noqa: E402
    Graph, synth_city_graph, synth_road_network,
)
from distributed_oracle_search_tpu_torch.models import cpd  # noqa: E402
from distributed_oracle_search_tpu_torch.ops import (  # noqa: E402
    DeviceGraph, bellman_ford, cuda_build_kernels as cbk, grid_sweep,
)
from distributed_oracle_search_tpu_torch.ops.ell_split import (  # noqa: E402
    dist_to_targets_split, ell_split_graph,
)
from distributed_oracle_search_tpu_torch.parallel import (  # noqa: E402
    DistributionController, sharded,
)
from distributed_oracle_search_tpu_torch.utils import cuda_build  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _two_cycles() -> Graph:
    """Two directed 4-cycles with no edge between them: unreachable
    pairs everywhere."""
    return Graph(np.arange(8), np.zeros(8), np.arange(8),
                 np.array([1, 2, 3, 0, 5, 6, 7, 4]), np.full(8, 10, np.int32))


GRAPHS = {
    "city": lambda: synth_city_graph(24, 17, seed=3),
    "road": lambda: synth_road_network(1500, seed=5),
    "unreachable": _two_cycles,
}


def _targets(n: int, b: int, seed: int) -> np.ndarray:
    """``b`` targets with pad columns (-1) among them."""
    rng = np.random.default_rng(seed)
    t = rng.choice(n, min(b, n), replace=False).astype(np.int32)
    t[::5] = -1
    return t


def _batch(n: int, b: int, seed: int) -> np.ndarray:
    """``b`` targets, repeats allowed (``b`` may exceed ``n``), with pad
    columns (-1) among them."""
    t = np.random.default_rng(seed).integers(0, n, b).astype(np.int32)
    t[3::5] = -1
    return t


#: batch widths, with the columns a lane each gets: 1 at B = 1, 31 and
#: 33, 4 at 100, 512 and 4096; ragged last groups
RELAX_BATCHES = [1, 31, 33, 100, 512, 4096]


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("cut", [1, 2, 4, 7, 0])
@pytest.mark.parametrize("b", RELAX_BATCHES)
def test_relax_equals_plain_at_cuts(dev, name, cut, b):
    """The skip loop on the card against the plain split relaxation, with
    the plain loop's step count (the CPU branch, dense)."""
    g = GRAPHS[name]()
    t = _batch(g.n, b, cut)
    want = dist_to_targets_split(ell_split_graph(g), t, cut)
    _, want_steps = cbk.jacobi_dist(cbk.csr_from_ell(DeviceGraph.from_graph(
        g, device="cpu")), torch.as_tensor(t), cut, skip=False)
    dg = DeviceGraph.from_graph(g, device=dev)
    before = cbk.relax_jacobi.launches
    d, steps = cbk.jacobi_dist(cbk.csr_from_ell(dg),
                               torch.as_tensor(t, device=dev), cut)
    torch.cuda.synchronize()
    assert torch.equal(d.T.cpu(), want)
    assert steps == want_steps
    assert cbk.relax_jacobi.launches - before == steps > 0
    if cut:
        assert steps <= cut


def _csr(g, dev, by_id: bool = False):
    """``g``'s full out-edge CSR on ``dev``: in its visit order, or with
    the nodes visited by id."""
    csr = cbk.csr_from_ell(DeviceGraph.from_graph(g, device=dev))
    return csr._replace(order=None, span=None) if by_id else csr


@pytest.mark.parametrize("vec", [1, 2, 4])
@pytest.mark.parametrize("by_id", [False, True])
@pytest.mark.parametrize("skip", [True, False])
@pytest.mark.parametrize("cut", [3, 0])
def test_relax_loop_every_width(dev, vec, by_id, skip, cut):
    """Each column group width, nodes in the visit order or by id, with
    and without the skip, against the plain loop (B = 100: groups of
    32, 64 and 128 columns)."""
    g = GRAPHS["road"]()
    t = _batch(g.n, 100, vec)
    csr_cpu = cbk.csr_from_ell(DeviceGraph.from_graph(g, device="cpu"))
    want, want_steps = cbk.jacobi_dist(csr_cpu, torch.as_tensor(t), cut,
                                       skip=False)
    stats = {}
    d, steps = cbk.jacobi_dist(
        _csr(g, dev, by_id), torch.as_tensor(t, device=dev), cut,
        skip=skip, vec=vec, stats=stats)
    torch.cuda.synchronize()
    assert torch.equal(d.cpu(), want) and steps == want_steps
    assert stats["vec"] == vec


@pytest.mark.parametrize("vec", [1, 2, 4])
@pytest.mark.parametrize("name", ["road", "city"])
def test_changed_map_equals_plain_each_step(dev, name, vec):
    """The kernel and the CPU branch step in lockstep with the changed
    map: after each of the first steps the distances, the map, the flag
    and the count of relaxed pairs are equal."""
    g = GRAPHS[name]()
    t = torch.as_tensor(_batch(g.n, 136, vec))
    sides = {}
    for where in ("cpu", dev):
        tt = t.to(where)
        d = bellman_ford.init_dist(g.n, tt)
        prev = cbk.target_map(g.n, tt, 32 * vec)
        sides[where] = [cbk.csr_from_ell(DeviceGraph.from_graph(
            g, device=where)), d, d.clone(), prev, torch.empty_like(prev)]
    for step in range(6):
        seen = []
        for where, st in sides.items():
            csr, d, spare, prev, cur = st
            flag = torch.zeros(1, dtype=torch.int32, device=d.device)
            active = cbk.active_counter(d.device)
            cbk.relax_jacobi(csr, d, spare, flag, prev, cur, active, vec)
            st[1:] = [spare, d, cur, prev]
            seen.append((spare.cpu(), cur.cpu(), int(flag.item()),
                         int(active[:, 0].sum())))
        (d_a, c_a, f_a, n_a), (d_b, c_b, f_b, n_b) = seen
        assert torch.equal(d_a, d_b), step
        assert torch.equal(c_a, c_b), step
        assert (f_a, n_a) == (f_b, n_b), step


@pytest.mark.parametrize("vec", [1, 2, 4])
@pytest.mark.parametrize("by_id", [False, True])
def test_one_relax_step_any_width(dev, vec, by_id):
    """With no map the kernel is the dense plain step at every width, in
    either visit order, whatever the second buffer held, and counts
    every pair."""
    g = synth_road_network(2000, seed=7)
    rng = np.random.default_rng(vec)
    d = rng.integers(0, 10 ** 9 + 1, (g.n, 260)).astype(np.int32)
    d[rng.random(d.shape) < 0.3] = 10 ** 9
    csr = _csr(g, dev, by_id)
    d_dev = torch.as_tensor(d, device=dev)
    out = torch.full_like(d_dev, -3)
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    active = cbk.active_counter(dev)
    cbk.relax_jacobi(csr, d_dev, out, flag, active=active, vec=vec)
    torch.cuda.synchronize()
    csr_cpu = cbk.csr_from_ell(DeviceGraph.from_graph(g, device="cpu"))
    want = cbk.relax_jacobi_plain(csr_cpu, torch.as_tensor(d))
    assert torch.equal(out.cpu(), want)
    assert int(flag.item()) == int(bool((want < torch.as_tensor(d)).any()))
    assert int(active[:, 0].sum()) == g.n * cbk.relax_groups(260, 32 * vec)


def test_one_relax_step_equals_plain(dev):
    g = synth_road_network(2000, seed=7)
    rng = np.random.default_rng(7)
    d = rng.integers(0, 10 ** 9 + 1, (g.n, 96)).astype(np.int32)
    d[rng.random(d.shape) < 0.3] = 10 ** 9
    csr = cbk.csr_from_ell(DeviceGraph.from_graph(g, device=dev))
    d_dev = torch.as_tensor(d, device=dev)
    out = torch.empty_like(d_dev)
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    cbk.relax_jacobi(csr, d_dev, out, flag)
    torch.cuda.synchronize()
    csr_cpu = cbk.csr_from_ell(DeviceGraph.from_graph(g, device="cpu"))
    want = cbk.relax_jacobi_plain(csr_cpu, torch.as_tensor(d))
    assert torch.equal(out.cpu(), want)
    assert int(flag.item()) == int(bool((want < torch.as_tensor(d)).any()))


def _grid_with_stragglers():
    """A road graph laid on a lattice it does not fit: ``grid_split``
    gives shift planes and stragglers besides the lattice edges."""
    g = synth_road_network(400, seed=5)
    gg = grid_sweep.GridGraph.from_graph(g)
    assert gg.shifts and gg.n_left
    return g, gg


def test_off_lattice_two_launches_equal_plain(dev):
    g, gg = _grid_with_stragglers()
    rng = np.random.default_rng(2)
    d = rng.integers(0, 10 ** 9 + 1, (g.n, 40)).astype(np.int32)
    want = grid_sweep.off_lattice(gg.on("cpu"), torch.as_tensor(d))
    gd = gg.on(dev)
    a = torch.as_tensor(d, device=dev)
    b = torch.empty_like(a)
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    cbk.relax_jacobi(gd.shift_csr, a, b, flag)
    cbk.relax_jacobi(gd.left_csr, b, a, flag)
    torch.cuda.synchronize()
    assert torch.equal(a.cpu(), want) and int(flag.item()) == 1


def _sweep_graph(case):
    if case == "lattice":
        g = synth_city_graph(40, 33, seed=2, shortcut_frac=0.0)
        return g, grid_sweep.GridGraph.from_graph(g)
    if case == "city":
        g = synth_city_graph(40, 33, seed=2)
        return g, grid_sweep.GridGraph.from_graph(g)
    return _grid_with_stragglers()


@pytest.mark.parametrize("case", ["lattice", "city", "stragglers"])
@pytest.mark.parametrize("cycles", [1, 2, 0])
def test_sweep_equals_plain(dev, case, cycles):
    """The loop at a cut and converged, with the plain loop's cycle
    count; on a lattice alone one launch runs every cycle, with
    off-lattice edges one launch a cycle."""
    g, gg = _sweep_graph(case)
    t = _targets(g.n, 77, cycles)
    want = grid_sweep.dist_to_targets_sweep(gg, t, cycles)
    _, want_cyc = cbk.sweep_dist(gg.on("cpu"), torch.as_tensor(t), cycles)
    before = cbk.grid_sweep.launches
    d, n_cyc = cbk.sweep_dist(gg.on(dev), torch.as_tensor(t, device=dev),
                              cycles)
    torch.cuda.synchronize()
    assert torch.equal(d.T.cpu(), want)
    assert n_cyc == want_cyc
    assert cbk.grid_sweep.launches - before == (
        1 if case == "lattice" else n_cyc)
    if cycles:
        assert n_cyc == cycles


#: lattices (width, height) for the sweep's shapes: a row one warp
#: covers; 1,100 cells, a row two warps cover at one or two columns a
#: block and two pieces at four or eight
SWEEP_WIDTHS = [(37, 29), (1100, 3)]


@pytest.mark.parametrize("size", SWEEP_WIDTHS)
@pytest.mark.parametrize("cols", cbk.SWEEP_COLS)
def test_sweep_cycle_any_column_group(dev, cols, size):
    """One cycle from random distances (every cell moves) at each count
    of columns a block, and the per-group loop's cycles and count,
    against the CPU branch."""
    g = synth_city_graph(*size, seed=4)
    gg = grid_sweep.GridGraph.from_graph(g)
    rng = np.random.default_rng(cols * 10 + size[0])
    d_np = rng.integers(0, 10 ** 9 + 1, (g.n, 40)).astype(np.int32)
    d_np[rng.random(d_np.shape) < 0.4] = 10 ** 9
    want = torch.tensor(d_np)     # a copy: the plain sweep is in place
    grid_sweep.sweep_quadrants(gg.on("cpu"), want)
    d = torch.as_tensor(d_np, device=dev)
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    cbk.grid_sweep(gg.on(dev), d, flag, cols=cols)
    torch.cuda.synchronize()
    assert torch.equal(d.cpu(), want) and int(flag.item()) == 1
    t = torch.as_tensor(_targets(g.n, 40, cols))
    sides = []
    for where in ("cpu", dev):
        dd = bellman_ford.init_dist(g.n, t.to(where))
        fl = torch.zeros(1, dtype=torch.int32, device=where)
        counter = torch.zeros(1, dtype=torch.int32, device=where)
        cbk.grid_sweep(gg.on(where), dd, fl, cycles=50, counter=counter,
                       cols=cols)
        sides.append((dd.cpu(), int(counter.item()), int(fl.item())))
    assert torch.equal(sides[0][0], sides[1][0])
    assert sides[0][1:] == sides[1][1:]


def test_sweep_fused_only_on_lattice(dev):
    """With shift planes and stragglers the loop is a launch a cycle, the
    off-lattice stage between (at a cut, with no fused launch); on the
    same grid without them one launch runs the cut's cycles."""
    g, gg = _grid_with_stragglers()
    t = torch.as_tensor(_targets(g.n, 64, 3), device=dev)
    sweeps, relax = cbk.grid_sweep.launches, cbk.relax_jacobi.launches
    d, n_cyc = cbk.sweep_dist(gg.on(dev), t, 2)
    torch.cuda.synchronize()
    assert n_cyc == 2
    assert cbk.grid_sweep.launches - sweeps == 2
    assert cbk.relax_jacobi.launches - relax == 4     # planes, stragglers
    want = grid_sweep.dist_to_targets_sweep(gg, t.cpu(), 2)
    assert torch.equal(d.T.cpu(), want)
    lat = grid_sweep.GridGraph.from_graph(
        synth_city_graph(40, 33, seed=2, shortcut_frac=0.0))
    assert lat.on(dev).shift_csr is None and lat.on(dev).left_csr is None
    t = torch.as_tensor(_targets(lat.n, 64, 3), device=dev)
    sweeps = cbk.grid_sweep.launches
    d, n_cyc = cbk.sweep_dist(lat.on(dev), t, 2)
    torch.cuda.synchronize()
    assert n_cyc == 2 and cbk.grid_sweep.launches - sweeps == 1
    assert torch.equal(d.T.cpu(),
                       grid_sweep.dist_to_targets_sweep(lat, t.cpu(), 2))


@pytest.mark.parametrize("cols", [1, 8])
def test_sweep_wide_lattice_in_pieces(dev, cols):
    """A lattice 6,000 cells wide (past the 2,552 a block holds at one
    column, so rows go in pieces): ``auto`` builds it by sweep; one cycle
    from random distances equals the plain cycle, and the loop equals
    the plain loop at a cut and at convergence with its cycle count, in
    one launch."""
    g = synth_city_graph(6000, 6, seed=6, shortcut_frac=0.0)
    kind, gg = cpd.pick_build_kernel(g, "auto")
    assert kind == "sweep" and gg.width == 6000
    rng = np.random.default_rng(cols)
    d_np = rng.integers(0, 10 ** 9 + 1, (g.n, 16)).astype(np.int32)
    d_np[rng.random(d_np.shape) < 0.4] = 10 ** 9
    want = torch.tensor(d_np)
    grid_sweep.sweep_quadrants(gg.on("cpu"), want)
    d = torch.as_tensor(d_np, device=dev)
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    cbk.grid_sweep(gg.on(dev), d, flag, cols=cols)
    torch.cuda.synchronize()
    assert torch.equal(d.cpu(), want) and int(flag.item()) == 1
    t = _targets(g.n, 40, cols)
    for cut in (1, 0):
        want_d, want_cyc = cbk.sweep_dist(gg.on("cpu"), torch.as_tensor(t),
                                          cut)
        before = cbk.grid_sweep.launches
        got, n_cyc = cbk.sweep_dist(gg.on(dev),
                                    torch.as_tensor(t, device=dev), cut)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want_d) and n_cyc == want_cyc
        assert cbk.grid_sweep.launches - before == 1


@pytest.mark.parametrize("b", [70, 128])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_first_moves_equal_plain(dev, name, b):
    """2 and 4 columns a lane."""
    g = GRAPHS[name]()
    t = _targets(g.n, b, 1)
    dg_cpu = DeviceGraph.from_graph(g, device="cpu")
    dist = bellman_ford.dist_to_targets(dg_cpu, t)
    want = bellman_ford.first_move_from_dist(dg_cpu, t, dist)
    assert bool((want == -1).any())
    dg = DeviceGraph.from_graph(g, device=dev)
    before = cbk.first_moves.launches
    got = cbk.first_moves(dg, torch.as_tensor(t, device=dev),
                          dist.T.contiguous().to(dev))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert cbk.first_moves.launches == before + 1
    # pad targets' rows and each target's own column are -1
    assert bool((got[torch.as_tensor(t < 0)] == -1).all())


@pytest.mark.parametrize("cut", [1, 3, 0])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_dist_to_targets_equals_plain(dev, name, cut):
    """``bellman_ford.dist_to_targets`` on the card runs K1's loop and
    gives the plain loop's distances at cuts and at convergence."""
    g = GRAPHS[name]()
    t = _targets(g.n, 70, 2)
    want = bellman_ford.dist_to_targets(
        DeviceGraph.from_graph(g, device="cpu"), t, max_iters=cut)
    before = cbk.relax_jacobi.launches
    got = bellman_ford.dist_to_targets(DeviceGraph.from_graph(g, device=dev),
                                       t, max_iters=cut)
    torch.cuda.synchronize()
    assert got.device.type == "cuda" and torch.equal(got.cpu(), want)
    assert cbk.relax_jacobi.launches > before


def _files(d):
    import os
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d)) if os.path.isfile(
                os.path.join(d, f))}


@pytest.mark.parametrize("pipeline", ["1", "0"])
@pytest.mark.parametrize("codec", ["raw", "pack4"])
def test_shard_build_on_card_equals_cpu(dev, tmp_path, monkeypatch,
                                        pipeline, codec):
    """The pipelined (and the serial) shard build on the card writes the
    CPU build's blocks and ledger, byte for byte: 10 blocks of 16 rows in
    chunks of 8, the copy of each block queued into pinned memory."""
    g = synth_road_network(600, seed=2)
    dc = DistributionController("mod", 4, 4, g.n, block_size=16)
    cpu = str(tmp_path / "cpu")
    cpd.build_worker_shard(g, dc, 0, cpu, chunk=8, device="cpu",
                           codec=codec)
    monkeypatch.setenv("DOS_BUILD_PIPELINE", pipeline)
    card = str(tmp_path / "card")
    before = cbk.first_moves.launches
    written = cpd.build_worker_shard(g, dc, 0, card, chunk=8, device=dev,
                                     codec=codec)
    assert len(written) == 10
    assert cbk.first_moves.launches - before == 19    # one a chunk
    assert _files(card) == _files(cpu)


def test_delta_on_card_equals_cpu(dev, tmp_path):
    """The tense-edge pass (K1 on the transposed graph), the recompute
    (K1/K2) and the splice on the card give the CPU's dirty targets and
    epoch index; a promoted engine on the card answers as the CPU's."""
    import shutil

    from distributed_oracle_search_tpu_torch.data import write_diff
    from distributed_oracle_search_tpu_torch.transport import RuntimeConfig
    from distributed_oracle_search_tpu_torch.worker import engine

    g = synth_road_network(600, seed=2)
    dc = DistributionController("mod", 4, 4, g.n, block_size=16)
    old = str(tmp_path / "old")
    for wid in range(4):
        cpd.build_worker_shard(g, dc, wid, old, chunk=32, device="cpu")
    cpd.write_index_manifest(old, dc)
    rng = np.random.default_rng(4)
    eids = rng.choice(g.m, 2, replace=False)
    fused = str(tmp_path / "fused-e000001.diff")
    write_diff(fused, g.src[eids], g.dst[eids],
               g.w[eids].astype(np.int64) * 4)
    w_new = g.weights_with_diff(fused)
    want = cpd.delta_affected_targets(g, eids, g.w, w_new, device="cpu")
    before = cbk.relax_jacobi.launches
    got = cpd.delta_affected_targets(g, eids, g.w, w_new, device=dev)
    assert np.array_equal(got, want) and cbk.relax_jacobi.launches > before
    reps = {}
    for name, device in (("cpu", "cpu"), ("card", dev)):
        shutil.copytree(old, str(tmp_path / name))
        reps[name] = cpd.delta_build_index(g, dc, str(tmp_path / name),
                                           fused, chunk=32, device=device)
    assert reps["card"]["blocks_skipped"] > 0
    assert {**reps["card"], "outdir": 0} == {**reps["cpu"], "outdir": 0}
    assert _files(reps["card"]["outdir"]) == _files(reps["cpu"]["outdir"])
    q = np.stack([rng.integers(0, g.n, 64), rng.choice(dc.owned(0), 64)], 1)
    answers = []
    for name, device in (("cpu", "cpu"), ("card", dev)):
        eng = engine.ShardEngine(g, dc, 0, str(tmp_path / name),
                                 device=device)
        assert eng.promote_index(reps[name]["outdir"], 1)
        answers.append(eng.answer(q, RuntimeConfig(), difffile=fused)[:3])
    for a, b in zip(*answers):
        assert np.array_equal(a, b)


def test_first_moves_rows_past_two_gigabytes(dev):
    """An int8 ``[33_000, 65_536]`` table is 2.16 GB: K2 writes 48 rows
    of a 64-column batch into rows that start past byte 2^31, leaving
    the rest of the table as it was."""
    g = synth_city_graph(256, 256, seed=3)
    assert g.n == 65_536
    dg = DeviceGraph.from_graph(g, device=dev)
    t = torch.as_tensor(_targets(g.n, 64, 9), device=dev)
    dist, _ = cbk.jacobi_dist(cbk.csr_from_ell(dg), t)
    alone = cbk.first_moves(dg, t, dist)
    big = torch.full((33_000, g.n), 7, dtype=torch.int8, device=dev)
    at = 33_000 - 48 - 5
    assert at * g.n > 2 ** 31
    out = cbk.first_moves(dg, t, dist, out=big[at:at + 48])
    torch.cuda.synchronize()
    assert out.data_ptr() == big[at].data_ptr()
    assert torch.equal(big[at:at + 48], alone[:48])
    assert bool((big[:at] == 7).all()) and bool((big[at + 48:] == 7).all())
    plain = bellman_ford.first_move_from_dist(dg, t, dist.T.contiguous())
    assert torch.equal(alone, plain)


@pytest.mark.parametrize("method", ["auto", "sweep", "shift", "frontier",
                                    "ellsplit", "ell"])
def test_every_method_builds_the_cpu_table(dev, method):
    g = synth_city_graph(33, 21, seed=5)
    dc = DistributionController("tpu", 8, 8, g.n)
    cpu = cpd.CPDOracle(g, dc, device="cpu").build(chunk=40, method=method)
    counts = (cbk.relax_jacobi.launches, cbk.first_moves.launches,
              cbk.grid_sweep.launches)
    card = cpd.CPDOracle(g, dc, device=dev).build(chunk=40, method=method)
    torch.cuda.synchronize()
    assert torch.equal(card.fm.cpu(), cpu.fm)
    relax, fms, sweeps = (a - b for a, b in zip(
        (cbk.relax_jacobi.launches, cbk.first_moves.launches,
         cbk.grid_sweep.launches), counts))
    assert fms == 8 * -(-card.targets_wr.shape[1] // 40)   # one a chunk
    assert (sweeps > 0) == (method == "sweep")
    if method != "sweep":
        assert (relax > 0) == (method != "frontier")


def test_build_failure_raises(dev, tmp_path, monkeypatch):
    """A source that does not compile raises at the first call; nothing
    falls back to the plain version."""
    (tmp_path / f"{cbk.KERNEL_NAME}.cu").write_text("this is not CUDA\n")
    monkeypatch.setattr(cuda_build, "CSRC_DIR", str(tmp_path))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(cuda_build, "_loaded", {})
    monkeypatch.setattr(cbk, "_fns", {})
    g = synth_city_graph(8, 6, seed=1)
    dg = DeviceGraph.from_graph(g, device=dev)
    before = cbk.relax_jacobi.launches
    with pytest.raises(RuntimeError, match="nvcc failed"):
        bellman_ford.build_fm_columns(dg, torch.arange(4, dtype=torch.int32,
                                                       device=dev))
    assert cbk.relax_jacobi.launches == before


def test_refused_launch_raises(dev):
    """The sweep entry refuses a column group that does not divide the
    batch, and a cap of no cycles; the wrapper turns the returned error
    into an exception."""
    g = synth_city_graph(8, 6, seed=1)
    gd = grid_sweep.GridGraph.from_graph(g).on(dev)
    d = torch.zeros((g.n, 4), dtype=torch.int32, device=dev)
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    dt = torch.empty((4, gd.height, gd.wpad.shape[2]), dtype=torch.int32,
                     device=dev)
    for cols, cycles in ((3, 1), (1, 0)):
        with pytest.raises(RuntimeError, match="launch failed"):
            cbk._launch(cbk.SWEEP_ENTRY, dev, gd.wpad.data_ptr(),
                        d.data_ptr(), dt.data_ptr(), flag.data_ptr(), None,
                        gd.height, gd.width, 4, cols, cycles)
    with pytest.raises(ValueError, match="cols must"):
        cbk.grid_sweep(gd, d, flag, cols=3)
    csr = cbk.csr_from_ell(DeviceGraph.from_graph(g, device=dev))
    with pytest.raises(ValueError, match="second buffer"):
        cbk.relax_jacobi(csr, d, d, flag)
    for order, span, vec in ((None, None, 3),
                             (csr.order.data_ptr(), None, 1)):
        with pytest.raises(RuntimeError, match="launch failed"):
            cbk._launch(cbk.RELAX_ENTRY, dev, csr.row_ptr.data_ptr(),
                        csr.col.data_ptr(), csr.wt.data_ptr(), order, span,
                        d.data_ptr(), d.clone().data_ptr(), flag.data_ptr(),
                        None, None, None, g.n, 4, vec)
    with pytest.raises(ValueError, match="aligned"):
        buf = torch.zeros(g.n * 2 + 1, dtype=torch.int32, device=dev)
        cbk.relax_jacobi(csr, buf[1:].view(g.n, 2),
                         torch.zeros((g.n, 2), dtype=torch.int32,
                                     device=dev), flag, vec=2)


def _worker_build(dev):
    """Worker 0's targets of a 4-worker road, its ``ellsplit`` kind and
    its graph on ``dev``."""
    g = GRAPHS["road"]()
    dc = DistributionController("mod", 4, 4, g.n)
    return (DeviceGraph.from_graph(g, device=dev),
            sharded.pad_targets(dc)[[0]], cpd.pick_build_kernel(g, "ellsplit"))


def test_shard_build_counts_the_cpu_loops_pairs(dev):
    dg, targets, kernel = _worker_build(dev)
    stats = {}
    cbk.jacobi_dist(cbk.csr_from_ell(DeviceGraph.from_graph(
        GRAPHS["road"](), device="cpu")), torch.from_numpy(targets[0]),
        stats=stats)
    before = cbk.relax_jacobi.active_pairs
    sharded.build_fm_sharded(dg, targets, kernel=kernel)
    torch.cuda.synchronize()
    assert cbk.relax_jacobi.active_pairs - before == stats["active_pairs"]
    assert stats["active_pairs"] <= stats["steps"] * stats["pairs_per_step"]


def test_profiled_build_spans_lead_the_relax_kernels(dev):
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "benchmark"))
    from harness import trace as htrace

    dg, targets, kernel = _worker_build(dev)
    sharded.build_fm_sharded(dg, targets, kernel=kernel)      # warm
    torch.cuda.synchronize()
    launches = cbk.relax_jacobi.launches
    with htrace.profiled(True) as prof:
        sharded.build_fm_sharded(dg, targets, kernel=kernel)
        torch.cuda.synchronize()
    launches = cbk.relax_jacobi.launches - launches
    events = prof.profiler.kineto_results.events()
    card = [("cuda" in str(ev.device_type()).lower(), ev) for ev in events]
    steps = sorted(ev.start_ns() for on, ev in card
                   if not on and ev.name() == "build.step_launch")
    k1 = sorted(ev.start_ns() for on, ev in card
                if on and htrace.base_name(ev.name()) == "relax_jacobi_kernel")
    assert len(k1) == len(steps) == launches > 0
    assert all(k > s for k, s in zip(k1, steps))
    names = {ev.name() for ev in events if ev.is_user_annotation()}
    assert {"build.shard", "build.csr", "build.relax", "build.step_launch",
            "build.flag_read", "build.first_moves"} <= names
    red = htrace.reduce(prof)
    assert "relax_jacobi_kernel" in red["kernels"]
    assert not set(red["kernels"]) & names
