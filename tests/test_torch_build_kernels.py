"""PyTorch port, the build's distance stages on the CPU, held against
the JAX package (ground truth), tolerance exact: each plain stage
(``ellsplit``, ``shift``, ``sweep``, ``frontier``) and the kernel loops'
CPU branches (``jacobi_dist`` over the full out-edge CSR, ``sweep_dist``)
give the JAX counterpart's distances at convergence and after 1, 2 and 3
steps (cycles for the sweep, pops for the frontier), on degree-skewed,
grid-with-shortcuts, grid-with-stragglers, shuffled and one-way
(unreachable pairs) graphs with pad targets; the frontier ends on
near-INF weights; the extraction wrapper's CPU branch gives the JAX
first moves."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)

from distributed_oracle_search_tpu.data import (  # noqa: E402
    synth_city_graph as jcity, synth_road_network as jroad,
)
from distributed_oracle_search_tpu.data.graph import Graph as JGraph  # noqa: E402
from distributed_oracle_search_tpu.ops import (  # noqa: E402
    DeviceGraph as JDeviceGraph, bellman_ford as jbf, ell_split as jes,
    frontier_relax as jfr, grid_sweep as jgs, shift_relax as jsr,
)
from distributed_oracle_search_tpu_torch.data.graph import Graph  # noqa: E402
from distributed_oracle_search_tpu_torch.ops import (  # noqa: E402
    DeviceGraph, cuda_build_kernels as cbk, ell_split, frontier_relax,
    grid_sweep, shift_relax,
)


def _arrays(jg):
    return jg.xs, jg.ys, jg.src, jg.dst, jg.w


def _oneway(w: int = 7, h: int = 5):
    """A ``w x h`` row-major lattice with only rightward and upward
    edges: most pairs are unreachable, and ``grid_split`` fits it."""
    ids = np.arange(w * h)
    right = ids[ids % w < w - 1]
    up = ids[ids // w < h - 1]
    src = np.concatenate([right, up])
    dst = np.concatenate([right + 1, up + w])
    wt = np.random.default_rng(3).integers(1, 50, len(src)).astype(np.int32)
    return ids % w, ids // w, src, dst, wt


def _stragglers():
    """A 24 x 17 city (lattice + shortcut shift planes) with six long
    edges past the shift planes' 256-id cap: ``grid_split`` keeps them
    as stragglers."""
    xs, ys, src, dst, w = _arrays(jcity(24, 17, seed=3))
    extra = np.array([0, 5, 50, 100, 101, 7])
    return (xs, ys, np.r_[src, extra, extra + 300],
            np.r_[dst, extra + 300, extra],
            np.r_[w, np.full(12, 40, np.int32)])


def _shuffled():
    jg = jcity(9, 8, seed=7)
    return _arrays(jg.reorder(np.random.default_rng(0).permutation(jg.n)))


GRAPHS = {
    "road": lambda: _arrays(jroad(150, seed=5)),   # degree-skewed
    "city": lambda: _arrays(jcity(12, 9, seed=3)),  # + shortcut planes
    "stragglers": _stragglers,
    "shuffled": _shuffled,                          # a big leftover ELL
    "oneway": _oneway,
}

#: the grid width where ``grid_split`` infers none (shuffled ids: the
#: sweep still runs, on a lattice that is mostly off-lattice edges)
SWEEP_WIDTH = {"shuffled": 9}

#: the shift stage's plane cap: the JAX program unrolls one slice per
#: plane, so a few planes keep its compile short (the leftover ELL then
#: carries the rest, which exercises it too)
SHIFT_PLANES = 6

#: graphs each stage is held on
STAGE_GRAPHS = {
    "ellsplit": ("road", "city", "oneway"),
    "shift": ("road", "shuffled", "oneway"),
    "sweep": ("city", "stragglers", "shuffled", "oneway"),
    "frontier": ("road", "city", "oneway"),
    "jacobi": ("road", "stragglers"),
    "sweep-loop": ("stragglers", "oneway"),
}


def _pair(name):
    arrays = GRAPHS[name]()
    return JGraph(*arrays), Graph(*arrays)


def test_graphs_cover_every_edge_kind():
    """The sweep graphs carry shift planes and stragglers, and the shift
    graphs a leftover ELL, so every branch of both stages runs."""
    for name in ("city", "stragglers"):
        assert grid_sweep.GridGraph.from_graph(_pair(name)[1]).shifts
    assert grid_sweep.GridGraph.from_graph(_pair("stragglers")[1]).n_left
    assert grid_sweep.GridGraph.from_graph(_pair("shuffled")[1], 9).n_left
    for name in ("road", "shuffled"):
        assert shift_relax.ShiftGraph.from_graph(_pair(name)[1],
                                                 SHIFT_PLANES).k_left


def _targets(n: int) -> np.ndarray:
    """Every third node, with pad columns in the middle and at the end."""
    t = np.arange(0, n, 3, dtype=np.int32)
    return np.concatenate([t[:5], [-1], t[5:], [-1, -1]]).astype(np.int32)


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def _jax_dist(stage, jg, t, cut, width=None):
    """The JAX counterpart of a port stage: ``[B, N]`` numpy."""
    tj = jnp.asarray(t)
    if stage in ("ellsplit",):
        sg = jes.ell_split_graph(jg)
        fn = jes._ellsplit_dist_fn(sg.n, sg.k0, len(sg.u_ov), cut)
        return np.asarray(fn(*(jnp.asarray(a) for a in (
            sg.nbr0, sg.w0, sg.u_ov, sg.v_ov, sg.w_ov)), tj))
    if stage == "shift":
        return np.asarray(jsr.dist_to_targets_shift(
            jsr.ShiftGraph.from_graph(jg, SHIFT_PLANES), tj, max_iters=cut))
    if stage in ("sweep", "sweep-loop"):
        return np.asarray(jgs.dist_to_targets_sweep(
            jgs.GridGraph.from_graph(jg, width), tj, max_iters=cut))
    if stage == "frontier":
        fg = jfr.frontier_graph(jg, f=16)
        dg = JDeviceGraph.from_graph(jg)
        fn = jfr._frontier_dist_fn(fg.n, fg.f, fg.delta, fg.s_unroll, cut)
        return np.asarray(fn(dg.out_nbr, dg.out_eid, dg.w_pad,
                             jnp.asarray(fg.in_nbr), tj))
    return np.asarray(jbf.dist_to_targets(JDeviceGraph.from_graph(jg), tj,
                                          max_iters=cut))


def _port_dist(stage, tg, t, cut, width=None):
    tt = torch.as_tensor(t)
    if stage == "ellsplit":
        return ell_split.dist_to_targets_split(
            ell_split.ell_split_graph(tg), t, cut)
    if stage == "shift":
        return shift_relax.dist_to_targets_shift(
            shift_relax.ShiftGraph.from_graph(tg, SHIFT_PLANES), t, cut)
    if stage == "sweep":
        return grid_sweep.dist_to_targets_sweep(
            grid_sweep.GridGraph.from_graph(tg, width), t, cut)
    if stage == "sweep-loop":
        gd = grid_sweep.GridGraph.from_graph(tg, width).on("cpu")
        return cbk.sweep_dist(gd, tt, cut)[0].T
    dg = DeviceGraph.from_graph(tg, device="cpu")
    if stage == "frontier":
        return frontier_relax.dist_to_targets_frontier(
            dg, frontier_relax.frontier_graph(tg, f=16), t, cut)
    return cbk.jacobi_dist(cbk.csr_from_ell(dg), tt, cut)[0].T


@pytest.mark.parametrize("stage,name", [
    (stage, name) for stage, names in STAGE_GRAPHS.items() for name in names])
@pytest.mark.parametrize("cut", [0, 1, 2, 3])
def test_distance_stage_equal(stage, name, cut):
    jg, tg = _pair(name)
    t = _targets(tg.n)
    width = SWEEP_WIDTH.get(name)
    want = _jax_dist(stage, jg, t, cut, width)
    got = _port_dist(stage, tg, t, cut, width)
    _eq(got.contiguous(), want)
    if cut == 0:
        # converged: every stage reaches the ELL Bellman-Ford fixed point
        _eq(got.contiguous(), _jax_dist("ell", jg, t, 0))


def test_frontier_near_inf_weights_terminate():
    """Weights near INF push theta past INF: idle nodes must not pop."""
    jg0 = jcity(8, 6, seed=7)
    arrays = (jg0.xs, jg0.ys, jg0.src, jg0.dst,
              np.full(jg0.m, 500_000_000, np.int32))
    jg, tg = JGraph(*arrays), Graph(*arrays)
    fg = frontier_relax.frontier_graph(tg)
    assert fg.delta == 1 << 29
    t = np.arange(0, tg.n, 2, dtype=np.int32)
    want = np.asarray(jbf.build_fm_columns(JDeviceGraph.from_graph(jg),
                                           jnp.asarray(t)))
    dg = DeviceGraph.from_graph(tg, device="cpu")
    _eq(frontier_relax.build_fm_columns_frontier(dg, fg, t), want)


@pytest.mark.parametrize("name", ["road", "stragglers", "oneway"])
def test_first_moves_wrapper_cpu_branch(name):
    jg, tg = _pair(name)
    t = _targets(tg.n)
    dist = np.array(jbf.dist_to_targets(JDeviceGraph.from_graph(jg),
                                        jnp.asarray(t)))
    want = np.asarray(jbf.first_move_from_dist(
        JDeviceGraph.from_graph(jg), jnp.asarray(t), jnp.asarray(dist)))
    dg = DeviceGraph.from_graph(tg, device="cpu")
    before = cbk.first_moves.launches
    tt = torch.as_tensor(t)
    got = cbk.first_moves(dg, tt, torch.as_tensor(dist).T.contiguous())
    _eq(got, want)
    out = torch.full((len(t) - 2, tg.n), 5, dtype=torch.int8)
    cbk.first_moves(dg, tt, torch.as_tensor(dist).T.contiguous(), out=out)
    _eq(out, want[:len(t) - 2])
    assert cbk.first_moves.launches == before     # no kernel on the CPU


