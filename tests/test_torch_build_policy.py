"""PyTorch port, the build policy's host side, held against the JAX
package (ground truth), tolerance exact: ``Graph.shift_split`` and
``grid_split`` and the bundles ``ELLSplitGraph``, ``ShiftGraph``,
``GridGraph``, ``FrontierGraph`` with their gates' numbers, array by
array; the policy's constants; and ``pick_build_kernel`` resolving every
method to the JAX package's kind (and k0, shifts, grid dims) on the
graphs the JAX tests name, the campaign's 65,536-node road network and
a grid past the sweep's size gate among them."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)

from distributed_oracle_search_tpu.data import (  # noqa: E402
    synth_city_graph as jcity, synth_road_network as jroad,
)
from distributed_oracle_search_tpu.data.graph import Graph as JGraph  # noqa: E402
from distributed_oracle_search_tpu.models import cpd as jcpd  # noqa: E402
from distributed_oracle_search_tpu.ops import (  # noqa: E402
    ell_split as jes, frontier_relax as jfr, grid_sweep as jgs,
    shift_relax as jsr,
)
from distributed_oracle_search_tpu_torch.data.graph import Graph  # noqa: E402
from distributed_oracle_search_tpu_torch.models import cpd  # noqa: E402
from distributed_oracle_search_tpu_torch.ops import (  # noqa: E402
    ell_split, frontier_relax, grid_sweep, shift_relax,
)


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


def _arrays(jg):
    return jg.xs, jg.ys, jg.src, jg.dst, jg.w


def _shuffled(jg, seed=0):
    perm = np.random.default_rng(seed).permutation(jg.n)
    return _arrays(jg.reorder(perm))


#: name -> arrays (xs, ys, src, dst, w); every one has a grid layout
GRAPHS = {
    # degree-skewed road network (grid_split fits a lattice it does not
    # follow: shift planes and stragglers beside the lattice edges)
    "road": lambda: _arrays(jroad(400, seed=5)),
    # city grid with constant-offset shortcuts (shift planes)
    "city": lambda: _arrays(jcity(12, 9, seed=3)),
    # the same city with shuffled ids: a big leftover ELL
    "shuffled": lambda: _shuffled(jcity(9, 8, seed=7)),
    "oneway": _oneway,
}


#: grid width for the sweep where ``grid_split`` infers none (shuffled
#: ids: the sweep still runs, on a lattice that is mostly stragglers)
SWEEP_WIDTH = {"shuffled": 9}


def _pair(name):
    arrays = GRAPHS[name]()
    return JGraph(*arrays), Graph(*arrays)


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)



# ------------------------------------------------------ host structures

@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("max_shifts", [64, 4])
def test_shift_split_equal(name, max_shifts):
    jg, tg = _pair(name)
    want, got = jg.shift_split(max_shifts), tg.shift_split(max_shifts)
    assert got[0] == want[0]
    for a, b in zip(got[1:], want[1:]):
        _eq(a, b)


def test_shift_split_takes_min_of_parallel_edges():
    arrays = ([0, 1], [0, 0], [0, 0], [1, 1], [7, 3])
    want = JGraph(*arrays).shift_split()
    got = Graph(*arrays).shift_split()
    assert got[0] == want[0] and got[1][got[0].index(1)][0] == 3
    for a, b in zip(got[1:], want[1:]):
        _eq(a, b)


@pytest.mark.parametrize("name", sorted(GRAPHS) + ["star", "grid16"])
def test_grid_split_equal(name):
    if name == "star":
        n = 12
        arrays = (np.arange(n), np.arange(n),
                  np.r_[np.zeros(n - 1, np.int64), np.arange(1, n)],
                  np.r_[np.arange(1, n), np.zeros(n - 1, np.int64)],
                  np.full(2 * (n - 1), 5, np.int32))
    elif name == "grid16":
        arrays = _arrays(jcity(16, 16, seed=2))
    else:
        arrays = GRAPHS[name]()
    want, got = JGraph(*arrays).grid_split(), Graph(*arrays).grid_split()
    assert (got is None) == (want is None)
    if want is None:
        return
    assert got[:2] == want[:2] and got[6] == want[6]
    for i in (2, 3, 4, 5, 7, 8, 9, 10):
        _eq(got[i], want[i])


def test_grid_split_coverage_and_stragglers():
    arrays = _arrays(jcity(16, 16, seed=2))
    want = jgs.GridGraph.from_graph(JGraph(*arrays))
    got = grid_sweep.GridGraph.from_graph(Graph(*arrays))
    assert got.coverage() == want.coverage() > 0.99
    assert got.lattice_coverage() == want.lattice_coverage()
    n_struct = (int((got.w_shift < 10 ** 9).sum())
                + sum(int((a < 10 ** 9).sum())
                      for a in (got.wl, got.wr, got.wd, got.wu)))
    assert n_struct + got.n_left == len(arrays[2])


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_bundles_equal(name):
    jg, tg = _pair(name)
    # ELL+COO split
    deg = np.diff(tg.out_ptr)
    assert ell_split.pick_k0(deg, tg.max_out_degree) == jes.pick_k0(
        np.diff(jg.out_ptr), jg.max_out_degree)
    assert ell_split.split_ratio(deg, tg.max_out_degree) == jes.split_ratio(
        np.diff(jg.out_ptr), jg.max_out_degree)
    for k0 in (None, 1, 2):
        want, got = jes.ell_split_graph(jg, k0), ell_split.ell_split_graph(
            tg, k0)
        assert (got.k0, got.n) == (want.k0, want.n)
        for f in ("nbr0", "w0", "u_ov", "v_ov", "w_ov"):
            _eq(getattr(got, f), getattr(want, f))
    # shift
    want = jsr.ShiftGraph.from_graph(jg)
    got = shift_relax.ShiftGraph.from_graph(tg)
    assert (got.shifts, got.n, got.k_left, got.coverage()) == (
        want.shifts, want.n, want.k_left, want.coverage())
    for f in ("w_shift", "nbr_left", "w_left"):
        _eq(getattr(got, f), getattr(want, f))
    # grid
    width = SWEEP_WIDTH.get(name)
    want = jgs.GridGraph.from_graph(jg, width)
    got = grid_sweep.GridGraph.from_graph(tg, width)
    assert (got.width, got.height, got.shifts, got.n, got.n_left) == (
        want.width, want.height, want.shifts, want.n, want.n_left)
    assert (got.coverage(), got.lattice_coverage()) == (
        want.coverage(), want.lattice_coverage())
    for f in ("wl", "wr", "wd", "wu", "w_shift", "src_left", "dst_left",
              "w_left"):
        _eq(getattr(got, f), getattr(want, f))
    # frontier
    assert frontier_relax.locality_fraction(tg) == jfr.locality_fraction(jg)
    assert frontier_relax.pick_delta(tg.w) == jfr.pick_delta(jg.w)
    for kw in ({}, {"f": 16, "delta": 1 << 31, "s_unroll": 3}):
        want = jfr.frontier_graph(jg, **kw)
        got = frontier_relax.frontier_graph(tg, **kw)
        assert (got.n, got.f, got.delta, got.s_unroll) == (
            want.n, want.f, want.delta, want.s_unroll)
        _eq(got.in_nbr, want.in_nbr)


def test_constants_equal():
    for name in ("SHIFT_COVERAGE_MIN", "SWEEP_COVERAGE_MIN", "SWEEP_MIN_NODES",
                 "ELLSPLIT_RATIO_MAX", "FRONTIER_MIN_NODES",
                 "FRONTIER_LOCALITY_MIN"):
        assert getattr(cpd, name) == getattr(jcpd, name)
    assert ell_split.SCATTER_COST == jes.SCATTER_COST
    assert frontier_relax.FRONTIER_CAPACITY == jfr.FRONTIER_CAPACITY
    assert frontier_relax.DELTA_MEAN_W_MULT == jfr.DELTA_MEAN_W_MULT


# --------------------------------------------------------------- policy

def _rcm(jg):
    return _arrays(jg.reorder(jg.rcm_order()))


#: (graph, method) pairs of the JAX policy tests, plus the campaign's
#: road network and the chip smoke's grid
POLICY = {
    "city10": lambda: _arrays(jcity(10, 10, seed=4)),
    "toy": lambda: _arrays(jcity(8, 6, seed=7)),
    "road800": lambda: _arrays(jroad(800, seed=5)),
    "road800-rcm": lambda: _rcm(jroad(800, seed=5)),
    "road32k": lambda: _arrays(jroad(jcpd.FRONTIER_MIN_NODES, seed=1)),
    "road32k-rcm": lambda: _rcm(jroad(jcpd.FRONTIER_MIN_NODES, seed=1)),
    "road65k": lambda: _arrays(jroad(65_536, seed=0)),
    "grid200": lambda: _arrays(jcity(200, 200, seed=0, shortcut_frac=0.0)),
    "star": lambda: (np.arange(12), np.arange(12),
                     np.r_[np.zeros(11, np.int64), np.arange(1, 12)],
                     np.r_[np.arange(1, 12), np.zeros(11, np.int64)],
                     np.full(22, 5, np.int32)),
}

#: the kind the JAX package's ``auto`` gives, pinned (it is also compared)
AUTO_KIND = {"city10": "shift", "toy": "shift", "road800": "ellsplit",
             "road800-rcm": "ellsplit", "road32k": "ellsplit",
             "road32k-rcm": "frontier", "road65k": "ellsplit",
             "grid200": "sweep", "star": "shift"}


def _same_structure(kind, got, want):
    if kind == "ell":
        assert got is None and want is None
    elif kind == "ellsplit":
        assert (got.k0, len(got.u_ov)) == (want.k0, len(want.u_ov))
        _eq(got.w0, want.w0)
    elif kind == "shift":
        assert (got.shifts, got.k_left) == (want.shifts, want.k_left)
    elif kind == "sweep":
        assert (got.width, got.height, got.shifts, got.n_left) == (
            want.width, want.height, want.shifts, want.n_left)
    else:
        assert (got.f, got.delta, got.s_unroll) == (want.f, want.delta,
                                                    want.s_unroll)


@pytest.mark.parametrize("name", sorted(POLICY))
@pytest.mark.parametrize("method", ["auto", "sweep", "shift", "frontier",
                                    "ellsplit", "ell"])
def test_pick_build_kernel_equal(name, method):
    arrays = POLICY[name]()
    jg, tg = JGraph(*arrays), Graph(*arrays)
    try:
        want = jcpd.pick_build_kernel(jg, method)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split("(")[0][:30]):
            cpd.pick_build_kernel(tg, method)
        return
    got = cpd.pick_build_kernel(tg, method)
    assert got[0] == want[0]
    _same_structure(got[0], got[1], want[1])
    if method == "auto":
        assert got[0] == AUTO_KIND[name]


def test_campaign_graph_policy():
    """The campaign's ``synth_road_network(65_536, seed=0)``: ellsplit,
    k0 = 5, 38,800 overflow edges."""
    kind, st = cpd.pick_build_kernel(Graph(*POLICY["road65k"]()), "auto")
    assert (kind, st.k0, len(st.u_ov)) == ("ellsplit", 5, 38_800)


def test_unknown_method_raises():
    tg = Graph(*POLICY["city10"]())
    with pytest.raises(ValueError, match="unknown build method"):
        cpd.pick_build_kernel(tg, "bogus")


