"""PyTorch port, the orders the hand sweep kernel (K3) relies on, on the
CPU, held against the JAX package (ground truth), tolerance exact:

* the row-by-row order (rows in ``sy`` order, a min-plus scan along each
  row, ``grid_sweep.sweep_quadrants_rows``, the kernel's plain twin)
  gives the JAX ``dist_to_targets_sweep`` after 1, 2 and 3 cycles and at
  convergence, with the JAX loop's cycle count, with whole rows and with
  rows swept in pieces (all the rows of a piece, then the next);
* the per-group loop (``sweep_dist``'s CPU branch: each group of columns
  runs its own cycles to its own convergence, as the kernel's blocks do
  on a lattice with no off-lattice edges) gives the same at every cut
  and for every group width;
* the saturating min-plus combine is associative, and a row scan equals
  the sequential recurrence, with INF and near-INF weights, in int32;
* a lattice 6,000 cells wide (past the row a kernel block holds, so the
  kernel sweeps it in pieces) is built by sweep, and both the CPU branch
  and the piece order give the JAX distances and cycle count.

Graphs: a pure lattice, a city with shortcut planes, a grid with
stragglers, each with a square island cut off from the rest; B in
{1, 31, 33, 100} with pad targets."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)
hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from distributed_oracle_search_tpu.data import (  # noqa: E402
    synth_city_graph as jcity,
)
from distributed_oracle_search_tpu.data.graph import Graph as JGraph  # noqa: E402
from distributed_oracle_search_tpu.ops import (  # noqa: E402
    grid_sweep as jgs,
)
from distributed_oracle_search_tpu_torch.data.graph import Graph  # noqa: E402
from distributed_oracle_search_tpu_torch.models import cpd  # noqa: E402
from distributed_oracle_search_tpu_torch.ops import (  # noqa: E402
    cuda_build_kernels as cbk, grid_sweep,
)
from distributed_oracle_search_tpu_torch.ops.bellman_ford import (  # noqa: E402
    init_dist,
)

INF = 10 ** 9


def _arrays(jg):
    return jg.xs, jg.ys, jg.src, jg.dst, jg.w


def _island(arrays, width, lo=2, hi=5):
    """Drop every edge across the border of the square ``[lo, hi)^2`` of
    a row-major lattice: its nodes and the rest cannot reach each other."""
    xs, ys, src, dst, w = arrays
    ids = np.arange(len(xs))
    inside = ((ids % width >= lo) & (ids % width < hi)
              & (ids // width >= lo) & (ids // width < hi))
    keep = inside[src] == inside[dst]
    return xs, ys, src[keep], dst[keep], w[keep]


def _lattice():
    return _island(_arrays(jcity(23, 17, seed=3, shortcut_frac=0.0)), 23)


def _city():
    return _island(_arrays(jcity(21, 13, seed=5)), 21)


def _stragglers():
    """A 24 x 17 city with six long edges each way past the shift planes'
    reach: ``grid_split`` keeps them as stragglers."""
    xs, ys, src, dst, w = _island(_arrays(jcity(24, 17, seed=3)), 24, 9, 12)
    extra = np.array([0, 5, 50, 100, 101, 7])
    return (xs, ys, np.r_[src, extra, extra + 300],
            np.r_[dst, extra + 300, extra],
            np.r_[w, np.full(12, 40, np.int32)])


GRAPHS = {"lattice": _lattice, "city": _city, "stragglers": _stragglers}
#: each graph's width and its island's low corner
ISLAND = {"lattice": (23, 2), "city": (21, 2), "stragglers": (24, 9)}
#: the batch widths each graph is held at (JAX compiles once per width
#: and cut, so the off-lattice graphs take two)
BATCHES = {"lattice": (1, 31, 33, 100), "city": (31, 100),
           "stragglers": (1, 33)}
CASES = [(name, b) for name, bs in BATCHES.items() for b in bs]


@functools.lru_cache(maxsize=None)
def _graphs(name):
    arrays = GRAPHS[name]()
    return JGraph(*arrays), Graph(*arrays)


@functools.lru_cache(maxsize=None)
def _grids(name):
    jg, tg = _graphs(name)
    return jgs.GridGraph.from_graph(jg), grid_sweep.GridGraph.from_graph(tg)


@functools.lru_cache(maxsize=None)
def _targets(name, b):
    """``b`` targets (repeats allowed) with pad columns; one on the
    island where there are several."""
    tg = _graphs(name)[1]
    t = np.random.default_rng(b).integers(0, tg.n, b).astype(np.int32)
    t[2::6] = -1
    if b > 1:
        width, lo = ISLAND[name]
        t[1] = (lo + 1) * width + lo + 1
    return t


@functools.lru_cache(maxsize=None)
def _jax_at(name, b, cut):
    """The JAX sweep's ``[B, N]`` distances after ``cut`` cycles."""
    return np.asarray(jgs.dist_to_targets_sweep(
        _grids(name)[0], jnp.asarray(_targets(name, b)), max_iters=cut))


def _jax_cycles(name, b, cut):
    """The JAX loop's cycle count at ``cut``: the first cycle that lowers
    nothing is the last (so one past the first iterate equal to the
    converged one), at most the cut."""
    conv = _jax_at(name, b, 0)
    start = init_dist(conv.shape[1],
                      torch.as_tensor(_targets(name, b))).T.numpy()
    k = 0      # the first iterate equal to the converged one
    while not np.array_equal(start if k == 0 else _jax_at(name, b, k), conv):
        k += 1
    return k + 1 if cut == 0 else min(cut, k + 1)


def _rows_loop(gg, t, cut, piece=None):
    """The plain loop with the kernel's row order (rows in pieces of
    ``piece`` cells): ``(distances [N, B], cycles)``."""
    gd = gg.on("cpu")
    limit = (gg.n - 1) if cut == 0 else cut
    d = init_dist(gg.n, torch.as_tensor(t))
    changed, i = bool((d < INF).any()), 0
    while changed and i < limit:
        before = d.clone()
        grid_sweep.sweep_quadrants_rows(gd, d, piece)
        d = grid_sweep.off_lattice(gd, d)
        changed = bool((d < before).any())
        i += 1
    return d, i


def test_graphs_cover_every_edge_kind():
    """The lattice has no off-lattice edge, the city shift planes only,
    the straggler grid both; every island target is cut off."""
    lat, city, strag = (_grids(n)[1] for n in ("lattice", "city",
                                               "stragglers"))
    assert not lat.shifts and not lat.n_left
    assert city.shifts and not city.n_left
    assert strag.shifts and strag.n_left
    for name in GRAPHS:
        b = BATCHES[name][-1]
        want = _jax_at(name, b, 0)
        assert (want == INF).any(), name


@pytest.mark.parametrize("cut", [1, 2, 3, 0])
@pytest.mark.parametrize("name,b", CASES)
def test_row_order_equals_jax(name, b, cut):
    t = _targets(name, b)
    d, cycles = _rows_loop(_grids(name)[1], t, cut)
    np.testing.assert_array_equal(d.T.numpy(), _jax_at(name, b, cut))
    assert cycles == _jax_cycles(name, b, cut)


@pytest.mark.parametrize("piece", [4, 8, 12])
@pytest.mark.parametrize("cut", [1, 2, 0])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_row_order_in_pieces_equals_jax(name, cut, piece):
    """Rows swept in pieces of 4 to 12 cells (the widths past a piece
    end in a partial one): each piece's first cell takes the new value
    of the cell before it from the piece before."""
    b = BATCHES[name][-1]
    t = _targets(name, b)
    d, cycles = _rows_loop(_grids(name)[1], t, cut, piece)
    np.testing.assert_array_equal(d.T.numpy(), _jax_at(name, b, cut))
    assert cycles == _jax_cycles(name, b, cut)


@pytest.mark.parametrize("cut", [1, 2, 3, 0])
@pytest.mark.parametrize("name,b", CASES)
def test_sweep_loop_equals_jax(name, b, cut):
    """``sweep_dist``'s CPU branch: the per-group loop on the lattice,
    a cycle at a time with the off-lattice stage elsewhere."""
    t = _targets(name, b)
    gd = _grids(name)[1].on("cpu")
    d, cycles = cbk.sweep_dist(gd, torch.as_tensor(t), cut)
    np.testing.assert_array_equal(d.T.numpy(), _jax_at(name, b, cut))
    assert cycles == _jax_cycles(name, b, cut)


@pytest.mark.parametrize("cols", [1, 2, 4])
@pytest.mark.parametrize("cut", [1, 2, 3, 0])
def test_per_group_loop_any_width(cols, cut):
    """Groups of 1 to 4 columns each stop at their own convergence: the
    batch loop's iterate at every cut, and its cycle count (B = 100)."""
    t = _targets("lattice", 100)
    gd = _grids("lattice")[1].on("cpu")
    d = init_dist(gd.n, torch.as_tensor(t))
    flag = torch.zeros(1, dtype=torch.int32)
    counter = torch.zeros(1, dtype=torch.int32)
    limit = (gd.n - 1) if cut == 0 else cut
    cbk.grid_sweep(gd, d, flag, cycles=limit, counter=counter, cols=cols)
    np.testing.assert_array_equal(d.T.numpy(),
                                  _jax_at("lattice", 100, cut))
    assert int(counter.item()) == _jax_cycles("lattice", 100, cut)
    assert int(flag.item()) == 1


def test_per_group_counts_differ():
    """A group whose targets are all pads converges in one cycle, while
    the batch needs more: the count is the largest a group ran."""
    t = _targets("lattice", 100).copy()
    t[:4] = -1
    gd = _grids("lattice")[1].on("cpu")
    d = init_dist(gd.n, torch.as_tensor(t))
    counter = torch.zeros(1, dtype=torch.int32)
    flag = torch.zeros(1, dtype=torch.int32)
    cbk.grid_sweep(gd, d[:, :4], flag, cycles=50, counter=counter, cols=4)
    assert int(counter.item()) == 1 and int(flag.item()) == 0
    cbk.grid_sweep(gd, d, flag, cycles=50, counter=counter, cols=4)
    assert int(counter.item()) > 1


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_one_row_order_cycle_equals_diagonals(name):
    """One cycle of the row order equals one of the diagonal order, from
    random distances (every cell, not just the loop's iterates)."""
    gd = _grids(name)[1].on("cpu")
    rng = np.random.default_rng(7)
    d = rng.integers(0, INF + 1, (gd.n, 9)).astype(np.int32)
    d[rng.random(d.shape) < 0.4] = INF
    a, b = torch.as_tensor(d), torch.as_tensor(d.copy())
    fa = grid_sweep.sweep_quadrants(gd, a)
    fb = grid_sweep.sweep_quadrants_rows(gd, b)
    assert torch.equal(a, b) and bool(fa) == bool(fb)


# weights and values a sweep sees: every int in [0, INF], INF and the
# values right under it weighted up
_VALUES = st.one_of(st.integers(0, INF), st.just(INF),
                    st.integers(INF - 1000, INF))


def _combine_exact(first, then):
    """``then ∘ first`` of maps ``v -> min(A, W + v)`` in Python ints,
    nothing saturated."""
    (a1, w1), (a2, w2) = first, then
    return min(a2, w2 + a1), w2 + w1


def _apply_exact(m, v):
    return min(m[0], m[1] + v)


@settings(max_examples=300, deadline=None)
@given(st.lists(st.tuples(_VALUES, _VALUES), min_size=3, max_size=3),
       _VALUES)
def test_saturating_combine_is_associative(maps, v):
    """In int32 with the weight sum saturated at INF: associative, never
    past int32, and every composite applied to a value at most INF gives
    the exact (unsaturated) composite's value."""
    m = [(torch.tensor([a], dtype=torch.int32),
          torch.tensor([w], dtype=torch.int32)) for a, w in maps]
    left = grid_sweep.min_plus_then(grid_sweep.min_plus_then(m[0], m[1]),
                                    m[2])
    right = grid_sweep.min_plus_then(m[0], grid_sweep.min_plus_then(m[1],
                                                                    m[2]))
    assert int(left[0]) == int(right[0]) and int(left[1]) == int(right[1])
    assert 0 <= int(left[0]) <= INF and 0 <= int(left[1]) <= INF
    exact = _combine_exact(_combine_exact(maps[0], maps[1]), maps[2])
    got = min(int(left[0]), int(left[1]) + v)
    assert got == _apply_exact(exact, v)
    assert int(left[1]) + v < 2 ** 31


@settings(max_examples=200, deadline=None)
@given(st.lists(st.tuples(_VALUES, _VALUES), min_size=1, max_size=40))
def test_row_scan_equals_recurrence(cells):
    """``row_scan`` (log-depth, saturating) equals ``new[X] = min(a[X],
    min(w[X] + new[X - 1], INF))`` run cell by cell in Python ints."""
    a = torch.tensor([[c[0]] for c in cells], dtype=torch.int32)
    w = torch.tensor([[c[1]] for c in cells], dtype=torch.int32)
    got = grid_sweep.row_scan(a, w)[:, 0].tolist()
    want, left = [], INF
    for ai, wi in cells:
        left = min(ai, min(wi + left, INF))
        want.append(left)
    assert got == want


#: a lattice past the row a kernel block holds (2,552 cells at one
#: column a block): the kernel cuts its 6,000-cell rows into three pieces
#: of 2,000
WIDE = (6000, 6)
WIDE_PIECE = 2000


@functools.lru_cache(maxsize=None)
def _wide():
    arrays = _arrays(jcity(*WIDE, seed=6, shortcut_frac=0.0))
    t = np.random.default_rng(6).integers(0, len(arrays[0]), 5)
    t = t.astype(np.int32)
    t[3] = -1
    return JGraph(*arrays), Graph(*arrays), t


@functools.lru_cache(maxsize=None)
def _wide_at(cut):
    """The JAX sweep's ``[B, N]`` distances on the wide lattice after
    ``cut`` cycles (0: converged)."""
    jg, _, t = _wide()
    return np.asarray(jgs.dist_to_targets_sweep(
        jgs.GridGraph.from_graph(jg), jnp.asarray(t), max_iters=cut))


def test_wide_lattice_builds_by_sweep():
    kind, gg = cpd.pick_build_kernel(_wide()[1], "auto")
    assert kind == "sweep" and (gg.width, gg.height) == WIDE


@pytest.mark.parametrize("order", ["cpu_branch", "pieces"])
def test_wide_lattice_equals_jax(order):
    """``sweep_dist``'s CPU branch, and the loop in the kernel's piece
    order, give the JAX distances with the JAX cycle count (the JAX
    iterate first equals the converged one a cycle before the last)."""
    _, tg, t = _wide()
    gg = grid_sweep.GridGraph.from_graph(tg)
    if order == "cpu_branch":
        d, cycles = cbk.sweep_dist(gg.on("cpu"), torch.as_tensor(t))
    else:
        d, cycles = _rows_loop(gg, t, 0, WIDE_PIECE)
    want = _wide_at(0)
    np.testing.assert_array_equal(d.T.numpy(), want)
    assert cycles >= 2
    assert np.array_equal(_wide_at(cycles - 1), want)
    assert not np.array_equal(_wide_at(cycles - 2), want)
