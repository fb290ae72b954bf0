"""PyTorch port, the Jacobi relax loop (K1) with its settled-tile skip,
on the CPU, held against the JAX package (ground truth), tolerance
exact: ``cuda_build_kernels.jacobi_dist`` (the CPU branch runs the plain
step with the kernel's changed-map bookkeeping) gives the JAX Jacobi
iterate (``bellman_ford._relax_nb`` under the ``while changed and i <
limit`` loop) after 1, 2, 3 and 7 steps and at convergence, with the JAX
loop's step count, with and without the skip, for batch widths that are
no multiple of 32, 64 or 128, pad targets (``t < 0``) and an unreachable
component; it equals the JAX ``bellman_ford`` and ``ell_split`` stages at
a cut and at convergence; every column group a lane may own gives the
same; the work set equals a brute-force recomputation from two
consecutive iterates, and no pair outside it changes in the next
step; the step over the edges whose destination changed is the dense
step."""

import functools

import jax
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
)
from distributed_oracle_search_tpu_torch.data.graph import Graph  # noqa: E402
from distributed_oracle_search_tpu_torch.ops import (  # noqa: E402
    DeviceGraph, cuda_build_kernels as cbk,
)
from distributed_oracle_search_tpu_torch.ops.bellman_ford import (  # noqa: E402
    init_dist,
)

INF = 10 ** 9


def _arrays(jg):
    return jg.xs, jg.ys, jg.src, jg.dst, jg.w


def _stragglers():
    """A 24 x 17 city with six long edges each way between far ids."""
    xs, ys, src, dst, w = _arrays(jcity(24, 17, seed=3))
    extra = np.array([0, 5, 50, 100, 101, 7])
    return (xs, ys, np.r_[src, extra, extra + 300],
            np.r_[dst, extra + 300, extra],
            np.r_[w, np.full(12, 40, np.int32)])


def _oneway(w: int = 9, h: int = 7):
    """Only rightward and upward edges: most pairs are unreachable."""
    ids = np.arange(w * h)
    right = ids[ids % w < w - 1]
    up = ids[ids // w < h - 1]
    src = np.concatenate([right, up])
    dst = np.concatenate([right + 1, up + w])
    wt = np.random.default_rng(3).integers(1, 50, len(src)).astype(np.int32)
    return ids % w, ids // w, src, dst, wt


def _island():
    """A degree-skewed road graph plus a directed 5-cycle that no edge
    joins to it: the cycle's targets are unreachable from the road and
    the road's from the cycle."""
    xs, ys, src, dst, w = _arrays(jroad(150, seed=5))
    n = len(xs)
    cyc = np.arange(n, n + 5)
    return (np.r_[xs, np.arange(5)], np.r_[ys, np.full(5, -50)],
            np.r_[src, cyc], np.r_[dst, np.roll(cyc, -1)],
            np.r_[w, np.full(5, 9, np.int32)])


GRAPHS = {
    "road": lambda: _arrays(jroad(150, seed=5)),
    "stragglers": _stragglers,
    "oneway": _oneway,
    "island": _island,
}
#: batch widths: none a multiple of 32, 64 or 128
BATCHES = (1, 31, 33, 70, 100)
#: cuts (0 = to convergence)
CUTS = (1, 2, 3, 7, 0)


@functools.lru_cache(maxsize=None)
def _graphs(name):
    arrays = GRAPHS[name]()
    return JGraph(*arrays), Graph(*arrays)


@functools.lru_cache(maxsize=None)
def _targets(name, b):
    """``b`` targets (repeats allowed) with pad columns among them; on
    the island graph one of them sits on the cycle."""
    n = _graphs(name)[1].n
    rng = np.random.default_rng(b)
    t = rng.integers(0, n, b).astype(np.int32)
    t[2::6] = -1
    if name == "island" and b > 1:
        t[1] = n - 2
    return t


_relax_nb = jax.jit(jbf._relax_nb)


@functools.lru_cache(maxsize=None)
def _jax_iterates(name, b):
    """The JAX Jacobi iterates ``[d_0, d_1, ..., d_S]`` (``[N, B]``
    numpy) of the ``while changed`` loop, ``d_S`` the first that equals
    the one before; a valid target makes ``S >= 1``."""
    jg = _graphs(name)[0]
    dg = JDeviceGraph.from_graph(jg)
    d = init_dist(jg.n, torch.as_tensor(_targets(name, b))).numpy()
    seq = [d]
    while True:
        nd = np.array(_relax_nb(jnp.asarray(seq[-1]), dg))
        seq.append(nd)
        if not (nd < seq[-2]).any():
            return seq


def _jax_at(name, b, cut):
    """(the JAX loop's distances, its step count) under ``max_iters``."""
    seq = _jax_iterates(name, b)
    n = _graphs(name)[0].n
    limit = (n - 1) if cut == 0 else cut
    steps = min(limit, len(seq) - 1)
    return seq[steps], steps


def _csr(name):
    return cbk.csr_from_ell(DeviceGraph.from_graph(_graphs(name)[1],
                                                   device="cpu"))


@pytest.mark.parametrize("skip", [True, False])
@pytest.mark.parametrize("cut", CUTS)
@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_loop_equals_jax_iterate(name, b, cut, skip):
    t = _targets(name, b)
    want, want_steps = _jax_at(name, b, cut)
    stats = {}
    before = cbk.relax_jacobi.launches
    d, steps = cbk.jacobi_dist(_csr(name), torch.as_tensor(t), cut,
                               skip=skip, stats=stats)
    np.testing.assert_array_equal(d.numpy(), want)
    assert steps == want_steps == stats["steps"]
    assert cbk.relax_jacobi.launches == before       # no kernel on the CPU
    total = steps * stats["pairs_per_step"]
    assert 0 < stats["active_pairs"] <= total
    if not skip:
        assert stats["active_pairs"] == total


@pytest.mark.parametrize("cut", [7, 0])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_loop_equals_jax_stages(name, cut):
    """The skip loop against the JAX package's own jitted stages: the
    ELL Bellman-Ford and the split relaxation, at a cut and converged."""
    jg, _ = _graphs(name)
    t = _targets(name, 70)
    d, _ = cbk.jacobi_dist(_csr(name), torch.as_tensor(t), cut)
    got = d.T.contiguous().numpy()
    want = np.asarray(jbf.dist_to_targets(JDeviceGraph.from_graph(jg),
                                          jnp.asarray(t), max_iters=cut))
    np.testing.assert_array_equal(got, want)
    sg = jes.ell_split_graph(jg)
    fn = jes._ellsplit_dist_fn(sg.n, sg.k0, len(sg.u_ov), cut)
    want_split = np.asarray(fn(*(jnp.asarray(a) for a in (
        sg.nbr0, sg.w0, sg.u_ov, sg.v_ov, sg.w_ov)), jnp.asarray(t)))
    np.testing.assert_array_equal(got, want_split)


@pytest.mark.parametrize("skip", [True, False])
@pytest.mark.parametrize("vec", [1, 2, 4])
@pytest.mark.parametrize("cut", [3, 0])
def test_every_column_group_width(vec, cut, skip):
    """B = 100 divides by 1, 2 and 4: groups of 32, 64 and 128 columns,
    the last one ragged."""
    t = _targets("road", 100)
    want, want_steps = _jax_at("road", 100, cut)
    stats = {}
    d, steps = cbk.jacobi_dist(_csr("road"), torch.as_tensor(t), cut,
                               skip=skip, vec=vec, stats=stats)
    np.testing.assert_array_equal(d.numpy(), want)
    assert steps == want_steps
    assert stats["vec"] == vec
    assert stats["groups"] == -(-100 // (32 * vec))


def _brute_changed(old, new, cols):
    n, b = old.shape
    groups = -(-b // cols)
    chg = np.zeros((groups, n), np.uint8)
    for g in range(groups):
        chg[g] = (new[:, g * cols:(g + 1) * cols]
                  < old[:, g * cols:(g + 1) * cols]).any(axis=1)
    return chg


def _brute_work_set(jg, chg):
    act = chg.astype(bool).copy()
    for s, v in zip(jg.src, jg.dst):
        act[:, s] |= chg[:, v].astype(bool)
    return act


@pytest.mark.parametrize("cols", [8, 32, 64])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_work_set_equals_brute_force(name, cols):
    """For every pair of consecutive JAX iterates: the changed map, the
    work set it implies, and the next step changes nothing outside it
    (the skip is exact)."""
    jg, _ = _graphs(name)
    b = 70
    seq = _jax_iterates(name, b)
    csr = _csr(name)
    for old, new, nxt in zip(seq, seq[1:], seq[2:]):
        chg = _brute_changed(old, new, cols)
        got = cbk.tile_changed(torch.as_tensor(new < old), cols)
        np.testing.assert_array_equal(got.numpy(), chg)
        act = cbk.relax_work_set(csr, got).numpy()
        np.testing.assert_array_equal(act, _brute_work_set(jg, chg))
        cell = np.repeat(act.T, cols, axis=1)[:, :b]
        assert (nxt[~cell] == new[~cell]).all()


@pytest.mark.parametrize("cols", [8, 32, 64])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_changed_edges_step_equals_dense_step(name, cols):
    """From each JAX iterate, the step over only the edges whose
    destination changed in the step before (the first step: the targets'
    nodes) is the next JAX iterate."""
    b = 70
    seq = _jax_iterates(name, b)
    csr = _csr(name)
    t = torch.as_tensor(_targets(name, b))
    chg = cbk.target_map(csr.n, t, cols)
    for cur, nxt in zip(seq, seq[1:]):
        got = cbk.relax_changed_plain(csr, torch.as_tensor(cur), chg, cols)
        np.testing.assert_array_equal(got.numpy(), nxt)
        chg = cbk.tile_changed(torch.as_tensor(nxt < cur), cols)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_target_map_is_the_first_changed_map(name):
    """The first step's map: the starting iterate against all-INF."""
    t = _targets(name, 70)
    n = _graphs(name)[1].n
    d0 = init_dist(n, torch.as_tensor(t)).numpy()
    want = _brute_changed(np.full_like(d0, INF), d0, 64)
    got = cbk.target_map(n, torch.as_tensor(t), 64)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_one_step_with_map_writes_map_and_counts(name):
    """One CPU step from d_1 with d_0 in the second buffer and the map of
    step 1: out is d_2 everywhere, the written map is step 2's, the flag
    is raised iff a value fell, and the count is the work set's size."""
    b = 33
    seq = _jax_iterates(name, b)
    assert len(seq) >= 3
    csr = _csr(name)
    d0, d1, d2 = (torch.as_tensor(a) for a in seq[:3])
    prev = cbk.tile_changed(d1 < d0, 32)
    cur = torch.full_like(prev, 7)
    out = d0.clone()
    flag = torch.zeros(1, dtype=torch.int32)
    active = cbk.active_counter("cpu")
    cbk.relax_jacobi(csr, d1, out, flag, prev, cur, active, vec=1)
    assert torch.equal(out, d2)
    assert torch.equal(cur, cbk.tile_changed(d2 < d1, 32))
    assert int(flag.item()) == int(bool((d2 < d1).any()))
    assert int(active[:, 0].sum()) == int(cbk.relax_work_set(
        csr, prev).sum())


def test_no_map_relaxes_every_pair():
    """Without a map the step is the dense plain step, whatever ``out``
    held, and counts every pair."""
    csr = _csr("road")
    rng = np.random.default_rng(4)
    d = torch.as_tensor(rng.integers(0, INF + 1, (csr.n, 70)).astype(
        np.int32))
    out = torch.full_like(d, -5)
    flag = torch.zeros(1, dtype=torch.int32)
    active = cbk.active_counter("cpu")
    cbk.relax_jacobi(csr, d, out, flag, active=active)
    want = cbk.relax_jacobi_plain(csr, d)
    assert torch.equal(out, want)
    assert int(flag.item()) == int(bool((want < d).any()))
    cols = 32 * cbk.relax_vec(70)
    assert cols == 64
    assert int(active[:, 0].sum()) == csr.n * cbk.relax_groups(70, cols)


def test_skip_relaxes_fewer_pairs():
    """On the road graph the skip loop relaxes fewer pairs than the
    dense loop, in the same number of steps."""
    t = _targets("road", 100)
    s_skip, s_dense = {}, {}
    cbk.jacobi_dist(_csr("road"), torch.as_tensor(t), skip=True,
                    stats=s_skip)
    cbk.jacobi_dist(_csr("road"), torch.as_tensor(t), skip=False,
                    stats=s_dense)
    assert s_skip["steps"] == s_dense["steps"]
    assert s_skip["active_pairs"] < s_dense["active_pairs"]


@pytest.mark.parametrize("b,want", [
    (512, 4), (8192, 4),                  # the road and campaign chunks
    (100, 4), (70, 2), (64, 2), (40, 2), (36, 2), (33, 1), (31, 1), (1, 1),
])
def test_relax_vec_rule(b, want):
    """The widest of 4, 2, 1 that divides B and fills half a group."""
    assert cbk.relax_vec(b) == want


def _brute_visit_order(n, src, dst):
    """Breadth first over the out-edges from node 0, each level by id,
    then the nodes not reached, by id."""
    nbrs = [[] for _ in range(n)]
    for s, v in zip(src, dst):
        nbrs[s].append(v)
    seen, level, order = {0}, [0], []
    while level:
        order += level
        nxt = sorted({v for u in level for v in nbrs[u]} - seen)
        seen.update(nxt)
        level = nxt
    return np.array(order + [x for x in range(n) if x not in seen])


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_visit_order_is_breadth_first(name):
    """The CSR's visit order: a permutation, breadth first from node 0,
    with each node's out-edge range beside it."""
    jg, tg = _graphs(name)
    csr = _csr(name)
    order = csr.order.numpy()
    np.testing.assert_array_equal(order,
                                  _brute_visit_order(jg.n, jg.src, jg.dst))
    assert sorted(order) == list(range(jg.n))
    rp = csr.row_ptr.numpy()
    np.testing.assert_array_equal(csr.span.numpy(),
                                  np.stack([rp[order], rp[order + 1]], 1))


def test_visit_order_empty_and_edgeless():
    assert cbk.visit_order(np.zeros(1, np.int64), np.zeros(0, np.int32)
                           ).shape == (0,)
    np.testing.assert_array_equal(
        cbk.visit_order(np.zeros(4, np.int64), np.zeros(0, np.int32)),
        [0, 1, 2])


def test_bad_vec_raises():
    csr = _csr("road")
    d = torch.zeros((csr.n, 70), dtype=torch.int32)
    flag = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="vec"):
        cbk.relax_jacobi(csr, d, d.clone(), flag, vec=4)
    with pytest.raises(ValueError, match="vec"):
        cbk.relax_jacobi(csr, d, d.clone(), flag, vec=3)
