"""PyTorch port, the skip of K6's A* sweep on the CPU, against the JAX
package's ``ops/batched_astar.py::astar_batch``.

K6's ``astar_sweep`` gathers a source's rows only where its query group
of 32 changed in the sweep before (``csrc/batched_astar.cu`` proves why
that is exact). ``sweep_skip_plain`` masks out exactly the slots the
kernel skips; here it equals ``sweep_plain`` at every sweep to
convergence on small random graphs (hypothesis, numpy seeds), with
``groups_plain`` the any-reduction of ``improved``, over hscale 0.7 / 1
/ 1.5, fscale 0 / 0.5, Q = 1, 2, 8, 32, 64 with padded lanes, and
weights of 0, at ``2^31 - 1 - JINF`` and just above it (the always-
gathered slots, whose sums wrap); the converged cost, plen, finished and
counters equal JAX's. Rules that skipped the heavy slots too, or the
slots of queries whose threshold can wrap, are seen to differ, so the
tests can see a wrong rule."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)
hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

import jax.numpy as jnp  # noqa: E402

from distributed_oracle_search_tpu.ops.batched_astar import (  # noqa: E402
    astar_batch as j_astar_batch,
)
from distributed_oracle_search_tpu_torch.data import (  # noqa: E402
    Graph, synth_road_network,
)
from distributed_oracle_search_tpu_torch.models.astar import (  # noqa: E402
    min_cost_per_unit,
)
from distributed_oracle_search_tpu_torch.ops import batched_astar as tba  # noqa: E402

COUNTERS = tba.COUNTERS
#: fixed shapes, so JAX compiles its loop once a query count
N, M, K = 24, 60, 6
HEAVY = {"zero": 0, "at": tba.SKIP_W_MAX, "above": tba.SKIP_W_MAX + 1}


def _graph(seed: int, weights: str) -> tuple[Graph, np.ndarray]:
    """A random graph of N nodes and M edges (self-loops, parallel edges
    and nodes without in-edges among them), in-degree at most K; weights
    about the edges' lengths, a fifth of them set to ``HEAVY[weights]``
    (zero weights only on edges of length 0 for even seeds, on any edge
    for odd ones, which makes ``cpu`` 0)."""
    rng = np.random.default_rng(seed)
    xs = rng.integers(0, 40, N)
    ys = rng.integers(0, 40, N)
    src = rng.integers(0, N, M)
    dst = rng.choice(np.repeat(np.arange(N), K), M, replace=False)
    for j in range(2):                           # edges of length 0
        xs[dst[j]], ys[dst[j]] = xs[src[j]], ys[src[j]]
    length = np.hypot(xs[src] - xs[dst], ys[src] - ys[dst])
    w = np.ceil(length * rng.uniform(1.0, 2.0, M)) + rng.integers(0, 3, M)
    pick = rng.random(M) < 0.2
    if weights == "zero" and seed % 2 == 0:
        pick = length == 0
    w[pick] = HEAVY[weights]
    w = w.astype(np.int32)
    return Graph(xs, ys, src, dst, w), w


def _ell(g: Graph) -> tuple[np.ndarray, np.ndarray]:
    """The in-edge ELL padded to K slots (trailing self / M padding)."""
    in_nbr, in_eid = g.ell("in")
    pad = K - in_nbr.shape[1]
    nbr = np.concatenate([in_nbr, np.repeat(np.arange(g.n, dtype=np.int32)
                                            [:, None], pad, 1)], 1)
    eid = np.concatenate([in_eid, np.full((g.n, pad), g.m, np.int32)], 1)
    return nbr, eid


def _queries(seed: int, q: int) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed + 1)
    qs = rng.integers(0, N, (q, 2)).astype(np.int32)
    if q > 1:
        qs[0, 1] = qs[0, 0]                      # s == t
    valid = rng.random(q) < 0.8
    if q > 1:
        valid[-1] = False                        # a padded lane
        valid[0] = True
    return qs, valid


def _run(seed, q, weights, hscale, fscale, rule=None):
    """Sweeps from ``init_state`` to convergence (or N - 1 sweeps), each
    through ``sweep_plain`` and ``sweep_skip_plain`` on the same state
    (``rule``: ``{name: value}`` of the skip's module constants to use
    instead, a wrong rule); returns the first sweep they differ at (None
    if never), the converged ``(cost, plen, finished, counters)`` and the
    inputs."""
    g, w = _graph(seed, weights)
    in_nbr, in_eid = _ell(g)
    qs, valid = _queries(seed, q)
    T = torch.from_numpy
    nbr, eid = T(in_nbr), T(in_eid)
    w_pad = T(g.padded_weights(w))
    w_in = w_pad[eid.long()]
    deg = tba.in_degree(eid, g.m)
    xs = T(np.asarray(g.xs, np.float32))
    ys = T(np.asarray(g.ys, np.float32))
    s, t, vt = T(qs[:, 0].copy()), T(qs[:, 1].copy()), T(valid)
    cpu = min_cost_per_unit(g, w)
    h = tba.heuristic_plain(xs, ys, t, cpu, hscale)
    state, hops, changed, groups = tba.init_state(g.n, s, vt)
    rows, differs, i = [], None, 0
    saved = {name: getattr(tba, name) for name in rule or {}}
    while i < g.n - 1 and bool(changed.any()):
        want = tba.sweep_plain(nbr, w_in, h, t, vt, state, hops, changed,
                               fscale)
        for name, value in (rule or {}).items():
            setattr(tba, name, value)
        try:
            got = tba.sweep_skip_plain(nbr, w_in, deg, h, t, vt, state, hops,
                                       changed, groups, fscale)
        finally:
            for name, value in saved.items():
                setattr(tba, name, value)
        if differs is None and not all(torch.equal(a, b)
                                       for a, b in zip(got, want)):
            differs = i + 1
        state, hops, changed, c = want
        groups = tba.groups_plain(changed)
        imp = changed.numpy()
        pad = np.zeros((g.n, -q % 32), bool)
        np.testing.assert_array_equal(
            groups.numpy().astype(bool),
            np.concatenate([imp, pad], 1).reshape(g.n, -1, 32).any(2))
        rows.append(c)
        i += 1
    counts = (torch.stack(rows).numpy() if rows
              else np.zeros((0, 5), np.int64))
    out = (*(x.numpy() for x in tba.finish(state, hops, t, vt)),
           tba.fold_counts(counts, K))
    return differs, out, (in_nbr, in_eid, g.padded_weights(w), g, qs,
                          valid, cpu)


def _jax(inputs, hscale, fscale):
    in_nbr, in_eid, w_pad, g, qs, valid, cpu = inputs
    cost, plen, fin, counters = j_astar_batch(
        jnp.asarray(in_nbr), jnp.asarray(in_eid), jnp.asarray(w_pad),
        jnp.asarray(np.asarray(g.xs, np.float32)),
        jnp.asarray(np.asarray(g.ys, np.float32)), jnp.asarray(qs[:, 0]),
        jnp.asarray(qs[:, 1]), jnp.float32(hscale), jnp.float32(fscale),
        jnp.float32(cpu), valid=jnp.asarray(valid))
    return (np.asarray(cost), np.asarray(plen), np.asarray(fin),
            {k: float(v) for k, v in counters.items()})


@pytest.mark.parametrize("weights", sorted(HEAVY))
@pytest.mark.parametrize("q", [1, 2, 8, 32, 64])
@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1),
       hscale=st.sampled_from([0.7, 1.0, 1.5]),
       fscale=st.sampled_from([0.0, 0.5]))
def test_skip_equals_plain_at_every_sweep_and_jax(q, weights, seed, hscale,
                                                  fscale):
    differs, got, inputs = _run(seed, q, weights, hscale, fscale)
    assert differs is None, f"sweep {differs} differs"
    want = _jax(inputs, hscale, fscale)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a, b)
    assert {k: got[3][k] for k in COUNTERS} == {k: want[3][k]
                                                  for k in COUNTERS}


@pytest.mark.parametrize("rule", [{"SKIP_W_MAX": 2 ** 31 - 1},
                                  {"THR_SAFE": -2 ** 31}],
                         ids=["heavy_slots", "any_threshold"])
def test_a_looser_skip_would_differ(rule):
    """Above ``SKIP_W_MAX`` ``w + INF`` wraps to a negative ``via``, and
    a threshold driven below ``THR_SAFE`` by such sums makes ``thr - h``
    wrap: a rule that skipped those slots, or those queries' slots, when
    the source did not change misses improvements that ``sweep_plain``
    makes, and the comparison sees it."""
    found = [seed for seed in range(40)
             if _run(seed, 8, "above", 1.0, 0.0, rule)[0] is not None]
    assert found
    assert all(_run(seed, 8, "above", 1.0, 0.0)[0] is None
               for seed in found[:3])


@pytest.mark.parametrize("q", [1, 5, 32, 33, 100])
def test_groups_cover_32_queries_each(q):
    rng = np.random.default_rng(q)
    imp = torch.from_numpy(rng.random((7, q)) < 0.05)
    got = tba.groups_plain(imp)
    assert got.dtype == torch.uint8 and got.shape == (7, tba.n_groups(q))
    for grp in range(tba.n_groups(q)):
        np.testing.assert_array_equal(
            got[:, grp].numpy().astype(bool),
            imp[:, 32 * grp:32 * grp + 32].numpy().any(1))


def test_in_degree_is_the_rows_real_slots():
    g = synth_road_network(512, seed=3)
    in_nbr, in_eid = g.ell("in")
    deg = tba.in_degree(torch.from_numpy(in_eid), g.m).numpy()
    np.testing.assert_array_equal(deg, np.diff(g.in_ptr))
    assert (in_eid[np.arange(in_eid.shape[1])[None, :]
                   >= deg[:, None]] == g.m).all()
    ctx = tba._device_graph(g, {}, "cpu")
    assert torch.equal(ctx["deg"], torch.from_numpy(deg.astype(np.int32)))
