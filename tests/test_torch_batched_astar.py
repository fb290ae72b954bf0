"""PyTorch port, batched A* (``ops/batched_astar.py``, K6's loop in
``ops/cuda_astar.py``) against the JAX package's ``ops/batched_astar.py``
on the CPU, exactly: the heuristic table bit for bit (where a separately
rounded formula differs), cost, plen, finished and the five counters
over hscale, fscale, sweep cuts, padded lanes, s == t and diff weights,
through the loop that drives K6 (its wrappers' plain versions here) and
through the plain copy of the JAX loop; the chunked numpy entry with its
deadline and its device cache."""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from distributed_oracle_search_tpu.data import (  # noqa: E402
    synth_city_graph as j_city, synth_road_network as j_road,
)
from distributed_oracle_search_tpu.models.astar import (  # noqa: E402
    min_cost_per_unit as j_mcpu,
)
from distributed_oracle_search_tpu.ops.batched_astar import (  # noqa: E402
    astar_batch as j_astar_batch, astar_batch_np as j_astar_batch_np,
)
from distributed_oracle_search_tpu_torch.data import (  # noqa: E402
    synth_city_graph, synth_road_network,
)
from distributed_oracle_search_tpu_torch.models.astar import (  # noqa: E402
    min_cost_per_unit,
)
from distributed_oracle_search_tpu_torch.ops import (  # noqa: E402
    astar_batch, astar_batch_np, heuristic_table,
)
from distributed_oracle_search_tpu_torch.ops import batched_astar as tba  # noqa: E402
from distributed_oracle_search_tpu_torch.ops import cuda_astar as tca  # noqa: E402

COUNTERS = ("n_expanded", "n_surplus", "n_touched", "n_inserted",
            "n_updated")


@jax.jit
def jax_h(xs, ys, t, cpu, hscale):
    """The JAX stage's heuristic, ``ops/batched_astar.py:101-107`` as it
    stands there (the stage keeps it inside its jitted loop)."""
    dx = xs[:, None] - xs[t][None, :]
    dy = ys[:, None] - ys[t][None, :]
    h_raw = jnp.sqrt(dx * dx + dy * dy) * cpu * hscale
    return jnp.maximum(
        jnp.minimum(jnp.floor(h_raw * (1.0 - 4e-7) - 1.0), 2.0e9),
        0.0).astype(jnp.int32)


def _h_both(xs, ys, t, cpu, hscale):
    want = np.asarray(jax_h(jnp.asarray(xs), jnp.asarray(ys),
                            jnp.asarray(t), jnp.float32(cpu),
                            jnp.float32(hscale)))
    got = heuristic_table(torch.from_numpy(xs), torch.from_numpy(ys),
                          torch.from_numpy(t), cpu, hscale).numpy()
    return want, got


def _separately_rounded(xs, ys, t, cpu, hscale):
    f = np.float32
    dx = xs[:, None] - xs[t][None, :]
    dy = ys[:, None] - ys[t][None, :]
    raw = np.sqrt(dx * dx + dy * dy) * f(cpu) * f(hscale)
    tail = np.floor(raw * f(1.0 - 4e-7) - f(1.0))
    return np.maximum(np.minimum(tail, f(2.0e9)), f(0)).astype(np.int32)


@pytest.mark.parametrize("hscale,separate_differs", [(1.0, 40), (1.5, 70)])
def test_heuristic_equals_jax_where_rounding_matters(hscale,
                                                     separate_differs):
    """Every node a target on a 512-node road graph: the port's table is
    JAX's bit for bit, and a separately rounded float32 formula is not
    (so the test can see a wrong formula)."""
    g = synth_road_network(512, seed=0)
    xs = np.asarray(g.xs, np.float32)
    ys = np.asarray(g.ys, np.float32)
    t = np.arange(g.n, dtype=np.int32)
    cpu = min_cost_per_unit(g)
    assert cpu == j_mcpu(j_road(512, seed=0))
    want, got = _h_both(xs, ys, t, cpu, hscale)
    np.testing.assert_array_equal(got, want)
    assert int((_separately_rounded(xs, ys, t, cpu, hscale)
                != want).sum()) == separate_differs


def test_heuristic_tail_is_fused_as_jax():
    """Coordinates whose tail ``h_raw * (1 - 4e-7) - 1`` floors
    differently rounded once (a fused multiply-add, as XLA computes it)
    and rounded twice: the port follows JAX."""
    c = np.float32(1.0 - 4e-7)
    cands = []
    for k in range(1, 24):
        base = np.float32((2.0 ** k + 1) / float(c))
        raw = (base.view(np.int32)
               + np.arange(-5000, 5000, dtype=np.int32)).view(np.float32)
        once = np.floor((raw.astype(np.float64) * np.float64(c)
                         - 1.0).astype(np.float32))
        twice = np.floor((raw * c).astype(np.float32) - np.float32(1))
        cands += list(raw[once != twice])
    assert cands
    xs = np.concatenate([[0.0], cands]).astype(np.float32)
    ys = np.zeros_like(xs)
    t = np.zeros(1, np.int32)
    want, got = _h_both(xs, ys, t, 1.0, 1.0)
    np.testing.assert_array_equal(got, want)


def _tensors(g, w=None):
    in_nbr, in_eid = g.ell("in")
    T = torch.from_numpy
    return dict(in_nbr=T(in_nbr), in_eid=T(in_eid),
                w_pad=T(g.padded_weights(w)),
                xs=T(np.asarray(g.xs, np.float32)),
                ys=T(np.asarray(g.ys, np.float32)))


def _jax_run(jg, q, valid, hscale, fscale, max_iters, w=None):
    in_nbr, in_eid = jg.ell("in")
    cost, plen, fin, counters = j_astar_batch(
        jnp.asarray(in_nbr), jnp.asarray(in_eid),
        jnp.asarray(jg.padded_weights(w)),
        jnp.asarray(jg.xs, jnp.float32), jnp.asarray(jg.ys, jnp.float32),
        jnp.asarray(q[:, 0].astype(np.int32)),
        jnp.asarray(q[:, 1].astype(np.int32)), jnp.float32(hscale),
        jnp.float32(fscale), jnp.float32(j_mcpu(jg, w)),
        valid=jnp.asarray(valid), max_iters=max_iters)
    return (np.asarray(cost), np.asarray(plen), np.asarray(fin),
            {k: float(v) for k, v in counters.items()})


def _port_run(fn, g, q, valid, hscale, fscale, max_iters, w=None):
    info: dict = {}
    cost, plen, fin, counters = fn(
        **_tensors(g, w), s=torch.from_numpy(q[:, 0].astype(np.int32)),
        t=torch.from_numpy(q[:, 1].astype(np.int32)), hscale=hscale,
        fscale=fscale, cpu=min_cost_per_unit(g, w),
        valid=torch.from_numpy(valid), max_iters=max_iters, info=info)
    return (cost.numpy(), plen.numpy(), fin.numpy(), counters), info


def _assert_same(got, want):
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a, b)
    assert {k: got[3][k] for k in COUNTERS} == {k: want[3][k]
                                                  for k in COUNTERS}


def _city_case():
    g, jg = synth_city_graph(9, 7, seed=41), j_city(9, 7, seed=41)
    rng = np.random.default_rng(7)
    q = np.stack([rng.integers(0, g.n, 48), rng.integers(0, g.n, 48)], 1)
    q[5, 0] = q[5, 1]                                  # s == t
    q[17, 0] = q[17, 1]
    valid = np.ones(64, bool)
    valid[48:] = False                                 # padded lanes
    return g, jg, np.concatenate([q, np.zeros((16, 2), np.int64)]), valid


@pytest.mark.parametrize("fn", [astar_batch, tba.astar_batch_plain],
                         ids=["entry", "plain"])
@pytest.mark.parametrize("fscale", [0.0, 0.1, 0.5])
@pytest.mark.parametrize("hscale", [0.7, 1.0, 1.5])
def test_batch_equals_jax_on_city(fn, hscale, fscale):
    g, jg, q, valid = _city_case()
    got, info = _port_run(fn, g, q, valid, hscale, fscale, 0)
    _assert_same(got, _jax_run(jg, q, valid, hscale, fscale, 0))
    assert got[2][:48].all() and not got[2][48:].any()
    assert got[0][5] == 0 and got[1][5] == 0           # s == t
    assert info["sweeps"] > 0
    assert info["exact"]["n_touched"] == got[3]["n_touched"]


@pytest.mark.parametrize("fn", [astar_batch, tba.astar_batch_plain],
                         ids=["entry", "plain"])
@pytest.mark.parametrize("max_iters", [1, 2, 3, 0])
def test_batch_equals_jax_at_sweep_cuts(fn, max_iters):
    """A cut stops the loop mid-search: unfinished queries, the partial
    counters and plen of the cut's iterate all equal JAX's."""
    g, jg, q, valid = _city_case()
    got, info = _port_run(fn, g, q, valid, 1.5, 0.1, max_iters)
    _assert_same(got, _jax_run(jg, q, valid, 1.5, 0.1, max_iters))
    if max_iters:
        assert info["sweeps"] == max_iters


@pytest.mark.parametrize("n,hscale,fscale", [
    (512, 1.0, 0.0), (512, 1.5, 0.1), (2048, 1.0, 0.5), (2048, 0.7, 0.0),
])
def test_batch_equals_jax_on_road(n, hscale, fscale):
    """The road network (float coordinates in the millions: the
    fma-sensitive heuristic prunes here) through the entry."""
    g, jg = synth_road_network(n, seed=0), j_road(n, seed=0)
    rng = np.random.default_rng(n)
    q = np.stack([rng.integers(0, n, 32), rng.integers(0, n, 32)], 1)
    valid = np.ones(32, bool)
    valid[-3:] = False
    got, _ = _port_run(astar_batch, g, q, valid, hscale, fscale, 0)
    _assert_same(got, _jax_run(jg, q, valid, hscale, fscale, 0))


def test_batch_equals_jax_on_diff_weights():
    g, jg, q, valid = _city_case()
    rng = np.random.default_rng(3)
    w = g.w.copy()
    bump = rng.integers(0, 2, g.m).astype(bool)
    w[bump] = w[bump] * 3
    for fn in (astar_batch, tba.astar_batch_plain):
        got, _ = _port_run(fn, g, q, valid, 1.0, 0.0, 0, w=w)
        _assert_same(got, _jax_run(jg, q, valid, 1.0, 0.0, 0, w=w))


def test_batch_on_cpu_is_the_plain_loop():
    """On CPU tensors ``astar_batch`` runs ``astar_batch_plain`` (counted
    in ``astar_batch.plain``) and launches nothing; K6's sweep and loop
    refuse CPU tensors (their grouping is held to the plain loop on the
    card, ``test_torch_cuda_astar.py``)."""
    g, _, q, valid = _city_case()
    plain0, launches0 = astar_batch.plain, tca.astar_sweep.launches
    got, info = _port_run(astar_batch, g, q, valid, 1.0, 0.0, 0)
    want, pinfo = _port_run(tba.astar_batch_plain, g, q, valid, 1.0, 0.0, 0)
    _assert_same(got, want)
    assert info["sweeps"] == pinfo["sweeps"] > 0
    np.testing.assert_array_equal(info["counts"], pinfo["counts"])
    assert info["launches"] == 0
    assert astar_batch.plain == plain0 + 1
    assert tca.astar_sweep.launches == launches0
    tt = _tensors(g)
    s = torch.from_numpy(q[:, 0].astype(np.int32))
    t = torch.from_numpy(q[:, 1].astype(np.int32))
    with pytest.raises(ValueError, match="cpu"):
        tca.astar_loop(**tt, s=s, t=t, hscale=1.0, fscale=0.0, cpu=1.0)
    n, nq = g.n, len(q)
    z = torch.zeros((n, nq), dtype=torch.int32)
    z8 = torch.zeros((n, nq), dtype=torch.uint8)
    grp = torch.zeros((n, tba.n_groups(nq)), dtype=torch.uint8)
    flag = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="cpu"):
        tca.astar_sweep(tt["in_nbr"], tt["w_pad"][tt["in_eid"].long()],
                        tba.in_degree(tt["in_eid"], g.m), z, t,
                        torch.ones(nq, dtype=torch.uint8), z, z.clone(), z8,
                        grp, z.clone(), z.clone(), z8.clone(), grp.clone(),
                        0.0, flag, flag.clone(),
                        torch.zeros(8, dtype=torch.int64))


def test_no_valid_lane_runs_no_sweep():
    g, jg, q, _ = _city_case()
    valid = np.zeros(64, bool)
    got, info = _port_run(astar_batch, g, q, valid, 1.0, 0.0, 0)
    _assert_same(got, _jax_run(jg, q, valid, 1.0, 0.0, 0))
    assert info["sweeps"] == 0 and not got[2].any()


def test_counter_fold_is_float32_in_sweep_order():
    """Totals past 2^24 round as JAX's float32 accumulation does."""
    rows = np.array([[2 ** 24, 1, 3, 1, 1], [1, 1, 2 ** 24 + 1, 1, 1]])
    folded = tba.fold_counts(rows, 20)
    f = np.float32
    assert folded["n_expanded"] == float(f(f(2 ** 24) + f(1)))
    assert folded["n_touched"] == float(
        f(f(f(3) * f(20)) + f(f(2 ** 24 + 1) * f(20))))
    assert tba.exact_totals(rows, 20)["n_touched"] == (3 + 2 ** 24 + 1) * 20


def test_wrappers_take_plain_on_cpu_and_refuse_other_devices():
    g, _, q, valid = _city_case()
    tt = _tensors(g)
    h0 = tca.astar_heuristic.plain
    h = heuristic_table(tt["xs"], tt["ys"],
                        torch.from_numpy(q[:, 1].astype(np.int32)), 1.0, 1.0)
    assert h.dtype == torch.int32 and tca.astar_heuristic.plain == h0 + 1
    meta = {k: v.to("meta") for k, v in tt.items()}
    with pytest.raises(ValueError, match="meta"):
        astar_batch(**meta, s=torch.zeros(4, dtype=torch.int32,
                                          device="meta"),
                    t=torch.zeros(4, dtype=torch.int32, device="meta"),
                    hscale=1.0, fscale=0.0, cpu=1.0)


def _queries(n, count, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, n, count),
                     rng.integers(0, n, count)], 1)


def test_np_chunking_is_transparent_and_equals_jax():
    g, jg = synth_city_graph(9, 7, seed=41), j_city(9, 7, seed=41)
    q = _queries(g.n, 48, 5)
    want = j_astar_batch_np(jg, q, hscale=1.5, fscale=0.1)
    for chunk in (7, 16, 1024):
        got = astar_batch_np(g, q, hscale=1.5, fscale=0.1, chunk=chunk,
                             device="cpu")
        for a, b in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(a, b)
    # the counters are per chunk: one chunk equals JAX's one chunk
    got = astar_batch_np(g, q, hscale=1.5, fscale=0.1, device="cpu")
    assert got[3] == want[3]
    got7 = astar_batch_np(g, q, hscale=1.5, fscale=0.1, chunk=7,
                          device="cpu")
    assert got7[3] == j_astar_batch_np(jg, q, hscale=1.5, fscale=0.1,
                                       chunk=7)[3]


def test_np_past_deadline_still_answers_first_chunk():
    g, jg = synth_city_graph(9, 7, seed=41), j_city(9, 7, seed=41)
    q = _queries(g.n, 48, 5)
    past = time.perf_counter() - 1.0
    info: dict = {}
    got = astar_batch_np(g, q, chunk=8, deadline=past, device="cpu",
                         info=info)
    want = j_astar_batch_np(jg, q, chunk=8, deadline=past)
    assert got[2][:8].all() and not got[2][8:].any()
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a, b)
    assert got[3] == want[3] and len(info["sweeps"]) == 1


def test_np_ctx_caches_graph_and_named_weights():
    g = synth_city_graph(9, 7, seed=41)
    q = _queries(g.n, 20, 9)
    ctx: dict = {}
    w = g.w * 2
    first = astar_batch_np(g, q, w=w, ctx=ctx, w_key="double", device="cpu")
    nbr, wkey = ctx["in_nbr"], ctx[("w_pad", "double")]
    again = astar_batch_np(g, q, w=w, ctx=ctx, w_key="double")
    assert ctx["in_nbr"] is nbr and ctx[("w_pad", "double")] is wkey
    assert ctx["device"].type == "cpu"
    for a, b in zip(first[:3], again[:3]):
        np.testing.assert_array_equal(a, b)
    # no key: nothing cached for the weights
    astar_batch_np(g, q, ctx=ctx)
    assert [k for k in ctx if isinstance(k, tuple)] == [("w_pad", "double")]


def test_np_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = synth_city_graph(4, 3, seed=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        astar_batch_np(g, _queries(g.n, 4, 1))
