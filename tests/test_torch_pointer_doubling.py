"""PyTorch port, pointer doubling: the port's plain ``doubled_tables``,
``doubled_tables_multi``, ``lookup_tables(_multi)`` and ``unpack_tables``
against the JAX package's (jitted XLA, the stage the card's K5 sweep
serves) on the same fm rows, targets and weights, made from numpy seeds.
Held exactly (no tolerance: integer sums): ``max_len`` 0 (converge), 1,
2 and 3 (cuts, where a Jacobi and an in-place squaring differ), pad rows
(target -1), targets a node cannot reach, plen packed as int16 (a small
grid) and as int32 (a 32,768-node two-way path with a few rows), D = 1,
2, 3 and 5 cost sets, rows that settle at different sweeps and corrupted
first-move rows with a 2-cycle and a 3-cycle of non-zero weight (their
cost and plen grow every sweep, so a row must run exactly the chunk's
sweep count), on the on-chip path's rule (``double_rows`` a chunk, the
live rows rerun) and on the wide path's sweep loop. ``double_rows``
with a sweep cap equals a row-by-row Jacobi loop of ``sweep_records``,
and its ``settled`` and ``live`` their definitions. The wrappers take
the plain versions on CPU tensors and count them; the card cases (K5
against the plain versions) are in ``test_torch_cuda_serving.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)

import jax.numpy as jnp  # noqa: E402

from distributed_oracle_search_tpu.data import Graph as JGraph  # noqa: E402
from distributed_oracle_search_tpu.ops import DeviceGraph as JDG  # noqa: E402
from distributed_oracle_search_tpu.ops import pointer_doubling as jpd  # noqa: E402
from distributed_oracle_search_tpu_torch.data import (  # noqa: E402
    Graph, synth_road_network,
)
from distributed_oracle_search_tpu_torch.ops import (  # noqa: E402
    DeviceGraph, build_fm_columns, doubling_rows, doubling_sweep,
)
from distributed_oracle_search_tpu_torch.ops import cuda_doubling as tcd  # noqa: E402
from distributed_oracle_search_tpu_torch.ops import pointer_doubling as tpd  # noqa: E402
from torch_doubling_cases import plant_cycles  # noqa: E402


def _sinks(seed: int) -> Graph:
    """A road graph whose every 5th node keeps no out-edge."""
    g = synth_road_network(240, seed=seed)
    keep = g.src % 5 != 2
    return Graph(g.xs, g.ys, g.src[keep], g.dst[keep], g.w[keep])


def _path(n: int) -> tuple[Graph, np.ndarray, np.ndarray]:
    """A two-way path of ``n`` nodes and the first-move rows toward a
    few targets (built by hand: the move is one step toward the target),
    with one pad row."""
    i = np.arange(n - 1)
    src = np.concatenate([i, i + 1])
    dst = np.concatenate([i + 1, i])
    w = (np.arange(2 * (n - 1)) % 9 + 1).astype(np.int32)
    g = Graph(np.arange(n), np.zeros(n, np.int64), src, dst, w)
    nbr, _ = g.ell("out")
    targets = np.array([0, n - 1, n // 3, -1], np.int32)
    x = np.arange(n)
    fm = np.full((len(targets), n), -1, np.int8)
    for r, tg in enumerate(targets):
        if tg < 0:
            continue
        nxt = np.where(x < tg, x + 1, x - 1)
        slot = np.argmax(nbr == nxt[:, None], axis=1)
        fm[r] = np.where(x == tg, -1, slot).astype(np.int8)
    return g, fm, targets


def _road_case(seed: int, d: int, cyclic: bool = False):
    g = _sinks(seed)
    rng = np.random.default_rng(seed)
    targets = np.sort(rng.choice(g.n, 24, replace=False)).astype(np.int32)
    fm = build_fm_columns(DeviceGraph.from_graph(g, device="cpu"),
                          targets).numpy()
    targets[5] = -1                                  # a pad row
    fm[5] = -1
    if cyclic:
        plant_cycles(g, fm, 1, 2)
    w_pads = np.stack([g.padded_weights(
        None if i == 0 else (g.w * rng.uniform(1.0, 3.0, g.m)).astype(
            np.int32)) for i in range(d)]).astype(np.int32)
    return g, fm, targets, w_pads


def _jax(g, fm, targets, w_pads, max_len, multi):
    jdg = JDG.from_graph(JGraph(g.xs, g.ys, g.src, g.dst, g.w))
    if multi:
        return jpd.doubled_tables_multi(jdg, jnp.asarray(fm),
                                        jnp.asarray(targets),
                                        jnp.asarray(w_pads), max_len=max_len)
    return jpd.doubled_tables(jdg, jnp.asarray(fm), jnp.asarray(targets),
                              jnp.asarray(w_pads[0]), max_len=max_len)


def _port(g, fm, targets, w_pads, max_len, multi, ids=False):
    """The port's tables, the records in the Z-order the oracle lays
    them out in (``record_order``), or by node id with ``ids``."""
    dg = DeviceGraph.from_graph(g, device="cpu")
    order = None if ids else tpd.record_order(g, "cpu")
    if multi:
        return tpd.doubled_tables_multi(
            dg, torch.from_numpy(fm), torch.from_numpy(targets),
            torch.from_numpy(w_pads), max_len=max_len, order=order)
    return tpd.doubled_tables(dg, torch.from_numpy(fm),
                              torch.from_numpy(targets),
                              torch.from_numpy(w_pads[0]), max_len=max_len,
                              order=order)


def _equal(got, want):
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype, (a.dtype, b.dtype)
        np.testing.assert_array_equal(a.numpy(), b)


@pytest.fixture
def wide(monkeypatch):
    """Route the doubling to the wide path (the shape rule's answer for a
    row no cluster holds)."""
    monkeypatch.setattr(tcd, "rows_plan", lambda n, d, device: (0, 0, 0, 0))


@pytest.mark.parametrize("max_len", [0, 1, 2, 3])
@pytest.mark.parametrize("cyclic", [False, True], ids=["paths", "cycles"])
@pytest.mark.parametrize("multi, d", [(False, 1), (True, 1), (True, 2),
                                      (True, 3), (True, 5)],
                         ids=["single", "multi1", "multi2", "multi3",
                              "multi5"])
@pytest.mark.parametrize("ids", [False, True], ids=["zorder", "ids"])
def test_tables_equal_jax(multi, d, cyclic, max_len, ids):
    """The records laid out in the Z-order (``record_order``, as the
    oracle lays them out) or by node id give the JAX tables."""
    g, fm, targets, w_pads = _road_case(7 + d, d, cyclic)
    before = (tpd.doubled_tables_multi.sweeps, doubling_rows.plain,
              doubling_sweep.plain)
    got = _port(g, fm, targets, w_pads, max_len, multi, ids)
    sweeps = tpd.doubled_tables_multi.sweeps - before[0]
    _equal(got, _jax(g, fm, targets, w_pads, max_len, multi))
    assert got[1].dtype == torch.int16
    # one on-chip call a chunk, a second when a live row stopped early
    calls = doubling_rows.plain - before[1]
    assert doubling_sweep.plain == before[2]
    assert calls == 1 or (cyclic and calls == 2)
    if max_len == 0:
        assert 1 <= sweeps <= tpd.n_sweeps(g.n)
        _, plen, fin = tpd.unpack_tables(*got)
        assert (~fin[5]).all() and fin.any() and (~fin).any()
        if cyclic:
            # the cycles' rows run the chunk's every sweep
            assert calls == 2
    else:
        assert sweeps <= tpd.n_sweeps(g.n, max_len)


@pytest.mark.parametrize("max_len", [0, 2])
@pytest.mark.parametrize("cyclic", [False, True], ids=["paths", "cycles"])
def test_wide_path_equals_jax(wide, cyclic, max_len):
    """The wide path's sweep loop (padded records, double-buffered, a
    flag a sweep) keeps the JAX tables too, cycles included."""
    g, fm, targets, w_pads = _road_case(11, 2, cyclic)
    before = (tpd.doubled_tables_multi.sweeps, doubling_rows.plain,
              doubling_sweep.plain)
    got = _port(g, fm, targets, w_pads, max_len, True)
    _equal(got, _jax(g, fm, targets, w_pads, max_len, True))
    sweeps = tpd.doubled_tables_multi.sweeps - before[0]
    assert doubling_rows.plain == before[1]
    assert doubling_sweep.plain - before[2] == sweeps >= 1


@pytest.mark.parametrize("max_len", [0, 1, 2, 3])
@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
def test_int32_plen_on_a_long_path(multi, max_len):
    g, fm, targets = _path(1 << 15)
    w_pads = np.stack([g.padded_weights(),
                       g.padded_weights(g.w * 2)]).astype(np.int32)
    got = _port(g, fm, targets, w_pads, max_len, multi)
    assert got[1].dtype == torch.int32
    _equal(got, _jax(g, fm, targets, w_pads, max_len, multi))
    if max_len == 0:
        _, plen, fin = tpd.unpack_tables(*got)
        assert int(plen[1, 0]) == (1 << 15) - 1 and bool(fin[:3].all())


def test_lookups_equal_jax():
    g, fm, targets, w_pads = _road_case(3, 2)
    single = _port(g, fm, targets, w_pads, 0, False)
    multi = _port(g, fm, targets, w_pads, 0, True)
    rng = np.random.default_rng(4)
    q = 300
    rows = rng.integers(0, len(targets), q).astype(np.int32)
    s = rng.integers(0, g.n, q).astype(np.int32)
    valid = rng.random(q) > 0.2
    for valid_arg in (None, valid):
        jv = None if valid_arg is None else jnp.asarray(valid_arg)
        tv = None if valid_arg is None else torch.from_numpy(valid_arg)
        want = jpd.lookup_tables(jnp.asarray(single[0].numpy()),
                                 jnp.asarray(single[1].numpy()),
                                 jnp.asarray(rows), jnp.asarray(s), jv)
        got = tpd.lookup_tables(*single, torch.from_numpy(rows),
                                torch.from_numpy(s), tv)
        _equal(got, want)
        want = jpd.lookup_tables_multi(jnp.asarray(multi[0].numpy()),
                                       jnp.asarray(multi[1].numpy()),
                                       jnp.asarray(rows), jnp.asarray(s), jv)
        got = tpd.lookup_tables_multi(*multi, torch.from_numpy(rows),
                                      torch.from_numpy(s), tv)
        _equal(got, want)
    # the fused table's row 0 is the single table (the same recursion)
    assert torch.equal(multi[0][..., 0], single[0])
    assert torch.equal(multi[1], single[1])
    want = jpd.unpack_tables(jnp.asarray(single[0].numpy()),
                             jnp.asarray(single[1].numpy()))
    _equal(tpd.unpack_tables(*single), want)


def test_sweep_wrapper_is_double_buffered_on_cpu():
    g, fm, targets, w_pads = _road_case(5, 2)
    dg = DeviceGraph.from_graph(g, device="cpu")
    rec = tpd.initial_records(dg, torch.from_numpy(fm),
                              torch.from_numpy(w_pads))
    assert rec.shape == (len(fm), g.n, 4) and rec.dtype == torch.int32
    assert (rec[..., 4:] == 0).all()
    keep = rec.clone()
    out = torch.empty_like(rec)
    flag = torch.zeros(1, dtype=torch.int32)
    before = (doubling_sweep.plain, doubling_sweep.launches)
    doubling_sweep(rec, out, flag)
    assert (doubling_sweep.plain, doubling_sweep.launches) == (
        before[0] + 1, before[1])
    assert torch.equal(rec, keep) and int(flag) == 1
    # every field of the new record reads the old records only
    succ = keep[..., 0].long()
    gat = torch.gather(keep, 1, succ[..., None].expand_as(keep))
    assert torch.equal(out[..., 0], gat[..., 0])
    assert torch.equal(out[..., 1:], keep[..., 1:] + gat[..., 1:])
    assert tpd.record_width(1) == 4 and tpd.record_width(3) == 8


def _row_loop(rec: torch.Tensor, sweeps: int, fixed: bool):
    """The reference for ``double_rows``: each row alone through the
    Jacobi ``sweep_records`` loop, stopping after its first sweep that
    moves no successor unless ``fixed``; ``settled`` and ``live`` by
    their definitions, node by node."""
    out, settled, live = [], [], []
    n = rec.shape[1]
    for row in rec:
        cur = row[None].clone()
        moving = bool((cur[0, :, 0] != torch.arange(n)).any())
        first = 0
        for i in range(1, sweeps + 1):
            if not (moving or fixed):
                break
            cur, changed = tpd.sweep_records(cur)
            if not changed and moving and first == 0:
                first = i
                if not fixed:
                    break
        out.append(cur[0])
        settled.append(first if first or not moving else sweeps)
        succ, rest = cur[0, :, 0].numpy(), cur[0, :, 1:].numpy()
        live.append(any(succ[y] == y and rest[y].any() for y in range(n)))
    return torch.stack(out), settled, live


@pytest.mark.parametrize("fixed", [False, True], ids=["own", "fixed"])
@pytest.mark.parametrize("sweeps", [1, 2, 3, 8])
@pytest.mark.parametrize("d", [1, 2, 5])
def test_double_rows_equals_row_loop(d, sweeps, fixed):
    g, fm, _, w_pads = _road_case(13 + d, d, cyclic=True)
    dg = DeviceGraph.from_graph(g, device="cpu")
    rec = tpd.initial_records(dg, torch.from_numpy(fm),
                              torch.from_numpy(w_pads))
    assert rec.shape == (len(fm), g.n, tpd.record_width(d))
    want, settled_want, live_want = _row_loop(rec, sweeps, fixed)
    before = (doubling_rows.plain, doubling_rows.launches)
    settled, live = doubling_rows(rec, d, sweeps, fixed)
    assert (doubling_rows.plain, doubling_rows.launches) == (
        before[0] + 1, before[1])
    assert torch.equal(rec, want)
    assert settled.dtype == torch.int32 and live.dtype == torch.bool
    assert settled.tolist() == settled_want
    assert live.tolist() == live_want
    # the pad row never moves; the 2-cycle's row is live once it
    # settles; the 3-cycle's never settles (2^k steps never close it);
    # rows settle at different sweeps
    assert settled[5] == 0 and not live[5]
    assert settled[2] == sweeps
    if sweeps == 8:
        assert bool(live[1]) and not bool(live[0])
        assert len(set(settled.tolist())) > 2


def test_zorder_is_a_permutation_of_nearby_nodes():
    """The records' Z-order is a permutation (new -> old) that keeps a
    range of positions in a compact region: neighbouring positions lie
    nearer each other on the map than neighbouring ids do."""
    g = synth_road_network(2000, seed=4)
    order = tpd.record_order(g, "cpu").numpy()
    assert order.dtype == np.int64
    assert np.array_equal(np.sort(order), np.arange(g.n))

    def step(o):
        return np.hypot(np.diff(g.xs[o].astype(float)),
                        np.diff(g.ys[o].astype(float))).mean()

    assert step(order) * 5 < step(np.arange(g.n))
