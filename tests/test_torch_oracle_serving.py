"""PyTorch port, the oracle's serving methods: the port's ``CPDOracle``
on ``device="cpu"`` against the JAX ``CPDOracle`` on the root conftest's
8 CPU devices, on ``data/synth-city.xy`` with ``partmethod tpu`` and 8
workers, both built by each package. Held exactly (no tolerance):
``query_multi`` (D = 1, 2, 3, the ``-w`` filter, a step cut; row d equals
``query`` on diff d), ``query_mat`` (power-of-two padding, out-of-range
targets and source, the ``w_key`` cache), ``build(store_dists=True)`` for
every build method (whole, in chunks that do not divide R, at an
iteration cut) and ``query_dist``, ``prepare_weights`` + ``query_table``
and ``prepare_weights_multi`` + ``query_table_multi`` (whole and in
chunks with a padded tail, at ``max_len`` cuts), the budget refusal; and
the in-process campaign's fused rounds (``process_query.run_tpu``) row
for row against the JAX CLI's and against sequential rounds."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)

from distributed_oracle_search_tpu.cli import process_query as j_pq  # noqa: E402
from distributed_oracle_search_tpu.cli.args import (  # noqa: E402
    parse_args as j_parse_args,
)
from distributed_oracle_search_tpu.data import Graph as JGraph  # noqa: E402
from distributed_oracle_search_tpu.data import read_scen  # noqa: E402
from distributed_oracle_search_tpu.models.cpd import (  # noqa: E402
    CPDOracle as JOracle,
)
from distributed_oracle_search_tpu.parallel.partition import (  # noqa: E402
    DistributionController as JDC,
)
from distributed_oracle_search_tpu.utils.config import (  # noqa: E402
    ClusterConfig as JConf,
)
from distributed_oracle_search_tpu_torch.cli import process_query as t_pq  # noqa: E402
from distributed_oracle_search_tpu_torch.cli.args import parse_args  # noqa: E402
from distributed_oracle_search_tpu_torch.data import Graph, read_diff  # noqa: E402
from distributed_oracle_search_tpu_torch.models import cpd as tcpd  # noqa: E402
from distributed_oracle_search_tpu_torch.models.cpd import CPDOracle  # noqa: E402
from distributed_oracle_search_tpu_torch.ops import cuda_walk as cw  # noqa: E402
from distributed_oracle_search_tpu_torch.parallel import (  # noqa: E402
    DistributionController,
)
from distributed_oracle_search_tpu_torch.utils.config import (  # noqa: E402
    ClusterConfig,
)

DATA = os.path.join(os.path.dirname(os.path.dirname(__file__)), "data")
XY = os.path.join(DATA, "synth-city.xy")
DIFF = os.path.join(DATA, "synth-city.xy.diff")
SCEN = os.path.join(DATA, "synth.scen")


@pytest.fixture(scope="module")
def setup():
    jg, tg = JGraph.from_xy(XY), Graph.from_xy(XY)
    queries = read_scen(SCEN)
    w_diff = tg.weights_with_diff(read_diff(DIFF))
    rng = np.random.default_rng(0)
    w_diff2 = (tg.w * rng.uniform(1.0, 2.5, tg.m)).astype(np.int32)
    return jg, tg, queries, [None, w_diff, w_diff2]


@pytest.fixture(scope="module")
def built(setup):
    jg, tg, *_ = setup
    jo = JOracle(jg, JDC("tpu", 8, 8, jg.n)).build()
    to = CPDOracle(tg, DistributionController("tpu", 8, 8, tg.n),
                   device="cpu").build()
    return jo, to


def _eq(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("d, active_worker, max_steps",
                         [(1, -1, 0), (2, -1, 0), (3, -1, 0), (2, 3, 0),
                          (3, -1, 5)])
def test_query_multi_equal(setup, built, d, active_worker, max_steps):
    *_, queries, ws = setup
    jo, to = built
    want = jo.query_multi(queries, ws[:d], active_worker=active_worker,
                          max_steps=max_steps)
    got = to.query_multi(queries, ws[:d], active_worker=active_worker,
                         max_steps=max_steps)
    _eq(got, want)
    assert got[0].shape == (d, len(queries))
    for i in range(d):
        single = to.query(queries, w_query=ws[i], active_worker=active_worker,
                          max_steps=max_steps)
        np.testing.assert_array_equal(got[0][i], single[0])
        np.testing.assert_array_equal(got[1], single[1])
        np.testing.assert_array_equal(got[2], single[2])


def test_query_multi_one_walk_and_errors(setup, built):
    *_, queries, ws = setup
    _, to = built
    before = cw.cuda_walk_multi.plain
    to.query_multi(queries, ws)
    assert cw.cuda_walk_multi.plain == before + 1
    with pytest.raises(ValueError, match="at least one"):
        to.query_multi(queries, [])
    bare = CPDOracle(to.graph, to.dc, device="cpu")
    with pytest.raises(RuntimeError, match="build"):
        bare.query_multi(queries, ws)


@pytest.mark.parametrize("k", [1, 5, 16, 37])
def test_query_mat_equal(setup, built, k):
    _, tg, _, ws = setup
    jo, to = built
    rng = np.random.default_rng(k)
    targets = rng.integers(0, tg.n, k)
    bad = np.resize([-1, tg.n + 5, tg.n, 3], len(targets[::4]))
    targets[::4] = bad
    for s in (0, 17):
        for w, key in ((None, None), (ws[1], None), (ws[1], "diff-a")):
            want = jo.query_mat(s, targets, w_query=w, w_key=key)
            got = to.query_mat(s, targets, w_query=w, w_key=key)
            _eq(got, want)
            q = np.stack([np.full(k, s), targets], 1)
            ok = (targets >= 0) & (targets < tg.n)
            c, _, f = to.query(q[ok], w_query=w)
            np.testing.assert_array_equal(got[0][ok], c)
            np.testing.assert_array_equal(got[1][ok], f)
            assert not got[1][~ok].any() and not got[0][~ok].any()
    _eq(to.query_mat(-1, targets), jo.query_mat(-1, targets))
    _eq(to.query_mat(tg.n, targets), jo.query_mat(tg.n, targets))


def test_query_mat_w_key_cache(setup, built, monkeypatch):
    *_, ws = setup
    jo, to = built
    builds = []
    real = tcpd.walk_pairs
    monkeypatch.setattr(tcpd, "walk_pairs",
                        lambda dg, w: builds.append(1) or real(dg, w))
    targets = [1, 2, 9]
    # three rows under each of two keys: one pair table a key
    for i in range(6):
        key, w = f"cache-{i % 2}", ws[1 + i % 2]
        _eq(to.query_mat(3, targets, w_query=w, w_key=key),
            jo.query_mat(3, targets, w_query=w, w_key=key))
    assert len(builds) == 2
    # the key names the weights: a row under a cached key walks the
    # weights first cached for it, as the JAX oracle's
    got = to.query_mat(3, targets, w_query=ws[2], w_key="cache-0")
    _eq(got, jo.query_mat(3, targets, w_query=ws[2], w_key="cache-0"))
    _eq(got, to.query_mat(3, targets, w_query=ws[1]))
    # the cache stays bounded under many keys
    builds.clear()
    for i in range(6):
        to.query_mat(3, targets, w_query=ws[1], w_key=f"many-{i}")
    assert len(builds) == 6 and len(to._weights) <= to._weight_keep


def test_query_dist_needs_dists(setup, built):
    *_, queries, _ = setup
    _, to = built
    with pytest.raises(RuntimeError, match="store_dists"):
        to.query_dist(queries)


@pytest.mark.parametrize("method, chunk, max_iters",
                         [("ell", 0, 0), ("ellsplit", 16, 0),
                          ("shift", 0, 0), ("sweep", 20, 0),
                          ("frontier", 0, 0), ("ell", 5, 6),
                          ("sweep", 0, 2), ("frontier", 0, 40)])
def test_store_dists_equal(setup, method, chunk, max_iters):
    jg, tg, queries, _ = setup
    jo = JOracle(jg, JDC("tpu", 8, 8, jg.n)).build(
        chunk=chunk, max_iters=max_iters, store_dists=True, method=method)
    to = CPDOracle(tg, DistributionController("tpu", 8, 8, tg.n),
                   device="cpu").build(chunk=chunk, max_iters=max_iters,
                                       store_dists=True, method=method)
    assert to.dists.dtype == torch.int32
    _eq([to.dists.numpy(), to.fm.numpy()],
        [np.asarray(jo.dists), np.asarray(jo.fm)])
    for aw in (-1, 2):
        _eq(to.query_dist(queries, active_worker=aw),
            jo.query_dist(queries, active_worker=aw))
    if max_iters == 0:
        cost, fin = to.query_dist(queries)
        c, _, f = to.query(queries)
        np.testing.assert_array_equal(fin, f)
        np.testing.assert_array_equal(cost[fin], c[fin])


def test_save_leaves_dists_out(setup, tmp_path):
    _, tg, queries, _ = setup
    dc = DistributionController("tpu", 8, 8, tg.n)
    to = CPDOracle(tg, dc, device="cpu").build(store_dists=True)
    to.save(str(tmp_path))
    back = CPDOracle(tg, dc, device="cpu").load(str(tmp_path))
    assert back.dists is None
    np.testing.assert_array_equal(back.fm.numpy(), to.fm.numpy())


@pytest.mark.parametrize("chunk, max_len, diff",
                         [(0, 0, 0), (2048, 0, 1), (16, 0, 1), (20, 3, 0),
                          (7, 1, 2)])
def test_prepare_weights_query_table_equal(setup, built, chunk, max_len,
                                           diff):
    *_, queries, ws = setup
    jo, to = built
    want_t = jo.prepare_weights(ws[diff], max_len=max_len, chunk=chunk)
    got_t = to.prepare_weights(ws[diff], max_len=max_len, chunk=chunk)
    _eq([x.numpy() for x in got_t], [np.asarray(x) for x in want_t])
    for aw in (-1, 5):
        _eq(to.query_table(got_t, queries, active_worker=aw),
            jo.query_table(want_t, queries, active_worker=aw))
    if max_len == 0:
        _eq(to.query_table(got_t, queries),
            to.query(queries, w_query=ws[diff]))


@pytest.mark.parametrize("chunk, max_len, d",
                         [(0, 0, 3), (16, 0, 2), (1024, 2, 1), (9, 0, 2)])
def test_prepare_weights_multi_equal(setup, built, chunk, max_len, d):
    *_, queries, ws = setup
    jo, to = built
    want_t = jo.prepare_weights_multi(ws[:d], max_len=max_len, chunk=chunk)
    got_t = to.prepare_weights_multi(ws[:d], max_len=max_len, chunk=chunk)
    _eq([x.numpy() for x in got_t], [np.asarray(x) for x in want_t])
    for aw in (-1, 1):
        _eq(to.query_table_multi(got_t, queries, active_worker=aw),
            jo.query_table_multi(want_t, queries, active_worker=aw))
    if max_len == 0:
        _eq(to.query_table_multi(got_t, queries),
            to.query_multi(queries, ws[:d]))


def test_table_budget_refusal(setup, built, monkeypatch):
    *_, ws = setup
    _, to = built
    need = to.table_memory_bytes()
    w, r = to.targets_wr.shape
    assert need == w * r * to.graph.n * 6          # int16 plen: N < 2^15
    monkeypatch.setenv("DOS_TABLE_BUDGET_GB", str(need / 1e9 / 2))
    with pytest.raises(ValueError, match=r"entries x 6 B, sharded over 1 "
                                         r"worker shard.*DOS_TABLE_BUDGET"):
        to.prepare_weights()
    with pytest.raises(ValueError, match=r"3 diffs need .*14 B/entry"):
        to.prepare_weights_multi(ws)
    with pytest.raises(ValueError, match="at least one"):
        to.prepare_weights_multi([])
    monkeypatch.setenv("DOS_TABLE_BUDGET_GB", "junk")
    assert to.TABLE_BUDGET == int(8e9)


def _conf(cls, tmp_path, workers=4):
    return cls(workers=[f"tpu:{i}" for i in range(workers)],
               partmethod="tpu", partkey=workers,
               outdir=str(tmp_path / "index"), xy_file=XY, scenfile=SCEN,
               diffs=["-", DIFF, "-"]).validate()


def test_fused_rounds_equal_jax_and_sequential(setup, tmp_path):
    jg, tg, queries, _ = setup
    queries = queries[:60]
    tconf = _conf(ClusterConfig, tmp_path / "t")
    jconf = _conf(JConf, tmp_path / "j")
    tdc = DistributionController("tpu", None, 4, tg.n)
    jdc = JDC("tpu", None, 4, jg.n)
    before = (cw.cuda_walk_multi.plain, cw.cuda_walk_batch.plain)
    fused, _ = t_pq.run_tpu(tconf, parse_args(["--device", "cpu"]), queries,
                            tdc, tconf.diffs)
    assert (cw.cuda_walk_multi.plain - before[0],
            cw.cuda_walk_batch.plain - before[1]) == (1, 0)
    seq, _ = t_pq.run_tpu(tconf, parse_args(["--device", "cpu", "-k",
                                             "1000000"]),
                          queries, tdc, tconf.diffs)
    want, _ = j_pq.run_tpu(jconf, j_parse_args([]), queries, jdc,
                           jconf.diffs)
    for other in (seq, want):
        assert len(fused) == len(other) == 3
        for rows_f, rows_o in zip(fused, other):
            assert len(rows_f) == len(rows_o) == 4
            for rf, ro in zip(rows_f, rows_o):
                assert rf[:7] == ro[:7] and rf[-1] == ro[-1]
    # a fused round's timers are an equal share of one interval
    total = [sum(r[9] for r in rows) for rows in fused]
    assert total[0] == pytest.approx(total[1]) == pytest.approx(total[2])
    # -w: the filter applies to the fused rounds as to sequential ones
    fw, _ = t_pq.run_tpu(tconf, parse_args(["--device", "cpu", "-w", "2"]),
                         queries, tdc, tconf.diffs)
    jw, _ = j_pq.run_tpu(jconf, j_parse_args(["-w", "2"]), queries, jdc,
                         jconf.diffs)
    for rows_f, rows_o in zip(fw, jw):
        assert [r[:7] for r in rows_f] == [r[:7] for r in rows_o]
