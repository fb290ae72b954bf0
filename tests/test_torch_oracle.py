"""PyTorch port, the in-process oracle: the port's ``CPDOracle`` on
``device="cpu"`` against the JAX ``CPDOracle`` on the root conftest's 8
CPU devices, on ``data/synth-city.xy`` with ``partmethod tpu`` and 8
workers. Held exactly (no tolerance): the ``[W, R, N]`` table from
``build`` (whole and in chunks that do not divide R), ``save``'s block
digests with each package loading the other's index, the checked-in
``data/index``, ``route``, and ``query``/``query_paths`` answers — free
flow, under ``data/synth-city.xy.diff``, with move budgets, step cuts and
the ``-w`` filter — and, after unrouting, the answers of a JAX oracle on
a ``[2, 4]`` data × worker mesh. Also: the pair table is built once per
weight set, a bad block heals (or raises with ``heal=False``), and the
synthetic dataset writer writes the JAX package's files."""

import filecmp
import json
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)

from distributed_oracle_search_tpu.data import Graph as JGraph  # noqa: E402
from distributed_oracle_search_tpu.data import read_scen  # noqa: E402
from distributed_oracle_search_tpu.data.synth import (  # noqa: E402
    ensure_synth_dataset as j_ensure_synth_dataset,
)
from distributed_oracle_search_tpu.models.cpd import (  # noqa: E402
    CPDOracle as JOracle,
)
from distributed_oracle_search_tpu.parallel.mesh import make_mesh  # noqa: E402
from distributed_oracle_search_tpu.parallel.partition import (  # noqa: E402
    DistributionController as JDC,
)
from distributed_oracle_search_tpu_torch.data import Graph, read_diff  # noqa: E402
from distributed_oracle_search_tpu_torch.data.synth import (  # noqa: E402
    ensure_synth_dataset,
)
from distributed_oracle_search_tpu_torch.models import cpd  # noqa: E402
from distributed_oracle_search_tpu_torch.models.cpd import CPDOracle  # noqa: E402
from distributed_oracle_search_tpu_torch.parallel import (  # noqa: E402
    DistributionController,
)
from distributed_oracle_search_tpu_torch.parallel.sharded import (  # noqa: E402
    pad_targets,
)

DATA = os.path.join(os.path.dirname(os.path.dirname(__file__)), "data")
INDEX = os.path.join(DATA, "index")
XY = os.path.join(DATA, "synth-city.xy")
DIFF = os.path.join(DATA, "synth-city.xy.diff")
SCEN = os.path.join(DATA, "synth.scen")


@pytest.fixture(scope="module")
def setup():
    jg, tg = JGraph.from_xy(XY), Graph.from_xy(XY)
    jdc = JDC("tpu", 8, 8, jg.n)
    tdc = DistributionController("tpu", 8, 8, tg.n)
    queries = read_scen(SCEN)
    w_diff = tg.weights_with_diff(read_diff(DIFF))
    return jg, tg, jdc, tdc, queries, w_diff


@pytest.fixture(scope="module")
def built(setup):
    jg, tg, jdc, tdc, *_ = setup
    jo = JOracle(jg, jdc).build()
    to = CPDOracle(tg, tdc, device="cpu").build()
    return jo, to


def _fm(oracle) -> np.ndarray:
    fm = oracle.fm
    return fm.numpy() if isinstance(fm, torch.Tensor) else np.asarray(fm)


def test_pad_targets_equal(built):
    jo, to = built
    np.testing.assert_array_equal(to.targets_wr, jo.targets_wr)
    assert to.targets_wr.dtype == np.int32
    uneven = DistributionController("mod", 3, 3, 10)
    np.testing.assert_array_equal(pad_targets(uneven),
                                  [[0, 3, 6, 9], [1, 4, 7, -1],
                                   [2, 5, 8, -1]])


@pytest.mark.parametrize("chunk", [0, 5, 16])
def test_build_fm_byte_equal(setup, built, chunk):
    """chunk 0 builds a worker's 54 rows at once; 5 and 16 do not divide
    R, so the last batch of each worker is padded."""
    _, tg, _, tdc, *_ = setup
    jo, to = built
    got = (to if chunk == 0
           else CPDOracle(tg, tdc, device="cpu").build(chunk=chunk))
    want = _fm(jo)
    assert got.fm.dtype == torch.int8 and got.fm.device.type == "cpu"
    assert got.fm.shape == want.shape == (8, 54, tg.n)
    np.testing.assert_array_equal(got.fm.numpy(), want)


def test_build_max_iters_cut_equal(setup):
    jg, tg, jdc, tdc, *_ = setup
    jo = JOracle(jg, jdc).build(max_iters=6, method="ell")
    to = CPDOracle(tg, tdc, device="cpu").build(max_iters=6)
    np.testing.assert_array_equal(_fm(to), _fm(jo))


def test_build_methods_not_ported_raise(setup, built):
    """Every JAX build method is ported and builds the same table; only
    a method the JAX package does not have raises, before any build."""
    _, tg, _, tdc, *_ = setup
    o = CPDOracle(tg, tdc, device="cpu")
    with pytest.raises(ValueError, match="unknown build method"):
        o.build(method="bogus")
    assert o.fm is None
    for method in ("sweep", "shift", "frontier", "ellsplit"):
        o.build(method=method, chunk=64)
        assert o.build_kind == method
        np.testing.assert_array_equal(_fm(o), _fm(built[0]))


def _digests(outdir):
    with open(os.path.join(outdir, "index.json")) as f:
        man = json.load(f)
    return man["files"], {k: (v["digest"], v["shape"], v.get("codec"))
                          for k, v in man["blocks"].items()}


@pytest.mark.parametrize("codec", ["raw", "pack4", "rle"])
def test_save_digests_equal_and_cross_load(setup, built, tmp_path, codec):
    jg, tg, jdc, tdc, *_ = setup
    jo, to = built
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jo.save(jdir, codec=codec)
    to.save(tdir, codec=codec)
    jfiles, jmeta = _digests(jdir)
    tfiles, tmeta = _digests(tdir)
    assert tfiles == jfiles and len(tfiles) == 8
    assert tmeta == jmeta
    if codec != "raw":
        assert {m[2] for m in tmeta.values()} == {codec}
    for f in tfiles:
        assert filecmp.cmp(os.path.join(jdir, f), os.path.join(tdir, f),
                           shallow=False)
    t_from_j = CPDOracle(tg, tdc, device="cpu").load(jdir)
    j_from_t = JOracle(jg, jdc).load(tdir)
    np.testing.assert_array_equal(_fm(t_from_j), _fm(jo))
    np.testing.assert_array_equal(_fm(j_from_t), _fm(jo))


def test_load_checked_in_index(setup, built):
    jg, tg, jdc, tdc, *_ = setup
    jo, to = built
    got = CPDOracle(tg, tdc, device="cpu").load(INDEX)
    want = JOracle(jg, jdc).load(INDEX)
    assert got.fm.shape == (8, 54, tg.n)
    np.testing.assert_array_equal(_fm(got), _fm(want))
    np.testing.assert_array_equal(_fm(got), _fm(to))


@pytest.mark.parametrize("fault", ["corrupt", "missing"])
def test_bad_block_heals_or_raises(setup, built, tmp_path, fault):
    """``load(heal=True)`` quarantines a corrupt block (or finds a missing
    one), rebuilds it from the graph and loads the table it was saved
    from; ``heal=False`` raises the per-block diagnostic instead."""
    _, tg, _, tdc, *_ = setup
    _, to = built
    out = str(tmp_path)
    to.save(out)
    victim = os.path.join(out, cpd.shard_block_name(5, 0))
    with open(victim, "rb") as f:
        original = f.read()

    def plant():
        if fault == "missing":
            os.remove(victim)
        else:
            with open(victim, "r+b") as f:
                f.seek(-1, os.SEEK_END)
                f.write(b"\x7f")

    plant()
    with pytest.raises(ValueError, match=f"{os.path.basename(victim)} in "
                       f".* is {fault}"):
        CPDOracle(tg, tdc, device="cpu").load(out, heal=False)
    healed = CPDOracle(tg, tdc, device="cpu").load(out, heal=True)
    np.testing.assert_array_equal(_fm(healed), _fm(to))
    with open(victim, "rb") as f:
        assert f.read() == original
    assert os.path.exists(victim + ".quarantined") == (fault == "corrupt")
    plant()
    with pytest.raises(ValueError, match=fault):
        CPDOracle(tg, tdc, device="cpu").load(out, heal=False)


def test_manifest_of_other_partition_refused(setup, built, tmp_path):
    _, tg, *_ = setup
    _, to = built
    to.save(str(tmp_path))
    other = DistributionController("mod", 8, 8, tg.n)
    with pytest.raises(ValueError, match="partmethod"):
        CPDOracle(tg, other, device="cpu").load(str(tmp_path))


@pytest.mark.parametrize("active_worker", [-1, 3])
def test_route_equal(setup, built, active_worker):
    *_, queries, _ = setup
    jo, to = built
    want = jo.route(queries, active_worker)
    got = to.route(queries, active_worker)
    for a, b in zip(got[:4], want[:4]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got[4], want[4]):
        np.testing.assert_array_equal(a, b)


#: query knobs held against the JAX oracle: free run, move budgets, step
#: cuts (5 stops most walks short; 17 is not a multiple of the unroll
#: quantum) and the -w filter
QUERY_CASES = [{}, {"k_moves": 8}, {"k_moves": 0}, {"max_steps": 5},
               {"max_steps": 17}, {"active_worker": 3},
               {"k_moves": 3, "active_worker": 6}]


@pytest.mark.parametrize("diffed", [False, True], ids=["free", "diff"])
@pytest.mark.parametrize("kw", QUERY_CASES, ids=lambda kw: ",".join(
    f"{k}={v}" for k, v in kw.items()) or "default")
def test_query_equal(setup, built, diffed, kw):
    *_, queries, w_diff = setup
    jo, to = built
    w = w_diff if diffed else None
    want = jo.query(queries, w_query=w, **kw)
    got = to.query(queries, w_query=w, **kw)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    if not kw:
        assert got[2].all()                 # strongly connected


@pytest.mark.parametrize("active_worker", [-1, 3])
def test_query_paths_equal(setup, built, active_worker):
    *_, queries, _ = setup
    jo, to = built
    want = jo.query_paths(queries, k=8, active_worker=active_worker)
    got = to.query_paths(queries, k=8, active_worker=active_worker)
    assert got[0].shape == (len(queries), 9)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="positive"):
        to.query_paths(queries, k=0)


def test_answers_equal_a_data_by_worker_mesh(setup):
    """A JAX oracle on a [2, 4] data x worker mesh splits each worker's
    queries over two data slots; the port routes them over one. After
    unrouting the answers are the same."""
    jg, tg, *_, queries, w_diff = setup
    jo = JOracle(jg, JDC("tpu", 4, 4, jg.n),
                 mesh=make_mesh(n_workers=4, n_data=2)).build()
    to = CPDOracle(tg, DistributionController("tpu", 4, 4, tg.n),
                   device="cpu").build()
    assert jo.route(queries)[0].shape[0] == 2
    assert to.route(queries)[0].shape[0] == 1
    np.testing.assert_array_equal(_fm(to), _fm(jo))
    for w in (None, w_diff):
        for a, b in zip(to.query(queries, w_query=w),
                        jo.query(queries, w_query=w)):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(to.query_paths(queries, k=8),
                    jo.query_paths(queries, k=8)):
        np.testing.assert_array_equal(a, b)


def test_empty_batch(built):
    jo, to = built
    empty = np.zeros((0, 2), np.int64)
    for a, b in zip(to.query(empty), jo.query(empty)):
        assert a.shape == b.shape == (0,)


def test_pair_table_built_once_per_weight_set(setup, monkeypatch):
    _, tg, _, tdc, queries, w_diff = setup
    to = CPDOracle(tg, tdc, device="cpu").load(INDEX)
    built_for = []
    real = cpd.walk_pairs

    def counting(dg, w_pad):
        built_for.append(w_pad.clone())
        return real(dg, w_pad)

    monkeypatch.setattr(cpd, "walk_pairs", counting)
    first = to.query(queries)
    to.query(queries, k_moves=4)
    d1 = to.query(queries, w_query=w_diff)
    d2 = to.query(queries, w_query=w_diff.copy())   # same weights, new array
    assert len(built_for) == 2
    np.testing.assert_array_equal(d1[0], d2[0])
    assert not np.array_equal(d1[0], first[0])
    to.query(queries, w_query=w_diff * 2)
    assert len(built_for) == 3


def test_weight_sets_lru_bounded(setup, monkeypatch):
    _, tg, _, tdc, queries, w_diff = setup
    monkeypatch.setenv("DOS_TRAFFIC_WEIGHT_EPOCHS", "2")
    to = CPDOracle(tg, tdc, device="cpu").load(INDEX)
    for scale in (1, 2, 3):
        to.query(queries[:10], w_query=w_diff * scale)
    assert len(to._weights) == 2


def test_query_before_build_raises(setup):
    _, tg, _, tdc, queries, _ = setup
    o = CPDOracle(tg, tdc, device="cpu")
    for call in (lambda: o.query(queries), lambda: o.query_paths(queries, 2),
                 lambda: o.save("unused")):
        with pytest.raises(RuntimeError, match="build"):
            call()


def test_synth_dataset_files_equal(tmp_path):
    """``ensure_synth_dataset`` writes the JAX package's three files
    byte for byte, and the checked-in dataset is what it writes."""
    j, t = tmp_path / "jax", tmp_path / "torch"
    jp = j_ensure_synth_dataset(str(j))
    tp = ensure_synth_dataset(str(t))
    assert [os.path.basename(p) for p in tp.values()] == [
        os.path.basename(p) for p in jp.values()]
    for key in ("xy", "scen", "diff"):
        assert filecmp.cmp(jp[key], tp[key], shallow=False), key
        assert filecmp.cmp(tp[key], os.path.join(DATA, os.path.basename(
            tp[key])), shallow=False), key
    # idempotent: an existing file is left as it is
    shutil.copy(tp["scen"], tp["xy"])
    ensure_synth_dataset(str(t))
    assert filecmp.cmp(tp["scen"], tp["xy"], shallow=False)
