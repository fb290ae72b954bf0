"""PyTorch port, shard engine: the port's ``ShardEngine(device="cpu")``
loads the checked-in ``data/index`` and answers ``data/synth.scen`` —
free flow and under ``data/synth-city.xy.diff`` — exactly as the JAX
``ShardEngine`` does, ``StatsRow`` sums included; likewise for move
budgets, extraction, repeats, the chunked ns-budget path and dedup. The
per-worker build CLI rebuilds ``data/index``'s rows."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from distributed_oracle_search_tpu.data import Graph as JGraph  # noqa: E402
from distributed_oracle_search_tpu.data import read_scen  # noqa: E402
from distributed_oracle_search_tpu.parallel.partition import (  # noqa: E402
    DistributionController as JDC,
)
from distributed_oracle_search_tpu.transport.wire import (  # noqa: E402
    RuntimeConfig as JConfig,
)
from distributed_oracle_search_tpu.worker.engine import (  # noqa: E402
    ShardEngine as JEngine,
)
from distributed_oracle_search_tpu_torch.data import Graph  # noqa: E402
from distributed_oracle_search_tpu_torch.data import synth_diff, write_diff  # noqa: E402
from distributed_oracle_search_tpu_torch.parallel import (  # noqa: E402
    DistributionController,
)
from distributed_oracle_search_tpu_torch.transport import RuntimeConfig  # noqa: E402
from distributed_oracle_search_tpu_torch.worker import build as wbuild  # noqa: E402
from distributed_oracle_search_tpu_torch.worker.engine import (  # noqa: E402
    ShardEngine, load_shard_rows,
)

DATA = os.path.join(os.path.dirname(os.path.dirname(__file__)), "data")
INDEX = os.path.join(DATA, "index")
XY = os.path.join(DATA, "synth-city.xy")
DIFF = os.path.join(DATA, "synth-city.xy.diff")
COUNT_FIELDS = ("n_expanded", "n_inserted", "n_touched", "n_updated",
                "n_surplus", "plen", "finished")


@pytest.fixture(scope="module")
def setup():
    jg, tg = JGraph.from_xy(XY), Graph.from_xy(XY)
    jdc = JDC("tpu", 8, 8, jg.n)
    tdc = DistributionController("tpu", 8, 8, tg.n)
    groups = tdc.group_queries(read_scen(os.path.join(DATA, "synth.scen")))
    return jg, tg, jdc, tdc, groups


@pytest.fixture(scope="module")
def engines(setup):
    jg, tg, jdc, tdc, groups = setup
    return {w: (JEngine(jg, jdc, w, INDEX),
                ShardEngine(tg, tdc, w, INDEX, device="cpu"))
            for w in groups}


def _both(engines, wid, queries, difffile="-", **cfg):
    je, te = engines[wid]
    a = je.answer(queries, JConfig(**cfg), difffile)
    b = te.answer(queries, RuntimeConfig(**cfg), difffile)
    return a, b, je.last_paths, te.last_paths


def _assert_same(a, b):
    for x, y in zip(a[:3], b[:3]):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    for f in COUNT_FIELDS:
        assert getattr(a[3], f) == getattr(b[3], f), f


@pytest.mark.parametrize("difffile", ["-", DIFF])
def test_scenario_answers_equal_jax_engine(setup, engines, difffile):
    *_, groups = setup
    assert len(groups) == 8
    total = 0
    for wid, queries in groups.items():
        a, b, _, _ = _both(engines, wid, queries, difffile)
        _assert_same(a, b)
        assert b[3].finished == len(queries)       # strongly connected
        total += len(queries)
    assert total == 512


@pytest.mark.parametrize("k_moves", [0, 1, 3])
def test_move_budget_and_extract_equal(setup, engines, k_moves):
    *_, groups = setup
    for wid in (1, 6):
        a, b, pa, pb = _both(engines, wid, groups[wid], DIFF,
                             k_moves=k_moves, extract=True)
        _assert_same(a, b)
        if k_moves > 0:
            for x, y in zip(pa, pb):
                np.testing.assert_array_equal(x, y)
            assert pb[0].shape == (len(groups[wid]), k_moves + 1)
        else:
            assert pa is None and pb is None


@pytest.mark.parametrize("time_ns,itrs", [(10 ** 13, 1), (10 ** 13, 2),
                                          (1, 1)])
def test_chunked_time_budget_equal(setup, engines, time_ns, itrs):
    """Under an ns budget the batch runs in chunks with the deadline
    checked between them; a budget of 1 ns answers the first chunk only
    and still extracts every query's prefix (the JAX engine's
    asymmetry)."""
    *_, groups = setup
    je, te = engines[2]
    je.astar_chunk = te.time_chunk = 16
    try:
        a, b, pa, pb = _both(engines, 2, groups[2], time=time_ns,
                             itrs=itrs, k_moves=4, extract=True)
    finally:
        je.astar_chunk, te.time_chunk = 1024, 1024
    _assert_same(a, b)
    for x, y in zip(pa, pb):
        np.testing.assert_array_equal(x, y)
    if time_ns == 1:
        assert 0 < b[3].finished < len(groups[2])
        assert pb[0].shape[0] == len(groups[2])


def test_duplicates_and_zero_length_equal(setup, engines):
    *_, groups = setup
    q = groups[5]
    queries = np.concatenate([q, q[:7], np.stack([q[:4, 1], q[:4, 1]], 1)])
    a, b, _, _ = _both(engines, 5, queries)
    _assert_same(a, b)
    np.testing.assert_array_equal(b[0][len(q):len(q) + 7], b[0][:7])
    assert (b[1][-4:] == 0).all() and b[2][-4:].all()


def test_empty_batch_and_routing_invariant(setup, engines):
    *_, groups = setup
    _, te = engines[3]
    cost, plen, fin, stats = te.answer(np.zeros((0, 2), np.int64),
                                       RuntimeConfig(k_moves=2,
                                                     extract=True))
    assert cost.shape == (0,) and stats.n_touched == 0
    assert te.last_paths[0].shape == (0, 3)
    with pytest.raises(ValueError, match="routing invariant"):
        te.answer(groups[4], RuntimeConfig())


def test_weight_cache_is_lru_bounded(setup, tmp_path, monkeypatch):
    _, tg, _, tdc, groups = setup
    monkeypatch.setenv("DOS_TRAFFIC_WEIGHT_EPOCHS", "2")
    te = ShardEngine(tg, tdc, 0, INDEX, device="cpu")
    diffs = []
    for seed in range(3):
        p = str(tmp_path / f"d{seed}.diff")
        write_diff(p, *synth_diff(tg, frac=0.3, seed=seed))
        diffs.append(p)
    answers = [te.answer(groups[0], RuntimeConfig(), d)[0] for d in diffs]
    assert list(te._weight_cache) == diffs[1:]
    np.testing.assert_array_equal(
        te.answer(groups[0], RuntimeConfig(), diffs[0])[0], answers[0])
    te.answer(groups[0], RuntimeConfig(no_cache=True), diffs[2])
    assert not te._weight_cache


def test_build_cli_rebuilds_checked_in_rows(setup, tmp_path):
    *_, tdc, _ = setup
    out = str(tmp_path)
    for wid in (0, 7):
        assert wbuild.main(["--input", XY, "--partmethod", "tpu",
                            "--partkey", "8", "--workerid", str(wid),
                            "--maxworker", "8", "--outdir", out,
                            "--chunk", "16", "--device", "cpu"]) == 0
        np.testing.assert_array_equal(load_shard_rows(out, wid),
                                      load_shard_rows(INDEX, wid))
