"""PyTorch port, delta rebuilds and epoch promotion (``models.cpd``,
``worker.engine``, ``make_cpds --delta-from``), held against the JAX
package on identical copies of one index (the 8 x 6 toy city, 8
workers, ``block_size`` 4) and against the port's own build from
scratch on the retimed graph. Every comparison is exact: the epoch
index's block files, ledger lines and ``index.json`` byte for byte, the
reports apart from paths, the dirty targets, and the promoted engine's
answers. Covered: an increase, a decrease, argmin ties, a chain of two
epochs, the empty diff, both degrades to a full build (the seed bound
and the dirty share), a pruned old diff, a pack4 index, a delta
interrupted after k blocks and resumed, promotion (gated by epoch,
monotone, failing without change, never healing), the CLI, and
``dist_to_targets`` on the transposed graph."""

import json
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)

from distributed_oracle_search_tpu.cli import make_cpds as j_make  # noqa: E402
from distributed_oracle_search_tpu.data import Graph as JGraph  # noqa: E402
from distributed_oracle_search_tpu.models import cpd as jcpd  # noqa: E402
from distributed_oracle_search_tpu.ops import bellman_ford as jbf  # noqa: E402
from distributed_oracle_search_tpu.ops.device_graph import (  # noqa: E402
    DeviceGraph as JDeviceGraph,
)
from distributed_oracle_search_tpu.parallel.partition import (  # noqa: E402
    DistributionController as JDC,
)
from distributed_oracle_search_tpu.transport.wire import (  # noqa: E402
    RuntimeConfig as JRuntimeConfig,
)
from distributed_oracle_search_tpu.worker import engine as jengine  # noqa: E402
from distributed_oracle_search_tpu_torch.cli import make_cpds as t_make  # noqa: E402
from distributed_oracle_search_tpu_torch.data import (  # noqa: E402
    Graph, synth_city_graph, write_diff, write_xy,
)
from distributed_oracle_search_tpu_torch.models import (  # noqa: E402
    cpd, dist_to_target, first_move_to_target,
)
from distributed_oracle_search_tpu_torch.ops import (  # noqa: E402
    DeviceGraph, bellman_ford,
)
from distributed_oracle_search_tpu_torch.parallel import (  # noqa: E402
    DistributionController,
)
from distributed_oracle_search_tpu_torch.transport import RuntimeConfig  # noqa: E402
from distributed_oracle_search_tpu_torch.worker import engine  # noqa: E402

W = 8
BS = 4


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The toy city (port and JAX graphs, an ``.xy`` file) and its raw
    index, built by the port on the CPU."""
    d = tmp_path_factory.mktemp("delta")
    g = synth_city_graph(8, 6, seed=7)
    xy = str(d / "city.xy")
    write_xy(xy, g.xs, g.ys, g.src, g.dst, g.w)
    jg = JGraph(g.xs, g.ys, g.src, g.dst, g.w)
    tdc = DistributionController("tpu", W, W, g.n, block_size=BS)
    jdc = JDC("tpu", W, W, g.n, block_size=BS)
    old = str(d / "index")
    _build_all(g, tdc, old)
    return {"d": d, "g": g, "jg": jg, "tdc": tdc, "jdc": jdc, "xy": xy,
            "old": old}


def _build_all(g, dc, outdir, **kw):
    for wid in range(dc.maxworker):
        cpd.build_worker_shard(g, dc, wid, outdir, device="cpu", **kw)
    cpd.write_index_manifest(outdir, dc)


def _tree(d):
    """Every file directly under ``d`` by name, with its bytes."""
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d))
            if os.path.isfile(os.path.join(d, f))}


def _blocks(d):
    return {f: b for f, b in _tree(d).items() if f.startswith("cpd-")}


def _retimed(g, difffile):
    return Graph(g.xs, g.ys, g.src, g.dst, g.weights_with_diff(difffile))


def _diff(path, g, eids, new_w):
    eids = np.asarray(eids)
    write_diff(str(path), g.src[eids], g.dst[eids],
               np.asarray(new_w, np.int64))
    return str(path)


def _hot(path, g, eids, mult):
    eids = np.asarray(eids)
    return _diff(path, g, eids, g.w[eids].astype(np.int64) * mult)


def _pair(world, tmp_path, src=None):
    """Two identical copies of an index: (JAX's, the port's)."""
    src = src or world["old"]
    j, t = str(tmp_path / "j"), str(tmp_path / "t")
    shutil.copytree(src, j)
    shutil.copytree(src, t)
    return j, t


def _delta_both(world, j_old, t_old, fused, **kw):
    """JAX's delta on ``j_old``, the port's on ``t_old``: equal reports
    (apart from the outdir) and equal epoch trees. Returns the port's
    report."""
    jrep = jcpd.delta_build_index(world["jg"], world["jdc"], j_old, fused,
                                  **kw)
    trep = cpd.delta_build_index(world["g"], world["tdc"], t_old, fused,
                                 device="cpu", **kw)
    assert jrep["outdir"] == jcpd.epoch_index_dir(j_old, jrep["epoch"])
    assert trep["outdir"] == cpd.epoch_index_dir(t_old, trep["epoch"])
    assert {**trep, "outdir": None} == {**jrep, "outdir": None}
    assert _tree(trep["outdir"]) == _tree(jrep["outdir"])
    return trep


def _scratch_equal(world, tmp_path, rep, fused, name="scratch"):
    scratch = str(tmp_path / name)
    _build_all(_retimed(world["g"], fused), world["tdc"], scratch)
    assert _blocks(rep["outdir"]) == _blocks(scratch)


# ------------------------------------------------------------ delta index

def test_delta_build_bit_identical_and_skips(world, tmp_path):
    """One increased and one decreased edge with small dirty cones: the
    port's epoch index is JAX's byte for byte and a build from scratch
    on the retimed graph; rows are recomputed and blocks copied."""
    g = world["g"]
    j, t = _pair(world, tmp_path)
    e1, e2 = 26, 41
    fused = _diff(tmp_path / "fused-e000005.diff", g, [e1, e2],
                  [int(g.w[e1]) * 7, max(int(g.w[e2]) - 1, 1)])
    c0 = dict(cpd.COUNTERS)
    rep = _delta_both(world, j, t, fused)
    assert rep["epoch"] == 5 and rep["changed_edges"] == 2
    _scratch_equal(world, tmp_path, rep, fused)
    assert 0 < rep["affected_rows"] < g.n
    assert 0 < rep["rows_recomputed"] < g.n
    assert rep["blocks_skipped"] > 0 and not rep["degraded_full"]
    assert rep["shards"] == W
    assert (cpd.COUNTERS["build_delta_rows_recomputed_total"]
            - c0["build_delta_rows_recomputed_total"]
            == rep["rows_recomputed"])
    assert (cpd.COUNTERS["build_delta_skipped_blocks_total"]
            - c0["build_delta_skipped_blocks_total"]
            == rep["blocks_skipped"])
    man = cpd.read_manifest(rep["outdir"])
    assert man["diff_epoch"] == 5
    assert man["diff_file"] == os.path.abspath(fused)
    assert {e.get("epoch") for e in cpd.BuildLedger(
        rep["outdir"], 0).entries().values()} == {5}


def _decrease(g):
    """An edge and a lower weight that makes it tense for some target."""
    for e in np.argsort(-g.w, kind="stable"):
        if g.w[e] > 2:
            return int(e), int(g.w[e]) // 3
    raise AssertionError("no edge to decrease")


@pytest.mark.parametrize("case", ["increase", "decrease"])
def test_delta_one_direction(world, tmp_path, case):
    g = world["g"]
    j, t = _pair(world, tmp_path)
    if case == "increase":
        fused = _hot(tmp_path / "fused-e000003.diff", g, [4], 11)
    else:
        e, w_new = _decrease(g)
        fused = _diff(tmp_path / "fused-e000003.diff", g, [e], [w_new])
    rep = _delta_both(world, j, t, fused)
    assert rep["changed_edges"] == 1 and rep["affected_rows"] > 0
    _scratch_equal(world, tmp_path, rep, fused)


def test_delta_chain_of_two_epochs(world, tmp_path):
    """Epoch 1 (a hotspot x3) from the free-flow index, then epoch 2 from
    the epoch-1 index: the hotspot back at free flow (the decrease
    branch) plus a second hotspot; each link equals JAX's and a build
    from scratch."""
    g = world["g"]
    j, t = _pair(world, tmp_path)
    fused1 = _hot(tmp_path / "fused-e000001.diff", g, [26, 27], 3)
    rep1 = _delta_both(world, j, t, fused1)
    _scratch_equal(world, tmp_path, rep1, fused1, "s1")
    hot2 = [41]
    fused2 = _diff(tmp_path / "fused-e000002.diff", g, [26, 27, *hot2],
                   [int(g.w[26]), int(g.w[27]), int(g.w[41]) * 3])
    rep2 = _delta_both(world, rep1["outdir"].replace(t, j), rep1["outdir"],
                       fused2)
    assert rep2["epoch"] == 2 and rep2["changed_edges"] == 3
    _scratch_equal(world, tmp_path, rep2, fused2, "s2")
    # the epoch comes from the manifest when the name carries none
    fused3 = _hot(tmp_path / "spool.diff", g, [6], 5)
    rep3 = _delta_both(world, rep2["outdir"].replace(t, j), rep2["outdir"],
                       fused3)
    assert rep3["epoch"] == 3


def test_delta_empty_diff_copies_everything(world, tmp_path):
    g = world["g"]
    j, t = _pair(world, tmp_path)
    fused = _diff(tmp_path / "fused-e000002.diff", g, [0, 1, 2], g.w[:3])
    rep = _delta_both(world, j, t, fused)
    assert rep["changed_edges"] == rep["rows_recomputed"] == 0
    assert rep["affected_rows"] == 0
    n_blocks = sum(-(-world["tdc"].n_owned(w) // BS) for w in range(W))
    assert rep["blocks_skipped"] == n_blocks
    assert _blocks(rep["outdir"]) == _blocks(t)


def test_delta_seed_bound_degrades_to_full(world, tmp_path, monkeypatch):
    g = world["g"]
    j, t = _pair(world, tmp_path)
    fused = _hot(tmp_path / "fused-e000005.diff", g, [1, 5, 9], 4)
    monkeypatch.setenv("DOS_BUILD_DELTA_MAX_SEEDS", "2")
    rep = _delta_both(world, j, t, fused)
    assert rep["degraded_full"] and rep["blocks_skipped"] == 0
    assert rep["affected_rows"] == g.n
    _scratch_equal(world, tmp_path, rep, fused)


def test_delta_dirty_share_degrades_to_full(world, tmp_path, monkeypatch):
    """A shard whose dirty share passes ``DOS_BUILD_DELTA_MAX_FRAC``
    builds in full (pipelined, epoch-keyed); clean shards still copy."""
    g = world["g"]
    j, t = _pair(world, tmp_path)
    fused = _hot(tmp_path / "fused-e000004.diff", g, [26], 7)
    monkeypatch.setenv("DOS_BUILD_DELTA_MAX_FRAC", "0.0")
    rep = _delta_both(world, j, t, fused)
    assert rep["degraded_full"] and rep["blocks_skipped"] > 0
    assert {e.get("epoch") for w in range(W) for e in cpd.BuildLedger(
        rep["outdir"], w).entries().values()} == {4}
    _scratch_equal(world, tmp_path, rep, fused)


def test_delta_pruned_old_diff_degrades_to_full(world, tmp_path):
    g = world["g"]
    j, t = _pair(world, tmp_path)
    fused2 = _hot(tmp_path / "fused-e000002.diff", g, [26], 7)
    rep2 = _delta_both(world, j, t, fused2)
    os.unlink(fused2)                      # the spool pruned it
    fused3 = _hot(tmp_path / "fused-e000003.diff", g, [41], 9)
    rep3 = _delta_both(world, rep2["outdir"].replace(t, j), rep2["outdir"],
                       fused3)
    assert rep3["degraded_full"]
    _scratch_equal(world, tmp_path, rep3, fused3)


def test_delta_splices_a_recomputed_block_when_the_copy_is_torn(
        world, tmp_path):
    """A clean block whose old copy no longer matches the old manifest is
    recomputed, not copied: the epoch index stays correct."""
    g = world["g"]
    j, t = _pair(world, tmp_path)
    for x in (j, t):
        p = os.path.join(x, "cpd-w00007-b00001.npy")
        data = bytearray(open(p, "rb").read())
        data[-1] ^= 0x55
        open(p, "wb").write(bytes(data))
    fused = _hot(tmp_path / "fused-e000006.diff", g, [26], 7)
    rep = _delta_both(world, j, t, fused)
    _scratch_equal(world, tmp_path, rep, fused)


# ---------------------------------------------------- affected targets

def _tie(g):
    """An edge and target where a lower weight TIES the old optimum."""
    for t in range(g.n):
        d = dist_to_target(g, t)
        # an edge (u, v) off every shortest path into t, d(u) - d(v) < w,
        # ties at w' = d(u) - d(v)
        gap = d[g.src] - d[g.dst]
        ok = np.nonzero((gap >= 0) & (gap < g.w) & (d[g.dst] < 2**30))[0]
        if len(ok):
            e = int(ok[0])
            return e, int(gap[e]), t
    raise AssertionError("no tie to make")


def _changed_rows(g, w_new, targets):
    """Targets whose first-move column differs between the old and new
    weights (by the CPU reference)."""
    return [tt for tt in targets
            if not np.array_equal(first_move_to_target(g, tt),
                                  first_move_to_target(g, tt, w_new))]


@pytest.mark.parametrize("case", ["increase", "decrease", "tie", "many"])
def test_delta_affected_targets_equal_jax(world, case):
    """The dirty targets equal JAX's, and cover every target whose first
    moves really change (a tie stays dirty)."""
    g, jg = world["g"], world["jg"]
    w_new = g.w.copy()
    if case == "increase":
        eids = np.array([4, 26])
        w_new[eids] *= 5
    elif case == "decrease":
        e, w = _decrease(g)
        eids = np.array([e])
        w_new[e] = w
    elif case == "tie":
        e, w, tie_t = _tie(g)
        eids = np.array([e])
        w_new[e] = w
    else:
        eids = np.random.default_rng(3).choice(g.m, 40, replace=False)
        w_new[eids] = np.maximum(w_new[eids] // 2, 1)
        w_new[eids[::2]] *= 6
    got = cpd.delta_affected_targets(g, eids, g.w, w_new, device="cpu",
                                     seed_chunk=16)
    want = jcpd.delta_affected_targets(jg, eids, jg.w, w_new,
                                       seed_chunk=16)
    assert got.dtype == np.int64 and np.array_equal(got, want)
    assert set(_changed_rows(g, w_new, range(g.n))) <= set(got.tolist())
    if case == "tie":
        assert tie_t in got


def test_delta_affected_targets_bound_and_empty(world):
    g, jg = world["g"], world["jg"]
    assert len(cpd.delta_affected_targets(
        g, np.zeros(0, np.int64), g.w, g.w, device="cpu")) == 0
    w2 = g.w.copy()
    w2[:8] *= 2
    assert cpd.delta_affected_targets(g, np.arange(8), g.w, w2,
                                      max_seeds=3, device="cpu") is None
    assert jcpd.delta_affected_targets(jg, np.arange(8), jg.w, w2,
                                       max_seeds=3) is None


@pytest.mark.parametrize("cut", [0, 1, 3])
def test_dist_to_targets_cpu_equals_jax(world, cut):
    """The plain relax the CPU path of the tense-edge pass runs, on the
    transposed graph, equals JAX's ``dist_to_targets`` at cuts and at
    convergence."""
    g = world["g"]
    gt = Graph(g.xs, g.ys, g.dst, g.src, g.w)
    jgt = JGraph(g.xs, g.ys, g.dst, g.src, g.w)
    t = np.array([3, 0, 17, -1, 40, -1, 47, 5], np.int32)
    got = bellman_ford.dist_to_targets(
        DeviceGraph.from_graph(gt, device="cpu"), t, max_iters=cut)
    want = np.asarray(jbf.dist_to_targets(JDeviceGraph.from_graph(jgt),
                                          t, max_iters=cut))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


def test_diff_epoch_of_and_epoch_dir():
    for name in ("spool/fused-e000042.diff", "road.xy.diff", "", None,
                 "fused-e7.diff"):
        assert cpd.diff_epoch_of(name) == jcpd.diff_epoch_of(name)
    assert cpd.diff_epoch_of("spool/fused-e000042.diff") == 42
    assert cpd.epoch_index_dir("/x/idx", 7) == jcpd.epoch_index_dir(
        "/x/idx", 7) == "/x/idx/epoch-e000007"


def test_delta_needs_a_gpu_unless_cpu(world, tmp_path):
    """No hidden fallback: the delta entry points run on the card unless
    asked for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None runs on it")
    g = world["g"]
    fused = _hot(tmp_path / "fused-e000001.diff", g, [4], 3)
    for call in (
            lambda: cpd.delta_build_index(g, world["tdc"], world["old"],
                                          fused),
            lambda: cpd.delta_affected_targets(g, np.array([4]), g.w, g.w),
            lambda: cpd.delta_build_worker_shard(
                g, world["tdc"], 0, world["old"], str(tmp_path / "o"),
                None)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not os.path.exists(cpd.epoch_index_dir(world["old"], 1))


# -------------------------------------------------- interrupted delta

@pytest.mark.parametrize("where,k", [("record", 0), ("record", 1),
                                     ("record", 3), ("record", 9),
                                     ("save", 0), ("save", 1),
                                     ("save", 2)])
def test_delta_interrupted_resumes_missing_blocks(world, tmp_path,
                                                  monkeypatch, where, k):
    """A delta that fails after k blocks (the k+1-th ledger line, or the
    k+1-th spliced block's write, raises): the rerun copies or
    recomputes exactly the blocks not journaled under the epoch, and the
    epoch index is byte-equal to an uninterrupted delta's."""
    g = world["g"]
    fused = _hot(tmp_path / "fused-e000008.diff", g, [2, 26], 9)
    whole = str(tmp_path / "whole")
    shutil.copytree(world["old"], whole)
    want = cpd.delta_build_index(g, world["tdc"], whole, fused,
                                 device="cpu")
    assert want["blocks_skipped"] > 9 and want["rows_recomputed"] > 0
    n_spliced = sum(-(-world["tdc"].n_owned(w) // BS)
                    for w in range(W)) - want["blocks_skipped"]
    assert n_spliced > 2
    old = str(tmp_path / "old")
    shutil.copytree(world["old"], old)
    calls = []
    real_record, real_save = cpd.BuildLedger.record, cpd.atomic_save_npy

    def record(self, *a, **kw):
        calls.append(1)
        if len(calls) > k:
            raise OSError("planted ledger fault")
        return real_record(self, *a, **kw)

    def save(path, arr):
        calls.append(1)
        if len(calls) > k:
            raise OSError("planted write fault")
        return real_save(path, arr)

    if where == "record":
        monkeypatch.setattr(cpd.BuildLedger, "record", record)
    else:
        monkeypatch.setattr(cpd, "atomic_save_npy", save)
    with pytest.raises(OSError, match="planted"):
        cpd.delta_build_index(g, world["tdc"], old, fused, device="cpu")
    monkeypatch.setattr(cpd.BuildLedger, "record", real_record)
    monkeypatch.setattr(cpd, "atomic_save_npy", real_save)
    out = cpd.epoch_index_dir(old, 8)
    journaled = {f for w in range(W)
                 for f, e in cpd.BuildLedger(out, w).entries().items()
                 if e.get("epoch") == 8}
    if where == "record":
        assert len(journaled) == k
    every = {cpd.shard_block_name(w, b) for w in range(W)
             for b in range(-(-world["tdc"].n_owned(w) // BS))}
    landed = []

    def copy(src, dst):
        landed.append(os.path.basename(dst))
        return real_copy(src, dst)

    def save2(path, arr):
        landed.append(os.path.basename(path))
        return real_save(path, arr)

    real_copy = cpd.atomic_copy_file
    monkeypatch.setattr(cpd, "atomic_copy_file", copy)
    monkeypatch.setattr(cpd, "atomic_save_npy", save2)
    rep = cpd.delta_build_index(g, world["tdc"], old, fused, device="cpu")
    assert sorted(landed) == sorted(every - journaled)
    assert rep["blocks_resumed"] == len(journaled)
    assert _tree(out) == _tree(want["outdir"])


# ------------------------------------------------------------- pack4

@pytest.fixture(scope="module")
def delta_city(tmp_path_factory):
    """A 432-node city, one worker, blocks of 64, a pack4 index."""
    g = synth_city_graph(24, 18, seed=3)
    jg = JGraph(g.xs, g.ys, g.src, g.dst, g.w)
    dc = DistributionController("div", g.n, 1, g.n, block_size=64)
    jdc = JDC("div", g.n, 1, g.n, block_size=64)
    d = str(tmp_path_factory.mktemp("comp-delta") / "index")
    cpd.build_worker_shard(g, dc, 0, d, chunk=64, codec="pack4",
                           device="cpu")
    cpd.write_index_manifest(d, dc)
    return {"g": g, "jg": jg, "tdc": dc, "jdc": jdc, "old": d}


def test_delta_empty_copies_containers(delta_city, tmp_path):
    g = delta_city["g"]
    j, t = _pair(delta_city, tmp_path)
    fused = _diff(tmp_path / "fused-e000001.diff", g, [0], g.w[:1])
    rep = _delta_both(delta_city, j, t, fused)
    assert rep["blocks_skipped"] == 7 and rep["rows_recomputed"] == 0
    assert all(m.get("codec") == "pack4" for m in cpd.read_manifest(
        rep["outdir"])["blocks"].values())


def test_delta_splice_on_compressed_index(delta_city, tmp_path):
    """A real retime splices through decode -> row splice -> re-encode:
    the epoch index is JAX's, stays pack4, and decodes to a raw build
    from scratch on the retimed graph."""
    g = delta_city["g"]
    j, t = _pair(delta_city, tmp_path)
    cand = np.nonzero((g.src > g.n - 30) & (g.dst > g.n - 30))[0][:1]
    fused = _hot(tmp_path / "fused-e000002.diff", g, cand, 3)
    rep = _delta_both(delta_city, j, t, fused)
    assert not rep["degraded_full"]
    assert 0 < rep["rows_recomputed"] < g.n
    full = str(tmp_path / "full")
    cpd.build_worker_shard(_retimed(g, fused), delta_city["tdc"], 0, full,
                           chunk=64, device="cpu")
    man = cpd.read_manifest(rep["outdir"])
    assert {m.get("codec") for m in man["blocks"].values()} == {"pack4"}
    for f in man["files"]:
        got = np.load(os.path.join(rep["outdir"], f))
        assert np.array_equal(cpd.maybe_decode_rows(got),
                              np.load(os.path.join(full, f)))


def test_delta_degrade_keeps_the_codec(delta_city, tmp_path, monkeypatch):
    g = delta_city["g"]
    j, t = _pair(delta_city, tmp_path)
    fused = _hot(tmp_path / "fused-e000003.diff", g, [5, 6, 7], 3)
    monkeypatch.setenv("DOS_BUILD_DELTA_MAX_SEEDS", "1")
    rep = _delta_both(delta_city, j, t, fused)
    assert rep["degraded_full"]
    assert {m.get("codec") for m in cpd.read_manifest(
        rep["outdir"])["blocks"].values()} == {"pack4"}


# ---------------------------------------------------------- promotion

def _queries(dc, g, wid, n, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, g.n, n),
                     rng.choice(dc.owned(wid), n)], axis=1)


@pytest.mark.parametrize("resident", ["raw", "pack4", "rle"])
def test_engine_promotes_epoch_index(world, tmp_path, monkeypatch,
                                     resident):
    """A promoted engine answers the epoch's batches from the new table,
    as JAX's promoted engine and an engine on a build from scratch do;
    free-flow batches and batches of another diff are unchanged."""
    g, jg = world["g"], world["jg"]
    monkeypatch.setenv("DOS_CPD_RESIDENT", resident)
    j, t = _pair(world, tmp_path)
    fused = _hot(tmp_path / "fused-e000005.diff", g, [4], 11)
    rep = _delta_both(world, j, t, fused)
    other = _hot(tmp_path / "fused-e000004.diff", g, [4], 11)
    wid = 0
    queries = _queries(world["tdc"], g, wid, 32, 3)
    eng = engine.ShardEngine(g, world["tdc"], wid, t, device="cpu")
    jeng = jengine.ShardEngine(jg, world["jdc"], wid, j)
    base = engine.ShardEngine(g, world["tdc"], wid, t, device="cpu")
    assert eng.index_epoch == 0
    th = eng.promote_index_async(rep["outdir"], rep["epoch"])
    th.join(timeout=30)
    assert eng.index_epoch == rep["epoch"] == 5
    assert jeng.promote_index(rep["outdir"].replace(t, j), rep["epoch"])
    scratch = str(tmp_path / "scratch")
    _build_all(_retimed(g, fused), world["tdc"], scratch)
    ref = engine.ShardEngine(g, world["tdc"], wid, scratch, device="cpu")
    for cfg, jcfg in ((RuntimeConfig(), JRuntimeConfig()),
                      (RuntimeConfig(k_moves=3, extract=True),
                       JRuntimeConfig(k_moves=3, extract=True))):
        got = eng.answer(queries, cfg, difffile=fused)
        want = jeng.answer(queries, jcfg, difffile=fused)
        scr = ref.answer(queries, cfg, difffile=fused)
        for a, b, c in zip(got[:3], want[:3], scr[:3]):
            assert np.array_equal(a, np.asarray(b))
            assert np.array_equal(a, c)
        if cfg.extract:
            assert np.array_equal(eng.last_paths[0],
                                  np.asarray(jeng.last_paths[0]))
    # the gate: free flow and another epoch's diff walk the base table
    for diff in ("-", other):
        got = eng.answer(queries, RuntimeConfig(), difffile=diff)
        want = base.answer(queries, RuntimeConfig(), difffile=diff)
        jwant = jeng.answer(queries, JRuntimeConfig(), difffile=diff)
        for a, b, c in zip(got[:3], want[:3], jwant[:3]):
            assert np.array_equal(a, b) and np.array_equal(a, np.asarray(c))


def test_engine_promotion_failure_keeps_old_table(world, tmp_path):
    eng = engine.ShardEngine(world["g"], world["tdc"], 0, world["old"],
                             device="cpu")
    fm_before = eng.fm
    assert not eng.promote_index(str(tmp_path / "nope"), 3)
    assert eng.index_epoch == 0 and eng.fm is fm_before
    assert eng._fm_promoted is None
    astar = engine.ShardEngine(world["g"], world["tdc"], 0, world["old"],
                               alg="astar", device="cpu")
    assert not astar.promote_index(world["old"], 3)


def test_engine_promotion_rejects_a_row_count_mismatch(world, tmp_path):
    """An epoch index of another partition does not promote."""
    g = world["g"]
    dc2 = DistributionController("tpu", 4, 4, g.n, block_size=BS)
    other = str(tmp_path / "other")
    _build_all(g, dc2, other)
    eng = engine.ShardEngine(g, world["tdc"], 0, world["old"], device="cpu")
    assert not eng.promote_index(other, 2)
    assert eng.index_epoch == 0


def test_engine_promotion_is_monotone(world, tmp_path):
    g = world["g"]
    j, t = _pair(world, tmp_path)
    fused = _hot(tmp_path / "fused-e000005.diff", g, [26], 7)
    rep = _delta_both(world, j, t, fused)
    eng = engine.ShardEngine(g, world["tdc"], 0, t, device="cpu")
    assert eng.promote_index(rep["outdir"], rep["epoch"])
    table = eng._fm_promoted
    assert not eng.promote_index(rep["outdir"], rep["epoch"] - 1)
    assert not eng.promote_index(rep["outdir"], rep["epoch"])
    assert eng.index_epoch == rep["epoch"] and eng._fm_promoted is table


def test_engine_promotion_never_heals_with_freeflow_graph(world, tmp_path):
    """A corrupt epoch-index block fails the promotion; the bytes stay as
    they are (no quarantine, no rebuild from the free-flow graph)."""
    g = world["g"]
    j, t = _pair(world, tmp_path)
    fused = _hot(tmp_path / "fused-e000005.diff", g, [26], 7)
    rep = _delta_both(world, j, t, fused)
    victim = os.path.join(rep["outdir"], "cpd-w00000-b00000.npy")
    raw = bytearray(open(victim, "rb").read())
    raw[-3] ^= 0xFF
    open(victim, "wb").write(bytes(raw))
    eng = engine.ShardEngine(g, world["tdc"], 0, t, device="cpu")
    c0 = cpd.COUNTERS["cpd_blocks_rebuilt_total"]
    assert not eng.promote_index(rep["outdir"], rep["epoch"])
    assert eng.index_epoch == 0
    assert open(victim, "rb").read() == bytes(raw)
    assert not os.path.exists(victim + ".quarantined")
    assert cpd.COUNTERS["cpd_blocks_rebuilt_total"] == c0


# ---------------------------------------------------------------- CLI

def _conf(world, path, old):
    with open(path, "w") as f:
        json.dump({"workers": [f"tpu:{i}" for i in range(W)],
                   "partmethod": "tpu", "partkey": W, "outdir": old,
                   "xy_file": world["xy"]}, f)
    return str(path)


def test_make_cpds_delta_from_cli(world, tmp_path, capsys):
    """``make_cpds --delta-from OLD --diff FUSED`` prints JAX's report
    (apart from the paths) and writes JAX's epoch index; an explicit
    ``--delta-epoch`` wins over the name."""
    g = world["g"]
    j, t = _pair(world, tmp_path)
    fused = _hot(tmp_path / "fused-e000005.diff", g, [6], 5)
    outs = []
    for main, old, extra in ((j_make.main, j, []),
                             (t_make.main, t, ["--device", "cpu"])):
        conf = _conf(world, tmp_path / f"conf-{len(outs)}.json", old)
        assert main(["-c", conf, "--delta-from", old, "--diff", fused,
                     *extra]) == 0
        outs.append(json.loads(
            capsys.readouterr().out.strip().splitlines()[-1]))
    jout, tout = outs
    assert tout["exit_code"] == 0 and tout["epoch"] == 5
    assert {**tout, "outdir": None} == {**jout, "outdir": None}
    assert _tree(tout["outdir"]) == _tree(jout["outdir"])
    _scratch_equal(world, tmp_path, tout, fused)
    conf = _conf(world, tmp_path / "conf-e.json", t)
    assert t_make.main(["-c", conf, "--delta-from", t, "--diff", fused,
                        "--delta-epoch", "9", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["epoch"] == 9 and out["outdir"] == cpd.epoch_index_dir(t, 9)


def test_make_cpds_delta_exit_codes(world, tmp_path, capsys):
    """Exit 4 (and JAX's fatal line, apart from the message) without a
    readable manifest; 2 without ``--diff``."""
    fused = _hot(tmp_path / "fused-e000001.diff", world["g"], [6], 5)
    missing = str(tmp_path / "no-index")
    codes = []
    for main, extra in ((j_make.main, []),
                        (t_make.main, ["--device", "cpu"])):
        conf = _conf(world, tmp_path / "c.json", missing)
        codes.append(main(["-c", conf, "--delta-from", missing, "--diff",
                           fused, *extra]))
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert out["exit_code"] == 4 and out["index"] == missing
        assert sorted(out) == ["exit_code", "fatal", "index"]
    assert codes == [4, 4]
    conf = _conf(world, tmp_path / "c.json", world["old"])
    assert t_make.main(["-c", conf, "--delta-from", world["old"],
                        "--device", "cpu"]) == 2
    assert not os.path.exists(missing)
