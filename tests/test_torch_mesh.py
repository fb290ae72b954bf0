"""PyTorch port, device grids and worker lanes (``parallel/mesh.py``, the
lane half of ``parallel/sharded.py``, ``ShardEngine``'s lanes and
``CPDOracle``'s grid) against the JAX package.

The lanes must not show in the answers: at every lane count in {1, 2,
4, 8} the port's lane engine answers (costs, plens, finished, path
prefixes) equal the JAX package's SINGLE-DEVICE engine, whose answers
are the reference (its Pallas-interpret lanes are not: they fail on the
CPU). Lane builds write block files byte-equal to the JAX build's; the
oracle over ``[1, 8]`` and ``[2, 4]`` grids answers as JAX's
``CPDOracle`` on the conftest's 8-device CPU mesh, and so does a grid
split over two parts, as on two cards. The CPU is one torch device, so
every lane and cell here names it: lanes that share a device share one
copy of the table.
"""

import glob
import hashlib
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)

from distributed_oracle_search_tpu.data import synth_diff as j_synth_diff  # noqa: E402
from distributed_oracle_search_tpu.data.formats import (  # noqa: E402
    write_diff as j_write_diff,
)
from distributed_oracle_search_tpu.models.cpd import (  # noqa: E402
    CPDOracle as JOracle, build_worker_shard as j_build_worker_shard,
)
from distributed_oracle_search_tpu.parallel import mesh as jmesh  # noqa: E402
from distributed_oracle_search_tpu.parallel.partition import (  # noqa: E402
    DistributionController as JDC,
)
from distributed_oracle_search_tpu.transport.wire import (  # noqa: E402
    RuntimeConfig as JConfig,
)
from distributed_oracle_search_tpu.utils.config import (  # noqa: E402
    ClusterConfig as JConf,
)
from distributed_oracle_search_tpu.worker.engine import (  # noqa: E402
    ShardEngine as JEngine,
)
from distributed_oracle_search_tpu_torch.data import (  # noqa: E402
    read_diff, synth_city_graph,
)
from distributed_oracle_search_tpu_torch.models import cpd  # noqa: E402
from distributed_oracle_search_tpu_torch.models.cpd import (  # noqa: E402
    CPDOracle, build_worker_shard,
)
from distributed_oracle_search_tpu_torch.ops import cuda_walk as cw  # noqa: E402
from distributed_oracle_search_tpu_torch.parallel import mesh  # noqa: E402
from distributed_oracle_search_tpu_torch.parallel import sharded  # noqa: E402
from distributed_oracle_search_tpu_torch.parallel.partition import (  # noqa: E402
    DistributionController,
)
from distributed_oracle_search_tpu_torch.transport import RuntimeConfig  # noqa: E402
from distributed_oracle_search_tpu_torch.utils.config import (  # noqa: E402
    ClusterConfig,
)
from distributed_oracle_search_tpu_torch.worker.engine import (  # noqa: E402
    ShardEngine,
)

LANES = (1, 2, 4, 8)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def tg():
    """The port's copy of the conftest's ``toy_graph`` (8x6 city)."""
    return synth_city_graph(8, 6, seed=7)


@pytest.fixture(scope="module")
def dcs(toy_graph):
    return (JDC("tpu", None, 1, toy_graph.n),
            DistributionController("tpu", None, 1, toy_graph.n))


@pytest.fixture(scope="module")
def shard_dir(toy_graph, dcs, tmp_path_factory):
    """Worker 0's one-worker shard, built by the JAX package."""
    d = str(tmp_path_factory.mktemp("tmesh-shard"))
    j_build_worker_shard(toy_graph, dcs[0], 0, d, chunk=16)
    return d


@pytest.fixture(scope="module")
def diff_file(toy_graph, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tmesh-diff") / "t.diff")
    j_write_diff(path, *j_synth_diff(toy_graph, frac=0.3, seed=3))
    return path


@pytest.fixture(scope="module")
def walk_queries(toy_queries):
    """Scenario plus zero-length (s == t) and duplicate pairs: the
    dedup/unsort machinery must survive lanes."""
    q = np.asarray(toy_queries, np.int64)
    extra = np.array([[3, 3], [0, 0], q[0].tolist(), q[0].tolist(),
                      q[5].tolist()], np.int64)
    return np.concatenate([q, extra], axis=0)


@pytest.fixture(scope="module")
def jax_engine(toy_graph, dcs, shard_dir):
    """The JAX package's single-device engine: the reference answers."""
    eng = JEngine(toy_graph, dcs[0], 0, shard_dir)
    assert eng.mesh is None
    return eng


def _lane_engine(monkeypatch, lanes, tg, dc, shard_dir, **kw):
    monkeypatch.setenv("DOS_MESH_DEVICES", str(lanes))
    eng = ShardEngine(tg, dc, 0, shard_dir, device="cpu", **kw)
    assert eng.n_lanes == lanes
    assert (eng.mesh is None) == (lanes == 1)
    return eng


def _same(want, got):
    for a, b in zip(want[:3], got[:3]):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------ knob resolution

@pytest.mark.parametrize("avail", [8, 4, 1])
@pytest.mark.parametrize("raw", [None, "1", "0", "-3", "bogus", "2", "3",
                                 "8", "64"])
def test_mesh_devices_resolution_equals_jax(monkeypatch, raw, avail):
    if raw is None:
        monkeypatch.delenv("DOS_MESH_DEVICES", raising=False)
    else:
        monkeypatch.setenv("DOS_MESH_DEVICES", raw)
    assert mesh.mesh_devices(avail=avail) == jmesh.mesh_devices(avail=avail)
    # the JAX default counts the conftest's 8 devices; the CPU's slots
    # stand for them here
    assert mesh.mesh_devices(avail=len(mesh.local_devices("cpu"))) == \
        jmesh.mesh_devices()


@pytest.mark.parametrize("raw,lanes", [(None, None), ("1", None),
                                       ("4", 4), ("8", 8)])
def test_make_worker_mesh_one_lane_is_none(monkeypatch, raw, lanes):
    if raw is None:
        monkeypatch.delenv("DOS_MESH_DEVICES", raising=False)
    else:
        monkeypatch.setenv("DOS_MESH_DEVICES", raw)
    got = mesh.make_worker_mesh(devices=mesh.local_devices("cpu"))
    want = jmesh.make_worker_mesh()
    if lanes is None:
        assert got is None and want is None
    else:
        assert got == [CPU] * lanes
        assert want.shape[jmesh.LANE_AXIS] == lanes


def test_worker_mesh_needs_its_devices():
    with pytest.raises(ValueError) as te:
        mesh.make_worker_mesh(4, devices=[CPU] * 2)
    with pytest.raises(ValueError) as je:
        jmesh.make_worker_mesh(4, devices=jmesh.jax.devices()[:2])
    assert str(te.value) == str(je.value)


# -------------------------------------------------------- walk parity

@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("diffed", [False, True], ids=["free", "diff"])
def test_walk_parity(monkeypatch, tg, dcs, shard_dir, walk_queries,
                     diff_file, jax_engine, lanes, diffed):
    """Lane counts 1/2/4/8 answer as the JAX single-device engine, free
    flow and diffed, duplicates and zero-length pairs included, with one
    walk call a lane."""
    diff = diff_file if diffed else "-"
    eng = _lane_engine(monkeypatch, lanes, tg, dcs[1], shard_dir)
    cw.cuda_walk_batch.plain = 0
    got = eng.answer(walk_queries, RuntimeConfig(), diff)
    assert cw.cuda_walk_batch.plain == lanes
    _same(jax_engine.answer(walk_queries, JConfig(), diff), got)


@pytest.mark.parametrize("lanes", LANES)
def test_paths_parity(monkeypatch, tg, dcs, shard_dir, walk_queries,
                      jax_engine, lanes):
    """``--extract`` path prefixes under lanes equal the JAX engine's."""
    eng = _lane_engine(monkeypatch, lanes, tg, dcs[1], shard_dir)
    got = eng.answer(walk_queries, RuntimeConfig(extract=True, k_moves=6))
    _same(jax_engine.answer(walk_queries, JConfig(extract=True, k_moves=6)),
          got)
    for a, b in zip(jax_engine.last_paths, eng.last_paths):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", [1, 2, 3])
def test_tiny_batch_pads_to_lanes(monkeypatch, tg, dcs, shard_dir,
                                  walk_queries, jax_engine, n):
    """A batch smaller than the lane count pads up (valid=False lanes)
    instead of leaving the lane path or crashing."""
    eng = _lane_engine(monkeypatch, 8, tg, dcs[1], shard_dir)
    cw.cuda_walk_batch.plain = 0
    got = eng.answer(walk_queries[:n], RuntimeConfig())
    assert cw.cuda_walk_batch.plain == 8
    _same(jax_engine.answer(walk_queries[:n], JConfig()), got)


def test_deadline_chunks_under_lanes(monkeypatch, toy_graph, tg, dcs,
                                     shard_dir, walk_queries):
    """The ns-budget chunked path splits each chunk over the lanes; a
    generous budget answers everything, as the JAX engine's chunks."""
    base = JEngine(toy_graph, dcs[0], 0, shard_dir)
    base.astar_chunk = 16
    eng = _lane_engine(monkeypatch, 4, tg, dcs[1], shard_dir)
    eng.time_chunk = 16
    cw.cuda_walk_batch.plain = 0
    got = eng.answer(walk_queries, RuntimeConfig(time=10**13))
    qpad = 1 << (len(np.unique(walk_queries, axis=0)) - 1).bit_length()
    assert cw.cuda_walk_batch.plain == 4 * (qpad // 16)
    _same(base.answer(walk_queries, JConfig(time=10**13)), got)


def test_walk_lanes_joins_in_lane_order(tg, dcs, shard_dir, walk_queries):
    """``walk_lanes`` on its own: one call a lane on its slice, the
    answers joined in lane order == one call over the whole batch."""
    from distributed_oracle_search_tpu_torch.ops import DeviceGraph
    from distributed_oracle_search_tpu_torch.worker.engine import (
        load_shard_rows,
    )

    dg = DeviceGraph.from_graph(tg, device="cpu")
    fm = torch.from_numpy(load_shard_rows(shard_dir, 0, device="cpu"))
    q = walk_queries[:64]
    rows = dcs[1].owned_index_of(q[:, 1]).astype(np.int32)
    s, t = q[:, 0].astype(np.int32), q[:, 1].astype(np.int32)
    valid = np.ones(64, bool)
    whole = cw.cuda_walk_batch(dg, fm, *(torch.from_numpy(a) for a in
                                         (rows, s, t)), dg.w_pad,
                               valid=torch.from_numpy(valid))
    calls = sharded.lane_walk_program(dg, fm, rows, s, t, valid, dg.w_pad,
                                      [CPU] * 4)
    assert [len(c[1][2]) for c in calls] == [16] * 4
    assert all(c[1][1] is fm for c in calls)      # one copy, shared
    for a, b in zip(whole, sharded.walk_lanes(dg, fm, rows, s, t, valid,
                                              dg.w_pad, [CPU] * 4)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="does not divide"):
        sharded.walk_lanes(dg, fm, rows[:6], s[:6], t[:6], valid[:6],
                           dg.w_pad, [CPU] * 4)


# -------------------------------------------------------- build parity

def _digests(d):
    return {os.path.basename(p): hashlib.md5(open(p, "rb").read()).hexdigest()
            for p in glob.glob(os.path.join(d, "*.npy"))}


@pytest.fixture
def lane_calls(monkeypatch):
    calls = []
    real = cpd.build_fm_lanes

    def counting(*a, **k):
        calls.append(len(a[2]))
        return real(*a, **k)
    monkeypatch.setattr(cpd, "build_fm_lanes", counting)
    return calls


@pytest.mark.parametrize("lanes", (2, 4, 8))
def test_build_parity(monkeypatch, tg, dcs, shard_dir, tmp_path, lanes,
                      lane_calls):
    """Lane-parallel build chunks write block files byte-equal to the
    JAX package's single-device build."""
    monkeypatch.setenv("DOS_MESH_DEVICES", str(lanes))
    d = str(tmp_path / f"lanes{lanes}")
    build_worker_shard(tg, dcs[1], 0, d, chunk=16, device="cpu")
    assert lane_calls and set(lane_calls) == {lanes}
    assert _digests(d) == _digests(shard_dir)


@pytest.mark.parametrize("lanes", (2, 4, 8))
def test_build_fm_lanes_block_bytes(toy_graph, tg, lanes):
    """One chunk by ``build_fm_lanes``: its real rows equal the JAX
    package's first-move rows, and the whole block (pad rows too) the
    single-device chunk's, byte for byte; a short ``out`` skips the
    lanes that hold only pad targets."""
    from distributed_oracle_search_tpu.models.reference import (
        first_move_matrix,
    )
    from distributed_oracle_search_tpu_torch.ops import DeviceGraph

    pad = np.full(16, -1, np.int32)
    pad[:11] = np.arange(3, 14)
    dg = DeviceGraph.from_graph(tg, device="cpu")
    kind, st = cpd.pick_build_kernel(tg, "auto")
    whole = sharded.chunk_compute(dg, (kind, st))(torch.from_numpy(pad))
    got = sharded.build_fm_lanes(dg, pad, [CPU] * lanes, kind, st)
    assert torch.equal(got, whole)
    np.testing.assert_array_equal(
        got[:11].numpy(), first_move_matrix(toy_graph, np.arange(3, 14)))
    out = torch.full((11, tg.n), 7, dtype=torch.int8)
    sharded.build_fm_lanes(dg, pad, [CPU] * lanes, kind, st, out=out)
    assert torch.equal(out, whole[:11])


def test_build_indivisible_chunk_falls_back(monkeypatch, toy_graph, tg,
                                            dcs, tmp_path, lane_calls,
                                            caplog):
    """A chunk the lane count does not divide builds on one device, with
    JAX's warning — the same bytes as JAX's build at that chunk."""
    monkeypatch.setenv("DOS_MESH_DEVICES", "8")
    d = str(tmp_path / "odd")
    build_worker_shard(tg, dcs[1], 0, d, chunk=12, device="cpu")
    assert not lane_calls
    assert "does not divide over 8 mesh lane(s)" in caplog.text
    d_ref = str(tmp_path / "odd-ref")
    monkeypatch.delenv("DOS_MESH_DEVICES")
    j_build_worker_shard(toy_graph, dcs[0], 0, d_ref, chunk=12)
    assert _digests(d) == _digests(d_ref)


def test_build_ctx_reuse(monkeypatch, tg, dcs, shard_dir, tmp_path,
                         lane_calls):
    """The shared compute ctx keeps the DeviceGraph, the kind and the
    lane list across builds; a second build through it writes the same
    blocks."""
    monkeypatch.setenv("DOS_MESH_DEVICES", "4")
    ctx = {}
    d1, d2 = str(tmp_path / "c1"), str(tmp_path / "c2")
    build_worker_shard(tg, dcs[1], 0, d1, chunk=16, device="cpu", ctx=ctx)
    dg_first, compute = ctx["dg"], ctx["compute"]
    assert ctx["mesh"] == [CPU] * 4
    build_worker_shard(tg, dcs[1], 0, d2, chunk=16, device="cpu", ctx=ctx)
    assert ctx["dg"] is dg_first and ctx["compute"] is compute
    assert _digests(d1) == _digests(d2) == _digests(shard_dir)


# ------------------------------------------------------- replica lanes

@pytest.mark.parametrize("rank", [1, 2, 3])
def test_replica_lane_pinning(monkeypatch, tg, dcs, shard_dir, walk_queries,
                              jax_engine, rank):
    """Replica rank r pins to lane r % L and does not split; its answers
    are unchanged (it falls back to the primary block set on a shared
    filesystem)."""
    lanes = [torch.device("cpu")] * 4
    eng = ShardEngine(tg, dcs[1], 0, shard_dir, device="cpu",
                      replica=rank, mesh=lanes)
    assert not eng._lane_split
    assert eng.device == lanes[rank % 4] and eng.fm.device == eng.device
    cw.cuda_walk_batch.plain = 0
    got = eng.answer(walk_queries, RuntimeConfig())
    assert cw.cuda_walk_batch.plain == 1
    _same(jax_engine.answer(walk_queries, JConfig()), got)


def test_compressed_lanes_walk_raw(monkeypatch, tg, dcs, shard_dir,
                                   walk_queries, jax_engine):
    """A pack4-resident shard under lanes inflates the batch's distinct
    rows and walks them raw over the lanes (the pack4 walk does not run
    under lanes); the answers are unchanged."""
    monkeypatch.setenv("DOS_CPD_RESIDENT", "pack4")
    eng = _lane_engine(monkeypatch, 4, tg, dcs[1], shard_dir)
    assert eng.resident_codec == "pack4"
    cw.cuda_walk_batch.plain = cw.cuda_walk_batch.launches_pack4 = 0
    packed = []
    real = sharded.cuda_walk_batch
    monkeypatch.setattr(sharded, "cuda_walk_batch", lambda *a, **k: (
        packed.append(k.get("packed4", False)) or real(*a, **k)))
    got = eng.answer(walk_queries, RuntimeConfig())
    assert packed == [False] * 4
    _same(jax_engine.answer(walk_queries, JConfig()), got)


# -------------------------------------------------------- oracle grids

@pytest.fixture(scope="module")
def campaign(tg, diff_file):
    w = tg.weights_with_diff(read_diff(diff_file))
    rng = np.random.default_rng(21)
    q = np.concatenate([rng.integers(0, tg.n, size=(120, 2)),
                        [[4, 4], [2, 9], [2, 9]]]).astype(np.int64)
    return w, q


def _controllers(n, workers):
    return (JDC("tpu", None, workers, n),
            DistributionController("tpu", None, workers, n))


def _split_in_two(o):
    """Force ``o``'s one part into two (as on two cards): the first and
    the second half of its workers, each with its cells."""
    (p,) = o.parts
    halves = np.array_split(p.workers, 2)
    o.parts = [sharded.GridPart(p.device, h, p.cells[np.isin(p.cells[:, 1],
                                                             h)])
               for h in halves]
    assert not o.single
    return o


@pytest.mark.parametrize("split", [False, True], ids=["one", "split"])
@pytest.mark.parametrize("shape", [(1, 8), (2, 4)], ids=["1x8", "2x4"])
def test_oracle_on_grids_equals_jax(toy_graph, tg, campaign, shape, split):
    """The oracle over a ``[1, 8]`` and a ``[2, 4]`` (data x worker)
    grid answers as JAX's ``CPDOracle`` on
    the 8-device mesh: walk, diff, paths, fused multi-diff, mat, stored
    distances and doubling tables; the table is JAX's. A grid naming one
    device keeps one table and one walk a round; split in two parts it
    walks once a part and joins on the host."""
    w, q = campaign
    n_data, n_workers = shape
    jdc, tdc = _controllers(tg.n, n_workers)
    jm = jmesh.make_mesh(n_workers=n_workers, n_data=n_data)
    jo = JOracle(toy_graph, jdc, mesh=jm).build(chunk=16, store_dists=True)
    grid = mesh.make_mesh(n_workers=n_workers, n_data=n_data,
                          devices=[CPU] * 8)
    to = CPDOracle(tg, tdc, mesh=grid)
    assert to.n_data == n_data and to.single
    if split:
        _split_in_two(to)
    to.build(chunk=16, store_dists=True)
    fms = to.fm if split else (to.fm,)
    np.testing.assert_array_equal(torch.cat(list(fms)).numpy(),
                                  np.asarray(jo.fm))
    cw.cuda_walk_batch.plain = 0
    _same(jo.query(q), to.query(q))
    assert cw.cuda_walk_batch.plain == len(to.parts)
    _same(jo.query(q, w_query=w), to.query(q, w_query=w))
    _same(jo.query(q, k_moves=3), to.query(q, k_moves=3))
    for a, b in zip(jo.query_paths(q, k=5), to.query_paths(q, k=5)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jo.query_multi(q, [None, w]),
                    to.query_multi(q, [None, w])):
        np.testing.assert_array_equal(a, b)
    tgts = np.concatenate([np.arange(0, tg.n, 3), [7, 7, tg.n + 2, -1]])
    for a, b in zip(jo.query_mat(5, tgts, w_query=w),
                    to.query_mat(5, tgts, w_query=w)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jo.query_dist(q), to.query_dist(q)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jo.query_table(jo.prepare_weights(w), q),
                    to.query_table(to.prepare_weights(w, chunk=4), q)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jo.query_table_multi(jo.prepare_weights_multi(
                        [None, w]), q),
                    to.query_table_multi(to.prepare_weights_multi(
                        [None, w], chunk=4), q)):
        np.testing.assert_array_equal(a, b)


def test_split_grid_save_load(tg, campaign, tmp_path):
    """A split grid saves the index a one-table oracle saves, and loads
    it back into its parts."""
    _w, q = campaign
    tdc = _controllers(tg.n, 8)[1]
    one = CPDOracle(tg, tdc, device="cpu").build(chunk=16)
    one.save(str(tmp_path / "a"))
    two = _split_in_two(CPDOracle(tg, tdc, device="cpu")).build(chunk=16)
    two.save(str(tmp_path / "b"))
    assert _digests(str(tmp_path / "a")) == _digests(str(tmp_path / "b"))
    back = _split_in_two(CPDOracle(tg, tdc, device="cpu")).load(
        str(tmp_path / "a"))
    np.testing.assert_array_equal(torch.cat(list(back.fm)).numpy(),
                                  one.fm.numpy())
    _same(one.query(q), back.query(q))


def test_oracle_refuses_a_worker_axis_not_maxworker(tg):
    tdc = _controllers(tg.n, 8)[1]
    with pytest.raises(ValueError, match="mesh worker axis 4 != maxworker 8"):
        CPDOracle(tg, tdc, mesh=mesh.make_mesh(4, 2, devices=[CPU] * 8))


# ------------------------------------------------------ conf validation

@pytest.mark.parametrize("shape,axes", [
    ([2, 4], ["data", "worker"]),
    ([4, 2], ["worker", "data"]),
    ([8], None),
    ([1, 8], None),
    ([2, 4], ["data"]),
    ([2, 4], ["data", "bogus"]),
    ([4], ["worker"]),
    ([2, 2], None),
    ([8], ["data"]),
])
def test_mesh_from_config_equals_jax(shape, axes):
    """``mesh_from_config`` accepts and refuses the confs JAX's does,
    with the same messages, and lays the grid out as JAX's."""
    kw = dict(workers=[f"tpu:{i}" for i in range(8)], partmethod="tpu",
              partkey=8, mesh_shape=shape, mesh_axes=axes)
    try:
        jm = jmesh.mesh_from_config(JConf(**kw))
    except ValueError as e:
        with pytest.raises(ValueError) as te:
            mesh.mesh_from_config(ClusterConfig(**kw),
                                  devices=[CPU] * 8)
        assert str(te.value) == str(e)
        return
    got = mesh.mesh_from_config(ClusterConfig(**kw), devices=[CPU] * 8)
    assert got.shape == (jm.shape[jmesh.DATA_AXIS],
                         jm.shape[jmesh.WORKER_AXIS])


def test_make_mesh_too_few_devices_equals_jax():
    with pytest.raises(ValueError) as te:
        mesh.make_mesh(n_workers=8, n_data=2, devices=[CPU] * 8)
    with pytest.raises(ValueError) as je:
        jmesh.make_mesh(n_workers=8, n_data=2)
    assert str(te.value) == str(je.value)


def test_device_pool_deals_contiguous_blocks():
    assert mesh.device_pool(5, "cpu") == [CPU] * 5
    assert mesh.distinct([[CPU, CPU], [CPU, CPU]]) == [CPU]
