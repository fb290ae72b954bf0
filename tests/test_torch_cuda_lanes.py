"""PyTorch port, worker lanes and the campaign grid on the card: a lane
engine over ``[cuda:0] * L`` answers as the one-lane engine and as the
CPU engine, with one ``table_search_walk`` launch a lane and no plain
walk; lanes share one copy of the table; a replica pins to lane
``r % L``; ``build_fm_lanes`` on the card writes the single-device
chunk's bytes; the oracle over a grid and over a grid split in two
parts answers as one table does.

Needs an NVIDIA GPU and ``nvcc``; the whole module skips without a card
before any fixture builds anything. Imports the port only (no JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_lanes.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)

from distributed_oracle_search_tpu_torch.data import (  # noqa: E402
    synth_diff, synth_road_network, synth_scenario, write_diff,
)
from distributed_oracle_search_tpu_torch.models import cpd  # noqa: E402
from distributed_oracle_search_tpu_torch.models.cpd import (  # noqa: E402
    CPDOracle, build_worker_shard,
)
from distributed_oracle_search_tpu_torch.ops import DeviceGraph  # noqa: E402
from distributed_oracle_search_tpu_torch.obs import device as obs_device  # noqa: E402
from distributed_oracle_search_tpu_torch.ops import cuda_walk as cw  # noqa: E402
from distributed_oracle_search_tpu_torch.parallel import (  # noqa: E402
    DistributionController, mesh, sharded,
)
from distributed_oracle_search_tpu_torch.transport import RuntimeConfig  # noqa: E402
from distributed_oracle_search_tpu_torch.worker.engine import (  # noqa: E402
    ShardEngine,
)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module", autouse=True)
def _card():
    """Skip the whole module without a card, before the module-scoped
    fixtures build anything."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


@pytest.fixture(scope="module")
def shard(tmp_path_factory):
    """A 3,000-node road network, ``mod`` over 3 workers; worker 0's
    shard built on the CPU; 2,000 queries to its targets and a diff."""
    d = tmp_path_factory.mktemp("cuda-lanes")
    g = synth_road_network(3000, seed=3)
    dc = DistributionController("mod", 3, 3, g.n, block_size=256)
    build_worker_shard(g, dc, 0, str(d), chunk=256, device="cpu")
    rng = np.random.default_rng(4)
    q = np.stack([rng.integers(0, g.n, 2000),
                  dc.owned(0)[rng.integers(0, dc.n_owned(0), 2000)]],
                 axis=1).astype(np.int64)
    diff = str(d / "c.diff")
    write_diff(diff, *synth_diff(g, frac=0.2, seed=5))
    return g, dc, str(d), q, diff


def _zero():
    cw.cuda_walk_batch.launches = cw.cuda_walk_batch.plain = 0


ROUNDS = [("free", RuntimeConfig(), False),
          ("diff", RuntimeConfig(), True),
          ("k8", RuntimeConfig(k_moves=8, extract=True), False),
          ("budget", RuntimeConfig(time=10**13), False)]


@pytest.mark.parametrize("lanes", [2, 4, 8])
@pytest.mark.parametrize("name,cfg,diffed", ROUNDS,
                         ids=[r[0] for r in ROUNDS])
def test_lane_engine_equals_one_lane_and_cpu(shard, lanes, name, cfg,
                                             diffed):
    g, dc, d, q, diff = shard
    f = diff if diffed else "-"
    cpu = ShardEngine(g, dc, 0, d, device="cpu")
    one = ShardEngine(g, dc, 0, d, device="cuda")
    lane = ShardEngine(g, dc, 0, d, mesh=[torch.device("cuda:0")] * lanes)
    one.time_chunk = lane.time_chunk = cpu.time_chunk = 512
    want = cpu.answer(q, cfg, f)
    # each engine's first batch records its key's obs.device entry: one
    # more call, over the lanes for the lane engine
    obs_device.reset()
    _zero()
    got1 = one.answer(q, cfg, f)
    calls1 = cw.cuda_walk_batch.launches
    _zero()
    got = lane.answer(q, cfg, f)
    assert cw.cuda_walk_batch.plain == 0
    assert cw.cuda_walk_batch.launches == lanes * calls1
    for a, b, c in zip(want[:3], got1[:3], got[:3]):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    if cfg.extract:
        for a, b in zip(cpu.last_paths, lane.last_paths):
            np.testing.assert_array_equal(a, b)


def test_lanes_share_one_table(shard):
    g, dc, d, q, _diff = shard
    lanes = [torch.device("cuda:0")] * 4
    eng = ShardEngine(g, dc, 0, d, mesh=lanes)
    w_pad, pair = eng._weights_for("-", False)
    placed = eng._placed(eng.fm, w_pad, pair)
    assert list(placed) == [torch.device("cuda:0")]
    assert placed[torch.device("cuda:0")][1] is eng.fm
    assert not eng._lane_copies


@pytest.mark.parametrize("rank", [1, 2, 3])
def test_replica_pins_to_its_lane(shard, rank):
    g, dc, d, q, _diff = shard
    lanes = [torch.device("cuda:0")] * 4
    eng = ShardEngine(g, dc, 0, d, mesh=lanes, replica=rank)
    assert eng.fm.device == lanes[rank % 4] and not eng._lane_split
    obs_device.reset()
    _zero()
    got = eng.answer(q, RuntimeConfig())
    assert cw.cuda_walk_batch.launches == 1 + 1       # + the capture's
    want = ShardEngine(g, dc, 0, d, device="cpu").answer(q, RuntimeConfig())
    for a, b in zip(want[:3], got[:3]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("lanes", [2, 4])
def test_build_fm_lanes_on_the_card(shard, lanes):
    g, dc, _d, _q, _diff = shard
    dg = DeviceGraph.from_graph(g, device="cuda")
    kind, st = cpd.pick_build_kernel(g, "auto")
    pad = np.full(256, -1, np.int32)
    pad[:200] = dc.owned(0)[:200]
    whole = sharded.chunk_compute(dg, (kind, st))(
        torch.from_numpy(pad).cuda())
    got = sharded.build_fm_lanes(dg, pad, [torch.device("cuda:0")] * lanes,
                                 kind, st)
    assert torch.equal(got, whole)
    cpu = sharded.chunk_compute(DeviceGraph.from_graph(g, device="cpu"),
                                (kind, st))(torch.from_numpy(pad))
    assert torch.equal(got.cpu(), cpu)


@pytest.mark.parametrize("split", [False, True], ids=["one", "split"])
def test_oracle_grid_on_the_card(shard, split):
    g, _dc, _d, _q, _diff = shard
    dc = DistributionController("tpu", None, 4, g.n)
    q = synth_scenario(g.n, 3000, seed=6)
    w = g.weights_with_diff(synth_diff(g, frac=0.2, seed=7))
    ref = CPDOracle(g, dc, device="cpu").build(chunk=256)
    grid = mesh.make_mesh(n_workers=4, n_data=2,
                          devices=[torch.device("cuda:0")] * 8)
    o = CPDOracle(g, dc, mesh=grid)
    if split:
        (p,) = o.parts
        halves = np.array_split(p.workers, 2)
        o.parts = [sharded.GridPart(
            p.device, h, p.cells[np.isin(p.cells[:, 1], h)]) for h in halves]
    o.build(chunk=256)
    want = ref.query(q, w_query=w)
    _zero()
    got = o.query(q, w_query=w)
    assert cw.cuda_walk_batch.launches == len(o.parts)
    assert cw.cuda_walk_batch.plain == 0
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(ref.query_multi(q, [None, w]), o.query_multi(q, [None, w])):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(ref.query_paths(q, k=6), o.query_paths(q, k=6)):
        np.testing.assert_array_equal(a, b)
