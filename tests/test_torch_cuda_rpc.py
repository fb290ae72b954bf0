"""PyTorch port, the RPC lane on the card: a ``worker.server`` engine on
``cuda`` behind an ``RpcServeLoop`` answers one RPC batch (with results
and path prefixes) exactly as the plain walk on the CPU does, through one
raw walk launch (B1) and no plain walk; and the engine's ``obs.device``
entry for that program is filled from CUDA events (``timer:
"cuda-events"``) with the closed-form cost of the launch.

Needs an NVIDIA GPU and ``nvcc``; skips without them. This file imports
the port only (no JAX), so it runs on a machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_rpc.py
"""

import json
import os
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)

from distributed_oracle_search_tpu_torch.data import (  # noqa: E402
    Graph, synth_road_network, synth_scenario, write_scen, write_xy,
)
from distributed_oracle_search_tpu_torch.models.cpd import (  # noqa: E402
    build_worker_shard, write_index_manifest,
)
from distributed_oracle_search_tpu_torch.obs import device as obs_device  # noqa: E402
from distributed_oracle_search_tpu_torch.ops import cuda_walk as cw  # noqa: E402
from distributed_oracle_search_tpu_torch.parallel import (  # noqa: E402
    DistributionController,
)
from distributed_oracle_search_tpu_torch.transport import rpc  # noqa: E402
from distributed_oracle_search_tpu_torch.transport.wire import (  # noqa: E402
    RuntimeConfig, StatsRow,
)
from distributed_oracle_search_tpu_torch.utils.config import (  # noqa: E402
    ClusterConfig,
)
from distributed_oracle_search_tpu_torch.worker import server as wserver  # noqa: E402
from distributed_oracle_search_tpu_torch.worker.engine import (  # noqa: E402
    ShardEngine,
)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module", autouse=True)
def _card():
    """Skip the whole module without a card, before the module-scoped
    ``cluster`` builds anything."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    """A 3,000-node road network, ``mod`` over 2 workers, built on the
    CPU; the conf and 400 queries."""
    d = tmp_path_factory.mktemp("cuda-rpc")
    g = synth_road_network(3000, seed=5)
    xy = str(d / "g.xy")
    write_xy(xy, g.xs, g.ys, g.src, g.dst, g.w)
    g = Graph.from_xy(xy)
    dc = DistributionController("mod", 2, 2, g.n)
    outdir = str(d / "index")
    for wid in range(2):
        build_worker_shard(g, dc, wid, outdir, chunk=512, device="cpu")
    write_index_manifest(outdir, dc)
    q = synth_scenario(g.n, 400, seed=6)
    scen = str(d / "g.scen")
    write_scen(scen, q)
    conf = str(d / "conf.json")
    with open(conf, "w") as f:
        json.dump({"workers": ["localhost"] * 2, "partmethod": "mod",
                   "partkey": 2, "outdir": outdir, "xy_file": xy,
                   "scenfile": scen, "diffs": ["-"], "nfs": str(d)}, f)
    return conf, g, dc, q


def test_rpc_batch_on_card_equals_plain_walk(cluster, tmp_path):
    conf, g, dc, q = cluster
    mine = np.ascontiguousarray(q[dc.worker_of(q[:, 1]) == 0], np.int64)
    server = wserver.FifoServer(ClusterConfig.load(conf), 0,
                                command_fifo=str(tmp_path / "w0.fifo"),
                                device="cuda")
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    for _ in range(200):
        if os.path.exists(server.command_fifo):
            break
        time.sleep(0.02)
    loop = wserver.RpcServeLoop(server,
                                socket_path=str(tmp_path / "w0.sock")).start()
    obs_device.reset()
    l0, p0 = cw.cuda_walk_batch.launches, cw.cuda_walk_batch.plain
    client = rpc.RpcClient(("unix", str(tmp_path / "w0.sock"), None),
                           timeout_s=120.0)
    try:
        fr = client.call({"kind": "req", "config": {
            "results": True, "k_moves": 6, "extract": True}, "diff": "-"},
            [mine])
    finally:
        client.close()
        wserver.stop_server(server.command_fifo)
        th.join(timeout=30)
        loop.stop()
    # the batch's launch, and the obs.device capture's timed one
    assert cw.cuda_walk_batch.launches - l0 == 2
    assert cw.cuda_walk_batch.plain - p0 == 0
    row = StatsRow.decode(fr.header["stats"])
    cost, plen, fin, nodes, moves = (np.array(a) for a in fr.arrays)
    ref = ShardEngine(g, dc, 0, ClusterConfig.load(conf).outdir,
                      device="cpu")
    rc, rp, rf, rstats = ref.answer(mine, RuntimeConfig(k_moves=6,
                                                        extract=True), "-")
    np.testing.assert_array_equal(cost, rc)
    np.testing.assert_array_equal(plen, rp)
    np.testing.assert_array_equal(fin.astype(bool), rf)
    np.testing.assert_array_equal(nodes, ref.last_paths[0])
    np.testing.assert_array_equal(moves, ref.last_paths[1])
    assert (row.plen, row.finished) == (rstats.plen, rstats.finished)
    snap = obs_device.snapshot()
    keys = [k for k in snap if k.startswith("table-search[cuda]/")]
    assert len(keys) == 1, snap
    entry = snap[keys[0]]
    assert entry["timer"] == "cuda-events" and entry["kernel_ms"] > 0
    assert entry["device"].startswith("cuda")
    qn = int(keys[0].split("/q")[1].split("/")[0])
    want = cw.walk_launch_cost(qn, g.n, g.max_out_degree,
                               int(server.engine.fm.nbytes), k_moves=6)
    assert {k: entry[k] for k in want} == want
