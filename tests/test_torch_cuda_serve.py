"""PyTorch port, the serving stack on the card: a ``ServingFrontend`` over
``EngineDispatcher(device="cuda")`` answers as the CPU engines do (the
walk by B1), ``sig_k`` signatures from the card equal the CPU's with the
answers unchanged, a ``FifoServer`` on ``cuda`` gives the same answers
with its L2 (``DOS_GATEWAY_L2_BYTES``) on and off — the repeat from the
L2 without a launch — and the walk's launch count is exact when eight
threads launch at once.

Needs an NVIDIA GPU and ``nvcc``; skips without them. This file imports
the port only (no JAX), so it runs on a machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_serve.py
"""

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
from distributed_oracle_search_tpu_torch.ops import cuda_walk as cw  # noqa: E402
from distributed_oracle_search_tpu_torch.parallel import (  # noqa: E402
    DistributionController,
)
from distributed_oracle_search_tpu_torch.serving import (  # noqa: E402
    EngineDispatcher, ServeConfig, ServingFrontend,
)
from distributed_oracle_search_tpu_torch.transport.wire import (  # noqa: E402
    Request, RuntimeConfig, read_results_file, results_file_for,
    write_query_file,
)
from distributed_oracle_search_tpu_torch.utils.config import (  # noqa: E402
    ClusterConfig,
)
from distributed_oracle_search_tpu_torch.worker.server import (  # noqa: E402
    FifoServer,
)

pytestmark = pytest.mark.cuda

W = 2


@pytest.fixture(scope="module", autouse=True)
def _card():
    """Skip the whole module without a card, before the module-scoped
    ``world`` builds anything."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A 2,000-node road network, ``mod`` over 2 workers, built on the
    CPU; its conf and 600 queries."""
    d = tmp_path_factory.mktemp("cuda-serve")
    g = synth_road_network(2000, seed=5)
    xy = str(d / "road.xy")
    write_xy(xy, g.xs, g.ys, g.src, g.dst, g.w)
    g = Graph.from_xy(xy)
    scen = str(d / "road.scen")
    queries = synth_scenario(g.n, 600, seed=6)
    write_scen(scen, queries)
    outdir = str(d / "index")
    dc = DistributionController("mod", W, W, g.n)
    for wid in range(W):
        build_worker_shard(g, dc, wid, outdir, device="cpu")
    write_index_manifest(outdir, dc)
    conf = ClusterConfig(workers=["localhost"] * W, partmethod="mod",
                         partkey=W, outdir=outdir, xy_file=xy,
                         scenfile=scen, diffs=["-"],
                         nfs=str(d)).validate()
    return conf, g, dc, queries


def _frontend_answers(conf, g, dc, queries, device):
    disp = EngineDispatcher(conf, graph=g, dc=dc, device=device)
    fe = ServingFrontend(dc, disp, sconf=ServeConfig(
        max_batch=64, max_wait_ms=2.0, queue_depth=1024, cache_bytes=0))
    fe.start()
    try:
        res = [f.result(60) for f in
               [fe.submit(int(s), int(t)) for s, t in queries]]
    finally:
        fe.stop()
    return [(r.status, r.cost, r.plen, r.finished) for r in res]


def test_frontend_on_cuda_equals_cpu(world):
    conf, g, dc, queries = world
    before = (cw.cuda_walk_batch.launches, cw.cuda_walk_batch.plain)
    card = _frontend_answers(conf, g, dc, queries, "cuda")
    launched = cw.cuda_walk_batch.launches - before[0]
    plain_on_card = cw.cuda_walk_batch.plain - before[1]
    cpu = _frontend_answers(conf, g, dc, queries, "cpu")
    assert card == cpu and all(r[0] == "OK" for r in card)
    assert launched > 0 and plain_on_card == 0


def test_sig_k_on_cuda_equals_cpu(world):
    conf, g, dc, queries = world
    mine = queries[dc.worker_of(queries[:, 1]) == 0][:100]
    out = {}
    for dev in ("cuda", "cpu"):
        eng = EngineDispatcher(conf, graph=g, dc=dc,
                               device=dev)._engine_for(0)
        plain = eng.answer(mine, RuntimeConfig())[:3]
        signed = eng.answer(mine, RuntimeConfig(sig_k=32))[:3]
        for a, b in zip(plain, signed):
            np.testing.assert_array_equal(a, b)
        out[dev] = (signed, eng.last_paths)
    for a, b in zip(out["cuda"][0], out["cpu"][0]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        np.testing.assert_array_equal(a, b)
    assert out["cuda"][1][0].shape == (len(mine), 33)


def _serve_twice(conf, queries, tmp_path, tag):
    fifo = str(tmp_path / f"{tag}.fifo")
    server = FifoServer(conf, 1, command_fifo=fifo, device="cuda")
    mine = queries[server.dc.worker_of(queries[:, 1]) == 1][:64]
    out = []
    for i in range(2):
        qfile = str(tmp_path / f"query.{tag}.{i}")
        write_query_file(qfile, mine)
        n0 = cw.cuda_walk_batch.launches
        row = server._handle(Request(RuntimeConfig(results=True), qfile,
                                     str(tmp_path / "ans"), "-"))
        res = read_results_file(results_file_for(qfile))
        out.append((row.ok, [a.tolist() for a in res],
                    cw.cuda_walk_batch.launches - n0))
    return out


def test_fifo_server_l2_on_and_off(world, tmp_path, monkeypatch):
    conf, g, dc, queries = world
    monkeypatch.delenv("DOS_GATEWAY_L2_BYTES", raising=False)
    off = _serve_twice(conf, queries, tmp_path, "off")
    monkeypatch.setenv("DOS_GATEWAY_L2_BYTES", str(1 << 20))
    on = _serve_twice(conf, queries, tmp_path, "on")
    assert [o[:2] for o in on] == [o[:2] for o in off]
    assert all(o[2] >= 1 for o in off) and on[0][2] >= 1
    assert on[1][2] == 0          # the repeat came from the L2


def test_launch_counts_exact_under_threads(world):
    conf, g, dc, queries = world
    eng = EngineDispatcher(conf, graph=g, dc=dc,
                           device="cuda")._engine_for(0)
    dev = torch.device("cuda")
    q = 256
    rng = np.random.default_rng(1)
    rows = torch.as_tensor(rng.integers(0, eng.fm.shape[0], q),
                           dtype=torch.int32, device=dev)
    s = torch.as_tensor(rng.integers(0, g.n, q), dtype=torch.int32,
                        device=dev)
    t = torch.as_tensor(dc.owned(0)[rng.integers(0, dc.n_owned(0), q)],
                        dtype=torch.int32, device=dev)
    threads, n = 8, 50
    barrier = threading.Barrier(threads)
    errors = []

    def body():
        barrier.wait()
        try:
            for _ in range(n):
                cw.cuda_walk_batch(eng.dg, eng.fm, rows, s, t, eng.dg.w_pad)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)
    before = (cw.cuda_walk_batch.launches, cw.cuda_walk_batch.plain)
    ts = [threading.Thread(target=body) for _ in range(threads)]
    t0 = time.monotonic()
    for th in ts:
        th.start()
    for th in ts:
        th.join(timeout=300)
    torch.cuda.synchronize()
    assert not errors, errors
    assert time.monotonic() - t0 < 300
    assert cw.cuda_walk_batch.launches - before[0] == threads * n
    assert cw.cuda_walk_batch.plain == before[1]
