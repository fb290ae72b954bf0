"""PyTorch port, the integrity plane on the card: the resident scrubber
reads a CUDA table (raw, pack4, rle) in bounded row chunks, its peak
device memory under two tables; a re-bind while eight threads walk the
same engine gives each batch the old table's answers or the new one's,
never a mix, with every B1 launch counted; and an audit thread beside
the batchers books B1 = batches + audited batches + program keys.

Needs an NVIDIA GPU and ``nvcc``; skips without them. This file imports
the port only (no JAX), so it runs on a machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_planes.py
"""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)

from distributed_oracle_search_tpu_torch.data import (  # noqa: E402
    Graph, synth_city_graph, synth_scenario, write_scen, write_xy,
)
from distributed_oracle_search_tpu_torch.integrity import (  # noqa: E402
    audit as audit_mod, scrub as scrub_mod,
)
from distributed_oracle_search_tpu_torch.models import (  # noqa: E402
    resident,
)
from distributed_oracle_search_tpu_torch.models.cpd import (  # noqa: E402
    build_worker_shard, write_index_manifest,
)
from distributed_oracle_search_tpu_torch.obs import device as obs_device  # noqa: E402
from distributed_oracle_search_tpu_torch.obs import metrics as obs_metrics  # noqa: E402
from distributed_oracle_search_tpu_torch.ops import cuda_walk as cw  # noqa: E402
from distributed_oracle_search_tpu_torch.parallel import (  # noqa: E402
    DistributionController,
)
from distributed_oracle_search_tpu_torch.serving import (  # noqa: E402
    EngineDispatcher, ServeConfig, ServingFrontend,
)
from distributed_oracle_search_tpu_torch.transport.wire import (  # noqa: E402
    RuntimeConfig,
)
from distributed_oracle_search_tpu_torch.utils.config import (  # noqa: E402
    ClusterConfig,
)
from distributed_oracle_search_tpu_torch.worker.engine import (  # noqa: E402
    ShardEngine,
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
    """A 48 x 32 city grid (pack4 and rle both viable on its shards),
    ``tpu`` over 2 workers in blocks of 256 rows, built on the CPU; its
    conf and 600 queries."""
    d = tmp_path_factory.mktemp("cuda-planes")
    g = synth_city_graph(48, 32, seed=5)
    xy = str(d / "city.xy")
    write_xy(xy, g.xs, g.ys, g.src, g.dst, g.w)
    g = Graph.from_xy(xy)
    scen = str(d / "city.scen")
    queries = synth_scenario(g.n, 600, seed=6)
    write_scen(scen, queries)
    outdir = str(d / "index")
    dc = DistributionController("tpu", W, W, g.n, block_size=256)
    for wid in range(W):
        build_worker_shard(g, dc, wid, outdir, device="cpu")
    write_index_manifest(outdir, dc)
    conf = ClusterConfig(workers=["localhost"] * W, partmethod="tpu",
                         partkey=W, outdir=outdir, xy_file=xy,
                         scenfile=scen, diffs=["-"],
                         nfs=str(d)).validate()
    return conf, g, dc, queries


def _rot(eng, rows_to_flip):
    """Publish a copy of the resident table with ``rows_to_flip``
    flipped (what in-memory rot does); returns the clean rows."""
    n = eng.fm.shape[0]
    dense = (eng.fm if isinstance(eng.fm, torch.Tensor)
             else eng.fm.decompress_rows(torch.arange(
                 n, device=eng.device)))
    clean = dense.cpu().numpy().copy()
    bad = clean.copy()
    for r in rows_to_flip:
        bad[r, :] = np.where(bad[r, :] <= 0, 1, 0)
    eng.fm = eng._make_resident(bad)
    return clean


@pytest.mark.parametrize("codec", ["raw", "pack4", "rle"])
def test_scrub_cuda_table_in_bounded_chunks(world, codec, monkeypatch):
    conf, g, dc, _ = world
    monkeypatch.setenv("DOS_CPD_RESIDENT", codec)
    # small decode chunks: the 768-row shard goes to the host in many
    monkeypatch.setattr(resident, "DECODE_CELLS", 1 << 15)
    eng = ShardEngine(g, dc, 0, conf.outdir, device="cuda")
    assert eng.resident_codec == codec
    dense_bytes = eng.fm.shape[0] * eng.fm.shape[1]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    report, _ = scrub_mod.scrub_engine_table(eng, conf.outdir, eng.fm,
                                             None)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    assert report["checked"] == 3 and not report["corrupt"]
    assert peak < dense_bytes, (peak, dense_bytes)
    _rot(eng, [0, 300])
    report, _ = scrub_mod.scrub_engine_table(eng, conf.outdir, eng.fm,
                                             None)
    assert report["corrupt"] == ["cpd-w00000-b00000.npy",
                                 "cpd-w00000-b00001.npy"]
    assert report["rebound"] and eng.resident_codec == codec
    report, _ = scrub_mod.scrub_engine_table(eng, conf.outdir, eng.fm,
                                             None)
    assert not report["corrupt"]


def _answer_vec(eng, q):
    c, p, f, _ = eng.answer(q, RuntimeConfig())
    return np.concatenate([np.asarray(c, np.int64), np.asarray(p, np.int64),
                           np.asarray(f, np.int64)])


def test_rebind_under_concurrent_walks(world):
    """Eight threads walk one engine while the scrubber re-binds its
    rotted table: each batch answers wholly as the old table or wholly
    as the new one, and the B1 count equals the batches walked."""
    conf, g, dc, queries = world
    eng = ShardEngine(g, dc, 0, conf.outdir, device="cuda")
    owned = dc.owned(0)
    rng = np.random.default_rng(3)
    # sources in the rotted rows' region and elsewhere, targets owned
    q = np.stack([rng.integers(0, g.n, 256),
                  owned[rng.integers(0, len(owned), 256)]], 1)
    q[:64, 1] = owned[0]
    q[64:128, 1] = owned[300]
    new_ans = _answer_vec(eng, q)          # warm: the program key seen
    _rot(eng, [0, 300])
    old_ans = _answer_vec(eng, q)
    assert not np.array_equal(old_ans, new_ans)
    threads, stop, seen, errors = 8, threading.Event(), [], []
    barrier = threading.Barrier(threads + 1)

    def body():
        barrier.wait()
        try:
            while True:
                done = stop.is_set()
                seen.append(_answer_vec(eng, q))
                if done:
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    ts = [threading.Thread(target=body) for _ in range(threads)]
    for th in ts:
        th.start()
    n0 = cw.cuda_walk_batch.launches
    barrier.wait()
    time.sleep(0.2)
    report, _ = scrub_mod.scrub_engine_table(eng, conf.outdir, eng.fm,
                                             None)
    time.sleep(0.2)
    stop.set()
    for th in ts:
        th.join(timeout=300)
    torch.cuda.synchronize()
    assert not errors, errors
    assert report["rebound"]
    kinds = [("old" if np.array_equal(a, old_ans) else
              "new" if np.array_equal(a, new_ans) else "mix")
             for a in seen]
    assert "mix" not in kinds
    assert "old" in kinds and "new" in kinds
    assert cw.cuda_walk_batch.launches - n0 == len(seen)
    assert np.array_equal(_answer_vec(eng, q), new_ans)


def test_audit_beside_batchers_counts_every_launch(world):
    """A frontend on the card with the audit at 1000 per mille (its
    recompute lane walks with B1 from the audit thread): B1 launches ==
    batches + audited batches + the new program keys, with no plain
    walk."""
    conf, g, dc, queries = world
    disp = EngineDispatcher(conf, graph=g, dc=dc, device="cuda")
    fe = ServingFrontend(dc, disp, sconf=ServeConfig(
        max_batch=64, max_wait_ms=2.0, queue_depth=4096, cache_bytes=0))
    aud = audit_mod.AnswerAuditor(disp, 1000, queue_max=4096)
    fe.auditor = aud
    snap0 = obs_metrics.REGISTRY.snapshot()["counters"]
    keys0 = len(obs_device.snapshot())
    n0, p0 = cw.cuda_walk_batch.launches, cw.cuda_walk_batch.plain
    fe.start()
    try:
        res = [f.result(120) for f in
               [fe.submit(int(s), int(t)) for s, t in queries]]
    finally:
        fe.stop()
    deadline = time.monotonic() + 120
    while (aud.statusz()["queued"] or aud.statusz()["audited"]
           < _delta(snap0, "audit_batches_total")) \
            and time.monotonic() < deadline:
        time.sleep(0.05)
    aud.stop()
    torch.cuda.synchronize()
    assert all(r.status == "OK" for r in res)
    batches = _delta(snap0, "serve_batches_total")
    audited = _delta(snap0, "audit_batches_total")
    assert audited == batches and aud.statusz()["divergent"] == {}
    keys = len(obs_device.snapshot()) - keys0
    assert cw.cuda_walk_batch.launches - n0 == batches + audited + keys
    assert cw.cuda_walk_batch.plain == p0


def _delta(snap0, name):
    now = obs_metrics.REGISTRY.snapshot()["counters"].get(name, 0)
    return int(now - snap0.get(name, 0))
