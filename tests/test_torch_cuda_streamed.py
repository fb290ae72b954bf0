"""PyTorch port, the streamed oracle on the card: ``StreamedCPDOracle``
on ``cuda`` answers as on the CPU — ``query`` (free flow, a diff, a move
budget), ``query_multi`` and ``query_paths``, in range and compacted
mode, with RLE, pack4 and raw uploads, cold and warm — with the same
``last_stats``; one walk kernel launch a row-chunk (B1 for ``query``, K4
for ``query_multi``) and no plain walk; the device decoders equal their
CPU runs on seeded chunks, escapes and runs past 255 included.

Needs an NVIDIA GPU and ``nvcc``; skips without them. This file imports
the port only (no JAX), so it runs on a machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_streamed.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)

from distributed_oracle_search_tpu_torch.data import (  # noqa: E402
    synth_diff, synth_road_network, synth_scenario,
)
from distributed_oracle_search_tpu_torch.models import streamed as ts  # noqa: E402
from distributed_oracle_search_tpu_torch.models.cpd import (  # noqa: E402
    build_worker_shard, write_index_manifest,
)
from distributed_oracle_search_tpu_torch.ops import cuda_walk as cw  # noqa: E402
from distributed_oracle_search_tpu_torch.parallel import (  # noqa: E402
    DistributionController,
)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module", autouse=True)
def _card():
    """Skip the whole module without a card, before the module-scoped
    ``index`` builds anything (an autouse fixture of a scope is set up
    before the other fixtures of that scope)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def index(tmp_path_factory):
    """A 3,000-node road network, ``mod`` over 3 workers in blocks of 128
    rows, built on the CPU; 2,500 queries and a diff."""
    d = str(tmp_path_factory.mktemp("cuda-stream"))
    g = synth_road_network(3000, seed=3)
    dc = DistributionController("mod", 3, 3, g.n, block_size=128)
    for wid in range(3):
        build_worker_shard(g, dc, wid, d, chunk=256, device="cpu")
    write_index_manifest(d, dc)
    w = g.weights_with_diff(synth_diff(g, frac=0.2, seed=4))
    return g, dc, d, synth_scenario(g.n, 2500, seed=5), w


def _zero():
    for fn in (cw.cuda_walk_batch, cw.cuda_walk_multi):
        fn.launches = fn.plain = 0


@pytest.mark.parametrize("density", ["0.0", "2.0"])
@pytest.mark.parametrize("codec", ["rle", "pack4", "raw"])
def test_streamed_on_the_card_equals_the_cpu(dev, index, monkeypatch,
                                              tmp_path, density, codec):
    g, dc, d, queries, w = index
    monkeypatch.setenv("DOS_STREAM_RANGE_DENSITY", density)
    monkeypatch.setenv("DOS_STREAM_RLE", "1" if codec == "rle" else "0")
    monkeypatch.setenv("DOS_STREAM_PACK4", "0" if codec == "raw" else "1")
    monkeypatch.setenv("DOS_STREAM_RLE_SIDECAR", "0")
    cpu = ts.StreamedCPDOracle(g, dc, d, row_chunk=200, device="cpu")
    card = ts.StreamedCPDOracle(g, dc, d, row_chunk=200, device="cuda")
    calls = (("query", (queries,), {}), ("query", (queries,), {}),
             ("query", (queries,), {"w_query": w}),
             ("query", (queries,), {"k_moves": 5}),
             ("query_multi", (queries, [None, w]), {}),
             ("query_paths", (queries,), {"k": 6}))
    for name, args, kw in calls:
        want = getattr(cpu, name)(*args, **kw)
        _zero()
        got = getattr(card, name)(*args, **kw)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        assert card.last_stats == cpu.last_stats
        chunks = card.last_stats["row_chunks"]
        walks = {"query": (chunks, 0), "query_multi": (0, chunks),
                 "query_paths": (0, 0)}[name]
        assert (cw.cuda_walk_batch.launches,
                cw.cuda_walk_multi.launches) == walks
        assert cw.cuda_walk_batch.plain == cw.cuda_walk_multi.plain == 0
        assert card.last_seconds["walk"] > 0
        if card.last_stats["cache_misses"] and codec != "raw":
            assert card.last_seconds["decode"] > 0
    st = card.last_stats
    assert st["bytes_streamed"] == 0 and st["cache_hits"] == st["row_chunks"]


def _chunks():
    rng = np.random.default_rng(8)
    esc = np.repeat(rng.choice(np.int8([-1, 0, 2, 13, 14, 21]), (40, 301)),
                    7, axis=0)[:271]
    tall = np.tile(rng.integers(-1, 6, (1, 513)).astype(np.int8), (1300, 1))
    few = rng.integers(-1, 14, (64, 999)).astype(np.int8)
    few[3, 7], few[60, 998] = 17, 14
    return [esc, tall, few]


def test_decoders_on_the_card_equal_the_cpu(dev):
    for fm in _chunks():
        rle = ts._pack_rle(fm, False)
        if rle is not None:
            host = [torch.from_numpy(a) for a in rle]
            got = ts._unpack_rle(*(h.to(dev) for h in host), c=fm.shape[0])
            np.testing.assert_array_equal(got.cpu().numpy(), fm)
        p4 = ts._pack4(fm)
        if p4 is not None:
            packed, er, ec, ev = (torch.from_numpy(a) for a in
                                  (p4[0], p4[1].view(np.int16), *p4[2:]))
            got = ts._unpack4(packed.to(dev), fm.shape[1], er.to(dev),
                              ec.to(dev), ev.to(dev))
            np.testing.assert_array_equal(got.cpu().numpy(), fm)
    assert ts._pack_rle(_chunks()[1], False) is not None
    assert ts._pack4(_chunks()[2]) is not None
