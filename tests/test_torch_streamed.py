"""PyTorch port, the streamed oracle (``models/streamed.py``): the port's
``StreamedCPDOracle`` on ``device="cpu"`` against the JAX package's on
one index the JAX package builds, which the port's resident
``CPDOracle`` loads too. Each test mirrors one of the JAX package's
``tests/test_streamed.py`` (and the two streamed tests of
``tests/test_compressed.py``) and holds exactly equal: the answers of
``query``/``query_paths``/``query_multi``, the port's resident answers,
and ``last_stats``. Each package streams from its own copy of the index,
so the sidecars each writes stay its own and both see the same files.
Also held: the codecs byte-equal to JAX's on seeded chunks (escapes, odd
N, an escape share past the limit, runs past 255, ``c < 2``, a chunk
taller than 65,536 rows), each decoder the inverse of its encoder,
sidecars written by either package hit by the other, the negative marker
honoured."""

import os
import shutil
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)

from distributed_oracle_search_tpu.data import (  # noqa: E402
    synth_city_graph as j_city, synth_diff as j_diff, synth_scenario,
)
from distributed_oracle_search_tpu.models import streamed as js  # noqa: E402
from distributed_oracle_search_tpu.models.cpd import (  # noqa: E402
    build_worker_shard as j_build, write_index_manifest as j_manifest,
)
from distributed_oracle_search_tpu.parallel import (  # noqa: E402
    DistributionController as JDC,
)
from distributed_oracle_search_tpu_torch.data import (  # noqa: E402
    synth_city_graph, synth_diff,
)
from distributed_oracle_search_tpu_torch.models import streamed as ts  # noqa: E402
from distributed_oracle_search_tpu_torch.models.cpd import CPDOracle  # noqa: E402
from distributed_oracle_search_tpu_torch.parallel import (  # noqa: E402
    DistributionController,
)

STREAM_KNOBS = ("DOS_STREAM_PACK4", "DOS_STREAM_RLE", "DOS_STREAM_RLE_SIDECAR",
                "DOS_STREAM_RANGE_DENSITY")


@pytest.fixture(autouse=True)
def _default_knobs(monkeypatch):
    for name in STREAM_KNOBS:
        monkeypatch.delenv(name, raising=False)


def _copy_index(src: str, dst: str) -> str:
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns("rle-*"))
    return dst


@pytest.fixture(scope="module")
def stream_setup(tmp_path_factory):
    """The JAX suite's index (a 16 x 12 city, ``mod`` over 4 workers),
    built by the JAX package and copied once for each package."""
    root = tmp_path_factory.mktemp("stream")
    built = str(root / "built")
    jg = j_city(16, 12, seed=5)
    jdc = JDC("mod", 4, 4, jg.n)
    for wid in range(4):
        j_build(jg, jdc, wid, built, chunk=64)
    j_manifest(built, jdc)
    tg = synth_city_graph(16, 12, seed=5)
    tdc = DistributionController("mod", 4, 4, tg.n)
    resident = CPDOracle(tg, tdc, device="cpu").load(built)
    return types.SimpleNamespace(
        jg=jg, jdc=jdc, tg=tg, tdc=tdc, built=built,
        jdir=_copy_index(built, str(root / "jax")),
        tdir=_copy_index(built, str(root / "torch")),
        queries=synth_scenario(jg.n, 300, seed=6), resident=resident)


def _oracles(s, jdir=None, tdir=None, **kw):
    """A JAX and a port streamed oracle, each on its own index copy."""
    return (js.StreamedCPDOracle(s.jg, s.jdc, jdir or s.jdir, **kw),
            ts.StreamedCPDOracle(s.tg, s.tdc, tdir or s.tdir, device="cpu",
                                 **kw))


def _same(pair, method, *args, **kw):
    """Run ``method`` on both oracles: answers and ``last_stats`` equal.
    Returns the port's answers."""
    j, t = pair
    want = getattr(j, method)(*args, **kw)
    got = getattr(t, method)(*args, **kw)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
        assert a.dtype == np.asarray(b).dtype
    assert t.last_stats == j.last_stats
    return got


def _equal(got, want):
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def _diff_weights(s, frac, seed):
    """The same congestion diff, made by each package's ``synth_diff``."""
    jw = s.jg.weights_with_diff(j_diff(s.jg, frac=frac, seed=seed))
    tw = s.tg.weights_with_diff(synth_diff(s.tg, frac=frac, seed=seed))
    np.testing.assert_array_equal(jw, tw)
    return tw


# ------------------------------------------------------------------ codecs

def _codec_cases():
    rng = np.random.default_rng(21)
    escapes = rng.integers(-1, 14, (5, 33)).astype(np.int8)   # odd N
    escapes[0, 0] = 17                 # (0, 0) itself an escape entry
    escapes[2, 31] = 14                # the escape boundary value
    escapes[4, 5] = 20                 # a hub-degree slot
    heavy = rng.integers(-1, 14, (8, 16)).astype(np.int8)
    heavy[:, :2] = 20                  # 12.5% of entries escape
    noise = np.arange(64 * 32, dtype=np.int64).reshape(64, 32)
    tall_guard = np.zeros((65537, 1), np.int8)
    tall_guard[65535, 0] = 20
    return {
        "blocky": np.repeat(rng.integers(-1, 6, (4, 50)).astype(np.int8),
                            16, axis=0)[:60],
        "escapes-odd-n": escapes,
        "escape-share-past-limit": heavy,
        "runs-past-255": np.tile(rng.integers(-1, 6, (1, 8)).astype(np.int8),
                                 (600, 1)),
        "blocky-escapes": np.repeat(
            rng.choice(np.int8([-1, 0, 3, 15, 19]), (3, 41)), 30,
            axis=0)[:77],
        "incompressible": ((noise % 13) - 1).astype(np.int8),
        "one-row": np.zeros((1, 5), np.int8),
        "taller-than-65536": tall_guard,
    }


CODEC_CASES = _codec_cases()
#: (pack4 encodes, RLE encodes against the pack4 baseline) for each case
ENCODES = {"blocky": (True, True), "escapes-odd-n": (True, False),
           "escape-share-past-limit": (False, False),
           "runs-past-255": (True, True), "blocky-escapes": (False, True),
           "incompressible": (True, False), "one-row": (True, False),
           "taller-than-65536": (False, True)}


def _bytes_equal(got, want):
    if want is None:
        assert got is None
        return
    assert got is not None and len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("name", sorted(CODEC_CASES))
def test_codecs_byte_equal_and_invertible(name):
    """``_pack4`` and ``_pack_rle`` (both break-even baselines) give JAX's
    arrays byte for byte, and each port decoder inverts its encoder (the
    wire's uint16 rows travel as int16 bytes, as the oracle uploads
    them)."""
    fm = CODEC_CASES[name]
    p4 = ts._pack4(fm)
    _bytes_equal(p4, js._pack4(fm))
    assert (p4 is not None, ts._pack_rle(fm, True) is not None) == \
        ENCODES[name]
    if p4 is not None:
        packed, er, ec, ev = p4
        got = ts._unpack4(torch.from_numpy(packed), fm.shape[1],
                          torch.from_numpy(er.view(np.int16)),
                          torch.from_numpy(ec), torch.from_numpy(ev))
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), fm)
    for viable in (True, False):
        rle = ts._pack_rle(fm, viable)
        _bytes_equal(rle, js._pack_rle(fm, viable))
        if rle is not None:
            got = ts._unpack_rle(*(torch.from_numpy(a) for a in rle),
                                 c=fm.shape[0])
            assert got.dtype == torch.int8 and got.is_contiguous()
            np.testing.assert_array_equal(got.numpy(), fm)
    if name == "runs-past-255":
        plen = ts._pack_rle(fm, True)[0]
        assert (plen == 255).any()


def test_default_cache_bytes_on_cpu():
    assert ts.default_cache_bytes("cpu") == 1 << 30


def test_entry_point_needs_a_gpu_unless_asked(stream_setup):
    s = stream_setup
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ts.StreamedCPDOracle(s.tg, s.tdc, s.tdir)


# ---------------------------------------------- the JAX suite, mirrored

def test_streamed_matches_resident_free_flow(stream_setup):
    s = stream_setup
    pair = _oracles(s, row_chunk=37)         # force many chunks
    got = _same(pair, "query", s.queries)
    _equal(got, s.resident.query(s.queries))
    stats = pair[1].last_stats
    assert stats["n_queries"] == len(s.queries)
    if stats["mode"] == "compacted":
        assert stats["row_chunks"] == -(-stats["distinct_targets"] // 37)
    else:
        assert stats["row_chunks"] >= -(-stats["distinct_targets"] // 37)
    assert pair[1].pack4
    assert stats["bytes_raw"] == stats["row_chunks"] * 37 * s.tg.n
    assert stats["bytes_streamed"] < 0.55 * stats["bytes_raw"]


def test_streamed_matches_resident_diffed(stream_setup):
    s = stream_setup
    w = _diff_weights(s, 0.2, 7)
    got = _same(_oracles(s, row_chunk=64), "query", s.queries, w_query=w)
    _equal(got, s.resident.query(s.queries, w_query=w))


def test_streamed_k_moves_budget(stream_setup):
    s = stream_setup
    got = _same(_oracles(s, row_chunk=128), "query", s.queries, k_moves=3)
    _equal(got, s.resident.query(s.queries, k_moves=3))
    assert (got[1] <= 3).all()


def test_streamed_query_paths_matches_resident(stream_setup):
    s = stream_setup
    pair = _oracles(s, row_chunk=37)
    got = _same(pair, "query_paths", s.queries, k=5)
    _equal(got, s.resident.query_paths(s.queries, k=5))
    for o in pair:
        with pytest.raises(ValueError, match="positive"):
            o.query_paths(s.queries, k=0)


def test_streamed_rejects_mismatched_controller(stream_setup):
    s = stream_setup
    with pytest.raises(ValueError, match="was built with"):
        ts.StreamedCPDOracle(s.tg, DistributionController("mod", 2, 2,
                                                          s.tg.n),
                             s.tdir, device="cpu")


def test_streamed_chunk_cache_round2_streams_zero(stream_setup,
                                                  monkeypatch):
    s = stream_setup
    monkeypatch.setenv("DOS_STREAM_RANGE_DENSITY", "0.0")   # force range
    pair = _oracles(s, row_chunk=37)
    first = _same(pair, "query", s.queries)
    st = pair[1].last_stats
    assert st["cache_misses"] == st["row_chunks"] and st["bytes_streamed"]
    _equal(_same(pair, "query", s.queries), first)
    assert pair[1].last_stats["bytes_streamed"] == 0
    assert pair[1].last_stats["cache_hits"] == st["row_chunks"]
    w = _diff_weights(s, 0.2, 9)
    got = _same(pair, "query", s.queries, w_query=w)
    assert pair[1].last_stats["bytes_streamed"] == 0   # all hits
    _equal(got, s.resident.query(s.queries, w_query=w))
    # compacted mode: an identical replayed campaign is content-addressed
    monkeypatch.setenv("DOS_STREAM_RANGE_DENSITY", "2.0")
    pair_c = _oracles(s, row_chunk=37)
    c1 = _same(pair_c, "query", s.queries)
    assert pair_c[1].last_stats["mode"] == "compacted"
    assert pair_c[1].last_stats["bytes_streamed"] > 0
    _equal(_same(pair_c, "query", s.queries), c1)
    assert pair_c[1].last_stats["bytes_streamed"] == 0


def test_streamed_query_multi_matches_sequential(stream_setup):
    s = stream_setup
    w_list = [None, _diff_weights(s, 0.2, 13), _diff_weights(s, 0.4, 14)]
    pair = _oracles(s, row_chunk=37)
    cm, pm, fm = _same(pair, "query_multi", s.queries, w_list)
    assert cm.shape == (3, len(s.queries))
    for di, w in enumerate(w_list):
        c1, p1, f1 = _same(pair, "query", s.queries, w_query=w)
        np.testing.assert_array_equal(cm[di], c1)
        np.testing.assert_array_equal(pm, p1)
        np.testing.assert_array_equal(fm, f1)
    _equal(s.resident.query_multi(s.queries, w_list), (cm, pm, fm))
    c2, _, _ = _same(pair, "query_multi", s.queries, w_list)   # warm
    assert pair[1].last_stats["bytes_streamed"] == 0
    np.testing.assert_array_equal(c2, cm)
    with pytest.raises(ValueError, match="at least one"):
        pair[1].query_multi(s.queries, [])


def test_streamed_cache_budget_and_disable(stream_setup, monkeypatch):
    s = stream_setup
    monkeypatch.setenv("DOS_STREAM_RANGE_DENSITY", "0.0")   # force range
    two_chunks = 2 * 37 * s.tg.n
    pair = _oracles(s, row_chunk=37, cache_bytes=two_chunks)
    got = _same(pair, "query", s.queries)
    assert pair[1].last_stats["row_chunks"] > 2         # forced eviction
    held = sum(v.nbytes for v in pair[1]._chunk_cache.values())
    assert 0 < held <= two_chunks
    assert held == sum(v.nbytes for v in pair[0]._chunk_cache.values())
    _equal(got, s.resident.query(s.queries))
    pair0 = _oracles(s, row_chunk=37, cache_bytes=0)
    _same(pair0, "query", s.queries)
    got0 = _same(pair0, "query", s.queries)
    assert pair0[1].last_stats["cache_hits"] == 0
    assert pair0[1].last_stats["bytes_streamed"] > 0
    _equal(got0, got)


def test_streamed_pack4_roundtrip_and_disable(stream_setup, monkeypatch):
    """pack4 uploads answer as raw ones; ``DOS_STREAM_PACK4=0`` uploads
    raw chunks (the RLE coder held off, so pack4 is what streams)."""
    s = stream_setup
    monkeypatch.setenv("DOS_STREAM_RLE", "0")
    pair_p = _oracles(s, row_chunk=37)
    assert pair_p[1].pack4
    got_p = _same(pair_p, "query", s.queries)
    assert pair_p[1].last_stats["chunks_packed"] > 0
    monkeypatch.setenv("DOS_STREAM_PACK4", "0")
    pair_r = _oracles(s, row_chunk=37)
    assert not pair_r[1].pack4
    got_r = _same(pair_r, "query", s.queries)
    _equal(got_p, got_r)
    assert pair_p[1].last_stats["bytes_streamed"] < \
        pair_r[1].last_stats["bytes_streamed"]


def test_streamed_rle_roundtrip_and_disable(stream_setup, monkeypatch):
    s = stream_setup
    pair_on = _oracles(s, row_chunk=64)
    assert pair_on[1].rle
    got_on = _same(pair_on, "query", s.queries)
    stats_on = dict(pair_on[1].last_stats)
    monkeypatch.setenv("DOS_STREAM_RLE", "0")
    pair_off = _oracles(s, row_chunk=64)
    assert not pair_off[1].rle
    _equal(_same(pair_off, "query", s.queries), got_on)
    if stats_on["chunks_rle"] > 0:
        assert stats_on["bytes_streamed"] < \
            pair_off[1].last_stats["bytes_streamed"]


def test_streamed_rle_sidecar_persistence(stream_setup, tmp_path):
    """The first cold round writes a sidecar a miss; a fresh oracle's
    cold round hits them all with the same answers and bytes; touching
    the block files invalidates them."""
    s = stream_setup
    jdir = _copy_index(s.built, str(tmp_path / "j"))
    tdir = _copy_index(s.built, str(tmp_path / "t"))
    pair1 = _oracles(s, jdir, tdir, row_chunk=64)
    first = _same(pair1, "query", s.queries)
    s1 = dict(pair1[1].last_stats)
    # every miss persists the encoding or a negative marker
    for d in (jdir, tdir):
        sidecars = [f for f in os.listdir(d) if f.startswith("rle-")]
        assert len(sidecars) == s1["cache_misses"]
    assert s1["sidecar_hits"] == 0
    pair2 = _oracles(s, jdir, tdir, row_chunk=64)
    _equal(_same(pair2, "query", s.queries), first)
    s2 = pair2[1].last_stats
    if s1["chunks_rle"] == 0:          # coder fell back: markers only
        assert s2["sidecar_hits"] == s2["cache_misses"]
        assert s2["chunks_rle"] == 0
    else:
        assert s2["sidecar_hits"] == s2["chunks_rle"] == s1["chunks_rle"]
        assert s2["bytes_streamed"] == s1["bytes_streamed"]
    for d in (jdir, tdir):
        for f in os.listdir(d):
            if f.startswith("cpd-"):
                os.utime(os.path.join(d, f), ns=(1, 1))
    pair3 = _oracles(s, jdir, tdir, row_chunk=64)
    _equal(_same(pair3, "query", s.queries), first)
    assert pair3[1].last_stats["sidecar_hits"] == 0


def test_streamed_modes_agree(stream_setup, monkeypatch):
    s = stream_setup
    monkeypatch.setenv("DOS_STREAM_RANGE_DENSITY", "0.0")
    pair_r = _oracles(s, row_chunk=37)
    got_r = _same(pair_r, "query", s.queries)
    assert pair_r[1].last_stats["mode"] == "range"
    monkeypatch.setenv("DOS_STREAM_RANGE_DENSITY", "2.0")
    pair_c = _oracles(s, row_chunk=37)
    _equal(_same(pair_c, "query", s.queries), got_r)
    assert pair_c[1].last_stats["mode"] == "compacted"


# ------------------------------------------------------ sidecar exchange

@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_sidecars_interchange(stream_setup, tmp_path, monkeypatch, writer):
    """A sidecar written by either package is a hit for the other: the
    same names, keys, dtypes and arrays, and the reader streams the same
    bytes with the same answers."""
    s = stream_setup
    monkeypatch.setenv("DOS_STREAM_RANGE_DENSITY", "0.0")
    d = _copy_index(s.built, str(tmp_path / "idx"))
    j, t = _oracles(s, d, d, row_chunk=64)
    first, second = (j, t) if writer == "jax" else (t, j)
    want = first.query(s.queries)
    cold = dict(first.last_stats)
    names = sorted(f for f in os.listdir(d) if f.startswith("rle-"))
    assert len(names) == cold["cache_misses"] > 0
    got = second.query(s.queries)
    _equal(got, [np.asarray(a) for a in want])
    st = second.last_stats
    assert st["sidecar_hits"] == st["cache_misses"] == cold["cache_misses"]
    assert st["bytes_streamed"] == cold["bytes_streamed"]
    assert sorted(f for f in os.listdir(d) if f.startswith("rle-")) == names
    # the arrays each package would write for these chunks
    for name in names:
        with np.load(os.path.join(d, name)) as z:
            keys = set(z.files)
            assert keys in ({"fp", "lens", "vals", "counts"},
                            {"fp", "fallback"})
            assert z["fp"].dtype == np.int64
            if "lens" in keys:
                assert (z["lens"].dtype, z["vals"].dtype,
                        z["counts"].dtype) == (np.uint8, np.int8, np.int32)


def test_negative_marker_honoured(stream_setup, tmp_path, monkeypatch):
    """A valid fallback sidecar (the chunk measured incompressible) is a
    hit that skips the RLE attempt: the chunk streams pack4, in both
    packages alike."""
    s = stream_setup
    monkeypatch.setenv("DOS_STREAM_RANGE_DENSITY", "0.0")
    jdir = _copy_index(s.built, str(tmp_path / "j"))
    tdir = _copy_index(s.built, str(tmp_path / "t"))
    j, t = _oracles(s, jdir, tdir, row_chunk=64)
    for o, d in ((j, jdir), (t, tdir)):
        fp = o._chunk_fingerprint([(0, 0)])
        o._sidecar_save(os.path.join(d, "rle-w00000-r000000000-c64.npz"),
                        fp, None)
    calls = []
    real = ts._pack_rle
    monkeypatch.setattr(ts, "_pack_rle",
                        lambda fm, v: calls.append(fm.shape) or real(fm, v))
    got = _same((j, t), "query", s.queries)
    _equal(got, s.resident.query(s.queries))
    st = t.last_stats
    assert st["sidecar_hits"] == 1
    assert len(calls) == st["cache_misses"] - 1
    assert st["chunks_packed"] >= 1


# ----------------------------------------------- compressed block files

@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """The JAX compressed suite's toy shard (8 x 6 city, one worker,
    blocks of 8 and 16 rows) as pack4 container blocks."""
    jg, tg = j_city(8, 6, seed=7), synth_city_graph(8, 6, seed=7)
    out = {}
    for bs in (8, 16):
        d = str(tmp_path_factory.mktemp(f"comp{bs}"))
        jdc = JDC("tpu", None, 1, jg.n, block_size=bs)
        j_build(jg, jdc, 0, d, chunk=bs, codec="pack4")
        j_manifest(d, jdc)
        out[bs] = (d, DistributionController("tpu", None, 1, tg.n,
                                             block_size=bs), jdc)
    return jg, tg, out, synth_scenario(jg.n, 64, seed=11)


def test_streamed_decoded_cache_is_bounded(toy):
    jg, tg, idx, _ = toy
    d, tdc, _ = idx[8]
    st = ts.StreamedCPDOracle(tg, tdc, d, row_chunk=8, cache_bytes=0,
                              device="cpu")
    n_blocks = -(-tdc.n_owned(0) // tdc.block_size)
    assert n_blocks > st._DECODED_KEEP
    for bid in range(n_blocks):
        blk = st._block(0, bid)
        assert blk.dtype == np.int8 and blk.ndim == 2
    assert len(st._decoded) == st._DECODED_KEEP
    st._block(0, n_blocks - 1)
    assert (0, n_blocks - 1) in st._decoded


def test_streamed_oracle_reads_compressed_blocks(toy, tmp_path):
    jg, tg, idx, queries = toy
    d, tdc, jdc = idx[16]
    q = np.asarray(queries, np.int64)
    got = _same((js.StreamedCPDOracle(
                    jg, jdc, _copy_index(d, str(tmp_path / "j")),
                    row_chunk=16, cache_bytes=0),
                 ts.StreamedCPDOracle(
                    tg, tdc, _copy_index(d, str(tmp_path / "t")),
                    row_chunk=16, cache_bytes=0, device="cpu")),
                "query", q)
    _equal(got, CPDOracle(tg, tdc, device="cpu").load(d).query(q))
