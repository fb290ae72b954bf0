"""PyTorch port, compressed residency: the port's ``models/resident.py``
encoders and containers give the JAX package's bytes (equal crc32
digests), its torch decoders give the JAX decoders' rows, a port
``ShardEngine`` kept pack4/rle/auto answers exactly as the JAX engine and
as the port's raw engine, and compressed indexes built by either package
load under the other. Every comparison is bit-identical."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)

from distributed_oracle_search_tpu.data import Graph as JGraph  # noqa: E402
from distributed_oracle_search_tpu.data import synth_city_graph  # noqa: E402
from distributed_oracle_search_tpu.data import synth_diff  # noqa: E402
from distributed_oracle_search_tpu.data.formats import write_diff  # noqa: E402
from distributed_oracle_search_tpu.models import cpd as jcpd  # noqa: E402
from distributed_oracle_search_tpu.models import resident as jres  # noqa: E402
from distributed_oracle_search_tpu.ops import DeviceGraph as JDeviceGraph  # noqa: E402
from distributed_oracle_search_tpu.ops import build_fm_columns as jbuild  # noqa: E402
from distributed_oracle_search_tpu.parallel.partition import (  # noqa: E402
    DistributionController as JDC,
)
from distributed_oracle_search_tpu.transport.wire import (  # noqa: E402
    RuntimeConfig as JConfig,
)
from distributed_oracle_search_tpu.worker import engine as jengine  # noqa: E402
from distributed_oracle_search_tpu_torch.data import Graph  # noqa: E402
from distributed_oracle_search_tpu_torch.models import cpd  # noqa: E402
from distributed_oracle_search_tpu_torch.models import resident  # noqa: E402
from distributed_oracle_search_tpu_torch.ops import cuda_walk_batch  # noqa: E402
from distributed_oracle_search_tpu_torch.parallel import (  # noqa: E402
    DistributionController,
)
from distributed_oracle_search_tpu_torch.transport import RuntimeConfig  # noqa: E402
from distributed_oracle_search_tpu_torch.worker import build as wbuild  # noqa: E402
from distributed_oracle_search_tpu_torch.worker import engine  # noqa: E402

CODECS = ("pack4", "rle", "auto")


def _structured_fm(r: int = 600, n: int = 300, seed: int = 0):
    """A run-coherent [r, n] int8 table (the target-axis coherence real
    CPD shards have) with slots 0..5 and -1 holes."""
    rng = np.random.default_rng(seed)
    base = rng.integers(-1, 6, size=(1, n), dtype=np.int64)
    fm = np.repeat(base, r, axis=0).astype(np.int8)
    flip = rng.random(fm.shape) < 0.03
    fm[flip] = rng.integers(-1, 6, size=int(flip.sum()))
    return fm


def _toy_fm(g):
    return np.asarray(jbuild(JDeviceGraph.from_graph(g),
                             jnp.arange(g.n, dtype=jnp.int32)))


def _tg(g):
    return Graph(g.xs, g.ys, g.src, g.dst, g.w)


def _assert_enc_equal(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y


# ------------------------------------------------------------- knobs

@pytest.mark.parametrize("raw", [None, "rle", "PACK4", "auto", "bogus", ""])
def test_resident_choice_knob_equal(monkeypatch, raw):
    if raw is None:
        monkeypatch.delenv("DOS_CPD_RESIDENT", raising=False)
    else:
        monkeypatch.setenv("DOS_CPD_RESIDENT", raw)
    assert resident.resident_choice() == jres.resident_choice()


@pytest.mark.parametrize("raw", [None, "128", "0", "1", "999999", "nope"])
def test_rle_group_knob_equal(monkeypatch, raw):
    if raw is None:
        monkeypatch.delenv("DOS_CPD_RLE_GROUP", raising=False)
    else:
        monkeypatch.setenv("DOS_CPD_RLE_GROUP", raw)
    assert resident.rle_group_rows() == jres.rle_group_rows()


def test_constants_equal():
    for name in ("RESIDENT_CODECS", "PACK4_ESCAPE", "PACK4_MARKER",
                 "RESIDENT_RLE_MAX_FRAC", "_RLE_GROUP_DEFAULT",
                 "BLOCK_MAGIC"):
        assert getattr(resident, name) == getattr(jres, name), name


# ---------------------------------------------------------- encoders

def test_encode_pack4_equal_and_escape_refusal(toy_graph):
    fm = _toy_fm(toy_graph)
    for table in (fm, _structured_fm()):
        got, want = resident.encode_pack4(table), jres.encode_pack4(table)
        assert got is not None and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    esc = _structured_fm()
    esc[3, 5] = resident.PACK4_ESCAPE
    assert resident.encode_pack4(esc) is None
    assert jres.encode_pack4(esc) is None


def test_encode_pack4_odd_n_pads_marker():
    g = synth_city_graph(5, 3)
    fm = _toy_fm(g)
    assert fm.shape == (15, 15)
    got = resident.encode_pack4(fm)
    np.testing.assert_array_equal(got, jres.encode_pack4(fm))
    assert got.shape == (15, 8)
    assert ((got[:, -1] >> 4) == resident.PACK4_MARKER).all()


@pytest.mark.parametrize("group", [2, 7, 64, 100, 4096])
def test_encode_rle_equal(toy_graph, group):
    for table in (_toy_fm(toy_graph), _structured_fm(r=597, n=299, seed=2)):
        _assert_enc_equal(resident.encode_rle(table, group=group),
                          jres.encode_rle(table, group=group))
    enc = resident.encode_rle(_structured_fm(r=597, n=299, seed=2),
                              group=group)
    # groups 2 and 7 cost more in offsets than the raw bytes: refused
    assert (enc is None) == (group in (2, 7))
    if enc is not None:
        assert resident._rle_steps(enc[2]) == jres._rle_steps(enc[2])


def test_incompressible_refused():
    rng = np.random.default_rng(1)
    junk = rng.integers(-1, 14, size=(128, 129)).astype(np.int8)
    assert resident.encode_rle(junk) is None
    assert resident.encode_block(junk, "rle") is None
    assert jres.encode_block(junk, "rle") is None


@pytest.mark.parametrize("codec", ["raw", None, "pack4", "rle", "auto"])
def test_encode_block_bytes_equal(toy_graph, codec):
    for table in (_toy_fm(toy_graph), _structured_fm(),
                  _toy_fm(synth_city_graph(5, 3))):
        got, want = (resident.encode_block(table, codec),
                     jres.encode_block(table, codec))
        _assert_enc_equal(got, want)
        if got is not None:
            assert resident.is_container(got[0])
            assert resident.block_codec(got[0]) == got[1]
            np.testing.assert_array_equal(
                resident.decode_block_rows(got[0]), table)
            np.testing.assert_array_equal(jres.decode_block_rows(got[0]),
                                          table)


def test_auto_picks_the_same_codec():
    """Short runs: pack4 beats rle; long runs: rle beats pack4. Both
    packages pick alike, on disk and resident."""
    rng = np.random.default_rng(7)
    base = rng.integers(-1, 6, size=(1, 64), dtype=np.int64)
    short = np.repeat(base, 1200, axis=0).astype(np.int8)
    flip = rng.random(short.shape) < 0.12
    short[flip] = rng.integers(-1, 6, size=int(flip.sum()))
    for table, want in ((short, "pack4"), (_structured_fm(), "rle")):
        _, used = resident.encode_block(table, "auto")
        assert used == want == jres.encode_block(table, "auto")[1]
        _, res_used = resident.make_resident(table, codec="auto",
                                             device="cpu")
        assert res_used == want


def test_container_torn_and_foreign_payloads():
    fm = _structured_fm()
    payload, _ = resident.encode_block(fm, "rle")
    with pytest.raises(ValueError):
        resident.decode_block_rows(payload[:len(payload) // 2])
    torn = np.frombuffer(resident.BLOCK_MAGIC + bytes(16), np.uint8)
    with pytest.raises(ValueError, match="header"):
        resident.block_codec(torn)
    assert not resident.is_container(np.zeros(64, np.uint8))
    assert not resident.is_container(fm)
    assert resident.block_codec(fm) is None
    np.testing.assert_array_equal(resident.maybe_decode_rows(fm), fm)


# ---------------------------------------------------------- decoders

def _row_sets(r: int, seed: int):
    rng = np.random.default_rng(seed)
    return [np.arange(r, dtype=np.int32),
            rng.integers(0, r, 37).astype(np.int32),
            np.array([0, 0, r - 1, -1, -5, r, r + 3, 2], np.int32)]


@pytest.mark.parametrize("cells", [resident.DECODE_CELLS, 64])
def test_decode_pack4_rows_equal(monkeypatch, cells):
    """Pad and negative row ids clamp like the JAX decoder; a small cell
    budget decodes in row chunks to the same rows."""
    monkeypatch.setattr(resident, "DECODE_CELLS", cells)
    for fm in (_structured_fm(r=97, n=61, seed=4),
               _toy_fm(synth_city_graph(5, 3))):
        packed = resident.encode_pack4(fm)
        for rows in _row_sets(fm.shape[0], 5):
            want = np.asarray(jres._decode_pack4_rows(
                jnp.asarray(packed), jnp.asarray(rows), n=fm.shape[1]))
            got = resident.decode_pack4_rows(torch.as_tensor(packed),
                                              torch.as_tensor(rows),
                                              fm.shape[1])
            assert got.dtype == torch.int8
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("group,cells", [(64, resident.DECODE_CELLS),
                                         (100, 64), (4096, 1000)])
def test_decode_rle_rows_equal(monkeypatch, group, cells):
    monkeypatch.setattr(resident, "DECODE_CELLS", cells)
    fm = _structured_fm(r=597, n=299, seed=2)
    starts, vals, offsets, g = resident.encode_rle(fm, group=group)
    steps = resident._rle_steps(offsets)
    dev = {"starts": torch.as_tensor(starts.view(np.int16)),
           "vals": torch.as_tensor(vals), "offsets": torch.as_tensor(offsets)}
    for rows in _row_sets(fm.shape[0], 6):
        want = np.asarray(jres._decode_rle_rows(
            jnp.asarray(starts), jnp.asarray(vals), jnp.asarray(offsets),
            jnp.asarray(rows), n=fm.shape[1], group=g, steps=steps,
            r=fm.shape[0]))
        got = resident.decode_rle_rows(
            dev["starts"], dev["vals"], dev["offsets"],
            torch.as_tensor(rows), n=fm.shape[1], group=g, steps=steps,
            r=fm.shape[0])
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            got.numpy(), fm[np.clip(rows, 0, fm.shape[0] - 1)])


@pytest.mark.parametrize("codec", ["raw", "pack4", "rle", "auto"])
def test_make_resident_equal(codec):
    fm = _structured_fm()
    tbl, used = resident.make_resident(fm, codec=codec, device="cpu")
    jtbl, jused = jres.make_resident(fm, codec=codec)
    assert used == jused
    assert int(tbl.nbytes) == int(jtbl.nbytes)
    rows = torch.as_tensor(np.r_[0:7, 593:600, 41].astype(np.int32))
    dense = (tbl[rows.long()] if used == "raw"
             else tbl.decompress_rows(rows))
    np.testing.assert_array_equal(dense.numpy(), fm[rows.numpy()])


def test_make_resident_degrades_to_raw(caplog):
    rng = np.random.default_rng(1)
    junk = rng.integers(-1, 30, size=(128, 129)).astype(np.int8)
    for codec in CODECS:
        tbl, used = resident.make_resident(junk, codec=codec, device="cpu")
        assert used == "raw" == jres.make_resident(junk, codec=codec)[1]
        np.testing.assert_array_equal(tbl.numpy(), junk)
    assert "not viable" in caplog.text
    with pytest.raises(ValueError, match="unknown resident codec"):
        resident.make_resident(junk, codec="zip", device="cpu")


# ----------------------------------------------------- engine parity

@pytest.fixture(scope="module")
def shard(toy_graph, tmp_path_factory):
    """The toy graph's one-worker raw index, built by the port."""
    tdc = DistributionController("tpu", None, 1, toy_graph.n,
                                 block_size=16)
    jdc = JDC("tpu", None, 1, toy_graph.n, block_size=16)
    d = str(tmp_path_factory.mktemp("torch-res-shard"))
    cpd.build_worker_shard(_tg(toy_graph), tdc, 0, d, chunk=16,
                           device="cpu")
    cpd.write_index_manifest(d, tdc)
    diff = str(tmp_path_factory.mktemp("torch-res-diff") / "t.diff")
    write_diff(diff, *synth_diff(toy_graph, frac=0.3, seed=3))
    return tdc, jdc, d, diff


@pytest.fixture(scope="module")
def queries(toy_queries):
    """Scenario plus zero-length (s==t) and duplicate pairs."""
    q = np.asarray(toy_queries, np.int64)
    extra = np.array([[3, 3], [0, 0], q[0].tolist(), q[0].tolist(),
                      q[5].tolist()], np.int64)
    return np.concatenate([q, extra], axis=0)


def _engines(monkeypatch, codec, g, tdc, jdc, d):
    monkeypatch.setenv("DOS_CPD_RESIDENT", "raw")
    raw = engine.ShardEngine(_tg(g), tdc, 0, d, device="cpu")
    monkeypatch.setenv("DOS_CPD_RESIDENT", codec)
    te = engine.ShardEngine(_tg(g), tdc, 0, d, device="cpu")
    je = jengine.ShardEngine(g, jdc, 0, d)
    assert te.resident_codec == je.resident_codec
    assert te.resident_bytes == je.resident_bytes
    if codec != "auto":
        # the engines must not have degraded, or the parity proves nothing
        assert te.resident_codec == codec
    assert te.resident_codec != "raw" and raw.resident_codec == "raw"
    assert 0 < te.resident_bytes < raw.resident_bytes
    return raw, te, je


def _assert_answers(a, b):
    for x, y in zip(a[:3], b[:3]):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    for f in ("n_expanded", "n_touched", "plen", "finished"):
        assert getattr(a[3], f) == getattr(b[3], f), f


@pytest.mark.parametrize("codec", CODECS)
def test_engine_parity_free_flow_and_diff(monkeypatch, toy_graph, shard,
                                          queries, codec):
    tdc, jdc, d, diff = shard
    raw, te, je = _engines(monkeypatch, codec, toy_graph, tdc, jdc, d)
    for difffile in ("-", diff):
        p4_before = cuda_walk_batch.launches_pack4
        got = te.answer(queries, RuntimeConfig(), difffile)
        _assert_answers(raw.answer(queries, RuntimeConfig(), difffile), got)
        _assert_answers(je.answer(queries, JConfig(), difffile), got)
        assert cuda_walk_batch.launches_pack4 == p4_before   # CPU: plain
    assert got[2][-5:].all() and (got[1][-5:-3] == 0).all()


@pytest.mark.parametrize("codec", CODECS)
def test_engine_parity_extract(monkeypatch, toy_graph, shard, queries,
                               codec):
    """Extraction walks and extracts from the inflated batch rows (pack4
    too)."""
    tdc, jdc, d, diff = shard
    raw, te, je = _engines(monkeypatch, codec, toy_graph, tdc, jdc, d)
    for eng_, cfg in ((raw, RuntimeConfig), (je, JConfig)):
        want = eng_.answer(queries, cfg(extract=True, k_moves=6), diff)
        got = te.answer(queries, RuntimeConfig(extract=True, k_moves=6),
                        diff)
        _assert_answers(want, got)
        for x, y in zip(eng_.last_paths, te.last_paths):
            np.testing.assert_array_equal(x, y)
    assert te.last_paths[0].shape == (len(queries), 7)


@pytest.mark.parametrize("codec", ["pack4", "rle"])
def test_engine_parity_chunked_deadline(monkeypatch, toy_graph, shard,
                                        queries, codec):
    """The ns-budget chunked path slices the (packed or remapped) rows;
    a generous budget answers everything, bit-identical to raw."""
    tdc, jdc, d, diff = shard
    raw, te, je = _engines(monkeypatch, codec, toy_graph, tdc, jdc, d)
    raw.time_chunk = te.time_chunk = je.astar_chunk = 16
    cfg = {"time": 10 ** 13}
    got = te.answer(queries, RuntimeConfig(**cfg), diff)
    _assert_answers(raw.answer(queries, RuntimeConfig(**cfg), diff), got)
    _assert_answers(je.answer(queries, JConfig(**cfg), diff), got)
    assert got[3].finished == len(queries)


def _two_cliques():
    """Two disconnected 2-cliques: 0-1 and 2-3."""
    return (np.array([0, 1, 10, 11]), np.zeros(4, np.int64),
            np.array([0, 1, 2, 3]), np.array([1, 0, 3, 2]),
            np.array([5, 5, 7, 7]))


def _star(leaves: int = 18):
    """A hub with ``leaves`` two-way spokes: hub slots run past 13."""
    n = leaves + 1
    spokes = np.arange(1, n)
    src = np.concatenate([np.zeros(leaves, np.int64), spokes])
    dst = np.concatenate([spokes, np.zeros(leaves, np.int64)])
    return (np.arange(n), np.zeros(n, np.int64), src, dst,
            np.full(2 * leaves, 3, np.int32))


@pytest.mark.parametrize("graph,codec,want", [
    (_two_cliques, "pack4", "pack4"),
    (_star, "pack4", "raw"),
])
def test_engine_parity_small_graphs(monkeypatch, tmp_path, graph, codec,
                                    want):
    """Unreachable targets (-1 rows) answer as raw; a shard with slots
    >= 14 asked for pack4 degrades to raw in both packages."""
    arrays = graph()
    jg, tg = JGraph(*arrays), Graph(*arrays)
    tdc = DistributionController("tpu", None, 1, tg.n)
    jdc = JDC("tpu", None, 1, jg.n)
    d = str(tmp_path)
    cpd.build_worker_shard(tg, tdc, 0, d, chunk=4, device="cpu")
    n = tg.n
    q = np.array([[0, 1], [0, n - 1], [n - 2, 1], [n - 1, n - 2], [1, 1],
                  [n - 1, 0]], np.int64)
    monkeypatch.setenv("DOS_CPD_RESIDENT", "raw")
    base = engine.ShardEngine(tg, tdc, 0, d, device="cpu").answer(
        q, RuntimeConfig())
    monkeypatch.setenv("DOS_CPD_RESIDENT", codec)
    te = engine.ShardEngine(tg, tdc, 0, d, device="cpu")
    je = jengine.ShardEngine(jg, jdc, 0, d)
    assert te.resident_codec == je.resident_codec == want
    got = te.answer(q, RuntimeConfig())
    _assert_answers(base, got)
    _assert_answers(je.answer(q, JConfig()), got)
    if graph is _two_cliques:
        assert not got[2][[1, 2]].any()        # cross-clique fails


# ------------------------------------------------------------ on disk

@pytest.fixture(scope="module")
def comp_indexes(toy_graph, tmp_path_factory):
    """Compressed indexes of the toy graph (one worker, 48-row blocks so
    rle is viable too), built by both packages for each codec."""
    tdc = DistributionController("tpu", None, 1, toy_graph.n)
    jdc = JDC("tpu", None, 1, toy_graph.n)
    out = {}
    for codec in CODECS:
        tdir = str(tmp_path_factory.mktemp(f"torch-{codec}"))
        jdir = str(tmp_path_factory.mktemp(f"jax-{codec}"))
        cpd.build_worker_shard(_tg(toy_graph), tdc, 0, tdir, chunk=16,
                               device="cpu", codec=codec)
        jcpd.build_worker_shard(toy_graph, jdc, 0, jdir, chunk=16,
                                codec=codec)
        out[codec] = (cpd.write_index_manifest(tdir, tdc),
                      jcpd.write_index_manifest(jdir, jdc), tdir, jdir)
    return tdc, jdc, out


@pytest.mark.parametrize("codec", CODECS)
def test_compressed_blocks_byte_identical(comp_indexes, codec):
    _, _, out = comp_indexes
    tman, jman, tdir, jdir = out[codec]
    assert tman == jman
    metas = list(tman["blocks"].values())
    assert metas and all(m.get("codec") in ("pack4", "rle") for m in metas)
    if codec != "auto":
        assert all(m["codec"] == codec for m in metas)
    assert (cpd.BuildLedger(tdir, 0).entries()
            == jcpd.BuildLedger(jdir, 0).entries())
    for f in tman["files"]:
        with open(os.path.join(tdir, f), "rb") as a, \
                open(os.path.join(jdir, f), "rb") as b:
            assert a.read() == b.read(), f


@pytest.mark.parametrize("codec", CODECS)
def test_compressed_index_cross_loads(monkeypatch, toy_graph, comp_indexes,
                                      queries, codec):
    """Each package loads and serves the other's compressed index; the
    manifest-less harvest path records the codec too."""
    tdc, jdc, out = comp_indexes
    _, _, tdir, jdir = out[codec]
    rows_t = engine.load_shard_rows(jdir, 0)
    rows_j = jengine.load_shard_rows(tdir, 0, heal=False)
    np.testing.assert_array_equal(rows_t, rows_j)
    np.testing.assert_array_equal(rows_t, _toy_fm(toy_graph))
    for f, meta in jcpd.read_manifest(jdir)["blocks"].items():
        blk, status, _ = cpd.load_verified_block(os.path.join(jdir, f), meta)
        assert status == "ok" and resident.is_container(blk)
    monkeypatch.setenv("DOS_CPD_RESIDENT", codec)
    te = engine.ShardEngine(_tg(toy_graph), tdc, 0, jdir, device="cpu")
    je = jengine.ShardEngine(toy_graph, jdc, 0, tdir)
    _assert_answers(je.answer(queries, JConfig()),
                    te.answer(queries, RuntimeConfig()))
    ledgers: dict = {}
    f0 = cpd.shard_block_name(0, 0)
    os.rename(cpd.ledger_path(tdir, 0), cpd.ledger_path(tdir, 0) + ".off")
    try:
        assert (cpd._block_meta_for(tdir, f0, ledgers)
                == jcpd.read_manifest(jdir)["blocks"][f0])
    finally:
        os.rename(cpd.ledger_path(tdir, 0) + ".off", cpd.ledger_path(tdir, 0))


def test_codec_mismatched_manifest_is_corrupt(comp_indexes, tmp_path):
    _, _, out = comp_indexes
    tman, _, tdir, _ = out["pack4"]
    f0 = tman["files"][0]
    meta = dict(tman["blocks"][f0], codec="rle")
    _, status, reason = cpd.load_verified_block(os.path.join(tdir, f0),
                                                meta)
    jstatus, jreason = jcpd.check_block(os.path.join(tdir, f0), meta)
    assert status == jstatus == "corrupt"
    assert "codec" in reason and "codec" in jreason
    # the same mismatch through a manifest on disk fails the shard load
    d = str(tmp_path)
    for name in os.listdir(tdir):
        with open(os.path.join(tdir, name), "rb") as a, \
                open(os.path.join(d, name), "wb") as b:
            b.write(a.read())
    man = json.load(open(os.path.join(d, "index.json")))
    man["blocks"][f0]["codec"] = "rle"
    with open(os.path.join(d, "index.json"), "w") as f:
        json.dump(man, f)
    with pytest.raises(ValueError, match="corrupt"):
        engine.load_shard_rows(d, 0)


def test_build_cli_codec(toy_graph, comp_indexes, tmp_path):
    from distributed_oracle_search_tpu.data import write_xy

    _, _, out = comp_indexes
    xy = str(tmp_path / "g.xy")
    write_xy(xy, toy_graph.xs, toy_graph.ys, toy_graph.src, toy_graph.dst,
             toy_graph.w)
    d = str(tmp_path / "idx")
    assert wbuild.main(["--input", xy, "--partmethod", "tpu",
                        "--workerid", "0", "--maxworker", "1",
                        "--outdir", d, "--chunk", "16", "--codec", "pack4",
                        "--device", "cpu"]) == 0
    f0 = cpd.shard_block_name(0, 0)
    with open(os.path.join(d, f0), "rb") as a, \
            open(os.path.join(out["pack4"][2], f0), "rb") as b:
        assert a.read() == b.read()
    assert cpd.BuildLedger(d, 0).entries()[f0]["codec"] == "pack4"
