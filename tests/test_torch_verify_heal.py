"""PyTorch port, verify and heal: the port's ``check_block``,
``load_verified_block``, ``verify_index``, ``verify_exit_code``,
``heal_block``, the healing ``CPDOracle.load``, ``load_shard_rows`` and
``ShardEngine``, and ``make_cpds --verify/--scrub``, each against the JAX
package's function on identical copies of one index (8 workers of the
8 x 6 toy city, ``block_size`` 4: two blocks a worker) with the same
planted faults. Held exactly: reports, exit codes, the block bytes and
crc32 digests a heal writes, ledgers, manifests and every other file
left in the index directory."""

import json
import os
import shutil
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)

from distributed_oracle_search_tpu.cli import make_cpds as j_make  # noqa: E402
from distributed_oracle_search_tpu.data import Graph as JGraph  # noqa: E402
from distributed_oracle_search_tpu.models import cpd as jcpd  # noqa: E402
from distributed_oracle_search_tpu.parallel.partition import (  # noqa: E402
    DistributionController as JDC,
)
from distributed_oracle_search_tpu.transport.wire import (  # noqa: E402
    RuntimeConfig as JRuntimeConfig,
)
from distributed_oracle_search_tpu.worker import engine as jengine  # noqa: E402
from distributed_oracle_search_tpu_torch.cli import make_cpds as t_make  # noqa: E402
from distributed_oracle_search_tpu_torch.data import (  # noqa: E402
    Graph, synth_city_graph, synth_scenario, write_xy,
)
from distributed_oracle_search_tpu_torch.models import cpd, resident  # noqa: E402
from distributed_oracle_search_tpu_torch.parallel import (  # noqa: E402
    DistributionController,
)
from distributed_oracle_search_tpu_torch.transport import RuntimeConfig  # noqa: E402
from distributed_oracle_search_tpu_torch.utils import atomicio  # noqa: E402
from distributed_oracle_search_tpu_torch.worker import engine  # noqa: E402

W = 8
BS = 4


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The toy city as an ``.xy`` file and a conf over it, with a raw
    and a pack4 index built by the port on the CPU."""
    d = tmp_path_factory.mktemp("verify-heal")
    g0 = synth_city_graph(8, 6, seed=7)
    xy = str(d / "city.xy")
    write_xy(xy, g0.xs, g0.ys, g0.src, g0.dst, g0.w)
    tg, jg = Graph.from_xy(xy), JGraph.from_xy(xy)
    tdc = DistributionController("tpu", W, W, tg.n, block_size=BS)
    jdc = JDC("tpu", W, W, jg.n, block_size=BS)
    indexes = {}
    for codec in ("raw", "pack4"):
        out = str(d / f"index-{codec}")
        for wid in range(W):
            cpd.build_worker_shard(tg, tdc, wid, out, device="cpu",
                                   codec=codec)
        man = cpd.write_index_manifest(out, tdc)
        if codec != "raw":
            assert {m.get("codec") for m in man["blocks"].values()} == {
                codec}
        indexes[codec] = out
    return {"d": d, "xy": xy, "tg": tg, "jg": jg, "tdc": tdc, "jdc": jdc,
            "index": indexes}


def _pair(world, tmp_path, codec="raw"):
    """Two identical copies of one index: (JAX's, the port's)."""
    src = world["index"][codec]
    j, t = str(tmp_path / "j"), str(tmp_path / "t")
    shutil.copytree(src, j)
    shutil.copytree(src, t)
    return j, t


def _tree(d):
    """Every file under ``d`` by name, with its bytes."""
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            out[name] = f.read()
    return out


def _same_tree(j, t):
    a, b = _tree(j), _tree(t)
    assert sorted(a) == sorted(b)
    for name in a:
        assert a[name] == b[name], name


def _norm(obj, *dirs):
    """A report with the index directories' paths masked out."""
    s = json.dumps(obj, sort_keys=True)
    for d in dirs:
        s = s.replace(d, "<index>")
    return json.loads(s)


def _crc(path):
    with open(path, "rb") as f:
        return f"crc32:{zlib.crc32(f.read()) & 0xFFFFFFFF:08x}"


# ---------------------------------------------------------------- faults

def _torn(path):
    with open(path, "rb") as f:
        data = f.read()
    with open(path, "wb") as f:
        f.write(data[:len(data) // 2])


def _flip(path, off=-1):
    with open(path, "r+b") as f:
        f.seek(off, os.SEEK_END if off < 0 else os.SEEK_SET)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0x55]))


def _edit_manifest(d, fn):
    p = os.path.join(d, "index.json")
    with open(p) as f:
        man = json.load(f)
    fn(man)
    with open(p, "w") as f:
        json.dump(man, f)


def _redigest(d, fname):
    """Make the manifest's digest of ``fname`` match its bytes again."""
    def fn(man):
        man["blocks"][fname]["digest"] = _crc(os.path.join(d, fname))
    _edit_manifest(d, fn)


def _container_header_torn(d, fname):
    """A container whose magic holds but whose header length runs past
    the payload: the digest is refreshed, so only the header check can
    see it."""
    p = os.path.join(d, fname)
    arr = np.load(p)
    arr[len(resident.BLOCK_MAGIC):len(resident.BLOCK_MAGIC) + 4] = 0xFF
    np.save(p, arr)
    _redigest(d, fname)


def _container_header_not_object(d, fname):
    """A container whose header is valid JSON but no object (``[1]``), of
    the original's length: digest refreshed, shape and dtype as the
    manifest records them, so only the codec check reads the header."""
    p = os.path.join(d, fname)
    size = np.load(p).shape[0]
    head = resident.BLOCK_MAGIC + (3).to_bytes(4, "little") + b"[1]"
    np.save(p, np.frombuffer(head + bytes(size - len(head)), np.uint8))
    _redigest(d, fname)


B3 = cpd.shard_block_name(3, 1)
B5 = cpd.shard_block_name(5, 0)
B6 = cpd.shard_block_name(6, 0)

FAULTS = {
    "torn": ("raw", lambda d: _torn(os.path.join(d, B3))),
    "missing": ("raw", lambda d: os.remove(os.path.join(d, B5))),
    "digest": ("raw", lambda d: _flip(os.path.join(d, B6))),
    "shape": ("raw", lambda d: _edit_manifest(
        d, lambda m: m["blocks"][B3].update(shape=[3, 48]))),
    "dtype": ("raw", lambda d: _edit_manifest(
        d, lambda m: m["blocks"][B3].update(dtype="uint8"))),
    "all-four": ("raw", lambda d: (
        _torn(os.path.join(d, B3)), os.remove(os.path.join(d, B5)),
        _flip(os.path.join(d, B6)))),
    "pack4-header-torn": ("pack4",
                          lambda d: _container_header_torn(d, B3)),
    "pack4-header-not-object": (
        "pack4", lambda d: _container_header_not_object(d, B3)),
    "pack4-codec-differs": ("pack4", lambda d: _edit_manifest(
        d, lambda m: m["blocks"][B3].update(codec="rle"))),
    "manifest-unreadable": ("raw", lambda d: open(
        os.path.join(d, "index.json"), "w").write("{torn")),
    "manifest-mismatch": ("raw", lambda d: _edit_manifest(
        d, lambda m: m.update(partmethod="mod"))),
    "v1-no-digests": ("raw", lambda d: _edit_manifest(
        d, lambda m: (m.update(version=1), m.pop("digest_algo"),
                      m.pop("blocks")))),
    "v1-and-torn": ("raw", lambda d: (_edit_manifest(
        d, lambda m: (m.update(version=1), m.pop("blocks"))),
        _torn(os.path.join(d, B3)))),
    "every-block-missing": ("raw", lambda d: [
        os.remove(os.path.join(d, f)) for f in os.listdir(d)
        if f.endswith(".npy")]),
}
WANT_EXIT = {"torn": 3, "missing": 3, "digest": 3, "shape": 3, "dtype": 3,
             "all-four": 3, "pack4-header-torn": 3,
             "pack4-header-not-object": 3, "pack4-codec-differs": 3,
             "manifest-unreadable": 4, "manifest-mismatch": 4,
             "v1-no-digests": 0, "v1-and-torn": 3,
             "every-block-missing": 4}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_verify_report_equals_jax(world, tmp_path, fault):
    codec, plant = FAULTS[fault]
    j, t = _pair(world, tmp_path, codec)
    plant(j)
    plant(t)
    want = jcpd.verify_index(j, dc=world["jdc"])
    got = cpd.verify_index(t, dc=world["tdc"])
    assert _norm(got, t) == _norm(want, j)
    assert cpd.verify_exit_code(got) == jcpd.verify_exit_code(want) \
        == WANT_EXIT[fault]
    if fault == "all-four":
        assert got["missing"] == [B5]
        assert [c["file"] for c in got["corrupt"]] == [B3, B6]
    # block by block, with the manifest's entry and without one
    try:
        blocks = jcpd.read_manifest(j).get("blocks", {})
    except ValueError:
        blocks = {}
    for fname in sorted(f for f in os.listdir(j) if f.endswith(".npy")) \
            + [B5]:
        for meta in (blocks.get(fname), None):
            assert cpd.check_block(os.path.join(t, fname), meta) == \
                jcpd.check_block(os.path.join(j, fname), meta)
            rows_t, *st_t = cpd.load_verified_block(os.path.join(t, fname),
                                                    meta)
            rows_j, *st_j = jcpd.load_verified_block(
                os.path.join(j, fname), meta)
            assert st_t == st_j
            assert (rows_t is None) == (rows_j is None)
            if rows_t is not None:
                np.testing.assert_array_equal(rows_t, rows_j)
    _same_tree(j, t)


def test_torn_container_header_reports_corrupt(world, tmp_path):
    """A container header that parses to no JSON object: JAX reports the
    block corrupt, and so does the port — from the check and the load,
    with the manifest's codec and without it — never a traceback."""
    j, t = _pair(world, tmp_path, "pack4")
    _container_header_not_object(t, B3)
    path = os.path.join(t, B3)
    for meta in ({"codec": "pack4"}, cpd.read_manifest(t)["blocks"][B3]):
        status, reason = cpd.check_block(path, meta)
        assert status == "corrupt" and "AttributeError" in reason
        rows, status, reason = cpd.load_verified_block(path, meta)
        assert rows is None and status == "corrupt"
        assert jcpd.check_block(path, meta) == cpd.check_block(path, meta)


# ------------------------------------------------------------------ heal

@pytest.mark.parametrize("fault", ["torn", "missing", "digest"])
def test_heal_block_equals_jax_and_the_original(world, tmp_path, fault):
    codec, plant = FAULTS[fault]
    j, t = _pair(world, tmp_path, codec)
    fname = {"torn": B3, "missing": B5, "digest": B6}[fault]
    wid = int(fname.split("-")[1][1:])
    with open(os.path.join(t, fname), "rb") as f:
        original = f.read()
    before = _tree(t)["index.json"]
    plant(j)
    plant(t)
    r0 = cpd.COUNTERS["cpd_blocks_rebuilt_total"]
    rows_j = jcpd.heal_block(j, jcpd.read_manifest(j), fname, wid,
                             world["jg"], world["jdc"])
    rows_t = cpd.heal_block(t, cpd.read_manifest(t), fname, wid,
                            world["tg"], world["tdc"], device="cpu")
    assert cpd.COUNTERS["cpd_blocks_rebuilt_total"] == r0 + 1
    np.testing.assert_array_equal(rows_t, rows_j)
    with open(os.path.join(t, fname), "rb") as f:
        assert f.read() == original
    # the rebuilt digest is the recorded one: the manifest is untouched
    assert _tree(t)["index.json"] == before
    assert os.path.exists(os.path.join(t, fname + ".quarantined")) == (
        fault != "missing")
    _same_tree(j, t)


def test_oracle_load_heals_equal_to_jax(world, tmp_path):
    j, t = _pair(world, tmp_path)
    want = cpd.CPDOracle(world["tg"], world["tdc"], device="cpu").load(t)
    for d in (j, t):
        FAULTS["all-four"][1](d)
    c0 = dict(cpd.COUNTERS)
    got = cpd.CPDOracle(world["tg"], world["tdc"], device="cpu").load(t)
    jo = jcpd.CPDOracle(world["jg"], world["jdc"]).load(j)
    assert torch.equal(got.fm, want.fm)
    np.testing.assert_array_equal(got.fm.numpy(), np.asarray(jo.fm))
    n = len(cpd.read_manifest(t)["files"])
    delta = {k: cpd.COUNTERS[k] - c0[k] for k in c0}
    assert delta["cpd_blocks_corrupt_total"] == 3
    assert delta["cpd_blocks_rebuilt_total"] == 3
    assert delta["cpd_blocks_verified_total"] == n - 3
    for f in (B3, B6):
        assert os.path.exists(os.path.join(t, f + ".quarantined"))
    _same_tree(j, t)
    assert cpd.verify_exit_code(cpd.verify_index(t, world["tdc"])) == 0
    # healed in place: a second load rebuilds nothing
    cpd.CPDOracle(world["tg"], world["tdc"], device="cpu").load(t)
    assert cpd.COUNTERS["cpd_blocks_rebuilt_total"] == \
        c0["cpd_blocks_rebuilt_total"] + 3


@pytest.mark.parametrize("fault", ["torn", "missing"])
def test_oracle_load_without_heal_raises(world, tmp_path, fault):
    _, t = _pair(world, tmp_path)
    FAULTS[fault][1](t)
    fname = {"torn": B3, "missing": B5}[fault]
    status = "missing" if fault == "missing" else "corrupt"
    with pytest.raises(ValueError, match=f"{fname} in .* is {status}"):
        cpd.CPDOracle(world["tg"], world["tdc"], device="cpu").load(
            t, heal=False)
    assert not os.path.exists(os.path.join(t, fname + ".quarantined"))


def test_load_shard_rows_heals_and_refreshes_manifest_once(world,
                                                           tmp_path):
    """A rebuilt block whose digest differs from the manifest's (an index
    recorded by another build) refreshes the manifest entry, so the next
    load of either path rebuilds nothing (no churn)."""
    j, t = _pair(world, tmp_path)
    fname = cpd.shard_block_name(6, 0)
    for d in (j, t):
        _edit_manifest(d, lambda m: m["blocks"][fname].update(
            digest="crc32:00000000"))
    r0 = cpd.COUNTERS["cpd_blocks_rebuilt_total"]
    rows_j = jengine.load_shard_rows(j, 6, dc=world["jdc"],
                                     graph=world["jg"])
    rows_t = engine.load_shard_rows(t, 6, dc=world["tdc"],
                                    graph=world["tg"], device="cpu")
    np.testing.assert_array_equal(rows_t, rows_j)
    assert cpd.COUNTERS["cpd_blocks_rebuilt_total"] == r0 + 1
    _same_tree(j, t)
    assert cpd.read_manifest(t)["blocks"][fname]["digest"] == _crc(
        os.path.join(t, fname))
    assert cpd.verify_exit_code(cpd.verify_index(t, world["tdc"])) == 0
    engine.load_shard_rows(t, 6, dc=world["tdc"], graph=world["tg"],
                           device="cpu")
    cpd.CPDOracle(world["tg"], world["tdc"], device="cpu").load(t)
    assert cpd.COUNTERS["cpd_blocks_rebuilt_total"] == r0 + 1


@pytest.fixture(scope="module")
def comp_world(tmp_path_factory):
    """A 12 x 10 lattice (no shortcuts) split ``div`` over 2 workers in
    32-row blocks: rows of nearby targets share long runs, so both pack4
    and rle take every block. A raw, a pack4 and an rle index."""
    d = tmp_path_factory.mktemp("verify-heal-comp")
    g = synth_city_graph(12, 10, seed=7, shortcut_frac=0.0)
    tdc = DistributionController("div", 60, 2, g.n, block_size=32)
    jdc = JDC("div", 60, 2, g.n, block_size=32)
    jg = JGraph(g.xs, g.ys, g.src, g.dst, g.w)
    out = {}
    for codec in ("raw", "pack4", "rle"):
        out[codec] = str(d / codec)
        for wid in range(2):
            cpd.build_worker_shard(g, tdc, wid, out[codec], device="cpu",
                                   codec=codec)
        man = cpd.write_index_manifest(out[codec], tdc)
        assert {m.get("codec") for m in man["blocks"].values()} == {
            None if codec == "raw" else codec}
    return {"tg": g, "jg": jg, "tdc": tdc, "jdc": jdc, "index": out}


@pytest.mark.parametrize("codec", ["pack4", "rle"])
def test_compressed_index_heals_keeping_its_codec(comp_world, tmp_path,
                                                  codec):
    """A torn container is quarantined and rebuilt as a container of the
    manifest's codec (not the process's ``DOS_CPD_RESIDENT``), equal to
    the JAX heal's bytes and to the original."""
    j, t = _pair(comp_world, tmp_path, codec)
    fname = cpd.shard_block_name(1, 1)
    with open(os.path.join(t, fname), "rb") as f:
        original = f.read()
    for d in (j, t):
        _torn(os.path.join(d, fname))
    dc = comp_world["tdc"]
    assert cpd.verify_exit_code(cpd.verify_index(t, dc)) == 3
    rows_j = jengine.load_shard_rows(j, 1, dc=comp_world["jdc"],
                                     graph=comp_world["jg"])
    rows_t = engine.load_shard_rows(t, 1, dc=dc, graph=comp_world["tg"],
                                    device="cpu")
    np.testing.assert_array_equal(rows_t, rows_j)
    np.testing.assert_array_equal(
        rows_t, engine.load_shard_rows(comp_world["index"]["raw"], 1))
    with open(os.path.join(t, fname), "rb") as f:
        assert f.read() == original
    assert resident.block_codec(np.load(os.path.join(t, fname))) == codec
    assert cpd.read_manifest(t)["blocks"][fname]["codec"] == codec
    assert cpd.verify_exit_code(cpd.verify_index(t, dc)) == 0
    _same_tree(j, t)


def test_load_without_graph_is_degraded(world, tmp_path):
    _, t = _pair(world, tmp_path)
    _flip(os.path.join(t, B5))
    with pytest.raises(ValueError, match="load degraded"):
        engine.load_shard_rows(t, 5)
    with pytest.raises(ValueError, match="healing disabled"):
        engine.load_shard_rows(t, 5, dc=world["tdc"], graph=world["tg"],
                               heal=False, device="cpu")
    assert not os.path.exists(os.path.join(t, B5 + ".quarantined"))


def test_engine_heals_and_answers_as_jax(world, tmp_path):
    j, t = _pair(world, tmp_path)
    for d in (j, t):
        _torn(os.path.join(d, cpd.shard_block_name(3, 0)))
    c0 = cpd.COUNTERS["cpd_blocks_rebuilt_total"]
    te = engine.ShardEngine(world["tg"], world["tdc"], 3, t, device="cpu")
    je = jengine.ShardEngine(world["jg"], world["jdc"], 3, j)
    assert cpd.COUNTERS["cpd_blocks_rebuilt_total"] == c0 + 1
    _same_tree(j, t)
    owned = world["tdc"].owned(3)
    q = synth_scenario(world["tg"].n, 40, seed=3)
    q[:, 1] = owned[q[:, 1] % len(owned)]
    for cfg in ({}, {"k_moves": 5, "extract": True}):
        got = te.answer(q, RuntimeConfig(**cfg))
        want = je.answer(q, JRuntimeConfig(**cfg))
        for a, b in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(a, b)
        if not cfg:
            assert bool(got[2].all())


def test_quarantine(tmp_path):
    p = str(tmp_path / "x.npy")
    assert atomicio.quarantine(p) is None
    with open(p, "wb") as f:
        f.write(b"bad")
    q = atomicio.quarantine(p)
    assert q == p + atomicio.QUARANTINE_SUFFIX
    assert not os.path.exists(p) and open(q, "rb").read() == b"bad"


# ------------------------------------------------------------------- CLI

def _conf(world, d, index):
    path = os.path.join(d, "conf.json")
    with open(path, "w") as f:
        json.dump({"workers": [f"tpu:{i}" for i in range(W)],
                   "partmethod": "tpu", "partkey": W, "outdir": index,
                   "xy_file": world["xy"], "scenfile": "",
                   "diffs": ["-"]}, f)
    return path


@pytest.mark.parametrize("fault", ["none", "all-four",
                                   "manifest-unreadable", "v1-no-digests"])
@pytest.mark.parametrize("flag", [["--verify"],
                                  ["--scrub", "--scrub-passes", "2",
                                   "--scrub-interval", "0"]])
def test_make_cpds_verify_cli_equals_jax(world, tmp_path, capsys, fault,
                                         flag):
    """Both CLIs on one faulted index: the same JSON report line and the
    same exit code (a scrub prints one line a pass)."""
    index = str(tmp_path / "index")
    shutil.copytree(world["index"]["raw"], index)
    if fault != "none":
        FAULTS[fault][1](index)
    conf = _conf(world, str(tmp_path), index)
    capsys.readouterr()
    rc_j = j_make.main(["-c", conf, *flag])
    out_j = capsys.readouterr().out
    rc_t = t_make.main(["-c", conf, *flag])
    out_t = capsys.readouterr().out
    assert rc_t == rc_j == {"none": 0}.get(fault, WANT_EXIT.get(fault))
    assert out_t == out_j
    lines = out_t.strip().splitlines()
    assert len(lines) == (2 if "--scrub" in flag else 1)
    assert json.loads(lines[-1])["exit_code"] == rc_t
    assert not os.path.exists(os.path.join(index, B3 + ".quarantined"))
