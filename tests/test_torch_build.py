"""PyTorch port, CPD build: the torch Bellman-Ford + first-move build is
byte-identical to the JAX ``build_fm_columns`` and to the CPU oracle's
``first_move_matrix`` (weight ties, unreachable nodes, pad targets), and
port-built worker blocks carry the same crc32 digests as JAX-built ones
in an ``index.json`` either package loads."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from distributed_oracle_search_tpu.data.graph import Graph as JGraph  # noqa: E402
from distributed_oracle_search_tpu.data.synth import synth_city_graph  # noqa: E402
from distributed_oracle_search_tpu.models import cpd as jcpd  # noqa: E402
from distributed_oracle_search_tpu.models.reference import first_move_matrix  # noqa: E402
from distributed_oracle_search_tpu.ops import bellman_ford as jbf  # noqa: E402
from distributed_oracle_search_tpu.ops import DeviceGraph as JDeviceGraph  # noqa: E402
from distributed_oracle_search_tpu.parallel.partition import (  # noqa: E402
    DistributionController as JDC,
)
from distributed_oracle_search_tpu.worker import engine as jengine  # noqa: E402
from distributed_oracle_search_tpu_torch.data.graph import Graph  # noqa: E402
from distributed_oracle_search_tpu_torch.models import cpd  # noqa: E402
from distributed_oracle_search_tpu_torch.ops import (  # noqa: E402
    DeviceGraph, bellman_ford,
)
from distributed_oracle_search_tpu_torch.parallel.partition import (  # noqa: E402
    DistributionController,
)
from distributed_oracle_search_tpu_torch.worker import engine  # noqa: E402


def _tie_grid():
    """5x4 grid, every weight 1: many equal-cost first moves."""
    w, h = 5, 4
    ids = np.arange(w * h)
    right = ids[ids % w < w - 1]
    up = ids[ids // w < h - 1]
    su = np.concatenate([right, up])
    sv = np.concatenate([right + 1, up + w])
    src, dst = np.concatenate([su, sv]), np.concatenate([sv, su])
    return ids % w, ids // w, src, dst, np.ones(len(src), np.int32)


def _two_cycles():
    """Two directed 4-cycles with no edge between them."""
    n = 8
    return (np.arange(n), np.zeros(n), np.arange(n),
            np.array([1, 2, 3, 0, 5, 6, 7, 4]), np.full(8, 10, np.int32))


def _city():
    g = synth_city_graph(8, 6, seed=7)
    return g.xs, g.ys, g.src, g.dst, g.w


GRAPHS = {"city": _city, "ties": _tie_grid, "unreachable": _two_cycles}


def _pair(name):
    arrays = GRAPHS[name]()
    return JGraph(*arrays), Graph(*arrays)


def _targets(n):
    """Every node, then pad rows (< 0) in the middle and at the end."""
    t = np.arange(n, dtype=np.int32)
    return np.concatenate([t[: n // 2], [-1], t[n // 2:], [-1, -1]]
                          ).astype(np.int32)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_build_fm_columns_byte_identical(name):
    jg, tg = _pair(name)
    targets = _targets(tg.n)
    want = np.asarray(jbf.build_fm_columns(JDeviceGraph.from_graph(jg),
                                           jnp.asarray(targets)))
    got = bellman_ford.build_fm_columns(
        DeviceGraph.from_graph(tg, device="cpu"), targets)
    assert got.dtype == torch.int8 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    valid = targets >= 0
    np.testing.assert_array_equal(got.numpy()[valid],
                                  first_move_matrix(jg, targets[valid]))
    assert (got.numpy()[~valid] == -1).all()


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("max_iters", [0, 1, 3])
def test_dist_and_first_moves_identical(name, max_iters):
    """Jacobi iteration: even a cut-short build stops at the JAX
    loop's distances."""
    jg, tg = _pair(name)
    targets = _targets(tg.n)
    jdg = JDeviceGraph.from_graph(jg)
    tdg = DeviceGraph.from_graph(tg, device="cpu")
    jd = jbf.dist_to_targets(jdg, jnp.asarray(targets), max_iters=max_iters)
    td = bellman_ford.dist_to_targets(tdg, targets, max_iters=max_iters)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(
        bellman_ford.first_move_from_dist(tdg, targets, td).numpy(),
        np.asarray(jbf.first_move_from_dist(jdg, jnp.asarray(targets), jd)))


def test_unreachable_rows_are_minus_one():
    _, tg = _pair("unreachable")
    fm = bellman_ford.build_fm_columns(
        DeviceGraph.from_graph(tg, device="cpu"), np.arange(8)).numpy()
    assert (fm[0, 4:] == -1).all() and (fm[5, :4] == -1).all()
    assert (np.diag(fm) == -1).all()


# --------------------------------------------------- blocks + manifest

@pytest.fixture(scope="module")
def both_indexes(tmp_path_factory):
    g = synth_city_graph(8, 6, seed=7)
    tg = Graph(g.xs, g.ys, g.src, g.dst, g.w)
    jdc = JDC("mod", 3, 3, g.n, block_size=7)
    tdc = DistributionController("mod", 3, 3, g.n, block_size=7)
    jdir = str(tmp_path_factory.mktemp("jax-index"))
    tdir = str(tmp_path_factory.mktemp("torch-index"))
    for wid in range(3):
        jcpd.build_worker_shard(g, jdc, wid, jdir, chunk=4, method="ell")
        cpd.build_worker_shard(tg, tdc, wid, tdir, chunk=4, device="cpu")
    return g, tg, jdc, tdc, jdir, tdir


def test_blocks_and_digests_identical(both_indexes):
    _, _, _, _, jdir, tdir = both_indexes
    for wid in range(3):
        je = jcpd.BuildLedger(jdir, wid).entries()
        te = cpd.BuildLedger(tdir, wid).entries()
        assert je and je == te
    jfiles = sorted(f for f in os.listdir(jdir) if f.endswith(".npy"))
    tfiles = sorted(f for f in os.listdir(tdir) if f.endswith(".npy"))
    assert jfiles == tfiles and len(jfiles) == 3 * 3
    for f in jfiles:
        with open(os.path.join(jdir, f), "rb") as a, \
                open(os.path.join(tdir, f), "rb") as b:
            assert a.read() == b.read(), f


def test_manifest_loads_under_either_package(both_indexes):
    g, tg, jdc, tdc, jdir, tdir = both_indexes
    tman = cpd.write_index_manifest(tdir, tdc)
    jman = jcpd.write_index_manifest(jdir, jdc)
    assert tman == jman
    # port-built index, JAX reader (digests verified: status ok)
    jcpd.validate_manifest(jcpd.read_manifest(tdir), jdc, tdir)
    for wid in range(3):
        rows_j = jengine.load_shard_rows(tdir, wid, heal=False)
        rows_t = engine.load_shard_rows(jdir, wid)
        np.testing.assert_array_equal(rows_j, rows_t)
        for f in tman["files"]:
            _, status, _ = cpd.load_verified_block(
                os.path.join(jdir, f), jman["blocks"][f])
            assert status == "ok"
    cpd.validate_manifest(cpd.read_manifest(jdir), tdc, jdir)


def test_resume_skips_digest_valid_blocks(both_indexes):
    _, tg, _, tdc, _, tdir = both_indexes
    assert cpd.build_worker_shard(tg, tdc, 0, tdir, chunk=4,
                                  device="cpu") == []


def test_corrupt_and_compressed_blocks_raise(tmp_path):
    g = synth_city_graph(4, 3, seed=1)
    tg = Graph(g.xs, g.ys, g.src, g.dst, g.w)
    dc = DistributionController("mod", 2, 2, g.n)
    out = str(tmp_path)
    cpd.build_worker_shard(tg, dc, 0, out, device="cpu")
    cpd.write_index_manifest(out, dc, workers=[0])
    path = os.path.join(out, cpd.shard_block_name(0, 0))
    with open(path, "r+b") as f:
        f.seek(-1, os.SEEK_END)
        f.write(b"\x05")
    with pytest.raises(ValueError, match="corrupt"):
        engine.load_shard_rows(out, 0)
    meta = {"digest": "crc32:00000000", "codec": "pack4"}
    with pytest.raises(NotImplementedError, match="not ported"):
        cpd.load_verified_block(path, meta)
    container = np.frombuffer(cpd.BLOCK_MAGIC + bytes(16), np.uint8)
    np.save(path, container)
    with pytest.raises(NotImplementedError, match="not ported"):
        cpd.load_verified_block(path, None)
    with open(os.path.join(out, "index.json")) as f:
        assert json.load(f)["version"] == cpd.INDEX_VERSION
