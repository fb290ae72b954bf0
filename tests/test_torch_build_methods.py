"""PyTorch port, every build method end to end on the CPU, held against
the JAX package (ground truth), tolerance exact: first moves byte-equal
per method (each against the JAX build of the same kind and against the
ELL build), and ``build_worker_shard(method=...)``,
``CPDOracle.build(method=...)`` and the ``worker.build --method`` CLI
writing the JAX package's block digests and table for every method."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)

from distributed_oracle_search_tpu.data import (  # noqa: E402
    synth_city_graph as jcity, synth_road_network as jroad,
)
from distributed_oracle_search_tpu.data.graph import Graph as JGraph  # noqa: E402
from distributed_oracle_search_tpu.models import cpd as jcpd  # noqa: E402
from distributed_oracle_search_tpu.ops import (  # noqa: E402
    DeviceGraph as JDeviceGraph, bellman_ford as jbf, ell_split as jes,
    frontier_relax as jfr, grid_sweep as jgs, shift_relax as jsr,
)
from distributed_oracle_search_tpu.parallel.mesh import make_mesh  # noqa: E402
from distributed_oracle_search_tpu.parallel.partition import (  # noqa: E402
    DistributionController as JDC,
)
from distributed_oracle_search_tpu_torch.data.formats import write_xy  # noqa: E402
from distributed_oracle_search_tpu_torch.data.graph import Graph  # noqa: E402
from distributed_oracle_search_tpu_torch.models import cpd  # noqa: E402
from distributed_oracle_search_tpu_torch.ops import (  # noqa: E402
    DeviceGraph, bellman_ford, ell_split, frontier_relax, grid_sweep,
    shift_relax,
)
from distributed_oracle_search_tpu_torch.parallel.partition import (  # noqa: E402
    DistributionController,
)
from distributed_oracle_search_tpu_torch.worker import build as tbuild  # noqa: E402


def _arrays(jg):
    return jg.xs, jg.ys, jg.src, jg.dst, jg.w


def _oneway(w: int = 7, h: int = 5):
    """A ``w x h`` row-major lattice with only rightward and upward
    edges: most pairs are unreachable, and ``grid_split`` fits it."""
    ids = np.arange(w * h)
    right = ids[ids % w < w - 1]
    up = ids[ids // w < h - 1]
    src = np.concatenate([right, up])
    dst = np.concatenate([right + 1, up + w])
    wt = np.random.default_rng(3).integers(1, 50, len(src)).astype(np.int32)
    return ids % w, ids // w, src, dst, wt


GRAPHS = {
    "road": lambda: _arrays(jroad(150, seed=5)),   # degree-skewed
    "city": lambda: _arrays(jcity(12, 9, seed=3)),  # + shortcut planes
    "oneway": _oneway,                              # unreachable pairs
}

#: methods each graph is built with: the road network's ``shift`` and
#: ``sweep`` bundles carry dozens of shift planes, which the JAX program
#: unrolls (minutes of compile); its own kinds are ``ell``/``ellsplit``
FM_CASES = [("road", m) for m in ("ell", "ellsplit", "frontier")] + [
    (g, m) for g in ("city", "oneway")
    for m in ("sweep", "shift", "frontier", "ellsplit", "ell")]


def _pair(name):
    arrays = GRAPHS[name]()
    return JGraph(*arrays), Graph(*arrays)


def _targets(n: int) -> np.ndarray:
    """Every third node, with pad columns in the middle and at the end."""
    t = np.arange(0, n, 3, dtype=np.int32)
    return np.concatenate([t[:5], [-1], t[5:], [-1, -1]]).astype(np.int32)


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def _fm_by_kind(kind, dg, st, t):
    if kind == "ellsplit":
        return ell_split.build_fm_columns_ellsplit(dg, st, t)
    if kind == "shift":
        return shift_relax.build_fm_columns_shift(dg, st, t)
    if kind == "sweep":
        return grid_sweep.build_fm_columns_sweep(dg, st, t)
    if kind == "frontier":
        return frontier_relax.build_fm_columns_frontier(dg, st, t,
                                                        extract_chunk=4)
    return bellman_ford.build_fm_columns(dg, t)


@pytest.mark.parametrize("name,method", FM_CASES)
def test_fm_byte_equal_per_method(name, method):
    jg, tg = _pair(name)
    t = _targets(tg.n)
    jkind, jst = jcpd.pick_build_kernel(jg, method)
    jdg = JDeviceGraph.from_graph(jg)
    ref = {"ell": lambda: jbf.build_fm_columns(jdg, jnp.asarray(t)),
           "ellsplit": lambda: jes.build_fm_columns_ellsplit(jdg, jst, t),
           "shift": lambda: jsr.build_fm_columns_shift(jdg, jst, t),
           "sweep": lambda: jgs.build_fm_columns_sweep(jdg, jst, t),
           "frontier": lambda: jfr.build_fm_columns_frontier(jdg, jst, t)}
    want = np.asarray(ref[jkind]())
    kind, st = cpd.pick_build_kernel(tg, method)
    assert kind == jkind
    dg = DeviceGraph.from_graph(tg, device="cpu")
    _eq(_fm_by_kind(kind, dg, st, t), want)
    _eq(_fm_by_kind(kind, dg, st, t), np.asarray(
        jbf.build_fm_columns(jdg, jnp.asarray(t))))


def _ledger_digests(outdir, wid):
    with open(os.path.join(outdir, f"build-w{wid:05d}.ledger")) as f:
        return sorted((e["file"], e["digest"], tuple(e["shape"]))
                      for e in map(json.loads, f))


METHODS = ["auto", "sweep", "shift", "frontier", "ellsplit", "ell"]


@pytest.fixture(scope="module")
def jax_shard(tmp_path_factory):
    """The JAX package's worker-1 blocks of the city graph (ELL)."""
    arrays = GRAPHS["city"]()
    jg = JGraph(*arrays)
    jdc = JDC("mod", 4, 4, jg.n, block_size=8)
    out = str(tmp_path_factory.mktemp("jax-shard"))
    jcpd.build_worker_shard(jg, jdc, 1, out, chunk=5, method="ell")
    return arrays, _ledger_digests(out, 1)


@pytest.mark.parametrize("method", METHODS)
def test_worker_shard_digests_equal(jax_shard, tmp_path, method):
    arrays, want = jax_shard
    tg = Graph(*arrays)
    dc = DistributionController("mod", 4, 4, tg.n, block_size=8)
    written = cpd.build_worker_shard(tg, dc, 1, str(tmp_path), chunk=5,
                                     device="cpu", method=method)
    assert written and _ledger_digests(str(tmp_path), 1) == want


@pytest.mark.parametrize("method", METHODS)
def test_oracle_build_equal(method):
    arrays = GRAPHS["city"]()
    jg, tg = JGraph(*arrays), Graph(*arrays)
    jo = jcpd.CPDOracle(jg, JDC("tpu", 4, 4, jg.n),
                        mesh=make_mesh(n_workers=4)).build(chunk=32,
                                                           method=method)
    to = cpd.CPDOracle(tg, DistributionController("tpu", 4, 4, tg.n),
                       device="cpu").build(chunk=32, method=method)
    assert to.build_kind == jcpd.pick_build_kernel(jg, method)[0]
    _eq(to.fm, np.asarray(jo.fm))


@pytest.mark.parametrize("method", METHODS)
def test_build_cli_method_digests(jax_shard, tmp_path, method):
    """``worker.build --method`` writes the same block digests for every
    method, equal to the JAX package's."""
    arrays, want = jax_shard
    xy = str(tmp_path / "g.xy")
    write_xy(xy, *arrays)
    out = str(tmp_path / "out")
    rc = tbuild.main(["--input", xy, "--partmethod", "mod", "--partkey", "4",
                      "--workerid", "1", "--maxworker", "4", "--outdir", out,
                      "--chunk", "5", "--block-size", "8", "--device", "cpu",
                      "--method", method])
    assert rc == 0 and _ledger_digests(out, 1) == want


def test_build_cli_refuses_unknown_method(tmp_path):
    with pytest.raises(SystemExit):
        tbuild.main(["--input", "x.xy", "--partmethod", "mod", "--workerid",
                     "0", "--maxworker", "2", "--method", "bogus"])
