"""PyTorch port, replicas: the replica-aware names and ledgers,
``build_worker_shard(resume=, replica=)``, ``copy_replica_blocks``,
``build_replica_shards``, the replicated ``write_index_manifest``,
``anti_entropy``, ``adopt_shard_blocks``, ``worker.build --no-resume
--replication/--adopt-shard``, ``make_cpds --backend host`` at R = 2, and
a ``FifoServer`` answering a batch for a shard it hosts as a replica —
each against the JAX package's function on identical copies of one index
(4 workers of the 8 x 6 toy city, ``mod``, ``block_size`` 4: three
blocks a worker). Held exactly: reports, files, ledgers and manifests."""

import json
import os
import shlex
import shutil
import sys

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
from distributed_oracle_search_tpu.worker import build as j_wbuild  # noqa: E402
from distributed_oracle_search_tpu_torch.cli import make_cpds as t_make  # noqa: E402
from distributed_oracle_search_tpu_torch.data import (  # noqa: E402
    Graph, synth_city_graph, synth_scenario, write_xy,
)
from distributed_oracle_search_tpu_torch.models import cpd, resident  # noqa: E402
from distributed_oracle_search_tpu_torch.parallel import (  # noqa: E402
    DistributionController,
)
from distributed_oracle_search_tpu_torch.transport import RuntimeConfig  # noqa: E402
from distributed_oracle_search_tpu_torch.utils.config import (  # noqa: E402
    ClusterConfig,
)
from distributed_oracle_search_tpu_torch.worker import build as t_wbuild  # noqa: E402
from distributed_oracle_search_tpu_torch.worker import server as t_server  # noqa: E402
from distributed_oracle_search_tpu_torch.worker.engine import ShardEngine  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W = 4
BS = 4


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The toy city as an ``.xy`` file; its primaries built by the port
    (raw and pack4), and the R = 2 controllers of both packages."""
    d = tmp_path_factory.mktemp("replicas")
    g0 = synth_city_graph(8, 6, seed=7)
    xy = str(d / "city.xy")
    write_xy(xy, g0.xs, g0.ys, g0.src, g0.dst, g0.w)
    tg, jg = Graph.from_xy(xy), JGraph.from_xy(xy)
    tdc = DistributionController("mod", W, W, tg.n, block_size=BS,
                                 replication=2)
    jdc = JDC("mod", W, W, jg.n, block_size=BS, replication=2)
    prim = {}
    for codec in ("raw", "pack4"):
        prim[codec] = str(d / f"primaries-{codec}")
        for wid in range(W):
            cpd.build_worker_shard(tg, tdc, wid, prim[codec], device="cpu",
                                   codec=codec)
    return {"d": d, "xy": xy, "tg": tg, "jg": jg, "tdc": tdc, "jdc": jdc,
            "prim": prim}


def _pair(src, tmp_path):
    j, t = str(tmp_path / "j"), str(tmp_path / "t")
    shutil.copytree(src, j)
    shutil.copytree(src, t)
    return j, t


def _tree(d):
    out = {}
    for name in sorted(os.listdir(d)):
        p = os.path.join(d, name)
        if os.path.isfile(p):
            with open(p, "rb") as f:
                out[name] = f.read()
    return out


def _same_tree(j, t):
    a, b = _tree(j), _tree(t)
    assert sorted(a) == sorted(b)
    for name in a:
        assert a[name] == b[name], name


def _replicate(world, j, t, hosts=range(W)):
    """``build_replica_shards`` for each host, in both packages."""
    out = []
    for host in hosts:
        want = jcpd.build_replica_shards(world["jg"], world["jdc"], host, j)
        got = cpd.build_replica_shards(world["tg"], world["tdc"], host, t,
                                       device="cpu")
        assert got == want
        out.append(got)
    return out


@pytest.fixture()
def replicated(world, tmp_path):
    """Two identical R = 2 indexes (primaries, replicas, manifest)."""
    j, t = _pair(world["prim"]["raw"], tmp_path)
    _replicate(world, j, t)
    jcpd.write_index_manifest(j, world["jdc"])
    cpd.write_index_manifest(t, world["tdc"])
    _same_tree(j, t)
    return j, t


# ------------------------------------------------------------------ names

@pytest.mark.parametrize("wid,bid,replica", [
    (0, 0, 0), (3, 12, 0), (7, 1, 1), (12345, 99999, 2), (5, 0, 31)])
def test_names_equal_jax(wid, bid, replica):
    name = cpd.shard_block_name(wid, bid, replica)
    assert name == jcpd.shard_block_name(wid, bid, replica)
    assert cpd.block_file_replica(name) == jcpd.block_file_replica(
        name) == replica
    assert cpd.ledger_path("/x", wid, replica) == jcpd.ledger_path(
        "/x", wid, replica)
    assert cpd.BuildLedger("/x", wid, replica).path == jcpd.BuildLedger(
        "/x", wid, replica).path
    if replica == 0:
        assert cpd.shard_block_name(wid, bid) == name


# ------------------------------------------------------------------ build

@pytest.mark.parametrize("resume", [True, False])
def test_build_resume_and_replica_equal_jax(world, tmp_path, resume):
    """``resume=False`` recomputes every block (and journals it again);
    ``replica=r`` writes the rank-r set under its own ledger."""
    j, t = _pair(world["prim"]["raw"], tmp_path)
    r0 = cpd.COUNTERS["build_blocks_resumed_total"]
    for wid in range(W):
        want = jcpd.build_worker_shard(world["jg"], world["jdc"], wid, j,
                                       resume=resume)
        got = cpd.build_worker_shard(world["tg"], world["tdc"], wid, t,
                                     device="cpu", resume=resume)
        assert got == want
        assert len(got) == (0 if resume else 3)
    assert cpd.COUNTERS["build_blocks_resumed_total"] - r0 == (
        3 * W if resume else 0)
    got = cpd.build_worker_shard(world["tg"], world["tdc"], 1, t,
                                 device="cpu", replica=1, resume=resume)
    want = jcpd.build_worker_shard(world["jg"], world["jdc"], 1, j,
                                   replica=1, resume=resume)
    assert got == want == [cpd.shard_block_name(1, b, 1) for b in range(3)]
    for b in range(3):
        with open(os.path.join(t, cpd.shard_block_name(1, b)), "rb") as p, \
                open(os.path.join(t, cpd.shard_block_name(1, b, 1)),
                     "rb") as r:
            assert p.read() == r.read()
    _same_tree(j, t)


# --------------------------------------------------------------- replicas

@pytest.mark.parametrize("codec", ["raw", "pack4"])
def test_replica_sets_copy_equal_jax(world, tmp_path, codec):
    """Every primary digest-valid: every replica block is a copy (a
    compressed primary's container verbatim), no recompute."""
    j, t = _pair(world["prim"][codec], tmp_path)
    c0 = cpd.COUNTERS["replica_blocks_copied_total"]
    outs = _replicate(world, j, t)
    assert outs[2] == {1: [cpd.shard_block_name(1, b, 1) for b in range(3)]}
    assert cpd.COUNTERS["replica_blocks_copied_total"] - c0 == 3 * W
    _same_tree(j, t)
    # resumed: nothing copied twice
    assert cpd.copy_replica_blocks(world["tdc"], 1, 1, t) == []
    assert jcpd.copy_replica_blocks(world["jdc"], 1, 1, j) == []
    for b in range(3):
        name = cpd.shard_block_name(1, b, 1)
        prim = np.load(os.path.join(t, cpd.shard_block_name(1, b)))
        assert resident.is_container(prim) == (codec == "pack4")
        np.testing.assert_array_equal(np.load(os.path.join(t, name)), prim)


@pytest.mark.parametrize("codec", ["raw", "pack4"])
def test_replica_recompute_keeps_the_primary_codec(world, tmp_path, codec):
    """A primary that cannot be copied (torn, missing) is recomputed
    from the graph with the primary's codec — bytes equal to the
    primary's, and to JAX's."""
    j, t = _pair(world["prim"][codec], tmp_path)
    torn = cpd.shard_block_name(2, 1)
    gone = cpd.shard_block_name(2, 2)
    originals = {}
    for d in (j, t):
        for name in (torn, gone):
            with open(os.path.join(d, name), "rb") as f:
                originals[name] = f.read()
        with open(os.path.join(d, torn), "r+b") as f:
            f.truncate(40)
        os.remove(os.path.join(d, gone))
    got = cpd.build_replica_shards(world["tg"], world["tdc"], 3, t,
                                   device="cpu")
    want = jcpd.build_replica_shards(world["jg"], world["jdc"], 3, j)
    assert got == want == {2: [cpd.shard_block_name(2, b, 1)
                               for b in range(3)]}
    for b, name in ((1, torn), (2, gone)):
        with open(os.path.join(t, cpd.shard_block_name(2, b, 1)),
                  "rb") as f:
            assert f.read() == originals[name]
    assert cpd._primary_codec(t, 2) == jcpd._primary_codec(j, 2) == codec
    _same_tree(j, t)


def test_manifest_r2_and_r1_equal_jax(world, replicated, tmp_path):
    j, t = replicated
    man = cpd.read_manifest(t)
    assert man["replication"] == 2
    assert len(man["replica_files"]) == 3 * W
    for rf in man["replica_files"]:
        prim = rf.replace("-r01", "")
        assert man["blocks"][rf]["digest"] == man["blocks"][prim]["digest"]
    rep = cpd.verify_index(t, dc=world["tdc"])
    assert rep["ok"] == rep["total"] == 6 * W
    # R = 1 over the same directory: no replica keys, byte-equal to JAX
    r1 = DistributionController("mod", W, W, world["tg"].n, block_size=BS)
    m1 = cpd.write_index_manifest(t, r1)
    jcpd.write_index_manifest(j, JDC("mod", W, W, world["jg"].n,
                                     block_size=BS))
    assert "replication" not in m1 and "replica_files" not in m1
    assert sorted(m1["blocks"]) == m1["files"]
    _same_tree(j, t)
    # a missing replica leaves the R = 2 index incomplete
    os.remove(os.path.join(t, cpd.shard_block_name(0, 1, 1)))
    with pytest.raises(FileNotFoundError, match="missing replica"):
        cpd.write_index_manifest(t, world["tdc"])


# ----------------------------------------------------------- anti-entropy

def _flip(path):
    with open(path, "r+b") as f:
        f.seek(96)
        f.write(b"\x7f" * 8)


AE_CASES = {
    "clean": lambda d: None,
    "flipped-replica": lambda d: _flip(
        os.path.join(d, cpd.shard_block_name(2, 0, 1))),
    "missing-replica": lambda d: os.remove(
        os.path.join(d, cpd.shard_block_name(1, 2, 1))),
    "recompute": lambda d: [os.remove(os.path.join(d, n)) for n in (
        cpd.shard_block_name(3, 1), cpd.shard_block_name(3, 1, 1))],
    "missing-primary": lambda d: [os.remove(os.path.join(d, n)) for n in (
        "index.json", cpd.shard_block_name(0, 0))],
}


@pytest.mark.parametrize("graph", [True, False])
@pytest.mark.parametrize("case", sorted(AE_CASES))
def test_anti_entropy_equals_jax(world, replicated, case, graph):
    j, t = replicated
    with open(os.path.join(t, cpd.shard_block_name(3, 1)), "rb") as f:
        w3b1 = f.read()
    AE_CASES[case](j)
    AE_CASES[case](t)
    m0 = cpd.COUNTERS["replica_digest_mismatches_total"]
    want = jcpd.anti_entropy(j, world["jdc"],
                             graph=world["jg"] if graph else None)
    got = cpd.anti_entropy(t, world["tdc"],
                           graph=world["tg"] if graph else None,
                           device="cpu")
    assert got == want
    assert got["checked"] == (3 * W if case != "missing-primary"
                              else 3 * W - 1)
    assert cpd.COUNTERS["replica_digest_mismatches_total"] - m0 == len(
        got["mismatched"])
    healed = {"clean": [], "flipped-replica": [cpd.shard_block_name(2, 0, 1)],
              "missing-replica": [cpd.shard_block_name(1, 2, 1)],
              "recompute": ([cpd.shard_block_name(3, 1, 1)] if graph
                            else []),
              "missing-primary": []}[case]
    assert got["healed"] == healed
    if case == "missing-primary":
        assert got["missing_primary"] == [cpd.shard_block_name(0, 0)]
    if case == "recompute" and graph:
        with open(os.path.join(t, cpd.shard_block_name(3, 1, 1)),
                  "rb") as f:
            assert f.read() == w3b1
    _same_tree(j, t)
    # a second pass finds nothing left to heal
    again = cpd.anti_entropy(t, world["tdc"],
                             graph=world["tg"] if graph else None,
                             device="cpu")
    assert again["healed"] == []


def test_anti_entropy_r1_is_a_noop(world, tmp_path):
    j, t = _pair(world["prim"]["raw"], tmp_path)
    r1 = DistributionController("mod", W, W, world["tg"].n, block_size=BS)
    want = jcpd.anti_entropy(j, JDC("mod", W, W, world["jg"].n,
                                    block_size=BS))
    assert cpd.anti_entropy(t, r1) == want == {
        "checked": 0, "mismatched": [], "healed": [], "missing_primary": []}
    _same_tree(j, t)


# -------------------------------------------------------------- adoption

@pytest.mark.parametrize("fault", ["none", "flip", "missing"])
def test_adopt_shard_blocks_equals_jax(world, replicated, fault):
    j, t = replicated
    victim = cpd.shard_block_name(2, 1)
    for d in (j, t):
        if fault == "flip":
            _flip(os.path.join(d, victim))
        elif fault == "missing":
            os.remove(os.path.join(d, victim))
    a0 = cpd.COUNTERS["reshard_blocks_adopted_total"]
    want = jcpd.adopt_shard_blocks(world["jg"], world["jdc"], 2, j)
    got = cpd.adopt_shard_blocks(world["tg"], world["tdc"], 2, t,
                                 device="cpu")
    assert got == want
    assert got["healed"] == ([] if fault == "none" else [victim])
    assert cpd.COUNTERS["reshard_blocks_adopted_total"] - a0 == 3
    _same_tree(j, t)
    again = cpd.adopt_shard_blocks(world["tg"], world["tdc"], 2, t,
                                   device="cpu")
    assert again["healed"] == [] and again["ok"] == again["blocks"] == 3


# ------------------------------------------------------------------- CLIs

def _build_argv(world, outdir, *extra):
    return ["--input", world["xy"], "--partmethod", "mod", "--partkey",
            str(W), "--maxworker", str(W), "--outdir", outdir,
            "--block-size", str(BS), *extra]


def test_worker_build_cli_equals_jax(world, tmp_path):
    """``worker.build --no-resume --replication 2`` on every worker, then
    ``--adopt-shard`` over a faulted block: the same files as the JAX
    CLI's, and the dump's counters and launches."""
    j, t = _pair(world["prim"]["raw"], tmp_path)
    dump = str(tmp_path / "dump.json")
    for wid in range(W):
        flags = ["--workerid", str(wid), "--no-resume", "--replication",
                 "2"]
        before = dict(cpd.COUNTERS)
        assert t_wbuild.main(_build_argv(world, t, *flags, "--device",
                                         "cpu", "--metrics-dump",
                                         dump)) == 0
        assert j_wbuild.main(_build_argv(world, j, *flags)) == 0
        with open(dump) as f:
            snap = json.load(f)
        assert snap["blocks"] == 3 and snap["device"]["type"] == "cpu"
        c = snap["counters"]
        # the primaries rebuilt (each of their rows staged), the hosted
        # replica copied (its own recompute pass then finds every block
        # done); the build pipeline's ``*_seconds`` sums are timings
        counts = [k for k in before if not k.endswith("_seconds")]
        assert {k: c[k] - before[k] for k in counts} == {
            **dict.fromkeys(counts, 0),
            "replica_blocks_copied_total": 3,
            "build_blocks_resumed_total": 3,
            "build_rows_staged_total": world["tdc"].n_owned(wid)}
        assert c["relax_jacobi.launches"] == c["first_moves.launches"] == 0
    _same_tree(j, t)
    for d in (j, t):
        os.remove(os.path.join(d, cpd.shard_block_name(3, 0)))
    before = dict(cpd.COUNTERS)
    assert t_wbuild.main(_build_argv(
        world, t, "--workerid", "0", "--adopt-shard", "3", "--device",
        "cpu", "--metrics-dump", dump)) == 0
    assert j_wbuild.main(_build_argv(world, j, "--workerid", "0",
                                     "--adopt-shard", "3")) == 0
    with open(dump) as f:
        c = json.load(f)["counters"]
    assert c["reshard_blocks_adopted_total"] - before[
        "reshard_blocks_adopted_total"] == 3
    assert c["cpd_blocks_rebuilt_total"] - before[
        "cpd_blocks_rebuilt_total"] == 1
    _same_tree(j, t)


@pytest.mark.parametrize("raw,want", [("2", 2), ("9", 1), ("0", 1)])
def test_worker_build_replication_env(world, tmp_path, monkeypatch, raw,
                                      want):
    """``DOS_REPLICATION`` sets the default; out of [1, W] builds the
    primaries only, as JAX's worker.build does."""
    monkeypatch.setenv("DOS_REPLICATION", raw)
    j, t = _pair(world["prim"]["raw"], tmp_path)
    assert t_wbuild.main(_build_argv(world, t, "--workerid", "1",
                                     "--device", "cpu")) == 0
    assert j_wbuild.main(_build_argv(world, j, "--workerid", "1")) == 0
    _same_tree(j, t)
    assert os.path.exists(os.path.join(t, cpd.shard_block_name(0, 0, 1))) \
        == (want == 2)


def _conf(world, d, **extra):
    conf = {"workers": ["localhost"] * W, "partmethod": "mod",
            "partkey": W, "outdir": str(d / "index"), "nfs": str(d / "nfs"),
            "projectdir": ROOT, "xy_file": world["xy"], "scenfile": "",
            "diffs": ["-"], **extra}
    os.makedirs(conf["nfs"], exist_ok=True)
    path = str(d / "conf.json")
    with open(path, "w") as f:
        json.dump(conf, f)
    return path


class _Done:
    """A finished build process as ``launch`` returns one."""

    def __init__(self, rc):
        self.returncode = rc

    def wait(self):
        return self.returncode


def _in_process_launch(mods):
    """``launch`` running the worker command's ``-m`` module's ``main``
    in this process (the package's own, by module name)."""
    def launch(host, session, cmd, **kw):
        argv = shlex.split(cmd)
        assert argv[0] == sys.executable and argv[1] == "-m"
        return _Done(mods[argv[2]].main(argv[3:]))
    return launch


def test_make_cpds_host_r2_equals_jax(world, tmp_path, monkeypatch,
                                      capsys):
    """``make_cpds --backend host`` with ``replication: 2``: every worker
    builds its primary and copies its hosted replica; the head writes the
    replicated manifest and the anti-entropy pass finds it clean — files
    and manifest byte-equal to the JAX CLI's."""
    mods = {"distributed_oracle_search_tpu_torch.worker.build": t_wbuild,
            "distributed_oracle_search_tpu.worker.build": j_wbuild}
    out = {}
    for pkg, mod in (("t", t_make), ("j", j_make)):
        d = tmp_path / pkg
        d.mkdir()
        conf = _conf(world, d, replication=2)
        monkeypatch.setattr(mod, "launch", _in_process_launch(mods))
        assert mod.main(["-c", conf, "--backend", "host",
                         "--device", "cpu", "--no-resume"]) in (0, None)
        out[pkg] = str(d / "index")
    text = capsys.readouterr().out
    assert text.count(f"anti-entropy: {W} replica block(s) cross-checked, "
                      "0 divergent, 0 healed") == 2
    man = cpd.read_manifest(out["t"])
    assert man["replication"] == 2 and len(man["replica_files"]) == W
    _same_tree(out["j"], out["t"])
    assert cpd.verify_exit_code(cpd.verify_index(
        out["t"], DistributionController("mod", W, W, world["tg"].n,
                                         replication=2))) == 0


def test_make_cpds_worker_cmd_passes_resume_and_replication(world,
                                                            tmp_path):
    conf = ClusterConfig.load(_conf(world, tmp_path, replication=3))
    cmd = t_make.worker_build_cmd(1, conf, resume=False, device="cpu")
    assert " --no-resume" in cmd and " --replication 3" in cmd
    assert cmd.endswith("--device cpu")
    plain = t_make.worker_build_cmd(1, ClusterConfig.load(
        _conf(world, tmp_path)))
    assert "--no-resume" not in plain and "--replication" not in plain


# ----------------------------------------------------------------- server

def test_server_answers_a_hosted_replica_batch(world, replicated,
                                               tmp_path):
    """Worker 2 hosts shard 1's rank-1 replica: its server answers a
    batch for shard 1 from that replica set, equal to shard 1's primary
    engine, and counts it; a batch for shard 0 (not hosted) fails the
    routing invariant."""
    _, t = replicated
    conf = ClusterConfig.load(_conf(world, tmp_path, replication=2,
                                    outdir=t))
    tdc = world["tdc"]
    server = t_server.FifoServer(conf, 2, command_fifo=str(tmp_path / "f"),
                                 device="cpu")
    q = synth_scenario(world["tg"].n, 60, seed=5)
    shard1 = q[tdc.worker_of(q[:, 1]) == 1]
    prim = ShardEngine(world["tg"], tdc, 1, t, device="cpu")
    for cfg in (RuntimeConfig(), RuntimeConfig(k_moves=4, extract=True)):
        cost, plen, fin, _stats, paths = server.answer_queries(
            shard1, cfg, "-")
        want = prim.answer(shard1, cfg, "-")
        for a, b in zip((cost, plen, fin), want[:3]):
            np.testing.assert_array_equal(a, b)
        if cfg.extract:
            for a, b in zip(paths, prim.last_paths):
                np.testing.assert_array_equal(a, b)
    assert server.counters["server_replica_batches_total"] == 2
    eng = server._replica_engines[1]
    assert (eng.shard, eng.replica) == (1, 1)
    shard0 = q[tdc.worker_of(q[:, 1]) == 0]
    with pytest.raises(ValueError, match="routing invariant"):
        server.answer_queries(shard0, RuntimeConfig(), "-")
    own = q[tdc.worker_of(q[:, 1]) == 2]
    server.answer_queries(own, RuntimeConfig(), "-")
    assert server.counters["server_replica_batches_total"] == 2
