"""PyTorch port, the host backend on the CPU: ``make_cpds --backend
host`` → ``make_fifos`` → ``process_query --backend host`` over 4
``localhost`` workers of a ``mod`` conf, every command FIFO, answer FIFO
and query file under ``tmp_path``. Held equal, exactly:

(a) the port's host campaign (in-thread port servers) and the JAX
    package's (in-thread JAX servers): ``parts.csv`` round by round in
    every column but the timers, and ``paths.csv`` byte for byte;
(b) across packages: the port head against JAX servers and the JAX head
    against port servers give the same rows;
(c) ``make_cpds --backend host --device cpu`` with real ``worker.build``
    subprocesses writes blocks and an ``index.json`` byte-equal to the
    JAX package's ``worker.build``;
(d) ``make_fifos`` + ``process_query`` with real ``worker.server``
    subprocesses answer every query and stop cleanly; a dead worker
    degrades the campaign (``FAIL`` row, ``degraded.json``, exit 3);
(e) the cases A14 refused now act as the JAX package's do: the RPC lane
    (``DOS_TRANSPORT=rpc``), the per-lane FIFO fallback (``auto``) and a
    replicated campaign failing over off a dead worker give the JAX
    head's rows; an elastic fleet's ``membership.json`` is still refused,
    naming its ``ROADMAP.md`` item (A14.3)."""

import csv
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)

from distributed_oracle_search_tpu.cli import process_query as j_pq  # noqa: E402
from distributed_oracle_search_tpu.models.cpd import (  # noqa: E402
    write_index_manifest as j_write_manifest,
)
from distributed_oracle_search_tpu.parallel.partition import (  # noqa: E402
    DistributionController as JDistributionController,
)
from distributed_oracle_search_tpu.utils.config import (  # noqa: E402
    ClusterConfig as JClusterConfig,
)
from distributed_oracle_search_tpu.worker import build as j_wbuild  # noqa: E402
from distributed_oracle_search_tpu.worker import server as j_server  # noqa: E402
from distributed_oracle_search_tpu_torch.cli import make_cpds as t_make  # noqa: E402
from distributed_oracle_search_tpu_torch.cli import make_fifos as t_fifos  # noqa: E402
from distributed_oracle_search_tpu_torch.cli import process_query as t_pq  # noqa: E402
from distributed_oracle_search_tpu_torch.data import (  # noqa: E402
    Graph, read_scen, synth_city_graph, synth_diff, synth_scenario,
    write_diff, write_scen, write_xy,
)
from distributed_oracle_search_tpu_torch.models import cpd  # noqa: E402
from distributed_oracle_search_tpu_torch.models.cpd import (  # noqa: E402
    build_worker_shard, write_index_manifest,
)
from distributed_oracle_search_tpu_torch.parallel import (  # noqa: E402
    DistributionController,
)
from distributed_oracle_search_tpu_torch.transport import fifo as t_fifo  # noqa: E402
from distributed_oracle_search_tpu_torch.utils.config import (  # noqa: E402
    ClusterConfig,
)
from distributed_oracle_search_tpu_torch.worker import server as t_server  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W = 4
TIMERS = ("t_receive", "t_astar", "t_search", "t_prepare", "t_partition")
SERVERS = {"torch": (t_server, ClusterConfig),
           "jax": (j_server, JClusterConfig)}
HEADS = {"torch": t_pq, "jax": j_pq}
DEV = ["--device", "cpu"]     # the JAX parser passes it through
#: the registry metrics a ``worker.build`` process registers (its
#: ``--metrics-dump`` holds these, plus the mirrored counts in counters)
BUILD_REGISTRY_COUNTERS = (
    "artifacts_swept_total", "cpd_resident_degraded_total",
    "failover_total", "faults_injected_total", "head_circuit_closed_total",
    "head_circuit_half_open_total", "head_circuit_open_total",
    "head_circuit_rejected_total", "head_probe_failures_total",
    "head_probes_total", "head_retries_total",
    "head_stale_fifos_cleaned_total", "mesh_walk_batches_total",
    "recorder_events_total", "recorder_records_total",
    "recorder_segments_total", "recorder_torn_lines_total",
    "walk_compressed_batches_total", "walk_pallas_batches_total",
    "walk_xla_batches_total", "worker_batches_total",
    "worker_duplicate_queries_total", "worker_queries_total")
BUILD_REGISTRY_GAUGES = (
    "cpd_resident_bytes", "device_programs_analyzed", "head_circuits_open",
    "mesh_devices", "recorder_ring_bytes")
BUILD_REGISTRY_HISTOGRAMS = (
    "cpd_decompress_seconds", "mesh_collective_seconds",
    "worker_jit_compile_seconds",
    "worker_receive_seconds", "worker_search_seconds",
    "worker_weights_load_seconds")


def _write_conf(d, data, **extra) -> str:
    conf = {"workers": ["localhost"] * W, "partmethod": "mod", "partkey": W,
            "outdir": str(d / "index"), "nfs": str(d / "nfs"),
            "projectdir": ROOT, **data, **extra}
    os.makedirs(conf["nfs"], exist_ok=True)
    path = str(d / "conf.json")
    with open(path, "w") as f:
        json.dump(conf, f)
    return path


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("host-data")
    g = synth_city_graph(12, 9, seed=4)
    xy = str(d / "city.xy")
    write_xy(xy, g.xs, g.ys, g.src, g.dst, g.w)
    g = Graph.from_xy(xy)
    scen = str(d / "city.scen")
    q = synth_scenario(g.n, 200, seed=8)
    write_scen(scen, np.concatenate([q, q[:10], [[5, 5]]]))
    diff = str(d / "city.diff")
    write_diff(diff, *synth_diff(g, frac=0.2, seed=9))
    return {"xy_file": xy, "scenfile": scen, "diffs": ["-", diff]}


@pytest.fixture(scope="module")
def cluster(tmp_path_factory, dataset):
    """The conf with its index built on the CPU (in-process)."""
    d = tmp_path_factory.mktemp("host-cluster")
    conf = _write_conf(d, dataset)
    g = Graph.from_xy(dataset["xy_file"])
    dc = DistributionController("mod", W, W, g.n)
    outdir = str(d / "index")
    for wid in range(W):
        build_worker_shard(g, dc, wid, outdir, chunk=32, device="cpu")
    write_index_manifest(outdir, dc)
    return conf


def _fifos(tmp_path, tag):
    return {w: str(tmp_path / f"{tag}-worker{w}.fifo") for w in range(W)}


class Fleet:
    """In-thread servers of one package, one per worker, on FIFOs under
    ``tmp_path``; both heads' ``command_fifo_path`` point at them."""

    def __init__(self, pkg, conf, tmp_path, monkeypatch, rpc=False):
        mod, conf_cls = SERVERS[pkg]
        self.mod = mod
        self.fifos = _fifos(tmp_path, pkg)
        kw = {"device": "cpu"} if pkg == "torch" else {}
        self.servers = [mod.FifoServer(conf_cls.load(conf), w,
                                       command_fifo=self.fifos[w], **kw)
                        for w in range(W)]
        self.stop = mod.stop_server
        # RPC listeners beside the FIFO loops, on sockets under tmp_path
        # (DOS_RPC_SOCKET_DIR names them for both heads)
        self.rpc = rpc
        self.loops = []
        monkeypatch.setenv("DOS_RPC_SOCKET_DIR", str(tmp_path))
        for head in HEADS.values():
            monkeypatch.setattr(head, "command_fifo_path",
                                lambda w: self.fifos[w])

    def __enter__(self):
        self.threads = [threading.Thread(target=s.serve_forever, daemon=True)
                        for s in self.servers]
        for t in self.threads:
            t.start()
        for f in self.fifos.values():
            for _ in range(200):
                if os.path.exists(f):
                    break
                time.sleep(0.02)
        if self.rpc:
            self.loops = [self.mod.RpcServeLoop(s).start()
                          for s in self.servers]
        return self

    def __exit__(self, *exc):
        for f in self.fifos.values():
            self.stop(f)
        for t in self.threads:
            t.join(timeout=10)
        for loop in self.loops:
            loop.stop()
        assert not any(t.is_alive() for t in self.threads)


def _parts(path):
    with open(path) as f:
        rows = list(csv.reader(f))
    keep = [i for i, h in enumerate(rows[0]) if h not in TIMERS]
    return [[r[i] for i in keep] for r in rows]


def _campaign(head, conf, out, extra=()):
    rc = HEADS[head].main(["-c", conf, "--backend", "host", "-o", out,
                           *DEV, *extra])
    return rc, _parts(os.path.join(out, "parts.csv"))


@pytest.fixture(scope="module")
def jax_campaign(cluster, tmp_path_factory):
    """The JAX package's host campaign (JAX head, JAX servers): the
    reference the port's campaigns are held to."""
    tmp = tmp_path_factory.mktemp("jax-campaign")
    mp = pytest.MonkeyPatch()
    try:
        with Fleet("jax", cluster, tmp, mp):
            rounds = _campaign("jax", cluster, str(tmp / "rounds"))
            k8 = _campaign("jax", cluster, str(tmp / "k8"),
                           ["-k", "8", "--extract"])
    finally:
        mp.undo()
    with open(tmp / "k8" / "paths.csv", "rb") as f:
        paths = f.read()
    return rounds, k8, paths


def test_host_campaign_equals_jax(cluster, jax_campaign, tmp_path,
                                  monkeypatch):
    """(a) port head + port servers == JAX head + JAX servers."""
    with Fleet("torch", cluster, tmp_path, monkeypatch):
        rounds = _campaign("torch", cluster, str(tmp_path / "rounds"))
        k8 = _campaign("torch", cluster, str(tmp_path / "k8"),
                       ["-k", "8", "--extract"])
    assert rounds == jax_campaign[0] and k8 == jax_campaign[1]
    assert rounds[0] == 0
    head, rows = rounds[1][0], rounds[1][1:]
    assert {r[0] for r in rows} == {"0", "1"}        # one round per diff
    n = len(read_scen(ClusterConfig.load(cluster).scenfile))
    for expe in ("0", "1"):
        mine = [r for r in rows if r[0] == expe]
        assert len(mine) == W
        assert sum(int(r[head.index("size")]) for r in mine) == n
        assert sum(int(r[head.index("finished")]) for r in mine) == n
    with open(tmp_path / "k8" / "paths.csv", "rb") as f:
        assert f.read() == jax_campaign[2]
    with open(tmp_path / "rounds" / "metrics.json") as f:
        metrics = json.load(f)
    assert metrics["failed_batches"] == [] and metrics["num_queries"] == n
    assert not os.path.exists(tmp_path / "rounds" / "degraded.json")
    nfs = ClusterConfig.load(cluster).nfs
    assert not [f for f in os.listdir(nfs) if f.startswith("answer.")]


@pytest.mark.parametrize("head,servers", [("torch", "jax"),
                                          ("jax", "torch")])
def test_cross_package_head_and_servers(cluster, jax_campaign, tmp_path,
                                        monkeypatch, head, servers):
    """(b) either package's head drives the other's servers over the
    same wire, with the same rows and paths."""
    with Fleet(servers, cluster, tmp_path, monkeypatch):
        rounds = _campaign(head, cluster, str(tmp_path / "rounds"))
        k8 = _campaign(head, cluster, str(tmp_path / "k8"),
                       ["-k", "8", "--extract"])
    assert rounds == jax_campaign[0] and k8 == jax_campaign[1]
    with open(tmp_path / "k8" / "paths.csv", "rb") as f:
        assert f.read() == jax_campaign[2]


def test_host_campaign_worker_filter(cluster, tmp_path, monkeypatch):
    """``-w 2`` sends one worker's batches only, with that worker's rows
    equal to the full campaign's."""
    with Fleet("torch", cluster, tmp_path, monkeypatch):
        rc_all, full = _campaign("torch", cluster, str(tmp_path / "all"))
        rc_w, one = _campaign("torch", cluster, str(tmp_path / "w2"),
                              ["-w", "2"])
    assert rc_all == rc_w == 0
    assert len(one) == 1 + 2
    assert one[1:] == [r for r in full[1:] if r in one[1:]]


def test_make_cpds_host_subprocess_blocks_equal_jax(dataset, tmp_path):
    """(c) real ``worker.build`` subprocesses on the CPU: blocks and
    manifest byte-equal to the JAX package's ``worker.build``."""
    conf = _write_conf(tmp_path, dataset)
    dump = str(tmp_path / "build")
    assert t_make.main(["-c", conf, "--chunk", "32", "--metrics-dump",
                        dump, *DEV]) == 0
    c = ClusterConfig.load(conf)
    dc = DistributionController("mod", W, W, Graph.from_xy(c.xy_file).n)
    for wid in range(W):
        with open(f"{dump}.w{wid}.json") as f:
            snap = json.load(f)
        assert snap["wid"] == wid and snap["rows"] == dc.n_owned(wid)
        assert snap["blocks"] >= 1 and snap["seconds"] > 0
        assert snap["device"]["type"] == "cpu"
        # the registry's snapshot: the metrics a build process registers,
        # with the build kernels' launches, K1's active pairs and the
        # index counters mirrored into its counters
        assert set(snap["counters"]) == {
            *BUILD_REGISTRY_COUNTERS, "relax_jacobi.launches",
            "first_moves.launches", "grid_sweep.launches",
            "relax_jacobi.active_pairs", *cpd.COUNTERS}
        assert set(snap["gauges"]) == set(BUILD_REGISTRY_GAUGES)
        assert set(snap["histograms"]) == set(BUILD_REGISTRY_HISTOGRAMS)
    jout = str(tmp_path / "jax-index")
    for wid in range(W):
        assert j_wbuild.main([
            "--input", c.xy_file, "--partmethod", "mod", "--partkey",
            str(W), "--workerid", str(wid), "--maxworker", str(W),
            "--outdir", jout, "--chunk", "32"]) == 0
    g = Graph.from_xy(c.xy_file)
    j_write_manifest(jout, JDistributionController("mod", W, W, g.n))
    names = sorted(f for f in os.listdir(jout)
                   if f.endswith(".npy") or f == "index.json")
    assert sorted(f for f in os.listdir(c.outdir)
                  if f.endswith(".npy") or f == "index.json") == names
    assert len(names) >= W + 1
    for f in names:
        with open(os.path.join(jout, f), "rb") as a, \
                open(os.path.join(c.outdir, f), "rb") as b:
            assert a.read() == b.read(), f


def test_make_cpds_host_failed_build_raises(dataset, tmp_path):
    conf = _write_conf(tmp_path, dataset, xy_file=str(tmp_path / "no.xy"))
    with open(tmp_path / "no.xy", "w") as f:
        f.write("garbage\n")
    with pytest.raises(SystemExit, match=f"{W} worker build"):
        t_make.main(["-c", conf, *DEV])
    assert not os.path.exists(tmp_path / "index" / "index.json")


def _wait_ready(conf, fifos, deadline_s=60.0):
    """Ping every server until it answers; returns ``{wid: pid}``."""
    nfs = ClusterConfig.load(conf).nfs
    pids = {}
    deadline = time.monotonic() + deadline_s
    while len(pids) < len(fifos) and time.monotonic() < deadline:
        for w, f in fifos.items():
            if w not in pids and os.path.exists(f):
                st = t_fifo.probe("localhost", w, command_fifo=f, nfs=nfs,
                                  timeout=2.0)
                if st is not None:
                    pids[w] = st.pid
        time.sleep(0.1)
    return pids


def test_make_fifos_subprocess_servers_answer_and_stop(cluster, tmp_path,
                                                       monkeypatch):
    """(d) ``make_fifos`` starts real ``worker.server`` processes on the
    CPU; ``process_query`` answers every query through them; each stops
    on its stop token, writes its metrics dump and exits 0."""
    fifos = _fifos(tmp_path, "proc")
    for mod in (t_fifos, t_pq):
        monkeypatch.setattr(mod, "command_fifo_path", lambda w: fifos[w])
    dump = str(tmp_path / "metrics")
    monkeypatch.setenv("DOS_SEND_TIMEOUT_S", "60")
    # tracked subprocesses even where tmux exists: no session outlives
    # the test, and each server's exit code is read
    procs = {}
    real_launch = t_fifos.launch

    def tracked(host, session, cmd, **kw):
        proc = real_launch(host, session, cmd, **{**kw, "prefer_track": True})
        procs[int(session.rsplit("-", 1)[1])] = proc
        return proc

    monkeypatch.setattr(t_fifos, "launch", tracked)
    assert t_fifos.main(["-c", cluster, "--metrics-dump", dump, *DEV]) == 0
    assert sorted(procs) == list(range(W))
    try:
        pids = _wait_ready(cluster, fifos)
        # the process that answers the pings is the tracked one
        assert pids == {w: proc.pid for w, proc in procs.items()}
        rc, parts = _campaign("torch", cluster, str(tmp_path / "out"),
                              ["-k", "4", "--extract"])
    finally:
        for f in fifos.values():
            t_server.stop_server(f)
        for proc in procs.values():
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:      # fails the test below
                proc.kill()
                proc.wait()
    assert rc == 0
    assert [proc.returncode for proc in procs.values()] == [0] * W
    assert not any(os.path.exists(f) for f in fifos.values())
    head, rows = parts[0], parts[1:]
    n = len(read_scen(ClusterConfig.load(cluster).scenfile))
    assert sum(int(r[head.index("size")]) for r in rows) == 2 * n
    paths = np.loadtxt(tmp_path / "out" / "paths.csv", delimiter=",",
                       skiprows=1, dtype=np.int64)
    assert paths.shape == (n, 3 + 5)
    for w in range(W):
        with open(f"{dump}.w{w}.json") as f:
            snap = json.load(f)
        assert snap["wid"] == w and snap["pid"] == pids[w]
        assert snap["device"]["type"] == "cpu"
        c = snap["counters"]
        assert c["worker_batches_total"] == 2
        assert c["cuda_walk_batch.plain"] >= 2
        assert c["cuda_walk_batch.launches"] == 0


def test_dead_worker_degrades_campaign(cluster, tmp_path, monkeypatch):
    """A worker with no resident server fails fast: its batches are
    booked ``send-failed`` in ``degraded.json`` and the exit code is 3."""
    fleet = Fleet("torch", cluster, tmp_path, monkeypatch)
    dead = fleet.fifos[1]
    fleet.servers[1].serve_forever = lambda: None      # never resident
    monkeypatch.setenv("DOS_RETRY_MAX", "0")
    monkeypatch.setenv("DOS_SEND_TIMEOUT_S", "10")
    with fleet:
        assert not os.path.exists(dead)
        out = str(tmp_path / "out")
        rc, parts = _campaign("torch", cluster, out)
    assert rc == t_pq.EXIT_DEGRADED
    with open(os.path.join(out, "degraded.json")) as f:
        man = json.load(f)
    assert man["failed_workers"] == [1] and man["failed_count"] == 2
    assert man["total_batches"] == 2 * W and man["exit_code"] == 3
    assert {b["reason"] for b in man["failed_batches"]} == {"send-failed"}
    assert [b["round"] for b in man["failed_batches"]] == [0, 1]


def test_worker_commands_name_the_port(cluster):
    conf = ClusterConfig.load(cluster)
    build = t_make.worker_build_cmd(2, conf, chunk=64, codec="pack4",
                                    device="cpu")
    assert build.startswith(f"{sys.executable} -m "
                            "distributed_oracle_search_tpu_torch.worker.build")
    assert "--workerid 2" in build and "--chunk 64" in build
    assert build.endswith("--codec pack4 --device cpu")
    assert "distributed_oracle_search_tpu." not in build
    serve = t_fifos.worker_server_cmd(3, "c.json", verbose=2)
    assert ("distributed_oracle_search_tpu_torch.worker.server -c c.json "
            "--workerid 3 --alg table-search --fifo /tmp/worker3.fifo "
            "--device cuda -vv") in serve


@pytest.mark.parametrize("argv,item", [
    (["--engine", "native"], "install.sh"),
])
def test_make_cpds_host_refusals_name_roadmap(dataset, tmp_path, argv,
                                              item, monkeypatch):
    """``--engine native`` runs ``make_cpd_auto``; without the binary
    it fails as the JAX package does (``utils.nativebin``), before any
    build process starts."""
    from distributed_oracle_search_tpu_torch.utils import nativebin

    monkeypatch.setattr(nativebin, "SEARCH_DIRS", (str(tmp_path / "nb"),))
    conf = _write_conf(tmp_path, dataset)
    with pytest.raises(FileNotFoundError, match=item):
        t_make.main(["-c", conf, *DEV, *argv])
    assert not os.path.exists(tmp_path / "index")


@pytest.mark.parametrize("argv,item", [
    (["--supervise", "--engine", "native"], "python worker.server"),
    (["--engine", "native"], "install.sh"),
    (["--alg", "ch"], "add --engine native"),
])
def test_make_fifos_refusals_name_roadmap(cluster, argv, item,
                                          monkeypatch, tmp_path):
    """What ``make_fifos`` still refuses, in the JAX package's words:
    ``--alg ch`` without the native engine, a supervised native fleet,
    and (through ``utils.nativebin``) a native launch whose binary is
    missing; nothing is launched."""
    from distributed_oracle_search_tpu.cli import make_fifos as j_fifos
    from distributed_oracle_search_tpu.utils import nativebin as j_nb
    from distributed_oracle_search_tpu_torch.utils import nativebin

    for nb in (nativebin, j_nb):
        monkeypatch.setattr(nb, "SEARCH_DIRS", (str(tmp_path / "nb"),))
    monkeypatch.setattr(t_fifos, "launch", None)         # never launches
    monkeypatch.setattr(j_fifos, "launch", None)
    errors = {}
    for name, main, dev in (("torch", t_fifos.main, DEV),
                            ("jax", j_fifos.main, [])):
        with pytest.raises((SystemExit, FileNotFoundError),
                           match=item) as err:
            main(["-c", cluster, *dev, *argv])
        errors[name] = (type(err.value), str(err.value))
    assert errors["torch"][0] == errors["jax"][0]
    if errors["torch"][0] is SystemExit:
        assert errors["torch"] == errors["jax"]


def test_make_fifos_tpu_conf_needs_no_servers(tmp_path, dataset, capsys):
    conf = _write_conf(tmp_path, dataset, partmethod="tpu",
                       workers=[f"tpu:{i}" for i in range(W)])
    assert t_fifos.main(["-c", conf, *DEV]) == 0
    assert "no resident servers needed" in capsys.readouterr().out


@pytest.mark.parametrize("case,item", [
    ("rpc", "A14"), ("auto", "A14"), ("replication", "A14"),
    ("membership", "A14"),
])
def test_process_query_host_refusals_name_roadmap(cluster, dataset,
                                                  jax_campaign, tmp_path,
                                                  monkeypatch, case, item):
    """The four cases, refused until A14 ported them, give the JAX
    campaign's rows: ``rpc`` over the port servers' sockets (no query
    file written), ``auto`` against servers with no listener (each lane
    falls back to the FIFO wire), ``replication`` 2 with worker 1 never
    resident — its batches fail over to worker 2, the holder of its
    replica, under the port's head and the JAX head alike — and
    ``membership``: on a copy of the index, the port's controller
    commits worker 1's leave (epoch 1, ``membership.json``), and both
    heads route shard 1 to its new owner, whose port server adopts it,
    stamping epoch 1 on every batch; the rows equal the static fleet's
    and the departed worker answers nothing."""
    if case == "membership":
        import shutil

        from distributed_oracle_search_tpu_torch.parallel import (
            membership as t_membership)

        base = ClusterConfig.load(cluster)
        index = tmp_path / "index"
        shutil.copytree(base.outdir, index)
        conf = _write_conf(tmp_path, dataset)
        n = Graph.from_xy(dataset["xy_file"]).n
        mc = t_membership.MembershipController(
            ClusterConfig.load(conf), DistributionController("mod", W, W, n),
            device="cpu")
        state = mc.leave(1)
        assert state.epoch == 1 and 1 not in state.owners
        got = {}
        for head in ("torch", "jax"):
            (tmp_path / head).mkdir()
            fleet = Fleet("torch", conf, tmp_path / head, monkeypatch)
            with fleet:
                got[head] = _campaign(head, conf,
                                      str(tmp_path / head / "out"))
            assert fleet.servers[1].counters["worker_batches_total"] == 0
            assert all(s.epoch == 1 for s in fleet.servers)
        assert got["torch"] == got["jax"] == jax_campaign[0]
        return
    monkeypatch.setattr(t_pq, "_RPC_FALLBACK_LANES", set())
    if case in ("rpc", "auto"):
        monkeypatch.setenv("DOS_TRANSPORT", case)
        nfs = ClusterConfig.load(cluster).nfs
        before = set(os.listdir(nfs))
        with Fleet("torch", cluster, tmp_path, monkeypatch,
                   rpc=case == "rpc"):
            got = _campaign("torch", cluster, str(tmp_path / "rounds"))
        assert got == jax_campaign[0]
        written = set(os.listdir(nfs)) - before
        if case == "rpc":
            assert not [f for f in written if f.startswith("query.")]
            assert t_pq._RPC_FALLBACK_LANES == set()
        else:
            assert t_pq._RPC_FALLBACK_LANES == {("localhost", w)
                                                for w in range(W)}
        return
    with open(cluster) as f:
        conf_d = json.load(f)
    conf_d.update(replication=2, nfs=str(tmp_path / "nfs"))
    os.makedirs(conf_d["nfs"])
    conf = str(tmp_path / "conf-r2.json")
    with open(conf, "w") as f:
        json.dump(conf_d, f)
    monkeypatch.setenv("DOS_RETRY_MAX", "0")
    monkeypatch.setenv("DOS_SEND_TIMEOUT_S", "10")
    got = {}
    for head in ("torch", "jax"):
        fleet = Fleet("torch", conf, tmp_path / head, monkeypatch) \
            if (tmp_path / head).mkdir() is None else None
        fleet.servers[1].serve_forever = lambda: None      # never resident
        with fleet:
            got[head] = _campaign(head, conf, str(tmp_path / head / "out"))
        assert fleet.servers[2].counters[
            "server_replica_batches_total"] == 2
        assert not os.path.exists(tmp_path / head / "out" / "degraded.json")
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == 0 and got["torch"][1] == jax_campaign[0][1]
