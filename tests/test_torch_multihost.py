"""PyTorch port, multi-controller runs (``parallel/multihost.py``): two
processes on one machine, joined by one gloo group over a TCP
rendezvous, stand for two hosts.

Each case spawns two new interpreters running a port-only worker script
(``tests/torch_multihost_*.py``, no JAX), on free ports, with a timeout
a process and one intra-op thread. What they produce is held against the
JAX package here: the gathered index and the merged answers of the
two-process oracle, the artifacts of the conf-driven campaign (resident
and streamed, process 0 alone writing them) and the sharded streamed
campaign, whose per-process wire bytes sum to one controller's.
"""

import csv
import json
import os
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)

from distributed_oracle_search_tpu.cli import process_query as j_pq  # noqa: E402
from distributed_oracle_search_tpu.data import (  # noqa: E402
    Graph as JGraph, ensure_synth_dataset as j_ensure, read_scen as j_scen,
    synth_city_graph as j_city, synth_diff as j_synth_diff,
    synth_scenario as j_synth_scenario,
)
from distributed_oracle_search_tpu.models.cpd import (  # noqa: E402
    CPDOracle as JOracle, build_worker_shard as j_build_worker_shard,
    write_index_manifest as j_write_manifest,
)
from distributed_oracle_search_tpu.models.reference import (  # noqa: E402
    first_move_matrix,
)
from distributed_oracle_search_tpu.models.streamed import (  # noqa: E402
    StreamedCPDOracle as JStreamed,
)
from distributed_oracle_search_tpu.parallel.mesh import make_mesh  # noqa: E402
from distributed_oracle_search_tpu.parallel.partition import (  # noqa: E402
    DistributionController as JDC,
)
from distributed_oracle_search_tpu.worker.engine import (  # noqa: E402
    load_shard_rows as j_load_shard_rows,
)
from distributed_oracle_search_tpu_torch.cli import process_query as t_pq  # noqa: E402
from distributed_oracle_search_tpu_torch.data import Graph, read_scen  # noqa: E402
from distributed_oracle_search_tpu_torch.models.streamed import (  # noqa: E402
    StreamedCPDOracle,
)
from distributed_oracle_search_tpu_torch.parallel import multihost  # noqa: E402
from distributed_oracle_search_tpu_torch.parallel.partition import (  # noqa: E402
    DistributionController,
)
from distributed_oracle_search_tpu_torch.utils.config import (  # noqa: E402
    ClusterConfig,
)

HERE = os.path.dirname(os.path.abspath(__file__))
TIMEOUT_S = 240
TIMERS = ("t_receive", "t_astar", "t_search", "t_prepare", "t_partition")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(script: str, argv_of, extra_env=None) -> list[str]:
    """Run two processes of ``script`` (``argv_of(pid)``) to their end,
    each within ``TIMEOUT_S``; a process that outlives it is killed and
    fails the test. Returns their outputs, each process asserted to have
    exited 0."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env["OMP_NUM_THREADS"] = "1"
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")     # one machine
    env.update(extra_env or {})
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, script), *argv_of(pid)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for pid in range(2)]
    outs = []
    try:
        for p in procs:
            o, _ = p.communicate(timeout=TIMEOUT_S)
            outs.append(o)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for pid, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid} failed:\n{o[-3000:]}"
    return outs


def test_two_process_oracle_build_and_rounds(tmp_path):
    """Two processes, four of the eight workers each: the index process
    0 saves (every worker's rows gathered to it) holds JAX's reference
    first-move rows, and the merged answers of a round, a diff round and
    a fused two-diff round equal JAX's one-controller oracle."""
    coord = f"127.0.0.1:{_free_port()}"
    out = str(tmp_path)
    outs = _spawn("torch_multihost_worker.py",
                  lambda pid: [str(pid), "2", coord, out])
    for pid, o in enumerate(outs):
        assert f"MULTIHOST_OK process={pid} nproc=2 slots=4" in o, o[-2000:]
    g = j_city(8, 6, seed=7)
    dc = JDC("tpu", None, 8, g.n)
    golden = first_move_matrix(g, np.arange(g.n))
    for wid in range(8):
        rows = j_load_shard_rows(os.path.join(out, "index"), wid)
        np.testing.assert_array_equal(rows, golden[dc.owned(wid)])
    jo = JOracle(g, dc, mesh=make_mesh(n_workers=8)).build()
    queries = j_synth_scenario(g.n, 24, seed=8)
    w_diff = g.weights_with_diff(j_synth_diff(g, frac=0.3, seed=9))
    got = np.load(os.path.join(out, "answers.npz"))
    c0, p0, f0 = jo.query(queries)
    c1, _p1, _f1 = jo.query(queries, w_query=w_diff)
    for name, want in (("c0", c0), ("p0", p0), ("f0", f0), ("c1", c1),
                       ("pm", p0)):
        np.testing.assert_array_equal(got[name], want)
    np.testing.assert_array_equal(got["cm"], np.stack([c0, c1]))


@pytest.fixture(scope="module")
def campaign_data(tmp_path_factory):
    """The JAX campaign tests' multi-controller dataset (a 10x8 city, 96
    queries, a diff) and its 8-worker index, built and saved by the JAX
    package."""
    root = tmp_path_factory.mktemp("tmh-campaign")
    dataset = j_ensure(str(root / "data"), width=10, height=8,
                       n_queries=96, seed=13)
    g = JGraph.from_xy(dataset["xy"])
    dc = JDC("tpu", 8, 8, g.n)
    JOracle(g, dc, mesh=make_mesh(n_workers=8)).build().save(
        str(root / "index"))
    return root, dataset


def _parts(path):
    with open(path) as f:
        rows = list(csv.reader(f))
    keep = [i for i, h in enumerate(rows[0]) if h not in TIMERS]
    return [[r[i] for i in keep] for r in rows]


def _conf(path, index, dataset, multihost_key=None):
    conf = {"workers": [f"tpu:{i}" for i in range(8)],
            "partmethod": "tpu", "partkey": 8, "outdir": index,
            "xy_file": dataset["xy"], "scenfile": dataset["scen"],
            "diffs": ["-", dataset["diff"]]}
    if multihost_key is not None:
        conf["multihost"] = multihost_key
    with open(path, "w") as f:
        json.dump(conf, f)
    return path


@pytest.mark.parametrize("plan,argv", [
    ("resident", []), ("streamed", []),
    ("resident", ["-k", "8", "--extract"]),
    ("streamed", ["-k", "8", "--extract"]),
], ids=["resident", "streamed", "resident-paths", "streamed-paths"])
def test_two_process_conf_driven_campaign(tmp_path, campaign_data,
                                          monkeypatch, plan, argv):
    """``process_query`` run by two controllers on one conf whose
    ``multihost`` key joins them: process 0 alone writes ``metrics.json``,
    ``parts.csv`` and ``paths.csv``, equal (but the timers) to one port
    controller's and to the JAX package's; process 1 writes nothing."""
    root, dataset = campaign_data
    streamed = plan == "streamed"
    index = str(root / "index")
    coord = f"127.0.0.1:{_free_port()}"
    conf = _conf(str(tmp_path / "conf.json"), index, dataset,
                 {"coordinator": coord, "num_processes": 2,
                  "cpu_devices_per_process": 4})
    outs = _spawn("torch_multihost_campaign_worker.py",
                  lambda pid: [str(pid), conf, str(tmp_path / f"out{pid}"),
                               *argv],
                  {"DOS_SERVE_STREAMED": "1"} if streamed else None)
    for pid, o in enumerate(outs):
        assert f"CAMPAIGN_OK process={pid} nproc=2" in o, o[-2000:]
        if streamed:
            assert f"streamed: process {pid}/2 streamed" in o, o[-2000:]
    assert not os.path.exists(tmp_path / "out1")
    got = str(tmp_path / "out0")
    n_queries = len(j_scen(dataset["scen"]))
    with open(os.path.join(got, "metrics.json")) as f:
        assert json.load(f)["num_queries"] == n_queries

    # one port controller, and the JAX package, on the same conf
    one = _conf(str(tmp_path / "one.json"), index, dataset)
    if streamed:
        monkeypatch.setenv("DOS_SERVE_STREAMED", "1")
    else:
        monkeypatch.delenv("DOS_SERVE_STREAMED", raising=False)
    assert t_pq.main(["-c", one, "-o", str(tmp_path / "t1"), "--device",
                      "cpu", *argv]) == 0
    assert j_pq.main(["-c", one, "-o", str(tmp_path / "j1"), *argv]) == 0
    for ref in ("t1", "j1"):
        assert _parts(os.path.join(got, "parts.csv")) == _parts(
            str(tmp_path / ref / "parts.csv")), ref
        if argv:
            with open(os.path.join(got, "paths.csv")) as a, \
                    open(tmp_path / ref / "paths.csv") as b:
                assert a.read() == b.read(), ref
    rows = _parts(os.path.join(got, "parts.csv"))[1:]
    if not argv:
        for rnd in ("0", "1"):
            assert sum(int(float(r[7])) for r in rows
                       if r[0] == rnd) == n_queries


def test_two_process_sharded_streamed_campaign(tmp_path):
    """The streamed plan under two controllers: each process streams ONLY
    its own workers' rows (the per-process wire bytes sum to one
    controller's, and neither streams all of them) and every process
    holds the whole merged answer, equal to JAX's streamed oracle."""
    datadir = str(tmp_path / "data")
    index = str(tmp_path / "index")
    dataset = j_ensure(datadir, width=10, height=8, n_queries=96, seed=17)
    jg = JGraph.from_xy(dataset["xy"])
    jdc = JDC("mod", 4, 4, jg.n)
    for wid in range(4):
        j_build_worker_shard(jg, jdc, wid, index, chunk=64)
    j_write_manifest(index, jdc)
    # range mode and small row chunks, so the two controllers' chunk
    # sets partition one controller's exactly
    knobs = {"DOS_STREAM_RANGE_DENSITY": "0.0", "DOS_STREAM_ROW_CHUNK": "8"}
    g = Graph.from_xy(dataset["xy"])
    dc = DistributionController("mod", 4, 4, g.n)
    queries = read_scen(dataset["scen"])
    # sidecars land in the index directory: the JAX oracle gets a copy
    j_index = str(tmp_path / "j_index")
    shutil.copytree(index, j_index)
    old = {k: os.environ.get(k) for k in knobs}
    os.environ.update(knobs)
    try:
        st = StreamedCPDOracle(g, dc, index, row_chunk=8, device="cpu")
        c_ref, _, f_ref = st.query(queries)
        jst = JStreamed(jg, jdc, j_index, row_chunk=8)
        jc, jp, jf = jst.query(j_scen(dataset["scen"]))
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    assert bool(f_ref.all())
    total_bytes = st.last_stats["bytes_streamed"]
    assert total_bytes == jst.last_stats["bytes_streamed"]

    coord = f"127.0.0.1:{_free_port()}"
    out = str(tmp_path)
    outs = _spawn("torch_multihost_streamed_worker.py",
                  lambda pid: [str(pid), "2", coord, dataset["xy"], index,
                               dataset["scen"], out], knobs)
    per_proc = {}
    for pid, o in enumerate(outs):
        line = [ln for ln in o.splitlines()
                if ln.startswith(f"STREAMED_OK process={pid} ")]
        assert line, o[-2000:]
        per_proc[pid] = dict(kv.split("=") for kv in line[0].split()[1:])
    for pid in (0, 1):
        assert int(per_proc[pid]["cost_sum"]) == int(np.asarray(jc).sum())
    got = np.load(os.path.join(out, "streamed.npz"))
    for name, want in (("cost", jc), ("plen", jp), ("fin", jf)):
        np.testing.assert_array_equal(got[name], np.asarray(want))
    b0, b1 = (int(per_proc[p]["bytes"]) for p in (0, 1))
    assert b0 + b1 == total_bytes, (b0, b1, total_bytes)
    assert 0 < b0 < total_bytes and 0 < b1 < total_bytes


@pytest.mark.parametrize("conf", [
    ClusterConfig(workers=["tpu:0"], partmethod="tpu"),
    {"nfs": "/tmp"},
    {"multihost": {}},
], ids=["conf", "dict", "empty-key"])
def test_initialize_from_conf_noop_without_key(conf):
    """No ``multihost`` key, no process group: one controller, primary,
    its gathers one-deep."""
    assert multihost.initialize_from_conf(conf) is False
    assert multihost.process_info() == (0, 1)
    assert multihost.is_primary()
    x = np.arange(6, dtype=np.int64).reshape(2, 3)
    np.testing.assert_array_equal(multihost.gather_to_host(x), x[None])
    multihost.barrier("single")           # a no-op on one controller


def test_initialize_needs_its_rendezvous():
    """A ``multihost`` key without a process id (no conf entry, no
    ``$DOS_PROCESS_ID``) is refused before any socket opens."""
    with pytest.raises(ValueError, match="process_id"):
        multihost.initialize(coordinator="127.0.0.1:1", num_processes=2)
