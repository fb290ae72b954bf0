"""PyTorch port, ``testing.faults`` and its call sites against the JAX
package's: ``DOS_FAULTS`` parsing over a table of specs (and the errors
of malformed ones), an injector's counting (``wid``, ``after``,
``times``), ``DOS_FAULTS_STATE`` shared by two processes of each package,
the env re-arm; the FIFO server's ``crash-engine``, ``drop-reply``,
``delay`` and ``kill-mid-batch`` paths answering as the JAX server's do
and moving the same counters; ``corrupt-frame`` on both wires;
``corrupt-resident`` flipping the same resident row; and ``crash-build``
(``mode=raise``) leaving blocks and a ledger that the resumed build
completes byte-equal to the JAX package's, serial and pipelined."""

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

from distributed_oracle_search_tpu.data.graph import Graph as JGraph  # noqa: E402
from distributed_oracle_search_tpu.models import cpd as j_cpd  # noqa: E402
from distributed_oracle_search_tpu.obs import metrics as j_metrics  # noqa: E402
from distributed_oracle_search_tpu.parallel.partition import (  # noqa: E402
    DistributionController as JDC,
)
from distributed_oracle_search_tpu.testing import faults as j_faults  # noqa: E402
from distributed_oracle_search_tpu.transport import fifo as j_fifo  # noqa: E402
from distributed_oracle_search_tpu.transport import rpc as j_rpc  # noqa: E402
from distributed_oracle_search_tpu.transport.wire import (  # noqa: E402
    Request as JRequest, RuntimeConfig as JRuntimeConfig,
)
from distributed_oracle_search_tpu.utils.config import (  # noqa: E402
    ClusterConfig as JClusterConfig,
)
from distributed_oracle_search_tpu.worker import engine as j_engine  # noqa: E402
from distributed_oracle_search_tpu.worker import server as j_server  # noqa: E402
from distributed_oracle_search_tpu_torch.data import (  # noqa: E402
    Graph, synth_city_graph, synth_scenario, write_scen, write_xy,
)
from distributed_oracle_search_tpu_torch.models import cpd as t_cpd  # noqa: E402
from distributed_oracle_search_tpu_torch.obs import metrics as t_metrics  # noqa: E402
from distributed_oracle_search_tpu_torch.parallel import (  # noqa: E402
    DistributionController,
)
from distributed_oracle_search_tpu_torch.testing import faults as t_faults  # noqa: E402
from distributed_oracle_search_tpu_torch.transport import fifo as t_fifo  # noqa: E402
from distributed_oracle_search_tpu_torch.transport import rpc as t_rpc  # noqa: E402
from distributed_oracle_search_tpu_torch.transport.wire import (  # noqa: E402
    Request, RuntimeConfig, StatsRow, write_query_file,
)
from distributed_oracle_search_tpu_torch.utils.config import (  # noqa: E402
    ClusterConfig,
)
from distributed_oracle_search_tpu_torch.worker import engine as t_engine  # noqa: E402
from distributed_oracle_search_tpu_torch.worker import server as t_server  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAULTS = {"jax": j_faults, "torch": t_faults}

SPECS = [
    "drop-reply;wid=2;times=3,delay;delay=0.25;times=inf;after=1,"
    "kill-mid-batch;mode=raise",
    "crash-build;wid=0;times=1", "crash-engine;times=inf",
    " corrupt-frame ; wid=3 ,, stale-epoch-reply",
    "kill-during-reshard;mode=exit,blackhole-conn;wid=1,lease-freeze",
    "corrupt-resident;wid=0,corrupt-answer;after=2;times=2",
    "no-such-point", "drop-reply;times", "drop-reply;x=1",
    "kill-mid-batch;mode=explode", "delay;delay=abc", "drop-reply;wid=one",
]


def _parsed(mod, spec):
    try:
        return [vars(r) for r in mod.parse_faults(spec)]
    except ValueError as e:
        return f"ValueError: {e}"


@pytest.mark.parametrize("spec", SPECS)
def test_parse_faults_equals_jax(spec):
    got = {k: _parsed(m, spec) for k, m in FAULTS.items()}
    assert got["torch"] == got["jax"]
    assert t_faults.POINTS == j_faults.POINTS
    assert t_faults.KILL_EXIT_CODE == j_faults.KILL_EXIT_CODE == 86


def _fires(mod):
    inj = mod.FaultInjector(mod.parse_faults(
        "crash-engine;wid=1;times=2;after=1,drop-reply;times=inf"))
    seq = [("crash-engine", 0), ("drop-reply", 1), ("crash-engine", 1),
           ("crash-engine", 1), ("crash-engine", None), ("crash-engine", 1),
           ("drop-reply", 7)]
    return [getattr(inj.fire(p, wid=w), "index", None) for p, w in seq]


def test_injector_counts_equal_jax(monkeypatch):
    assert _fires(t_faults) == _fires(j_faults) == [None, 1, None, 0, 0,
                                                    None, 1]
    monkeypatch.delenv("DOS_FAULTS", raising=False)
    assert t_faults.inject("drop-reply", wid=0) is None
    t_faults.reset()
    monkeypatch.setenv("DOS_FAULTS", "delay;delay=0.1;times=1")
    assert t_faults.inject("delay").delay == 0.1
    assert t_faults.inject("delay") is None
    monkeypatch.setenv("DOS_FAULTS", "delay;delay=0.2;times=1")
    assert t_faults.inject("delay").delay == 0.2
    t_faults.reset()


_CHILD = """
import sys
from {pkg}.testing import faults
print(",".join(str(faults.inject("kill-mid-batch", wid=w) is not None)
               for w in (1, 1, 2, 1)))
"""


def test_faults_state_counts_across_two_processes(tmp_path):
    """Two processes of each package share one ``DOS_FAULTS_STATE``
    budget: the fires and the state file's counts are equal."""
    got = {}
    for pkg in ("distributed_oracle_search_tpu",
                "distributed_oracle_search_tpu_torch"):
        state = str(tmp_path / f"{pkg}.state.json")
        env = {**os.environ, "DOS_FAULTS": "kill-mid-batch;wid=1;times=3;"
               "after=1,kill-mid-batch;wid=2", "DOS_FAULTS_STATE": state,
               "PYTHONPATH": ROOT, "JAX_PLATFORMS": "cpu"}
        outs = [subprocess.run(
            [sys.executable, "-c", _CHILD.format(pkg=pkg)], env=env,
            cwd=ROOT, capture_output=True, text=True, timeout=120,
            check=True).stdout.strip() for _ in range(2)]
        with open(state) as f:
            got[pkg] = (outs, json.load(f))
    assert got["distributed_oracle_search_tpu_torch"] == \
        got["distributed_oracle_search_tpu"]
    outs, counts = got["distributed_oracle_search_tpu_torch"]
    assert outs == ["False,True,True,True", "True,False,False,False"]
    assert counts == {"0": {"seen": 6, "fired": 3},
                      "1": {"seen": 2, "fired": 1}}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A 2-worker ``mod`` conf on a small grid, its index built on the
    CPU by the port, a FIFO-free nfs dir."""
    d = tmp_path_factory.mktemp("faults-world")
    g = synth_city_graph(8, 7, seed=5)
    xy = str(d / "g.xy")
    write_xy(xy, g.xs, g.ys, g.src, g.dst, g.w)
    g = Graph.from_xy(xy)
    scen = str(d / "g.scen")
    write_scen(scen, synth_scenario(g.n, 80, seed=6))
    dc = DistributionController("mod", 2, 2, g.n)
    outdir = str(d / "index")
    for wid in range(2):
        t_cpd.build_worker_shard(g, dc, wid, outdir, chunk=16, device="cpu")
    t_cpd.write_index_manifest(outdir, dc)
    conf = str(d / "conf.json")
    with open(conf, "w") as f:
        json.dump({"workers": ["localhost"] * 2, "partmethod": "mod",
                   "partkey": 2, "outdir": outdir, "xy_file": xy,
                   "scenfile": scen, "diffs": ["-"], "nfs": str(d)}, f)
    q = synth_scenario(g.n, 80, seed=6)
    return conf, g, dc, q[dc.worker_of(q[:, 1]) == 0][:10]


def g_xy(conf):
    with open(conf) as f:
        return json.load(f)["xy_file"]


SERVERS = {"jax": (j_server, JClusterConfig, JRequest, JRuntimeConfig,
                   j_metrics),
           "torch": (t_server, ClusterConfig, Request, RuntimeConfig,
                     t_metrics)}
NAMES = ("server_replies_dropped_total", "server_batches_failed_total",
         "server_replies_sent_total", "faults_injected_total")


def _counts(m):
    snap = m.REGISTRY.snapshot()["counters"]
    return {k: snap.get(k, 0) for k in NAMES}


@pytest.mark.parametrize("spec", [
    "crash-engine;wid=0;times=1", "drop-reply;wid=0;times=1",
    "delay;wid=0;delay=0.3;times=1", "kill-mid-batch;wid=0;mode=raise",
])
def test_server_fault_paths_equal_jax(world, tmp_path, monkeypatch, spec):
    conf, _g, _dc, mine = world
    monkeypatch.setenv("DOS_FAULTS", spec)
    monkeypatch.setenv("DOS_REPLY_DEADLINE_S", "1")
    got = {}
    for pkg, (mod, conf_cls, req_cls, rc_cls, m) in SERVERS.items():
        FAULTS[pkg].reset()
        kw = {"device": "cpu"} if pkg == "torch" else {}
        s = mod.FifoServer(conf_cls.load(conf), 0,
                           command_fifo=str(tmp_path / f"{pkg}.fifo"), **kw)
        th = threading.Thread(target=s.serve_forever, daemon=True)
        th.start()
        for _ in range(200):
            if os.path.exists(s.command_fifo):
                break
            time.sleep(0.02)
        qfile = str(tmp_path / f"query.{pkg}")
        afifo = str(tmp_path / f"answer.{pkg}")
        write_query_file(qfile, mine)
        os.mkfifo(afifo)
        c0 = _counts(m)
        t0 = time.monotonic()
        with open(s.command_fifo, "w") as f:
            f.write(req_cls(rc_cls(), qfile, afifo, "-").encode())
        line = None
        if not spec.startswith(("drop-reply", "kill")):
            with open(afifo) as f:
                line = f.readline().strip()
        else:
            th.join(timeout=5) if spec.startswith("kill") else \
                time.sleep(1.5)
        waited = time.monotonic() - t0
        alive = th.is_alive()
        if alive:
            mod.stop_server(s.command_fifo)
            th.join(timeout=10)
        c1 = _counts(m)
        row = StatsRow.decode(line) if line else None
        got[pkg] = ((row.ok, row.finished) if row else None, alive,
                    {k: c1[k] - c0[k] for k in NAMES})
        if spec.startswith("delay"):
            assert waited >= 0.3
        FAULTS[pkg].reset()
    assert got["torch"] == got["jax"]
    row, alive, delta = got["torch"]
    assert delta["faults_injected_total"] == 1
    if spec.startswith("crash-engine"):
        assert row == (False, 0) and delta["server_batches_failed_total"] == 1
    elif spec.startswith("drop-reply"):
        assert row is None and delta["server_replies_dropped_total"] == 1
    elif spec.startswith("delay"):
        assert row == (True, len(mine))
    else:
        assert row is None and not alive


def test_corrupt_frame_on_both_wires(monkeypatch):
    """``corrupt-frame`` garbles the FIFO script's config line and the RPC
    request's config exactly as the JAX head does."""
    monkeypatch.setenv("DOS_FAULTS", "corrupt-frame;wid=3;times=inf")
    req = Request(RuntimeConfig(k_moves=2), "/q", "/a", "-")
    jreq = JRequest(JRuntimeConfig(k_moves=2), "/q", "/a", "-")
    assert t_fifo.make_script(req, "/c", corrupt=True, answer_wait_s=5) \
        == j_fifo.make_script(jreq, "/c", corrupt=True, answer_wait_s=5)
    for mod in FAULTS.values():
        mod.reset()
    got = [m.request_header(r, "-", wid=w)
           for m, r in ((t_rpc, RuntimeConfig(k_moves=2)),
                        (j_rpc, JRuntimeConfig(k_moves=2)))
           for w in (3, 1)]
    assert got[:2] == got[2:]
    assert got[0]["config"].startswith("CORRUPT ")
    assert isinstance(got[1]["config"], dict)
    for mod in FAULTS.values():
        mod.reset()


def test_corrupt_resident_flips_the_same_row(world, monkeypatch):
    conf, g, dc, _mine = world
    outdir = ClusterConfig.load(conf).outdir
    monkeypatch.setenv("DOS_FAULTS", "corrupt-resident;wid=0;times=inf")
    for mod in FAULTS.values():
        mod.reset()
    t_fm = t_engine.ShardEngine(g, dc, 0, outdir, device="cpu").fm
    j_fm = j_engine.ShardEngine(JGraph.from_xy(g_xy(conf)),
                                JDC("mod", 2, 2, g.n), 0, outdir).fm
    clean = t_engine.load_shard_rows(outdir, 0)
    np.testing.assert_array_equal(t_fm.numpy(), np.asarray(j_fm))
    assert not np.array_equal(t_fm.numpy()[0], clean[0])
    np.testing.assert_array_equal(t_fm.numpy()[1:], clean[1:])
    for mod in FAULTS.values():
        mod.reset()


@pytest.mark.parametrize("pipeline", ["0", "1"])
def test_crash_build_resume_equals_jax(world, tmp_path, monkeypatch,
                                       pipeline):
    """``crash-build;mode=raise`` after the first block: the build raises
    with one ledger line and one block on disk; the rerun resumes that
    block and builds the rest. Blocks and ledger are byte-equal to the
    JAX package's after the same two runs."""
    conf, g, _dc, _mine = world
    monkeypatch.setenv("DOS_BUILD_PIPELINE", pipeline)
    dc = DistributionController("mod", 2, 2, g.n, block_size=8)
    jdc = JDC("mod", 2, 2, g.n, block_size=8)
    jg = JGraph.from_xy(g_xy(conf))
    got = {}
    for pkg, build, gg, dcc in (
            ("torch", lambda o: t_cpd.build_worker_shard(
                g, dc, 0, o, chunk=8, device="cpu"), g, dc),
            ("jax", lambda o: j_cpd.build_worker_shard(
                jg, jdc, 0, o, chunk=8), jg, jdc)):
        out = str(tmp_path / pkg)
        monkeypatch.setenv("DOS_FAULTS", "crash-build;wid=0;times=1;"
                           "mode=raise")
        FAULTS[pkg].reset()
        with pytest.raises(RuntimeError, match="crash-build"):
            build(out)
        first = sorted(f for f in os.listdir(out) if f.endswith(".npy"))
        monkeypatch.delenv("DOS_FAULTS")
        FAULTS[pkg].reset()
        written = build(out)
        files = sorted(os.listdir(out))
        blobs = {}
        for f in files:
            with open(os.path.join(out, f), "rb") as fh:
                blobs[f] = fh.read()
        got[pkg] = (first, sorted(os.path.basename(w) for w in written),
                    blobs)
    assert got["torch"] == got["jax"]
    first, rest, blobs = got["torch"]
    assert len(first) == 1 and first[0] not in rest and len(rest) >= 2
    assert not [f for f in blobs if ".tmp" in f]
