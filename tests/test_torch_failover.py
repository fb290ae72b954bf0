"""PyTorch port, the head's failover over replicas against the JAX
package's: a replicated (``replication: 2``) 4-worker host campaign over
in-thread servers, with one fault armed on worker 1 — ``drop-reply``,
``kill-mid-batch;mode=raise`` or ``crash-engine`` — over the FIFO wire
and over the RPC lane. The port's head and servers and the JAX package's
give the same ``parts.csv`` (every column but the timers), the same
``degraded.json`` (or none), exit code, ``failover_total`` and
``server_replica_batches_total`` deltas, and the same breaker states at
the campaign's end; every query is answered, shard 1's batches by worker
2, the holder of its replica."""

import csv
import json
import os
import threading
import time

import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)

from distributed_oracle_search_tpu.cli import process_query as j_pq  # noqa: E402
from distributed_oracle_search_tpu.obs import metrics as j_metrics  # noqa: E402
from distributed_oracle_search_tpu.testing import faults as j_faults  # noqa: E402
from distributed_oracle_search_tpu.transport import resilience as j_res  # noqa: E402
from distributed_oracle_search_tpu.transport import rpc as j_rpc  # noqa: E402
from distributed_oracle_search_tpu.utils.config import (  # noqa: E402
    ClusterConfig as JClusterConfig,
)
from distributed_oracle_search_tpu.worker import server as j_server  # noqa: E402
from distributed_oracle_search_tpu_torch.cli import process_query as t_pq  # noqa: E402
from distributed_oracle_search_tpu_torch.data import (  # noqa: E402
    Graph, read_scen, synth_city_graph, synth_diff, synth_scenario,
    write_diff, write_scen, write_xy,
)
from distributed_oracle_search_tpu_torch.models.cpd import (  # noqa: E402
    build_worker_shard, write_index_manifest,
)
from distributed_oracle_search_tpu_torch.obs import metrics as t_metrics  # noqa: E402
from distributed_oracle_search_tpu_torch.parallel import (  # noqa: E402
    DistributionController,
)
from distributed_oracle_search_tpu_torch.testing import faults as t_faults  # noqa: E402
from distributed_oracle_search_tpu_torch.transport import resilience as t_res  # noqa: E402
from distributed_oracle_search_tpu_torch.transport import rpc as t_rpc  # noqa: E402
from distributed_oracle_search_tpu_torch.utils.config import (  # noqa: E402
    ClusterConfig,
)
from distributed_oracle_search_tpu_torch.worker import server as t_server  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W = 4
TIMERS = ("t_receive", "t_astar", "t_search", "t_prepare", "t_partition")
PKG = {"jax": (j_server, JClusterConfig, j_pq, j_metrics, j_faults, j_res,
               j_rpc),
       "torch": (t_server, ClusterConfig, t_pq, t_metrics, t_faults, t_res,
                 t_rpc)}
COUNTERS = ("failover_total", "server_replica_batches_total",
            "head_circuit_open_total", "head_batches_failed_total")


@pytest.fixture(scope="module")
def conf(tmp_path_factory):
    """A replication-2 ``mod`` conf over 4 localhost workers, the index
    built by the port on the CPU (replica engines load the primary block
    set: the rows are the same)."""
    d = tmp_path_factory.mktemp("failover")
    g = synth_city_graph(9, 7, seed=21)
    xy = str(d / "g.xy")
    write_xy(xy, g.xs, g.ys, g.src, g.dst, g.w)
    g = Graph.from_xy(xy)
    scen = str(d / "g.scen")
    write_scen(scen, synth_scenario(g.n, 120, seed=22))
    diff = str(d / "g.diff")
    write_diff(diff, *synth_diff(g, frac=0.2, seed=23))
    dc = DistributionController("mod", W, W, g.n)
    outdir = str(d / "index")
    for wid in range(W):
        build_worker_shard(g, dc, wid, outdir, chunk=16, device="cpu")
    write_index_manifest(outdir, dc)
    path = str(d / "conf.json")
    with open(path, "w") as f:
        json.dump({"workers": ["localhost"] * W, "partmethod": "mod",
                   "partkey": W, "outdir": outdir, "xy_file": xy,
                   "scenfile": scen, "diffs": ["-", diff],
                   "nfs": str(d), "replication": 2, "projectdir": ROOT}, f)
    # one fault-free JAX campaign first: its engines compile their walk
    # programs here, so no batch of the timed cases waits on a compile
    (d / "warm").mkdir()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DOS_TRANSPORT", "fifo")
        mp.delenv("DOS_FAULTS", raising=False)
        assert _run("jax", path, d / "warm", mp, "fifo")[0] == 0
    return path


def _parts(path):
    with open(path) as f:
        rows = list(csv.reader(f))
    keep = [i for i, h in enumerate(rows[0]) if h not in TIMERS]
    return [[r[i] for i in keep] for r in rows]


def _run(pkg, conf, tmp, monkeypatch, transport, extra=()):
    """One campaign of package ``pkg`` (its head, its in-thread servers,
    each with an RPC loop when ``transport`` is rpc)."""
    server, conf_cls, pq, metrics, faults, res, rpc = PKG[pkg]
    fifos = {w: str(tmp / f"w{w}.fifo") for w in range(W)}
    monkeypatch.setattr(pq, "command_fifo_path", lambda w: fifos[w])
    monkeypatch.setenv("DOS_RPC_SOCKET_DIR", str(tmp))
    kw = {"device": "cpu"} if pkg == "torch" else {}
    servers = [server.FifoServer(conf_cls.load(conf), w,
                                 command_fifo=fifos[w], **kw)
               for w in range(W)]
    threads = [threading.Thread(target=s.serve_forever, daemon=True)
               for s in servers]
    for th in threads:
        th.start()
    for f in fifos.values():
        for _ in range(200):
            if os.path.exists(f):
                break
            time.sleep(0.02)
    loops = ([server.RpcServeLoop(s).start() for s in servers]
             if transport == "rpc" else [])
    breakers = []
    real_shutdown = res.BreakerRegistry.shutdown

    def shutdown(self, *a, **k):
        breakers.append(self.snapshot())
        return real_shutdown(self, *a, **k)

    monkeypatch.setattr(res.BreakerRegistry, "shutdown", shutdown)
    faults.reset()
    c0 = metrics.REGISTRY.snapshot()["counters"]
    out = str(tmp / "out")
    try:
        rc = pq.main(["-c", conf, "--backend", "host", "-o", out,
                      "--device", "cpu", *extra])
    finally:
        for f in fifos.values():
            server.stop_server(f, deadline_s=1.0)
        for th in threads:
            th.join(timeout=10)
        for loop in loops:
            loop.stop()
        rpc.close_clients()
        faults.reset()
    c1 = metrics.REGISTRY.snapshot()["counters"]
    degraded = None
    if os.path.exists(os.path.join(out, "degraded.json")):
        with open(os.path.join(out, "degraded.json")) as f:
            degraded = json.load(f)
    return (rc, _parts(os.path.join(out, "parts.csv")), degraded,
            {k: c1.get(k, 0) - c0.get(k, 0) for k in COUNTERS}, breakers)


@pytest.mark.parametrize("transport", ["fifo", "rpc"])
@pytest.mark.parametrize("spec", [
    "drop-reply;wid=1;times=1", "kill-mid-batch;wid=1;mode=raise",
    "crash-engine;wid=1;times=1",
])
def test_replicated_campaign_under_faults_equals_jax(conf, tmp_path,
                                                     monkeypatch, spec,
                                                     transport):
    monkeypatch.setenv("DOS_TRANSPORT", transport)
    monkeypatch.setenv("DOS_FAULTS", spec)
    monkeypatch.setenv("DOS_RETRY_MAX", "0")
    monkeypatch.setenv("DOS_SEND_TIMEOUT_S", "2")
    monkeypatch.setenv("DOS_RPC_TIMEOUT_S", "2")
    monkeypatch.setenv("DOS_REPLY_DEADLINE_S", "1")
    monkeypatch.setenv("DOS_CIRCUIT_THRESHOLD", "1")
    monkeypatch.setenv("DOS_CIRCUIT_COOLDOWN_S", "600")
    got = {}
    for pkg in ("jax", "torch"):
        d = tmp_path / pkg
        d.mkdir()
        got[pkg] = _run(pkg, conf, d, monkeypatch, transport)
    assert got["torch"] == got["jax"]
    rc, parts, degraded, delta, breakers = got["torch"]
    n = len(read_scen(ClusterConfig.load(conf).scenfile))
    head, rows = parts[0], parts[1:]
    assert rc == 0 and degraded is None
    assert sum(int(r[head.index("finished")]) for r in rows) == 2 * n
    # shard 1's failed batch moved to worker 2, and its breaker opened:
    # every later batch of shard 1 skipped it
    assert delta["failover_total"] == 2
    assert delta["server_replica_batches_total"] == 2
    assert delta["head_circuit_open_total"] == 1
    assert breakers[0]["('localhost', 1)"]["state"] == "open"
    assert all(b["state"] == "closed" for k, b in breakers[0].items()
               if k != "('localhost', 1)")


def test_every_replica_failing_degrades_as_jax(conf, tmp_path,
                                               monkeypatch):
    """``crash-engine`` on workers 1 and 2 (shard 1 and its replica
    holder) for every batch, ``-w 1``: round 0's batch fails on both
    candidates and opens both breakers, round 1's finds both open. Both
    are booked in ``degraded.json`` with the replica trail and the
    campaign exits 4 (every batch failed), as under the JAX head."""
    monkeypatch.setenv("DOS_TRANSPORT", "fifo")
    monkeypatch.setenv("DOS_FAULTS", "crash-engine;wid=1;times=inf,"
                       "crash-engine;wid=2;times=inf")
    monkeypatch.setenv("DOS_RETRY_MAX", "0")
    monkeypatch.setenv("DOS_CIRCUIT_THRESHOLD", "1")
    monkeypatch.setenv("DOS_CIRCUIT_COOLDOWN_S", "600")
    got = {}
    for pkg in ("jax", "torch"):
        d = tmp_path / pkg
        d.mkdir()
        got[pkg] = _run(pkg, conf, d, monkeypatch, "fifo", ["-w", "1"])
    assert got["torch"] == got["jax"]
    rc, _parts_, degraded, delta, breakers = got["torch"]
    assert rc == 4 and degraded["exit_code"] == 4
    assert degraded["failed_workers"] == [1]
    trails = [(b["round"], b["reason"],
               [(r["wid"], r["reason"]) for r in b["replicas_tried"]])
              for b in degraded["failed_batches"]]
    assert trails == [(0, "send-failed", [(1, "send-failed"),
                                          (2, "send-failed")]),
                      (1, "circuit-open", [(1, "circuit-open"),
                                           (2, "circuit-open")])]
    assert delta["head_batches_failed_total"] == 2
    assert delta["failover_total"] == 1
    assert {b["state"] for b in breakers[0].values()} == {"open"}
