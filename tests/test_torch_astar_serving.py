"""PyTorch port, A* served (``--alg astar``) against the JAX package on
the CPU, exactly (every field but the timers):

(a) ``ShardEngine(alg="astar")``: no shard loaded; answers and the
    ``StatsRow`` counters of the batched path and the heap path
    (``debug``), with ``itrs``, ``no_cache``, diff weights and a 1 ns
    budget at a chunk of 4;
(b) a FIFO server round with ``--alg astar`` (no index directory): the
    stats line and the results file; ``worker.server.main`` accepts the
    flag and dumps the A* kernels' counts;
(c) ``make_fifos --alg astar`` puts the flag on every server's command
    line;
(d) ``process_query`` in-process, the batched default (against JAX's
    ``DOS_ASTAR_DEVICE=1``, its opt-in) and the heap under
    ``DOS_ASTAR_DEVICE=0`` (against JAX's default): the rows of ``run``
    equal JAX ``run``'s;
    ``--extract`` is ignored with a warning; the device path raises
    without a GPU unless asked for the CPU;
(e) a host campaign over A* servers (``process_query --backend host``):
    ``parts.csv`` equals the JAX package's host campaign."""

import csv
import json
import logging
import os
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)

from distributed_oracle_search_tpu.cli import process_query as j_pq  # noqa: E402
from distributed_oracle_search_tpu.cli.args import parse_args as j_parse  # noqa: E402
from distributed_oracle_search_tpu.data import Graph as JGraph  # noqa: E402
from distributed_oracle_search_tpu.parallel.partition import (  # noqa: E402
    DistributionController as JDistributionController,
)
from distributed_oracle_search_tpu.transport.wire import (  # noqa: E402
    RuntimeConfig as JRuntimeConfig,
)
from distributed_oracle_search_tpu.utils.config import (  # noqa: E402
    ClusterConfig as JClusterConfig,
)
from distributed_oracle_search_tpu.worker import server as j_server  # noqa: E402
from distributed_oracle_search_tpu.worker.engine import (  # noqa: E402
    ShardEngine as JShardEngine,
)
from distributed_oracle_search_tpu_torch.cli import make_fifos as t_fifos  # noqa: E402
from distributed_oracle_search_tpu_torch.cli import process_query as t_pq  # noqa: E402
from distributed_oracle_search_tpu_torch.cli.args import parse_args  # noqa: E402
from distributed_oracle_search_tpu_torch.data import (  # noqa: E402
    Graph, synth_city_graph, synth_diff, synth_scenario, write_diff,
    write_scen, write_xy,
)
from distributed_oracle_search_tpu_torch.ops import batched_astar as tba  # noqa: E402
from distributed_oracle_search_tpu_torch.parallel import (  # noqa: E402
    DistributionController,
)
from distributed_oracle_search_tpu_torch.transport.wire import (  # noqa: E402
    Request, RuntimeConfig, StatsRow, read_results_file, write_query_file,
)
from distributed_oracle_search_tpu_torch.utils.config import (  # noqa: E402
    ClusterConfig,
)
from distributed_oracle_search_tpu_torch.worker import server as t_server  # noqa: E402
from distributed_oracle_search_tpu_torch.worker.engine import (  # noqa: E402
    ShardEngine,
)

W = 2
DETERMINISTIC = ("n_expanded", "n_inserted", "n_touched", "n_updated",
                 "n_surplus", "plen", "finished")
TIMERS = ("t_receive", "t_astar", "t_search", "t_prepare", "t_partition")
DEV = ["--device", "cpu"]     # the JAX parser passes it through


@pytest.fixture(autouse=True, scope="module")
def _keep_package_loggers():
    """The CLIs' ``set_verbosity`` gives each package's root logger a
    handler and stops it propagating; put their state back."""
    saved = []
    for name in ("dos_tpu", "dos_torch"):
        lg = logging.getLogger(name)
        saved.append((lg, list(lg.handlers), lg.propagate, lg.level))
    yield
    for lg, handlers, propagate, level in saved:
        lg.handlers[:] = handlers
        lg.propagate = propagate
        lg.setLevel(level)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A city graph's files and two confs over them, neither with an
    index: ``mod`` over 2 localhost workers, and ``tpu`` over 4."""
    d = tmp_path_factory.mktemp("astar-serving")
    g = synth_city_graph(10, 8, seed=3)
    xy = str(d / "city.xy")
    write_xy(xy, g.xs, g.ys, g.src, g.dst, g.w)
    g = Graph.from_xy(xy)
    q = synth_scenario(g.n, 96, seed=5)
    q = np.concatenate([q, q[:6], [[7, 7]]])         # duplicates, s == t
    scen = str(d / "city.scen")
    write_scen(scen, q)
    diff = str(d / "city.diff")
    write_diff(diff, *synth_diff(g, frac=0.2, seed=6))
    nfs = d / "nfs"
    nfs.mkdir()
    confs = {}
    for name, body in (
            ("host", {"workers": ["localhost"] * W, "partmethod": "mod",
                      "partkey": W, "nfs": str(nfs)}),
            ("tpu", {"workers": [f"tpu:{i}" for i in range(4)],
                     "partmethod": "tpu", "partkey": 4})):
        path = str(d / f"{name}.json")
        with open(path, "w") as f:
            json.dump({**body, "outdir": str(d / "no-index"),
                       "xy_file": xy, "scenfile": scen,
                       "diffs": ["-", diff]}, f)
        confs[name] = path
    return {"g": g, "queries": q, "diff": diff, "confs": confs,
            "dir": d}


def _mine(data, wid):
    q = data["queries"]
    dc = DistributionController("mod", W, W, data["g"].n)
    return q[dc.worker_of(q[:, 1]) == wid]


def _engines(data, wid=1):
    g = data["g"]
    jg = JGraph(g.xs, g.ys, g.src, g.dst, g.w)
    outdir = str(data["dir"] / "no-index")
    port = ShardEngine(g, DistributionController("mod", W, W, g.n), wid,
                       outdir, alg="astar", device="cpu")
    jax_ = JShardEngine(jg, JDistributionController("mod", W, W, g.n), wid,
                        outdir, alg="astar")
    return port, jax_


def _same_answers(got, want):
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a, b)
    for f in DETERMINISTIC:
        assert getattr(got[3], f) == getattr(want[3], f), f


@pytest.mark.parametrize("knobs", [
    dict(), dict(hscale=1.5, fscale=0.1), dict(hscale=0.7, fscale=0.5),
    dict(debug=True), dict(debug=True, hscale=1.5, fscale=0.1),
    dict(itrs=2), dict(no_cache=True), dict(k_moves=3, extract=True),
], ids=["default", "h1.5-f0.1", "h0.7-f0.5", "debug", "debug-h1.5",
        "itrs2", "no-cache", "extract-ignored"])
@pytest.mark.parametrize("diff", [False, True], ids=["free", "diff"])
def test_engine_equals_jax(data, knobs, diff):
    """(a) the batched path (one chunk) and the heap path answer and
    count as JAX's engine; no shard is loaded and nothing extracted."""
    port, jax_ = _engines(data)
    assert port.fm is None and port.resident_codec == "raw"
    assert port.resident_bytes == 0 == jax_.resident_bytes
    mine = _mine(data, 1)
    difffile = data["diff"] if diff else "-"
    plain0 = tba.astar_batch.plain
    got = port.answer(mine, RuntimeConfig(**knobs), difffile)
    want = jax_.answer(mine, JRuntimeConfig(**knobs), difffile)
    _same_answers(got, want)
    assert got[3].finished == len(mine)
    assert port.last_paths is None and jax_.last_paths is None
    assert (tba.astar_batch.plain > plain0) != bool(knobs.get("debug"))
    # repeats answer from the cached weights and device graph
    _same_answers(port.answer(mine, RuntimeConfig(**knobs), difffile), got)


@pytest.mark.parametrize("debug", [False, True], ids=["batched", "heap"])
def test_engine_one_ns_budget_at_chunk_4(data, debug):
    """A 1 ns budget: the batched path answers its first chunk of 4 and
    leaves the rest unfinished, the heap path answers none — as JAX."""
    port, jax_ = _engines(data)
    port.time_chunk = 4
    jax_.astar_chunk = 4
    mine = _mine(data, 1)
    cfg = dict(time=1, debug=debug)
    got = port.answer(mine, RuntimeConfig(**cfg), "-")
    want = jax_.answer(mine, JRuntimeConfig(**cfg), "-")
    _same_answers(got, want)
    assert got[3].finished == (0 if debug else 4)


def test_engine_routing_and_empty_batch(data):
    port, _ = _engines(data)
    cost, plen, fin, st = port.answer(np.zeros((0, 2), np.int64),
                                      RuntimeConfig(), "-")
    assert len(cost) == 0 and st.finished == 0
    with pytest.raises(ValueError, match="routing invariant"):
        port.answer(_mine(data, 0), RuntimeConfig(), "-")


def _request(tmp_path, queries, tag, config, diff="-"):
    qfile = str(tmp_path / f"query.{tag}")
    afifo = str(tmp_path / f"answer.{tag}")
    write_query_file(qfile, queries)
    os.mkfifo(afifo)
    return Request(config, qfile, afifo, diff)


def _serve(server):
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    for _ in range(200):
        if os.path.exists(server.command_fifo):
            return th
        time.sleep(0.02)
    pytest.fail("server fifo never appeared")


@pytest.mark.parametrize("knobs", [dict(results=True),
                                   dict(results=True, hscale=1.5,
                                        fscale=0.1, debug=True)],
                         ids=["batched", "heap"])
def test_fifo_server_round_equals_jax(data, tmp_path, knobs):
    """(b) one request to a port and a JAX ``--alg astar`` server (no
    index directory): the stats line's counters and the results file are
    equal; the port's dump counts the A* kernels' plain runs."""
    conf = data["confs"]["host"]
    assert not os.path.exists(ClusterConfig.load(conf).outdir)
    mine = _mine(data, 1)
    servers = {
        "torch": t_server.FifoServer(
            ClusterConfig.load(conf), 1, alg="astar",
            command_fifo=str(tmp_path / "t.fifo"), device="cpu"),
        "jax": j_server.FifoServer(
            JClusterConfig.load(conf), 1, alg="astar",
            command_fifo=str(tmp_path / "j.fifo")),
    }
    got = {}
    for name, s in servers.items():
        th = _serve(s)
        try:
            req = _request(tmp_path, mine, name, RuntimeConfig(**knobs),
                           data["diff"])
            with open(s.command_fifo, "w") as f:
                f.write(req.encode())
            with open(req.answerfifo) as f:
                row = StatsRow.decode(f.readline().strip())
            assert row.ok
            got[name] = (row, read_results_file(req.queryfile + ".results"))
        finally:
            s.stop_file()
            th.join(timeout=10)
    (trow, tres), (jrow, jres) = got["torch"], got["jax"]
    for f in DETERMINISTIC:
        assert getattr(trow, f) == getattr(jrow, f), f
    assert trow.finished == len(mine)
    for a, b in zip(tres, jres):
        np.testing.assert_array_equal(a, b)
    snap = servers["torch"].metrics_snapshot()
    assert snap["alg"] == "astar"
    assert snap["device"]["resident_bytes"] == 0
    assert snap["counters"]["astar_sweep.launches"] == 0
    assert snap["counters"]["astar_heuristic.launches"] == 0


def test_server_main_accepts_alg_astar(data, tmp_path):
    fifo = str(tmp_path / "main.fifo")
    dump = str(tmp_path / "m.json")
    rcs = []
    th = threading.Thread(target=lambda: rcs.append(t_server.main(
        ["-c", data["confs"]["host"], "-w", "0", "--fifo", fifo,
         "--alg", "astar", "--metrics-dump", dump, *DEV])), daemon=True)
    th.start()
    for _ in range(300):
        if os.path.exists(fifo):
            break
        time.sleep(0.02)
    assert t_server.stop_server(fifo)
    th.join(timeout=10)
    assert rcs == [0]
    with open(dump) as f:
        snap = json.load(f)
    assert snap["alg"] == "astar" and snap["device"]["type"] == "cpu"
    assert {"astar_sweep.launches", "astar_batch.plain",
            "astar_heuristic.launches",
            "astar_heuristic.plain"} <= set(snap["counters"])


def test_make_fifos_passes_alg_astar(data, monkeypatch):
    """(c) the server command line carries ``--alg astar``; ``main``
    passes the flag to every launch."""
    cmd = t_fifos.worker_server_cmd(3, "c.json", device="cpu", alg="astar")
    assert " --alg astar " in cmd + " " and "worker.server" in cmd
    assert "--alg table-search" in t_fifos.worker_server_cmd(3, "c.json")
    calls = []
    monkeypatch.setattr(t_fifos, "call_worker",
                        lambda wid, *a, **kw: calls.append((wid, kw)))
    assert t_fifos.main(["-c", data["confs"]["host"], "--alg", "astar",
                         *DEV]) == 0
    assert [w for w, _ in calls] == list(range(W))
    assert all(kw["alg"] == "astar" for _, kw in calls)


def _rows(stats):
    from distributed_oracle_search_tpu_torch.transport.wire import (
        STATS_HEADER,
    )
    keep = [i for i, h in enumerate(STATS_HEADER[1:]) if h not in TIMERS]
    return [[[row[i] for i in keep] for row in expe] for expe in stats]


@pytest.mark.parametrize("argv", [
    [], ["--h-scale", "1.5", "--f-scale", "0.1"], ["--ns-lim", "1"],
    ["-w", "2"],
], ids=["default", "h1.5-f0.1", "ns-lim", "worker"])
@pytest.mark.parametrize("port_env, jax_env", [
    ("", "1"), ("1", "1"), ("0", ""),
], ids=["device-default", "device", "heap"])
def test_process_query_equals_jax(data, monkeypatch, argv, port_env,
                                  jax_env):
    """(d) in-process A* rounds (free flow, diff): every row of the port's
    ``run`` equals JAX ``run``'s, timers aside. The port's default is the
    batched search, JAX's the heap: each side runs under its own
    ``DOS_ASTAR_DEVICE``."""
    conf = data["confs"]["tpu"]
    monkeypatch.setenv("DOS_ASTAR_DEVICE", port_env)
    _, got, _ = t_pq.run(ClusterConfig.load(conf),
                         parse_args(["--alg", "astar", *argv, *DEV]))
    monkeypatch.setenv("DOS_ASTAR_DEVICE", jax_env)
    _, want, _ = j_pq.run(JClusterConfig.load(conf),
                          j_parse(["--alg", "astar", *argv]))
    assert _rows(got) == _rows(want)
    assert len(got) == 2
    if not argv:
        n = len(data["queries"])
        for expe in got:
            assert sum(r[6] for r in expe) == n and sum(r[-1]
                                                        for r in expe) == n
            assert sum(r[0] for r in expe) > 0


def test_process_query_extract_ignored_for_astar(data, tmp_path,
                                                 monkeypatch, caplog):
    monkeypatch.delenv("DOS_ASTAR_DEVICE", raising=False)
    out = str(tmp_path / "out")
    with caplog.at_level(logging.WARNING):
        rc = t_pq.main(["-c", data["confs"]["tpu"], "--alg", "astar", "-k",
                        "4", "--extract", "-o", out, *DEV])
    assert rc == 0 and not os.path.exists(os.path.join(out, "paths.csv"))
    assert os.path.exists(os.path.join(out, "parts.csv"))
    assert not os.path.exists(ClusterConfig.load(
        data["confs"]["tpu"]).outdir)


@pytest.mark.parametrize("env", ["", "1"], ids=["default", "device"])
def test_process_query_device_path_needs_a_gpu(data, monkeypatch, env):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("DOS_ASTAR_DEVICE", env)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_pq.run(ClusterConfig.load(data["confs"]["tpu"]),
                 parse_args(["--alg", "astar"]))


def _parts(path):
    with open(path) as f:
        rows = list(csv.reader(f))
    keep = [i for i, h in enumerate(rows[0]) if h not in TIMERS]
    return [[r[i] for i in keep] for r in rows]


@pytest.mark.parametrize("argv", [[], ["--h-scale", "1.5", "--debug"]],
                         ids=["batched", "heap"])
def test_host_campaign_over_astar_servers_equals_jax(data, tmp_path,
                                                     monkeypatch, argv):
    """(e) each package's head over its own ``--alg astar`` servers (in
    threads, on FIFOs under ``tmp_path``): the same ``parts.csv``."""
    conf = data["confs"]["host"]
    got = {}
    for name, (mod, conf_cls, head, kw) in {
            "torch": (t_server, ClusterConfig, t_pq, {"device": "cpu"}),
            "jax": (j_server, JClusterConfig, j_pq, {})}.items():
        fifos = {w: str(tmp_path / f"{name}-w{w}.fifo") for w in range(W)}
        monkeypatch.setattr(head, "command_fifo_path", lambda w: fifos[w])
        servers = [mod.FifoServer(conf_cls.load(conf), w, alg="astar",
                                  command_fifo=fifos[w], **kw)
                   for w in range(W)]
        threads = [_serve(s) for s in servers]
        out = str(tmp_path / f"{name}-out")
        try:
            rc = head.main(["-c", conf, "--backend", "host", "-o", out,
                            *argv, *DEV])
        finally:
            for s, th in zip(servers, threads):
                mod.stop_server(s.command_fifo)
                th.join(timeout=10)
        assert rc == 0
        got[name] = _parts(os.path.join(out, "parts.csv"))
    assert got["torch"] == got["jax"]
    head_row, rows = got["torch"][0], got["torch"][1:]
    n = len(data["queries"])
    for expe in ("0", "1"):
        mine = [r for r in rows if r[0] == expe]
        assert sum(int(r[head_row.index("finished")]) for r in mine) == n
