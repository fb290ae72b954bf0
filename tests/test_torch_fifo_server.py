"""PyTorch port, the resident FIFO server (``worker.server``) on the CPU,
in a thread on a FIFO under ``tmp_path`` (never ``/tmp/worker*.fifo``).
Its serve loop must survive what the reference's wedged on: a malformed
request gets ``FAIL``; back-to-back writers each get their reply; a half
frame is dropped and the next frame served; a stop token wins, also
after a truncated request; a ping gets a health line; a reader that
never opens does not wedge the loop; an engine error answers ``FAIL``.
A served batch's stats line, paths and results files equal the JAX
package's server's on the same request (deterministic fields exactly).
``--metrics-dump`` carries the counters, the walk's launches and plain
walks, and the device; ``--traffic-dir`` gates diff epochs, the L2
(``DOS_GATEWAY_L2_BYTES``) answers repeats, and the RPC and scrape flags
serve as the JAX server's do; the one refused knob names its
``ROADMAP.md`` item."""

import json
import os
import socket
import threading
import time
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)

from distributed_oracle_search_tpu.utils.config import (  # noqa: E402
    ClusterConfig as JClusterConfig,
)
from distributed_oracle_search_tpu.worker import server as j_server  # noqa: E402
from distributed_oracle_search_tpu_torch.data import (  # noqa: E402
    Graph, synth_city_graph, synth_diff, synth_scenario, write_diff,
    write_scen, write_xy,
)
from distributed_oracle_search_tpu_torch.models.cpd import (  # noqa: E402
    build_worker_shard, write_index_manifest,
)
from distributed_oracle_search_tpu_torch.parallel import (  # noqa: E402
    DistributionController,
)
from distributed_oracle_search_tpu_torch.transport import fifo as t_fifo  # noqa: E402
from distributed_oracle_search_tpu_torch.transport import rpc as t_rpc  # noqa: E402
from distributed_oracle_search_tpu_torch.transport.wire import (  # noqa: E402
    HealthStatus, Request, RuntimeConfig, StatsRow, read_paths_file,
    read_results_file, write_query_file,
)
from distributed_oracle_search_tpu_torch.utils.config import (  # noqa: E402
    ClusterConfig,
)
from distributed_oracle_search_tpu_torch.worker import server as t_server  # noqa: E402

DETERMINISTIC = ("n_expanded", "n_inserted", "n_touched", "n_updated",
                 "n_surplus", "plen", "finished")


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    """A 2-worker ``mod`` conf on a small city grid, its index built on
    the CPU; returns ``(conf path, graph, controller, queries, diff)``."""
    d = tmp_path_factory.mktemp("fifo-cluster")
    g = synth_city_graph(10, 8, seed=3)
    xy = str(d / "city.xy")
    write_xy(xy, g.xs, g.ys, g.src, g.dst, g.w)
    g = Graph.from_xy(xy)
    scen = str(d / "city.scen")
    queries = synth_scenario(g.n, 120, seed=5)
    write_scen(scen, queries)
    diff = str(d / "city.diff")
    write_diff(diff, *synth_diff(g, frac=0.2, seed=6))
    outdir = str(d / "index")
    dc = DistributionController("mod", 2, 2, g.n)
    for wid in range(2):
        build_worker_shard(g, dc, wid, outdir, chunk=16, device="cpu")
    write_index_manifest(outdir, dc)
    conf = str(d / "conf.json")
    nfs = d / "nfs"
    nfs.mkdir()
    with open(conf, "w") as f:
        json.dump({"workers": ["localhost", "localhost"],
                   "partmethod": "mod", "partkey": 2, "outdir": outdir,
                   "xy_file": xy, "scenfile": scen, "diffs": ["-", diff],
                   "nfs": str(nfs)}, f)
    return conf, g, dc, queries, diff


def _server(cluster, tmp_path, wid=0, name="w"):
    conf = ClusterConfig.load(cluster[0])
    return t_server.FifoServer(conf, wid,
                               command_fifo=str(tmp_path / f"{name}.fifo"),
                               device="cpu")


def _serve(server):
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    for _ in range(200):
        if os.path.exists(server.command_fifo):
            return th
        time.sleep(0.02)
    pytest.fail("server fifo never appeared")


def _stop(server, th):
    t_server.stop_server(server.command_fifo)
    th.join(timeout=10)
    assert not th.is_alive()


def _push(fifo, text):
    with open(fifo, "w") as f:
        f.write(text)


def _answer(path):
    with open(path) as f:                 # blocks until the server writes
        return f.readline().strip()


def _request(tmp_path, queries, tag, config=None, diff="-"):
    qfile = str(tmp_path / f"query.{tag}")
    afifo = str(tmp_path / f"answer.{tag}")
    write_query_file(qfile, queries)
    os.mkfifo(afifo)
    return Request(config or RuntimeConfig(), qfile, afifo, diff)


def _mine(cluster, wid=0, n=12):
    _, _, dc, queries, _ = cluster
    return queries[dc.worker_of(queries[:, 1]) == wid][:n]


@pytest.mark.parametrize("kind", ["stray", "undecodable"])
def test_malformed_request_gets_fail(cluster, tmp_path, kind):
    s = _server(cluster, tmp_path)
    answer = str(tmp_path / "ans.fifo")
    os.mkfifo(answer)
    before = dict(s.counters)
    th = _serve(s)
    try:
        _push(s.command_fifo, f"this is not a frame {answer} -\n"
              if kind == "stray" else '{"itrs": 1}\n' + f"q {answer}\n")
        assert _answer(answer) == "FAIL"
    finally:
        _stop(s, th)
    after = s.counters
    assert (after["server_frames_malformed_total"]
            == before["server_frames_malformed_total"] + 1)
    assert (after["server_frames_received_total"]
            == before["server_frames_received_total"] + 1)


def test_back_to_back_writers_each_answered(cluster, tmp_path):
    s = _server(cluster, tmp_path)
    mine = _mine(cluster)
    th = _serve(s)
    try:
        reqs = [_request(tmp_path, mine, f"b2b{k}") for k in range(8)]
        for req in reqs:                  # all queued before any read
            _push(s.command_fifo, req.encode())
        for req in reqs:
            row = StatsRow.decode(_answer(req.answerfifo))
            assert row.ok and row.finished == row.n_touched == len(mine)
    finally:
        _stop(s, th)


def test_half_frame_dropped_next_frame_served(cluster, tmp_path):
    s = _server(cluster, tmp_path)
    s.FRAME_TIMEOUT_S = 0.15
    mine = _mine(cluster)
    before = dict(s.counters)
    th = _serve(s)
    try:
        _push(s.command_fifo, '{"itrs": 1}\n')      # line 2 never comes
        time.sleep(0.5)
        req = _request(tmp_path, mine, "after-half")
        _push(s.command_fifo, req.encode())
        assert StatsRow.decode(_answer(req.answerfifo)).ok
        # a config line where line 2 belongs starts the next frame
        req2 = _request(tmp_path, mine, "after-cfg")
        _push(s.command_fifo, '{"itrs": 2}\n' + req2.encode())
        assert StatsRow.decode(_answer(req2.answerfifo)).ok
    finally:
        _stop(s, th)
    assert (s.counters["server_frames_half_total"]
            == before["server_frames_half_total"] + 2)


@pytest.mark.parametrize("truncated", [False, True])
def test_stop_token_stops_the_loop(cluster, tmp_path, truncated):
    s = _server(cluster, tmp_path)
    th = _serve(s)
    if truncated:
        _push(s.command_fifo, '{"itrs": 1}\n')
    assert t_server.stop_server(s.command_fifo)
    th.join(timeout=10)
    assert not th.is_alive()
    assert not os.path.exists(s.command_fifo)
    assert not t_server.stop_server(s.command_fifo, deadline_s=0.2)


def test_ping_gets_health_line(cluster, tmp_path):
    s = _server(cluster, tmp_path, wid=1, name="ping")
    th = _serve(s)
    before = dict(s.counters)
    try:
        st = t_fifo.probe("localhost", 1, command_fifo=s.command_fifo,
                          nfs=str(tmp_path), timeout=5.0)
        assert isinstance(st, HealthStatus)
        assert st.ok and st.wid == 1 and st.pid == os.getpid()
        assert st.batches == 0 and st.uptime_s >= 0
    finally:
        _stop(s, th)
    after = s.counters
    assert (after["server_pings_answered_total"]
            == before["server_pings_answered_total"] + 1)
    assert (after["server_frames_received_total"]
            == before["server_frames_received_total"])
    assert t_fifo.probe("localhost", 1, command_fifo=s.command_fifo,
                        nfs=str(tmp_path), timeout=1.0) is None


def test_reader_that_never_opens_does_not_wedge(cluster, tmp_path,
                                                monkeypatch):
    monkeypatch.setenv("DOS_REPLY_DEADLINE_S", "0.3")
    s = _server(cluster, tmp_path)
    mine = _mine(cluster)
    before = dict(s.counters)
    th = _serve(s)
    try:
        req = _request(tmp_path, mine, "nobody")   # nobody reads it
        _push(s.command_fifo, req.encode())
        req2 = _request(tmp_path, mine, "somebody")
        _push(s.command_fifo, req2.encode())
        assert StatsRow.decode(_answer(req2.answerfifo)).ok
        st = t_fifo.probe("localhost", 0, command_fifo=s.command_fifo,
                          nfs=str(tmp_path), timeout=5.0)
        assert st is not None and st.batches == 2
    finally:
        _stop(s, th)
    assert (s.counters["server_replies_dropped_total"]
            == before["server_replies_dropped_total"] + 1)


def test_engine_error_answers_fail(cluster, tmp_path):
    s = _server(cluster, tmp_path)
    th = _serve(s)
    before = dict(s.counters)
    try:
        afifo = str(tmp_path / "answer.err")
        os.mkfifo(afifo)
        req = Request(RuntimeConfig(), str(tmp_path / "no-such-query"),
                      afifo, "-")
        _push(s.command_fifo, req.encode())
        assert _answer(afifo) == "FAIL"
        # a batch for another worker's targets breaks the routing
        # invariant: FAIL too, never a zero row
        req2 = _request(tmp_path, _mine(cluster, wid=1), "misrouted")
        _push(s.command_fifo, req2.encode())
        assert _answer(req2.answerfifo) == "FAIL"
        st = t_fifo.probe("localhost", 0, command_fifo=s.command_fifo,
                          nfs=str(tmp_path), timeout=5.0)
        assert st.batch_failures == 2 and "routing" in st.last_error
    finally:
        _stop(s, th)
    assert (s.counters["server_batches_failed_total"]
            == before["server_batches_failed_total"] + 2)


@pytest.mark.parametrize("rconf", [
    dict(), dict(k_moves=3), dict(k_moves=4, extract=True, results=True),
    dict(results=True, itrs=2, no_cache=True),
], ids=["plain", "k3", "extract-results", "results-itrs"])
@pytest.mark.parametrize("diff", ["free", "diff"])
def test_batch_equals_jax_server(cluster, tmp_path, rconf, diff):
    """The same request to a port server and to a JAX server: the stats
    line's deterministic fields, the paths file and the results file are
    equal."""
    conf_path, _, _, _, diff_path = cluster
    difffile = diff_path if diff == "diff" else "-"
    mine = _mine(cluster, wid=1, n=40)
    servers = {
        "torch": t_server.FifoServer(
            ClusterConfig.load(conf_path), 1,
            command_fifo=str(tmp_path / "t.fifo"), device="cpu"),
        "jax": j_server.FifoServer(
            JClusterConfig.load(conf_path), 1,
            command_fifo=str(tmp_path / "j.fifo")),
    }
    got = {}
    for name, s in servers.items():
        th = _serve(s)
        try:
            req = _request(tmp_path, mine, name, RuntimeConfig(**rconf),
                           difffile)
            _push(s.command_fifo, req.encode())
            row = StatsRow.decode(_answer(req.answerfifo))
            assert row.ok
            extra = {}
            if rconf.get("extract"):
                extra["paths"] = read_paths_file(req.queryfile + ".paths")
            if rconf.get("results"):
                extra["results"] = read_results_file(
                    req.queryfile + ".results")
            got[name] = (row, extra)
        finally:
            s.stop_file()
            th.join(timeout=10)
    (trow, textra), (jrow, jextra) = got["torch"], got["jax"]
    for f in DETERMINISTIC:
        assert getattr(trow, f) == getattr(jrow, f), f
    assert trow.n_touched == len(mine)
    if "k_moves" not in rconf:            # a move budget cuts walks short
        assert trow.finished == len(mine)
    assert textra.keys() == jextra.keys()
    for key in textra:
        for a, b in zip(textra[key], jextra[key]):
            np.testing.assert_array_equal(a, b)


def test_metrics_snapshot_and_dump(cluster, tmp_path):
    s = _server(cluster, tmp_path)
    th = _serve(s)
    plain0 = t_server.cuda_walk_batch.plain
    try:
        req = _request(tmp_path, _mine(cluster), "m")
        _push(s.command_fifo, req.encode())
        assert StatsRow.decode(_answer(req.answerfifo)).ok
    finally:
        _stop(s, th)
    snap = s.metrics_snapshot()
    c = snap["counters"]
    assert c["cuda_walk_batch.plain"] > plain0
    assert c["cuda_walk_batch.launches"] == 0
    assert c["cuda_walk_batch.launches_pack4"] == 0
    assert c["worker_batches_total"] >= 1 and c["worker_queries_total"] >= 1
    assert set(t_server.COUNTER_NAMES) <= set(c)
    assert snap["device"]["name"] == "cpu" and snap["wid"] == 0
    assert snap["device"]["resident_codec"] == "raw"


def test_main_writes_metrics_dump(cluster, tmp_path):
    conf = cluster[0]
    fifo = str(tmp_path / "main.fifo")
    dump = str(tmp_path / "m.json")
    rcs = []
    th = threading.Thread(target=lambda: rcs.append(t_server.main(
        ["-c", conf, "-w", "1", "--fifo", fifo, "--device", "cpu",
         "--metrics-dump", dump])), daemon=True)
    th.start()
    st = None
    for _ in range(100):
        st = t_fifo.probe("localhost", 1, command_fifo=fifo,
                          nfs=str(tmp_path), timeout=2.0)
        if st is not None:
            break
        time.sleep(0.05)
    assert st is not None and st.wid == 1
    assert t_server.stop_server(fifo)
    th.join(timeout=10)
    assert rcs == [0]
    with open(dump) as f:
        snap = json.load(f)
    assert snap["device"]["type"] == "cpu" and snap["wid"] == 1
    assert "server_pings_answered_total" in snap["counters"]


def _free_port() -> int:
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def _main_server(pkg, conf, fifo, extra):
    """Run package ``pkg``'s ``worker.server.main`` in a thread until its
    FIFO answers a ping; returns ``(thread, exit codes)``."""
    mod = t_server if pkg == "torch" else j_server
    dev = ["--device", "cpu"] if pkg == "torch" else []
    rcs = []
    th = threading.Thread(target=lambda: rcs.append(mod.main(
        ["-c", conf, "-w", "0", "--fifo", fifo, *dev, *extra])),
        daemon=True)
    th.start()
    nfs = os.path.dirname(fifo)
    for _ in range(300):
        if (os.path.exists(fifo) and t_fifo.probe(
                "localhost", 0, command_fifo=fifo, nfs=nfs,
                timeout=2.0) is not None):
            return th, rcs
        time.sleep(0.05)
    pytest.fail(f"{pkg} server never answered a ping")


def _rpc_batch(endpoint, mine):
    client = t_rpc.RpcClient(endpoint, timeout_s=30.0)
    try:
        fr = client.call({"kind": "req", "config": {"results": True},
                          "diff": "-"}, [np.asarray(mine, np.int64)])
    finally:
        client.close()
    return (fr.header["stats"], fr.header.get("res"),
            [np.array(a) for a in fr.arrays])


def _scrape(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as r:
        return r.status, r.headers["Content-Type"], r.read().decode()


def _fifo_batch(tmp_path, fifo, tag, queries, config):
    """One FIFO request to a running server; ``(stats line, results)``
    with ``results`` None when the server wrote no sidecar."""
    req = _request(tmp_path, queries, tag, config)
    _push(fifo, req.encode())
    line = _answer(req.answerfifo)
    res = (read_results_file(req.queryfile + ".results")
           if os.path.exists(req.queryfile + ".results") else None)
    return line, res


@pytest.mark.parametrize("argv,item", [
    (["--traffic-dir", "{traffic}"], "A14"),
    (["--rpc-socket", "{sock}"], "A14"),
    (["--rpc-port", "{port}"], "A14"), (["--obs-port", "{port}"], "A14"),
])
def test_server_refused_flags_name_roadmap(cluster, tmp_path, argv, item):
    """The JAX server's flags, refused until A14 ported them, serve as
    the JAX server's do: ``--traffic-dir`` gates the diff epoch (a batch
    fused at an epoch the stream does not show yet answers ``STALE_DIFF``
    from both packages; once the segment lands the same batch is served,
    with equal answers), one batch over the RPC lane gets the same stats
    line and answers from both packages' servers, and ``/healthz`` /
    ``/metrics`` answer with the same keys and types."""
    from distributed_oracle_search_tpu_torch.traffic import write_segment

    mine = _mine(cluster)
    got = {}
    g = cluster[1]
    for pkg in ("torch", "jax"):
        sock = str(tmp_path / f"{pkg}.sock")
        port = _free_port()
        traffic = str(tmp_path / f"{pkg}-traffic")
        os.makedirs(traffic)
        extra = [a.format(sock=sock, port=port, traffic=traffic)
                 for a in argv]
        fifo = str(tmp_path / f"{pkg}.fifo")
        th, rcs = _main_server(pkg, cluster[0], fifo, extra)
        try:
            if argv[0] == "--traffic-dir":
                cfg = RuntimeConfig(results=True, diff_epoch=1)
                stale = _fifo_batch(tmp_path, fifo, f"{pkg}-s", mine, cfg)
                write_segment(traffic, 1, g.src[:3], g.dst[:3],
                              g.w[:3] + 5)
                served = _fifo_batch(tmp_path, fifo, f"{pkg}-ok", mine,
                                     cfg)
                got[pkg] = (stale, served)
            elif argv[0] == "--rpc-socket":
                got[pkg] = _rpc_batch(("unix", sock, None), mine)
            elif argv[0] == "--rpc-port":
                got[pkg] = _rpc_batch(("tcp", "127.0.0.1", port), mine)
            else:
                code, ctype, body = _scrape(port, "/healthz")
                m_code, m_type, metrics = _scrape(port, "/metrics")
                got[pkg] = (code, sorted(json.loads(body)), m_code,
                            m_type, "server_pings_answered_total" in metrics)
        finally:
            t_server.stop_server(fifo)
            th.join(timeout=20)
        assert rcs == [0], pkg
    if argv[0] == "--traffic-dir":
        (t_stale, t_ok), (j_stale, j_ok) = got["torch"], got["jax"]
        assert t_stale == j_stale == ("STALE_DIFF", None)
        trow, jrow = StatsRow.decode(t_ok[0]), StatsRow.decode(j_ok[0])
        assert trow.ok and trow.finished == len(mine)
        for f in DETERMINISTIC:
            assert getattr(trow, f) == getattr(jrow, f), f
        for a, b in zip(t_ok[1], j_ok[1]):
            np.testing.assert_array_equal(a, b)
        return
    if argv[0] == "--obs-port":
        assert got["torch"] == got["jax"]
        assert got["torch"][0] == 200 and got["torch"][-1]
        return
    (t_stats, t_res, t_arr), (j_stats, j_res, j_arr) = \
        got["torch"], got["jax"]
    trow, jrow = StatsRow.decode(t_stats), StatsRow.decode(j_stats)
    for f in DETERMINISTIC:
        assert getattr(trow, f) == getattr(jrow, f), f
    assert trow.ok and trow.finished == len(mine) and t_res == j_res
    assert len(t_arr) == len(j_arr) == 3
    for a, b in zip(t_arr, j_arr):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("knob,value,item", [
    ("DOS_TELEMETRY_INTERVAL_S", "0.5", "A14.5"),
    ("DOS_GATEWAY_L2_BYTES", "4096", "A14.3"),
])
def test_server_refuses_unported_knobs(cluster, tmp_path, monkeypatch,
                                       knob, value, item):
    """A nonzero ``DOS_TELEMETRY_INTERVAL_S`` (refused until A14.5
    ported the telemetry publisher) starts the publisher in both
    packages' servers: each ticks into its FIFO's ``.telemetry``
    sidecar, which the other package reads tick for tick. A positive ``DOS_GATEWAY_L2_BYTES``
    (refused until A14.3 ported the worker L2) enables the L2 in both
    packages' servers: a repeated batch gets the same answers and
    stats line from each, the repeat from the L2 (hits booked, no walk
    in the port)."""
    monkeypatch.setenv(knob, value)
    if knob == "DOS_GATEWAY_L2_BYTES":
        from distributed_oracle_search_tpu.obs import metrics as j_metrics
        from distributed_oracle_search_tpu_torch.obs import (
            metrics as t_metrics)
        from distributed_oracle_search_tpu_torch.ops import cuda_walk

        mine = _mine(cluster, n=8)
        cfg = RuntimeConfig(results=True)
        got = {}
        for pkg, reg in (("torch", t_metrics), ("jax", j_metrics)):
            fifo = str(tmp_path / f"{pkg}.fifo")
            th, rcs = _main_server(pkg, cluster[0], fifo, [])
            hits0 = reg.counter("worker_l2_hits_total").value
            try:
                first = _fifo_batch(tmp_path, fifo, f"{pkg}-1", mine, cfg)
                walks = cuda_walk.cuda_walk_batch.plain
                again = _fifo_batch(tmp_path, fifo, f"{pkg}-2", mine, cfg)
                walks = cuda_walk.cuda_walk_batch.plain - walks
            finally:
                t_server.stop_server(fifo)
                th.join(timeout=20)
            assert rcs == [0], pkg
            hits = reg.counter("worker_l2_hits_total").value - hits0
            got[pkg] = (first, again, hits, walks)
        (t1, t2, t_hits, t_walks), (j1, j2, j_hits, _) = (got["torch"],
                                                          got["jax"])
        assert t_hits == j_hits == len(mine) and t_walks == 0
        for (tl, tr), (jl, jr) in ((t1, j1), (t2, j2)):
            for f in DETERMINISTIC:
                assert (getattr(StatsRow.decode(tl), f)
                        == getattr(StatsRow.decode(jl), f)), f
            for a, b in zip(tr, jr):
                np.testing.assert_array_equal(a, b)
        for a, b in zip(t1[1], t2[1]):
            np.testing.assert_array_equal(a, b)
        return
    # the telemetry publisher (A14.5): each package's server ticks into
    # its FIFO's .telemetry sidecar, which the other package reads
    from distributed_oracle_search_tpu.obs import telemetry as j_tele
    from distributed_oracle_search_tpu_torch.obs import telemetry as t_tele

    ticks = {}
    for pkg, mine, other in (("torch", t_tele, j_tele),
                             ("jax", j_tele, t_tele)):
        fifo = str(tmp_path / f"{pkg}.fifo")
        th, rcs = _main_server(pkg, cluster[0], fifo, [])
        side = fifo + mine.SIDECAR_SUFFIX
        try:
            deadline = time.monotonic() + 60
            while not (os.path.exists(side) and other.read_sidecar(side)):
                assert time.monotonic() < deadline, f"{pkg}: no tick"
                time.sleep(0.05)
        finally:
            t_server.stop_server(fifo)
            th.join(timeout=20)
        assert rcs == [0], pkg
        ticks[pkg] = other.read_sidecar(side)
        assert ticks[pkg] == mine.read_sidecar(side)
    for pkg, got in ticks.items():
        assert got[0]["source"] == "w0" and got[0]["full"], pkg
        assert set(got[0]) == set(ticks["jax"][0]), pkg


def test_server_without_gpu_raises(cluster, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    conf = ClusterConfig.load(cluster[0])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_server.FifoServer(conf, 0, command_fifo=str(tmp_path / "g.fifo"))
    assert not os.path.exists(tmp_path / "g.fifo")
