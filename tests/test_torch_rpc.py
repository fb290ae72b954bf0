"""PyTorch port, the streaming RPC lane against the JAX package's:
``encode_frame`` bytes are equal and each package decodes the other's
frames off a socket; a newer frame schema, a bad magic, implausible
lengths and a peer gone mid-frame surface as the same typed errors; the
knobs (``resolve_transport``, endpoints, ``config_from_wire``) agree.
Over Unix sockets under ``tmp_path``: the port's ``RpcServeLoop`` answers
a batch with the JAX loop's stats and segments; a request past the
credit window answers an explicit BUSY; a malformed config answers FAIL;
probes ride the health vocabulary; the client's heartbeat thread pings;
concurrent batches share one connection. Campaigns over the RPC lane:
the port head against JAX servers and the JAX head against port servers
give the JAX campaign's rows and ``paths.csv``, with no query file
written."""

import csv
import json
import os
import socket
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)

from distributed_oracle_search_tpu.cli import process_query as j_pq  # noqa: E402
from distributed_oracle_search_tpu.testing import faults as j_faults  # noqa: E402
from distributed_oracle_search_tpu.transport import frames as j_frames  # noqa: E402
from distributed_oracle_search_tpu.transport import rpc as j_rpc  # noqa: E402
from distributed_oracle_search_tpu.utils.config import (  # noqa: E402
    ClusterConfig as JClusterConfig,
)
from distributed_oracle_search_tpu.worker import server as j_server  # noqa: E402
from distributed_oracle_search_tpu_torch.cli import process_query as t_pq  # noqa: E402
from distributed_oracle_search_tpu_torch.data import (  # noqa: E402
    Graph, synth_city_graph, synth_diff, synth_scenario, write_diff,
    write_scen, write_xy,
)
from distributed_oracle_search_tpu_torch.models.cpd import (  # noqa: E402
    build_worker_shard, write_index_manifest,
)
from distributed_oracle_search_tpu_torch.obs import metrics as t_metrics  # noqa: E402
from distributed_oracle_search_tpu_torch.parallel import (  # noqa: E402
    DistributionController,
)
from distributed_oracle_search_tpu_torch.testing import faults as t_faults  # noqa: E402
from distributed_oracle_search_tpu_torch.transport import frames as t_frames  # noqa: E402
from distributed_oracle_search_tpu_torch.transport import rpc as t_rpc  # noqa: E402
from distributed_oracle_search_tpu_torch.transport.wire import (  # noqa: E402
    StatsRow,
)
from distributed_oracle_search_tpu_torch.utils.config import (  # noqa: E402
    ClusterConfig,
)
from distributed_oracle_search_tpu_torch.worker import server as t_server  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W = 2
TIMERS = ("t_receive", "t_astar", "t_search", "t_prepare", "t_partition")
FRAMES = {"jax": j_frames, "torch": t_frames}
SERVERS = {"jax": (j_server, JClusterConfig), "torch": (t_server,
                                                        ClusterConfig)}
HEADS = {"jax": j_pq, "torch": t_pq}

HEADERS = [
    ({"kind": "hello", "wid": 3, "credit": 8}, []),
    ({"kind": "req", "id": 7, "config": {"k_moves": 4, "results": True},
      "diff": "-"}, [np.arange(12, dtype=np.int64).reshape(6, 2)]),
    ({"kind": "rep", "id": 7, "stats": "1,2,3", "res": True},
     [np.arange(5, dtype=np.int64), np.arange(5, dtype=np.int64),
      np.array([1, 0, 1, 1, 0], np.uint8)]),
    ({"kind": "rep", "id": 9, "paths": True},
     [np.array([1, 2, 3], np.uint8), np.arange(9, dtype=np.int32),
      np.zeros((2, 3), np.int64)]),
    ({"kind": "ping", "id": 0, "extra": {"unknown": [1, 2]}}, []),
    ({"kind": "busy", "id": 4, "v": 1}, [np.zeros((1, 2), np.int64)]),
]


def test_empty_segment_refused_as_jax_does():
    """A zero-size segment cannot be cast to a byte view: both packages'
    ``encode_frame`` raise the same ``TypeError`` (the head never sends
    an empty batch: ``group_queries`` makes no empty group)."""
    errs = []
    for mod in FRAMES.values():
        with pytest.raises(TypeError) as e:
            mod.encode_frame({"kind": "req"}, [np.zeros((0, 2), np.int64)])
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def _bytes(mod, header, arrays):
    return b"".join(bytes(b) for b in mod.encode_frame(header, arrays))


@pytest.mark.parametrize("i", range(len(HEADERS)))
def test_encode_frame_bytes_equal_and_cross_decode(i):
    header, arrays = HEADERS[i]
    enc = {k: _bytes(m, header, arrays) for k, m in FRAMES.items()}
    assert enc["torch"] == enc["jax"]
    for writer, reader in (("torch", "jax"), ("jax", "torch")):
        a, b = socket.socketpair()
        try:
            FRAMES[writer].FrameWriter(a).send(header, arrays)
            fr = FRAMES[reader].FrameReader(b).read()
        finally:
            a.close()
            b.close()
        assert fr.kind == header["kind"]
        assert {k: v for k, v in fr.header.items() if k != "segs"} \
            == {"v": 1, **header}
        assert len(fr.arrays) == len(arrays)
        for x, y in zip(fr.arrays, arrays):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def _read_error(mod, raw: bytes, close: bool = True) -> str:
    a, b = socket.socketpair()
    try:
        a.sendall(raw)
        if close:
            a.close()
        try:
            fr = mod.FrameReader(b).read()
            return f"frame {fr}"
        except Exception as e:  # noqa: BLE001 — the type is the result
            return type(e).__name__ + ": " + str(e).split(":")[0]
    finally:
        b.close()
        if not close:
            a.close()


@pytest.mark.parametrize("case", ["newer-schema", "bad-magic", "torn",
                                  "implausible", "clean-eof",
                                  "bad-header"])
def test_frame_errors_equal_jax(case):
    good = _bytes(t_frames, {"kind": "req", "id": 1},
                  [np.arange(4, dtype=np.int64)])
    pre = t_frames._PREAMBLE
    raw = {
        "newer-schema": _bytes(t_frames, {"kind": "req", "v": 99}, []),
        "bad-magic": b"XXXX" + good[4:],
        "torn": good[:-5],
        "implausible": pre.pack(b"DOSF", 1 << 30, 0),
        "clean-eof": b"",
        "bad-header": pre.pack(b"DOSF", 3, 0) + b"{x]",
    }[case]
    got = {k: _read_error(m, raw) for k, m in FRAMES.items()}
    assert got["torch"] == got["jax"]
    want = {"newer-schema": "FrameSchemaError", "clean-eof": "frame None"}
    assert got["torch"].startswith(want.get(case, "TornFrame"))


def test_knobs_and_config_codec_equal_jax(monkeypatch, tmp_path):
    for raw in ("", "rpc", "AUTO", "garbage"):
        monkeypatch.setenv("DOS_TRANSPORT", raw)
        assert t_rpc.resolve_transport() == j_rpc.resolve_transport()
    monkeypatch.setenv("DOS_RPC_SOCKET_DIR", str(tmp_path))
    assert t_rpc.endpoint_for(3) == j_rpc.endpoint_for(3)
    monkeypatch.setenv("DOS_RPC_PORT", "7000")
    assert t_rpc.endpoint_for(3, "h") == j_rpc.endpoint_for(3, "h") == (
        "tcp", "h", 7003)
    raw = {"k_moves": 3, "results": True, "trace_id": "ab", "nope": 1}
    assert t_rpc.config_from_wire(raw).to_json() == \
        j_rpc.config_from_wire(raw).to_json()
    for bad in ("CORRUPT {", None, [1]):
        for mod in (t_rpc, j_rpc):
            with pytest.raises(ValueError):
                mod.config_from_wire(bad)


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    """A 2-worker ``mod`` conf on a small grid with a diff, its index
    built on the CPU by the port."""
    d = tmp_path_factory.mktemp("rpc-cluster")
    g = synth_city_graph(9, 8, seed=12)
    xy = str(d / "g.xy")
    write_xy(xy, g.xs, g.ys, g.src, g.dst, g.w)
    g = Graph.from_xy(xy)
    scen = str(d / "g.scen")
    q = synth_scenario(g.n, 150, seed=13)
    write_scen(scen, np.concatenate([q, q[:5]]))
    diff = str(d / "g.diff")
    write_diff(diff, *synth_diff(g, frac=0.3, seed=14))
    dc = DistributionController("mod", W, W, g.n)
    outdir = str(d / "index")
    for wid in range(W):
        build_worker_shard(g, dc, wid, outdir, chunk=16, device="cpu")
    write_index_manifest(outdir, dc)
    nfs = d / "nfs"
    nfs.mkdir()
    conf = str(d / "conf.json")
    with open(conf, "w") as f:
        json.dump({"workers": ["localhost"] * W, "partmethod": "mod",
                   "partkey": W, "outdir": outdir, "xy_file": xy,
                   "scenfile": scen, "diffs": ["-", diff], "nfs": str(nfs),
                   "projectdir": ROOT}, f)
    return conf, dc, q


class Fleet:
    """In-thread servers of one package, each with its FIFO loop and an
    RPC loop on a socket under ``sockdir``."""

    def __init__(self, pkg, conf, sockdir, monkeypatch, credit=None):
        mod, conf_cls = SERVERS[pkg]
        kw = {"device": "cpu"} if pkg == "torch" else {}
        self.fifos = {w: os.path.join(sockdir, f"{pkg}-w{w}.fifo")
                      for w in range(W)}
        monkeypatch.setenv("DOS_RPC_SOCKET_DIR", str(sockdir))
        self.servers = [mod.FifoServer(conf_cls.load(conf), w,
                                       command_fifo=self.fifos[w], **kw)
                        for w in range(W)]
        self.mod = mod
        self.credit = credit
        for head in HEADS.values():
            monkeypatch.setattr(head, "command_fifo_path",
                                lambda w: self.fifos[w])

    def __enter__(self):
        self.threads = [threading.Thread(target=s.serve_forever,
                                         daemon=True)
                        for s in self.servers]
        for t in self.threads:
            t.start()
        for f in self.fifos.values():
            for _ in range(200):
                if os.path.exists(f):
                    break
                time.sleep(0.02)
        self.loops = [self.mod.RpcServeLoop(s, credit=self.credit).start()
                      for s in self.servers]
        return self

    def __exit__(self, *exc):
        for f in self.fifos.values():
            self.mod.stop_server(f)
        for t in self.threads:
            t.join(timeout=10)
        for loop in self.loops:
            loop.stop()
        t_rpc.close_clients()
        j_rpc.close_clients()


def _counter(name):
    return t_metrics.REGISTRY.snapshot()["counters"].get(name, 0)


def _mine(cluster, wid=1, n=8):
    _conf, dc, q = cluster
    return np.ascontiguousarray(q[dc.worker_of(q[:, 1]) == wid][:n],
                                np.int64)


def test_rpc_batch_equals_jax_loop(cluster, tmp_path, monkeypatch):
    mine = _mine(cluster)
    got = {}
    for pkg in ("torch", "jax"):
        d = tmp_path / pkg
        d.mkdir()
        with Fleet(pkg, cluster[0], d, monkeypatch):
            c = t_rpc.RpcClient(t_rpc.endpoint_for(1), timeout_s=30.0)
            try:
                fr = c.call({"kind": "req", "config": {
                    "results": True, "k_moves": 5, "extract": True},
                    "diff": "-"}, [mine])
                hello = dict(c.server_hello)
            finally:
                c.close()
        got[pkg] = (StatsRow.decode(fr.header["stats"]).as_list()[:7],
                    sorted(k for k in fr.header if k != "v"),
                    [a.tolist() for a in fr.arrays], hello)
    assert got["torch"] == got["jax"]
    assert got["torch"][3] == {"kind": "hello", "wid": 1, "credit": 8,
                               "v": 1, "segs": []}


def test_busy_credit_malformed_probe_heartbeat(cluster, tmp_path,
                                               monkeypatch):
    """On the port's loop: BUSY past a credit window of 1 (worker 1's
    reply delayed), FAIL for a malformed config, probes over fresh
    connections (None without a listener), the client heartbeat, and
    four concurrent batches on one connection."""
    mine = _mine(cluster)
    monkeypatch.setenv("DOS_FAULTS", "delay;wid=1;delay=0.8;times=1")
    t_faults.reset()
    with Fleet("torch", cluster[0], tmp_path, monkeypatch, credit=1):
        ep = t_rpc.endpoint_for(1)
        ca = t_rpc.RpcClient(ep, timeout_s=30.0)
        cb = t_rpc.RpcClient(ep, timeout_s=30.0)
        hdr = {"kind": "req", "config": {"results": True}, "diff": "-"}
        busy0 = _counter("rpc_busy_frames_total")
        got = {}
        th = threading.Thread(target=lambda: got.update(
            a=ca.call(dict(hdr), [mine])))
        try:
            th.start()
            time.sleep(0.3)            # inside the injected delay
            with pytest.raises(t_rpc.RpcBusy):
                cb.call(dict(hdr), [mine])
            th.join(timeout=30)
            assert got["a"].header.get("res")
            assert _counter("rpc_busy_frames_total") - busy0 >= 2
            m0 = _counter("rpc_server_frames_malformed_total")
            fr = cb.call({"kind": "req", "config": "CORRUPT {",
                          "diff": "-"}, [np.zeros((1, 2), np.int64)])
            assert fr.header["stats"] == "FAIL"
            assert _counter("rpc_server_frames_malformed_total") - m0 == 1
        finally:
            th.join(timeout=5)
            ca.close()
            cb.close()
        st = t_rpc.probe(1)
        assert st is not None and st.ok and st.wid == 1
        assert t_rpc.probe(57, timeout=3.0) is None
        monkeypatch.setenv("DOS_RPC_HEARTBEAT_S", "0.2")
        hb0 = _counter("rpc_heartbeats_total")
        c0 = _counter("rpc_connects_total")
        multi = t_rpc.RpcClient(t_rpc.endpoint_for(0), timeout_s=30.0)
        outs = {}
        try:
            ths = [threading.Thread(target=lambda i=i: outs.update(
                {i: multi.call(dict(hdr), [_mine(cluster, 0)])}))
                for i in range(4)]
            for t in ths:
                t.start()
            for t in ths:
                t.join(timeout=30)
            time.sleep(0.7)
        finally:
            multi.close()
        assert len(outs) == 4 and len({
            tuple(o.header["stats"].split(",")[:7])
            for o in outs.values()}) == 1
        assert multi.statusz()["connects"] == 1
        # heartbeats probe over ephemeral connections of their own
        assert _counter("rpc_heartbeats_total") - hb0 >= 1
        assert _counter("rpc_connects_total") - c0 >= 2
    t_faults.reset()


def _parts(path):
    with open(path) as f:
        rows = list(csv.reader(f))
    keep = [i for i, h in enumerate(rows[0]) if h not in TIMERS]
    return [[r[i] for i in keep] for r in rows]


def _campaign(head, conf, out, extra=()):
    rc = HEADS[head].main(["-c", conf, "--backend", "host", "-o", out,
                           "--device", "cpu", *extra])
    with open(os.path.join(out, "paths.csv"), "rb") if extra else \
            open(os.devnull, "rb") as f:
        paths = f.read()
    return rc, _parts(os.path.join(out, "parts.csv")), paths


@pytest.fixture(scope="module")
def fifo_campaign(cluster, tmp_path_factory):
    """The JAX package's FIFO campaign (its head, its servers)."""
    tmp = tmp_path_factory.mktemp("rpc-ref")
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("DOS_TRANSPORT", "fifo")
        with Fleet("jax", cluster[0], tmp, mp):
            return (_campaign("jax", cluster[0], str(tmp / "r")),
                    _campaign("jax", cluster[0], str(tmp / "k"),
                              ["-k", "6", "--extract"]))
    finally:
        mp.undo()


@pytest.mark.parametrize("head,servers", [("torch", "jax"),
                                          ("jax", "torch"),
                                          ("torch", "torch")])
def test_cross_package_rpc_campaigns(cluster, fifo_campaign, tmp_path,
                                     monkeypatch, head, servers):
    monkeypatch.setenv("DOS_TRANSPORT", "rpc")
    for mod in (t_faults, j_faults):
        mod.reset()
    nfs = ClusterConfig.load(cluster[0]).nfs
    before = {f for f in os.listdir(nfs) if f.startswith("query.")}
    f0 = _counter("rpc_frames_sent_total")
    with Fleet(servers, cluster[0], tmp_path, monkeypatch):
        got = (_campaign(head, cluster[0], str(tmp_path / "r")),
               _campaign(head, cluster[0], str(tmp_path / "k"),
                         ["-k", "6", "--extract"]))
    assert got == fifo_campaign
    assert got[0][0] == 0 and len(got[0][1]) == 1 + 2 * W
    after = {f for f in os.listdir(nfs) if f.startswith("query.")}
    assert after <= before
    if head == "torch" or servers == "torch":
        assert _counter("rpc_frames_sent_total") - f0 >= 4 * W
