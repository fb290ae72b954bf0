"""PyTorch port, the gateway tier (``gateway/`` and ``cli/gateway.py``)
against the JAX package's.

The JAX package's ``tests/test_gateway.py`` and ``test_gateway_ha.py``
cases run over the port (``torch_port_cases``), on CPU engines."""

import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)
from torch_port_cases import load_cases  # noqa: E402

TIMING = ("asserts on wall-clock time, which fails on a loaded host "
          "(ROADMAP.md C1); the deadline path is held by the cases that "
          "wait on counters")

globals().update(load_cases("test_gateway.py", __name__, drop={
    "test_gateway_busy_at_credit_window": TIMING,
}))
globals().update(load_cases("test_gateway_ha.py", __name__, drop={
    "test_wait_honors_deadline_from_submit_time": TIMING,
}))


# ------------------------------------------- across the two packages

import json  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402

import numpy as np  # noqa: E402

from torch_parity import PKGS  # noqa: E402


def _wire_bytes(P, header, arrays=()):
    return b"".join(bytes(b) for b in P.frames.encode_frame(header, arrays))


def _frames_of(P):
    """Every gateway frame kind, built by one package's encoders."""
    pr, ServeResult = P.protocol, P.request.ServeResult
    ident = dict(frontend=2, epoch=3, diff_epoch=1)
    results = [ServeResult("OK", 1, 2, cost=17, plen=4, finished=True),
               ServeResult("BUSY", 3, 4, detail="queue full"),
               ServeResult("OK", 5, 6, cost=9, plen=2, finished=True,
                           cached=True)]
    return [
        ({"kind": "hello", **pr.hello_header(0, 32, epoch=3)}, []),
        pr.encode_pairs(7, [(1, 2), (3, 4)], deadline_ms=500.0, epoch=2,
                        cid="c-1"),
        pr.encode_pairs(8, [(5, 9)], family="rev"),
        pr.encode_mat(9, 5, [7, 9, 11]),
        pr.encode_alt(10, 5, 9, 3),
        pr.reply_pairs(7, "pair", results, **ident),
        pr.reply_mat(9, 5, [12, -1, 40], **ident),
        pr.reply_alt(10, 5, 9, [(20, 1), (24, 6)], **ident),
        pr.reply_shed(11, "mat", "BUSY", "family shed", **ident),
        pr.busy_frame(12, **ident),
        pr.error_frame(13, "unknown family 'zorp'", **ident),
    ]


def test_protocol_frames_byte_equal_jax():
    """Every gateway frame the port encodes is the JAX package's, byte
    for byte."""
    got = {name: [_wire_bytes(P, h, a) for h, a in _frames_of(P)]
           for name, P in PKGS.items()}
    assert got["torch"] == got["jax"]
    assert len(got["torch"]) == 11


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_protocol_frames_decode_across_packages(writer, reader):
    """Frames one package writes on a socket, the other reads: the same
    headers and payloads, and the same parse of each query frame."""
    W, R = PKGS[writer], PKGS[reader]
    frames = _frames_of(W)
    a, b = socket.socketpair()
    try:
        w, r = W.frames.FrameWriter(a), R.frames.FrameReader(b)
        for h, arrs in frames:
            w.send(h, arrs)
            fr = r.read()
            assert fr.kind == h["kind"]
            assert {k: v for k, v in fr.header.items()
                    if k not in ("segs", "v")} == json.loads(
                        json.dumps(h))
            assert [np.asarray(x).tolist() for x in fr.arrays] == \
                [np.asarray(x).tolist() for x in arrs]
            if fr.kind == "q":
                fam, payload = R.protocol.parse_query_frame(fr)
                jfam, jpayload = W.protocol.parse_query_frame(
                    W.frames.Frame("q", dict(fr.header), fr.arrays))
                assert fam == jfam
                assert repr(payload) == repr(jpayload)
    finally:
        a.close()
        b.close()


def _registry_ops(P, d):
    reg = P.registry.GatewayRegistry(d, lease_s=5.0)
    reg.register(0, "/s/f0.sock", now=100.0)
    reg.register(1, "/s/f1.sock", now=100.0)
    reg.renew(0, "/s/f0.sock", now=103.0)
    fid = reg.claim(2, endpoint_of=lambda f: f"/s/f{f}.sock", now=104.0)
    reg.unregister(1, "/s/f1.sock")
    return fid, reg


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_registry_file_read_across_packages(writer, reader, tmp_path):
    """``gateway.json`` written by one package: the same bytes as the
    other's for the same operations (but the pid), and the other reads
    its leases, live endpoints and next claim alike."""
    W, R = PKGS[writer], PKGS[reader]
    dw, dr = tmp_path / "w", tmp_path / "r"
    dw.mkdir()
    dr.mkdir()
    fid_w, _ = _registry_ops(W, str(dw))
    fid_r, _ = _registry_ops(R, str(dr))
    assert fid_w == fid_r == 2
    with open(R.registry.registry_path(str(dw))) as f:
        doc_w = json.load(f)
    with open(R.registry.registry_path(str(dr))) as f:
        doc_r = json.load(f)
    assert doc_w == doc_r
    state = R.registry.load_registry(str(dw))
    assert [l.to_dict() for l in state.lease_objs()] == \
        [l.to_dict() for l in W.registry.load_registry(
            str(dw)).lease_objs()]
    reg = R.registry.GatewayRegistry(str(dw), lease_s=5.0)
    assert [l.fid for l in reg.live(now=105.0)] == [0, 2, 3]
    assert [l.fid for l in reg.live(now=200.0)] == []
    assert reg.claim(1, endpoint_of=lambda f: f"/s/f{f}.sock",
                     now=106.0) == 4


@pytest.fixture(scope="module")
def x_world(tmp_path_factory):
    """A 2-shard index built by the JAX package, served by each package's
    in-process dispatcher (the port's on the CPU)."""
    from distributed_oracle_search_tpu.data import (
        ensure_synth_dataset, read_scen,
    )
    from distributed_oracle_search_tpu.models.cpd import (
        write_index_manifest,
    )
    from distributed_oracle_search_tpu.parallel.partition import (
        DistributionController as JDC,
    )
    from distributed_oracle_search_tpu.worker.build import main as jbuild

    datadir = str(tmp_path_factory.mktemp("x-gw"))
    paths = ensure_synth_dataset(datadir, width=10, height=8,
                                 n_queries=64, seed=51)
    outdir = os.path.join(datadir, "index")
    for wid in range(2):
        jbuild(["--input", paths["xy"], "--partmethod", "mod",
                "--partkey", "2", "--workerid", str(wid),
                "--maxworker", "2", "--outdir", outdir])
    world = {}
    for name, P in PKGS.items():
        conf = P.config.ClusterConfig(
            workers=["localhost", "localhost"], partmethod="mod",
            partkey=2, outdir=outdir, xy_file=paths["xy"],
            scenfile=paths["scen"], diffs=["-", paths["diff"]],
            nfs=datadir).validate()
        g = P.graph.Graph.from_xy(paths["xy"])
        dc = P.part.DistributionController("mod", 2, 2, g.n)
        world[name] = (conf, g, dc, P.dispatcher(conf, g, dc))
    write_index_manifest(outdir, JDC("mod", 2, 2, world["jax"][1].n))
    return world, read_scen(paths["scen"])


def _tier(P, world, sock_dir, fid_base=0):
    conf, g, dc, dispatcher = world
    sconf = P.serving.ServeConfig(queue_depth=1024, max_wait_ms=1.0,
                                  cache_bytes=1 << 20).validate()
    fe = P.serving.ServingFrontend(dc, dispatcher, sconf=sconf)
    fe.start()
    fam = P.families.QueryFamilies(fe, graph=g)
    gconf = P.gateway.GatewayConfig(replicas=1, socket_dir=str(sock_dir),
                                    credit=32,
                                    deadline_ms=60_000.0).validate()
    tier = P.gateway.GatewayTier([(fe, fam)], gconf=gconf,
                                 fid_base=fid_base).start()
    return tier, fe


def _campaign(C, endpoint, queries):
    client = C.gateway.DosClient(endpoint)
    try:
        pairs = [(int(s), int(t)) for s, t in queries[:24]]
        rows = [r[:4] for r in client.query_batch(pairs, timeout=60.0)]
        again = client.query_batch(pairs[:4], timeout=60.0)
        s, t = pairs[0]
        return {"pairs": rows,
                "cached": [bool(r[4]) for r in again],
                "rev": client.reverse(s, t, timeout=60.0)[:4],
                "mat": client.matrix(s, [int(q[1]) for q in queries[:6]],
                                     timeout=60.0),
                "alt": client.alternatives(s, t, 3, timeout=60.0)}
    finally:
        client.close()


def test_clients_and_tiers_across_packages(x_world, tmp_path):
    """A JAX ``DosClient`` against a port ``GatewayTier`` (CPU engines)
    and a port client against a JAX tier: every pair, reverse, matrix
    and alternatives answer equals the same package pair's, repeats
    come back cached."""
    world, queries = x_world
    got = {}
    for tier_pkg in ("jax", "torch"):
        d = tmp_path / tier_pkg[0]
        d.mkdir()
        tier, fe = _tier(PKGS[tier_pkg], world[tier_pkg], d)
        try:
            for client_pkg in ("jax", "torch"):
                got[(client_pkg, tier_pkg)] = _campaign(
                    PKGS[client_pkg], tier.endpoints[0], queries)
        finally:
            tier.stop()
            fe.stop()
    ref = got[("jax", "jax")]
    assert all(r[0] == "OK" and r[3] for r in ref["pairs"])
    for key, val in got.items():
        assert val["pairs"] == ref["pairs"], key
        assert val["rev"] == ref["rev"] and val["mat"] == ref["mat"], key
        assert val["alt"] == ref["alt"], key
        assert all(val["cached"]), key


def test_gateway_cli_passes_device_to_the_frontend():
    """``cli.gateway`` takes ``--device`` (default ``cuda``), which
    ``cli.serve.build_frontend`` reads as ``dos-serve``'s."""
    from distributed_oracle_search_tpu_torch.cli import gateway as gw

    assert gw.build_parser().parse_args([]).device == "cuda"
    assert gw.build_parser().parse_args(
        ["--device", "cpu"]).device == "cpu"
    # every knob the JAX entry point takes, and only --device beside them
    from distributed_oracle_search_tpu.cli import gateway as jgw

    jax_args = set(vars(jgw.build_parser().parse_args([])))
    assert set(vars(gw.build_parser().parse_args([]))) - jax_args == {
        "device"}
