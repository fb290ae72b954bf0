"""PyTorch port, the live traffic plane (``traffic/``) and the engine's
path signatures (``RuntimeConfig.sig_k``), held against the JAX package
on the CPU.

Each case runs the same steps through both packages: segment bytes and
fused ``.diff`` files byte-equal (each package reading the other's),
stream polls, epoch swaps and their affected-edge sets, scoped and full
cache invalidations with their re-keys, the frontend's epoch-folded
cache keys, the diff-epoch gate, the query families (held to the CPU
reference walk as in JAX), the live-swap smoke, the scenario generator,
and ``sig_k`` signatures equal with the answers unchanged. The mirror of
``tests/test_traffic.py`` without its ``slow`` replay drill; its two
bench-waiver cases (one drives ``dos-obs bench-diff`` on records it
writes under ``tmp_path``) run over the port (``torch_port_cases``).
"""

import glob
import io
import json
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)

from distributed_oracle_search_tpu.data import (  # noqa: E402
    ensure_synth_dataset, read_scen,
)
from distributed_oracle_search_tpu.models.cpd import (  # noqa: E402
    write_index_manifest,
)
from distributed_oracle_search_tpu.models.reference import (  # noqa: E402
    first_move_to_target, table_search_walk,
)
from distributed_oracle_search_tpu.parallel.partition import (  # noqa: E402
    DistributionController as JDC,
)
from distributed_oracle_search_tpu.worker.build import (  # noqa: E402
    main as j_build_main,
)
from torch_parity import PKGS, both, equal, outcome  # noqa: E402

WAIT_S = 60


@pytest.fixture(scope="module")
def traffic_world(tmp_path_factory):
    """A 2-shard world with a CPD index built by the JAX package; per
    package its conf, graph, controller and in-process dispatcher."""
    datadir = str(tmp_path_factory.mktemp("t-traffic-data"))
    paths = ensure_synth_dataset(datadir, width=10, height=8,
                                 n_queries=96, seed=33)
    outdir = os.path.join(datadir, "index")
    for wid in range(2):
        j_build_main(["--input", paths["xy"], "--partmethod", "mod",
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


def _reference_answers(g, queries, w_query):
    """CPU-oracle golden triple for (s, t) pairs under query weights."""
    fm_cache = {}

    def fm_of(x, t):
        if t not in fm_cache:
            fm_cache[t] = first_move_to_target(g, int(t))
        return fm_cache[t][int(x)]

    out = []
    for s, t in queries:
        c, p, f, _path = table_search_walk(g, fm_of, int(s), int(t),
                                           w_query=w_query)
        out.append((int(c), int(p), bool(f)))
    return out


def _sconf(P, **kw):
    base = dict(queue_depth=1024, max_wait_ms=1.0, cache_bytes=0)
    base.update(kw)
    return P.serving.ServeConfig(**base).validate()


def _read(path):
    with open(path, "rb") as f:
        return f.read()


# ------------------------------------------------------- segment codec

def test_segment_roundtrip_bytes_equal(tmp_path):
    """Each package writes the same segment bytes and reads the other's."""
    def run(P):
        d = str(tmp_path / P.name)
        p = P.traffic.write_segment(d, 3, [0, 1], [1, 2], [50, 60],
                                    extra={"producer": "sensor-fleet"})
        return os.path.basename(p), _read(p)
    name, raw = equal(run)
    for reader, writer in (("torch", "jax"), ("jax", "torch")):
        seg = PKGS[reader].traffic.read_segment(
            str(tmp_path / writer / name))
        assert seg.epoch == 3 and seg.pairs() == [(0, 1), (1, 2)]
        assert list(seg.w) == [50, 60]


def test_segment_unknown_keys_tolerated(tmp_path):
    def run(P):
        d = str(tmp_path / P.name)
        P.traffic.write_segment(d, 1, [0], [1], [9],
                                extra={"producer": "x", "region": 7})
        seg = P.traffic.read_segment(P.traffic.segment_path(d, 1))
        return seg.epoch, list(seg.w)
    assert equal(run) == (1, [9])


def test_segment_newer_schema_rejected(tmp_path):
    def run(P):
        d = str(tmp_path / P.name)
        raw = P.segments.encode_segment(1, [0], [1], [9]).decode()
        header = json.loads(raw.split("\n")[0])
        header["schema"] = P.traffic.SEGMENT_SCHEMA + 1
        p = P.traffic.segment_path(d, 1)
        os.makedirs(d, exist_ok=True)
        with open(p, "w") as f:
            f.write("\n".join([json.dumps(header)] + raw.split("\n")[1:]))
        err = outcome(lambda: P.traffic.read_segment(p))
        return err[:2], "newer" in err[2]
    assert equal(run) == (("raise", "ValueError"), True)


def test_segment_torn_tail_ignored(tmp_path):
    def run(P):
        d = str(tmp_path / P.name)
        P.traffic.write_segment(d, 1, [0], [1], [9])
        with open(P.traffic.segment_path(d, 2), "w") as f:
            f.write(json.dumps({"kind": "dos-traffic-segment",
                                "schema": 1, "epoch": 2,
                                "entries": 3}) + "\n0 1 5\n")
        first = [s.epoch for s in P.traffic.list_segments(d)]
        P.traffic.write_segment(d, 3, [2], [3], [7])
        err = outcome(lambda: P.traffic.list_segments(d))
        return first, err[:2], "mid-stream" in err[2]
    assert equal(run) == ([1], ("raise", "ValueError"), True)


def test_segment_filename_epoch_mismatch(tmp_path):
    def run(P):
        d = str(tmp_path / P.name)
        P.traffic.write_segment(d, 1, [0], [1], [9])
        os.rename(P.traffic.segment_path(d, 1),
                  P.traffic.segment_path(d, 4))
        err = outcome(lambda: P.traffic.read_segment(
            P.traffic.segment_path(d, 4)))
        return err[:2], "header says" in err[2]
    assert equal(run) == (("raise", "ValueError"), True)


def test_tail_stream_torn_frame(tmp_path):
    def run(P):
        spool = str(tmp_path / f"{P.name}.segs")
        ts = P.traffic.TailDiffStream(spool)
        out = [ts.poll()]
        enc = P.segments.encode_segment
        ts.append(enc(1, [0], [1], [9]))
        ts.append(enc(2, [1], [2], [8])[:-8])
        out.append([s.epoch for s in ts.poll()])
        with open(spool, "ab") as f:
            f.write(enc(2, [1], [2], [8])[-8:])
        got = ts.poll()
        return out + [[s.epoch for s in got], list(got[0].w), _read(spool)]
    assert equal(run)[:4] == [[], [1], [2], [8]]


def test_tail_stream_multibyte_header_annotation(tmp_path):
    def run(P):
        spool = str(tmp_path / f"{P.name}.segs")
        ts = P.traffic.TailDiffStream(spool)
        raw = json.dumps({"kind": "dos-traffic-segment", "schema": 1,
                          "epoch": 1, "entries": 1,
                          "corridor": "Åsgatan–Brogränd"},
                         ensure_ascii=False)
        ts.append((raw + "\n0 1 9\n").encode())
        first = [s.epoch for s in ts.poll()]
        ts.append(P.segments.encode_segment(2, [1], [2], [8]))
        got = ts.poll()
        return first, [s.epoch for s in got], list(got[0].w)
    assert equal(run) == ([1], [2], [8])


def test_stream_holds_back_out_of_order_visibility(tmp_path):
    def run(P):
        d = str(tmp_path / P.name)
        ds = P.traffic.DiffStream(d)
        P.traffic.write_segment(d, 1, [0], [1], [9])
        out = [[s.epoch for s in ds.poll()]]
        P.traffic.write_segment(d, 3, [2], [3], [7])
        out.append(ds.poll())
        P.traffic.write_segment(d, 2, [1], [2], [8])
        out.append([s.epoch for s in ds.poll()])
        out.append([s.epoch for s in P.traffic.DiffStream(d).poll()])
        return out
    assert equal(run) == [[1], [], [2, 3], [1, 2, 3]]


# ------------------------------------------------------- epoch manager

def test_fused_multi_segment_swap(tmp_path):
    """Both segments fuse into one ``.diff`` per swap — the same bytes in
    both packages — with the same affected sets and spool pruning."""
    def run(P):
        d = str(tmp_path / P.name / "stream")
        m = P.traffic.DiffEpochManager(d, keep_epochs=2)
        out = [m.epoch, m.refresh()]
        P.traffic.write_segment(d, 1, [0, 1], [1, 2], [50, 60])
        P.traffic.write_segment(d, 2, [0, 5], [1, 6], [50, 70])
        out.append(m.refresh())
        epoch, difffile, affected = m.active()
        out += [epoch, sorted(affected), os.path.basename(difffile),
                _read(difffile)]
        P.traffic.write_segment(d, 3, [0], [1], [50])
        out += [m.refresh(), sorted(m.active()[2])]
        P.traffic.write_segment(d, 4, [0], [1], [55])
        out.append(m.refresh())
        kept = sorted(glob.glob(os.path.join(m.spool, "fused-e*.diff")))
        out += [[os.path.basename(k) for k in kept],
                kept[-1] == m.fused_path(4), _read(kept[-1])]
        return out
    got = equal(run)
    assert got[:5] == [0, False, True, 2, [(0, 1), (1, 2), (5, 6)]]
    assert got[7:9] == [True, []] and len(got[10]) == 2 and got[11]
    # the kept fused file each package wrote reads in the other
    for reader, writer in (("torch", "jax"), ("jax", "torch")):
        path = os.path.join(str(tmp_path / writer / "stream"), "fused",
                            got[10][-1])
        src, dst, w = PKGS[reader].formats.read_diff(path)
        assert {(int(u), int(v)): int(x) for u, v, x in zip(src, dst, w)
                } == {(0, 1): 55, (1, 2): 60, (5, 6): 70}


def test_refresh_retains_segments_when_materialize_fails(tmp_path):
    def run(P):
        root = tmp_path / P.name
        root.mkdir()
        d = str(root / "stream")
        blocked = root / "spool"
        blocked.write_text("a FILE where the spool dir should be")
        m = P.traffic.DiffEpochManager(d, spool_dir=str(blocked))
        P.traffic.write_segment(d, 1, [0], [1], [9])
        out = [m.refresh(), m.epoch, m.weight_of(0, 1, 5)]
        os.remove(blocked)
        return out + [m.refresh(), m.epoch, m.weight_of(0, 1, 5)]
    assert equal(run) == [False, 0, 5, True, 1, 9]


def test_manager_base_diff_and_weight_of(tmp_path):
    def run(P):
        root = tmp_path / P.name
        root.mkdir()
        base = str(root / "base.diff")
        P.formats.write_diff(base, np.asarray([7]), np.asarray([8]),
                             np.asarray([123]))
        d = str(root / "stream")
        m = P.traffic.DiffEpochManager(d, base_diff=base)
        out = [m.weight_of(7, 8, 999), m.weight_of(1, 2, 42)]
        P.traffic.write_segment(d, 1, [7], [8], [200])
        out += [m.refresh(), m.weight_of(7, 8, 999), _read(m.difffile)]
        return out
    assert equal(run)[:4] == [123, 42, True, 200]


# ----------------------------------------- scoped cache invalidation

def _key(s, t, diff="-", fp=(), mep=0, dep=0):
    return (s, t, diff, fp, mep, dep)


INVALIDATION_CASES = {
    "rekeys-survivors": (
        [(_key(1, 2), (10, 2, True), frozenset({1, 5, 2})),
         (_key(3, 4), (20, 3, True), frozenset({3, 8, 9, 4})),
         (_key(5, 6), (30, 4, True), None)],
        ({(8, 9)}, "fused.diff", 1, 100, "-", 0),
        [_key(1, 2, "fused.diff", dep=1), _key(1, 2),
         _key(3, 4, "fused.diff", dep=1)]),
    "edge-midpath": (
        [(_key(1, 4), (5, 3, True), frozenset({1, 2, 3, 4}))],
        ({(9, 2)}, "f.diff", 1, 100, "-", 0),
        [_key(1, 4, "f.diff", dep=1)]),
    "drops-other-epoch": (
        [(_key(1, 2, dep=0), (10, 2, True), frozenset({1, 7, 2})),
         (_key(3, 4, "f1.diff", dep=1), (20, 2, True),
          frozenset({3, 9, 4}))],
        ({(5, 6)}, "f2.diff", 2, 100, "f1.diff", 1),
        [_key(3, 4, "f2.diff", dep=2), _key(1, 2, "f2.diff", dep=2)]),
    "full-flush": (
        [(_key(i, i + 1), (i, 1, True), frozenset({i})) for i in range(4)],
        ({(i, i + 1) for i in range(10)}, "f.diff", 1, 5, "-", 0),
        []),
}
INV_COUNTERS = ("serve_cache_invalidated_scoped_total",
                "serve_cache_invalidated_full_total",
                "serve_cache_rekeyed_total")


@pytest.mark.parametrize("case", sorted(INVALIDATION_CASES))
def test_scoped_invalidation(case):
    """Signature-scoped invalidation: the same drops, re-keys, reasons,
    surviving keys and counters in both packages."""
    entries, (aff, diff, ep, max_e, old_d, old_ep), probes = \
        INVALIDATION_CASES[case]

    def run(P):
        cache = P.serving.ResultCache(1 << 20)
        for key, val, sig in entries:
            cache.put(key, val, sig=sig)
        before = {k: P.counter(k) for k in INV_COUNTERS}
        res = cache.invalidate_scoped(aff, diff, ep, max_edges=max_e,
                                      old_diff=old_d, old_depoch=old_ep)
        return (res, [cache.get(k) for k in probes], list(cache._od),
                [P.counter(k) - before[k] for k in INV_COUNTERS])
    res, probed, keys, deltas = equal(run)
    expect = {"rekeys-survivors": (2, 1, "scoped"),
              "drops-other-epoch": (1, 1, "scoped"),
              "full-flush": (4, 0, "full")}
    if case in expect:
        assert res == expect[case]
    if case == "rekeys-survivors":
        assert probed == [(10, 2, True), None, None]
    if case == "full-flush":
        assert keys == [] and deltas[1] == 4


class _FakeMembership:
    def __init__(self):
        self.epoch = 0

    def candidates_for(self, wid):
        return [wid]

    def statusz(self):
        return {"epoch": self.epoch}


def _seven(calls):
    def answer(wid, q, rconf, diff):
        calls.append(len(q))
        n = len(q)
        return (np.full(n, 7), np.ones(n, np.int64), np.ones(n, bool))
    return answer


def test_cache_key_includes_membership_epoch():
    def run(P):
        dc = P.part.DistributionController("mod", 2, 2, 100)
        mem, calls = _FakeMembership(), []
        fe = P.serving.ServingFrontend(
            dc, P.serving.CallableDispatcher(_seven(calls)),
            sconf=P.serving.ServeConfig(max_wait_ms=1.0).validate(),
            membership=mem)
        fe.start()
        try:
            r1, r2 = fe.query(1, 2), fe.query(1, 2)
            mem.epoch = 1
            r3 = fe.query(1, 2)
        finally:
            fe.stop()
        return [(r.ok, r.cached) for r in (r1, r2, r3)], len(calls)
    assert equal(run) == ([(True, False), (True, True), (True, False)], 2)


def test_cache_key_includes_diff_epoch():
    def run(P):
        dc = P.part.DistributionController("mod", 2, 2, 100)
        fe = P.serving.ServingFrontend(
            dc, P.serving.CallableDispatcher(_seven([])),
            sconf=P.serving.ServeConfig(max_wait_ms=1.0).validate())
        fe.start()
        try:
            out = [fe.query(1, 2).ok, fe.query(1, 2).cached]
            fe._diff_epoch = 3
            out.append(fe.query(1, 2).cached)
        finally:
            fe.stop()
        return out
    assert equal(run) == [True, True, False]


def test_diff_epoch_wire_and_stale_diff_sentinel():
    def run(P):
        W = P.wire
        back = W.RuntimeConfig.from_json(
            W.RuntimeConfig(diff_epoch=4, sig_k=32).to_json())
        rc2 = W.RuntimeConfig.from_json(
            json.dumps({"hscale": 1.0, "future_knob": 9}))
        row = W.StatsRow(ok=False, stale_diff=True)
        b = W.StatsRow.decode(W.STALE_DIFF_LINE)
        o = W.StatsRow.decode("STALE_EPOCH")
        return ((back.diff_epoch, back.sig_k, rc2.diff_epoch, rc2.sig_k),
                row.encode_wire(), (b.ok, b.stale_diff, b.stale_epoch),
                (o.stale_epoch, o.stale_diff))
    assert equal(run) == ((4, 32, 0, 0), "STALE_DIFF", (False, True, False),
                          (True, False))


def test_server_stale_diff_gate(tmp_path):
    def run(P):
        d = str(tmp_path / P.name / "stream")
        srv = P.server.FifoServer.__new__(P.server.FifoServer)
        srv.wid = 0
        srv.traffic = P.traffic.DiffEpochManager(d, materialize=False)
        s0 = P.counter("server_stale_diff_total")
        W = P.wire

        def gate(**kw):
            row = srv._traffic_gate(W.RuntimeConfig(**kw))
            return None if row is None else row.encode_wire()
        out = [gate(), gate(diff_epoch=0), gate(diff_epoch=5),
               P.counter("server_stale_diff_total") - s0]
        P.traffic.write_segment(d, 5, [0], [1], [9])
        out.append(gate(diff_epoch=5))
        srv.traffic = None
        out.append(gate(diff_epoch=99))
        return out
    assert equal(run) == [None, None, "STALE_DIFF", 1, None, None]


# ------------------------------------------------------- query families

def test_family_line_parsing():
    def run(P):
        parse = P.traffic.parse_family_line
        return ([parse(x) for x in ("3 5", "mat 3 5 7 9", "alt 3 5 2",
                                    "rev 3 5")],
                [outcome(lambda: parse(b))[:2] for b in (
                    "mat 3", "alt 3 5", "rev 3", "alt 3 5 2 9")])
    good, bad = equal(run)
    assert good == [None, ("mat", (3, [5, 7, 9])), ("alt", (3, 5, 2)),
                    ("rev", (3, 5))]
    assert bad == [("raise", "ValueError")] * 4


def test_families_match_reference(traffic_world):
    """``mat``, ``alt`` and ``rev`` through each package's frontend: the
    same encoded results, held to the CPU reference walk."""
    world, queries = traffic_world
    s, t = int(queries[0][0]), int(queries[0][1])
    targets = [int(q[1]) for q in queries[:8]]

    def run(P):
        conf, g, dc, disp = world[P.name]
        fe = P.serving.ServingFrontend(dc, disp, sconf=_sconf(P))
        fam = P.traffic.QueryFamilies(fe, graph=g)
        fe.start()
        c0 = [P.counter(k) for k in ("serve_matrix_requests_total",
                                     "serve_alt_requests_total",
                                     "serve_reverse_requests_total")]
        try:
            mat = fam.matrix(s, targets).result(WAIT_S)
            alt = fam.alternatives(s, t, 3).result(WAIT_S)
            rev = fam.reverse(s, t).result(WAIT_S)
        finally:
            fe.stop()
        c1 = [P.counter(k) for k in ("serve_matrix_requests_total",
                                     "serve_alt_requests_total",
                                     "serve_reverse_requests_total")]
        return (mat.encode(), list(mat.costs), alt.encode(),
                [c for c, _v in alt.alternatives], rev.encode(),
                [b - a for a, b in zip(c0, c1)])
    mat_line, costs, _alt_line, alts, rev_line, deltas = equal(run)
    g = world["jax"][1]
    ref = _reference_answers(g, [(s, tt) for tt in targets], g.w)
    assert mat_line.startswith(f"MAT {s} {len(targets)} ")
    assert costs == [c if f else -1 for c, _p, f in ref]
    nbrs, eids = g.out_edges(s)
    exp = sorted(int(g.w[e]) + c for v, e in zip(nbrs, eids)
                 for c, _p, f in _reference_answers(g, [(int(v), t)], g.w)
                 if f)
    assert alts == exp[:3]
    rc, rp, rf = _reference_answers(g, [(t, s)], g.w)[0]
    assert rev_line == f"REV {s} {t} {rc} {rp} {int(rf)}"
    assert deltas == [1, 1, 1]


def test_alt_rejects_out_of_range_nodes(traffic_world):
    world, _q = traffic_world

    def run(P):
        conf, g, dc, disp = world[P.name]
        fe = P.serving.ServingFrontend(dc, disp,
                                       sconf=_sconf(P, queue_depth=64))
        fam = P.traffic.QueryFamilies(fe, graph=g)
        return [outcome(lambda: fam.alternatives(s, t, 2))
                for s, t in ((g.n + 7, 0), (-1, 0), (0, g.n), (0, -2))]
    got = equal(run)
    assert all(o[:2] == ("raise", "ValueError")
               and "node-out-of-range" in o[2] for o in got)


def _stream(P, world, lines):
    conf, g, dc, disp = world[P.name]
    fe = P.serving.ServingFrontend(dc, disp, sconf=_sconf(P))
    fam = P.traffic.QueryFamilies(fe, graph=g)
    fe.start()
    try:
        out = io.StringIO()
        n = P.ingress.serve_stream(fe, io.StringIO(lines), out,
                                   families=fam)
    finally:
        fe.stop()
    return n, out.getvalue().strip().split("\n")


def test_family_ingress_survives_bad_family_request(traffic_world):
    world, queries = traffic_world
    s, t = int(queries[0][0]), int(queries[0][1])
    n_nodes = world["jax"][1].n
    lines = f"alt {n_nodes + 99} {t} 2\nalt -1 {t} 2\n{s} {t}\nquit\n"
    n, got = equal(lambda P: _stream(P, world, lines))
    assert n == 1
    assert got[0].startswith("ERROR -1 -1 node-out-of-range")
    assert got[2].startswith(f"OK {s} {t} ")


def test_family_ingress_stream(traffic_world):
    world, queries = traffic_world
    s, t = int(queries[0][0]), int(queries[0][1])
    lines = (f"{s} {t}\nmat {s} {t}\nrev {s} {t}\n"
             f"alt {s} {t} 2\nmat nonsense\nquit\n")
    n, got = equal(lambda P: _stream(P, world, lines))
    assert n == 4
    assert [ln.split()[0] for ln in got] == ["OK", "MAT", "REV", "ALT",
                                             "ERROR"]


def test_cache_budget_charges_signatures():
    def run(P):
        EB, SB = P.cache.ENTRY_BYTES, P.cache.SIG_NODE_BYTES
        plain = P.serving.ResultCache(4 * EB)
        for i in range(4):
            plain.put(_key(i, i + 1), (i, 1, True))
        sigged = P.serving.ResultCache(4 * EB)
        big = frozenset(range(EB // SB))
        for i in range(4):
            sigged.put(_key(i, i + 1), (i, 1, True), sig=big)
        return len(plain), len(sigged), list(sigged._od)
    assert equal(run)[:2] == (4, 2)


def test_cache_refresh_with_signature_evicts():
    def run(P):
        EB, SB = P.cache.ENTRY_BYTES, P.cache.SIG_NODE_BYTES
        cache = P.serving.ResultCache(4 * EB)
        for i in range(4):
            cache.put(_key(i, i + 1), (i, 1, True))
        big = frozenset(range(2 * EB // SB))
        for i in range(4):
            cache.put(_key(i, i + 1), (i, 1, True), sig=big)
        return cache._bytes <= 4 * EB, len(cache), list(cache._od)
    assert equal(run)[:2] == (True, 1)


def test_swap_ignores_manual_set_diff_entries(traffic_world, tmp_path):
    world, queries = traffic_world
    s, t = int(queries[0][0]), int(queries[0][1])
    g = world["jax"][1]
    fm = first_move_to_target(g, t)
    _c, _p, _f, path = table_search_walk(g, lambda x, _t: fm[int(x)], s, t,
                                         w_query=g.w)
    on_path = set(int(x) for x in path)
    eid = next(e for e in range(g.m) if int(g.src[e]) not in on_path
               and int(g.dst[e]) not in on_path)

    def run(P):
        conf, gp, dc, disp = world[P.name]
        root = tmp_path / P.name
        root.mkdir()
        stream_dir = str(root / "stream")
        manager = P.traffic.DiffEpochManager(stream_dir, poll_ms=1e6)
        fe = P.serving.ServingFrontend(
            dc, disp, sconf=P.serving.ServeConfig(
                queue_depth=256, max_wait_ms=1.0,
                deadline_ms=60_000.0).validate(), traffic=manager)
        fe.start()
        try:
            mdiff = str(root / "manual.diff")
            P.formats.write_diff(mdiff, np.asarray([0]), np.asarray([1]),
                                 np.asarray([12345]))
            fe.set_diff(mdiff)
            out = [fe.submit(s, t).result(WAIT_S).ok,
                   fe.submit(s, t).result(WAIT_S).cached]
            r0 = P.counter("serve_cache_rekeyed_total")
            P.traffic.write_segment(stream_dir, 1, [int(g.src[eid])],
                                    [int(g.dst[eid])], [int(g.w[eid]) * 2])
            out += [fe.poll_traffic(),
                    P.counter("serve_cache_rekeyed_total") - r0,
                    fe.submit(s, t).result(WAIT_S).cached]
        finally:
            fe.stop()
        return out
    assert equal(run) == [True, True, True, 0, False]


# ------------------------------------------------- engine path signatures

def test_engine_sig_k_answers_unchanged(traffic_world):
    """``sig_k`` adds the path signature (nodes ``[Q, sig_k+1]``, moves =
    plen for a complete one) and leaves every answer as it was; the
    port's signatures equal JAX's."""
    world, queries = traffic_world

    def run(P):
        conf, g, dc, disp = world[P.name]
        eng = disp._engine_for(0)
        mine = queries[dc.worker_of(queries[:, 1]) == 0][:16]
        a0 = eng.answer(mine, P.wire.RuntimeConfig())[:3]
        a1 = eng.answer(mine, P.wire.RuntimeConfig(sig_k=64))[:3]
        nodes, moves = eng.last_paths
        a2 = eng.answer(mine, P.wire.RuntimeConfig(sig_k=4, k_moves=3))[:3]
        n2, m2 = eng.last_paths
        return ([x.tolist() for x in a0], [x.tolist() for x in a1],
                nodes.tolist(), moves.tolist(), [x.tolist() for x in a2],
                n2.tolist(), m2.tolist())
    a0, a1, nodes, moves, _a2, n2, _m2 = equal(run)
    assert a0 == a1 and len(nodes[0]) == 65 and moves == a1[1]
    assert len(n2[0]) == 5


# --------------------------------------------- tier-1 live-swap smoke

SHED = ("serve_shed_busy_total", "serve_shed_unavailable_total",
        "serve_timeouts_total", "serve_errors_total")


def test_live_swap_smoke(traffic_world, tmp_path):
    """100+ mixed-family queries across one LIVE epoch swap in each
    package: zero sheds, scoped invalidation with re-keyed survivors
    hitting, post-swap answers equal to a fresh frontend on the fused
    diff and to the CPU reference — and the same answers, fused diff
    bytes and invalidation counts in both packages."""
    world, queries = traffic_world
    pool = [(int(s), int(t)) for s, t in queries[:60]]

    def run(P):
        conf, g, dc, disp = world[P.name]
        stream_dir = str(tmp_path / P.name / "stream")
        manager = P.traffic.DiffEpochManager(stream_dir, poll_ms=25.0)
        fe = P.serving.ServingFrontend(
            dc, disp, sconf=P.serving.ServeConfig(
                queue_depth=2048, max_wait_ms=1.0,
                deadline_ms=60_000.0).validate(), traffic=manager)
        fam = P.traffic.QueryFamilies(fe, graph=g, traffic=manager)
        shed0 = [P.counter(k) for k in SHED]
        sc0 = P.counter("serve_cache_invalidated_scoped_total")
        fe.start()
        try:
            pre = [f.result(WAIT_S) for f in
                   [fe.submit(s, t) for s, t in pool]]
            fams = [fam.matrix(pool[0][0], [t for _s, t in pool[:10]]),
                    fam.alternatives(pool[1][0], pool[1][1], 3),
                    fam.reverse(pool[2][0], pool[2][1])]
            fam_pre = [f.result(WAIT_S).encode() for f in fams]
            eids = P.scenarios.pick_corridor(g, frac=0.01, seed=5)
            new_w = (g.w[eids].astype(np.int64) * 3).astype(np.int64)
            P.traffic.write_segment(stream_dir, 1, g.src[eids],
                                    g.dst[eids], new_w)
            deadline = time.monotonic() + 10.0
            while fe._diff_epoch != 1:
                assert time.monotonic() < deadline, "swap never applied"
                time.sleep(0.02)
            post = [f.result(WAIT_S) for f in
                    [fe.submit(s, t) for s, t in pool]]
            mat = fam.matrix(pool[0][0],
                             [t for _s, t in pool[:10]]).result(WAIT_S)
            rev = fam.reverse(pool[2][0], pool[2][1]).result(WAIT_S)
        finally:
            fe.stop()
        fresh = P.serving.ServingFrontend(
            dc, disp, sconf=P.serving.ServeConfig(
                queue_depth=2048, max_wait_ms=1.0, cache_bytes=0,
                deadline_ms=60_000.0).validate(),
            diff=manager.fused_path(1))
        fresh.start()
        try:
            fresh_res = [fresh.submit(s, t).result(WAIT_S)
                         for s, t in pool]
        finally:
            fresh.stop()
        return dict(
            pre=[(r.status, r.cost, r.plen, r.finished) for r in pre],
            fam_pre=fam_pre,
            post=[(r.status, r.cost, r.plen, r.finished) for r in post],
            fresh=[(r.status, r.cost, r.plen, r.finished)
                   for r in fresh_res],
            fam_post=(mat.encode(), rev.encode()),
            fused=_read(manager.fused_path(1)),
            diff_is_fused=fe.diff == manager.fused_path(1),
            any_hit=any(r.cached for r in post),
            sheds=[P.counter(k) - v for k, v in zip(SHED, shed0)],
            scoped=P.counter("serve_cache_invalidated_scoped_total") > sc0)
    got = both(run)
    t, j = got["torch"], got["jax"]
    for k in ("pre", "fam_pre", "post", "fresh", "fam_post", "fused",
              "diff_is_fused", "sheds", "scoped"):
        assert t[k] == j[k], k
    assert t["post"] == t["fresh"] and t["sheds"] == [0, 0, 0, 0]
    assert t["scoped"] and t["any_hit"] and t["diff_is_fused"]
    assert all(r[0] == "OK" for r in t["pre"] + t["post"])
    g = world["jax"][1]
    w_new = g.weights_with_diff(PKGS["jax"].formats.read_diff(str(
        tmp_path / "jax" / "stream" / "fused" / "fused-e000001.diff")))
    ref = _reference_answers(g, pool[:12], w_new)
    assert [r[1:] for r in t["post"][:12]] == ref


# the JAX cases of the bench waivers: obs.fleet's waiver file and the
# dos-obs bench-diff gate over it (cli.obs)
from torch_port_cases import load_cases  # noqa: E402

globals().update(load_cases("test_traffic.py", __name__, drop={}, only=(
    "test_bench_waiver_file_unreadable_fails_closed",
    "test_bench_diff_waiver_gate")))
