"""PyTorch port, the answer-integrity plane (``integrity/``) against
the JAX package's.

The JAX package's ``tests/test_integrity.py`` cases run over the port
(``torch_port_cases``), on CPU engines; its chaos drill stays ``slow``,
as in JAX."""

import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)
from torch_port_cases import load_cases  # noqa: E402

globals().update(load_cases("test_integrity.py", __name__, drop={}))


# ------------------------------------------- across the two packages

import os  # noqa: E402
import shutil  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402

from torch_parity import both  # noqa: E402

X_WORKERS, X_BLOCK = 4, 16


@pytest.fixture(scope="module")
def x_index(tmp_path_factory):
    """A 4-worker ``tpu`` index of the 16 x 12 city grid (a shard of 48
    rows, on which rle stays viable) in blocks of 16 rows, built by the
    JAX package, raw and as pack4 containers, and
    one epoch index (a copy of the raw one) under ``epoch-e000001``."""
    from distributed_oracle_search_tpu.data import synth_city_graph
    from distributed_oracle_search_tpu.models import cpd as jcpd
    from distributed_oracle_search_tpu.parallel.partition import (
        DistributionController as JDC,
    )

    g = synth_city_graph(16, 12, seed=7)
    dc = JDC("tpu", X_WORKERS, X_WORKERS, g.n, block_size=X_BLOCK)
    root = tmp_path_factory.mktemp("x-scrub")
    out = {}
    for codec in ("raw", "pack4"):
        d = str(root / codec)
        for wid in range(X_WORKERS):
            jcpd.build_worker_shard(g, dc, wid, d,
                                    codec=None if codec == "raw" else codec)
        jcpd.write_index_manifest(d, dc)
        out[codec] = d
    edir = jcpd.epoch_index_dir(out["raw"], 1)
    shutil.copytree(out["raw"], edir,
                    ignore=shutil.ignore_patterns("epoch-*"))
    return out


def _world(P):
    from importlib import import_module

    synth = import_module(P.graph.__name__.rsplit(".", 1)[0] + ".synth")
    g = synth.synth_city_graph(16, 12, seed=7)
    dc = P.part.DistributionController("tpu", X_WORKERS, X_WORKERS, g.n,
                                       block_size=X_BLOCK)
    return g, dc


def _copy(src, dst):
    shutil.copytree(src, dst)
    return str(dst)


def _report(r, outdir):
    return {k: (v.replace(outdir, "<dir>") if isinstance(v, str) else
                [x.replace(outdir, "<dir>") for x in v]
                if isinstance(v, list) else v)
            for k, v in r.items()}


def _engine(P, g, dc, outdir, monkeypatch, resident, rot=True):
    monkeypatch.setenv("DOS_CPD_RESIDENT", resident)
    if rot:
        monkeypatch.setenv("DOS_FAULTS", "corrupt-resident;wid=0;times=1")
    P.faults.reset()
    try:
        return P.engine.ShardEngine(g, dc, 0, outdir, **P.dev)
    finally:
        monkeypatch.delenv("DOS_FAULTS", raising=False)
        P.faults.reset()


def _answers(P, eng, g):
    q = np.stack([np.arange(g.n, dtype=np.int64),
                  np.full(g.n, int(eng.dc.owned(0)[1]), np.int64)], 1)
    c, p, f, _ = eng.answer(q, P.wire.RuntimeConfig())
    return np.asarray(c).tolist(), np.asarray(p).tolist(), \
        np.asarray(f).tolist()


@pytest.mark.parametrize("disk,resident", [("raw", "raw"),
                                           ("pack4", "pack4"),
                                           ("raw", "rle"),
                                           ("pack4", "rle")])
def test_scrub_reports_equal_jax(x_index, disk, resident, tmp_path,
                                 monkeypatch):
    """On copies of one index: resident rot (the ``corrupt-resident``
    fault) is found and re-bound, the next pass is clean, disk rot heals
    from the graph, and every report, the healed block's bytes and the
    answers after equal the JAX package's."""
    def run(P):
        g, dc = _world(P)
        outdir = _copy(x_index[disk], tmp_path / P.name)
        eng = _engine(P, g, dc, outdir, monkeypatch, resident)
        scrub = P.scrub.scrub_engine_table
        reports = [scrub(eng, outdir, eng.fm, None)]
        reports.append(scrub(eng, outdir, eng.fm, None))
        victim = os.path.join(outdir, P.cpd.shard_block_name(0, 1, 0))
        with open(victim, "r+b") as f:
            f.seek(-3, os.SEEK_END)
            f.write(b"\xff\xff\xff")
        reports.append(scrub(eng, outdir, eng.fm, None, budget=2))
        reports.append(scrub(eng, outdir, eng.fm, None,
                             cursor=reports[-1][1]))
        with open(victim, "rb") as f:
            healed = f.read()
        return ([(_report(r, outdir), cur) for r, cur in reports],
                eng.resident_codec, healed, _answers(P, eng, g))
    got = both(run)
    assert got["torch"] == got["jax"]
    reports, codec, _, _ = got["torch"]
    assert reports[0][0]["corrupt"] and reports[0][0]["rebound"]
    assert not reports[1][0]["corrupt"] and reports[1][0]["checked"] == 3
    assert reports[2][0]["healed"] or reports[3][0]["healed"]
    assert codec == resident


def test_scrub_promoted_epoch_equal_jax(x_index, tmp_path, monkeypatch):
    """A promoted epoch table: resident rot re-binds under the promote
    lock keeping its epoch; a block lost from the epoch index is an
    error (never healed from the free-flow graph), and a re-bind then
    drops the promotion. Equal to the JAX package's, report for
    report."""
    def run(P):
        g, dc = _world(P)
        outdir = _copy(x_index["raw"], tmp_path / P.name)
        eng = _engine(P, g, dc, outdir, monkeypatch, "raw", rot=False)
        edir = P.cpd.epoch_index_dir(outdir, 1)
        assert eng.promote_index(edir, 1)
        rows = np.array(np.asarray(eng.fm), np.int8, copy=True)
        rows[2, :] = np.where(rows[2, :] <= 0, 1, 0)
        eng._fm_promoted = (1, eng._make_resident(rows))
        scrub = P.scrub.scrub_engine_table
        out = [scrub(eng, edir, eng._fm_promoted[1], 1)]
        promoted = np.asarray(eng._fm_promoted[1]).tolist()
        os.remove(os.path.join(edir, P.cpd.shard_block_name(0, 2, 0)))
        out.append(scrub(eng, edir, eng._fm_promoted[1], 1))
        dropped = P.scrub._rebind(eng, 1)
        return ([(_report(r, outdir), c) for r, c in out], promoted,
                eng._fm_promoted is None, dropped)
    got = both(run)
    assert got["torch"] == got["jax"]
    (first, _), (second, _) = got["torch"][0]
    assert first["rebound"] and second["errors"]
    assert got["torch"][2] and got["torch"][3]


def test_table_scrubber_passes_equal_jax(x_index, tmp_path, monkeypatch):
    """``TableScrubber.run_pass`` over two engines with a block budget:
    the per-table reports, the resume cursors and ``statusz`` equal the
    JAX package's."""
    def run(P):
        g, dc = _world(P)
        outdir = _copy(x_index["pack4"], tmp_path / P.name)
        engs = [_engine(P, g, dc, outdir, monkeypatch, "pack4"),
                _engine(P, g, dc, outdir, monkeypatch, "raw", rot=False)]
        sc = P.scrub.TableScrubber(lambda: engs, interval_s=60.0,
                                   blocks_per_pass=2)
        passes = [_report_list(sc.run_pass(), outdir) for _ in range(3)]
        passes.append(_report_list(sc.run_pass(budget=0), outdir))
        st = sc.statusz()
        return passes, {k: st[k] for k in ("passes", "corrupt_blocks",
                                            "healed_blocks",
                                            "blocks_per_pass")}
    got = both(run)
    assert got["torch"] == got["jax"]
    passes, st = got["torch"]
    # as in JAX, a budgeted pass that finds rot before its budget ends
    # returns at the budget and does not re-bind (ROADMAP.md C11)
    assert st["corrupt_blocks"] == 2
    assert not any(r["rebound"] for p in passes for r in p)


def _report_list(reports, outdir):
    return [_report(r, outdir) for r in reports]


def test_choose_audit_lane_equal_jax():
    def run(P):
        out = []
        for cands in ((), (0,), (0, 3), (3, 0), (0, 3, 5)):
            for via in (0, 3):
                for nq in (0, 1, 16, 64, 65, 4096):
                    for have in (False, True):
                        out.append(P.audit.choose_audit_lane(
                            cands, via, nq, have_reference=have,
                            max_reference=64))
        return out
    got = both(run)
    assert got["torch"] == got["jax"]
    assert {lane for lane, _ in got["torch"]} == {
        "replica", "reference", "recompute"}


@pytest.fixture(scope="module")
def x_diff(tmp_path_factory):
    from distributed_oracle_search_tpu.data import synth_city_graph
    from distributed_oracle_search_tpu.data.formats import write_diff

    g = synth_city_graph(16, 12, seed=7)
    rng = np.random.default_rng(17)
    pick = rng.choice(len(g.src), size=len(g.src) // 4, replace=False)
    path = str(tmp_path_factory.mktemp("x-diff") / "g.diff")
    write_diff(path, g.src[pick], g.dst[pick], g.w[pick] * 3 + 1)
    return path


def test_reference_lane_equal_jax(x_diff):
    """The audit's CPU reference lane (``make_reference_fn``) answers
    the JAX package's, free flow and under a diff."""
    def run(P):
        g, _ = _world(P)
        ref = P.audit.make_reference_fn(g, max_fm_cache=8)
        rng = np.random.default_rng(5)
        q = rng.integers(0, g.n, size=(48, 2)).astype(np.int64)
        out = []
        for diff in ("-", x_diff, "-"):
            c, p, f = ref(q, P.wire.RuntimeConfig(), diff)
            out.append((np.asarray(c).tolist(), np.asarray(p).tolist(),
                        np.asarray(f).tolist()))
        return out
    got = both(run)
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == got["torch"][2] != got["torch"][1]


class _LaneDispatcher:
    """Answers ``|s - t|``, except that shard 1's replica lane (via 7)
    answers one more on its first row: a rotten copy."""

    def answer_batch(self, wid, queries, rconf, diff, via=None):
        q = np.asarray(queries)
        cost = np.abs(q[:, 0] - q[:, 1]).astype(np.int64)
        if int(wid) == 1 and via == 7:
            cost[0] += 1
        return cost, np.ones(len(q), np.int64), np.ones(len(q), bool)


def _audit_run(P, rate):
    P.recorder.drain_pending()
    ref_calls = []

    def reference(q, config, diff):
        ref_calls.append(len(q))
        q = np.asarray(q)
        return (np.abs(q[:, 0] - q[:, 1]).astype(np.int64),
                np.ones(len(q), np.int64), np.ones(len(q), bool))

    aud = P.audit.AnswerAuditor(_LaneDispatcher(), rate,
                                reference_fn=reference, max_reference=8,
                                queue_max=256)
    rng = np.random.default_rng(rate)
    queued = []
    try:
        for i in range(60):
            wid = int(rng.integers(0, 3))
            nq = int(rng.choice([1, 8, 9, 40]))
            q = rng.integers(0, 99, size=(nq, 2)).astype(np.int64)
            cands = [(), (0, 7), (7, 0)][i % 3]
            served = (np.abs(q[:, 0] - q[:, 1]).astype(np.int64),
                      np.ones(nq, np.int64), np.ones(nq, bool))
            queued.append(aud.maybe_submit(
                wid, 0 if cands != (7, 0) else 7, cands, q,
                P.wire.RuntimeConfig(time=5 if i % 11 == 10 else 0),
                "-", *served))
        deadline = time.monotonic() + 60
        while (aud.statusz()["audited"] < sum(queued)
               and time.monotonic() < deadline):
            time.sleep(0.01)
    finally:
        aud.stop()
    evs = [{k: v for k, v in e.items() if k not in ("ts", "pid")}
           for e in P.recorder.drain_pending()
           if e["kind"] == "audit_divergence"]
    st = aud.statusz()
    return queued, sorted(ref_calls), aud.snapshot(), st, \
        sorted(evs, key=repr)


@pytest.mark.parametrize("rate", [250, 1000])
def test_audit_sampling_lanes_and_divergence_equal_jax(rate):
    """One seeded stream of served batches: the batches sampled, the
    lane each took (reference calls), the divergences found on the
    rotten replica lane and their recorder events equal the JAX
    package's."""
    got = both(lambda P: _audit_run(P, rate))
    assert got["torch"] == got["jax"]
    queued, ref_calls, snap, st, evs = got["torch"]
    assert st["audited"] == sum(queued) and ref_calls and snap
    assert evs and all(e["lane"] == "replica" for e in evs)
