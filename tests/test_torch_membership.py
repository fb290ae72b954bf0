"""PyTorch port, elastic membership (``parallel.membership``) and its
hooks in the worker server and the campaign head, held against the JAX
package on the CPU.

Every case runs the same steps through each package — on its own copy of
one JAX-built replicated index — and compares what each observes: conf
tables and wire lines, ``membership.json`` bytes after every step (each
package reading the other's), plans, candidate chains, journals, counter
deltas, healed block bytes, epoch-gate rows, frontend answers and sheds,
and campaign rows under a committed epoch. The mirror of
``tests/test_membership.py`` without its ``slow`` chaos drill; its
``test_top_tolerates_mixed_statusz_schemas`` runs over the port
(``torch_port_cases``).
"""

import csv
import json
import os
import shutil
import threading
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)

from distributed_oracle_search_tpu.data import (  # noqa: E402
    ensure_synth_dataset, read_scen,
)
from distributed_oracle_search_tpu.data.graph import Graph  # noqa: E402
from distributed_oracle_search_tpu.models.cpd import (  # noqa: E402
    build_replica_shards, build_worker_shard, write_index_manifest,
)
from distributed_oracle_search_tpu.parallel.partition import (  # noqa: E402
    DistributionController as JDC,
)

from torch_parity import PKGS, both, equal, outcome  # noqa: E402

N_WORKERS = 3


def _dc(P, n, **kw):
    return P.part.DistributionController("mod", N_WORKERS, N_WORKERS, n,
                                         **kw)


# ------------------------------------------------- conf wire round-trips

def _tab(p):
    return {k: (np.asarray(v).tolist() if not np.isscalar(v) else v)
            for k, v in p.items()}


CONF_CASES = {
    "identity-r1": lambda P: P.part.DistributionController(
        "mod", 4, 4, 12, block_size=2).format_conf(),
    "identity-r2": lambda P: P.part.DistributionController(
        "mod", 4, 4, 12, block_size=2, replication=2).format_conf(),
    "epoch-owners": lambda P: _tab(P.part.parse_conf(
        P.part.DistributionController("mod", 4, 4, 32, block_size=4,
                                      epoch=7, owners=[0, 5, 2, 3])
        .format_conf())),
    "legacy-is-epoch0": lambda P: _tab(P.part.parse_conf(
        "node,wid,bid,bidx\n0,0,0,0\n1,1,0,0")),
    "unknown-columns": lambda P: _tab(P.part.parse_conf(
        "node,future,wid,bid,bidx,epoch,owner\n0,9,0,0,0,3,2\n"
        "1,9,1,0,0,3,1")),
    "mixed-epochs": lambda P: outcome(lambda: P.part.parse_conf(
        "node,wid,bid,bidx,epoch,owner\n0,0,0,0,3,0\n1,1,0,0,4,1")),
    "short-owners": lambda P: outcome(lambda: P.part.DistributionController(
        "mod", 4, 4, 16, owners=[0, 1])),
    "negative-epoch": lambda P: outcome(
        lambda: P.part.DistributionController("mod", 4, 4, 16, epoch=-1)),
}


@pytest.mark.parametrize("case", sorted(CONF_CASES))
def test_conf_wire_equal(case):
    """Epoch-0 identity tables keep the legacy columns; epoch/owner
    columns round-trip; unknown columns are tolerated, torn epochs and
    bad owners refused — the same text, tables and errors in both."""
    got = equal(CONF_CASES[case])
    if case == "identity-r1":
        assert got.split("\n")[0] == "node,wid,bid,bidx"
    if case in ("mixed-epochs", "short-owners", "negative-epoch"):
        assert got[0] == "raise"


def _wire(P):
    W = P.wire
    rc = W.RuntimeConfig(epoch=4, diff_epoch=2, sig_k=8, answer_fp=True)
    d = json.loads(rc.to_json())
    d["some_future_knob"] = True
    stale_e = W.StatsRow(ok=False, stale_epoch=True)
    stale_d = W.StatsRow(ok=False, stale_diff=True)
    return (rc.to_json(), W.RuntimeConfig.from_json(json.dumps(d)),
            W.RuntimeConfig.from_json('{"itrs": 2}').epoch,
            stale_e.encode_wire(), stale_d.encode_wire(),
            [(r.ok, r.stale_epoch, r.stale_diff) for r in (
                W.StatsRow.decode(W.STALE_EPOCH_LINE),
                W.StatsRow.decode(W.STALE_EPOCH_LINE + " 3"),
                W.StatsRow.decode(W.STALE_DIFF_LINE))],
            W.StatsRow.failed().encode_wire())


def test_runtime_config_epoch_and_stale_sentinels():
    got = both(_wire)
    t, j = got["torch"], got["jax"]
    assert t[0] == j[0] and t[2:] == j[2:]
    assert dataclass_dict(t[1]) == dataclass_dict(j[1])
    assert t[1].epoch == 4 and t[2] == 0
    assert t[3] == "STALE_EPOCH" and t[4] == "STALE_DIFF"


def dataclass_dict(x):
    import dataclasses
    return dataclasses.asdict(x)


# ----------------------------------------------- owner-aware routing

def _routing(P):
    dc = P.part.DistributionController("mod", 4, 4, 64, replication=2,
                                       epoch=1, owners=[4, 1, 2, 3])
    qs = np.stack([np.zeros(8, np.int64), np.arange(8, dtype=np.int64)],
                  axis=1)
    groups = dc.group_queries(qs, dead={4})
    dc2 = P.part.DistributionController("mod", 2, 2, 8, replication=2)
    dc3 = P.part.DistributionController("mod", 4, 4, 100, epoch=1,
                                        owners=[0, 4, 2, 3])
    qs3 = np.stack([np.zeros(12, np.int64),
                    np.arange(12, dtype=np.int64)], axis=1)
    g3 = dc3.group_queries(qs3, dead=[2])
    return (dc.replica_workers(0), dc.replica_rank(0, 4),
            dc.replica_rank(0, 1), outcome(lambda: dc.replica_rank(0, 2)),
            dc.replica_shards(4), dc.replica_shards(1),
            {k: v.tolist() for k, v in groups.items()},
            dc2.replica_shards(2), outcome(lambda: dc2.replica_rank(0, 2)),
            {k: v.tolist() for k, v in g3.items()}, list(g3))


def test_owner_aware_replica_routing():
    """Owner-aware chains, hosted shards, the dead-remap onto a joined
    worker and the out-of-range joiner hosting nothing: equal."""
    got = equal(_routing)
    assert got[0] == [4, 1] and got[4] == [0, 3] and got[7] == []
    assert 4 in got[9] and len(got[9][4]) == 3


# ----------------------------------------------- membership state file

def test_state_round_trip_and_compat(tmp_path):
    """Each package reads the other's ``membership.json`` (the same
    bytes), tolerates unknown keys and rejects only newer schemas."""
    out = {}
    for name, P in PKGS.items():
        d = tmp_path / name
        d.mkdir()
        assert P.fleet.load_state(str(d)) is None
        assert P.fleet.current_epoch(str(d)) == 0
        P.fleet.save_state(str(d), P.fleet.MembershipState(
            epoch=2, workers=["a", "b"], owners=[1, 0],
            migration=P.fleet.Migration(epoch=3, kind="join", worker=2,
                                        moves=[[0, 1, 2]]).to_dict()))
        with open(P.fleet.state_path(str(d)), "rb") as f:
            out[name] = f.read()
    assert out["torch"] == out["jax"]
    for reader, writer in (("torch", "jax"), ("jax", "torch")):
        st = PKGS[reader].fleet.load_state(str(tmp_path / writer))
        assert st.epoch == 2 and st.owners == [1, 0]
        assert st.live_migration.moves == [[0, 1, 2]]
    errs = {}
    for name, P in PKGS.items():
        path = P.fleet.state_path(str(tmp_path / name))
        raw = json.load(open(path))
        raw["future_key"] = {"x": 1}
        json.dump(raw, open(path, "w"))
        assert P.fleet.load_state(str(tmp_path / name)).epoch == 2
        raw["version"] = P.fleet.MEMBERSHIP_VERSION + 1
        json.dump(raw, open(path, "w"))
        errs[name] = outcome(lambda: P.fleet.load_state(
            str(tmp_path / name)))
    assert errs["torch"][:2] == errs["jax"][:2] == ("raise", "ValueError")
    assert "schema" in errs["torch"][2]


# ------------------------------------------------------ built world

@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """3-worker world, R=2 replicated index + manifest, built by the JAX
    package (the port reads and heals the same files)."""
    datadir = str(tmp_path_factory.mktemp("t-membership-data"))
    paths = ensure_synth_dataset(datadir, width=8, height=6,
                                 n_queries=45, seed=29)
    outdir = os.path.join(datadir, "index")
    g = Graph.from_xy(paths["xy"])
    dc = JDC("mod", N_WORKERS, N_WORKERS, g.n, replication=2)
    for wid in range(N_WORKERS):
        build_worker_shard(g, dc, wid, outdir)
        build_replica_shards(g, dc, wid, outdir)
    write_index_manifest(outdir, dc)
    return datadir, paths, outdir, g.n


def _fresh(P, world, tmp_path, name, diffs=("-",), replication=2):
    """Package ``P``'s own copy of the index, its conf, graph and
    controller."""
    _datadir, paths, outdir, n = world
    my_out = str(tmp_path / f"{P.name}-index-{name}")
    shutil.copytree(outdir, my_out)
    conf = P.config.ClusterConfig(
        workers=["localhost"] * N_WORKERS, partmethod="mod",
        partkey=N_WORKERS, outdir=my_out, xy_file=paths["xy"],
        scenfile=paths["scen"], diffs=list(diffs), nfs=str(tmp_path),
        replication=replication).validate()
    g = P.graph.Graph.from_xy(paths["xy"])
    return conf, g, _dc(P, n, replication=replication), my_out


def _state_bytes(outdir):
    with open(os.path.join(outdir, "membership.json"), "rb") as f:
        return f.read()


COUNTERS = ("reshard_migrations_total", "reshard_shards_moved_total",
            "reshard_aborted_total", "reshard_blocks_adopted_total")


def _deltas(P, before):
    return {k: P.counter(k) - before[k] for k in COUNTERS}


def _scenario(world, tmp_path, name, steps, replication=2):
    """Run ``steps(P, mc, conf, g, dc, outdir, trace)`` per package with
    its counters' deltas appended; assert the traces are equal."""
    def run(P):
        conf, g, dc, outdir = _fresh(P, world, tmp_path, name,
                                     replication=replication)
        mc = P.controller(conf, dc, g)
        before = {k: P.counter(k) for k in COUNTERS}
        trace = []
        steps(P, mc, conf, g, dc, outdir, trace)
        trace.append(_deltas(P, before))
        return trace
    return equal(run)


def test_join_window_and_commit(world, tmp_path):
    def steps(P, mc, conf, g, dc, outdir, trace):
        mig = mc.begin(mc.plan_join("localhost"), host="localhost")
        moved = mig.moves[0][0]
        trace += [mig.to_dict(), mc.candidates_for(moved),
                  P.fleet.current_epoch(outdir), _state_bytes(outdir)]
        mc.catch_up(mig)
        state = mc.commit(mig)
        dc2 = P.fleet.apply_state(dc, P.fleet.load_state(outdir))
        trace += [state.to_dict(), _state_bytes(outdir),
                  P.gauge("reshard_epoch"), mc.candidates_for(moved),
                  dc2.epoch, dc2.owner_of(moved)]
    t = _scenario(world, tmp_path, "join", steps)
    assert t[0]["worker"] == N_WORKERS
    assert t[1][:2] == [t[0]["moves"][0][0], N_WORKERS]
    assert t[2] == 0 and t[4]["epoch"] == 1 and t[6] == 1
    assert t[-1]["reshard_migrations_total"] == 1
    assert t[-1]["reshard_shards_moved_total"] == 1
    assert t[-1]["reshard_blocks_adopted_total"] > 0


def test_leave_transfers_to_replica_first(world, tmp_path):
    def steps(P, mc, conf, g, dc, outdir, trace):
        mig = mc.begin(mc.plan_leave(1))
        mc.catch_up(mig)
        state = mc.commit(mig)
        trace += [mig.moves, state.to_dict(), _state_bytes(outdir),
                  P.fleet.apply_state(dc, state).replica_workers(1)]
    t = _scenario(world, tmp_path, "leave", steps)
    assert t[0] == [[1, 1, 2]] and t[1]["owners"] == [0, 2, 2]
    assert t[3][0] == 2


def test_commit_requires_catchup_and_abort_restores(world, tmp_path):
    def steps(P, mc, conf, g, dc, outdir, trace):
        mig = mc.begin(mc.plan_join("localhost"), host="localhost")
        trace.append(outcome(lambda: mc.commit(mig))[:2])
        st = mc.abort(mig)
        trace += [st.to_dict(), _state_bytes(outdir)]
        mig2 = mc.begin(mc.plan_join("localhost"), host="localhost")
        trace.append(outcome(lambda: mc.begin(mc.plan_join("x")))[:2])
        mc.abort(mig2)
    t = _scenario(world, tmp_path, "abort", steps)
    assert t[0] == ("raise", "ValueError")
    assert t[1]["epoch"] == 0 and len(t[1]["workers"]) == N_WORKERS
    assert t[-1]["reshard_aborted_total"] == 2


def test_catch_up_crash_resume(world, tmp_path, monkeypatch):
    """``kill-during-reshard`` between moves: the journal keeps the done
    list, a fresh controller resumes exactly the tail and commits."""
    def steps(P, mc, conf, g, dc, outdir, trace):
        mig = P.fleet.Migration(epoch=1, kind="join", worker=N_WORKERS,
                                moves=[[0, 0, N_WORKERS],
                                       [1, 1, N_WORKERS]])
        mc.begin(mig, host="localhost")
        P.faults.reset()
        monkeypatch.setenv("DOS_FAULTS",
                           "kill-during-reshard;mode=raise;times=1")
        trace.append(outcome(lambda: mc.catch_up(mig))[:2])
        monkeypatch.delenv("DOS_FAULTS")
        P.faults.reset()
        st = P.fleet.load_state(outdir)
        trace += [st.epoch, st.live_migration.done, _state_bytes(outdir)]
        state = P.controller(conf, dc, g).resume()
        trace += [state.to_dict(), _state_bytes(outdir)]
    t = _scenario(world, tmp_path, "crash", steps)
    assert t[0] == ("raise", "RuntimeError") and t[1:3] == [0, [0]]
    assert t[4]["epoch"] == 1 and t[4]["owners"][:2] == [N_WORKERS] * 2


def test_adopt_heals_corrupt_block(world, tmp_path):
    """A corrupt block of an adopted shard is healed (on the CPU here,
    by K1/K2 on the card) to the bytes JAX heals it to; a second pass
    verifies clean."""
    def run(P):
        conf, g, dc, outdir = _fresh(P, world, tmp_path, "heal")
        victim = P.cpd.shard_block_name(2, 0)
        with open(os.path.join(outdir, victim), "r+b") as f:
            f.seek(64)
            f.write(b"\x55" * 16)
        report = P.cpd.adopt_shard_blocks(g, dc, 2, outdir, **P.dev)
        again = P.cpd.adopt_shard_blocks(g, dc, 2, outdir, **P.dev)
        with open(os.path.join(outdir, victim), "rb") as f:
            healed = f.read()
        return report, again, healed
    report, again, _ = equal(run)
    assert report["healed"] == [PKGS["torch"].cpd.shard_block_name(2, 0)]
    assert again["healed"] == [] and again["ok"] == again["blocks"]


def test_leave_fallback_never_targets_departed_worker(world, tmp_path):
    def steps(P, mc, conf, g, dc, outdir, trace):
        mig = mc.begin(mc.plan_leave(2))
        mc.catch_up(mig)
        mc.commit(mig)
        trace += [list(mc.state.owners), mc.plan_leave(0).moves]
    t = _scenario(world, tmp_path, "leave-r1", steps, replication=1)
    assert 2 not in t[0]
    targets = {to for _s, _f, to in t[1]}
    assert 2 not in targets and targets <= set(t[0])


def _join0(P, mc, host="localhost"):
    mig = P.fleet.Migration(epoch=1, kind="join", worker=3,
                            moves=[[0, 0, 3]])
    mc.begin(mig, host=host)
    mc.catch_up(mig)
    return mc.commit(mig)


def test_reader_controller_observes_external_commit(world, tmp_path):
    """A long-lived reader picks up another controller's commit on its
    throttled re-read of ``membership.json``."""
    def steps(P, mc, conf, g, dc, outdir, trace):
        trace.append(mc.candidates_for(0))
        _join0(P, P.controller(conf, dc, g))
        mc._last_refresh = 0.0
        trace += [mc.candidates_for(0), mc.epoch]
    t = _scenario(world, tmp_path, "xproc", steps, replication=1)
    assert t[0] == [0] and t[1][0] == 3 and t[2] == 1


def test_refresh_never_rolls_epoch_back(world, tmp_path):
    def steps(P, mc, conf, g, dc, outdir, trace):
        committed = _join0(P, mc)
        P.fleet.save_state(outdir, P.fleet.MembershipState(
            epoch=0, workers=["localhost"] * N_WORKERS,
            owners=list(range(N_WORKERS))))
        mc.refresh()
        trace += [mc.epoch, mc.candidates_for(0)]
        P.fleet.save_state(outdir, P.fleet.MembershipState(
            epoch=1, workers=committed.workers, owners=committed.owners,
            migration=P.fleet.Migration(epoch=2, kind="leave", worker=1,
                                        moves=[[1, 1, 2]]).to_dict()))
        mc.refresh()
        trace.append(mc.state.migration)
    t = _scenario(world, tmp_path, "rollback", steps, replication=1)
    assert t[0] == 1 and t[1][0] == 3 and t[2] is not None


def test_dc_view_cache_invalidated_across_mutations(world, tmp_path):
    def steps(P, mc, conf, g, dc, outdir, trace):
        gen0 = mc._state_gen
        before = mc.dc_view()
        trace.append(before.owner_of(0))
        _join0(P, mc)
        trace.append(mc._state_gen > gen0)
        mc._dc_cache = (gen0, before)
        trace.append(mc.dc_view().owner_of(0))
    assert _scenario(world, tmp_path, "dcgen", steps,
                     replication=1)[:3] == [0, True, 3]


def test_plan_join_records_host(world, tmp_path):
    def steps(P, mc, conf, g, dc, outdir, trace):
        mig = mc.plan_join("joiner-host")
        mc.begin(mig)
        trace += [mig.host, mc.state.workers[-1]]
        mc.abort(mig)
        mc.begin(mc.plan_join("planned-host"), host="explicit-host")
        trace += [mc.state.workers[-1], _state_bytes(outdir)]
    t = _scenario(world, tmp_path, "planhost", steps, replication=1)
    assert t[:3] == ["joiner-host", "joiner-host", "explicit-host"]


def test_refresh_keeps_dc_cache_on_unchanged_state(world, tmp_path):
    def steps(P, mc, conf, g, dc, outdir, trace):
        P.fleet.save_state(outdir, mc.state)
        view = mc.dc_view()
        gen = mc._state_gen
        mc.refresh()
        trace += [mc._state_gen == gen, mc.dc_view() is view]
    assert _scenario(world, tmp_path, "steadyref", steps,
                     replication=1)[:2] == [True, True]


def test_plan_join_share_counts_live_owners(tmp_path):
    def run(P):
        dc = P.part.DistributionController("mod", 6, 6, 18)
        conf = types.SimpleNamespace(workers=[f"h{i}" for i in range(6)],
                                     outdir=str(tmp_path / P.name))
        mc = P.fleet.MembershipController(conf, dc, **P.dev)
        mc.state.owners = [0, 0, 0, 1, 1, 1]
        return mc.plan_join("hnew").to_dict()
    mig = equal(run)
    assert len(mig["moves"]) == 2
    assert all(to == 6 for _s, _f, to in mig["moves"])


# --------------------------------------------------- server epoch gate

def _gate_rows(server, cfgs, P):
    return [None if r is None else r.encode_wire()
            for r in (server._epoch_gate(P.wire.RuntimeConfig(**c))
                      for c in cfgs)]


def test_server_epoch_gate(world, tmp_path):
    """Older and equal epochs pass; a newer one with no newer state on
    disk is refused ``STALE_EPOCH``; once the commit lands the gate
    refreshes and serves, and older traffic is still served."""
    def run(P):
        conf, g, dc, outdir = _fresh(P, world, tmp_path, "gate")
        server = P.fifo_server(conf, 0, str(tmp_path / f"{P.name}.fifo"))
        g0 = P.counter("server_stale_epoch_total")
        out = [server.epoch, _gate_rows(server, [{}, {"epoch": 0},
                                                 {"epoch": 1}], P),
               P.counter("server_stale_epoch_total") - g0]
        P.fleet.save_state(outdir, P.fleet.MembershipState(
            epoch=1, workers=["localhost"] * N_WORKERS, owners=[0, 1, 2]))
        out += [_gate_rows(server, [{"epoch": 1}], P), server.epoch,
                _gate_rows(server, [{"epoch": 0}], P),
                server.statusz()["epoch"]]
        return out
    got = equal(run)
    assert got == [0, [None, None, "STALE_EPOCH"], 1, [None], 1, [None], 1]


def test_stale_epoch_reply_fault(world, tmp_path, monkeypatch):
    def run(P):
        conf, g, dc, outdir = _fresh(P, world, tmp_path, "gatefault")
        server = P.fifo_server(conf, 1, str(tmp_path / f"{P.name}.fifo"))
        P.faults.reset()
        monkeypatch.setenv("DOS_FAULTS", "stale-epoch-reply;wid=1;times=1")
        rows = _gate_rows(server, [{}, {}], P)
        monkeypatch.delenv("DOS_FAULTS")
        P.faults.reset()
        return rows
    assert equal(run) == ["STALE_EPOCH", None]


def _handle(P, server, tmp_path, queries, tag, epoch=0):
    qfile = str(tmp_path / f"query.{P.name}.{tag}")
    P.wire.write_query_file(qfile, queries)
    row = server._handle(P.wire.Request(
        P.wire.RuntimeConfig(epoch=epoch, results=True), qfile,
        str(tmp_path / "ans"), "-"))
    res = P.wire.read_results_file(P.wire.results_file_for(qfile))
    return row.ok, row.finished, [a.tolist() for a in res]


def test_server_serves_adopted_shard_after_commit(world, tmp_path):
    """A joiner outside the original roster owns nothing at epoch 0,
    then serves its adopted shard after the commit is visible."""
    qs = read_scen(world[1]["scen"])

    def run(P):
        conf, g, dc, outdir = _fresh(P, world, tmp_path, "adopt-serve")
        _join0(P, P.controller(conf, dc, g))
        server = P.fifo_server(conf, 3, str(tmp_path / f"{P.name}3.fifo"))
        shard0 = qs[dc.worker_of(qs[:, 1]) == 0][:6]
        return (server.engine is None or server.engine.shard == 0,
                _handle(P, server, tmp_path, shard0, "adopt", epoch=1))
    ok, (row_ok, fin, _res) = equal(run)
    assert ok and row_ok and fin == 6


def test_server_learns_window_on_hosted_miss(world, tmp_path):
    """A worker started BEFORE a migration window opens refreshes on the
    first dual-read batch instead of refusing it."""
    qs = read_scen(world[1]["scen"])

    def run(P):
        conf, g, dc, outdir = _fresh(P, world, tmp_path, "window-miss",
                                     replication=1)
        server = P.fifo_server(conf, 2, str(tmp_path / f"{P.name}w.fifo"))
        mc = P.controller(conf, dc, g)
        mig = P.fleet.Migration(epoch=1, kind="leave", worker=0,
                                moves=[[0, 0, 2]])
        mc.begin(mig)
        mc.catch_up(mig)
        shard0 = qs[dc.worker_of(qs[:, 1]) == 0][:4]
        return (_handle(P, server, tmp_path, shard0, "window"),
                server.statusz().get("migration"))
    (row_ok, fin, _res), mig = equal(run)
    assert row_ok and fin == 4 and mig["moves"] == [[0, 0, 2]]


# ------------------------------------------------ frontend dual-read

class _FailingVia:
    """Dispatcher wrapper that fails every batch sent via one worker."""

    def __init__(self, inner, dead_via):
        self.inner = inner
        self.dead = dead_via

    def answer_batch(self, wid, queries, rconf, diff, via=None):
        if (wid if via is None else via) == self.dead:
            raise RuntimeError("injected: via-worker down")
        return self.inner.answer_batch(wid, queries, rconf, diff, via=via)


def _window(P, conf, dc, g, shard=1):
    mc = P.controller(conf, dc, g)
    mig = P.fleet.Migration(epoch=1, kind="join", worker=3,
                            moves=[[shard, shard, 3]])
    mc.begin(mig, host="localhost")
    mc.catch_up(mig)
    return mc


def _sconf(P, depth=256):
    return P.serving.ServeConfig(max_batch=16, max_wait_ms=2.0,
                                 queue_depth=depth, cache_bytes=0,
                                 deadline_ms=60_000.0)


def test_frontend_dual_read_window(world, tmp_path):
    """During a window the frontend walks old owner -> adopter: with the
    old owner down every moving-shard request is answered by the adopter
    lane, zero sheds, the same answers and failovers in both."""
    qs = read_scen(world[1]["scen"])

    def run(P):
        conf, g, dc, outdir = _fresh(P, world, tmp_path, "dualread",
                                     replication=1)
        mc = _window(P, conf, dc, g)
        disp = P.dispatcher(conf, g, dc)
        fe = P.serving.ServingFrontend(
            mc.dc_view(), _FailingVia(disp, dead_via=1), sconf=_sconf(P),
            hconf=P.serving.HedgeConfig(enabled=False), membership=mc)
        fe.start()
        f0 = P.counter("failover_total")
        try:
            shard1 = qs[dc.worker_of(qs[:, 1]) == 1][:8]
            res = [fe.query(int(s), int(t), timeout=60) for s, t in shard1]
        finally:
            fe.stop()
        c, p, fin = P.dispatcher(conf, g, dc).answer_batch(
            1, shard1, P.wire.RuntimeConfig(), "-")
        return ([(r.status, r.cost, r.plen, r.finished) for r in res],
                P.counter("failover_total") - f0 >= 1,
                [(int(a), int(b), bool(x)) for a, b, x in zip(c, p, fin)])
    res, failed_over, ref = equal(run)
    assert all(r[0] == "OK" for r in res) and failed_over
    assert [r[1:] for r in res] == ref


def test_frontend_r1_admission_sees_adopter(world, tmp_path):
    """R=1 admission in a window: the old owner's breaker is OPEN but
    the adopter is live, so requests pass and are served; a steady shard
    with an open breaker still sheds ``circuit-open``."""
    qs = read_scen(world[1]["scen"])

    def run(P):
        conf, g, dc, outdir = _fresh(P, world, tmp_path, "r1admission",
                                     replication=1)
        mc = _window(P, conf, dc, g)
        registry = P.resilience.BreakerRegistry(threshold=1,
                                                cooldown_s=600.0,
                                                enabled=True)
        registry.record(1, ok=False)
        registry.record(0, ok=False)
        fe = P.serving.ServingFrontend(
            mc.dc_view(), P.dispatcher(conf, g, dc), sconf=_sconf(P),
            registry=registry, hconf=P.serving.HedgeConfig(enabled=False),
            membership=mc)
        fe.start()
        try:
            shard1 = qs[dc.worker_of(qs[:, 1]) == 1][:6]
            res = [fe.query(int(s), int(t), timeout=60) for s, t in shard1]
            s0, t0 = qs[dc.worker_of(qs[:, 1]) == 0][0]
            steady = fe.query(int(s0), int(t0), timeout=60)
        finally:
            fe.stop()
            registry.shutdown()
        return ([(r.status, r.cost) for r in res],
                (steady.status, steady.detail))
    res, steady = equal(run)
    assert all(r[0] == "OK" for r in res)
    assert steady == ("UNAVAILABLE", "circuit-open")


def test_frontend_statusz_reports_live_chains(world, tmp_path):
    def run(P):
        conf, g, dc, outdir = _fresh(P, world, tmp_path, "statusz-live",
                                     replication=1)
        mc = P.controller(conf, dc, g)
        mc.begin(P.fleet.Migration(epoch=1, kind="join", worker=3,
                                   moves=[[0, 0, 3]]), host="localhost")
        fe = P.serving.ServingFrontend(
            dc, P.dispatcher(conf, g, dc), sconf=_sconf(P, 64),
            hconf=P.serving.HedgeConfig(enabled=False), membership=mc)
        try:
            fe.start()
            st = fe.statusz()
            return ({int(w): s["replicas"] for w, s in st["shards"].items()},
                    st["epoch"], st.get("migration"))
        finally:
            fe.stop()
    chains, epoch, mig = equal(run)
    assert chains[0] == [0, 3] and chains[1] == [1]
    assert epoch == 0 and mig["moves"] == [[0, 0, 3]]


# --------------------------------------------------------- wire sweep

def test_clean_stale_epoch_files(tmp_path):
    """Epoch-suffixed wire files older than the sweep age go, young and
    plain ones stay, ``artifacts_swept_total`` counts them: equal."""
    old = ["query.localhost1.s0.e2", "answer.localhost1.s0.e2.a0",
           "query.localhost3.e1"]
    keep = ["query.localhost1.s0.e3", "query.localhost1",
            "answer.localhost1.a0"]

    def run(P):
        nfs = tmp_path / P.name
        nfs.mkdir()
        for name in old + keep:
            (nfs / name).write_text("x")
        past = time.time() - 120
        for name in old + keep[1:]:
            os.utime(nfs / name, (past, past))
        s0 = P.counter("artifacts_swept_total")
        n = P.fifo.clean_stale_epoch_files(str(nfs))
        return (n, P.counter("artifacts_swept_total") - s0,
                sorted(os.listdir(nfs)))
    n, swept, left = equal(run)
    assert n == swept == len(old) and left == sorted(keep)


# --------------------------------------------- campaign (non-slow)

def _round_view(v):
    mview, dc_r, hosts = v
    return (None if mview is None else mview.to_dict(), dc_r.epoch,
            [int(dc_r.owner_of(s)) for s in range(N_WORKERS)], hosts)


def test_round_membership_degrades_to_last_good_pair(world, tmp_path):
    def run(P):
        conf, g, dc, outdir = _fresh(P, world, tmp_path, "lastgood",
                                     replication=1)
        _join0(P, P.controller(conf, dc, g), host="joiner-host")
        last = P.pq._round_membership(conf, dc)
        out = [_round_view(last)]
        with open(P.fleet.state_path(outdir), "w") as fh:
            fh.write("{torn")
        out.append(P.pq._round_membership(conf, dc, last=last) == last)
        os.remove(P.fleet.state_path(outdir))
        out.append(P.pq._round_membership(conf, dc, last=last) == last)
        static = P.pq._round_membership(conf, dc)
        out += [static[0] is None, static[1] is dc, static[2]]
        return out
    got = equal(run)
    assert got[0][2][0] == 3 and got[0][3][3] == "joiner-host"
    assert got[1:5] == [True, True, True, True]


def test_round_membership_stale_epoch_and_bad_owners(world, tmp_path):
    def run(P):
        conf, g, dc, outdir = _fresh(P, world, tmp_path, "roundguards",
                                     replication=1)
        mc = P.controller(conf, dc, g)
        mig = P.fleet.Migration(epoch=1, kind="join", worker=3,
                                moves=[[0, 0, 3]], host="joiner-host")
        mc.begin(mig)
        mc.catch_up(mig)
        mc.commit(mig)
        last = P.pq._round_membership(conf, dc)
        out = [_round_view(last),
               P.pq._round_membership(conf, dc, last=last) == last]
        P.fleet.save_state(outdir, P.fleet.MembershipState(
            epoch=0, workers=["localhost"] * N_WORKERS,
            owners=list(range(N_WORKERS))))
        out.append(P.pq._round_membership(conf, dc, last=last) == last)
        P.fleet.save_state(outdir, P.fleet.MembershipState(
            epoch=2, workers=["localhost"] * N_WORKERS, owners=[0, 1]))
        out.append(P.pq._round_membership(conf, dc, last=last) == last)
        mview, dc_r, hosts = P.pq._round_membership(conf, dc)
        out.append((mview is None, dc_r is dc, hosts == list(conf.workers)))
        return out
    got = equal(run)
    assert got[0][2][0] == 3 and got[1:4] == [True, True, True]
    assert got[4] == (True, True, True)


def _thread_servers(P, conf, fifo_dir, monkeypatch, wids, heads):
    os.makedirs(fifo_dir, exist_ok=True)
    fifos = {wid: os.path.join(fifo_dir, f"worker{wid}.fifo")
             for wid in wids}
    for head in heads:
        monkeypatch.setattr(head, "command_fifo_path",
                            lambda wid: fifos[wid])
    servers = {wid: P.fifo_server(conf, wid, fifos[wid]) for wid in wids}
    threads = {wid: threading.Thread(target=s.serve_forever, daemon=True)
               for wid, s in servers.items()}
    for t in threads.values():
        t.start()
    for fifo in fifos.values():
        for _ in range(100):
            if os.path.exists(fifo):
                break
            time.sleep(0.02)
    return fifos, threads, servers


def _stop_all(P, fifos, threads):
    for fifo in fifos.values():
        P.server.stop_server(fifo, deadline_s=5.0)
    for t in threads.values():
        t.join(timeout=15)


def _answer_columns(outdir):
    with open(os.path.join(outdir, "parts.csv")) as fh:
        rows = list(csv.reader(fh))
    hdr = rows[0]
    keep = [hdr.index(k) for k in
            ("expe", "n_expanded", "n_touched", "plen", "finished",
             "size")]
    return [[r[i] for i in keep] for r in rows[1:]]


@pytest.mark.parametrize("head,servers", [
    ("torch", "torch"), ("torch", "jax"), ("jax", "torch"),
])
def test_campaign_routes_by_committed_epoch(world, tmp_path, monkeypatch,
                                            head, servers):
    """A host campaign under a committed epoch (shard 0 owned by the
    joined worker 3; every batch stamped epoch 1) exits 0 with the
    static fleet's rows — a port head over port servers, a port head
    over JAX servers and a JAX head over port servers alike."""
    monkeypatch.setenv("DOS_RETRY_MAX", "0")
    monkeypatch.setenv("DOS_SEND_TIMEOUT_S", "15")
    monkeypatch.delenv("DOS_FAULTS", raising=False)
    H, S = PKGS[head], PKGS[servers]
    heads = [P.pq for P in PKGS.values()]
    out = {}
    for name, elastic in (("static", False), ("elastic", True)):
        conf, g, dc, outdir = _fresh(S, world, tmp_path, name,
                                     diffs=["-", "-"])
        conf_path = str(tmp_path / f"conf-{name}.json")
        conf.save(conf_path)
        wids = range(N_WORKERS)
        if elastic:
            _join0(S, S.controller(conf, dc, g))
            wids = range(N_WORKERS + 1)
        fifos, threads, srv = _thread_servers(
            S, conf, str(tmp_path / f"f-{name}"), monkeypatch, wids, heads)
        out[name] = str(tmp_path / f"artifacts-{name}")
        try:
            rc = H.pq.main(["-c", conf_path, "--backend", "host",
                            "-o", out[name], "--device", "cpu"])
        finally:
            _stop_all(S, fifos, threads)
        assert rc == H.pq.EXIT_CLEAN
        assert not os.path.exists(os.path.join(out[name],
                                               "degraded.json"))
        if elastic:
            assert srv[0].engine is None or srv[0].engine.shard != 0
            assert all(s.epoch == 1 for s in srv.values())
    assert _answer_columns(out["static"]) == _answer_columns(
        out["elastic"])


# the JAX case of ``dos-obs top``'s table over mixed /statusz schemas
# (obs.fleet.render_top, ported in A14.5)
from torch_port_cases import load_cases  # noqa: E402

globals().update(load_cases("test_membership.py", __name__, drop={}, only=(
    "test_top_tolerates_mixed_statusz_schemas",)))
