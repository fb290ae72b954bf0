"""PyTorch port, the online serving layer (``serving/``) and answer
fingerprints (``integrity.fingerprint``), held against the JAX package
on the CPU.

Each case runs the same steps through both packages and compares what
they observe: serve knobs, cache keys, hits, evictions and counters,
queue batching, the frontend's answers, sheds, timeouts and breaker
trips, the line protocol's output, fingerprints and their verify points
(results files, the in-process guard, the cache). The mirror of
``tests/test_serving.py`` without its ``slow`` Poisson drill, plus the
fingerprint cases of ``tests/test_integrity.py``. Over the wire, a port
dispatcher drives JAX servers and a JAX dispatcher drives port servers,
on the FIFO and the RPC lanes, with ``answer_fp`` on and the
``corrupt-answer`` fault armed at the server.
"""

import io
import os
import threading
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
from distributed_oracle_search_tpu.parallel.partition import (  # noqa: E402
    DistributionController as JDC,
)
from distributed_oracle_search_tpu.worker.build import (  # noqa: E402
    main as j_build_main,
)
from torch_parity import PKGS, equal, outcome  # noqa: E402

WAIT_S = 30


@pytest.fixture(scope="module")
def serve_world(tmp_path_factory):
    """A 2-shard world with a CPD index built by the JAX package; each
    package reads it through its own conf and graph."""
    datadir = str(tmp_path_factory.mktemp("t-serve-data"))
    paths = ensure_synth_dataset(datadir, width=10, height=8,
                                 n_queries=96, seed=21)
    outdir = os.path.join(datadir, "index")
    for wid in range(2):
        j_build_main(["--input", paths["xy"], "--partmethod", "mod",
                      "--partkey", "2", "--workerid", str(wid),
                      "--maxworker", "2", "--outdir", outdir])
    conf = {}
    for name, P in PKGS.items():
        conf[name] = P.config.ClusterConfig(
            workers=["localhost", "localhost"], partmethod="mod",
            partkey=2, outdir=outdir, xy_file=paths["xy"],
            scenfile=paths["scen"], diffs=["-", paths["diff"]],
            nfs=datadir).validate()
    g = {name: P.graph.Graph.from_xy(paths["xy"])
         for name, P in PKGS.items()}
    n = g["jax"].n
    write_index_manifest(outdir, JDC("mod", 2, 2, n))
    dc = {name: P.part.DistributionController("mod", 2, 2, n)
          for name, P in PKGS.items()}
    return conf, g, dc, read_scen(paths["scen"])


def _hist(P, name):
    return P.metrics.REGISTRY.snapshot()["histograms"][name]


def _mk_req(P, s, t, wid=0, deadline=None):
    return P.serving.ServeRequest(s=s, t=t, wid=wid, key=(s, t, "-", ()),
                                  t_submit=time.monotonic(),
                                  deadline=deadline)


# ----------------------------------------------------------- unit: knobs

def test_serve_config_env_and_overrides(monkeypatch):
    monkeypatch.setenv("DOS_SERVE_MAX_BATCH", "128")
    monkeypatch.setenv("DOS_SERVE_MAX_WAIT_MS", "2.5")
    monkeypatch.setenv("DOS_SERVE_QUEUE_DEPTH", "nonsense")  # degrades
    got = equal(lambda P: P.serving.ServeConfig.from_env(
        cache_bytes=0).__dict__)
    assert got["max_batch"] == 128 and got["max_wait_ms"] == 2.5
    assert got["cache_bytes"] == 0


@pytest.mark.parametrize("bad", [
    dict(max_batch=0), dict(max_batch=48), dict(queue_depth=0),
    dict(deadline_ms=0), dict(cache_bytes=-1),
])
def test_serve_config_rejects_malformed(bad):
    got = equal(lambda P: outcome(
        lambda: P.serving.ServeConfig(**bad).validate())[:2])
    assert got == ("raise", "ValueError")


# ----------------------------------------------------------- unit: cache

CACHE_COUNTERS = ("serve_cache_hits_total", "serve_cache_misses_total",
                  "serve_cache_evictions_total")


def _deltas(P, names, before):
    return [P.counter(k) - before[k] for k in names]


def test_result_cache_lru_eviction_and_counters():
    def run(P):
        cache = P.serving.ResultCache(3 * P.cache.ENTRY_BYTES)
        before = {k: P.counter(k) for k in CACHE_COUNTERS}
        for i in range(4):
            cache.put((i, i, "-", ()), (i, 1, True))
        out = [len(cache), cache.get((0, 0, "-", ())),
               cache.get((3, 3, "-", ())),
               cache.get((1, 1, "-", ())) is not None]
        cache.put((9, 9, "-", ()), (9, 1, True))
        out += [cache.get((2, 2, "-", ())), list(cache._od),
                _deltas(P, CACHE_COUNTERS, before)]
        return out
    got = equal(run)
    assert got[:4] == [3, None, (3, 1, True), True] and got[4] is None
    assert got[-1] == [2, 2, 2]


def test_result_cache_invalidate_by_diff_and_disabled():
    def run(P):
        cache = P.serving.ResultCache(1 << 20)
        cache.put((1, 2, "-", ()), (3, 1, True))
        cache.put((1, 2, "d1", ()), (5, 1, True))
        out = [cache.invalidate("d1"), cache.get((1, 2, "-", ())),
               cache.invalidate(), len(cache)]
        off = P.serving.ResultCache(0)
        off.put((1, 2, "-", ()), (3, 1, True))
        return out + [off.get((1, 2, "-", ())), off.enabled]
    assert equal(run) == [1, (3, 1, True), 1, 0, None, False]


def test_knob_fingerprint_covers_answer_knobs():
    cfgs = [{}, {"hscale": 2.0}, {"k_moves": 3}, {"time": 10},
            {"verbose": 3, "threads": 7}, {"sig_k": 8},
            {"answer_fp": True}, {"epoch": 3, "diff_epoch": 2}]

    def run(P):
        return [P.serving.knob_fingerprint(P.wire.RuntimeConfig(**c))
                for c in cfgs]
    fps = equal(run)
    assert len(set(fps[:4])) == 4 and fps[4] == fps[0]


# ----------------------------------------------------------- unit: queue

def test_shard_queue_bounded_and_never_blocks():
    def run(P):
        q = P.serving.ShardQueue(2)
        out = [q.try_put(_mk_req(P, 1, 2)), q.try_put(_mk_req(P, 3, 4))]
        t0 = time.monotonic()
        out.append(q.try_put(_mk_req(P, 5, 6)))
        out.append(time.monotonic() - t0 < 0.1)
        q.close()
        out += [q.try_put(_mk_req(P, 7, 8)), len(q.drain())]
        return out
    assert equal(run) == [True, True, False, True, False, 2]


def test_shard_queue_batch_flush_on_size_and_wait():
    def run(P):
        q = P.serving.ShardQueue(64)
        stop = threading.Event()
        for i in range(5):
            q.try_put(_mk_req(P, i, i))
        t0 = time.monotonic()
        first = q.get_batch(4, max_wait_s=5.0, stop=stop)
        fast = time.monotonic() - t0 < 1.0
        second = q.get_batch(4, max_wait_s=0.05, stop=stop)
        stop.set()
        return ([r.s for r in first], fast, [r.s for r in second],
                q.get_batch(4, 0.01, stop))
    assert equal(run) == ([0, 1, 2, 3], True, [4], [])


# ------------------------------------------------- frontend: smoke gate

def test_online_answers_match_campaign_path(serve_world):
    """~100 queries (zipf repeats) through each package's frontend over
    its in-process engines: the same answers, equal to the campaign
    path's engine answers; the repeats hit the cache and the
    micro-batcher coalesces, in both."""
    conf, g, dc, queries = serve_world
    base = queries[:64]
    rng = np.random.default_rng(5)
    reps = base[rng.zipf(1.5, size=40).clip(1, len(base)) - 1]
    workload = np.concatenate([base, reps])

    def run(P):
        n = P.name
        rconf = P.wire.RuntimeConfig()
        disp = P.dispatcher(conf[n], g[n], dc[n])
        fe = P.serving.ServingFrontend(
            dc[n], disp, sconf=P.serving.ServeConfig(
                max_batch=32, max_wait_ms=50.0, queue_depth=256),
            rconf=rconf)
        fe.start()
        hits0 = P.counter("serve_cache_hits_total")
        fill0 = _hist(P, "serve_batch_fill")
        try:
            res = [f.result(WAIT_S) for f in
                   [fe.submit(s, t) for s, t in base]]
            res2 = [f.result(WAIT_S) for f in
                    [fe.submit(s, t) for s, t in reps]]
        finally:
            fe.stop()
        cost = np.zeros(len(workload), np.int64)
        for wid, part in dc[n].group_queries(workload).items():
            mask = dc[n].worker_of(workload[:, 1]) == wid
            cost[mask] = disp._engine_for(wid).answer(part, rconf)[0]
        fill1 = _hist(P, "serve_batch_fill")
        nb = fill1["count"] - fill0["count"]
        return ([(r.status, r.cost, r.plen, r.finished)
                 for r in res + res2], cost.tolist(),
                P.counter("serve_cache_hits_total") - hits0 > 0,
                any(r.cached for r in res2),
                nb > 0 and (fill1["sum"] - fill0["sum"]) / nb > 1.0)
    answers, golden, hit, cached, coalesced = equal(run)
    assert all(a[0] == "OK" for a in answers)
    assert [a[1] for a in answers] == golden
    assert hit and cached and coalesced


def _slow(release):
    def fn(wid, q, rconf, diff):
        release.wait(10)
        n = len(q)
        return (np.zeros(n, np.int64), np.zeros(n, np.int64),
                np.ones(n, bool))
    return fn


def test_overload_sheds_busy_immediately():
    """A full shard queue answers BUSY at once in both packages; the
    admitted requests still terminate once the shard is released."""
    def run(P):
        dc = P.part.DistributionController("mod", 1, 1, 64)
        release = threading.Event()
        fe = P.serving.ServingFrontend(
            dc, P.serving.CallableDispatcher(_slow(release)),
            sconf=P.serving.ServeConfig(queue_depth=4, max_batch=2,
                                        max_wait_ms=1.0, cache_bytes=0))
        fe.start()
        busy0 = P.counter("serve_shed_busy_total")
        try:
            futs = [fe.submit(i, i + 1) for i in range(12)]
            t0 = time.monotonic()
            shed = [f for f in futs if f.done()
                    and f.result(0).status == P.serving.BUSY]
            quick = time.monotonic() - t0 < 1.0
            booked = P.counter("serve_shed_busy_total") - busy0
        finally:
            release.set()
            fe.stop()
        return (len(shed) >= 4, quick, booked == len(shed),
                all(f.done() for f in futs))
    assert equal(run) == (True, True, True, True)


def test_open_breaker_sheds_unavailable():
    def run(P):
        dc = P.part.DistributionController("mod", 1, 1, 64)

        def never(wid, q, rconf, diff):  # pragma: no cover - shed first
            raise AssertionError("dispatch must not run")

        registry = P.resilience.BreakerRegistry(threshold=1,
                                                cooldown_s=60.0,
                                                enabled=True)
        registry.record(0, ok=False)
        fe = P.serving.ServingFrontend(
            dc, P.serving.CallableDispatcher(never),
            sconf=P.serving.ServeConfig(cache_bytes=0), registry=registry)
        fe.start()
        try:
            res = fe.query(1, 2, timeout=5)
            return res.status, res.detail
        finally:
            fe.stop()
            registry.shutdown()
    assert equal(run) == ("UNAVAILABLE", "circuit-open")


def test_dispatch_failure_records_breaker_and_errors():
    def run(P):
        dc = P.part.DistributionController("mod", 1, 1, 64)

        def broken(wid, q, rconf, diff):
            raise RuntimeError("shard down")

        registry = P.resilience.BreakerRegistry(threshold=2,
                                                cooldown_s=60.0,
                                                enabled=True)
        fe = P.serving.ServingFrontend(
            dc, P.serving.CallableDispatcher(broken),
            sconf=P.serving.ServeConfig(max_wait_ms=1.0, cache_bytes=0),
            registry=registry)
        fe.start()
        try:
            return [(r.status, "shard down" in r.detail) for r in (
                fe.query(1, 2, timeout=10), fe.query(3, 4, timeout=10),
                fe.query(5, 6, timeout=10))]
        finally:
            fe.stop()
            registry.shutdown()
    got = equal(run)
    assert got[0] == ("ERROR", True) and got[2][0] == "UNAVAILABLE"


def test_deadline_expires_queued_requests():
    def run(P):
        dc = P.part.DistributionController("mod", 1, 1, 64)
        release = threading.Event()
        dispatched = []

        def gated(wid, q, rconf, diff):
            dispatched.append(np.array(q))
            release.wait(10)
            n = len(q)
            return (np.zeros(n, np.int64), np.zeros(n, np.int64),
                    np.ones(n, bool))

        fe = P.serving.ServingFrontend(
            dc, P.serving.CallableDispatcher(gated),
            sconf=P.serving.ServeConfig(max_batch=2, max_wait_ms=1.0,
                                        deadline_ms=200.0, cache_bytes=0))
        fe.start()
        try:
            f1 = fe.submit(1, 2)
            for _ in range(100):
                if dispatched:
                    break
                time.sleep(0.01)
            f2 = fe.submit(3, 4)
            time.sleep(0.4)
            release.set()
            return f1.result(10).status, f2.result(10).status
        finally:
            release.set()
            fe.stop()
    assert equal(run) == ("OK", "TIMEOUT")


def test_diff_change_invalidates_cache(serve_world):
    conf, g, dc, queries = serve_world
    s, t = map(int, queries[0])

    def run(P):
        n = P.name
        fe = P.serving.ServingFrontend(
            dc[n], P.dispatcher(conf[n], g[n], dc[n]),
            sconf=P.serving.ServeConfig(max_wait_ms=1.0), diff="-")
        fe.start()
        try:
            free = fe.query(s, t, timeout=WAIT_S)
            again = fe.query(s, t, timeout=WAIT_S)
            fe.set_diff(conf[n].diffs[1])
            pert = fe.query(s, t, timeout=WAIT_S)
        finally:
            fe.stop()
        return [(r.status, r.cost, r.plen, r.finished, r.cached)
                for r in (free, again, pert)]
    free, again, pert = equal(run)
    assert free[0] == "OK" and again[-1] and not pert[-1]
    assert pert[1] >= free[1]


def test_line_protocol_stream(serve_world):
    conf, g, dc, queries = serve_world
    s0, t0 = map(int, queries[0])
    s1, t1 = map(int, queries[1])
    text = (f"{s0} {t0}\n# a comment\n\n{s1} {t1}\nnot a query\n"
            f"{s0} {t0}\nquit\n{s1} {t1}\n")

    def run(P):
        n = P.name
        fe = P.serving.ServingFrontend(
            dc[n], P.dispatcher(conf[n], g[n], dc[n]),
            sconf=P.serving.ServeConfig(max_wait_ms=5.0))
        fe.start()
        try:
            wfile = io.StringIO()
            count = P.ingress.serve_stream(fe, io.StringIO(text), wfile)
        finally:
            fe.stop()
        lines = wfile.getvalue().strip().splitlines()
        return count, [ln.split()[:6] for ln in lines]
    count, lines = equal(run)
    assert count == 3 and len(lines) == 4
    assert lines[0][:3] == ["OK", str(s0), str(t0)]
    assert lines[2][:4] == ["ERROR", "-1", "-1", "malformed-line"]
    assert lines[3] == lines[0]


# ---------------------------------------------------------- fingerprints

def test_answer_fingerprint_dtype_stable():
    def run(P):
        fp = P.fingerprint.answer_fingerprint
        return (fp([3, 0, 7], [2, 0, 4], [True, False, True]),
                fp(np.array([3, 0, 7], np.int32),
                   np.array([2, 0, 4], np.int64),
                   np.array([1, 0, 1], np.uint8)),
                fp([3, 0, 7], [2, 0, 4], [True, False, False]),
                P.fingerprint.value_fingerprint((3, 2, True)),
                fp([3], [2], [True]))
    a, b, c, v, w = equal(run)
    assert a == b and a != c and v == w


def test_results_file_fingerprint_round_trip(tmp_path):
    """A fingerprinted sidecar reads back; a tampered row fails typed in
    both packages and books ``answer_fp_mismatch_total``."""
    def run(P):
        path = str(tmp_path / f"{P.name}.results")
        cost, plen = np.array([5, 9], np.int64), np.array([2, 3], np.int64)
        fin = np.array([True, True])
        P.wire.write_results_file(
            path, cost, plen, fin,
            fp=P.fingerprint.answer_fingerprint(cost, plen, fin))
        back = [a.tolist() for a in P.wire.read_results_file(path)]
        with open(path) as f:
            raw = f.read()
        lines = raw.splitlines()
        lines[1] = "6 2 1"
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
        m0 = P.counter("answer_fp_mismatch_total")
        err = outcome(lambda: P.wire.read_results_file(path))[:2]
        return raw, back, err, P.counter("answer_fp_mismatch_total") - m0
    raw, back, err, booked = equal(run)
    assert back[0] == [5, 9] and err == ("raise", "FingerprintError")
    assert booked == 1 and " fp=" in raw.splitlines()[0]


def test_results_file_without_fp_stays_legacy(tmp_path):
    def run(P):
        path = str(tmp_path / f"{P.name}.results")
        P.wire.write_results_file(path, [5], [2], [True])
        with open(path) as f:
            raw = f.read()
        with open(path, "w") as f:
            f.write(raw.replace("5 2 1", "6 2 1"))
        return raw, P.wire.read_results_file(path)[0].tolist()
    raw, cost = equal(run)
    assert "fp=" not in raw and cost == [6]


def test_fp_guard_catches_injected_corruption(monkeypatch):
    monkeypatch.setenv("DOS_FAULTS", "corrupt-answer;times=1")

    def run(P):
        P.faults.reset()
        cost = np.arange(4, dtype=np.int64)
        plen, fin = np.ones(4, np.int64), np.ones(4, bool)
        rc = P.wire.RuntimeConfig(answer_fp=True)
        m0 = P.counter("answer_fp_mismatch_total")
        err = outcome(lambda: P.dispatch._fp_guard(0, cost, plen, fin,
                                                   rc))
        booked = P.counter("answer_fp_mismatch_total") - m0
        retry = P.dispatch._fp_guard(0, cost, plen, fin, rc)[0].tolist()
        P.faults.reset()
        return err[:2], "fingerprint" in err[2], booked, retry
    err, named, booked, retry = equal(run)
    assert err == ("raise", "DispatchError") and named and booked == 1
    assert retry == [0, 1, 2, 3]


def test_fp_guard_off_is_identity_and_consumes_nothing(monkeypatch):
    monkeypatch.setenv("DOS_FAULTS", "corrupt-answer;times=1")

    def run(P):
        P.faults.reset()
        cost = np.arange(3, dtype=np.int64)
        plen, fin = np.ones(3, np.int64), np.ones(3, bool)
        out = P.dispatch._fp_guard(0, cost, plen, fin,
                                   P.wire.RuntimeConfig())
        same = out[0] is cost and out[1] is plen and out[2] is fin
        armed = P.faults.inject("corrupt-answer", 0) is not None
        P.faults.reset()
        return same, armed
    assert equal(run) == (True, True)


def test_cache_fingerprint_drops_rotted_entry():
    def run(P):
        cache = P.serving.ResultCache(1 << 20, fingerprint=True)
        key = (3, 9, "-", (), 0, 0)
        cache.put(key, (7, 2, True))
        out = [cache.get(key)]
        m0 = P.counter("cache_fingerprint_mismatch_total")
        with cache._lock:
            cache._od[key] = (8, 2, True)
        out += [cache.get(key),
                P.counter("cache_fingerprint_mismatch_total") - m0,
                cache.fp_mismatches, len(cache)]
        cache.put(key, (7, 2, True))
        return out + [cache.get(key)]
    assert equal(run) == [(7, 2, True), None, 1, 1, 0, (7, 2, True)]


def test_cache_without_fingerprint_stays_legacy():
    def run(P):
        cache = P.serving.ResultCache(1 << 20)
        key = (3, 9, "-", (), 0, 0)
        cache.put(key, (7, 2, True))
        with cache._lock:
            cache._od[key] = (8, 2, True)
        return cache.get(key), cache.fp_mismatches
    assert equal(run) == ((8, 2, True), 0)


def test_integrity_config_defaults_and_env(monkeypatch):
    for k in ("DOS_SCRUB_INTERVAL_S", "DOS_SCRUB_BLOCKS_PER_PASS",
              "DOS_AUDIT_RATE", "DOS_AUDIT_MAX_REFERENCE",
              "DOS_ANSWER_FP"):
        monkeypatch.delenv(k, raising=False)

    def run(P):
        IC = P.integrity.IntegrityConfig
        out = [IC.from_env() == IC(), IC.from_env().any_enabled]
        monkeypatch.setenv("DOS_SCRUB_INTERVAL_S", "30")
        monkeypatch.setenv("DOS_AUDIT_RATE", "10")
        monkeypatch.setenv("DOS_ANSWER_FP", "1")
        cfg = IC.from_env()
        out += [cfg.scrub_interval_s, cfg.audit_rate, cfg.answer_fp]
        monkeypatch.setenv("DOS_AUDIT_RATE", "2000")
        out.append(IC.from_env() == IC())
        out.append(outcome(lambda: IC(audit_rate=-1).validate())[:2])
        for k in ("DOS_SCRUB_INTERVAL_S", "DOS_AUDIT_RATE",
                  "DOS_ANSWER_FP"):
            monkeypatch.delenv(k)
        return out
    assert equal(run) == [True, False, 30.0, 10, True, True,
                          ("raise", "ValueError")]


def test_fault_points_include_corruption_pair():
    def run(P):
        rules = P.faults.parse_faults(
            "corrupt-resident;wid=0;times=1,corrupt-answer;times=2")
        return ("corrupt-answer" in P.faults.POINTS,
                "stale-epoch-reply" in P.faults.POINTS,
                "kill-during-reshard" in P.faults.POINTS,
                [r.point for r in rules],
                outcome(lambda: P.faults.parse_faults(
                    "corrupt-everything"))[:2])
    got = equal(run)
    assert got[:3] == (True, True, True)
    assert got[4] == ("raise", "ValueError")


def test_unported_integrity_and_gateway_modules_name_a14_5():
    """A14.5 ported the scrubber, the audit and the gateway's modules:
    each imports, and the packages export the JAX package's names."""
    import distributed_oracle_search_tpu.gateway as j_gateway
    import distributed_oracle_search_tpu.integrity as j_integrity
    import distributed_oracle_search_tpu_torch.gateway as t_gateway
    import distributed_oracle_search_tpu_torch.integrity as t_integrity
    from distributed_oracle_search_tpu_torch.integrity import (  # noqa
        audit, scrub,
    )

    assert callable(scrub.scrub_engine_table)
    assert callable(audit.AnswerAuditor)
    for name in ("client", "protocol", "registry", "server"):
        assert getattr(t_gateway, name).__name__ == \
            f"{t_gateway.__name__}.{name}"
    assert sorted(t_gateway.__all__) == sorted(j_gateway.__all__)
    assert set(j_integrity.__all__) <= set(t_integrity.__all__)



@pytest.mark.parametrize("env", [
    {}, {"DOS_GATEWAY_L2_BYTES": "4096", "DOS_GATEWAY_L2_ADMIT":
         "second-hit"}, {"DOS_GATEWAY_L2_ADMIT": "bogus"},
])
def test_gateway_config_equal(monkeypatch, env):
    """``GatewayConfig.from_env`` (the worker L2's size and admission)
    reads the same knobs, defaults and degrades in both packages."""
    import dataclasses
    import importlib

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got = {n: dataclasses.asdict(importlib.import_module(
        f"{pkg}.gateway.config").GatewayConfig.from_env())
        for n, pkg in (("jax", "distributed_oracle_search_tpu"),
                       ("torch", "distributed_oracle_search_tpu_torch"))}
    assert got["torch"] == got["jax"]


# ------------------------------------------------------- wire: both ways

def _thread_server(P, conf, wid, fifo, rpc_sock=None):
    server = P.fifo_server(conf, wid, fifo)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    for _ in range(200):
        if os.path.exists(fifo):
            break
        time.sleep(0.02)
    else:
        pytest.fail("server fifo never appeared")
    loop = (P.server.RpcServeLoop(server, socket_path=rpc_sock).start()
            if rpc_sock else None)
    return server, th, loop


@pytest.mark.parametrize("lane", ["fifo", "rpc"])
@pytest.mark.parametrize("disp_pkg,server_pkg", [
    ("torch", "jax"), ("jax", "torch"), ("torch", "torch"),
])
def test_dispatcher_over_the_wire_with_fingerprints(
        serve_world, tmp_path, monkeypatch, lane, disp_pkg, server_pkg):
    """A dispatcher of one package drives a resident server of the
    other: with ``answer_fp`` the server fingerprints the answers (the
    results header, the RPC reply header), the dispatcher verifies them
    and the answers equal the in-process engines'; under
    ``corrupt-answer`` at the server the dispatcher refuses the batch
    (``DispatchError``) and books ``answer_fp_mismatch_total``."""
    conf, g, dc, queries = serve_world
    D, S = PKGS[disp_pkg], PKGS[server_pkg]
    mine = queries[dc["jax"].worker_of(queries[:, 1]) == 1][:8]
    fifo = str(tmp_path / "serve-worker1.fifo")
    sock = str(tmp_path / "dos-rpc-worker1.sock")
    monkeypatch.setenv("DOS_RPC_SOCKET_DIR", str(tmp_path))
    monkeypatch.setattr(D.dispatch, "command_fifo_path", lambda wid: fifo)
    server, th, loop = _thread_server(S, conf[server_pkg], 1, fifo,
                                      rpc_sock=sock if lane == "rpc"
                                      else None)
    cls = (D.serving.RpcDispatcher if lane == "rpc"
           else D.serving.FifoDispatcher)
    fd = cls(conf[disp_pkg], timeout=60.0)
    rc = D.wire.RuntimeConfig(answer_fp=True)
    try:
        cost, plen, fin = fd.answer_batch(1, mine, rc, "-")
        monkeypatch.setenv("DOS_FAULTS", "corrupt-answer;wid=1;times=1")
        S.faults.reset()
        m0 = D.counter("answer_fp_mismatch_total")
        err = outcome(lambda: fd.answer_batch(1, mine, rc, "-"))
        booked = D.counter("answer_fp_mismatch_total") - m0
        monkeypatch.delenv("DOS_FAULTS")
        S.faults.reset()
        again = fd.answer_batch(1, mine, rc, "-")
    finally:
        close = getattr(fd, "close", None)
        if close is not None:
            close()
        if loop is not None:
            loop.stop()
        S.server.stop_server(fifo)
        th.join(timeout=10)
        D.rpc.close_clients()
    ref = PKGS["torch"].dispatcher(conf["torch"], g["torch"],
                                   dc["torch"]).answer_batch(
        1, mine, PKGS["torch"].wire.RuntimeConfig(), "-")
    for a, b, c in zip((cost, plen, fin), again, ref):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, c)
    assert err[:2] == ("raise", "DispatchError") and booked == 1


def test_fifo_dispatcher_stale_diff_from_either_server(serve_world,
                                                       tmp_path,
                                                       monkeypatch):
    """A batch stamped with a diff epoch the server's segment stream
    (``--traffic-dir``) does not show is refused ``STALE_DIFF`` by the
    servers of both packages, and both packages' dispatchers fail it
    over as a dispatch error; after the segment lands it is served."""
    from distributed_oracle_search_tpu_torch.traffic import write_segment

    conf, g, dc, queries = serve_world
    mine = queries[dc["jax"].worker_of(queries[:, 1]) == 0][:6]
    gj = g["jax"]
    got = {}
    for spkg, S in PKGS.items():
        traffic = str(tmp_path / f"traffic-{spkg}")
        os.makedirs(traffic)
        fifo = str(tmp_path / f"{spkg}-w0.fifo")
        server = S.fifo_server(conf[spkg], 0, fifo, traffic_dir=traffic)
        th = threading.Thread(target=server.serve_forever, daemon=True)
        th.start()
        while not os.path.exists(fifo):
            time.sleep(0.02)
        try:
            for dpkg, D in PKGS.items():
                monkeypatch.setattr(D.dispatch, "command_fifo_path",
                                    lambda wid: fifo)
                fd = D.serving.FifoDispatcher(conf[dpkg], timeout=30.0)
                rc = D.wire.RuntimeConfig(diff_epoch=server.traffic.epoch
                                          + 1)
                err = outcome(lambda: fd.answer_batch(0, mine, rc, "-"))
                got[(spkg, dpkg)] = (err[:2], "STALE_DIFF" in err[2]
                                     or "stale" in err[2].lower())
                fd.close()
            write_segment(traffic, 1, gj.src[:2], gj.dst[:2], gj.w[:2] + 3)
            fd = PKGS["torch"].serving.FifoDispatcher(conf["torch"],
                                                      timeout=30.0)
            monkeypatch.setattr(PKGS["torch"].dispatch,
                                "command_fifo_path", lambda wid: fifo)
            served = fd.answer_batch(
                0, mine, PKGS["torch"].wire.RuntimeConfig(diff_epoch=1),
                "-")
            fd.close()
            got[(spkg, "served")] = [a.tolist() for a in served]
        finally:
            S.server.stop_server(fifo)
            th.join(timeout=10)
    assert got[("jax", "served")] == got[("torch", "served")]
    for key, val in got.items():
        if key[1] != "served":
            assert val[0][0] == "raise", key
    assert {v for k, v in got.items() if k[1] != "served"} == {
        got[("jax", "jax")]}
