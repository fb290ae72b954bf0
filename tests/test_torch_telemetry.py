"""PyTorch port, the telemetry, timeseries, SLO and fleet modules
(``obs/{telemetry,timeseries,slo,fleet}.py``) against the JAX package's.

The JAX package's ``tests/test_telemetry.py`` and ``test_obs_plane.py``
cases run over the port (``torch_port_cases``), on CPU engines: the
``dos-obs`` CLI's and the supervisor's among them. Left out: XLA's cost
capture (the port's ``obs.device`` is its own) and a read of the JAX
package's benchmark records."""

import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)
from torch_port_cases import load_cases  # noqa: E402

#: the drill waits for tick 3's seq, but the RPC read loop that ingested
#: it books the tick's events on the tape just after the seq (outside
#: the ingest lock): the port's case also waits for the event itself
#: before it replays the tape, else it races that thread
_DRILL_WAIT = (
    """        assert ingest.statusz()["sources"]["w0"]["seq"] >= tick3["seq"]
""", """        assert ingest.statusz()["sources"]["w0"]["seq"] >= tick3["seq"]
        deadline = time.time() + 5.0
        while time.time() < deadline and not any(
                r.get("kind") == "breaker_open"
                for r in (rec.flush() or obs_recorder.replay(tape))):
            time.sleep(0.02)
""")

globals().update(load_cases("test_telemetry.py", __name__, drop={},
                            replace=dict([_DRILL_WAIT])))
globals().update(load_cases("test_obs_plane.py", __name__, drop={
    "test_device_cost_capture_on_host_backend":
        "captures an XLA program's cost analysis; the port's obs.device "
        "entries are held in tests/test_torch_obs.py",
    "test_engine_captures_cost_per_program_key":
        "holds XLA's program keys; the port's obs.device keys are its "
        "own (ROADMAP.md A14.1) and tests/test_torch_obs.py holds them",
    "test_bench_diff_reads_the_repo_records":
        "reads the JAX package's BENCH_r*.json records",
}))


# ------------------------------------------- across the two packages

import json  # noqa: E402

import numpy as np  # noqa: E402

from torch_parity import PKGS, both  # noqa: E402


def _publisher(P, seed):
    """A publisher over a private registry and windows, driven by one
    seeded sequence; returns its ticks."""
    rng = np.random.default_rng(seed)
    clock = [1000.0]
    P.recorder.drain_pending()       # events of earlier cases stay out
    reg = P.metrics.MetricsRegistry()
    win = P.obs_quantiles.QuantileWindows(window_s=60.0, buckets=6,
                                          max_samples=32,
                                          clock=lambda: clock[0])
    pub = P.telemetry.TelemetryPublisher(
        source="w3", registry=reg, windows=win, full_every=3,
        clock=lambda: clock[0])
    pub.incarnation = "inc-1"
    ticks = []
    for i in range(7):
        clock[0] += 1.0
        reg.counter("serve_requests_total").inc(int(rng.integers(1, 50)))
        reg.counter("serve_shed_busy_total").inc(int(rng.integers(0, 3)))
        reg.gauge("serve_queue_depth_w3").set(float(rng.integers(0, 9)))
        for v in rng.random(5):
            win.observe("serve_request_seconds", float(v) / 10)
        if i == 4:
            reg.counter("audit_divergence_total").inc()
        ticks.append(pub.tick_once())
    return ticks


def test_ticks_equal_jax_and_encode_byte_equal():
    ticks = both(lambda P: _publisher(P, 5))
    assert ticks["torch"] == ticks["jax"]
    enc = both(lambda P: [P.telemetry.encode_tick(t)
                          for t in _publisher(P, 5)])
    assert enc["torch"] == enc["jax"]


def _ingest_all(P, ticks, now):
    store = P.timeseries.TimeseriesStore()
    ing = P.telemetry.TelemetryIngest(store, clock=lambda: now)
    accepted = [ing.ingest(t) for t in ticks]
    return store, ing, accepted


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_sidecars_and_ticks_read_across_packages(writer, reader,
                                                 tmp_path):
    """A ``.telemetry`` sidecar one package writes, the other reads
    tick for tick, and the other's ingest stores the same series as the
    writer's own ingest (replays dropped alike)."""
    W, R = PKGS[writer], PKGS[reader]
    ticks = _publisher(W, 9)
    path = str(tmp_path / "worker3.fifo.telemetry")
    sink = W.telemetry.sidecar_sink(path)
    for t in ticks:
        sink(t)
    got = R.telemetry.read_sidecar(path)
    assert got == W.telemetry.read_sidecar(path)
    assert [t["seq"] for t in got] == [t["seq"] for t in ticks][-len(got):]
    views = {}
    for name, P in (("w", W), ("r", R)):
        store, ing, accepted = _ingest_all(
            P, [P.telemetry.encode_tick(t) for t in got] + got[:2],
            now=1010.0)
        views[name] = (accepted, store.workers(),
                       store.query("serve_requests_total"),
                       store.latest("serve_queue_depth"),
                       store.rate("serve_requests_total", 30.0,
                                  now=1010.0),
                       store.fleet_window("serve_request_seconds",
                                          now=1010.0),
                       {k: v for k, v in ing.statusz().items()})
    assert views["r"] == views["w"]


def _slo_run(P, seed):
    """SLO burns over one seeded series: a latency and a ratio
    objective, evaluated every 10 s of a 10 minute run."""
    rng = np.random.default_rng(seed)
    now = [5000.0]
    store = P.timeseries.TimeseriesStore(bucket_s=5.0)
    specs = P.slo.parse_specs([
        {"name": "serve_latency", "kind": "latency",
         "window": "serve_request_seconds", "threshold_s": 0.05,
         "objective": 0.99},
        {"name": "serve_avail", "kind": "availability",
         "total": "serve_requests_total",
         "bad": ["serve_shed_busy_total"], "objective": 0.999}])
    eng = P.slo.SLOEngine(store, specs=specs, fast_s=60.0, slow_s=300.0,
                          fast_threshold=10.0, slow_threshold=4.0,
                          clock=lambda: now[0])
    out = []
    for step in range(60):
        now[0] += 10.0
        bad_phase = 20 <= step < 35
        for w in ("w0", "w1"):
            store.append(w, "serve_requests_total", now[0],
                         float(rng.integers(80, 120)), kind="delta")
            store.append(w, "serve_shed_busy_total", now[0],
                         float(rng.integers(2, 9) if bad_phase else 0),
                         kind="delta")
            lat = rng.random(40) * (0.2 if bad_phase else 0.03)
            store.put_window(w, "serve_request_seconds", now[0], {
                "count": 40, "quantiles": {
                    "p50": float(np.quantile(lat, 0.5)),
                    "p95": float(np.quantile(lat, 0.95)),
                    "p99": float(np.quantile(lat, 0.99))}})
        out.append(json.dumps(eng.evaluate(now[0]), sort_keys=True))
    return out, eng.alerting()


def test_slo_burn_rates_equal_jax():
    got = both(lambda P: _slo_run(P, 13))
    assert got["torch"] == got["jax"]
    runs = [json.loads(x) for x in got["torch"][0]]
    assert any(r["serve_avail"]["alerting"] for r in runs)
    assert any(r["serve_latency"]["alerting"] for r in runs)


def _statuses(P, seed):
    """/statusz documents of a small fleet: a dos-serve head with the
    planes and two workers, one missing most sections."""
    rng = np.random.default_rng(seed)
    return {
        "head:9100": {
            "serving": {"queues": {"0": int(rng.integers(0, 9))},
                        "breakers": {"0": "closed", "1": "open"},
                        "hedges": {"issued": 4, "won": 1}},
            "telemetry": {"sources": 2, "ticks": 40},
            "slo": {"alerting": ["serve_latency"],
                    "burn": {"serve_latency": {"fast": 21.37,
                                               "slow": 2.0}}},
            "control": {"brownout_level": 1, "quarantined": [5],
                        "actions": 3},
            "integrity": {"audit": {"audited": 12, "divergent": {"5": 2}},
                          "scrub": {"passes": 3, "corrupt_blocks": 1}},
        },
        "w0:9101": {"worker": {"wid": 0, "alg": "table-search",
                               "batches": int(rng.integers(1, 99)),
                               "telemetry": {"seq": 7}}},
        "w1:9102": {"error": "unreachable"},
    }


def test_fleet_merges_and_summaries_equal_jax():
    def run(P):
        snaps = []
        rng = np.random.default_rng(3)
        for w in range(3):
            reg = P.metrics.MetricsRegistry()
            reg.counter("worker_batches_total").inc(int(rng.integers(1, 9)))
            reg.gauge(f"serve_queue_depth_w{w}").set(float(w))
            h = reg.histogram("worker_search_seconds")
            for v in rng.random(6):
                h.observe(float(v))
            snaps.append((f"w{w}", reg.snapshot()))
        merged = P.obsfleet.merge_snapshots(snaps)
        st = _statuses(P, 4)
        return (json.dumps(merged, sort_keys=True),
                json.dumps({k: P.obsfleet._summarize(v)
                            for k, v in st.items()}, sort_keys=True,
                           default=str),
                P.obsfleet.render_top(st),
                P.obsfleet._KEY_DIRECTIONS, P.obsfleet._KEY_TOLERANCES)
    got = both(run)
    assert got["torch"] == got["jax"]


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_recorder_tape_of_ticks_read_across_packages(writer, reader,
                                                     tmp_path):
    """The flight-recorder tape an ingest writes (its ticks and the
    events they carry) is the same for both packages' recorders on a
    fixed clock, and the other package replays it record for record."""
    W, R = PKGS[writer], PKGS[reader]
    ticks = _publisher(W, 11)
    tapes = {}
    for name, P in (("w", W), ("r", R)):
        d = str(tmp_path / name)
        rec = P.recorder.FlightRecorder(d, flush_every=1,
                                        clock=lambda: 1234.5)
        try:
            ing = P.telemetry.TelemetryIngest(
                P.timeseries.TimeseriesStore(), recorder=rec,
                clock=lambda: 1234.5)
            for t in ticks:
                assert ing.ingest(t)
        finally:
            rec.close()
        tapes[name] = d
    got = R.recorder.replay(tapes["w"])
    assert got == W.recorder.replay(tapes["w"])
    assert got == R.recorder.replay(tapes["r"])
    assert {r.get("rec") for r in got} >= {"tick"}


def _snapshots(tmp_path, seed: int) -> list[str]:
    """Seeded per-worker snapshots in the port server's dump shape
    (registry sections, mirrored kernel counts, ``device``)."""
    rng = np.random.default_rng(seed)
    paths = []
    for wid in range(4):
        snap = {
            "counters": {"worker_batches_total": int(rng.integers(1, 50)),
                         "cuda_walk_batch.launches":
                             int(rng.integers(1, 60)),
                         "cuda_walk_batch.plain": 0,
                         f"server_frames_received_total_w{wid}":
                             int(rng.integers(0, 9))},
            "gauges": {"supervisor_workers_alive": 8,
                       f"serve_queue_depth_w{wid}":
                           int(rng.integers(0, 5))},
            "histograms": {"worker_search_seconds": {
                "count": 3, "sum": float(rng.random()),
                "buckets": {"0.01": 1, "0.1": 3, "+Inf": 3}}},
            "device": {"type": "cuda", "name": "card"}, "wid": wid}
        d = tmp_path / f"w{wid}"
        d.mkdir(exist_ok=True)
        p = str(d / "dump.json")
        with open(p, "w") as f:
            json.dump(snap, f)
        paths.append(p)
    return paths


@pytest.mark.parametrize("seed", [0, 1])
def test_dos_obs_merge_documents_equal_jax(tmp_path, seed):
    """``dos-obs merge-metrics`` of the same snapshots and
    ``merge-traces`` of the same sidecars write the same documents,
    byte for byte, from both packages' CLIs."""
    snaps = _snapshots(tmp_path, seed)
    traces = tmp_path / "traces"
    traces.mkdir()
    for wid in range(3):
        with open(traces / f"w{wid}.trace", "w") as f:
            json.dump([{"name": "worker.batch", "ph": "X",
                        "ts": 100 * (3 - wid) + seed, "dur": 5,
                        "pid": wid, "tid": 1}], f)

    def run(P):
        out_m = str(tmp_path / f"{P.name}-fleet.json")
        out_t = str(tmp_path / f"{P.name}-trace.json")
        assert P.obscli.main(["merge-metrics", *snaps, "-o", out_m]) == 0
        assert P.obscli.main(["merge-traces", str(traces), "-o",
                              out_t]) == 0
        with open(out_m, "rb") as f, open(out_t, "rb") as g:
            return f.read(), g.read()

    got = both(run)
    assert got["torch"] == got["jax"]
    doc = json.loads(got["torch"][0])
    want = sum(json.load(open(p))["counters"]["cuda_walk_batch.launches"]
               for p in snaps)
    assert doc["n_workers"] == 4
    assert doc["fleet"]["counters"]["cuda_walk_batch.launches"] == want
    assert len(json.loads(got["torch"][1])["traceEvents"]) == 3
