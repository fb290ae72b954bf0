"""PyTorch port, ``obs`` against the JAX package's: after the same
operations each package's registry gives the same ``snapshot()``,
``to_prometheus()`` text and ``dump_json`` bytes; sliding quantile
windows (reservoir past its cap, exemplars, rotation) are equal for one
seed; trace events, captures, sidecars and trace files have the same
structure; flight-recorder tapes (rotation, the ring bound, a torn tail)
are byte-equal and replay the same; the scrape server answers the same
``/metrics``, ``/healthz``, ``/statusz`` and 404. ``obs.device`` entries
of one engine batch carry the JAX entry's cost fields and the same
``device_program_*`` exposition names, with values the port computes in
closed form and a launch timed (``perf_counter`` on the CPU)."""

import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)

from distributed_oracle_search_tpu import obs as j_obs  # noqa: E402
from distributed_oracle_search_tpu.obs import device as j_device  # noqa: E402
from distributed_oracle_search_tpu.obs import http as j_http  # noqa: E402
from distributed_oracle_search_tpu.obs import metrics as j_metrics  # noqa: E402
from distributed_oracle_search_tpu.obs import quantiles as j_quant  # noqa: E402
from distributed_oracle_search_tpu.obs import recorder as j_rec  # noqa: E402
from distributed_oracle_search_tpu.obs import trace as j_trace  # noqa: E402
from distributed_oracle_search_tpu_torch import obs as t_obs  # noqa: E402
from distributed_oracle_search_tpu_torch.obs import device as t_device  # noqa: E402
from distributed_oracle_search_tpu_torch.obs import http as t_http  # noqa: E402
from distributed_oracle_search_tpu_torch.obs import metrics as t_metrics  # noqa: E402
from distributed_oracle_search_tpu_torch.obs import quantiles as t_quant  # noqa: E402
from distributed_oracle_search_tpu_torch.obs import recorder as t_rec  # noqa: E402
from distributed_oracle_search_tpu_torch.obs import trace as t_trace  # noqa: E402

PKG = {"jax": (j_metrics, j_quant, j_trace, j_rec, j_http),
       "torch": (t_metrics, t_quant, t_trace, t_rec, t_http)}


def _drive_registry(m):
    """One fixed sequence of operations on a fresh registry."""
    reg = m.MetricsRegistry()
    reg.counter("head_batches_total").inc()
    reg.counter("head_batches_total").inc(4)
    reg.counter("failover_total", "batches re-routed").inc(2)
    reg.gauge("head_circuits_open", "open breakers").set(3)
    reg.gauge("head_circuits_open").add(-1)
    reg.gauge("serve_queue_depth_w3").set(7)
    reg.gauge("serve_queue_depth_w11").set(2)
    # looks per-worker but collides with a counter family: stays flat
    reg.counter("mixed_w1").inc()
    reg.gauge("mixed").set(1.5)
    h = reg.histogram("worker_search_seconds", "search")
    for v in (0.00005, 0.0004, 0.003, 0.2, 0.7, 3.0, 200.0):
        h.observe(v)
    reg.histogram("custom_seconds", buckets=(0.5, 0.1, 2.0)).observe(0.3)
    with pytest.raises(TypeError):
        reg.gauge("head_batches_total")
    return reg


@pytest.mark.parametrize("what", ["snapshot", "prometheus", "dump",
                                  "reset"])
def test_registry_equals_jax(what, tmp_path):
    got = {}
    for name, (m, *_rest) in PKG.items():
        reg = _drive_registry(m)
        if what == "snapshot":
            got[name] = json.dumps(reg.snapshot(), sort_keys=True)
        elif what == "prometheus":
            got[name] = reg.to_prometheus()
        elif what == "dump":
            path = str(tmp_path / f"{name}.json")
            reg.dump_json(path)
            with open(path, "rb") as f:
                got[name] = f.read()
        else:
            reg.reset()
            got[name] = (reg.snapshot(), reg.to_prometheus())
    assert got["torch"] == got["jax"]
    if what == "prometheus":
        text = got["torch"]
        assert 'serve_queue_depth{worker="3"} 7' in text
        assert "mixed_w1 1" in text
        assert 'worker_search_seconds_bucket{le="+Inf"} 7' in text


def test_mirror_counts_sets_registry_counters():
    reg = t_metrics.MetricsRegistry()
    t_metrics.mirror_counts({"cuda_walk_batch.launches": 5,
                             "build_flush_seconds": 0.25}, reg)
    t_metrics.mirror_counts({"cuda_walk_batch.launches": 7}, reg)
    assert reg.snapshot()["counters"] == {"build_flush_seconds": 0.25,
                                          "cuda_walk_batch.launches": 7}


def _drive_windows(q):
    clock = [1000.0]
    win = q.QuantileWindows(window_s=60.0, buckets=6, max_samples=16,
                            clock=lambda: clock[0])
    rng = np.random.default_rng(7)
    for i in range(300):
        clock[0] += 0.5
        win.observe("worker_search_seconds", float(rng.random()),
                    trace_id=f"t{i}" if i % 3 else None)
        if i % 50 == 0:
            win.observe("serve_request_seconds", float(i))
    sq = q.SlidingQuantiles(10.0, 5, 8, clock=lambda: clock[0])
    for v in rng.random(100):
        sq.observe(float(v), trace_id="x")
    return (win.snapshot(), win.to_prometheus(), sq.snapshot(),
            sq.quantiles((0.1, 0.5, 0.9)))


def test_quantile_windows_equal_for_one_seed():
    got = {name: _drive_windows(q) for name, (_m, q, *_r) in PKG.items()}
    assert got["torch"] == got["jax"]
    snap = got["torch"][0]["worker_search_seconds"]
    assert snap["count"] > 16 and snap["worst"]["trace_id"]


def _structure(evs):
    return [(e["name"], e["ph"], sorted(e), sorted(e["args"]),
             e["args"].get("trace_id")) for e in evs]


def test_trace_events_and_sidecars_equal_in_structure(tmp_path):
    got = {}
    for name, (_m, _q, tr, *_r) in PKG.items():
        tr.clear()
        tr.enable(True)
        tr.set_trace_id("feedbeef00000000")
        try:
            with tr.span("head.partition"):
                with tr.span("head.send", wid=3, diff="-"):
                    pass
            tr.add_span("worker.search", 0.002, wid=3, queries=9)
            with tr.capture("cafe000000000000") as cap:
                with tr.span("worker.receive", wid=1):
                    pass
            side = tr.trace_sidecar_for(str(tmp_path / f"query.{name}"))
            tr.write_events(side, cap.events)
            tr.ingest(tr.read_events(side))
            path = str(tmp_path / f"{name}.trace.json")
            tr.write_trace(path, extra_events=[{"name": "x", "ph": "X",
                                                "ts": 1, "dur": 1,
                                                "pid": 1, "tid": 1,
                                                "args": {}}])
            with open(path) as f:
                doc = json.load(f)
            got[name] = (os.path.basename(side).split(".", 2)[-1],
                         _structure(tr.events()), sorted(doc),
                         _structure(doc["traceEvents"]))
            assert all(isinstance(e["ts"], int) and e["dur"] >= 0
                       for e in tr.events())
        finally:
            tr.enable(False)
            tr.set_trace_id(None)
            tr.clear()
    assert got["torch"] == got["jax"]
    assert got["torch"][1][-1][4] == "cafe000000000000"
    # disabled: one shared no-op, nothing recorded
    assert t_trace.span("x") is t_trace.span("y")


def _drive_recorder(rec_mod, d):
    clock = [5000.0]
    rec = rec_mod.FlightRecorder(d, max_bytes=900, segment_bytes=300,
                                 flush_every=3, clock=lambda: clock[0])
    rec_mod.set_recorder(rec)
    try:
        for i in range(14):
            rec_mod.emit("breaker_open", ts=clock[0] + i, key=f"('h', {i})",
                         why="3 consecutive failures")
            if i % 4 == 0:
                rec.record_tick({"ts": clock[0] + i + 0.5, "source": "w1",
                                 "counters": {"c": i}, "windows": {"x": 1}})
        rec.close()
    finally:
        rec_mod.set_recorder(None)
    rec_mod.drain_pending()
    segs = rec_mod.segment_paths(d)
    tape = []
    for p in segs:
        with open(p, "rb") as f:
            tape.append((os.path.basename(p), f.read()))
    with open(segs[-1], "ab") as f:
        f.write(b'{"ts": 1.0, "kind": "torn')            # a torn tail
    records = rec_mod.replay(d)
    return tape, records, rec_mod.render_timeline(records), rec.statusz()


def test_recorder_tapes_byte_equal(tmp_path):
    got = {}
    for name, (_m, _q, _t, rec_mod, _h) in PKG.items():
        d = str(tmp_path / name)
        tape, records, text, st = _drive_recorder(rec_mod, d)
        st.pop("dir")
        got[name] = (tape, records, text, st)
    assert got["torch"] == got["jax"]
    tape = got["torch"][0]
    assert len(tape) >= 2 and sum(len(b) for _, b in tape) <= 900 + 300


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=10) as r:
            return r.status, r.headers["Content-Type"], r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read().decode()


@pytest.mark.parametrize("path", ["/metrics", "/healthz", "/statusz",
                                  "/nope"])
def test_scrape_endpoints_equal_jax(path, monkeypatch):
    monkeypatch.delenv("DOS_OBS_PORT", raising=False)
    got = {}
    for name, (m, q, _t, _r, http) in PKG.items():
        assert http.resolve_obs_port(None) == (None, "off")
        assert http.resolve_obs_port(-1) == (None, "off")
        assert http.resolve_obs_port(0) == (0, "flag")
        reg = _drive_registry(m)
        win = q.QuantileWindows(window_s=60.0, buckets=6,
                                clock=lambda: 100.0)
        win.observe("worker_search_seconds", 0.25, trace_id="abc")
        (j_device if name == "jax" else t_device).reset()
        srv = http.ObsServer(
            0, health_fn=lambda: {"ok": False, "wid": 2},
            status_providers={"worker": lambda: {"shard": 2},
                              "broken": lambda: 1 / 0},
            registry=reg, windows=win).start()
        try:
            got[name] = _get(srv.port, path)
        finally:
            srv.close()
    assert got["torch"] == got["jax"]
    code = got["torch"][0]
    assert code == {"/metrics": 200, "/healthz": 503, "/statusz": 200,
                    "/nope": 404}[path]


def test_obs_package_lazy_and_unported_modules():
    """The port's ``obs`` exports what the JAX package's does, the
    modules A14.5 ported included, lazily where JAX's are lazy."""
    assert t_obs.recorder is t_rec
    assert sorted(t_obs.__all__) == sorted(j_obs.__all__)
    for mod in ("fleet", "slo", "telemetry", "timeseries"):
        assert getattr(t_obs, mod).__name__ == f"{t_obs.__name__}.{mod}"
        assert getattr(j_obs, mod) is not None
    with pytest.raises(AttributeError):
        t_obs.no_such_module  # noqa: B018


def test_device_entries_keys_and_names(tmp_path, monkeypatch):
    """One engine batch per package on one index: each package records a
    ``table-search…`` entry for the program it ran, both entries carry
    ``flops``, ``bytes_accessed`` and ``hbm_bytes``, and the exposition's
    metric families are the same three."""
    from distributed_oracle_search_tpu.data.graph import Graph as JGraph
    from distributed_oracle_search_tpu.parallel.partition import (
        DistributionController as JDC,
    )
    from distributed_oracle_search_tpu.transport.wire import (
        RuntimeConfig as JRuntimeConfig,
    )
    from distributed_oracle_search_tpu.worker.engine import (
        ShardEngine as JShardEngine,
    )
    from distributed_oracle_search_tpu_torch.data import (
        Graph, synth_city_graph, synth_scenario, write_xy,
    )
    from distributed_oracle_search_tpu_torch.models.cpd import (
        build_worker_shard, write_index_manifest,
    )
    from distributed_oracle_search_tpu_torch.ops import cuda_walk
    from distributed_oracle_search_tpu_torch.parallel import (
        DistributionController,
    )
    from distributed_oracle_search_tpu_torch.transport.wire import (
        RuntimeConfig,
    )
    from distributed_oracle_search_tpu_torch.worker.engine import (
        ShardEngine,
    )

    monkeypatch.setenv("DOS_WALK_KERNEL", "xla")
    g0 = synth_city_graph(7, 6, seed=2)
    xy = str(tmp_path / "g.xy")
    write_xy(xy, g0.xs, g0.ys, g0.src, g0.dst, g0.w)
    g = Graph.from_xy(xy)
    dc = DistributionController("mod", 2, 2, g.n)
    outdir = str(tmp_path / "index")
    for wid in range(2):
        build_worker_shard(g, dc, wid, outdir, chunk=16, device="cpu")
    write_index_manifest(outdir, dc)
    q = synth_scenario(g.n, 60, seed=3)
    mine = q[dc.worker_of(q[:, 1]) == 0]
    j_device.reset()
    t_device.reset()
    JShardEngine(JGraph.from_xy(xy), JDC("mod", 2, 2, g.n), 0,
                 outdir).answer(mine, JRuntimeConfig(k_moves=4), "-")
    launches0 = cuda_walk.cuda_walk_batch.plain
    eng = ShardEngine(g, dc, 0, outdir, device="cpu")
    eng.answer(mine, RuntimeConfig(k_moves=4), "-")
    # the batch's walk, and the capture's timed one (counted like any)
    assert cuda_walk.cuda_walk_batch.plain - launches0 == 2
    eng.answer(mine, RuntimeConfig(k_moves=4), "-")       # same key
    assert cuda_walk.cuda_walk_batch.plain - launches0 == 3
    js, ts = j_device.snapshot(), t_device.snapshot()
    assert len(js) == len(ts) == 1
    (jk, je), (tk, te) = next(iter(js.items())), next(iter(ts.items()))
    assert jk.startswith("table-search") and tk.startswith("table-search")
    assert jk.split("/", 1)[1] == tk.split("/", 1)[1]     # /q<n>/k<k>
    assert tk == f"table-search[plain]/{tk.split('/', 1)[1]}"
    assert {"flops", "bytes_accessed"} <= set(je)
    assert {"flops", "bytes_accessed", "hbm_bytes", "kernel_ms"} <= set(te)
    assert te["timer"] == "perf_counter" and te["kernel_ms"] > 0
    qn = int(tk.split("/q")[1].split("/")[0])
    want = cuda_walk.walk_launch_cost(qn, g.n, g.max_out_degree,
                                      int(eng.fm.nbytes), k_moves=4)
    assert {k: te[k] for k in want} == want
    names = [{ln.split()[2] for ln in mod.to_prometheus().splitlines()
              if ln.startswith("# TYPE")} for mod in (j_device, t_device)]
    assert names[1] <= names[0] and {
        "device_program_flops", "device_program_bytes_accessed",
        "device_program_hbm_bytes"} == names[1]
    assert t_metrics.REGISTRY.snapshot()["gauges"][
        "device_programs_analyzed"] == 1
    j_device.reset()
    t_device.reset()


def test_mesh_metrics_move_only_on_mesh(tmp_path):
    """``mesh_devices`` reads 1 on a one-device engine and L on a lane
    engine; ``mesh_walk_batches_total`` moves only for a lane engine's
    batches (the JAX package's ``test_mesh_metrics_move_only_on_mesh``)."""
    from distributed_oracle_search_tpu_torch.data import (
        Graph, synth_city_graph, synth_scenario, write_xy,
    )
    from distributed_oracle_search_tpu_torch.models.cpd import (
        build_worker_shard, write_index_manifest,
    )
    from distributed_oracle_search_tpu_torch.parallel import (
        DistributionController,
    )
    from distributed_oracle_search_tpu_torch.transport.wire import (
        RuntimeConfig,
    )
    from distributed_oracle_search_tpu_torch.worker.engine import (
        ShardEngine,
    )

    g0 = synth_city_graph(6, 5, seed=4)
    xy = str(tmp_path / "g.xy")
    write_xy(xy, g0.xs, g0.ys, g0.src, g0.dst, g0.w)
    g = Graph.from_xy(xy)
    dc = DistributionController("mod", 2, 2, g.n)
    outdir = str(tmp_path / "index")
    for wid in range(2):
        build_worker_shard(g, dc, wid, outdir, chunk=16, device="cpu")
    write_index_manifest(outdir, dc)
    q = synth_scenario(g.n, 40, seed=5)
    mine = q[dc.worker_of(q[:, 1]) == 0]

    def counts():
        snap = t_metrics.REGISTRY.snapshot()
        return (snap["counters"]["mesh_walk_batches_total"],
                snap["gauges"]["mesh_devices"])

    one = ShardEngine(g, dc, 0, outdir, device="cpu", mesh=None)
    before, gauge = counts()
    one.answer(mine, RuntimeConfig())
    assert gauge == 1 and counts() == (before, 1)
    lanes = ShardEngine(g, dc, 0, outdir, device="cpu",
                        mesh=[torch.device("cpu")] * 4)
    lanes.answer(mine, RuntimeConfig())
    assert counts() == (before + 1, 4)


def test_metrics_registered_in_obs_catalog():
    """Every metric the port's modules declare at import is named in the
    ``obs`` package's catalog (the JAX package's metric-registry
    contract); counts mirrored from elsewhere keep their own names. The
    imports run in a fresh interpreter: what other tests of this process
    set on the registry is not what the modules declare."""
    import subprocess
    import sys

    modules = (
        "cli.process_query", "models.resident", "obs.http", "obs.recorder",
        "worker.server",
        # the planes (A14.5)
        "cli.gateway", "control", "gateway", "integrity.audit",
        "integrity.scrub", "obs.slo", "obs.telemetry", "obs.timeseries",
        # the tools (A15)
        "worker.supervisor", "cli.control", "cli.obs", "cli.lint")
    code = "\n".join(
        [f"import distributed_oracle_search_tpu_torch.{m}" for m in modules]
        + ["import json",
           "from distributed_oracle_search_tpu_torch.models import cpd",
           "from distributed_oracle_search_tpu_torch.obs import metrics",
           "snap = metrics.REGISTRY.snapshot()",
           "print(json.dumps(sorted({n for kind in snap.values() for n in "
           "kind if '.' not in n and n not in cpd.COUNTERS})))"])
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    names = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "supervisor_respawns_total" in names
    missing = sorted(n for n in names if n not in t_obs.__doc__)
    assert missing == []
