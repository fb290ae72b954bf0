"""PyTorch port, the work counts and host-phase spans on the build's and
batched A*'s paths, on the CPU.

* ``relax_jacobi.active_pairs`` moves, through ``build_fm_sharded``, by
  the ``stats["active_pairs"]`` that ``jacobi_dist`` reports for the same
  targets, at most N x the column groups a step;
* ``astar_batch_np.sweeps`` moves by ``sum(info["sweeps"])`` at chunks of
  1, 3 and 1,024;
* under a CPU ``torch.profiler`` session the build's spans are user
  annotations nested as the program opens them, and each step's flag
  reset (``aten::zero_``) is the first operation of its
  ``build.step_launch``; the Chrome events carry each loop's steps;
* with every switch off a span is the shared no-op and the span totals
  stay; under the profiler they count every span;
* a tiny traced CPU cell of the benchmark reports the build's new
  counter and span metrics, and each new reader names no counter, and
  reads None, where the program lacks the count.

``build_fm_sharded`` on the CPU takes the plain split stage; where a
test needs K1's loop, the card's stage (``build_fm_jacobi``: the CSR,
``jacobi_dist``, ``first_moves``, whose wrappers run their plain twins
on CPU tensors) takes its place, and gives the same table."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from distributed_oracle_search_tpu_torch.data import (  # noqa: E402
    synth_road_network,
)
from distributed_oracle_search_tpu_torch.models.cpd import (  # noqa: E402
    pick_build_kernel,
)
from distributed_oracle_search_tpu_torch.obs import trace as obs_trace  # noqa: E402
from distributed_oracle_search_tpu_torch.ops import (  # noqa: E402
    DeviceGraph, astar_batch_np, cuda_astar as tca,
    cuda_build_kernels as cbk,
)
from distributed_oracle_search_tpu_torch.ops import batched_astar as tba  # noqa: E402
from distributed_oracle_search_tpu_torch.parallel import (  # noqa: E402
    DistributionController,
)
from distributed_oracle_search_tpu_torch.parallel import sharded  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "benchmark", "tests"))
from bench_support import make_root  # noqa: E402
from harness.main import read_counters  # noqa: E402
from harness.spec import Spec  # noqa: E402

WORKERS = 4
BUILD_SPANS = ("build.shard", "build.csr", "build.relax",
               "build.step_launch", "build.flag_read", "build.first_moves")
#: the benchmark's metrics that read the counts and spans
NEW_METRICS = ("relax_jacobi.active_pairs_per_step",
               "relax_jacobi.ns_per_active_pair", "build.step_host_us",
               "build.csr_ms_per_call", "astar_sweep.gathers_per_sweep",
               "astar_sweep.ps_per_gather")


def _card_stage(dg, st, t, max_iters=0, csr=None, out=None, dist_out=None):
    return cbk.build_fm_jacobi(
        dg, torch.as_tensor(t, dtype=torch.int32, device=dg.device),
        max_iters, csr=csr, out=out, dist_out=dist_out)


@pytest.fixture
def card_stage(monkeypatch):
    """``build_fm_sharded``'s ``ellsplit`` kind through the card's stage."""
    monkeypatch.setattr(sharded, "build_fm_columns_ellsplit", _card_stage)


@pytest.fixture(scope="module")
def road():
    g = synth_road_network(400, seed=5)
    dc = DistributionController("mod", WORKERS, WORKERS, g.n)
    return (g, DeviceGraph.from_graph(g, device="cpu"),
            sharded.pad_targets(dc), pick_build_kernel(g, "ellsplit"))


def _chunks(targets_wr: np.ndarray, chunk: int):
    """Each worker's target batches as ``build_fm_sharded`` makes them."""
    w, r = targets_wr.shape
    chunk = r if chunk <= 0 or chunk >= r else chunk
    padded = np.full((w, -(-r // chunk) * chunk), -1, np.int32)
    padded[:, :r] = targets_wr
    return [padded[wid, i:i + chunk] for wid in range(w)
            for i in range(0, r, chunk)]


@pytest.mark.parametrize("chunk", [0, 40])
def test_active_pairs_counted_on_the_build_path(road, card_stage,
                                                monkeypatch, chunk):
    g, dg, targets, kernel = road
    before = cbk.relax_jacobi.active_pairs
    fm = sharded.build_fm_sharded(dg, targets, chunk=chunk, kernel=kernel)
    moved = cbk.relax_jacobi.active_pairs - before
    csr = cbk.csr_from_ell(dg)
    pairs = bound = 0
    for t in _chunks(targets, chunk):
        stats = {}
        cbk.jacobi_dist(csr, torch.from_numpy(t), stats=stats)
        pairs += stats["active_pairs"]
        bound += stats["steps"] * stats["pairs_per_step"]
    assert moved == pairs > 0
    assert pairs <= bound
    monkeypatch.undo()                   # the CPU's own split stage
    assert torch.equal(fm, sharded.build_fm_sharded(
        dg, targets, chunk=chunk, kernel=kernel))


@pytest.mark.parametrize("chunk", [1, 3, 1024])
def test_engine_sweeps_counted(road, chunk):
    g = road[0]
    rng = np.random.default_rng(chunk)
    q = rng.integers(0, g.n, (7, 2))
    info = {}
    before = astar_batch_np.sweeps
    astar_batch_np(g, q, chunk=chunk, device="cpu", info=info)
    assert len(info["sweeps"]) == -(-len(q) // chunk)
    assert astar_batch_np.sweeps - before == sum(info["sweeps"]) > 0


def _annotations(prof) -> dict[str, list[tuple[int, int]]]:
    out = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.is_user_annotation():
            s = ev.start_ns()
            out.setdefault(ev.name(), []).append((s, s + ev.duration_ns()))
    return out


def _inside(span, outer) -> bool:
    return any(s <= span[0] and span[1] <= e for s, e in outer)


def test_build_spans_nest_in_the_profiler_trace(road, card_stage):
    g, dg, targets, kernel = road
    obs_trace.clear()
    steps = cbk.relax_jacobi.plain
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            sharded.build_fm_sharded(dg, targets, chunk=40, kernel=kernel)
        steps = cbk.relax_jacobi.plain - steps
        relaxes = [e for e in obs_trace.events() if e["name"] == "build.relax"]
    finally:
        obs_trace.clear()
    spans = _annotations(prof)
    assert set(BUILD_SPANS) <= set(spans)
    assert len(spans["build.shard"]) == 1
    chunks = len(_chunks(targets, 40))
    for name in ("build.csr", "build.relax", "build.first_moves"):
        assert len(spans[name]) == chunks, name
        assert all(_inside(s, spans["build.shard"]) for s in spans[name])
    for name in ("build.step_launch", "build.flag_read"):
        assert len(spans[name]) == steps > 0, name
        assert all(_inside(s, spans["build.relax"]) for s in spans[name])
    assert sum(e["args"]["steps"] for e in relaxes) == steps
    ops = sorted((ev.start_ns(), ev.name())
                 for ev in prof.profiler.kineto_results.events()
                 if ev.name().startswith("aten::"))
    starts = [s for s, _ in ops]
    for s, e in spans["build.step_launch"]:
        i = int(np.searchsorted(starts, s))
        assert i < len(ops) and ops[i][0] <= e and ops[i][1] == "aten::zero_"


def _totals():
    return {name: (getattr(obs_trace.span_seconds, name),
                   getattr(obs_trace.span_count, name))
            for name in BUILD_SPANS}


def test_spans_off_are_shared_and_count_nothing(road):
    g, dg, targets, _ = road
    assert not obs_trace.enabled()
    assert obs_trace.span("build.relax") is obs_trace._NULL_SPAN
    obs_trace._NULL_SPAN.set(steps=3)
    before = _totals()
    cbk.build_fm_jacobi(dg, torch.from_numpy(targets[0]))
    assert _totals() == before
    steps = cbk.relax_jacobi.plain
    with profile(activities=[ProfilerActivity.CPU]):
        assert obs_trace.span("x") is not obs_trace._NULL_SPAN
        cbk.build_fm_jacobi(dg, torch.from_numpy(targets[0]))
    obs_trace.clear()
    steps = cbk.relax_jacobi.plain - steps
    after = _totals()
    assert after["build.step_launch"][1] - before["build.step_launch"][1] \
        == steps > 0
    for name in ("build.csr", "build.relax", "build.first_moves"):
        assert after[name][1] - before[name][1] == 1
        assert after[name][0] > before[name][0]


#: one traced tiny CPU run of a cell in a fresh process (the harness
#: refuses a process that has loaded JAX, as this one has), the build's
#: distance stage the card's: its result and the program's sweep count
CELL_RUN = """
import json, sys
sys.path[:0] = [{tests!r}, {root!r}]
import torch
from distributed_oracle_search_tpu_torch.ops import (
    batched_astar, cuda_build_kernels as cbk)
from distributed_oracle_search_tpu_torch.parallel import sharded
from bench_support import run_cell


def stage(dg, st, t, max_iters=0, csr=None, out=None, dist_out=None):
    return cbk.build_fm_jacobi(
        dg, torch.as_tensor(t, dtype=torch.int32, device=dg.device),
        max_iters, csr=csr, out=out, dist_out=dist_out)


sharded.build_fm_columns_ellsplit = stage
torch.set_num_threads(2)
rc, res, err = run_cell({cell_root!r}, {cell!r}, seed=2 ** 31 + 5, trace=1)
print(json.dumps({{"rc": rc, "res": res, "err": err[-2000:],
                  "sweeps": batched_astar.astar_batch_np.sweeps}}))
"""


@pytest.mark.parametrize("cell", ["ny-w32.build", "ny-w32.astar"])
def test_a_traced_tiny_cell_reports_the_new_metrics(tmp_path, cell):
    """The build's counter and span metrics read non-null; the A* cell's
    K6 metrics read nothing on the CPU (the plain loop has no K6), where
    the program still counts the loop's sweeps."""
    code = CELL_RUN.format(tests=os.path.join(ROOT, "benchmark", "tests"),
                           root=ROOT, cell_root=make_root(tmp_path),
                           cell=cell)
    env = {**{k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
           "OMP_NUM_THREADS": "2"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["rc"] == 0 and out["res"]["correct"], out["err"]
    got = {k: v["value"] for k, v in out["res"]["metrics"].items()}
    if cell == "ny-w32.build":
        for name in ("relax_jacobi.active_pairs_per_step",
                     "build.step_host_us", "build.csr_ms_per_call"):
            assert got[name] > 0, name
        assert "relax_jacobi.ns_per_active_pair" not in got
    else:
        assert out["sweeps"] > 0
        assert got["astar.sweeps_per_batch"] > 0
        assert not {"astar_sweep.gathers_per_sweep",
                    "astar_sweep.ps_per_gather"} & set(got)


#: what each reader's counts are taken from, to remove for a program
#: from before them
COUNT_OWNERS = {
    "relax_jacobi": (cbk.relax_jacobi, "active_pairs"),
    "build": (obs_trace, "span_seconds"),
    "astar_sweep": (tca.astar_sweep, "gathers"),
}


@pytest.mark.parametrize("name", NEW_METRICS)
def test_readers_name_only_counts_the_program_has(road, monkeypatch, name):
    spec = Spec(ROOT)
    reader = spec.reader(name)
    assert reader.COUNTERS
    values = read_counters(reader.COUNTERS)
    assert set(values) == set(reader.COUNTERS)
    assert all(isinstance(v, (int, float)) for v in values.values())
    owner, attr = COUNT_OWNERS[name.split(".")[0]]
    monkeypatch.delattr(owner, attr)
    old = spec.reader(name)
    assert old.COUNTERS == {}
    run = {"counters": {}, "work": {"calls": 3, "rows": 9},
           "kernels": {"relax_jacobi_kernel": {"seconds": 1.0,
                                               "launches": 4},
                       "sweep_kernel": {"seconds": 1.0, "launches": 4}}}
    assert old.read(run) is None
