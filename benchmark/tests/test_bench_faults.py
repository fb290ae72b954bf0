"""``correct`` at tiny sizes on the CPU: true for sound runs of every
cell, false for the int16 control, and false for each fault a cell can
have, planted in the program underneath a whole run:

* a step that returns its state unchanged (the build's relax step;
  A*'s sweep);
* half of the batch left out (half the build's targets; half of an A*
  batch's queries);
* an answer altered where it is produced (a first move in every row; the
  cost of each batch's longest query).

No cell spans chips, so there is no exchange between chips to leave
out."""

import numpy as np
import pytest
import torch

from bench_support import CELLS, make_root, run_cell

import distributed_oracle_search_tpu_torch.ops.batched_astar as ba
import distributed_oracle_search_tpu_torch.ops.ell_split as ell_split
import distributed_oracle_search_tpu_torch.parallel.sharded as sharded
import distributed_oracle_search_tpu_torch.worker.engine as engine

#: a graph whose distances pass int16's range from every target
CONTROL_GRAPHS = {"road_network_sized": {"n": 2000, "arcs": 5552}}


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_sound_runs_are_correct(tiny_root, cell, trace):
    rc, res, err = run_cell(tiny_root, cell, seed=2 ** 31 + 11, trace=trace)
    assert rc == 0, err
    assert res["correct"] and res["failed"] == 0
    assert list(res)[-1] == "checks"
    limits = err.strip().splitlines()[-len(res["checks"]):]
    for line, (name, c) in zip(limits, res["checks"].items()):
        assert line == f"{name} {c['value']} limit {c['limit']}"
    if trace:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert "setup_s" in res["metrics"] and len(res["metrics"]) == 2


@pytest.mark.parametrize("cell", CELLS)
def test_the_int16_control_is_not_correct(tmp_path, cell):
    root = make_root(tmp_path, graphs=CONTROL_GRAPHS, workers=64)
    rc, res, err = run_cell(root, cell, seed=5, control="int16")
    assert rc == 0, err
    assert not res["correct"]
    assert all(c["value"] > 0 for c in res["checks"].values())


def _state_unchanged(monkeypatch, kind):
    if kind == "build":
        monkeypatch.setattr(ell_split, "_split_step",
                            lambda d, *a: d.clone())
    else:
        def frozen(in_nbr, w_in, h, t, valid, g, hops, changed, fscale):
            return g, hops, torch.zeros_like(changed), torch.zeros(
                5, dtype=torch.int64)
        monkeypatch.setattr(ba, "sweep_plain", frozen)


def _half_left_out(monkeypatch, kind):
    if kind == "build":
        inner = sharded.chunk_compute

        def half(dg, kernel=None, max_iters=0):
            fn = inner(dg, kernel, max_iters)

            def build(t, out=None, dist_out=None):
                t = t.clone()
                t[len(t) // 2:] = -1
                return fn(t, out=out, dist_out=dist_out)
            return build
        monkeypatch.setattr(sharded, "chunk_compute", half)
    else:
        inner = engine.astar_batch_np

        def half(graph, queries, *a, **kw):
            k = len(queries) // 2
            cost, plen, fin, counters = inner(graph, queries[:k], *a, **kw)
            pad = len(queries) - k
            return (np.concatenate([cost, np.zeros(pad, np.int64)]),
                    np.concatenate([plen, np.zeros(pad, np.int64)]),
                    np.concatenate([fin, np.zeros(pad, bool)]), counters)
        monkeypatch.setattr(engine, "astar_batch_np", half)


def _answer_altered(monkeypatch, kind):
    if kind == "build":
        inner = sharded.chunk_compute

        def altered(dg, kernel=None, max_iters=0):
            fn = inner(dg, kernel, max_iters)

            def build(t, out=None, dist_out=None):
                rows = fn(t, out=out, dist_out=dist_out)
                rows[:, 1] += 1
                return rows
            return build
        monkeypatch.setattr(sharded, "chunk_compute", altered)
    else:
        inner = engine.astar_batch_np

        def altered(*a, **kw):
            cost, plen, fin, counters = inner(*a, **kw)
            cost[np.argmax(plen)] += 1
            return cost, plen, fin, counters
        monkeypatch.setattr(engine, "astar_batch_np", altered)


FAULTS = {"state_unchanged": _state_unchanged,
          "half_left_out": _half_left_out,
          "answer_altered": _answer_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_planted_fault_is_not_correct(tiny_root, monkeypatch, cell,
                                        fault):
    FAULTS[fault](monkeypatch, cell.split(".")[1])
    rc, res, err = run_cell(tiny_root, cell, seed=17)
    assert rc == 0, err
    assert not res["correct"]
