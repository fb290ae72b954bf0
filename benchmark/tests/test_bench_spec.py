"""``BENCHMARK.json`` against the contract's shape rules, and the harness
finding every file by name (a new configuration, traffic mix, driver,
cell, end-to-end and per-layer metric taken with no edit to an existing
file)."""

import json
import os
import re

import pytest

from bench_support import BENCH, ROOT, run_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


@pytest.fixture(scope="module")
def doc():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


#: a driver a later cell could bring: the program's graph made again and
#: again, its end-to-end number its own
NEW_DRIVER = """
from harness.driver import Driver as Base


class Driver(Base):
    def setup(self, trace):
        self.work.update(graphs=0)

    def call(self):
        self.g = self.graph()
        self.work["calls"] += 1
        self.work["graphs"] += 1

    def end_to_end(self, window_s):
        return {"graphs_per_s": self.work["graphs"] / window_s}

    def attempted(self):
        return self.work["graphs"], 0

    def outputs(self, rng):
        return {"m": self.g.m}


def check(driver, out, control=False):
    bad = abs(out["m"] - len(driver.arrays[2]))
    return {"arcs_differing": {"value": bad, "limit": 0}}, "1 graph"
"""

#: a reader of the program's counters under a key of its own
NEW_READER = """
COUNTERS = {"relax.plain": ("ops.cuda_build_kernels", "relax_jacobi",
                            "plain")}


def read(run):
    return run["work"]["graphs"] + run["counters"]["relax.plain"]
"""


def test_shape_and_names(doc):
    assert set(doc) == TOP_KEYS
    assert doc["command"] == ["python3", "benchmark/run.py"]
    assert doc["paths"] == ["benchmark"]
    assert 1 <= doc["run_seconds"] <= 51
    names = []
    for c in doc["configs"]:
        assert set(c) == CONFIG_KEYS
        assert line(c["source"]) and line(c["why"])
        assert c["file"].startswith("benchmark/")
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for c in doc["workloads"]:
        assert set(c) == CELL_KEYS
        assert c["chips"] == 1 and line(c["why"])
        assert c["config"] in names and NAME.match(c["traffic"])
        names.append(c["name"])
    for m in doc["end_to_end"]:
        assert set(m) - {"workloads"} == E2E_KEYS
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        names.append(m["name"])
    for m in doc["per_layer"]:
        assert set(m) - {"workloads"} == LAYER_KEYS
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert line(m["layer"])
        names.append(m["name"])
    for m in doc["end_to_end"] + doc["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))
    assert "setup_s" in [m["name"] for m in doc["end_to_end"]]
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 << 10


def test_every_file_is_found_by_name(doc):
    cells = {c["name"] for c in doc["workloads"]}
    e2e = {m["name"]: m for m in doc["end_to_end"]}
    for c in doc["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
    for c in doc["workloads"]:
        with open(os.path.join(BENCH, "traffic", f"{c['traffic']}.json")) as f:
            driver = json.load(f)["driver"]
        assert os.path.isfile(os.path.join(BENCH, "drivers",
                                           f"{driver}.py"))
        reported = [m for m in e2e.values()
                    if c["name"] in m.get("workloads", [c["name"]])]
        assert "setup_s" in [m["name"] for m in reported]
        assert len(reported) >= 2
    for m in doc["per_layer"]:
        assert os.path.isfile(os.path.join(BENCH, "metrics",
                                           f"{m['name']}.py"))
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in cells
            assert cell in e2e[m["moves"]].get("workloads", [cell])
    for cell in cells:
        assert any(cell in m["workloads"] for m in doc["per_layer"])


def test_an_added_cell_and_metric_need_no_edit(tiny_root):
    """A new configuration, traffic mix, cell and per-layer metric are new
    files and new entries; the harness runs the cell and reports the
    metric."""
    bench = os.path.join(tiny_root, "benchmark")
    with open(os.path.join(bench, "configs", "ny-w32.json")) as f:
        cfg = json.load(f)
    cfg["graph"].update(n=1500, arcs=4164)
    with open(os.path.join(bench, "configs", "extra-w8.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(bench, "traffic", "build_rows.json")) as f:
        mix = json.load(f)
    mix["method"] = "ell"
    with open(os.path.join(bench, "traffic", "build_ell.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(bench, "metrics", "build.calls_seen.py"),
              "w") as f:
        f.write(NEW_READER.replace("graphs", "calls"))
    with open(os.path.join(bench, "drivers", "graph_loads.py"), "w") as f:
        f.write(NEW_DRIVER)
    with open(os.path.join(bench, "traffic", "graph_loads.json"), "w") as f:
        json.dump({"driver": "graph_loads", "why": "test"}, f)
    with open(os.path.join(bench, "metrics", "load.graphs_seen.py"),
              "w") as f:
        f.write(NEW_READER)
    path = os.path.join(tiny_root, "BENCHMARK.json")
    with open(path) as f:
        doc = json.load(f)
    doc["configs"].append({"name": "extra-w8", "source": "test",
                           "file": "benchmark/configs/extra-w8.json",
                           "reduced": [], "why": "test"})
    doc["workloads"].append({"name": "extra-w8.ell", "config": "extra-w8",
                             "traffic": "build_ell", "chips": 1,
                             "why": "test"})
    doc["workloads"].append({"name": "extra-w8.loads", "config": "extra-w8",
                             "traffic": "graph_loads", "chips": 1,
                             "why": "test"})
    doc["end_to_end"][0]["workloads"].append("extra-w8.ell")
    doc["end_to_end"].append({"name": "graphs_per_s", "unit": "graphs/s",
                              "better": "higher", "bound": 0.05,
                              "source": "host_clock",
                              "workloads": ["extra-w8.loads"]})
    doc["per_layer"].append({"name": "build.calls_seen", "unit": "calls",
                             "better": "higher", "source": "host_clock",
                             "layer": "whole-index build",
                             "moves": "build_rows_per_s",
                             "workloads": ["extra-w8.ell"]})
    doc["per_layer"].append({"name": "load.graphs_seen", "unit": "graphs",
                             "better": "higher", "source": "program_counter",
                             "layer": "graph load", "moves": "graphs_per_s",
                             "workloads": ["extra-w8.loads"]})
    with open(path, "w") as f:
        json.dump(doc, f)
    rc, res, _ = run_cell(tiny_root, "extra-w8.ell")
    assert rc == 0 and res["correct"]
    assert set(res["metrics"]) == {"build_rows_per_s", "setup_s"}
    rc, res, _ = run_cell(tiny_root, "extra-w8.ell", trace=1)
    assert rc == 0 and res["correct"]
    assert res["metrics"]["build.calls_seen"]["value"] >= 1
    assert "relax_jacobi.device_us_per_row" not in res["metrics"]
    rc, res, _ = run_cell(tiny_root, "extra-w8.loads")
    assert rc == 0 and res["correct"]
    assert set(res["metrics"]) == {"graphs_per_s", "setup_s"}
    assert res["metrics"]["graphs_per_s"]["value"] > 0
    rc, res, _ = run_cell(tiny_root, "extra-w8.loads", trace=1)
    assert rc == 0 and res["correct"]
    assert res["metrics"]["load.graphs_seen"]["value"] >= 1
    assert res["checks"] == {"arcs_differing": {"value": 0, "limit": 0}}
