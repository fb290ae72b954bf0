"""Helpers of the benchmark's CPU tests: a checkout whose cells run at
tiny sizes on the CPU, and a runner that drives a whole run there (the
harness's look for a card skipped: ``main(device="cpu")``)."""

import contextlib
import io
import json
import os
import shutil
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

#: the tiny size: a 2,000-node road network with the configuration's
#: mean degree (5,552 arcs), over 8 workers (250 targets)
TINY_GRAPHS = {"road_network_sized": {"n": 2000, "arcs": 5552}}

TINY_TRAFFIC = {"build_rows": {"warmup_columns": 8, "sample_rows": 16},
                "astar_diff": {"batch": 64, "sample_queries": 40}}


def make_root(dst, graphs=TINY_GRAPHS, workers=8) -> str:
    """A copy of ``BENCHMARK.json`` and ``benchmark/`` under ``dst`` with
    every configuration and traffic mix shrunk; returns its path."""
    root = str(dst)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(BENCH, os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        doc = json.load(f)
    for c in doc["configs"]:
        path = os.path.join(root, c["file"])
        with open(path) as f:
            cfg = json.load(f)
        cfg["graph"].update(graphs[cfg["graph"]["generator"]])
        cfg["partition"]["workers"] = workers
        with open(path, "w") as f:
            json.dump(cfg, f)
    for name, small in TINY_TRAFFIC.items():
        path = os.path.join(root, "benchmark", "traffic", f"{name}.json")
        with open(path) as f:
            mix = json.load(f)
        mix.update(small)
        with open(path, "w") as f:
            json.dump(mix, f)
    return root


def run_cell(root, cell, seed=7, seconds=0.2, trace=0, control=None):
    """``(exit code, result dict or None, stderr text)`` of one run of
    ``cell`` on the CPU."""
    from harness.main import main

    argv = ["--workload", cell, "--seed", str(seed), "--seconds",
            str(seconds), "--trace", str(trace)]
    if control:
        argv += ["--control", control]
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv, root=root, device="cpu")
    lines = out.getvalue().strip().splitlines()
    result = json.loads(lines[-1]) if rc == 0 and lines else None
    return rc, result, err.getvalue()


with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    #: the benchmark's cells
    CELLS = tuple(c["name"] for c in json.load(_f)["workloads"])
