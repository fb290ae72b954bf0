"""``BENCHMARK.json`` and the files it names, found by name.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric is a file of its own:

* a configuration: the JSON file its entry names under ``file``;
* a traffic mix: ``benchmark/traffic/<traffic>.json``, parameters that
  the driver its ``driver`` key names reads;
* a driver: ``benchmark/drivers/<driver>.py``, the system under test's
  entry point, its end-to-end numbers and its comparison with the plain
  reference (:mod:`harness.driver`);
* a per-layer metric: ``benchmark/metrics/<name>.py``, a reader with a
  function ``read(run)`` that returns the number, or None when the run
  holds nothing to read, and optionally ``COUNTERS``, the program's
  counters it reads: ``{key: (module, function, attribute)}``, the
  module under the port's package, each read as the change over the
  window into ``run["counters"][key]``.

A later cell, mix, driver or metric is added with new files and new
entries, never by an edit here.
"""

from __future__ import annotations

import importlib.util
import json
import os


class Spec:
    """The parsed ``BENCHMARK.json`` of checkout ``root``."""

    def __init__(self, root: str):
        self.root = root
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.doc = json.load(f)
        self.bench_dir = os.path.join(root, "benchmark")

    def cell(self, name: str) -> dict:
        for c in self.doc["workloads"]:
            if c["name"] == name:
                return c
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.doc["configs"]:
            if c["name"] == name:
                with open(os.path.join(self.root, c["file"])) as f:
                    return json.load(f)
        raise KeyError(f"no configuration named {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        with open(os.path.join(self.bench_dir, "traffic",
                               f"{name}.json")) as f:
            return json.load(f)

    def end_to_end(self, cell: str) -> list[dict]:
        """The end-to-end metrics ``cell`` reports."""
        return [m for m in self.doc["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> list[dict]:
        """The per-layer metrics ``cell`` reports: those that list it, and
        those without a list whose end-to-end metric it reports."""
        reported = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.doc["per_layer"]
                if (cell in m["workloads"] if "workloads" in m
                    else m["moves"] in reported)]

    def _module(self, kind: str, name: str):
        path = os.path.join(self.bench_dir, kind, f"{name}.py")
        tag = name.replace(".", "_").replace("-", "_")
        mod_spec = importlib.util.spec_from_file_location(
            f"bench_{kind}_{tag}", path)
        mod = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(mod)
        return mod

    def driver(self, name: str):
        """The module ``benchmark/drivers/<name>.py``: its ``Driver`` and
        its ``check``."""
        return self._module("drivers", name)

    def reader(self, metric: str):
        """The module ``benchmark/metrics/<metric>.py``: its ``read`` and
        its ``COUNTERS``, if any."""
        return self._module("metrics", metric)
