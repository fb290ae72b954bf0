"""What every driver shares: the cell's graph made from the seed, the
worker's nodes, and the interface the harness calls.

A traffic mix (``benchmark/traffic/<mix>.json``) names its driver under
``driver``; the driver is ``benchmark/drivers/<driver>.py``, found by
name. It defines

* ``Driver``, a subclass of :class:`Driver` that builds the system under
  test through the program's own entry points and warms up the window's
  shapes (``setup``), runs one call of the window (``call``), and
  afterwards hands over what the timed path produced (``outputs``);
* ``check(driver, out, control)``, the comparison of those outputs with
  the plain reference (``benchmark/reference/``): ``(numbers, what)``,
  each number compared as ``{"value", "limit"}`` and ``what`` naming
  how much was compared.

The program's modules are imported inside the drivers' methods, never
when a module is imported.
"""

from __future__ import annotations

import time
import zlib

import numpy as np
import torch

from . import synth


def subseed(seed: int, tag: str) -> int:
    """A 64-bit seed of its own for each input ``tag`` of run ``seed``."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64),
                                 zlib.crc32(tag.encode())])
    return int(ss.generate_state(1, np.uint64)[0])


def owned_nodes(config: dict, n: int) -> np.ndarray:
    """The worker's nodes, ascending: its shard's rows in order (the
    partition's definition, worked out here for the reference)."""
    part = config["partition"]
    nodes = np.arange(n, dtype=np.int64)
    if part["method"] != "mod":
        raise ValueError(f"partition {part['method']!r} is not supported")
    return nodes[nodes % part["workers"] == config["worker"]]


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Driver:
    """The base of a traffic mix's driver: the configuration's graph,
    renamed by the run's seed, and the worker's nodes."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config = config
        self.traffic = traffic
        self.seed = seed
        self.device = torch.device(device)
        t0 = time.perf_counter()
        #: the graph's arrays, and the map from its drawn ids to the
        #: run's: a seed renames the configuration's one graph
        self.arrays, self.new_id = synth.make_graph(
            config["graph"], subseed(seed, "graph"),
            config["partition"]["workers"])
        #: set-up's seconds by phase: the inputs, the system under test
        #: (the program's structures and uploads), the warm-up
        self.split = {"inputs": time.perf_counter() - t0}
        self.n = len(self.arrays[0])
        self.owned = owned_nodes(config, self.n)
        #: the window's work: calls, and the driver's own units, which
        #: the per-layer readers see as ``run["work"]``
        self.work = {"calls": 0}

    def graph(self):
        from distributed_oracle_search_tpu_torch.data.graph import Graph

        return Graph(*self.arrays)

    def controller(self):
        from distributed_oracle_search_tpu_torch.parallel.partition import (
            DistributionController,
        )

        part = self.config["partition"]
        return DistributionController(part["method"], part["workers"],
                                      part["workers"], self.n)

    def end_to_end(self, window_s: float) -> dict:
        """The window's end-to-end numbers by metric name (all but
        ``setup_s``, which the harness measures)."""
        raise NotImplementedError

    def shapes(self) -> dict:
        """The window's launch shapes, for the roofline readers."""
        return {}

    def note(self) -> str:
        """A few words on the run for its log line."""
        return ""

    def close(self) -> None:
        """Frees what the driver holds on the device."""
