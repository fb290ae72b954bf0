"""``build_rows``: the CPD build of one worker's shard, as
``CPDOracle.build`` makes it for one part:
``build_fm_sharded(dg, targets_wr[[w]], chunk=build_chunk_rows(...),
kernel=pick_build_kernel(graph, method))``, the rows left on the device.
A call builds the whole shard; its work is the shard's rows, and its
end-to-end number ``build_rows_per_s`` the window's rows over its time.

``check`` compares a sample of the last call's rows, drawn from the
seed, cell by cell with the plain reference's first moves
(``fm_cells_differing``, limit 0); with ``control`` the reference at
int16 takes the program's place.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from harness.driver import Driver as Base
from harness.driver import sync
from reference import paths

#: targets the reference takes at a time
BLOCK = 64


class Driver(Base):
    def setup(self, trace: bool) -> None:
        from distributed_oracle_search_tpu_torch.models.cpd import (
            build_chunk_rows, pick_build_kernel,
        )
        from distributed_oracle_search_tpu_torch.ops.device_graph import (
            DeviceGraph,
        )
        from distributed_oracle_search_tpu_torch.parallel.sharded import (
            build_fm_sharded, pad_targets,
        )

        t0 = time.perf_counter()
        g = self.graph()
        dc = self.controller()
        wid = self.config["worker"]
        self.rows = dc.n_owned(wid)
        self.targets = pad_targets(dc)[[wid]]
        self.kernel = pick_build_kernel(g, self.traffic["method"])
        self.chunk = build_chunk_rows(g, self.config.get("chunk", 0),
                                      self.rows, self.kernel[0])
        self.dg = DeviceGraph.from_graph(g, device=self.device)
        self._build = build_fm_sharded
        self.m = g.m
        self.fm = None
        sync(self.device)
        t1 = time.perf_counter()
        # warm-up: one small build at the real N, its column count of the
        # same residue mod 4 as the timed batch (the kernels' lane widths)
        warm = self.traffic["warmup_columns"] + self.chunk % 4
        self._build(self.dg, self.targets[:, :warm], chunk=0,
                    kernel=self.kernel)
        sync(self.device)
        self.split.update(system=t1 - t0, warmup=time.perf_counter() - t1)
        self.work.update(rows=0)

    def call(self) -> None:
        self.fm = None
        self.fm = self._build(self.dg, self.targets, chunk=self.chunk,
                              kernel=self.kernel)
        sync(self.device)
        self.work["calls"] += 1
        self.work["rows"] += self.rows

    def end_to_end(self, window_s: float) -> dict:
        return {"build_rows_per_s": self.work["rows"] / window_s}

    def shapes(self) -> dict:
        """The shapes of the window's K2 launches: one a chunk a call."""
        r = self.rows
        launches = [(self.n, self.m, self.chunk, min(self.chunk, r - i))
                    for i in range(0, r, self.chunk)]
        return {"n": self.n, "m": self.m,
                "first_moves": launches * self.work["calls"]}

    def note(self) -> str:
        return f"build kind {self.kernel[0]}"

    def attempted(self) -> tuple[int, int]:
        return self.work["rows"], 0

    def outputs(self, rng: np.random.Generator) -> dict:
        """The last call's rows, a sample drawn from the seed, on the
        host; the program's table is then freed."""
        k = min(self.traffic["sample_rows"], self.rows)
        rows = np.sort(rng.choice(self.rows, size=k, replace=False))
        got = self.fm[0, torch.from_numpy(rows).to(self.device)].cpu()
        return {"rows": rows, "fm": got}

    def close(self) -> None:
        self.fm = self.dg = None


def check(driver, out: dict, control: bool = False):
    n, dev = driver.n, driver.device
    src, dst, w = (torch.as_tensor(np.asarray(a, np.int64), device=dev)
                   for a in driver.arrays[2:])
    targets = torch.as_tensor(driver.owned[out["rows"]], device=dev)
    differing = 0
    for lo in range(0, len(targets), BLOCK):
        t = targets[lo:lo + BLOCK]
        want = paths.first_moves(n, src, dst, w, t).cpu()
        have = (paths.first_moves(n, src, dst, w, t, paths.INT16_CAP).cpu()
                if control else out["fm"][lo:lo + BLOCK])
        differing += int((have != want).sum())
    return ({"fm_cells_differing": {"value": differing, "limit": 0}},
            f"{len(targets) * n} cells")
