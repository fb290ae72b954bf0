"""``astar_batches``: a worker's A* engine, ``ShardEngine(alg="astar")``,
answering ``batch`` s-t queries a call in a closed loop (one batch in
flight), every batch priced under one congestion diff. The queries are
a pool of ``pool_batches`` distinct batches drawn from the mix's
``query_seed`` (sources uniform over all nodes, targets uniform over
the worker's own nodes: the routing invariant), the diff a ``diff_frac``
share of the roads drawn from its ``diff_seed``; the run's seed renames
the graph's nodes, and so both, and sets the order in which the window
cycles through the pool's batches. Every seed thus does the same work:
a batch's time follows its deepest search, which seeds that drew their
own batches changed by several percent. The end-to-end number
``queries_per_s`` is the window's answered queries over its time.

``check`` compares a sample of the window's answers, drawn from the seed
with the longest among them, with the plain reference's (cost, fewest
hops, reached): ``answers_differing``, limit 0; with ``control`` the
reference at int16 takes the program's place.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time

import numpy as np
import torch

from harness import synth
from harness.driver import Driver as Base
from harness.driver import subseed, sync
from reference import paths

#: queries the reference takes at a time
BLOCK = 64


class Driver(Base):
    def setup(self, trace: bool) -> None:
        from distributed_oracle_search_tpu_torch.transport.wire import (
            RuntimeConfig,
        )
        from distributed_oracle_search_tpu_torch.worker import engine as eng

        t0 = time.perf_counter()
        g = self.graph()
        src, dst, w = self.arrays[2:]
        self.eids, self.new_w = synth.congestion(
            len(src), w, self.traffic["diff_frac"], self.traffic["diff_seed"],
            tuple(self.traffic["diff_factor"]))
        self.tmp = tempfile.mkdtemp(prefix="bench-astar-")
        self.diff = os.path.join(self.tmp, "congestion.diff")
        with open(self.diff, "w") as f:
            f.write(f"d {len(self.eids)}\n")
            f.writelines(f"{u} {v} {x}\n" for u, v, x in zip(
                src[self.eids], dst[self.eids], self.new_w))
        self.engine = eng.ShardEngine(g, self.controller(),
                                      self.config["worker"], self.tmp,
                                      alg="astar", device=self.device)
        self.rc = RuntimeConfig(hscale=self.traffic["hscale"],
                                fscale=self.traffic["fscale"])
        self.engine.preload(self.diff)
        self.batch = self.traffic["batch"]
        self.pool = query_pool(self.traffic, self.n, self.owned,
                               self.new_id)
        self.order = np.random.default_rng(subseed(self.seed, "order")) \
            .permutation(len(self.pool))
        self.answers = []
        self.work.update(queries=0, batches=0, sweeps=0)
        if trace:
            # the engine drops astar_batch_np's per-chunk sweep counts;
            # the traced run passes the call an info dict to keep them
            inner = eng.astar_batch_np

            def counted(*a, **kw):
                info = {}
                out = inner(*a, info=info, **kw)
                self.work["sweeps"] += sum(info["sweeps"])
                return out

            eng.astar_batch_np = counted
            self._restore = (eng, inner)
        sync(self.device)
        t1 = time.perf_counter()
        rng = np.random.default_rng(subseed(self.seed, "warmup"))
        k = self.traffic["warmup_queries"]
        warm = np.stack([rng.integers(0, self.n, k),
                         self.owned[rng.integers(0, len(self.owned), k)]],
                        axis=1)
        self.engine.answer(warm, self.rc, self.diff)
        sync(self.device)
        self.split.update(system=t1 - t0, warmup=time.perf_counter() - t1)
        self.work["sweeps"] = 0

    def call(self) -> None:
        i = self.work["batches"]
        q = self.pool[self.order[i % len(self.order)]]
        cost, plen, fin, _ = self.engine.answer(q, self.rc, self.diff)
        self.answers.append((q, cost, plen, fin))
        self.work["calls"] += 1
        self.work["batches"] += 1
        self.work["queries"] += len(q)

    def end_to_end(self, window_s: float) -> dict:
        return {"queries_per_s": self.work["queries"] / window_s}

    def shapes(self) -> dict:
        return {"n": self.n, "q": self.batch}

    def attempted(self) -> tuple[int, int]:
        fin = sum(int(a[3].sum()) for a in self.answers)
        return self.work["queries"], self.work["queries"] - fin

    def outputs(self, rng: np.random.Generator) -> dict:
        """A sample of the window's answers drawn from the seed, with the
        longest (by the program's hop count) in it."""
        q, cost, plen, fin = (np.concatenate(a) for a in zip(*self.answers))
        longest = np.argsort(-plen, kind="stable")[
            :self.traffic["sample_longest"]]
        rest = np.setdiff1d(np.arange(len(q)), longest)
        k = min(self.traffic["sample_queries"], len(rest))
        pick = np.concatenate([longest, rng.choice(rest, size=k,
                                                   replace=False)])
        return {"queries": q[pick], "cost": cost[pick], "plen": plen[pick],
                "fin": fin[pick]}

    def close(self) -> None:
        if getattr(self, "_restore", None):
            eng, inner = self._restore
            eng.astar_batch_np = inner
            self._restore = None
        self.engine = None
        if getattr(self, "tmp", None):
            shutil.rmtree(self.tmp, ignore_errors=True)
            self.tmp = None


def query_pool(traffic: dict, n: int, owned: np.ndarray,
               new_id: np.ndarray) -> np.ndarray:
    """int64 ``[pool_batches, batch, 2]``: the mix's queries, drawn in the
    graph's drawn ids and handed over in the run's (``new_id``; the
    worker's nodes ``owned`` are the same set in both)."""
    rng = np.random.default_rng(traffic["query_seed"])
    k = traffic["batch"] * traffic["pool_batches"]
    pool = np.stack([rng.integers(0, n, k),
                     owned[rng.integers(0, len(owned), k)]], axis=1)
    return new_id[pool].reshape(-1, traffic["batch"], 2)


def check(driver, out: dict, control: bool = False):
    n, dev = driver.n, driver.device
    w = np.array(driver.arrays[4], np.int64)
    w[driver.eids] = driver.new_w
    src, dst, w = (torch.as_tensor(np.asarray(a, np.int64), device=dev)
                   for a in (*driver.arrays[2:4], w))
    q = torch.as_tensor(out["queries"], device=dev)
    differing = 0
    for lo in range(0, len(q), BLOCK):
        s, t = q[lo:lo + BLOCK, 0], q[lo:lo + BLOCK, 1]
        want = paths.route_answers(n, src, dst, w, s, t)
        if control:
            have = paths.route_answers(n, src, dst, w, s, t,
                                       paths.INT16_CAP)
        else:
            have = tuple(torch.as_tensor(out[k][lo:lo + BLOCK], device=dev)
                         for k in ("cost", "plen", "fin"))
        bad = torch.zeros(len(s), dtype=torch.bool, device=dev)
        for a, b in zip(have, want):
            bad |= a.to(torch.int64) != b.to(torch.int64)
        differing += int(bad.sum())
    return ({"answers_differing": {"value": differing, "limit": 0}},
            f"{len(q)} answers")
