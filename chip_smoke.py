#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives one worker's main path end to end on the card, through the entry
points a user calls, at the size of the USA-road-d.NY stand-in
(``synth_road_network(264_000, seed=0)``, partitioned ``mod`` over 32
workers; worker 0 owns 8,250 targets, a 2.18 GB int8 first-move table):

1. print the card (``nvidia-smi``) and build the CUDA walk kernel from
   ``distributed_oracle_search_tpu_torch/csrc`` with ``nvcc``;
2. build worker 0's CPD shard on the card (``build_worker_shard``,
   512-row chunks) into block files plus an ``index.json`` manifest;
3. load it into a ``ShardEngine`` on the card and answer three rounds of
   20,000 queries: free flow, one congestion diff, and ``k_moves=8``
   with path extraction; the walk's launch counter is zeroed before the
   rounds and read after them;
4. call the kernel and its plain torch version on each round's exact
   kernel inputs on the card: ``(cost, plen, finished)`` must be equal
   element by element; both are timed with CUDA events;
5. golden check: free-flow costs equal reverse-Dijkstra distances for 4
   seeded targets, and 16 diff-round answers equal the CPU reference walk;
6. print the kernel table as one JSON line, then, as the last line,
   ``{"ok": true, "device": {...}}``.

Any failed phase exits non-zero. Without a GPU, or without the package
beside this script, it exits non-zero and prints no result. Everything it
writes goes under ``build/`` beside this script and is removed at exit.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

from distributed_oracle_search_tpu_torch.data import (
    synth_diff, synth_road_network, write_diff,
)
from distributed_oracle_search_tpu_torch.models import (
    dist_to_target, table_search_walk,
)
from distributed_oracle_search_tpu_torch.models.cpd import (
    build_worker_shard, write_index_manifest,
)
from distributed_oracle_search_tpu_torch.ops import cuda_walk as cw
from distributed_oracle_search_tpu_torch.ops.table_search import (
    table_search_batch,
)
from distributed_oracle_search_tpu_torch.parallel import (
    DistributionController,
)
from distributed_oracle_search_tpu_torch.transport import RuntimeConfig
from distributed_oracle_search_tpu_torch.utils import cuda_build
from distributed_oracle_search_tpu_torch.worker import engine as eng

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
N_NODES = 264_000
MAXWORKER = 32
WID = 0
CHUNK = 512
N_QUERIES = 20_000
N_DUPS = 200
N_SELF = 50
KERNEL_REPS = 20
PLAIN_REPS = 3
#: H100 SXM published device-memory rate and non-tensor 32-bit rate
#: (used for the int32 walk arithmetic); the bound is the larger time
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12
SECTOR = 32


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def time_cuda(fn, reps: int) -> float:
    """Mean ms of ``fn()`` over ``reps`` calls, by CUDA events, after
    one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def make_queries(dc, n: int) -> np.ndarray:
    """Uniform sources, targets uniform over worker WID's owned nodes,
    with duplicate pairs and s == t pairs mixed in."""
    rng = np.random.default_rng(SEED)
    owned = dc.owned(WID)
    s = rng.integers(0, n, N_QUERIES)
    t = owned[rng.integers(0, len(owned), N_QUERIES)]
    q = np.stack([s, t], axis=1).astype(np.int64)
    dup_to = rng.choice(N_QUERIES, N_DUPS, replace=False)
    q[dup_to] = q[rng.integers(0, N_QUERIES, N_DUPS)]
    self_at = rng.choice(N_QUERIES, N_SELF, replace=False)
    q[self_at, 0] = q[self_at, 1]
    return q


def run() -> dict:
    # ---- 1. card + kernel build
    log(card_line())
    t0 = time.perf_counter()
    cuda_build.load_library(cw.KERNEL_NAME)
    info = cuda_build.build_info[cw.KERNEL_NAME]
    log(f"[build] {cw.KERNEL_NAME}: nvcc {info['seconds']:.2f} s "
        f"(load {time.perf_counter() - t0:.2f} s)")
    for line in info["ptxas"].splitlines():
        log(f"[build]   {line.strip()}")

    # ---- 2. graph + worker 0's shard build on the card
    t0 = time.perf_counter()
    g = synth_road_network(N_NODES, seed=SEED)
    dc = DistributionController("mod", MAXWORKER, MAXWORKER, g.n)
    log(f"[graph] n={g.n} m={g.m} K={g.max_out_degree} "
        f"({time.perf_counter() - t0:.2f} s); worker {WID} owns "
        f"{dc.n_owned(WID)} targets")
    work = os.path.join(ROOT, "build")
    os.makedirs(work, exist_ok=True)
    outdir = tempfile.mkdtemp(prefix="chip-smoke-", dir=work)
    try:
        return _run_in(g, dc, outdir)
    finally:
        shutil.rmtree(outdir, ignore_errors=True)


def _run_in(g, dc, outdir) -> dict:
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    written = build_worker_shard(g, dc, WID, outdir, chunk=CHUNK,
                                 device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    rows = dc.n_owned(WID)
    log(f"[build-shard] rows={rows} chunk={CHUNK} blocks={len(written)} "
        f"seconds={build_s:.3f} rows/s={rows / build_s:.2f} peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    write_index_manifest(outdir, dc, workers=[WID])

    # ---- 3. engine on the card, three rounds through answer()
    t0 = time.perf_counter()
    engine = eng.ShardEngine(g, dc, WID, outdir, device="cuda")
    torch.cuda.synchronize()
    log(f"[engine] loaded {tuple(engine.fm.shape)} {engine.fm.dtype} fm "
        f"({engine.fm.numel() / 1e9:.2f} GB) in "
        f"{time.perf_counter() - t0:.2f} s")
    queries = make_queries(dc, g.n)
    diff_path = os.path.join(outdir, "congestion.diff")
    write_diff(diff_path, *synth_diff(g, frac=0.1, seed=2))
    rounds = [("free-flow", RuntimeConfig(), "-"),
              ("diff", RuntimeConfig(), diff_path),
              ("k8-extract", RuntimeConfig(k_moves=8, extract=True), "-")]
    # record the kernel calls answer() makes, to replay their exact
    # inputs in phase 4 (the recorder calls the real wrapper)
    captured: list = []
    real_walk = eng.cuda_walk_batch

    def recording_walk(*a, **kw):
        captured.append((a, kw))
        return real_walk(*a, **kw)

    eng.cuda_walk_batch = recording_walk
    answers = {}
    cw.cuda_walk_batch.launches = 0
    try:
        for name, cfg, diff in rounds:
            engine.answer(queries, cfg, diff)              # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cost, plen, fin, stats = engine.answer(queries, cfg, diff)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            answers[name] = (cost, plen, fin, stats, engine.last_paths,
                             captured[-1])
            log(f"[answer] {name}: {len(queries)} queries in {dt:.4f} s "
                f"= {len(queries) / dt:.1f} q/s; finished "
                f"{stats.finished}/{stats.n_touched}, sum plen "
                f"{stats.plen}, max plen {int(plen.max())}")
    finally:
        eng.cuda_walk_batch = real_walk
    launches = cw.cuda_walk_batch.launches
    log(f"[answer] walk kernel launches in the three rounds: {launches}")
    if launches <= 0:
        raise AssertionError("the main path never launched the walk kernel")

    # ---- 4. kernel vs plain torch on each round's kernel inputs
    per_round = []
    for name, *_rest in rounds:
        a, kw = answers[name][5]
        ker = cw.cuda_walk_batch(*a, **kw)
        plain = table_search_batch(*a, **kw)
        torch.cuda.synchronize()
        err = 0
        for x, y, label in zip(ker, plain, ("cost", "plen", "fin")):
            if x.dtype != y.dtype or not torch.equal(x, y):
                bad = int((x != y).sum())
                raise AssertionError(f"{name}: kernel {label} differs from "
                                     f"the plain walk on {bad} lanes")
            err = max(err, int((x.long() - y.long()).abs().max())
                      if x.numel() else 0)
        ms = time_cuda(lambda: cw.cuda_walk_batch(*a, **kw),
                       KERNEL_REPS)
        plain_ms = time_cuda(
            lambda: table_search_batch(*a, **kw), PLAIN_REPS)
        valid = kw["valid"]
        q = int(valid.numel())
        sum_plen = int(ker[1][valid].long().sum())
        n_valid = int(valid.sum())
        # least bytes: per valid lane its birth fm sector, then per move
        # one fm sector + one (next, w) pair sector; lane inputs
        # (rows, s, t int32 + valid) read once, outputs written once
        nbytes = ((n_valid + sum_plen) * SECTOR + sum_plen * SECTOR
                  + q * 13 + q * 9)
        ops = 6 * sum_plen + 4 * q       # compare/add/select per move
        bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S) * 1e3
        per_round.append({"round": name, "lanes": q, "valid": n_valid,
                          "sum_plen": sum_plen, "ms": ms,
                          "plain_ms": plain_ms, "bound_ms": bound_ms,
                          "bytes": nbytes, "max_abs_err": err})
        log(f"[kernel] {name}: lanes={q} valid={n_valid} sum_plen="
            f"{sum_plen} kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {bound_ms:.5f} ms ({nbytes} B) — bit-identical")

    # ---- 5. golden checks against the CPU reference oracle
    rng = np.random.default_rng(SEED + 1)
    cost_ff, plen_ff, fin_ff = answers["free-flow"][:3]
    if not fin_ff.all():
        raise AssertionError("free-flow round left queries unfinished on a "
                             "strongly connected graph")
    for tgt in rng.choice(np.unique(queries[:, 1]), 4, replace=False):
        ref = dist_to_target(g, int(tgt))
        sel = queries[:, 1] == tgt
        got, want = cost_ff[sel], ref[queries[sel, 0]]
        if not np.array_equal(got, want):
            raise AssertionError(f"target {tgt}: costs {got} != Dijkstra "
                                 f"{want}")
        log(f"[golden] target {tgt}: {int(sel.sum())} free-flow costs equal "
            "Dijkstra")
    w_diff = g.weights_with_diff(diff_path)
    cost_d, plen_d, fin_d = answers["diff"][:3]
    fm_rows: dict[int, np.ndarray] = {}

    def fm_of(x, tt):
        if tt not in fm_rows:
            r = int(dc.owned_index_of(tt))
            fm_rows[tt] = engine.fm[r].cpu().numpy()
        return fm_rows[tt][x]

    for i in rng.choice(len(queries), 16, replace=False):
        s, t = (int(v) for v in queries[i])
        c, p, f, _ = table_search_walk(g, fm_of, s, t,
                                               w_query=w_diff)
        if (int(cost_d[i]), int(plen_d[i]), bool(fin_d[i])) != (c, p, f):
            raise AssertionError(
                f"diff query {s}->{t}: engine "
                f"{(cost_d[i], plen_d[i], fin_d[i])} != reference "
                f"{(c, p, f)}")
    log("[golden] 16 diff-round answers equal the reference walk")
    _, plen_k, _, _, paths, _ = answers["k8-extract"]
    nodes, moves = paths
    if (nodes.shape != (len(queries), 9)
            or not np.array_equal(nodes[:, 0], queries[:, 0])
            or not np.array_equal(moves, plen_k) or plen_k.max() > 8):
        raise AssertionError("k_moves=8 extraction disagrees with the walk")
    log("[golden] k_moves=8 extraction: [Q, 9] prefixes, moves == plen")

    main = per_round[0]
    return {
        "name": cw.KERNEL_NAME,
        "route": "cuda",
        "source": "distributed_oracle_search_tpu_torch/csrc/"
                  "table_search_walk.cu",
        "replaces": "distributed_oracle_search_tpu/ops/pallas_walk.py:380",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in per_round),
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "parity": "bit-identical",
        "rounds": per_round,
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    try:
        kernel = run()
    except Exception:  # noqa: BLE001 — any failed phase fails the smoke
        traceback.print_exc()
        return 1
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
