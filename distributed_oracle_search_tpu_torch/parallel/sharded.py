"""The whole CPD index on one device: build and query over all workers.

Port of the campaign half of the JAX package's ``parallel/sharded.py``.
There, every mesh shard builds and walks its own worker's rows under
``shard_map``; here one device holds the ``[W, R, N]`` table and the
worker axis is a loop (build) or a row offset (walk):

* :func:`build_fm_sharded` — every worker's first-move rows, in
  ``chunk``-column batches through the build kind the policy picked
  (:func:`chunk_compute`, ``models.cpd.pick_build_kernel``), into one
  int8 ``[W, R, N]`` tensor (``-1`` in the pad rows); on the card the
  extraction kernel writes each batch's rows straight into the table;
* :func:`query_sharded` — one round of routed ``[D, W, Q]`` queries in
  ONE walk: the table is viewed as ``[W·R, N]`` and each lane's row is
  offset by ``w·R``, so a single ``cuda_walk_batch`` call (the CUDA
  kernel on the card, the plain walk on the CPU) answers every worker.
  Lanes are independent and the step bound depends only on
  ``max_steps`` or N, so the answers are bit-identical to the per-worker
  ``shard_map`` walk;
* :func:`query_paths_sharded` — the path prefixes of a routed round.

Padding convention as in the JAX module: targets pad with -1, queries
with ``valid=False`` lanes (which come back cost 0, plen 0, unfinished).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.bellman_ford import build_fm_columns
from ..ops.cuda_build_kernels import csr_from_ell
from ..ops.cuda_walk import cuda_walk_batch
from ..ops.device_graph import DeviceGraph
from ..ops.ell_split import build_fm_columns_ellsplit
from ..ops.frontier_relax import build_fm_columns_frontier
from ..ops.grid_sweep import build_fm_columns_sweep
from ..ops.shift_relax import build_fm_columns_shift
from ..ops.table_search import extract_paths


def pad_targets(controller, dtype=np.int32) -> np.ndarray:
    """[W, R] owned targets per worker, -1-padded to the max shard size."""
    w = controller.maxworker
    r = max(controller.max_owned, 1)
    out = np.full((w, r), -1, dtype)
    for wid in range(w):
        owned = controller.owned(wid)
        out[wid, :len(owned)] = owned
    return out


def chunk_compute(dg: DeviceGraph, kernel=None, max_iters: int = 0):
    """One build closure per resolved build kind (the JAX
    ``models.cpd._make_chunk_compute``): ``fn(targets, out=None)`` takes
    an int32 target tensor on ``dg``'s device (``-1`` = pad) and returns
    its int8 ``[B, N]`` first-move rows, or writes the first ``len(out)``
    of them into ``out``.

    ``kernel``: ``(kind, structure)`` from ``models.cpd.pick_build_kernel``
    (None = ``("ell", None)``). Every kind picks by device: the plain
    torch stage on the CPU, the hand kernels on the card — ``sweep`` the
    grid sweep (+ relax for its off-lattice edges), ``ell``/``ellsplit``/
    ``shift`` the Jacobi relax over the full out-edge CSR, ``frontier``
    its torch queue; every kind then the extraction kernel. The CSR is
    built here, once per build."""
    kind, st = kernel if kernel is not None else ("ell", None)
    csr = None if dg.device.type == "cpu" else csr_from_ell(dg)
    if kind == "ell":
        return lambda t, out=None: build_fm_columns(
            dg, t, max_iters=max_iters, csr=csr, out=out)
    stages = {"sweep": build_fm_columns_sweep,
              "shift": build_fm_columns_shift,
              "frontier": build_fm_columns_frontier,
              "ellsplit": build_fm_columns_ellsplit}
    if kind not in stages:
        raise ValueError(f"unknown build kind {kind!r}")
    stage = stages[kind]
    return lambda t, out=None: stage(dg, st, t, max_iters=max_iters,
                                     csr=csr, out=out)


def build_fm_sharded(dg: DeviceGraph, targets_wr: np.ndarray,
                     chunk: int = 0, max_iters: int = 0,
                     kernel=None) -> torch.Tensor:
    """Build the whole CPD: int8 ``[W, R, N]`` on ``dg``'s device.

    ``chunk`` bounds the live distance columns (0 = a worker's R rows at
    once): each worker's targets run through the build in ``chunk``-wide
    batches, the last one padded with ``-1`` to the fixed width as the
    JAX build pads it. A row depends only on its target, so the table is
    byte-identical whatever the chunk. ``kernel``: ``(kind, structure)``
    from ``models.cpd.pick_build_kernel`` selecting the distance stage
    (default ELL), as in the JAX ``build_fm_sharded``; every kind gives
    the same table."""
    w, r = targets_wr.shape
    chunk = r if chunk <= 0 or chunk >= r else chunk
    padded = np.full((w, -(-r // chunk) * chunk), -1, np.int32)
    padded[:, :r] = targets_wr
    build = chunk_compute(dg, kernel, max_iters)
    fm = torch.empty((w, r, dg.n), dtype=torch.int8, device=dg.device)
    for wid in range(w):
        for i in range(0, r, chunk):
            cols = torch.from_numpy(padded[wid, i:i + chunk]).to(dg.device)
            build(cols, out=fm[wid, i:i + min(chunk, r - i)])
    return fm


def _flat_lanes(fm_wrn: torch.Tensor, t_rows: np.ndarray,
                *lanes: np.ndarray):
    """The ``[W·R, N]`` view of the table, each routed lane's row offset
    by its worker's ``w·R`` (int32), and the other routed arrays
    flattened, all on the table's device."""
    w, r, _ = fm_wrn.shape
    if w * r >= 2 ** 31:
        raise ValueError(f"{w} x {r} table rows overflow an int32 row id")
    rows = (np.asarray(t_rows, np.int64)
            + np.arange(w, dtype=np.int64)[None, :, None] * r)
    dev = fm_wrn.device
    out = [torch.from_numpy(np.ascontiguousarray(a).reshape(-1)).to(dev)
           for a in (rows.astype(np.int32), *lanes)]
    return (fm_wrn.view(w * r, -1), *out)


def query_sharded(dg: DeviceGraph, fm_wrn: torch.Tensor,
                  t_rows: np.ndarray, s: np.ndarray, t: np.ndarray,
                  valid: np.ndarray, w_query_pad: torch.Tensor,
                  k_moves: int = -1, max_steps: int = 0,
                  pair: torch.Tensor | None = None):
    """Answer one round of routed query lanes over every worker's rows.

    Inputs are ``[D, W, Q]`` numpy arrays (data axis × worker axis ×
    padded queries): ``t_rows`` = the worker-local fm row of each lane's
    target, ``valid`` masks padding. ``pair``: the walk's pair table for
    ``w_query_pad`` (``ops.table_search.walk_pairs``), built here when
    absent. Returns ``(cost, plen, finished)`` tensors ``[D, W, Q]`` on
    the table's device, from one walk call."""
    shape = np.shape(s)
    fm2, rows, s_d, t_d, v_d = _flat_lanes(
        fm_wrn, t_rows, np.asarray(s, np.int32), np.asarray(t, np.int32),
        np.asarray(valid, bool))
    cost, plen, fin = cuda_walk_batch(
        dg, fm2, rows, s_d, t_d, w_query_pad, valid=v_d, k_moves=k_moves,
        max_steps=max_steps, pair=pair)
    return cost.view(shape), plen.view(shape), fin.view(shape)


def query_paths_sharded(dg: DeviceGraph, fm_wrn: torch.Tensor,
                        t_rows: np.ndarray, s: np.ndarray, t: np.ndarray,
                        k: int):
    """Materialize k-move path prefixes for routed ``[D, W, Q]`` lanes.

    Returns ``(nodes [D, W, Q, k+1], moves [D, W, Q])`` tensors on the
    table's device (the reference's ``--k-moves`` extraction, reference
    ``args.py:31-36``, batched over every worker at once)."""
    shape = np.shape(s)
    fm2, rows, s_d, t_d = _flat_lanes(
        fm_wrn, t_rows, np.asarray(s, np.int32), np.asarray(t, np.int32))
    nodes, moves = extract_paths(dg, fm2, rows, s_d, t_d, k=k)
    return nodes.view(*shape, k + 1), moves.view(shape)
