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
* :func:`query_paths_sharded` — the path prefixes of a routed round;
* :func:`query_multi_sharded` — a round under D weight sets in ONE fused
  walk (``cuda_walk_multi``);
* :func:`query_mat_sharded` — one source to K targets, one walk, the
  answers scattered into a row in target order (the JAX program's
  ``psum`` over workers is that scatter on one device);
* :func:`query_dist_sharded` — stored distances by one gather
  (:func:`build_fm_sharded` ``with_dists=True``);
* :func:`build_tables_sharded` / :func:`build_tables_multi_sharded` —
  pointer-doubling tables, a loop over workers — and
  :func:`query_tables_sharded` / :func:`query_tables_multi_sharded`, one
  gather over the ``[W·R, N]`` views.

Padding convention as in the JAX module: targets pad with -1, queries
with ``valid=False`` lanes (which come back cost 0, plen 0, unfinished).

Spread over several devices (``parallel.mesh``):

* worker lanes — one worker's work over the devices it drives:
  :func:`build_fm_lanes` (lane ``l`` builds the ``l``-th contiguous part
  of a build chunk's targets through :func:`chunk_compute` on its
  device) and :func:`lane_walk_program` / :func:`walk_lanes` (lane ``l``
  walks the ``l``-th contiguous part of a length-sorted batch, one
  ``cuda_walk_batch`` call a lane on its device: one B1 launch a lane on
  the card); the results join in lane order, bit-identical to one call;
* the campaign grid — :func:`grid_parts` groups a ``[D, W]`` grid's
  cells by device: each device holds the rows of the workers whose
  column names it (once, however many cells it has) and walks the lanes
  of its cells; :func:`gather_cells` / :func:`scatter_cells` move routed
  ``[D, W, Q]`` arrays to one device's flat lane set and the answers
  back, so every program above runs unchanged on each device's part
  (its table viewed as one ``[Wp·R, N]`` worker). A grid that names one
  device throughout is not split: the oracle keeps the single-table
  path.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.bellman_ford import build_fm_columns
from ..ops.cuda_build_kernels import csr_from_ell
from ..ops.cuda_walk import cuda_walk_batch, cuda_walk_multi
from ..ops.device_graph import DeviceGraph
from ..ops.ell_split import build_fm_columns_ellsplit
from ..ops.frontier_relax import build_fm_columns_frontier
from ..ops.grid_sweep import build_fm_columns_sweep
from ..ops.pointer_doubling import (
    doubled_tables, doubled_tables_multi, lookup_tables, lookup_tables_multi,
)
from ..ops.shift_relax import build_fm_columns_shift
from ..ops.table_search import extract_paths
from .mesh import canonical, distinct


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
    ``models.cpd._make_chunk_compute``): ``fn(targets, out=None,
    dist_out=None)`` takes an int32 target tensor on ``dg``'s device
    (``-1`` = pad) and returns its int8 ``[B, N]`` first-move rows, or
    writes the first ``len(out)`` of them into ``out``; ``dist_out``, an
    int32 ``[R, N]`` row block, receives the converged distances' first
    R rows (every kind: the JAX ``_build_fn(with_dists=True)``).

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
        return lambda t, out=None, dist_out=None: build_fm_columns(
            dg, t, max_iters=max_iters, csr=csr, out=out, dist_out=dist_out)
    stages = {"sweep": build_fm_columns_sweep,
              "shift": build_fm_columns_shift,
              "frontier": build_fm_columns_frontier,
              "ellsplit": build_fm_columns_ellsplit}
    if kind not in stages:
        raise ValueError(f"unknown build kind {kind!r}")
    stage = stages[kind]
    return lambda t, out=None, dist_out=None: stage(
        dg, st, t, max_iters=max_iters, csr=csr, out=out, dist_out=dist_out)


def build_fm_sharded(dg: DeviceGraph, targets_wr: np.ndarray,
                     chunk: int = 0, max_iters: int = 0,
                     kernel=None, with_dists: bool = False):
    """Build the whole CPD: int8 ``[W, R, N]`` on ``dg``'s device.

    ``chunk`` bounds the live distance columns (0 = a worker's R rows at
    once): each worker's targets run through the build in ``chunk``-wide
    batches, the last one padded with ``-1`` to the fixed width as the
    JAX build pads it. A row depends only on its target, so the table is
    byte-identical whatever the chunk. ``kernel``: ``(kind, structure)``
    from ``models.cpd.pick_build_kernel`` selecting the distance stage
    (default ELL), as in the JAX ``build_fm_sharded``; every kind gives
    the same table.

    ``with_dists=True`` also returns the converged distance table, int32
    ``[W, R, N]`` (4x the fm memory; INF where unreachable and in pad
    rows, the ``max_iters`` cut's iterate when cut): ``(fm, dists)``. On
    the card the relax loop works node-major, so each chunk's rows are a
    transposed copy of its ``[N, B]`` table."""
    w, r = targets_wr.shape
    chunk = r if chunk <= 0 or chunk >= r else chunk
    padded = np.full((w, -(-r // chunk) * chunk), -1, np.int32)
    padded[:, :r] = targets_wr
    build = chunk_compute(dg, kernel, max_iters)
    fm = torch.empty((w, r, dg.n), dtype=torch.int8, device=dg.device)
    dists = (torch.empty((w, r, dg.n), dtype=torch.int32, device=dg.device)
             if with_dists else None)
    for wid in range(w):
        for i in range(0, r, chunk):
            cols = torch.from_numpy(padded[wid, i:i + chunk]).to(dg.device)
            rows = slice(i, i + min(chunk, r - i))
            build(cols, out=fm[wid, rows],
                  dist_out=None if dists is None else dists[wid, rows])
    return (fm, dists) if with_dists else fm


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


def query_multi_sharded(dg: DeviceGraph, fm_wrn: torch.Tensor,
                        t_rows: np.ndarray, s: np.ndarray, t: np.ndarray,
                        valid: np.ndarray, w_pads: torch.Tensor,
                        max_steps: int = 0, pair: torch.Tensor | None = None):
    """Fused multi-diff round over every worker's rows: ONE walk, D cost
    sets (the JAX ``query_multi_sharded``). ``w_pads`` int32 ``[D, M+1]``
    on the table's device; ``pair``: ``ops.table_search.walk_eid_pairs``
    of ``dg`` (built here when None). Returns ``(cost [D, Dg, W, Q],
    plen [Dg, W, Q], finished [Dg, W, Q])`` for routed ``[Dg, W, Q]``
    lanes, from one ``cuda_walk_multi`` call (K4 on the card)."""
    shape = np.shape(s)
    fm2, rows, s_d, t_d, v_d = _flat_lanes(
        fm_wrn, t_rows, np.asarray(s, np.int32), np.asarray(t, np.int32),
        np.asarray(valid, bool))
    cost, plen, fin = cuda_walk_multi(
        dg, fm2, rows, s_d, t_d, w_pads, valid=v_d, max_steps=max_steps,
        pair=pair)
    return (cost.view(w_pads.shape[0], *shape), plen.view(shape),
            fin.view(shape))


def query_mat_sharded(dg: DeviceGraph, fm_wrn: torch.Tensor, t_rows, s, t,
                      valid, slots, w_pad: torch.Tensor, k_out: int,
                      max_steps: int = 0, pair: torch.Tensor | None = None):
    """One ``mat`` row (one source, ``k_out`` targets): routed ``[D, W,
    Q]`` lanes as in :func:`query_sharded` plus ``slots``, each lane's
    position in the output row (-1 on padding). One walk answers every
    lane; the answers are scattered into a ``[k_out + 1]`` row at their
    slots (pad lanes into the extra slot) — on one card this scatter is
    the JAX program's ``psum`` over workers, since every target lives in
    exactly one slot. Returns ``(cost [k_out] int32, finished [k_out]
    bool)`` in target order, on the table's device."""
    cost, _plen, fin = query_sharded(dg, fm_wrn, t_rows, s, t, valid, w_pad,
                                     k_moves=-1, max_steps=max_steps,
                                     pair=pair)
    dev = fm_wrn.device
    v = torch.from_numpy(np.asarray(valid, bool).reshape(-1)).to(dev)
    idx = torch.where(v, torch.from_numpy(
        np.asarray(slots, np.int64).reshape(-1)).to(dev), k_out)
    row_c = torch.zeros(k_out + 1, dtype=torch.int32, device=dev)
    row_f = torch.zeros(k_out + 1, dtype=torch.int32, device=dev)
    row_c.index_add_(0, idx, torch.where(v, cost.reshape(-1), 0))
    row_f.index_add_(0, idx, fin.reshape(-1).to(torch.int32))
    return row_c[:k_out], row_f[:k_out] > 0


def query_dist_sharded(dist_wrn: torch.Tensor, t_rows: np.ndarray,
                       s: np.ndarray) -> torch.Tensor:
    """Free-flow fast path: d(s → t) by one gather over the ``[W·R, N]``
    view of the stored distances, no walk (the JAX
    ``query_dist_sharded``). Routed ``[D, W, Q]`` inputs; returns cost
    ``[D, W, Q]`` (INF where unreachable) on the table's device."""
    shape = np.shape(s)
    d2, rows, s_d = _flat_lanes(dist_wrn, t_rows, np.asarray(s, np.int32))
    return d2[rows.long(), s_d.long()].view(shape)


def build_tables_sharded(dg: DeviceGraph, fm_wrn: torch.Tensor,
                         targets_wr: np.ndarray, w_query_pad: torch.Tensor,
                         max_len: int = 0, out=None, order=None):
    """Pointer-doubling cost and packed-plen tables of every worker's
    rows (the JAX ``build_tables_sharded``): each worker doubles only its
    own ``[R, N]`` rows — on one card a loop over workers, one
    ``doubled_tables`` each. ``out``: ``(cost [W, R, N], plen_packed [W,
    R, N])`` to write into; ``order``: the records' layout
    (``ops.pointer_doubling.record_order``; None: node order). Returns
    ``(cost, plen_packed)``."""
    return _tables_by_worker(
        lambda fm, tg, o: doubled_tables(dg, fm, tg, w_query_pad,
                                         max_len=max_len, out=o,
                                         order=order),
        fm_wrn, targets_wr, out)


def build_tables_multi_sharded(dg: DeviceGraph, fm_wrn: torch.Tensor,
                               targets_wr: np.ndarray, w_pads: torch.Tensor,
                               max_len: int = 0, out=None, order=None):
    """Fused multi-diff pointer-doubling tables of every worker's rows
    (the JAX ``build_tables_multi_sharded``). ``w_pads`` int32 ``[D,
    M+1]``. Returns ``(costs [W, R, N, D], plen_packed [W, R, N])``;
    ``out`` and ``order`` as :func:`build_tables_sharded`."""
    return _tables_by_worker(
        lambda fm, tg, o: doubled_tables_multi(dg, fm, tg, w_pads,
                                               max_len=max_len, out=o,
                                               order=order),
        fm_wrn, targets_wr, out)


def _tables_by_worker(double, fm_wrn, targets_wr, out):
    tgt = torch.as_tensor(np.asarray(targets_wr, np.int32),
                          device=fm_wrn.device)
    parts = [double(fm_wrn[wid], tgt[wid],
                    None if out is None else (out[0][wid], out[1][wid]))
             for wid in range(fm_wrn.shape[0])]
    if out is not None:
        return out
    return tuple(torch.stack(p) for p in zip(*parts))


def query_tables_sharded(tables, t_rows, s, valid):
    """Answer routed ``[D, W, Q]`` lanes from prepared cost tables (the
    JAX ``query_tables_sharded``): one gather over the ``[W·R, N]``
    views. Returns ``(cost, plen, finished)`` ``[D, W, Q]``."""
    cost, plen_packed = tables
    shape = np.shape(s)
    w, r, n = cost.shape
    _, rows, s_d, v_d = _flat_lanes(cost, t_rows, np.asarray(s, np.int32),
                                    np.asarray(valid, bool))
    c, p, f = lookup_tables(cost.view(w * r, n),
                            plen_packed.view(w * r, n), rows, s_d, v_d)
    return c.view(shape), p.view(shape), f.view(shape)


def query_tables_multi_sharded(tables, t_rows, s, valid):
    """Answer routed ``[Dg, W, Q]`` lanes from fused multi-diff tables
    (the JAX ``query_tables_multi_sharded``): one ``[D]``-wide gather a
    lane. Returns ``(cost [D, Dg, W, Q], plen, finished [Dg, W, Q])``."""
    costs, plen_packed = tables
    shape = np.shape(s)
    w, r, n, d = costs.shape
    _, rows, s_d, v_d = _flat_lanes(plen_packed, t_rows,
                                    np.asarray(s, np.int32),
                                    np.asarray(valid, bool))
    c, p, f = lookup_tables_multi(costs.view(w * r, n, d),
                                  plen_packed.view(w * r, n), rows, s_d,
                                  v_d)
    return c.reshape(d, *shape), p.view(shape), f.view(shape)


# ------------------------------------------------------- worker lanes

def _place_graph(dg: DeviceGraph, dev: torch.device) -> DeviceGraph:
    """``dg`` on ``dev``: itself when it is there already, else a copy."""
    return dg if dg.device == dev else DeviceGraph(*(a.to(dev) for a in dg))


def build_fm_lanes(dg: DeviceGraph, pad, mesh, kind: str, structure,
                   max_iters: int = 0, out: torch.Tensor | None = None,
                   computes: dict | None = None) -> torch.Tensor:
    """One build chunk's target pad (int32 ``[C]``, -1-padded) built
    across the worker's lanes (``mesh``, a list of L devices): lane l
    builds the contiguous rows ``pad[l*C/L:(l+1)*C/L]`` through
    :func:`chunk_compute` on its device. Returns the int8 ``[C, N]``
    block in target order on ``dg``'s device, or writes its first
    ``len(out)`` rows into ``out`` — the contract of the single-device
    chunk compute, so the pipelined build is unchanged. Lanes whose rows
    all lie past ``len(out)`` hold only pad targets and are not run.

    ``computes``: a dict, device → build closure, kept by the caller
    across chunks; lanes on one device share one closure (one graph and
    CSR upload). ``C`` must divide by L (callers gate)."""
    lanes = len(mesh)
    pad = torch.as_tensor(np.asarray(pad, np.int32)
                          if not torch.is_tensor(pad) else pad)
    c = int(pad.shape[0])
    if c % lanes:
        raise ValueError(f"chunk {c} does not divide over {lanes} lanes")
    per = c // lanes
    res = out if out is not None else torch.empty(
        (c, dg.n), dtype=torch.int8, device=dg.device)
    rows = res.shape[0]
    computes = {} if computes is None else computes
    for lane, dev in enumerate(mesh):
        lo, hi = lane * per, min((lane + 1) * per, rows)
        if lo >= hi:
            break
        if dev not in computes:
            computes[dev] = chunk_compute(_place_graph(dg, dev),
                                          (kind, structure), max_iters)
        tg = pad[lane * per:(lane + 1) * per].to(dev)
        if res.device == dev:
            computes[dev](tg, out=res[lo:hi])
        else:
            res[lo:hi].copy_(computes[dev](tg)[:hi - lo])
    return res


def lane_walk_program(dg: DeviceGraph, fm: torch.Tensor, t_rows, s, t,
                      valid, w_pad: torch.Tensor, mesh, k_moves: int = -1,
                      max_steps: int = 0, pair: torch.Tensor | None = None,
                      placed: dict | None = None):
    """The calls of one lane-split walk: ``[(device, args, kwargs)]``,
    lane l's ``cuda_walk_batch`` call on the contiguous slice ``[l*Q/L,
    (l+1)*Q/L)`` of the flat ``[Q]`` arrays (numpy or tensors), its
    inputs on its device. :func:`walk_lanes` makes exactly these calls;
    they are split out so a caller can time each lane's launch.

    ``placed``: device → ``(dg, fm, w_pad, pair)`` copies the caller
    keeps (an engine keeps one set a distinct lane device); a lane whose
    device is not in it reads ``dg``/``fm``/``w_pad``/``pair`` there, or
    a copy when they lie elsewhere. Lanes that share a device share one
    copy. ``Q`` must divide by the lane count (callers pad)."""
    lanes = len(mesh)
    q = int(len(s))
    if q % lanes:
        raise ValueError(f"batch {q} does not divide over {lanes} lanes")
    per = q // lanes
    calls = []
    for lane, dev in enumerate(mesh):
        if placed is not None and dev in placed:
            dg_l, fm_l, w_l, p_l = placed[dev]
        else:
            dg_l, fm_l, w_l = _place_graph(dg, dev), fm.to(dev), \
                w_pad.to(dev)
            p_l = None if pair is None else pair.to(dev)
        sl = slice(lane * per, (lane + 1) * per)
        q_l = [torch.as_tensor(a[sl]).to(dev) for a in (t_rows, s, t)]
        calls.append((dev, (dg_l, fm_l, *q_l, w_l),
                      dict(valid=torch.as_tensor(valid[sl]).to(dev),
                           k_moves=k_moves, max_steps=max_steps,
                           pair=p_l)))
    return calls


def walk_lanes(dg: DeviceGraph, fm: torch.Tensor, t_rows, s, t, valid,
               w_pad: torch.Tensor, mesh, k_moves: int = -1,
               max_steps: int = 0, pair: torch.Tensor | None = None,
               placed: dict | None = None):
    """Split one worker's walk batch across its lanes
    (:func:`lane_walk_program`): flat ``[Q]`` inputs, the engine's
    length-sorted, padded batch. Each lane walks its contiguous slice in
    one ``cuda_walk_batch`` call — one B1 launch on the card, the plain
    walk on the CPU — and the answers join in lane order on the first
    lane's device. The step bound depends only on ``max_steps`` or N and
    lanes are independent, so the answers are bit-identical to one call
    over the whole batch. Returns ``(cost, plen, finished)`` ``[Q]``."""
    calls = lane_walk_program(dg, fm, t_rows, s, t, valid, w_pad, mesh,
                              k_moves=k_moves, max_steps=max_steps,
                              pair=pair, placed=placed)
    outs = [cuda_walk_batch(*args, **kw) for _dev, args, kw in calls]
    home = calls[0][0]
    return tuple(torch.cat([o[i].to(home) for o in outs])
                 for i in range(3))


# ------------------------------------------------------- campaign grid

class GridPart(NamedTuple):
    """One device's share of a campaign grid: ``workers``, the global ids
    (ascending) of the workers whose column names ``device``, whose rows
    it holds once; ``cells``, the ``[C, 2]`` ``(d, w)`` grid cells whose
    routed lanes it walks."""
    device: torch.device
    workers: np.ndarray
    cells: np.ndarray


def grid_parts(grid, workers) -> list[GridPart]:
    """The devices of a ``[D, W]`` grid's columns ``workers`` (the ones
    this process holds), each with the workers and cells it serves, in
    first-seen order of the row-major cells."""
    grid = np.asarray(grid, dtype=object)
    cells = [(d, w) for d in range(grid.shape[0]) for w in workers]
    parts = []
    for dev in distinct([grid[d, w] for d, w in cells]):
        mine = np.array([c for c in cells if canonical(grid[c]) == dev],
                        np.int64)
        parts.append(GridPart(dev, np.unique(mine[:, 1]), mine))
    return parts


def gather_cells(part: GridPart, r: int, t_rows: np.ndarray,
                 *lanes: np.ndarray):
    """``part``'s routed lanes as one worker: ``[1, 1, C·Q]`` arrays, the
    row ids offset by each cell's worker's position in ``part.workers``
    times ``r`` — the lane set of ``part``'s table viewed as one ``[1,
    Wp·R, N]`` worker."""
    d, w = part.cells[:, 0], part.cells[:, 1]
    pos = np.searchsorted(part.workers, w)
    rows = (np.asarray(t_rows, np.int64)[d, w]
            + (pos * r)[:, None]).astype(np.int32)
    return tuple(np.ascontiguousarray(a).reshape(1, 1, -1)
                 for a in (rows, *(np.asarray(x)[d, w] for x in lanes)))


def scatter_cells(part: GridPart, dst: np.ndarray, src, lead: bool = False):
    """Write ``part``'s flat answers ``src`` (``[..., 1, 1, C·Q, ...]``,
    a tensor or numpy; with ``lead`` a leading per-diff axis) into the
    routed ``dst`` ``[..., D, W, Q, ...]`` at its cells."""
    src = src.cpu().numpy() if torch.is_tensor(src) else np.asarray(src)
    d, w = part.cells[:, 0], part.cells[:, 1]
    q = dst.shape[3] if lead else dst.shape[2]
    if lead:
        src = src.reshape(src.shape[0], len(d), q, *src.shape[4:])
        dst[:, d, w] = src
    else:
        src = src.reshape(len(d), q, *src.shape[3:])
        dst[d, w] = src
