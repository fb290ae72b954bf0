"""Fast-sweeping min-plus relaxation: CPD builds in O(turns), not O(hops).

Port of the JAX package's ``ops/grid_sweep.py``. The sweep-per-hop
relaxations (``bellman_ford``, ``ell_split``, ``shift_relax``) need
~hop-diameter steps — ``O(width + height)`` on a grid city. The fast
sweeping method needs far fewer: one *cycle* runs four Gauss-Seidel
sweeps over the ``H x W`` lattice, one per quadrant ordering
(+,+), (−,−), (+,−), (−,+). A sweep visits the anti-diagonals in order,
each node reading its two in-quadrant neighbours on the diagonal before
(already updated in this sweep: Gauss-Seidel across diagonals, Jacobi
within one), so a distance propagates along a whole monotone staircase
path in one sweep. After the four sweeps comes the off-lattice
relaxation, once per cycle: the shift planes (``Graph.grid_split``'s
frequent constant offsets), all reading the pre-shift table, then the
straggler edges' scatter-min on the result. ``max_iters`` counts cycles.

Order and arithmetic follow the JAX program exactly (``grid_sweep.py``
``cycle``/``off_lattice``), so the distances agree element by element
after any number of cycles, not just at convergence. The JAX package's
skewed layout (every anti-diagonal a contiguous column, for the TPU's
scan) is not carried over: the plain torch version here walks each
diagonal's node ids through precomputed index lists. A cell's new value
depends only on its old value and its two in-quadrant neighbours' new
values, so any order that reaches a cell after those two gives the same
sweep bit for bit: the hand kernel (``csrc/cpd_build.cu``, entry
``grid_sweep_cycle``) takes the rows in order and runs a min-plus scan
along each row, one CUDA block a group of batch columns, and
:func:`sweep_quadrants_rows` is that order in plain torch.

Correctness never depends on the grid assumption, only speed does:
min-plus relaxation reaches the same fixed point under any update
order, so the result equals ``bellman_ford.dist_to_targets``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import cuda_build_kernels as cbk
from .bellman_ford import first_move_from_dist, init_dist
from .device_graph import TINF

#: quadrant order of one cycle as ``(sx, sy)``: a node's in-quadrant
#: neighbours are ``(x - sx, y)`` and ``(x, y - sy)``
QUADRANTS = ((1, 1), (-1, -1), (1, -1), (-1, 1))


class GridGraph:
    """Host-side bundle of ``Graph.grid_split`` outputs (numpy).

    ``wl``/``wr``/``wd``/``wu`` int32 ``[H, W]``: the weight of the edge
    from each node to its left/right/lower/upper lattice neighbour (INF
    when absent); ``shifts``/``w_shift`` the off-lattice shift planes;
    ``src_left``/``dst_left``/``w_left`` the straggler edge list."""

    def __init__(self, width, height, wl, wr, wd, wu, shifts, w_shift,
                 src_left, dst_left, w_left):
        self.width = int(width)
        self.height = int(height)
        n = self.width * self.height
        on_grid = sum(int((np.asarray(a) < TINF).sum())
                      for a in (wl, wr, wd, wu))
        on_shift = int((np.asarray(w_shift) < TINF).sum())
        left = int(len(np.asarray(src_left)))
        total = on_grid + on_shift + left
        self._coverage = 1.0 if total == 0 else (on_grid + on_shift) / total
        # lattice share only: what the quadrant sweeps themselves serve;
        # the auto build-method gate keys on this
        self._lattice_coverage = 0.0 if total == 0 else on_grid / total
        shape = (self.height, self.width)
        self.wl = np.asarray(wl, np.int32).reshape(shape)
        self.wr = np.asarray(wr, np.int32).reshape(shape)
        self.wd = np.asarray(wd, np.int32).reshape(shape)
        self.wu = np.asarray(wu, np.int32).reshape(shape)
        self.shifts = tuple(int(s) for s in shifts)
        self.w_shift = np.asarray(w_shift, np.int32)
        self.src_left = np.asarray(src_left, np.int32)
        self.dst_left = np.asarray(dst_left, np.int32)
        self.w_left = np.asarray(w_left, np.int32)
        self.n = n
        self._devices: dict = {}

    @classmethod
    def from_graph(cls, graph, width: int | None = None):
        split = graph.grid_split(width)
        if split is None:
            return None
        return cls(*split)

    @property
    def n_left(self) -> int:
        return int(self.src_left.shape[0])

    def coverage(self) -> float:
        return self._coverage

    def lattice_coverage(self) -> float:
        return self._lattice_coverage

    def on(self, device) -> "GridDevice":
        """The device-side arrays (built once per device)."""
        dev = torch.device(device)
        key = str(dev)
        if key not in self._devices:
            self._devices[key] = _grid_device(self, dev)
        return self._devices[key]


class GridDevice(NamedTuple):
    """A :class:`GridGraph` on one device.

    ``wl``..``wu`` int32 ``[N]`` (row-major node ids); ``w_shift`` int32
    ``[S, N]``; the straggler list as int64 ids and int32 weights;
    ``shift_csr``/``left_csr`` the same two off-lattice edge sets as CSRs
    for the hand relax kernel (None when empty); ``wpad`` int32 ``[4, H,
    Wp]``, the hand sweep kernel's weights ``wl``..``wu`` with each row
    padded with zeros to ``Wp``, the width rounded up to 4."""
    height: int
    width: int
    shifts: tuple
    wl: torch.Tensor
    wr: torch.Tensor
    wd: torch.Tensor
    wu: torch.Tensor
    w_shift: torch.Tensor
    src_left: torch.Tensor
    dst_left: torch.Tensor
    w_left: torch.Tensor
    shift_csr: object
    left_csr: object
    wpad: torch.Tensor
    #: the plain sweep's per-quadrant diagonal index lists (built at use)
    diagonals: dict

    @property
    def n(self) -> int:
        return self.height * self.width

    @property
    def device(self) -> torch.device:
        return self.wl.device


def _grid_device(gg: GridGraph, dev: torch.device) -> GridDevice:
    n = gg.n
    # shift planes as an edge list: edge u -> u + s wherever the plane
    # holds a weight (an INF slot has no edge and relaxes nothing)
    srcs, dsts, ws = [], [], []
    for si, s in enumerate(gg.shifts):
        u = np.nonzero(gg.w_shift[si] < TINF)[0]
        srcs.append(u)
        dsts.append(u + s)
        ws.append(gg.w_shift[si][u])
    shift_csr = None
    if gg.shifts and sum(len(u) for u in srcs):
        shift_csr = cbk.csr_from_edges(np.concatenate(srcs),
                                       np.concatenate(dsts),
                                       np.concatenate(ws), n, dev)
    left_csr = None
    if gg.n_left:
        left_csr = cbk.csr_from_edges(gg.src_left, gg.dst_left, gg.w_left,
                                      n, dev)

    def flat(a):
        return torch.as_tensor(a.reshape(-1), dtype=torch.int32, device=dev)

    wpad = np.zeros((4, gg.height, -(-gg.width // 4) * 4), np.int32)
    wpad[:, :, :gg.width] = np.stack([gg.wl, gg.wr, gg.wd, gg.wu])

    return GridDevice(
        height=gg.height, width=gg.width, shifts=gg.shifts,
        wl=flat(gg.wl), wr=flat(gg.wr), wd=flat(gg.wd), wu=flat(gg.wu),
        w_shift=torch.as_tensor(gg.w_shift, dtype=torch.int32, device=dev),
        src_left=torch.as_tensor(gg.src_left, device=dev).long(),
        dst_left=torch.as_tensor(gg.dst_left, device=dev).long(),
        w_left=torch.as_tensor(gg.w_left, dtype=torch.int32, device=dev),
        shift_csr=shift_csr, left_csr=left_csr,
        wpad=torch.as_tensor(wpad, device=dev), diagonals={})


def _diagonals(gd: GridDevice, sx: int, sy: int):
    """Per anti-diagonal of quadrant ``(sx, sy)``, in sweep order:
    ``(ids, same, cross, w_same, w_cross)`` — the diagonal's node ids,
    their same-row and cross-row neighbours' ids (``N``, the INF pad row,
    off the lattice) and the two edge weights."""
    if (sx, sy) in gd.diagonals:
        return gd.diagonals[sx, sy]
    h, w, n = gd.height, gd.width, gd.n
    ys, xs = np.divmod(np.arange(n, dtype=np.int64), w)
    tx = xs if sx > 0 else w - 1 - xs          # quadrant-local coords
    ty = ys if sy > 0 else h - 1 - ys
    ids = np.arange(n, dtype=np.int64)
    same = np.where(tx >= 1, ids - sx, n)
    cross = np.where(ty >= 1, ids - sy * w, n)
    key_j = tx + ty
    order = np.argsort(key_j, kind="stable")
    bounds = np.searchsorted(key_j[order], np.arange(h + w))
    w_same = gd.wl if sx > 0 else gd.wr
    w_cross = gd.wd if sy > 0 else gd.wu
    dev = gd.device
    diags = []
    for j in range(h + w - 1):
        sel = order[bounds[j]:bounds[j + 1]]
        t_ids = torch.as_tensor(ids[sel], device=dev)
        diags.append((t_ids, torch.as_tensor(same[sel], device=dev),
                      torch.as_tensor(cross[sel], device=dev),
                      w_same[t_ids][:, None], w_cross[t_ids][:, None]))
    gd.diagonals[sx, sy] = diags
    return diags


def sweep_quadrants(gd: GridDevice, d: torch.Tensor) -> torch.Tensor:
    """The four quadrant sweeps of one cycle on ``d`` int32 ``[N, B]``,
    in place, plain torch. Returns a bool tensor: any value fell."""
    n, b = d.shape
    dp = torch.cat([d, torch.full((1, b), TINF, dtype=d.dtype,
                                  device=d.device)])
    fell = torch.zeros((), dtype=torch.bool, device=d.device)
    for sx, sy in QUADRANTS:
        for ids, same, cross, ws, wc in _diagonals(gd, sx, sy):
            cur = dp.index_select(0, ids)
            via_s = dp.index_select(0, same).add_(ws).clamp_max_(TINF)
            via_c = dp.index_select(0, cross).add_(wc).clamp_max_(TINF)
            new = torch.minimum(cur, torch.minimum(via_s, via_c))
            fell |= (new < cur).any()
            dp.index_copy_(0, ids, new)
    d.copy_(dp[:n])
    return fell


def min_plus_then(first, then):
    """``then ∘ first`` of two maps ``v -> min(A, W + v)`` given as
    ``(A, W)``: ``(min(A2, W2 + A1), min(W2 + W1, INF))``. With every
    ``A`` and ``W`` at most INF the sums fit int32, and saturating ``W``
    is exact on values at most INF (a term past INF never beats ``A``),
    so the combine is associative on that domain."""
    a1, w1 = first
    a2, w2 = then
    return torch.minimum(a2, w2 + a1), (w2 + w1).clamp_max(TINF)


def row_scan(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``new[X] = min(a[X], w[X] + new[X - 1])`` along dim 0 (nothing
    left of ``X = 0``), as a log-depth inclusive scan of the maps
    ``v -> min(a[X], w[X] + v)`` under :func:`min_plus_then`, applied
    to INF. ``a`` ``[X, B]``, ``w`` ``[X, 1]``, both at most INF."""
    acc, wt = a.clone(), w.clone()
    off = 1
    while off < acc.shape[0]:
        a2, w2 = min_plus_then((acc[:-off], wt[:-off]),
                               (acc[off:], wt[off:]))
        acc = torch.cat([acc[:off], a2])
        wt = torch.cat([wt[:off], w2])
        off *= 2
    return acc


def sweep_quadrants_rows(gd: GridDevice, d: torch.Tensor,
                         piece: int | None = None) -> torch.Tensor:
    """The four quadrant sweeps of one cycle in the hand kernel's order,
    plain torch, in place: a sweep takes the columns ``[k * piece, (k +
    1) * piece)`` in ``sx`` order (None: the whole row), and in each the
    rows in ``sy`` order, each cell's ``a = min(old, min(w_cross + new
    above, INF))``, then :func:`row_scan` along the piece's row in ``sx``
    order from the new value of the cell before the piece (INF where
    there is none). The same values as :func:`sweep_quadrants`; returns a
    bool tensor: any value fell."""
    h, w = gd.height, gd.width
    b = d.shape[1]
    piece = piece or w
    grid = d.view(h, w, b)
    fell = torch.zeros((), dtype=torch.bool, device=d.device)
    starts = range(0, w, piece)
    for sx, sy in QUADRANTS:
        w_same = (gd.wl if sx > 0 else gd.wr).view(h, w)
        w_cross = (gd.wd if sy > 0 else gd.wu).view(h, w)
        for a0 in (starts if sx > 0 else reversed(starts)):
            cols = slice(a0, min(a0 + piece, w))
            edge = a0 - 1 if sx > 0 else cols.stop   # the cell before

            def local(row):   # quadrant-local column order
                return row if sx > 0 else row.flip(0)

            above = torch.full((cols.stop - a0, b), TINF, dtype=d.dtype,
                               device=d.device)
            for yy in range(h):
                y = yy if sy > 0 else h - 1 - yy
                old = local(grid[y, cols])
                a = torch.minimum(old, (local(w_cross[y, cols])[:, None]
                                        + above).clamp_max(TINF))
                ws = local(w_same[y, cols])[:, None]
                if 0 <= edge < w:
                    # the cell before enters as a map with A = its value
                    a[0] = torch.minimum(a[0], (ws[0] + grid[y, edge])
                                         .clamp_max(TINF))
                new = row_scan(a, ws)
                fell |= (new < old).any()
                grid[y, cols] = local(new)
                above = new
    return fell


def off_lattice(gd: GridDevice, d: torch.Tensor) -> torch.Tensor:
    """Shift planes (all reading the pre-shift table) then the straggler
    scatter-min (reading the post-shift table), plain torch, as the JAX
    ``off_lattice``. Returns the new ``[N, B]`` table."""
    n = gd.n
    if gd.shifts:
        pad = max(abs(s) for s in gd.shifts)
        inf_rows = torch.full((pad, d.shape[1]), TINF, dtype=d.dtype,
                              device=d.device)
        dp = torch.cat([inf_rows, d, inf_rows])
        acc = d.clone()
        for si, s in enumerate(gd.shifts):
            sh = dp[pad + s: pad + s + n] + gd.w_shift[si][:, None]
            torch.minimum(acc, sh.clamp_max_(TINF), out=acc)
        d = acc
    if gd.src_left.numel():
        via = d.index_select(0, gd.dst_left).add_(
            gd.w_left[:, None]).clamp_max_(TINF)
        d = d.clone()
        d.scatter_reduce_(0, gd.src_left[:, None].expand_as(via), via, "amin")
    return d


def dist_to_targets_sweep(gg: GridGraph, targets,
                          max_iters: int = 0) -> torch.Tensor:
    """int32 [B, N] of d(x → targets[b]) by fast sweeping, plain torch:
    the reference the hand kernel is held against. ``max_iters`` bounds
    the CYCLE count (each cycle = 4 quadrant sweeps + 1 off-lattice
    relaxation); 0 = converge (bounded by N-1 as in JAX). On the
    targets' device."""
    targets = torch.as_tensor(targets, dtype=torch.int32)
    gd = gg.on(targets.device)
    limit = (gg.n - 1) if max_iters == 0 else max_iters
    d = init_dist(gg.n, targets)
    changed = bool((d < TINF).any())
    i = 0
    while changed and i < limit:
        before = d.clone()
        sweep_quadrants(gd, d)
        d = off_lattice(gd, d)
        changed = bool((d < before).any())
        i += 1
    return d.T.contiguous()


def build_fm_columns_sweep(dg, gg: GridGraph, targets, max_iters: int = 0,
                           csr=None, out: torch.Tensor | None = None,
                           dist_out: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """CPD build via fast sweeping + the shared first-move extraction:
    int8 ``[B, N]``. On the CPU the plain sweep and extraction; on the
    card the hand sweep kernel, the hand relax kernel for the off-lattice
    edges and the hand extraction kernel (``csr``: the full out-edge CSR
    the extraction reads, built from ``dg`` when None). ``dist_out``:
    ``cuda_build_kernels.write_dists``."""
    targets = torch.as_tensor(targets, dtype=torch.int32, device=dg.device)
    if dg.device.type == "cpu":
        dist = dist_to_targets_sweep(gg, targets, max_iters)
        cbk.write_dists(dist, dist_out)
        return cbk.write_rows(first_move_from_dist(dg, targets, dist), out)
    dist_nb, _ = cbk.sweep_dist(gg.on(dg.device), targets, max_iters)
    cbk.write_dists(dist_nb.T, dist_out)
    return cbk.first_moves(dg, targets, dist_nb, csr=csr, out=out)
