"""The CPD build's hand-written CUDA kernels and the loops that drive them.

Source: ``csrc/cpd_build.cu``, built with ``nvcc`` at first use
(``utils.cuda_build``) and called through plain C entry points with
``ctypes``. Three kernels, each with its wrapper here:

* :func:`relax_jacobi` (K1) — one Jacobi min-plus step over a CSR edge
  set, into a second buffer, raising a device flag when any distance
  fell. Over the graph's full out-edge CSR (:func:`csr_from_ell`) it is
  one step of the ``ell``, ``ellsplit`` and ``shift`` builds, which all
  compute this same iterate; over the grid's shift-plane and straggler
  edge sets it is the fast sweep's off-lattice stage (two launches).
  It visits the nodes in the CSR's breadth-first visit order
  (:func:`visit_order`), so the rows it gathers stay in L2. Given a
  changed map (one byte per column group and node, where the step
  before lowered a value) it skips the settled (node, group) pairs,
  gathers only the neighbours that changed, and writes the map of its
  own step: the same iterate, exactly;
* :func:`first_moves` (K2) — the first-move extraction of
  ``bellman_ford.first_move_from_dist``, from ``[N, B]`` distances into
  int8 ``[B, N]`` rows (optionally straight into a larger table), by
  node id through a shared-memory transpose;
* :func:`grid_sweep` (K3) — fast-sweeping cycles' four quadrant sweeps,
  in place: rows in order, a min-plus scan along each row, a row wider
  than a block's shared memory in pieces
  (:func:`grid_sweep.sweep_quadrants_rows` is its plain twin), one block
  a column group; on a lattice with no off-lattice edges a launch runs
  each group's cycles to its own convergence.

Every wrapper picks by the device its tensors lie on, as the walk does:
CPU tensors take the plain torch version of the same function (how the
CPU tests run it), CUDA tensors launch the kernel or raise — no fallback
from a failed build or launch. Each launch adds one to the wrapper's
``launches`` count, and nothing else does; each call on CPU tensors adds
one to its ``plain`` count (``utils.counts.bump``: exact under threads).
:func:`jacobi_dist` adds the (node, column group) pairs K1 relaxed to
``relax_jacobi.active_pairs``, on the card and on the CPU alike.

The build's host phases are ``obs.trace`` spans, recorded while a
``torch.profiler`` session (or ``--trace``) is on: ``build.csr`` (the
CSR and its visit order), ``build.relax`` (a loop, with its ``steps``),
in it ``build.step_launch`` (the host's work from one flag read to the
next launch) and ``build.flag_read`` a step, and ``build.first_moves``.

:func:`jacobi_dist` and :func:`sweep_dist` are the host loops with the
JAX ``while_loop`` semantics (``while changed and i < limit``), reading
the flag after every step or cycle (:func:`jacobi_dist` skips settled
tiles through the changed map, and its CPU branch runs the same
bookkeeping with :func:`relax_work_set`; :func:`sweep_dist` on a
lattice-only graph makes one launch and reads the cycle count it
returns); :func:`build_fm_jacobi` is the card's
``ell``/``ellsplit``/``shift`` build.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .bellman_ford import first_move_from_dist, init_dist
from .device_graph import DeviceGraph, TINF
from ..obs import trace as obs_trace
from ..utils.counts import bump

#: the CUDA source (``csrc/<KERNEL_NAME>.cu``)
KERNEL_NAME = "cpd_build"
#: its entry points
RELAX_ENTRY = "relax_jacobi"
FIRST_MOVES_ENTRY = "first_moves"
SWEEP_ENTRY = "grid_sweep_cycle"
#: columns a sweep block may own, one warp a column (``cols`` in the
#: source); one, the default, measured fastest (independent chains,
#: several blocks resident an SM)
SWEEP_COLS = (1, 2, 4, 8)
#: columns a relax lane may own (``V`` in the source); a warp's column
#: group, the changed map's tile, is ``32 * vec`` columns
RELAX_VECS = (4, 2, 1)
#: the relax kernel's active-pair counters (``kActiveSlots`` x
#: ``kActiveStride`` uint64 in the source; slot s is ``[s, 0]``)
ACTIVE_SLOTS = 64
ACTIVE_STRIDE = 16

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    RELAX_ENTRY: [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _LL, _I, _I,
                  _P],
    FIRST_MOVES_ENTRY: [_P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _P],
    SWEEP_ENTRY: [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
}
_fns: dict[str, object] = {}


def _kernel(entry: str):
    """The loaded C entry point ``entry`` (the source is built on the
    first call; a failed build raises)."""
    if entry not in _fns:
        from ..utils.cuda_build import load_library

        fn = getattr(load_library(KERNEL_NAME), entry)
        fn.argtypes = _ARGTYPES[entry]
        fn.restype = ctypes.c_int
        _fns[entry] = fn
    return _fns[entry]


def _launch(entry: str, dev: torch.device, *args) -> None:
    fn = _kernel(entry)
    with torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")


def _check(name: str, x: torch.Tensor, dtype: torch.dtype, shape,
           device: torch.device) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _on_cuda(x: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no {what} for tensors on {x.device}")


# ------------------------------------------------------------------ CSR

class EdgeCSR(NamedTuple):
    """A directed edge set by source node, int32 on one device:
    ``row_ptr [N + 1]``, ``col [M]`` (destinations), ``wt [M]``; and
    optionally the order K1 visits the nodes in, ``order [N]`` (a
    permutation, :func:`visit_order`) with ``span [N, 2]``, the out-edge
    range ``[begin, end)`` of node ``order[s]`` (None: by id)."""
    row_ptr: torch.Tensor
    col: torch.Tensor
    wt: torch.Tensor
    order: torch.Tensor | None = None
    span: torch.Tensor | None = None

    @property
    def n(self) -> int:
        return self.row_ptr.shape[0] - 1

    @property
    def device(self) -> torch.device:
        return self.row_ptr.device

    def sources(self) -> torch.Tensor:
        """int64 ``[M]``: each edge's source node."""
        deg = self.row_ptr[1:] - self.row_ptr[:-1]
        return torch.repeat_interleave(
            torch.arange(self.n, device=self.device), deg.long())


def visit_order(row_ptr: np.ndarray, col: np.ndarray) -> np.ndarray:
    """int32 ``[N]``: the nodes breadth first over the out-edges from node
    0, then those it did not reach, by id. Consecutive nodes in this
    order sit a few hops apart, so the relax kernel's warps in flight
    gather from a small band of rows, whatever the node ids."""
    n = len(row_ptr) - 1
    seen = np.zeros(n, bool)
    front = np.zeros(min(n, 1), np.int64)
    seen[front] = True
    levels = []
    while front.size:
        levels.append(front)
        lo = row_ptr[front]
        cnt = row_ptr[front + 1] - lo
        at = np.repeat(lo - np.cumsum(cnt) + cnt, cnt) + np.arange(cnt.sum())
        nxt = np.unique(col[at])
        front = nxt[~seen[nxt]]
        seen[front] = True
    levels.append(np.flatnonzero(~seen))
    return np.concatenate(levels).astype(np.int32)


def csr_from_ell(dg: DeviceGraph) -> EdgeCSR:
    """The full out-edge CSR of ``dg``'s ELL tables, on its device, in
    ELL slot order (edge ``row_ptr[x] + k`` is slot ``k`` of node x, so
    the extraction's slot numbers are the ELL's), with its visit order
    (computed on the host). One ``build.csr`` span."""
    with obs_trace.span("build.csr"):
        pad_eid = dg.w_pad.shape[0] - 1
        real = dg.out_eid != pad_eid      # real slots come first in a row
        col = dg.out_nbr[real].contiguous()
        row_ptr = np.zeros(dg.n + 1, np.int64)
        np.cumsum(real.sum(dim=1).cpu().numpy(), out=row_ptr[1:])
        order = visit_order(row_ptr, col.cpu().numpy())
        span = np.stack([row_ptr[order], row_ptr[order + 1]], axis=1)

        def up(a):
            return torch.as_tensor(a.astype(np.int32), device=dg.device)

        return EdgeCSR(row_ptr=up(row_ptr), col=col,
                       wt=dg.w_pad[dg.out_eid[real].long()].contiguous(),
                       order=up(order), span=up(span))


def csr_from_edges(src, dst, w, n: int, device) -> EdgeCSR:
    """CSR of an edge list (numpy), sorted by source (stable)."""
    src = np.asarray(src, np.int64)
    order = np.argsort(src, kind="stable")
    row_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(src, minlength=n), out=row_ptr[1:])

    def up(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.int32),
                               device=device)

    return EdgeCSR(row_ptr=up(row_ptr), col=up(np.asarray(dst)[order]),
                   wt=up(np.asarray(w)[order]))


# -------------------------------------------------------------- kernels

def relax_jacobi_plain(csr: EdgeCSR, d: torch.Tensor) -> torch.Tensor:
    """The plain torch K1: one Jacobi step over the CSR's edges."""
    nd = d.clone()
    if csr.col.numel():
        via = d.index_select(0, csr.col.long()).add_(
            csr.wt[:, None]).clamp_max_(TINF)
        nd.scatter_reduce_(0, csr.sources()[:, None].expand_as(via), via,
                           "amin")
    return nd


def relax_vec(b: int) -> int:
    """Columns a relax lane owns for ``b``-column distances: the widest of
    :data:`RELAX_VECS` that divides ``b`` and leaves the warp's column
    group at least half full (``b > 16 * vec``), else 1 — 4 at the
    build's 512- and 8,192-column chunks."""
    return next((v for v in RELAX_VECS if b % v == 0 and b > 16 * v), 1)


def relax_groups(b: int, cols: int) -> int:
    """Column groups (changed-map rows) of a ``b``-column step."""
    return -(-b // cols)


def tile_changed(fell: torch.Tensor, cols: int) -> torch.Tensor:
    """uint8 ``[T, N]`` changed map of a bool ``[N, B]`` ``fell``: 1 where
    any column of the node's ``cols``-column group is set."""
    n, b = fell.shape
    pad = relax_groups(b, cols) * cols - b
    grouped = torch.nn.functional.pad(fell, (0, pad)).view(n, -1, cols)
    return grouped.any(dim=2).T.to(torch.uint8).contiguous()


def target_map(n: int, targets: torch.Tensor, cols: int) -> torch.Tensor:
    """The changed map of the first step: each valid target's node in its
    column's group (where the starting iterate differs from all-INF)."""
    b = targets.shape[0]
    chg = torch.zeros((relax_groups(b, cols), n), dtype=torch.uint8,
                      device=targets.device)
    valid = targets >= 0
    at = torch.arange(b, device=targets.device)[valid]
    chg[at // cols, targets[valid].long()] = 1
    return chg


def _by_column(x: torch.Tensor, cols: int, b: int) -> torch.Tensor:
    """``[T, K]`` per column group → ``[K, B]`` per column."""
    return x.T.repeat_interleave(cols, dim=1)[:, :b]


def relax_work_set(csr: EdgeCSR, chg: torch.Tensor) -> torch.Tensor:
    """bool ``[T, N]``: the (group, node) pairs a step must relax after
    the step that wrote the changed map ``chg`` (uint8 ``[T, N]``) — the
    node itself or one of its out-neighbours changed in that group."""
    act = chg.to(torch.int32)
    if csr.col.numel():
        act.index_add_(1, csr.sources(), act[:, csr.col.long()])
    return act > 0


def relax_changed_plain(csr: EdgeCSR, d: torch.Tensor, chg: torch.Tensor,
                        cols: int) -> torch.Tensor:
    """The plain step over the edges whose destination changed in the
    column's group (``chg``, the previous step's map): where the map
    holds for ``d``'s step, the same iterate as :func:`relax_jacobi_plain`
    (an unchanged ``w + d[v]`` is at least ``d[x]`` already)."""
    nd = d.clone()
    if csr.col.numel():
        dst = csr.col.long()
        via = d.index_select(0, dst).add_(csr.wt[:, None]).clamp_max_(TINF)
        via.masked_fill_(_by_column(chg[:, dst], cols, d.shape[1]) == 0,
                         TINF)
        nd.scatter_reduce_(0, csr.sources()[:, None].expand_as(via), via,
                           "amin")
    return nd


def _relax_cpu(csr: EdgeCSR, d: torch.Tensor, out: torch.Tensor,
               flag: torch.Tensor, chg_prev, chg_cur, active,
               cols: int) -> torch.Tensor:
    """The CPU branch of :func:`relax_jacobi`, with the kernel's
    bookkeeping: the work set is written, the rest of ``out`` kept."""
    n, b = d.shape
    if chg_prev is None:
        nd = relax_jacobi_plain(csr, d)
        act = torch.ones((relax_groups(b, cols), n), dtype=torch.bool)
    else:
        nd = relax_changed_plain(csr, d, chg_prev, cols)
        act = relax_work_set(csr, chg_prev)
    cell = _by_column(act, cols, b)
    torch.where(cell, nd, out, out=out)
    fell = (nd < d) & cell
    if bool(fell.any()):
        flag.fill_(1)
    if chg_cur is not None:
        chg_cur.copy_(tile_changed(fell, cols))
    if active is not None:
        active[0, 0] += int(act.sum())
    return out


def _pick_vec(d: torch.Tensor, out: torch.Tensor, vec) -> int:
    """The caller's ``vec``, or :func:`relax_vec`'s narrowed until both
    buffers on the card are aligned for it."""
    b = d.shape[1] if d.dim() == 2 else -1
    if vec is None:
        vec = relax_vec(b)
        while d.is_cuda and (d.data_ptr() | out.data_ptr()) % (4 * vec):
            vec //= 2
    if vec not in RELAX_VECS or b % vec:
        raise ValueError(f"vec must be one of {RELAX_VECS} and divide "
                         f"B = {b}, got {vec}")
    return vec


def relax_jacobi(csr: EdgeCSR, d: torch.Tensor, out: torch.Tensor,
                 flag: torch.Tensor, chg_prev: torch.Tensor | None = None,
                 chg_cur: torch.Tensor | None = None,
                 active: torch.Tensor | None = None,
                 vec: int | None = None) -> torch.Tensor:
    """K1: ``out = min(d, min over edges (w + d[dst]))`` for int32
    ``[N, B]`` ``d`` and ``out`` (distinct buffers); sets ``flag[0] = 1``
    (int32 ``[1]``) when any value fell. Returns ``out``.

    ``vec``: columns a lane owns (None → :func:`relax_vec`); the column
    group is ``32 * vec`` columns. The kernel visits the nodes in
    ``csr.order`` where it is set. ``chg_prev``: the previous step's
    uint8 ``[T, N]`` changed map (``T = relax_groups(B, 32 * vec)``);
    with it the step relaxes only :func:`relax_work_set`'s pairs, over
    the edges whose destination changed (:func:`relax_changed_plain`),
    and leaves ``out`` as it is elsewhere — exact when ``d`` is the step
    after ``out``'s iterate and ``chg_prev`` that step's map (the loop's
    two buffers); None relaxes every pair over every edge. ``chg_cur``:
    receives this step's changed map. ``active``: int64
    ``[ACTIVE_SLOTS, ACTIVE_STRIDE]`` counters; the step adds the pairs
    it relaxed (their sum over ``[:, 0]``)."""
    n = csr.n
    b = d.shape[1] if d.dim() == 2 else -1
    on_cuda = _on_cuda(d, "relax")
    vec = _pick_vec(d, out, vec)
    if not on_cuda:
        bump(relax_jacobi, "plain")
        return _relax_cpu(csr, d, out, flag, chg_prev, chg_cur, active,
                          32 * vec)
    dev = d.device
    _check("d", d, torch.int32, (n, b), dev)
    _check("out", out, torch.int32, (n, b), dev)
    _check("flag", flag, torch.int32, (1,), dev)
    _check("row_ptr", csr.row_ptr, torch.int32, (n + 1,), dev)
    m = csr.col.shape[0]
    _check("col", csr.col, torch.int32, (m,), dev)
    _check("wt", csr.wt, torch.int32, (m,), dev)
    if d.data_ptr() == out.data_ptr():
        raise ValueError("relax_jacobi writes a second buffer: out is d")
    if (d.data_ptr() | out.data_ptr()) % (4 * vec):
        raise ValueError(f"d and out must be {4 * vec}-byte aligned for "
                         f"vec = {vec}")
    if csr.order is not None:
        _check("order", csr.order, torch.int32, (n,), dev)
        _check("span", csr.span, torch.int32, (n, 2), dev)
    groups = relax_groups(b, 32 * vec)
    for name, chg in (("chg_prev", chg_prev), ("chg_cur", chg_cur)):
        if chg is not None:
            _check(name, chg, torch.uint8, (groups, n), dev)
    if chg_prev is not None and chg_cur is not None and \
            chg_prev.data_ptr() == chg_cur.data_ptr():
        raise ValueError("chg_cur must be another buffer than chg_prev")
    if active is not None:
        _check("active", active, torch.int64, (ACTIVE_SLOTS, ACTIVE_STRIDE),
               dev)

    def ptr(x):
        return None if x is None else x.data_ptr()

    _launch(RELAX_ENTRY, dev, csr.row_ptr.data_ptr(), csr.col.data_ptr(),
            csr.wt.data_ptr(), ptr(csr.order), ptr(csr.span), d.data_ptr(),
            out.data_ptr(), flag.data_ptr(), ptr(chg_prev), ptr(chg_cur),
            ptr(active), n, b, vec)
    bump(relax_jacobi, "launches")
    return out


def active_counter(device) -> torch.Tensor:
    """Zeroed counters for :func:`relax_jacobi`'s ``active``."""
    return torch.zeros((ACTIVE_SLOTS, ACTIVE_STRIDE), dtype=torch.int64,
                       device=device)


def write_rows(fm: torch.Tensor, out: torch.Tensor | None) -> torch.Tensor:
    """``fm`` itself, or its first ``len(out)`` rows copied into ``out``."""
    if out is None:
        return fm
    return out.copy_(fm[:out.shape[0]])


def write_dists(dist_bn: torch.Tensor, dist_out: torch.Tensor | None
                ) -> None:
    """Copy the first ``len(dist_out)`` rows of ``[B, N]`` distances (on
    the card a transposed view of the relax loop's node-major ``[N, B]``
    table) into the int32 ``[R, N]`` rows ``dist_out``; nothing when
    None."""
    if dist_out is not None:
        dist_out.copy_(dist_bn[:dist_out.shape[0]])


def _fm_vec(dist_nb: torch.Tensor, targets: torch.Tensor) -> int:
    """K2's columns a lane: :func:`relax_vec`'s, narrowed until the
    distances and the targets on the card are aligned for it."""
    vec = relax_vec(dist_nb.shape[1])
    while (dist_nb.data_ptr() | targets.data_ptr()) % (4 * vec):
        vec //= 2
    return vec


def first_moves(dg: DeviceGraph, targets: torch.Tensor,
                dist_nb: torch.Tensor, csr: EdgeCSR | None = None,
                out: torch.Tensor | None = None) -> torch.Tensor:
    """K2: int8 ``[B, N]`` first moves from int32 ``[N, B]`` distances
    (``bellman_ford.first_move_from_dist``'s rule). ``csr``: ``dg``'s
    full out-edge CSR (built here when None). ``out``: an int8
    ``[R, N]`` row block (``R <= B``, rows contiguous — e.g. a slice of a
    whole-index table) that receives the first ``R`` rows; returns it,
    else a new ``[B, N]`` tensor. A lane owns :func:`relax_vec`'s
    columns, narrowed to the alignment."""
    n = dg.n
    if not _on_cuda(dist_nb, "first-move extraction"):
        bump(first_moves, "plain")
        return write_rows(first_move_from_dist(dg, targets, dist_nb.T), out)
    dev = dist_nb.device
    b = dist_nb.shape[1] if dist_nb.dim() == 2 else -1
    _check("dist", dist_nb, torch.int32, (n, b), dev)
    _check("targets", targets, torch.int32, (b,), dev)
    if out is None:
        out = torch.empty((b, n), dtype=torch.int8, device=dev)
    if out.dim() != 2 or out.shape[0] > b:
        raise ValueError(f"out must be [R <= {b}, {n}], got "
                         f"{tuple(out.shape)}")
    _check("out", out, torch.int8, (out.shape[0], n), dev)
    if csr is None:
        csr = csr_from_ell(dg)
    _check("row_ptr", csr.row_ptr, torch.int32, (n + 1,), dev)
    vec = _fm_vec(dist_nb, targets)
    _launch(FIRST_MOVES_ENTRY, dev, csr.row_ptr.data_ptr(),
            csr.col.data_ptr(), csr.wt.data_ptr(), dist_nb.data_ptr(),
            targets.data_ptr(), out.data_ptr(), n, b, out.shape[0], vec)
    bump(first_moves, "launches")
    return out


def _sweep_cpu(gd, d: torch.Tensor, flag: torch.Tensor, cycles: int,
               counter, cols: int) -> None:
    """The CPU branch of :func:`grid_sweep`, with the kernel's per-group
    loop: each group of ``cols`` columns runs cycles until one lowers none
    of its values or the cap (a cycle runs on the groups still active
    only); ``counter`` receives the largest count."""
    from .grid_sweep import sweep_quadrants

    b = d.shape[1]
    group = torch.arange(b) // cols
    ran = torch.zeros(-(-b // cols), dtype=torch.int64)
    active = torch.ones_like(ran, dtype=torch.bool)
    for c in range(1, cycles + 1):
        live = active[group].nonzero().flatten().to(d.device)
        part = d.index_select(1, live)
        before = part.clone()
        sweep_quadrants(gd, part)
        d.index_copy_(1, live, part)
        fell = torch.zeros_like(active)
        fell.index_put_((group[live.cpu()],),
                        (part < before).any(dim=0).cpu(), accumulate=True)
        ran[active] = c
        if bool(fell.any()):
            flag.fill_(1)
        active &= fell
        if not bool(active.any()):
            break
    if counter is not None:
        counter.fill_(max(int(counter.item()), int(ran.max())))


def grid_sweep(gd, d: torch.Tensor, flag: torch.Tensor, *, cycles: int = 1,
               counter: torch.Tensor | None = None,
               cols: int = 1) -> torch.Tensor:
    """K3: fast-sweeping cycles' four quadrant sweeps on int32 ``[N, B]``
    ``d``, in place (``gd``: ``grid_sweep.GridDevice``); sets ``flag[0] =
    1`` when any value fell. Each group of ``cols`` columns (one of
    :data:`SWEEP_COLS`) runs up to ``cycles`` cycles and stops after the
    first that lowers none of its values — the batch loop's iterate for a
    lattice with no off-lattice edges, since a converged group is a fixed
    point of a cycle. ``counter`` (int32 ``[1]``): raised to the largest
    count of cycles a group ran. A block sweeps its ``cols`` columns one
    warp a column (a few for a wide row; a row wider than its shared
    memory in pieces, at any width). On the card the launch copies ``d``
    into a column-major int32 ``[B, H, Wp]`` buffer (``Wp``: the width
    rounded up to 4), sweeps there and copies back: three kernels, one
    count. Returns ``d``."""
    b = d.shape[1] if d.dim() == 2 else -1
    if cols not in SWEEP_COLS or b % cols:
        raise ValueError(f"cols must be one of {SWEEP_COLS} and divide "
                         f"B = {b}, got {cols}")
    if cycles < 1:
        raise ValueError(f"cycles must be at least 1, got {cycles}")
    if not _on_cuda(d, "grid sweep"):
        bump(grid_sweep, "plain")
        _sweep_cpu(gd, d, flag, cycles, counter, cols)
        return d
    dev = d.device
    n = gd.n
    _check("d", d, torch.int32, (n, b), dev)
    _check("flag", flag, torch.int32, (1,), dev)
    if counter is not None:
        _check("counter", counter, torch.int32, (1,), dev)
    h, w = gd.height, gd.width
    wp = -(-w // 4) * 4
    _check("wpad", gd.wpad, torch.int32, (4, h, wp), dev)
    transposed = torch.empty((b, h, wp), dtype=torch.int32, device=dev)
    _launch(SWEEP_ENTRY, dev, gd.wpad.data_ptr(), d.data_ptr(),
            transposed.data_ptr(), flag.data_ptr(),
            None if counter is None else counter.data_ptr(),
            h, w, b, cols, cycles)
    bump(grid_sweep, "launches")
    return d


relax_jacobi.launches = 0
first_moves.launches = 0
grid_sweep.launches = 0
relax_jacobi.plain = 0
relax_jacobi.active_pairs = 0
first_moves.plain = 0
grid_sweep.plain = 0


# ---------------------------------------------------------------- loops

def jacobi_dist(csr: EdgeCSR, targets: torch.Tensor, max_iters: int = 0,
                *, skip: bool = True, vec: int | None = None,
                stats: dict | None = None) -> tuple[torch.Tensor, int]:
    """``([N, B] distances, steps)``: Jacobi steps of :func:`relax_jacobi`
    over ``csr`` while a step lowers a distance and fewer than ``limit``
    steps ran (``max_iters``, 0 = N-1) — the JAX loop, the same iterate
    at every cut. The flag is read after every step.

    ``skip``: pass each step the changed map of the step before (the
    first step that of the starting iterate, :func:`target_map`), so only
    the work set is relaxed; the second buffer then starts as a copy of
    the starting iterate. ``vec``: columns a lane owns (None →
    :func:`relax_vec`). ``stats``: a dict that receives ``steps``,
    ``vec``, ``groups`` (changed-map rows of ``32 * vec`` columns),
    ``active_pairs`` (the (node, group) pairs relaxed, summed over the
    steps) and ``pairs_per_step`` (N x groups). The pairs are added to
    ``relax_jacobi.active_pairs`` whether or not ``stats`` is given: one
    reduction a call, read after the loop's last flag read."""
    n = csr.n
    limit = (n - 1) if max_iters == 0 else max_iters
    d = init_dist(n, targets)
    if not bool((targets >= 0).any()):
        return d, 0
    spare = d.clone() if skip else torch.empty_like(d)
    vec = _pick_vec(d, spare, vec)
    groups = relax_groups(d.shape[1], 32 * vec)
    if skip:
        prev = target_map(n, targets, 32 * vec)
        cur = torch.empty_like(prev)
    else:
        prev = cur = None
    flag = torch.zeros(1, dtype=torch.int32, device=d.device)
    active = active_counter(d.device)
    i = 0
    with obs_trace.span("build.relax") as relax:
        while i < limit:
            with obs_trace.span("build.step_launch"):
                flag.zero_()
                relax_jacobi(csr, d, spare, flag, prev, cur, active, vec)
            d, spare = spare, d
            if skip:
                prev, cur = cur, prev
            i += 1
            with obs_trace.span("build.flag_read"):
                if not bool(flag.item()):
                    break
        relax.set(steps=i)
    pairs = int(active[:, 0].sum())
    bump(relax_jacobi, "active_pairs", pairs)
    if stats is not None:
        stats.update(steps=i, vec=vec, groups=groups, active_pairs=pairs,
                     pairs_per_step=n * groups)
    return d, i


def sweep_dist(gd, targets: torch.Tensor,
               max_iters: int = 0) -> tuple[torch.Tensor, int]:
    """``([N, B] distances, cycles)`` by fast sweeping; cycles run while
    one lowers a distance and fewer than ``limit`` ran (``max_iters``,
    0 = N-1). With off-lattice edges each cycle is one :func:`grid_sweep`
    launch, then :func:`relax_jacobi` over the shift-plane edges and then
    over the straggler edges on the result (the JAX order), the flag read
    after each. On a lattice alone one launch runs every
    column group's cycles to its own convergence, capped at ``limit``,
    and the count is the largest a group ran: the JAX loop's iterate and
    count."""
    n = gd.n
    limit = (n - 1) if max_iters == 0 else max_iters
    d = init_dist(n, targets)
    if not bool((targets >= 0).any()):
        return d, 0
    flag = torch.zeros(1, dtype=torch.int32, device=d.device)
    if gd.shift_csr is None and gd.left_csr is None:
        counter = torch.zeros(1, dtype=torch.int32, device=d.device)
        grid_sweep(gd, d, flag, cycles=limit, counter=counter)
        return d, int(counter.item())
    spare = torch.empty_like(d)
    i = 0
    while i < limit:
        flag.zero_()
        grid_sweep(gd, d, flag)
        for csr in (gd.shift_csr, gd.left_csr):
            if csr is not None:
                relax_jacobi(csr, d, spare, flag)
                d, spare = spare, d
        i += 1
        if not bool(flag.item()):
            break
    return d, i


def build_fm_jacobi(dg: DeviceGraph, targets: torch.Tensor,
                    max_iters: int = 0, csr: EdgeCSR | None = None,
                    out: torch.Tensor | None = None,
                    dist_out: torch.Tensor | None = None) -> torch.Tensor:
    """The ``ell``/``ellsplit``/``shift`` build through the kernels:
    :func:`jacobi_dist` over the full out-edge CSR, then
    :func:`first_moves`. int8 ``[B, N]`` (or ``out``); ``dist_out``
    receives the distances' first rows (:func:`write_dists`)."""
    if csr is None:
        csr = csr_from_ell(dg)
    dist_nb, _ = jacobi_dist(csr, targets, max_iters)
    write_dists(dist_nb.T, dist_out)
    with obs_trace.span("build.first_moves"):
        return first_moves(dg, targets, dist_nb, csr=csr, out=out)
