"""The CPD build's hand-written CUDA kernels and the loops that drive them.

Source: ``csrc/cpd_build.cu``, built with ``nvcc`` at first use
(``utils.cuda_build``) and called through plain C entry points with
``ctypes``. Three kernels, each with its wrapper here:

* :func:`relax_jacobi` (K1) — one Jacobi min-plus step over a CSR edge
  set, into a second buffer, raising a device flag when any distance
  fell. Over the graph's full out-edge CSR (:func:`csr_from_ell`) it is
  one step of the ``ell``, ``ellsplit`` and ``shift`` builds, which all
  compute this same iterate; over the grid's shift-plane and straggler
  edge sets it is the fast sweep's off-lattice stage (two launches);
* :func:`first_moves` (K2) — the first-move extraction of
  ``bellman_ford.first_move_from_dist``, from ``[N, B]`` distances into
  int8 ``[B, N]`` rows (optionally straight into a larger table);
* :func:`grid_sweep` (K3) — one fast-sweeping cycle's four quadrant
  sweeps, in place.

Every wrapper picks by the device its tensors lie on, as the walk does:
CPU tensors take the plain torch version of the same function (how the
CPU tests run it), CUDA tensors launch the kernel or raise — no fallback
from a failed build or launch. Each launch adds one to the wrapper's
``launches`` count, and nothing else does.

:func:`jacobi_dist` and :func:`sweep_dist` are the host loops with the
JAX ``while_loop`` semantics (``while changed and i < limit``), reading
the flag after every step or cycle; :func:`build_fm_jacobi` is the card's
``ell``/``ellsplit``/``shift`` build.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .bellman_ford import first_move_from_dist, init_dist
from .device_graph import DeviceGraph, TINF

#: the CUDA source (``csrc/<KERNEL_NAME>.cu``)
KERNEL_NAME = "cpd_build"
#: its entry points
RELAX_ENTRY = "relax_jacobi"
FIRST_MOVES_ENTRY = "first_moves"
SWEEP_ENTRY = "grid_sweep_cycle"
#: threads of a grid-sweep block (``kSweepThreads`` in the source)
SWEEP_THREADS = 512

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    RELAX_ENTRY: [_P, _P, _P, _P, _P, _P, _LL, _I, _P],
    FIRST_MOVES_ENTRY: [_P, _P, _P, _P, _P, _P, _LL, _I, _I, _P],
    SWEEP_ENTRY: [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
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
    ``row_ptr [N + 1]``, ``col [M]`` (destinations), ``wt [M]``."""
    row_ptr: torch.Tensor
    col: torch.Tensor
    wt: torch.Tensor

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


def csr_from_ell(dg: DeviceGraph) -> EdgeCSR:
    """The full out-edge CSR of ``dg``'s ELL tables, on its device, in
    ELL slot order (edge ``row_ptr[x] + k`` is slot ``k`` of node x, so
    the extraction's slot numbers are the ELL's)."""
    pad_eid = dg.w_pad.shape[0] - 1
    real = dg.out_eid != pad_eid          # real slots come first in a row
    deg = real.sum(dim=1)
    row_ptr = torch.zeros(dg.n + 1, dtype=torch.int64, device=dg.device)
    torch.cumsum(deg, 0, out=row_ptr[1:])
    return EdgeCSR(row_ptr=row_ptr.to(torch.int32),
                   col=dg.out_nbr[real].contiguous(),
                   wt=dg.w_pad[dg.out_eid[real].long()].contiguous())


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


def relax_jacobi(csr: EdgeCSR, d: torch.Tensor, out: torch.Tensor,
                 flag: torch.Tensor) -> torch.Tensor:
    """K1: ``out = min(d, min over edges (w + d[dst]))`` for int32
    ``[N, B]`` ``d`` and ``out`` (distinct buffers); sets ``flag[0] = 1``
    (int32 ``[1]``) when any value fell. Returns ``out``."""
    n = csr.n
    if not _on_cuda(d, "relax"):
        nd = relax_jacobi_plain(csr, d)
        if bool((nd < d).any()):
            flag.fill_(1)
        return out.copy_(nd)
    dev = d.device
    b = d.shape[1] if d.dim() == 2 else -1
    _check("d", d, torch.int32, (n, b), dev)
    _check("out", out, torch.int32, (n, b), dev)
    _check("flag", flag, torch.int32, (1,), dev)
    _check("row_ptr", csr.row_ptr, torch.int32, (n + 1,), dev)
    m = csr.col.shape[0]
    _check("col", csr.col, torch.int32, (m,), dev)
    _check("wt", csr.wt, torch.int32, (m,), dev)
    if d.data_ptr() == out.data_ptr():
        raise ValueError("relax_jacobi writes a second buffer: out is d")
    _launch(RELAX_ENTRY, dev, csr.row_ptr.data_ptr(), csr.col.data_ptr(),
            csr.wt.data_ptr(), d.data_ptr(), out.data_ptr(),
            flag.data_ptr(), n, b)
    relax_jacobi.launches += 1
    return out


def write_rows(fm: torch.Tensor, out: torch.Tensor | None) -> torch.Tensor:
    """``fm`` itself, or its first ``len(out)`` rows copied into ``out``."""
    if out is None:
        return fm
    return out.copy_(fm[:out.shape[0]])


def first_moves(dg: DeviceGraph, targets: torch.Tensor,
                dist_nb: torch.Tensor, csr: EdgeCSR | None = None,
                out: torch.Tensor | None = None) -> torch.Tensor:
    """K2: int8 ``[B, N]`` first moves from int32 ``[N, B]`` distances
    (``bellman_ford.first_move_from_dist``'s rule). ``csr``: ``dg``'s
    full out-edge CSR (built here when None). ``out``: an int8
    ``[R, N]`` row block (``R <= B``, rows contiguous — e.g. a slice of a
    whole-index table) that receives the first ``R`` rows; returns it,
    else a new ``[B, N]`` tensor."""
    n = dg.n
    if not _on_cuda(dist_nb, "first-move extraction"):
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
    _launch(FIRST_MOVES_ENTRY, dev, csr.row_ptr.data_ptr(),
            csr.col.data_ptr(), csr.wt.data_ptr(), dist_nb.data_ptr(),
            targets.data_ptr(), out.data_ptr(), n, b, out.shape[0])
    first_moves.launches += 1
    return out


def sweep_cols(b: int, sms: int) -> int:
    """Batch columns a sweep block owns: the widest power of two (at most
    32, a node's columns within one 128 B segment) that still gives at
    least three quarters of the SMs a block — a block's chain of
    diagonals is serial, so the card's parallelism is the block count.
    At B = 512 on 132 SMs that is 4 columns, 128 blocks."""
    cols = 32
    while cols > 1 and -(-b // cols) < sms * 3 // 4:
        cols //= 2
    return cols


def grid_sweep(gd, d: torch.Tensor, flag: torch.Tensor,
               cols: int | None = None) -> torch.Tensor:
    """K3: the four quadrant sweeps of one fast-sweeping cycle on int32
    ``[N, B]`` ``d``, in place (``gd``: ``grid_sweep.GridDevice``); sets
    ``flag[0] = 1`` when any value fell. ``cols``: batch columns a block
    owns (None → :func:`sweep_cols`). Returns ``d``."""
    from .grid_sweep import sweep_quadrants

    if not _on_cuda(d, "grid sweep"):
        if bool(sweep_quadrants(gd, d)):
            flag.fill_(1)
        return d
    dev = d.device
    n = gd.n
    b = d.shape[1] if d.dim() == 2 else -1
    _check("d", d, torch.int32, (n, b), dev)
    _check("flag", flag, torch.int32, (1,), dev)
    for name in ("wl", "wr", "wd", "wu"):
        _check(name, getattr(gd, name), torch.int32, (n,), dev)
    if cols is None:
        cols = sweep_cols(b, torch.cuda.get_device_properties(
            dev).multi_processor_count)
    if cols < 1 or SWEEP_THREADS % cols:
        raise ValueError(f"cols must divide {SWEEP_THREADS}, got {cols}")
    _launch(SWEEP_ENTRY, dev, gd.wl.data_ptr(), gd.wr.data_ptr(),
            gd.wd.data_ptr(), gd.wu.data_ptr(), d.data_ptr(),
            flag.data_ptr(), gd.height, gd.width, b, cols)
    grid_sweep.launches += 1
    return d


relax_jacobi.launches = 0
first_moves.launches = 0
grid_sweep.launches = 0


# ---------------------------------------------------------------- loops

def jacobi_dist(csr: EdgeCSR, targets: torch.Tensor,
                max_iters: int = 0) -> tuple[torch.Tensor, int]:
    """``([N, B] distances, steps)``: Jacobi steps of :func:`relax_jacobi`
    over ``csr`` while a step lowers a distance and fewer than ``limit``
    steps ran (``max_iters``, 0 = N-1) — the JAX loop. The flag is read
    after every step."""
    n = csr.n
    limit = (n - 1) if max_iters == 0 else max_iters
    d = init_dist(n, targets)
    if not bool((targets >= 0).any()):
        return d, 0
    spare = torch.empty_like(d)
    flag = torch.zeros(1, dtype=torch.int32, device=d.device)
    i = 0
    while i < limit:
        flag.zero_()
        relax_jacobi(csr, d, spare, flag)
        d, spare = spare, d
        i += 1
        if not bool(flag.item()):
            break
    return d, i


def sweep_dist(gd, targets: torch.Tensor,
               max_iters: int = 0) -> tuple[torch.Tensor, int]:
    """``([N, B] distances, cycles)`` by fast sweeping: each cycle one
    :func:`grid_sweep` launch, then the off-lattice stage as
    :func:`relax_jacobi` over the shift-plane edges and then over the
    straggler edges on the result (the JAX order). Cycles run while one
    lowers a distance and fewer than ``limit`` ran (``max_iters``, 0 =
    N-1)."""
    n = gd.n
    limit = (n - 1) if max_iters == 0 else max_iters
    d = init_dist(n, targets)
    if not bool((targets >= 0).any()):
        return d, 0
    spare = (None if gd.shift_csr is None and gd.left_csr is None
             else torch.empty_like(d))
    flag = torch.zeros(1, dtype=torch.int32, device=d.device)
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
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """The ``ell``/``ellsplit``/``shift`` build through the kernels:
    :func:`jacobi_dist` over the full out-edge CSR, then
    :func:`first_moves`. int8 ``[B, N]`` (or ``out``)."""
    if csr is None:
        csr = csr_from_ell(dg)
    dist_nb, _ = jacobi_dist(csr, targets, max_iters)
    return first_moves(dg, targets, dist_nb, csr=csr, out=out)
