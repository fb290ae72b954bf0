"""Batched A* as hand-written CUDA kernels (K6).

Serves the JAX package's XLA stage ``ops/batched_astar.py::astar_batch``
(the jitted ``while_loop``; no Pallas kernel there). The source is
``csrc/batched_astar.cu`` with two entries:

* :func:`astar_heuristic`: the ``[N, Q]`` int32 heuristic table, bit for
  bit the JAX stage's on the CPU (its fused multiply-adds spelled out);
* :func:`astar_sweep`: one Jacobi sweep of the pruned min-plus fixed
  point into second buffers, with the sweep's five exact counts, an
  any-improved flag and the dirty groups (any improved query a node in
  each group of 32) that let the next sweep skip the sources that cannot
  improve a cell; a sweep whose previous sweep changed nothing returns
  at once.

:func:`astar_loop` drives them: the JAX loop's stop (no node changed, or
``limit`` sweeps), with groups of sweeps queued between two host reads
of the flags, and each sweep's counts folded into float32 totals in
sweep order. See the note at the top of the source for the design and
what bounds it. The library is built with ``nvcc`` at first use
(``utils.cuda_build``) and called through plain C entry points with
``ctypes``.

:func:`astar_heuristic` on CPU tensors takes the plain version
(:func:`.batched_astar.heuristic_plain`); :func:`astar_sweep` and
:func:`astar_loop` take CUDA tensors only (on the CPU
:func:`.batched_astar.astar_batch` runs the plain loop
:func:`.batched_astar.astar_batch_plain`). On CUDA tensors each entry
launches its kernel or raises. There is no fallback.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .batched_astar import (
    exact_totals, f32, finish, fold_counts, heuristic_plain, in_degree,
    init_state, n_groups,
)
from .cuda_walk import _check
from ..utils.counts import bump

#: the CUDA source (``csrc/<KERNEL_NAME>.cu``) and its entry points
KERNEL_NAME = "batched_astar"
ENTRY_H = "astar_heuristic"
ENTRY_SWEEP = "astar_sweep"
#: sweeps queued between two host reads of the flags: the first group,
#: then doubled up to the largest (a finished loop leaves at most that
#: many launches that return at once)
GROUP_FIRST = 4
GROUP_MAX = 64
#: int64 slots a sweep's counts take (five used)
COUNT_SLOTS = 8

_fns: dict[str, object] = {}


def _kernel(entry: str):
    if entry not in _fns:
        from ..utils.cuda_build import load_library

        fn = getattr(load_library(KERNEL_NAME), entry)
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = {ENTRY_H: [p, p, p, i, i, f, f, p, p],
                       ENTRY_SWEEP: [p, p, p, i, i, p, p, p, i, p, p, p, p,
                                     p, p, p, p, f, i, p, p, p, p]}[entry]
        fn.restype = ctypes.c_int
        _fns[entry] = fn
    return _fns[entry]


def _check_cells(n: int, q: int) -> None:
    if n * q >= 2 ** 31:
        raise ValueError(f"{n} nodes x {q} queries overflow the kernel's "
                         "int32 cell index: take smaller chunks")


def astar_heuristic(xs: torch.Tensor, ys: torch.Tensor, t: torch.Tensor,
                    cpu: float, hscale: float) -> torch.Tensor:
    """int32 ``[N, Q]`` heuristic of float32 coordinates ``xs``, ``ys``
    [N] and int32 targets ``t`` [Q] (``cpu``, ``hscale`` rounded to
    float32). Each kernel launch adds one to
    ``astar_heuristic.launches``, each call on CPU tensors (the plain
    version) one to ``astar_heuristic.plain``."""
    if xs.device.type == "cpu":
        bump(astar_heuristic, "plain")
        return heuristic_plain(xs, ys, t, cpu, hscale)
    if xs.device.type != "cuda":
        raise ValueError(f"no heuristic for tensors on {xs.device}")
    dev = xs.device
    n, q = xs.shape[0], t.shape[0]
    _check("xs", xs, torch.float32, (n,), dev)
    _check("ys", ys, torch.float32, (n,), dev)
    _check("t", t, torch.int32, (q,), dev)
    _check_cells(n, q)
    h = torch.empty((n, q), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _kernel(ENTRY_H)(xs.data_ptr(), ys.data_ptr(), t.data_ptr(),
                               n, q, f32(cpu), f32(hscale), h.data_ptr(),
                               stream)
    if err != 0:
        raise RuntimeError(f"{ENTRY_H} launch failed: CUDA error {err}")
    bump(astar_heuristic, "launches")
    return h


astar_heuristic.launches = 0
astar_heuristic.plain = 0


def astar_sweep(in_nbr: torch.Tensor, w_in: torch.Tensor,
                deg: torch.Tensor, h: torch.Tensor, t: torch.Tensor,
                valid: torch.Tensor, g: torch.Tensor, hops: torch.Tensor,
                changed: torch.Tensor, groups_in: torch.Tensor,
                g_out: torch.Tensor, hops_out: torch.Tensor,
                improved: torch.Tensor, groups_out: torch.Tensor,
                fscale: float, flag_in: torch.Tensor, flag_out: torch.Tensor,
                counts: torch.Tensor, skip: bool = True) -> None:
    """One sweep from ``(g, hops, changed, groups_in)`` into ``(g_out,
    hops_out, improved, groups_out)`` (int32, int32, uint8 ``[N, Q]``
    and uint8 ``[N, ceil(Q / 32)]``; distinct buffers), if ``flag_in[0]``
    (int32 [1]) is set: sets ``flag_out[0] = 1`` when a node improved and
    adds the sweep's counts (:func:`.batched_astar.sweep_plain`'s five)
    into int64 ``counts[0:5]``. ``in_nbr``, ``w_in``: int32 ``[N, K]``;
    ``deg``: int32 [N] (:func:`.batched_astar.in_degree`); ``h``: int32
    ``[N, Q]``; ``t``: int32 [Q]; ``valid``: uint8 [Q]; ``groups_in``:
    :func:`.batched_astar.groups_plain` of ``changed``. ``skip`` (the
    main path's) skips the gathers that cannot improve a cell, exactly as
    :func:`.batched_astar.sweep_skip_plain`; ``skip=False`` gathers every
    real slot, for timing and checking the skip against. CUDA tensors
    only: one launch on the current stream, no synchronisation.

    Each kernel launch adds one to ``astar_sweep.launches``, each with
    ``skip=False`` also one to ``astar_sweep.dense``."""
    if g.device.type != "cuda":
        raise ValueError(f"no A* sweep kernel for tensors on {g.device}: "
                         "the plain loop is batched_astar.astar_batch_plain")
    dev = g.device
    n, k = in_nbr.shape
    q = g.shape[1]
    ng = n_groups(q)
    _check_cells(n, q)
    for name, x, dtype, shape in (
            ("in_nbr", in_nbr, torch.int32, (n, k)),
            ("w_in", w_in, torch.int32, (n, k)),
            ("deg", deg, torch.int32, (n,)),
            ("h", h, torch.int32, (n, q)), ("t", t, torch.int32, (q,)),
            ("valid", valid, torch.uint8, (q,)),
            ("g", g, torch.int32, (n, q)),
            ("hops", hops, torch.int32, (n, q)),
            ("changed", changed, torch.uint8, (n, q)),
            ("groups_in", groups_in, torch.uint8, (n, ng)),
            ("g_out", g_out, torch.int32, (n, q)),
            ("hops_out", hops_out, torch.int32, (n, q)),
            ("improved", improved, torch.uint8, (n, q)),
            ("groups_out", groups_out, torch.uint8, (n, ng)),
            ("flag_in", flag_in, torch.int32, (1,)),
            ("flag_out", flag_out, torch.int32, (1,)),
            ("counts", counts, torch.int64, (counts.shape[0],))):
        _check(name, x, dtype, shape, dev)
    if counts.shape[0] < 5:
        raise ValueError("counts needs 5 int64 slots")
    outs = {x.data_ptr() for x in (g_out, hops_out, improved, groups_out)}
    if outs & {x.data_ptr() for x in (g, hops, changed, groups_in)}:
        raise ValueError("the sweep is double-buffered: its outputs must "
                         "not be its inputs")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _kernel(ENTRY_SWEEP)(
            in_nbr.data_ptr(), w_in.data_ptr(), deg.data_ptr(), n, k,
            h.data_ptr(), t.data_ptr(), valid.data_ptr(), q, g.data_ptr(),
            hops.data_ptr(), changed.data_ptr(), groups_in.data_ptr(),
            g_out.data_ptr(), hops_out.data_ptr(), improved.data_ptr(),
            groups_out.data_ptr(), f32(fscale), int(bool(skip)),
            flag_in.data_ptr(), flag_out.data_ptr(), counts.data_ptr(),
            stream)
    if err != 0:
        raise RuntimeError(f"{ENTRY_SWEEP} launch failed: CUDA error {err}")
    bump(astar_sweep, "launches")
    if not skip:
        bump(astar_sweep, "dense")


astar_sweep.launches = 0
astar_sweep.dense = 0


def astar_loop(in_nbr, in_eid, w_pad, xs, ys, s, t, hscale, fscale, cpu,
               valid=None, max_iters: int = 0, w_in=None, deg=None,
               info: dict | None = None):
    """The JAX ``astar_batch`` through :func:`astar_heuristic` and
    :func:`astar_sweep` on CUDA tensors: sweeps while a node changed and
    fewer than ``limit`` ran (``max_iters``, 0 = N-1), in groups of
    :data:`GROUP_FIRST` doubling to :data:`GROUP_MAX` launches between
    two reads of the flags, every sweep with the skip. ``deg``:
    :func:`.batched_astar.in_degree` of ``in_eid`` (None builds it).
    Returns ``(cost, plen, finished, counters)`` as
    :func:`.batched_astar.astar_batch_plain`; ``info`` receives
    ``sweeps``, ``launches``, ``counts`` (int64 ``[S, 5]``) and
    ``exact``."""
    n, k = in_nbr.shape
    q = s.shape[0]
    dev = in_nbr.device
    if dev.type != "cuda":
        raise ValueError(f"no A* kernel loop for tensors on {dev}")
    if valid is None:
        valid = torch.ones(q, dtype=torch.bool, device=dev)
    limit = (n - 1) if max_iters == 0 else max_iters
    h = astar_heuristic(xs, ys, t, cpu, hscale)
    if w_in is None:
        w_in = w_pad[in_eid.long()]
    if deg is None:
        deg = in_degree(in_eid, w_pad.shape[0] - 1)
    g, hops, changed, groups = init_state(n, s, valid)
    bufs = ((g, hops, changed.to(torch.uint8), groups),
            (torch.empty_like(g), torch.empty_like(hops),
             torch.empty((n, q), dtype=torch.uint8, device=dev),
             torch.empty_like(groups)))
    valid8 = valid.to(torch.uint8)
    flag = valid.any().to(torch.int32).reshape(1)
    parts = []
    i = launches = 0
    group = GROUP_FIRST
    while i < limit:
        size = min(group, limit - i)
        flags = torch.zeros(size + 1, dtype=torch.int32, device=dev)
        flags[:1].copy_(flag)
        counts = torch.zeros((size, COUNT_SLOTS), dtype=torch.int64,
                             device=dev)
        for j in range(size):
            astar_sweep(in_nbr, w_in, deg, h, t, valid8, *bufs[(i + j) % 2],
                        *bufs[(i + j + 1) % 2], fscale, flags[j:j + 1],
                        flags[j + 1:j + 2], counts[j])
        launches += size
        fl = flags.cpu().numpy()
        ran = int(np.argmin(fl[:size] != 0)) if (fl[:size] == 0).any() \
            else size
        parts.append(counts[:ran, :5])
        i += ran
        if ran < size or fl[size] == 0:
            break
        flag = flags[size:size + 1]
        group = min(2 * group, GROUP_MAX)
    g, hops = bufs[i % 2][:2]
    counts_np = torch.cat(parts).cpu().numpy() if parts \
        else np.zeros((0, 5), np.int64)
    if info is not None:
        info.update(sweeps=i, launches=launches, counts=counts_np,
                    exact=exact_totals(counts_np, k))
    return (*finish(g, hops, t, valid), fold_counts(counts_np, k))
