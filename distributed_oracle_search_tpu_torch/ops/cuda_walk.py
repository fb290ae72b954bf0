"""The table-search walk as a hand-written CUDA kernel.

Port of the JAX package's one TPU kernel, the Pallas-fused walk
(``ops/pallas_walk.py::_pallas_walk``). The kernel is
``csrc/table_search_walk.cu``: one thread per query lane, fm bytes read
straight from device memory, packed ``(next, w)`` pairs per out-slot —
see the note at the top of the source for its design and what bounds it.
It is built with ``nvcc`` at first use (``utils.cuda_build``) and called
through a plain C entry point with ``ctypes``.

:func:`cuda_walk_batch` picks the walk by the device its tensors lie on:
CPU tensors walk through the plain :func:`.table_search.table_search_batch`
(how the CPU tests run it), CUDA tensors launch the kernel or raise.
There is no fallback from a failed launch and no knob: the TPU package's
VMEM-fit degrade and ``DOS_WALK_KERNEL`` selection have no counterpart.
"""

from __future__ import annotations

import ctypes

import torch

from .device_graph import DeviceGraph
from .table_search import table_search_batch, walk_budget, walk_pairs

KERNEL_NAME = "table_search_walk"

_fn = None


def _kernel():
    """The loaded C entry point (built on first call)."""
    global _fn
    if _fn is None:
        from ..utils.cuda_build import load_library

        fn = load_library(KERNEL_NAME).table_search_walk
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, ll, p, p, p, p, p, i, ll, i, p, p, p, i, p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


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


def cuda_walk_batch(dg: DeviceGraph, fm: torch.Tensor, t_rows: torch.Tensor,
                    s: torch.Tensor, t: torch.Tensor,
                    w_query_pad: torch.Tensor,
                    valid: torch.Tensor | None = None, k_moves: int = -1,
                    max_steps: int = 0, unroll: int = 8,
                    n_buckets: int = 0):
    """Kernel drop-in for :func:`.table_search.table_search_batch` — same
    parameters, same ``(cost int32, plen int32, finished bool)``
    contract, bit-identical answers. ``n_buckets`` is accepted for
    signature parity (results are bucket-invariant); ``unroll`` is only
    the step-bound quantum (``walk_budget``).

    Each kernel launch adds one to ``cuda_walk_batch.launches``."""
    if s.device.type == "cpu":
        return table_search_batch(dg, fm, t_rows, s, t, w_query_pad,
                                  valid=valid, k_moves=k_moves,
                                  max_steps=max_steps, unroll=unroll,
                                  n_buckets=n_buckets)
    if s.device.type != "cuda":
        raise ValueError(f"no walk for tensors on {s.device}")
    dev = s.device
    q = s.shape[0]
    if valid is None:
        valid = torch.ones(q, dtype=torch.bool, device=dev)
    n, k = dg.n, dg.k
    if fm.dim() != 2 or fm.shape[1] != n:
        raise ValueError(f"fm must be [R, {n}], got {tuple(fm.shape)}")
    _check("fm", fm, torch.int8, fm.shape, dev)
    for name, x in (("t_rows", t_rows), ("s", s), ("t", t)):
        _check(name, x, torch.int32, (q,), dev)
    _check("valid", valid, torch.bool, (q,), dev)
    _check("w_query_pad", w_query_pad, torch.int32, dg.w_pad.shape, dev)
    pair = walk_pairs(dg, w_query_pad)
    _check("pair", pair, torch.int32, (n, k, 2), dev)
    steps, budget = walk_budget(n, int(k_moves), int(max_steps), unroll)
    cost = torch.empty(q, dtype=torch.int32, device=dev)
    plen = torch.empty(q, dtype=torch.int32, device=dev)
    fin = torch.empty(q, dtype=torch.bool, device=dev)
    if q == 0:
        return cost, plen, fin
    fn = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(fm.data_ptr(), n, t_rows.data_ptr(), s.data_ptr(),
                 t.data_ptr(), valid.data_ptr(), pair.data_ptr(), k, steps,
                 -1 if budget is None else int(budget), cost.data_ptr(),
                 plen.data_ptr(), fin.data_ptr(), q, stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL_NAME} launch failed: CUDA error {err}")
    cuda_walk_batch.launches += 1
    return cost, plen, fin


cuda_walk_batch.launches = 0
