"""The table-search walk as a hand-written CUDA kernel.

Port of the JAX package's one TPU kernel, the Pallas-fused walk
(``ops/pallas_walk.py::_pallas_walk``). The kernel is
``csrc/table_search_walk.cu``: one thread per query lane, one memory
round trip a move (the fm byte and the head of the node's next-node row
read together, the move's weight read off the chain), small blocks and
lanes dealt round-robin over them — see the note at the top of the
source for its design and what bounds it. The pair table is an input: a
caller that walks one weight set many times builds it once
(``pair=``).
It is built with ``nvcc`` at first use (``utils.cuda_build``) and called
through a plain C entry point with ``ctypes``. The same source holds the
pack4 variant (``packed4=True``, the TPU kernel's ``packed4`` body): the
fm table is the pack4-resident shard (``models.resident``) and each slot
is a nibble of the lane's packed row. It also holds K4, the fused
multi-diff walk (:func:`cuda_walk_multi`, the JAX package's XLA stage
``table_search_multi``): the same chain, each move's edge id and D
weights read off it (added one move later) and summed in registers,
``ceil(D / 8)`` threads a query.

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
from .table_search import (
    table_search_batch, table_search_multi, walk_budget, walk_eid_pairs,
    walk_pairs, weights_t, weights_width,
)

#: the CUDA source (``csrc/<KERNEL_NAME>.cu``) and its raw entry point
KERNEL_NAME = "table_search_walk"
#: the pack4 entry point of the same source
KERNEL_NAME_PACK4 = "table_search_walk_pack4"
#: the fused multi-diff entry point of the same source (K4)
KERNEL_NAME_MULTI = "table_search_walk_multi"

_fns: dict[str, object] = {}


def _kernel(entry: str):
    """The loaded C entry point ``entry`` (built on first call)."""
    if entry not in _fns:
        from ..utils.cuda_build import load_library

        fn = getattr(load_library(KERNEL_NAME), entry)
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        if entry == KERNEL_NAME_MULTI:
            fn.argtypes = [p, ll, p, p, p, p, p, i, p, i, i, ll, i, p, p, p,
                           i, p]
        else:
            fn.argtypes = [p, ll, p, p, p, p, p, i, ll, i, p, p, p, i, p]
        fn.restype = ctypes.c_int
        _fns[entry] = fn
    return _fns[entry]


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
                    n_buckets: int = 0, packed4: bool = False,
                    pair: torch.Tensor | None = None):
    """Kernel drop-in for :func:`.table_search.table_search_batch` — same
    parameters, same ``(cost int32, plen int32, finished bool)``
    contract, bit-identical answers. ``n_buckets`` is accepted for
    signature parity (results are bucket-invariant); ``unroll`` is only
    the step-bound quantum (``walk_budget``). ``packed4``: ``fm`` is the
    pack4 nibble table, uint8 ``[R, (N + 1) // 2]`` (the JAX package's
    ``pallas_walk_batch(packed4=True)``). ``pair``: the int32
    ``[2, N, K']`` table ``walk_pairs(dg, w_query_pad)``, built once by a
    caller that walks one weight set many times (``ShardEngine`` keeps
    one per cached weight vector); None builds it here.

    Each raw kernel launch adds one to ``cuda_walk_batch.launches``, each
    pack4 launch one to ``cuda_walk_batch.launches_pack4``, and each walk
    on CPU tensors (the plain version) one to ``cuda_walk_batch.plain``."""
    if s.device.type == "cpu":
        cuda_walk_batch.plain += 1
        return table_search_batch(dg, fm, t_rows, s, t, w_query_pad,
                                  valid=valid, k_moves=k_moves,
                                  max_steps=max_steps, unroll=unroll,
                                  n_buckets=n_buckets, packed4=packed4,
                                  pair=pair)
    if s.device.type != "cuda":
        raise ValueError(f"no walk for tensors on {s.device}")
    dev = s.device
    q = s.shape[0]
    if valid is None:
        valid = torch.ones(q, dtype=torch.bool, device=dev)
    n, k = dg.n, dg.k
    width, fm_dtype = ((n + 1) // 2, torch.uint8) if packed4 \
        else (n, torch.int8)
    if fm.dim() != 2 or fm.shape[1] != width:
        raise ValueError(f"fm must be [R, {width}], got {tuple(fm.shape)}")
    _check("fm", fm, fm_dtype, fm.shape, dev)
    for name, x in (("t_rows", t_rows), ("s", s), ("t", t)):
        _check(name, x, torch.int32, (q,), dev)
    _check("valid", valid, torch.bool, (q,), dev)
    _check("w_query_pad", w_query_pad, torch.int32, dg.w_pad.shape, dev)
    if pair is None:
        pair = walk_pairs(dg, w_query_pad)
    _check("pair", pair, torch.int32, (2, n, k + -k % 4), dev)
    if pair.data_ptr() % 16:
        raise ValueError("pair must start on 16 bytes")
    steps, budget = walk_budget(n, int(k_moves), int(max_steps), unroll)
    cost = torch.empty(q, dtype=torch.int32, device=dev)
    plen = torch.empty(q, dtype=torch.int32, device=dev)
    fin = torch.empty(q, dtype=torch.bool, device=dev)
    if q:
        launch_walk(fm, n, t_rows, s, t, valid, pair, steps, budget, cost,
                    plen, fin, packed4)
    return cost, plen, fin


def launch_walk(fm: torch.Tensor, n: int, t_rows: torch.Tensor,
                s: torch.Tensor, t: torch.Tensor, valid: torch.Tensor,
                pair: torch.Tensor, steps: int, budget: int | None,
                cost: torch.Tensor, plen: torch.Tensor, fin: torch.Tensor,
                packed4: bool = False) -> None:
    """The bare kernel launch on tensors :func:`cuda_walk_batch` has
    checked and allocated: one launch on the current stream, no
    synchronisation; raises if the launch is refused. Counts the launch
    under its variant."""
    name = KERNEL_NAME_PACK4 if packed4 else KERNEL_NAME
    fn = _kernel(name)
    dev = s.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(fm.data_ptr(), n, t_rows.data_ptr(), s.data_ptr(),
                 t.data_ptr(), valid.data_ptr(), pair.data_ptr(),
                 pair.shape[2], steps, -1 if budget is None else int(budget),
                 cost.data_ptr(), plen.data_ptr(), fin.data_ptr(),
                 s.shape[0], stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    if packed4:
        cuda_walk_batch.launches_pack4 += 1
    else:
        cuda_walk_batch.launches += 1


cuda_walk_batch.launches = 0
cuda_walk_batch.launches_pack4 = 0
cuda_walk_batch.plain = 0


def cuda_walk_multi(dg: DeviceGraph, fm: torch.Tensor, t_rows: torch.Tensor,
                    s: torch.Tensor, t: torch.Tensor, w_pads: torch.Tensor,
                    valid: torch.Tensor | None = None, max_steps: int = 0,
                    pair: torch.Tensor | None = None):
    """Kernel drop-in for :func:`.table_search.table_search_multi` (K4) —
    same parameters, same ``(cost [D, Q] int32, plen int32, finished
    bool)`` contract, bit-identical answers. ``pair``: the int32
    ``[2, N, K']`` edge-id table ``walk_eid_pairs(dg)`` (weight-free: one
    per graph), built here when None; the kernel reads the weights
    transposed, ``weights_t(w_pads, weights_width(D))`` (int32 ``[M+1,
    dp]``), built here.

    CPU tensors walk through the plain version (counted in
    ``cuda_walk_multi.plain``); CUDA tensors launch the kernel (counted
    in ``cuda_walk_multi.launches``) or raise."""
    if s.device.type == "cpu":
        cuda_walk_multi.plain += 1
        return table_search_multi(dg, fm, t_rows, s, t, w_pads, valid=valid,
                                  max_steps=max_steps, pair=pair)
    if s.device.type != "cuda":
        raise ValueError(f"no walk for tensors on {s.device}")
    dev = s.device
    q = s.shape[0]
    if valid is None:
        valid = torch.ones(q, dtype=torch.bool, device=dev)
    n, k = dg.n, dg.k
    if w_pads.dim() != 2 or w_pads.shape[0] < 1:
        raise ValueError(f"w_pads must be [D >= 1, M+1], got "
                         f"{tuple(w_pads.shape)}")
    d, m1 = w_pads.shape
    if fm.dim() != 2 or fm.shape[1] != n:
        raise ValueError(f"fm must be [R, {n}], got {tuple(fm.shape)}")
    _check("fm", fm, torch.int8, fm.shape, dev)
    for name, x in (("t_rows", t_rows), ("s", s), ("t", t)):
        _check(name, x, torch.int32, (q,), dev)
    _check("valid", valid, torch.bool, (q,), dev)
    if m1 != dg.w_pad.shape[0]:
        raise ValueError(f"w_pads rows have {m1} weights, expected "
                         f"{dg.w_pad.shape[0]}")
    if pair is None:
        pair = walk_eid_pairs(dg)
    _check("pair", pair, torch.int32, (2, n, k + -k % 4), dev)
    if pair.data_ptr() % 16:
        raise ValueError("pair must start on 16 bytes")
    w_t = weights_t(w_pads, weights_width(d))
    _check("w_t", w_t, torch.int32, (m1, weights_width(d)), dev)
    steps, budget = walk_budget(n, -1, int(max_steps), 8)
    cost = torch.empty((d, q), dtype=torch.int32, device=dev)
    plen = torch.empty(q, dtype=torch.int32, device=dev)
    fin = torch.empty(q, dtype=torch.bool, device=dev)
    if q:
        launch_walk_multi(fm, n, t_rows, s, t, valid, pair, w_t, steps,
                          budget, cost, plen, fin)
    return cost, plen, fin


def launch_walk_multi(fm: torch.Tensor, n: int, t_rows: torch.Tensor,
                      s: torch.Tensor, t: torch.Tensor, valid: torch.Tensor,
                      pair: torch.Tensor, w_t: torch.Tensor, steps: int,
                      budget: int | None, cost: torch.Tensor,
                      plen: torch.Tensor, fin: torch.Tensor) -> None:
    """The bare K4 launch on tensors :func:`cuda_walk_multi` has checked
    and allocated (``pair`` the edge-id table, ``w_t`` the padded
    transposed weights, ``cost`` ``[D, Q]``): one launch on the current
    stream, no synchronisation; raises if the launch is refused. Counts
    the launch."""
    fn = _kernel(KERNEL_NAME_MULTI)
    dev = s.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(fm.data_ptr(), n, t_rows.data_ptr(), s.data_ptr(),
                 t.data_ptr(), valid.data_ptr(), pair.data_ptr(),
                 pair.shape[2], w_t.data_ptr(), w_t.shape[1], cost.shape[0],
                 steps, -1 if budget is None else int(budget),
                 cost.data_ptr(),
                 plen.data_ptr(), fin.data_ptr(), s.shape[0], stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL_NAME_MULTI} launch failed: CUDA error "
                           f"{err}")
    cuda_walk_multi.launches += 1


cuda_walk_multi.launches = 0
cuda_walk_multi.plain = 0
