"""Pointer doubling as hand-written CUDA kernels (K5).

Serves the JAX package's XLA stage ``ops/pointer_doubling.py``
(``doubled_tables(_multi)``'s ``while_loop``; no Pallas kernel there).
The source is ``csrc/pointer_doubling.cu`` with two entries:

* :func:`doubling_rows`, the main path: every sweep of a row in one
  launch, the row's ``(succ, plen, cost[0:D])`` records (16-byte
  groups) held in shared memory (one block a row, or a thread-block
  cluster a row whose blocks read each other's shared memory), written
  back once with the row's ``settled`` sweep and ``live`` bit;
* :func:`doubling_sweep`, the wide path for rows no cluster of the card
  holds: one sweep over device memory, one thread an entry.

:func:`rows_plan` is the shape rule that picks between them. See the
note at the top of the source for the design and what bounds it. The
library is built with ``nvcc`` at first use (``utils.cuda_build``) and
called through plain C entry points with ``ctypes``.

Each wrapper picks by the device its tensors lie on: CPU records take
the plain version (:func:`.pointer_doubling.double_rows`,
:func:`.pointer_doubling.sweep_records`), CUDA records launch the kernel
or raise. There is no fallback.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_walk import _check
from ..utils.counts import bump
from .pointer_doubling import double_rows, record_width, sweep_records

#: the CUDA source (``csrc/<KERNEL_NAME>.cu``) and its entry points
KERNEL_NAME = "pointer_doubling"
ENTRY = "doubling_sweep"
ENTRY_ROWS = "doubling_rows"
ENTRY_PLAN = "doubling_rows_plan"

_fns: dict[str, object] = {}
_plans: dict[tuple, tuple[int, int, int, int]] = {}


def _kernel(entry: str):
    if entry not in _fns:
        from ..utils.cuda_build import load_library

        fn = getattr(load_library(KERNEL_NAME), entry)
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = {ENTRY: [p, p, p, ll, i, i, p],
                       ENTRY_ROWS: [p, ll, i, i, p, i, i, p, p, p],
                       ENTRY_PLAN: [i, i, p]}[entry]
        fn.restype = ctypes.c_int
        _fns[entry] = fn
    return _fns[entry]


def rows_plan(n: int, d: int, device: torch.device
              ) -> tuple[int, int, int, int]:
    """The on-chip shape of a row of ``n`` nodes and ``d`` cost sets on
    ``device``: ``(blocks a row, threads a block, nodes a block, shared
    bytes a block)``; blocks 0 when no cluster of the card holds the row.

    The rule (``csrc/pointer_doubling.cu::plan_rows``): the fewest blocks
    ``c`` of 1 to 16 whose shared memory (the device's opt-in limit a
    block) holds ``ceil(n / c)`` records of :func:`.pointer_doubling.
    record_width` ints (``2 + d`` rounded up to 16 bytes) at no more than
    16 nodes a thread of 512, and of which the card can make a cluster
    resident. Made once a (device, n, d), in the C library, which also
    readies the kernels for it; every :func:`launch_rows` of that shape
    passes it back. On the CPU there is no card: one "block" a row, the
    plain version."""
    if device.type == "cpu":
        return 1, 0, n, 0
    if device.type != "cuda":
        raise ValueError(f"no doubling for tensors on {device}")
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    key = (idx, n, d)
    if key not in _plans:
        out = (ctypes.c_int * 4)()
        with torch.cuda.device(idx):
            err = _kernel(ENTRY_PLAN)(n, record_width(d) // 4,
                                      ctypes.addressof(out))
        if err != 0:
            raise RuntimeError(f"{ENTRY_PLAN} failed: CUDA error {err}")
        _plans[key] = tuple(out)
    return _plans[key]


def doubling_rows(rec: torch.Tensor, d: int, sweeps: int,
                  fixed: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Double every row of int32 ``[R, N, P]`` records (``P`` =
    :func:`.pointer_doubling.record_width` of ``d``) in place: up to
    ``sweeps`` sweeps a row, each row stopping after its first sweep that
    moves no successor, or exactly ``sweeps`` when ``fixed``. Returns
    ``(settled int32 [R], live bool [R])``
    (:func:`.pointer_doubling.double_rows` defines both).

    Each kernel launch adds one to ``doubling_rows.launches``, each call
    on CPU tensors (the plain version) one to ``doubling_rows.plain``."""
    if rec.device.type == "cpu":
        bump(doubling_rows, "plain")
        return double_rows(rec, d, sweeps, fixed)
    if rec.device.type != "cuda":
        raise ValueError(f"no doubling for tensors on {rec.device}")
    dev = rec.device
    if d < 1 or rec.dim() != 3 or rec.shape[2] != record_width(d):
        raise ValueError(f"records must be [R, N, record_width(d)] with d "
                         f"= {d}, got {tuple(rec.shape)}")
    _check("records", rec, torch.int32, rec.shape, dev)
    if rec.data_ptr() % 16:
        raise ValueError("records must start on 16 bytes")
    if sweeps < 0:
        raise ValueError(f"sweeps must be >= 0, got {sweeps}")
    r, n, _ = rec.shape
    if n >= 2 ** 31:
        raise ValueError(f"{n} nodes overflow the kernel's int32 node ids")
    if rows_plan(n, d, dev)[0] == 0:
        raise ValueError(f"a row of {n} nodes x {record_width(d)} ints "
                         "fits no cluster of this card: take the wide path "
                         "(doubling_sweep)")
    settled = torch.empty(r, dtype=torch.int32, device=dev)
    live = torch.empty(r, dtype=torch.bool, device=dev)
    if r:
        launch_rows(rec, d, sweeps, fixed, settled, live)
    return settled, live


def launch_rows(rec: torch.Tensor, d: int, sweeps: int, fixed: bool,
                settled: torch.Tensor, live: torch.Tensor) -> None:
    """The bare on-chip launch on tensors :func:`doubling_rows` has
    checked and allocated, in the shape :func:`rows_plan` gives: one
    launch on the current stream, no synchronisation; raises if the
    launch is refused. Counts the launch."""
    fn = _kernel(ENTRY_ROWS)
    r, n, p = rec.shape
    dev = rec.device
    plan = (ctypes.c_int * 4)(*rows_plan(n, d, dev))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(rec.data_ptr(), r, n, p // 4, ctypes.addressof(plan),
                 int(sweeps), int(bool(fixed)), settled.data_ptr(),
                 live.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{ENTRY_ROWS} launch failed: CUDA error {err}")
    bump(doubling_rows, "launches")


doubling_rows.launches = 0
doubling_rows.plain = 0


def doubling_sweep(cur: torch.Tensor, out: torch.Tensor,
                   flag: torch.Tensor) -> torch.Tensor:
    """One doubling sweep (the wide path) of int32 ``[R, N, P]`` records
    (``P`` a multiple of 4: ``pointer_doubling.record_width``) from
    ``cur`` into ``out`` (a distinct buffer of the same shape); sets
    ``flag[0] = 1`` (int32 ``[1]``) when any successor moved and leaves
    it otherwise. Returns ``out``.

    Each kernel launch adds one to ``doubling_sweep.launches``, each
    sweep on CPU tensors (the plain version) one to
    ``doubling_sweep.plain``."""
    if cur.device.type == "cpu":
        bump(doubling_sweep, "plain")
        new, changed = sweep_records(cur)
        out.copy_(new)
        if changed:
            flag.fill_(1)
        return out
    if cur.device.type != "cuda":
        raise ValueError(f"no doubling sweep for tensors on {cur.device}")
    dev = cur.device
    if cur.dim() != 3 or cur.shape[2] % 4 or cur.shape[2] == 0:
        raise ValueError(f"records must be [R, N, 4 v], got "
                         f"{tuple(cur.shape)}")
    _check("records", cur, torch.int32, cur.shape, dev)
    _check("out", out, torch.int32, cur.shape, dev)
    _check("flag", flag, torch.int32, (1,), dev)
    if cur.data_ptr() == out.data_ptr():
        raise ValueError("the sweep is double-buffered: out must not be "
                         "the records")
    if (cur.data_ptr() | out.data_ptr()) % 16:
        raise ValueError("records must start on 16 bytes")
    r, n, p = cur.shape
    if n >= 2 ** 31 or r * -(-n // 256) >= 2 ** 31:
        raise ValueError(f"{r} x {n} records overflow the kernel's int32 "
                         "node ids and tiles")
    launch_sweep(cur, out, flag)
    return out


def launch_sweep(cur: torch.Tensor, out: torch.Tensor,
                 flag: torch.Tensor) -> None:
    """The bare wide-path launch on tensors :func:`doubling_sweep` has
    checked: one launch on the current stream, no synchronisation; raises
    if the launch is refused. Counts the launch."""
    fn = _kernel(ENTRY)
    r, n, p = cur.shape
    dev = cur.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(cur.data_ptr(), out.data_ptr(), flag.data_ptr(), r, n,
                 p // 4, stream)
    if err != 0:
        raise RuntimeError(f"{ENTRY} launch failed: CUDA error {err}")
    bump(doubling_sweep, "launches")


doubling_sweep.launches = 0
doubling_sweep.plain = 0
