"""The pointer-doubling sweep as a hand-written CUDA kernel (K5).

Serves the JAX package's XLA stage ``ops/pointer_doubling.py``
(``doubled_tables(_multi)``'s ``while_loop`` body; no Pallas kernel
there). The kernel is ``csrc/pointer_doubling.cu``: one thread an entry,
the successor's whole record gathered in one or two 16-byte loads, the
new record written to the other buffer and a changed flag raised at most
once a block — see the note at the top of the source for its design and
what bounds it. It is built with ``nvcc`` at first use
(``utils.cuda_build``) and called through a plain C entry point with
``ctypes``.

:func:`doubling_sweep` picks by the device its tensors lie on: CPU
records take the plain :func:`.pointer_doubling.sweep_records`, CUDA
records launch the kernel or raise. There is no fallback.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_walk import _check
from .pointer_doubling import sweep_records

#: the CUDA source (``csrc/<KERNEL_NAME>.cu``) and its entry point
KERNEL_NAME = "pointer_doubling"
ENTRY = "doubling_sweep"

_fns: dict[str, object] = {}


def _kernel():
    if ENTRY not in _fns:
        from ..utils.cuda_build import load_library

        fn = getattr(load_library(KERNEL_NAME), ENTRY)
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, ll, i, i, p]
        fn.restype = ctypes.c_int
        _fns[ENTRY] = fn
    return _fns[ENTRY]


def doubling_sweep(cur: torch.Tensor, out: torch.Tensor,
                   flag: torch.Tensor) -> torch.Tensor:
    """One doubling sweep of int32 ``[R, N, P]`` records (``P`` a
    multiple of 4: ``pointer_doubling.record_width``) from ``cur`` into
    ``out`` (a distinct buffer of the same shape); sets ``flag[0] = 1``
    (int32 ``[1]``) when any successor moved and leaves it otherwise.
    Returns ``out``.

    Each kernel launch adds one to ``doubling_sweep.launches``, each
    sweep on CPU tensors (the plain version) one to
    ``doubling_sweep.plain``."""
    if cur.device.type == "cpu":
        doubling_sweep.plain += 1
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
    """The bare K5 launch on tensors :func:`doubling_sweep` has checked:
    one launch on the current stream, no synchronisation; raises if the
    launch is refused. Counts the launch."""
    fn = _kernel()
    r, n, p = cur.shape
    dev = cur.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(cur.data_ptr(), out.data_ptr(), flag.data_ptr(), r, n,
                 p // 4, stream)
    if err != 0:
        raise RuntimeError(f"{ENTRY} launch failed: CUDA error {err}")
    doubling_sweep.launches += 1


doubling_sweep.launches = 0
doubling_sweep.plain = 0
