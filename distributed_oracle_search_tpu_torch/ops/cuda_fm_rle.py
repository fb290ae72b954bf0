"""The build's compressed fetch as a hand-written CUDA kernel (K7).

Serves the JAX package's XLA stage ``models/cpd.py::_fm_run_count`` +
``_fm_rle_encode_impl`` (the device side of ``fetch_fm``; no Pallas
kernel there): the run-length code of an int8 ``[C, N]`` first-move
block along its target axis, column-major over the transposed block,
a run breaking at every change and at every column's first entry. The
source is ``csrc/fm_rle.cu`` with two entries:

* :func:`fm_run_count` — int32 ``[N]``: the runs of each node column;
* :func:`fm_rle_encode` — each column's runs ``(len uint16, val int8)``
  at its offset, the exclusive prefix sum of the counts
  (:func:`run_offsets`): the JAX run order.

The library is built with ``nvcc`` at first use (``utils.cuda_build``)
and called through plain C entry points with ``ctypes``. Each wrapper
picks by the device its block lies on: a CPU block takes the plain
torch version (:func:`fm_run_count_plain`, :func:`fm_rle_encode_plain`),
a CUDA block launches the kernel or raises. There is no fallback. Each
launch adds one to the wrapper's ``launches`` count, each call on a CPU
block one to its ``plain`` count (``utils.counts.bump``).

:func:`expand_runs` is the host's inverse (the JAX ``np.repeat`` and
transpose), byte-equal to the block.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .cuda_walk import _check
from ..utils.counts import bump

#: the CUDA source (``csrc/<KERNEL_NAME>.cu``) and its entry points
KERNEL_NAME = "fm_rle"
COUNT_ENTRY = "fm_run_count"
ENCODE_ENTRY = "fm_rle_encode"
#: the longest run a uint16 length holds: a run never passes its
#: column, so the encode takes blocks of at most this many rows
MAX_ROWS = 65535

_fns: dict[str, object] = {}


def _kernel(entry: str):
    if entry not in _fns:
        from ..utils.cuda_build import load_library

        fn = getattr(load_library(KERNEL_NAME), entry)
        p, ll = ctypes.c_void_p, ctypes.c_longlong
        fn.argtypes = {COUNT_ENTRY: [p, p, ll, ll, p],
                       ENCODE_ENTRY: [p, p, p, p, ll, ll, p]}[entry]
        fn.restype = ctypes.c_int
        _fns[entry] = fn
    return _fns[entry]


def _launch(entry: str, dev: torch.device, *args) -> None:
    fn = _kernel(entry)
    with torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")


def _on_cuda(fm: torch.Tensor) -> bool:
    if fm.dim() != 2 or fm.dtype != torch.int8:
        raise ValueError(f"fm must be int8 [C, N], got {fm.dtype} "
                         f"{tuple(fm.shape)}")
    if fm.device.type == "cuda":
        return True
    if fm.device.type == "cpu":
        return False
    raise ValueError(f"no run-length code for tensors on {fm.device}")


def _changes(fm: torch.Tensor) -> torch.Tensor:
    """bool ``[N, C]``: where a run starts, the block transposed (every
    entry unequal to the one a target up, and each column's first)."""
    t = fm.T
    ch = torch.ones(t.shape, dtype=torch.bool, device=fm.device)
    ch[:, 1:] = t[:, 1:] != t[:, :-1]
    return ch


def fm_run_count_plain(fm: torch.Tensor) -> torch.Tensor:
    """The plain torch count: int32 ``[N]`` runs of each column."""
    return _changes(fm).sum(dim=1, dtype=torch.int32)


def fm_rle_encode_plain(fm: torch.Tensor) -> tuple[torch.Tensor,
                                                   torch.Tensor]:
    """The plain torch encode: ``(lens uint16, vals int8)``, one entry a
    run, in the JAX run order — the transposed flat view, its change
    mask with column starts, ``torch.nonzero`` and gathers."""
    c, n = fm.shape
    flat = fm.T.reshape(-1)
    idx = torch.nonzero(_changes(fm).reshape(-1)).squeeze(1)
    nxt = torch.cat([idx[1:], torch.full((1,), c * n, dtype=idx.dtype,
                                         device=fm.device)])
    return (nxt - idx).to(torch.uint16), flat[idx]


def run_offsets(counts: torch.Tensor) -> tuple[torch.Tensor, int]:
    """int64 ``[N]`` exclusive prefix sum of ``counts`` and the total
    (a host read: the device work queued before it completes first)."""
    inc = torch.cumsum(counts, 0, dtype=torch.int64)
    total = int(inc[-1]) if inc.numel() else 0
    return inc - counts, total


def fm_run_count(fm: torch.Tensor,
                 counts: torch.Tensor | None = None) -> torch.Tensor:
    """K7's count: int32 ``[N]`` runs of each node column of the int8
    ``[C, N]`` block ``fm`` (C >= 1), into ``counts`` when given. Each
    launch adds one to ``fm_run_count.launches``, each CPU call one to
    ``fm_run_count.plain``."""
    if not _on_cuda(fm):
        bump(fm_run_count, "plain")
        got = fm_run_count_plain(fm)
        return got if counts is None else counts.copy_(got)
    c, n = fm.shape
    dev = fm.device
    _check("fm", fm, torch.int8, (c, n), dev)
    if c < 1:
        raise ValueError("fm has no rows")
    if counts is None:
        counts = torch.empty(n, dtype=torch.int32, device=dev)
    _check("counts", counts, torch.int32, (n,), dev)
    _launch(COUNT_ENTRY, dev, fm.data_ptr(), counts.data_ptr(), c, n)
    bump(fm_run_count, "launches")
    return counts


fm_run_count.launches = 0
fm_run_count.plain = 0


def fm_rle_encode(fm: torch.Tensor, offsets: torch.Tensor,
                  lens: torch.Tensor, vals: torch.Tensor) -> None:
    """K7's encode: the runs of the int8 ``[C, N]`` block ``fm`` (1 <= C
    <= :data:`MAX_ROWS`) into ``lens`` (uint16) and ``vals`` (int8), one
    entry a run, column ``j``'s from ``offsets[j]`` (:func:`run_offsets`
    of :func:`fm_run_count`). ``lens`` and ``vals`` may be views of one
    wire buffer. Each launch adds one to ``fm_rle_encode.launches``, each
    CPU call one to ``fm_rle_encode.plain``."""
    c, n = fm.shape if fm.dim() == 2 else (0, 0)
    if not 1 <= c <= MAX_ROWS:
        raise ValueError(f"fm must have 1 to {MAX_ROWS} rows, got {c}")
    if not _on_cuda(fm):
        bump(fm_rle_encode, "plain")
        got_l, got_v = fm_rle_encode_plain(fm)
        lens.copy_(got_l)
        vals.copy_(got_v)
        return
    dev = fm.device
    runs = lens.shape[0] if lens.dim() == 1 else -1
    _check("fm", fm, torch.int8, (c, n), dev)
    _check("offsets", offsets, torch.int64, (n,), dev)
    _check("lens", lens, torch.uint16, (runs,), dev)
    _check("vals", vals, torch.int8, (runs,), dev)
    if lens.data_ptr() % 2:
        raise ValueError("lens must be 2-byte aligned")
    _launch(ENCODE_ENTRY, dev, fm.data_ptr(), offsets.data_ptr(),
            lens.data_ptr(), vals.data_ptr(), c, n)
    bump(fm_rle_encode, "launches")


fm_rle_encode.launches = 0
fm_rle_encode.plain = 0


def wire_views(wire: torch.Tensor, runs: int) -> tuple[torch.Tensor,
                                                       torch.Tensor]:
    """``(lens, vals)`` over the first ``3 * runs`` bytes of the int8 or
    uint8 buffer ``wire``: ``runs`` uint16 lengths, then ``runs`` int8
    values (the wire layout of one block's runs)."""
    flat = wire.view(-1).view(torch.uint8)
    return (flat[:2 * runs].view(torch.uint16),
            flat[2 * runs:3 * runs].view(torch.int8))


def expand_runs(lens: np.ndarray, vals: np.ndarray, c: int,
                n: int) -> np.ndarray:
    """The host's inverse: runs in the JAX order -> int8 ``[C, N]``
    (contiguous), byte-equal to the block they encode: ``np.repeat``,
    then one transposed copy (most of the time)."""
    flat = np.repeat(vals, lens)
    return torch.from_numpy(flat).view(n, c).T.contiguous().numpy()
