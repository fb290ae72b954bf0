"""Min-plus relaxation over shift-structured edges.

Port of the JAX package's ``ops/shift_relax.py``. Road networks with
locality-preserving node ids put most edges at a handful of constant
id-offsets ``dst - src`` (``Graph.shift_split``). For those edges the
relaxation

    dist[u, b] <- min(dist[u, b], w(u -> u+s) + dist[u+s, b])

is a static slice + add + min over the whole ``[N, B]`` table; only the
uncovered leftover edges pay a (narrow) padded-ELL gather.
:func:`dist_to_targets_shift` is that relaxation in plain torch: pad,
slice and min, every plane and the leftover table reading the previous
iterate — exactly the Jacobi step of ``bellman_ford``, so the same
distances at every ``max_iters`` cut. On the card,
:func:`build_fm_columns_shift` therefore runs the hand relax kernel over
the graph's full out-edge CSR and the hand extraction kernel
(``cuda_build_kernels``), like the ``ell`` and ``ellsplit`` builds.

The host side (:func:`split_coverage`, :class:`ShiftGraph`) is a copy of
the JAX package's, holding numpy arrays: the build policy
(``models.cpd.pick_build_kernel``) decides on them before any upload.
"""

from __future__ import annotations

import numpy as np
import torch

from . import cuda_build_kernels as cbk
from .bellman_ford import first_move_from_dist, init_dist
from .device_graph import TINF


def split_coverage(w_shift: np.ndarray, w_left: np.ndarray) -> float:
    """Fraction of edge slots served by the shift planes, from the
    HOST-side ``shift_split`` arrays. 1.0 = no leftover gathers."""
    on_shift = int((np.asarray(w_shift) < TINF).sum())
    left = int((np.asarray(w_left) < TINF).sum()) if w_left.size else 0
    total = on_shift + left
    return 1.0 if total == 0 else on_shift / total


class ShiftGraph:
    """Host-side bundle of ``Graph.shift_split`` outputs.

    ``shifts`` is a tuple of ints; ``w_shift`` int32 ``[S, N]``,
    ``nbr_left``/``w_left`` int32 ``[N, K_left]`` numpy arrays. Coverage
    is computed at construction."""

    def __init__(self, shifts, w_shift, nbr_left, w_left, n: int):
        self.shifts = tuple(int(s) for s in shifts)
        self._coverage = split_coverage(w_shift, w_left)
        self.w_shift = np.asarray(w_shift, np.int32)
        self.nbr_left = np.asarray(nbr_left, np.int32)
        self.w_left = np.asarray(w_left, np.int32)
        self.n = int(n)

    @classmethod
    def from_graph(cls, graph, max_shifts: int = 64) -> "ShiftGraph":
        shifts, w_shift, nbr_left, w_left = graph.shift_split(max_shifts)
        return cls(shifts, w_shift, nbr_left, w_left, graph.n)

    @property
    def k_left(self) -> int:
        return int(self.nbr_left.shape[1])

    def coverage(self) -> float:
        return self._coverage


def _shift_step(d: torch.Tensor, shifts: tuple, pad: int, w_shift,
                nbr_left, w_left) -> torch.Tensor:
    """One Jacobi step: every shift plane by pad + slice, then the
    leftover ELL slot by slot, all reading ``d``."""
    n = d.shape[0]
    acc = d.clone()
    if shifts:
        inf_rows = torch.full((pad, d.shape[1]), TINF, dtype=d.dtype,
                              device=d.device)
        dp = torch.cat([inf_rows, d, inf_rows])
        for si, s in enumerate(shifts):
            sh = dp[pad + s: pad + s + n] + w_shift[si][:, None]
            torch.minimum(acc, sh.clamp_max_(TINF), out=acc)
    for k in range(nbr_left.shape[1]):
        via = d.index_select(0, nbr_left[:, k]).add_(w_left[:, k, None])
        torch.minimum(acc, via.clamp_max_(TINF), out=acc)
    return acc


def dist_to_targets_shift(sg: ShiftGraph, targets,
                          max_iters: int = 0) -> torch.Tensor:
    """int32 [B, N] of d(x → targets[b]): the plain torch shift
    relaxation, bit-identical to ``bellman_ford.dist_to_targets``.
    ``max_iters`` > 0 cuts the loop after that many steps (0 = N-1). On
    the targets' device."""
    targets = torch.as_tensor(targets, dtype=torch.int32)
    dev = targets.device
    pad = max((abs(s) for s in sg.shifts), default=0)
    w_shift = torch.as_tensor(sg.w_shift, dtype=torch.int32, device=dev)
    nbr_left = torch.as_tensor(sg.nbr_left, device=dev).long()
    w_left = torch.as_tensor(sg.w_left, dtype=torch.int32, device=dev)
    limit = (sg.n - 1) if max_iters == 0 else max_iters
    d = init_dist(sg.n, targets)
    changed = bool((d < TINF).any())
    i = 0
    while changed and i < limit:
        nd = _shift_step(d, sg.shifts, pad, w_shift, nbr_left, w_left)
        changed = bool((nd < d).any())
        d = nd
        i += 1
    return d.T.contiguous()


def build_fm_columns_shift(dg, sg: ShiftGraph, targets, max_iters: int = 0,
                           csr=None, out: torch.Tensor | None = None,
                           dist_out: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """CPD build via the shift relaxation: int8 ``[B, N]`` first moves.
    On the CPU the plain shift steps and the plain extraction; on the
    card the hand relax kernel over the full out-edge CSR and the hand
    extraction kernel (same Jacobi iterate, same table). ``dist_out``:
    ``cuda_build_kernels.write_dists``."""
    targets = torch.as_tensor(targets, dtype=torch.int32, device=dg.device)
    if dg.device.type == "cpu":
        dist = dist_to_targets_shift(sg, targets, max_iters)
        cbk.write_dists(dist, dist_out)
        fm = first_move_from_dist(dg, targets, dist)
        return cbk.write_rows(fm, out)
    return cbk.build_fm_jacobi(dg, targets, max_iters, csr=csr, out=out,
                               dist_out=dist_out)
