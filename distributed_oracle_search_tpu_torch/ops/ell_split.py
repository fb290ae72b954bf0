"""ELL+COO split relaxation: the build kernel for degree-skewed graphs.

Port of the JAX package's ``ops/ell_split.py``. The plain padded-ELL
relaxation gathers ``N x K`` rows per sweep with K = the MAX out-degree;
road networks are degree-skewed (the 264k synthetic: K = 20, mean degree
4), so most of those gathers hit padding. The split keeps

* a narrow ELL table of width ``K0`` covering every node's first K0
  out-edges, plus
* a COO list of the overflow edges (only hubs have any), relaxed by a
  scatter-min,

with ``K0`` minimising the modelled sweep cost ``N*K0 +
SCATTER_COST*overflow`` — the same cost model and the same ``K0`` as the
JAX package, because the build policy (``models.cpd.pick_build_kernel``)
gates on it. The host side (:class:`ELLSplitGraph`, :func:`pick_k0`,
:func:`split_ratio`, :func:`ell_split_graph`) is a numpy copy.

Both halves of a step read the previous iterate, so a step is exactly
the Jacobi step of ``bellman_ford`` and of ``shift_relax``: the same
distances at every ``max_iters`` cut. That is why, on the card,
:func:`build_fm_columns_ellsplit` runs the hand relax kernel over the
graph's full out-edge CSR (``cuda_build_kernels.relax_jacobi``) and the
hand extraction kernel; :func:`dist_to_targets_split` is the plain torch
version of the split step, which the CPU build and the tests use.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import cuda_build_kernels as cbk
from .bellman_ford import first_move_from_dist, init_dist
from .device_graph import TINF

#: modelled cost of one scattered overflow edge relative to one ELL slot
#: (the JAX package's constant: the policy's choice of K0 must match)
SCATTER_COST = 4


@dataclasses.dataclass(frozen=True)
class ELLSplitGraph:
    """Host-side bundle for the split relaxation (free-flow weights)."""

    nbr0: np.ndarray    # int32 [N, K0] first-K0 neighbors (pad: self)
    w0: np.ndarray      # int32 [N, K0] their weights (pad: INF)
    u_ov: np.ndarray    # int32 [E_ov] overflow edge sources
    v_ov: np.ndarray    # int32 [E_ov] overflow edge dests
    w_ov: np.ndarray    # int32 [E_ov] overflow edge weights
    k0: int
    n: int


def pick_k0(degrees: np.ndarray, k_max: int) -> int:
    """Width minimizing ``N*K0 + SCATTER_COST * overflow(K0)``."""
    best_k, best_cost = k_max, len(degrees) * k_max
    for k0 in range(1, k_max + 1):
        over = int(np.maximum(degrees - k0, 0).sum())
        cost = len(degrees) * k0 + SCATTER_COST * over
        if cost < best_cost:
            best_k, best_cost = k0, cost
    return best_k


def split_ratio(degrees: np.ndarray, k_max: int) -> tuple[float, int]:
    """Modeled cost of the split vs the plain ELL and the chosen width:
    ``(ratio, k0)`` — ratio < 1 means the split wins."""
    if k_max == 0 or len(degrees) == 0:
        return 1.0, max(k_max, 1)
    k0 = pick_k0(degrees, k_max)
    over = int(np.maximum(degrees - k0, 0).sum())
    return (len(degrees) * k0 + SCATTER_COST * over) / (
        len(degrees) * k_max), k0


def ell_split_graph(graph, k0: int | None = None) -> ELLSplitGraph:
    """Build the split bundle from a :class:`~..data.graph.Graph`.

    ``k0`` skips the width search when the caller already ran it
    (``models.cpd.pick_build_kernel`` gates on :func:`split_ratio` and
    passes its k0 through)."""
    nbr, eid = graph.ell("out")
    k_max = nbr.shape[1]
    if k0 is None:
        k0 = pick_k0(np.diff(graph.out_ptr), k_max)
    w_padded = graph.padded_weights()          # [m+1], last = INF
    nbr0 = np.asarray(nbr[:, :k0], np.int32)
    w0 = np.asarray(w_padded[eid[:, :k0]], np.int32)
    over_mask = eid[:, k0:] < graph.m          # real edges beyond K0
    # row-major flatten of the mask keeps overflow edges u-sorted
    rows = np.repeat(np.arange(graph.n), over_mask.sum(axis=1))
    flat_eid = eid[:, k0:][over_mask]
    return ELLSplitGraph(
        nbr0=nbr0, w0=w0,
        u_ov=np.asarray(rows, np.int32),
        v_ov=np.asarray(graph.dst[flat_eid], np.int32),
        w_ov=np.asarray(w_padded[flat_eid], np.int32),
        k0=k0, n=graph.n)


def _split_step(d: torch.Tensor, nbr0, w0, u_ov, v_ov, w_ov) -> torch.Tensor:
    """One Jacobi split step: the narrow ELL slot by slot, then the
    overflow scatter-min, both reading ``d``."""
    nd = d.clone()
    for k in range(nbr0.shape[1]):
        via = d.index_select(0, nbr0[:, k]).add_(w0[:, k, None])
        torch.minimum(nd, via.clamp_max_(TINF), out=nd)
    if u_ov.numel():
        cand = d.index_select(0, v_ov).add_(w_ov[:, None]).clamp_max_(TINF)
        nd.scatter_reduce_(0, u_ov[:, None].expand_as(cand), cand, "amin")
    return nd


def dist_to_targets_split(sg: ELLSplitGraph, targets,
                          max_iters: int = 0) -> torch.Tensor:
    """int32 [B, N] of d(x → targets[b]): the plain torch split
    relaxation to convergence (``max_iters`` > 0 cuts the loop after that
    many steps, as the JAX ``while_loop`` does; 0 = N-1), on the targets'
    device."""
    targets = torch.as_tensor(targets, dtype=torch.int32)
    dev = targets.device
    nbr0 = torch.as_tensor(sg.nbr0, device=dev).long()
    w0 = torch.as_tensor(sg.w0, dtype=torch.int32, device=dev)
    u_ov = torch.as_tensor(sg.u_ov, device=dev).long()
    v_ov = torch.as_tensor(sg.v_ov, device=dev).long()
    w_ov = torch.as_tensor(sg.w_ov, dtype=torch.int32, device=dev)
    limit = (sg.n - 1) if max_iters == 0 else max_iters
    d = init_dist(sg.n, targets)
    changed = bool((d < TINF).any())
    i = 0
    while changed and i < limit:
        nd = _split_step(d, nbr0, w0, u_ov, v_ov, w_ov)
        changed = bool((nd < d).any())
        d = nd
        i += 1
    return d.T.contiguous()


def build_fm_columns_ellsplit(dg, sg: ELLSplitGraph, targets,
                              max_iters: int = 0, csr=None,
                              out: torch.Tensor | None = None,
                              dist_out: torch.Tensor | None = None
                              ) -> torch.Tensor:
    """CPD build via the split relaxation: int8 ``[B, N]`` first moves.

    Picked by device, like the walk: on the CPU the plain split steps and
    the plain extraction; on the card the hand relax kernel over the full
    out-edge CSR (``csr``, built from ``dg`` when None) and the hand
    extraction kernel — the same Jacobi iterate, so the same table. The
    extraction always runs over the full-width ELL (bit-identical
    tie-breaks). ``out``: see ``cuda_build_kernels.first_moves``;
    ``dist_out``: ``cuda_build_kernels.write_dists``."""
    targets = torch.as_tensor(targets, dtype=torch.int32, device=dg.device)
    if dg.device.type == "cpu":
        dist = dist_to_targets_split(sg, targets, max_iters)
        cbk.write_dists(dist, dist_out)
        fm = first_move_from_dist(dg, targets, dist)
        return cbk.write_rows(fm, out)
    return cbk.build_fm_jacobi(dg, targets, max_iters, csr=csr, out=out,
                               dist_out=dist_out)
