"""Delta-stepping frontier relaxation: the build kernel for high-diameter
irregular graphs whose node ids have locality (road networks after a
BFS/RCM reorder).

Port of the JAX package's ``ops/frontier_relax.py``. The dense
relaxations sweep all N nodes every step for ~hop-diameter steps; this
one keeps a priority work queue over nodes instead:

* ``prio`` int32 [N] — INF = idle; otherwise the smallest just-improved
  distance among the node's out-neighbours (a lower bound on the
  improvement it can still receive);
* each iteration pops the first ``f`` node ids, in ascending order, with
  ``prio <= min(prio) + delta`` (and ``prio < INF``), relaxes only their
  out-edges over all B target columns, ``s_unroll`` sub-steps a pop, and
  re-arms the in-neighbours of every improved row at that row's new
  minimum.

Any pop order reaches the same unique fixed point, so the distances
equal every other build's; first moves come from the shared full-width
extraction. The JAX program pads each pop to a static ``f`` rows with the
out-of-range index ``n``, which its scatters drop; torch raises on an
out-of-range index, so here a pop is just the live rows (``nonzero``
then the first ``f``): the pads did nothing but be dropped.

Plain torch on every device: the fused pop+relax kernel is a later
slice. On the card the distances run as torch ops on card tensors and
the extraction is the hand kernel (``cuda_build_kernels.first_moves``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import cuda_build_kernels as cbk
from .bellman_ford import first_move_from_dist, init_dist
from .device_graph import TINF


@dataclasses.dataclass(frozen=True)
class FrontierGraph:
    """Host-side bundle for the delta-stepping relaxation."""

    in_nbr: np.ndarray   # int32 [N, K_in] k-th in-neighbor (pad: self)
    n: int
    f: int               # pop capacity per iteration
    delta: int           # bucket width (pop window above the queue min)
    s_unroll: int        # relax sub-steps per pop


#: pop capacity per iteration (the JAX package's tuned default)
FRONTIER_CAPACITY = 2048

#: bucket width multiplier: delta ~ 32 x mean edge weight
DELTA_MEAN_W_MULT = 32


def pick_delta(w: np.ndarray) -> int:
    """Bucket width from the weight distribution (power of two), clamped
    to 2^29 < INF so ``prio.min() + delta`` cannot overflow int32."""
    mean_w = float(w.mean()) if len(w) else 1.0
    target = max(int(min(mean_w * DELTA_MEAN_W_MULT, 1 << 29)), 1)
    return min(1 << (target - 1).bit_length(), 1 << 29)


def locality_fraction(graph, window_mult: int = 8) -> float:
    """Fraction of edges with ``|dst - src|`` under ``window_mult*sqrt(N)``
    — the auto gate's proxy for "wavefronts are id-coherent"."""
    if graph.m == 0:
        return 1.0
    win = window_mult * int(np.sqrt(max(graph.n, 1)))
    return float((np.abs(graph.dst - graph.src) < win).mean())


def frontier_graph(graph, f: int | None = None, delta: int | None = None,
                   s_unroll: int = 2) -> FrontierGraph:
    """Build the bundle from a :class:`~..data.graph.Graph`. An explicit
    ``delta`` is clamped to ``pick_delta``'s 2^29 ceiling."""
    in_nbr, _ = graph.ell("in")
    return FrontierGraph(
        in_nbr=np.asarray(in_nbr, np.int32), n=graph.n,
        f=f if f is not None else FRONTIER_CAPACITY,
        delta=(min(int(delta), 1 << 29) if delta is not None
               else pick_delta(graph.w)),
        s_unroll=s_unroll)


def dist_to_targets_frontier(dg, fg: FrontierGraph, targets,
                             max_iters: int = 0,
                             stats: dict | None = None) -> torch.Tensor:
    """int32 [B, N] of d(x → targets[b]) by delta-stepping on ``dg``'s
    device (a transposed view of the batch-minor ``[N, B]`` table the
    queue works on). ``max_iters`` bounds queue POPS; 0 = run until the
    queue is empty (with the JAX package's ``1 << 30`` backstop).
    ``stats``: a dict that receives ``pops``, the pops the queue ran."""
    n, f, delta = fg.n, fg.f, fg.delta
    dev = dg.device
    targets = torch.as_tensor(targets, dtype=torch.int32, device=dev)
    limit = (1 << 30) if max_iters == 0 else max_iters
    out_nbr = dg.out_nbr.long()
    in_nbr = torch.as_tensor(fg.in_nbr, device=dev).long()
    dist = init_dist(n, targets)
    # arm the in-neighbours of every valid target at priority 0
    prio = torch.full((n,), TINF, dtype=torch.int32, device=dev)
    live_t = targets[targets >= 0].long()
    prio[in_nbr[live_t].reshape(-1)] = 0
    i = 0
    while i < limit:
        pmin = int(prio.min())
        if pmin >= TINF:
            break
        # idle nodes (prio == INF) never match the pop window, even when
        # theta >= INF (near-INF weights)
        theta = pmin + delta
        idx = torch.nonzero((prio <= theta) & (prio < TINF)).squeeze(1)[:f]
        prio[idx] = TINF
        nbr = out_nbr[idx]                                  # [F, K]
        w = dg.w_pad[dg.out_eid[idx].long()]                # [F, K]
        for _ in range(fg.s_unroll):
            via = (dist[nbr] + w[:, :, None]).clamp_max_(TINF)
            new = via.amin(dim=1)                           # [F, B]
            old = dist[idx]
            imp = new < old
            dist[idx] = torch.minimum(old, new)
            # wake the in-neighbours of improved rows at the row's new
            # minimum (their relaxation input just reached that value)
            newmin = torch.where(imp, new, TINF).amin(dim=1)
            ch = newmin < TINF
            wake = in_nbr[idx[ch]]
            prio.scatter_reduce_(
                0, wake.reshape(-1),
                newmin[ch][:, None].expand_as(wake).reshape(-1), "amin")
        i += 1
    if stats is not None:
        stats["pops"] = i
    return dist.T


def build_fm_columns_frontier(dg, fg: FrontierGraph, targets,
                              max_iters: int = 0, extract_chunk: int = 512,
                              csr=None, out: torch.Tensor | None = None,
                              dist_out: torch.Tensor | None = None
                              ) -> torch.Tensor:
    """CPD build via the delta-stepping relaxation: int8 ``[B, N]``.

    ``extract_chunk``: on the CPU the plain extraction runs in column
    slices of this many targets (the JAX package's chunked extraction);
    on the card the extraction is one launch of the hand kernel, which
    needs no per-slot temporaries. ``csr``/``out``: see
    ``cuda_build_kernels.first_moves``; ``dist_out``:
    ``cuda_build_kernels.write_dists``."""
    targets = torch.as_tensor(targets, dtype=torch.int32, device=dg.device)
    dist = dist_to_targets_frontier(dg, fg, targets, max_iters)
    cbk.write_dists(dist, dist_out)
    if dg.device.type != "cpu":
        return cbk.first_moves(dg, targets, dist.T, csr=csr, out=out)
    b = int(targets.shape[0])
    parts = [first_move_from_dist(dg, targets[i:i + extract_chunk],
                                  dist[i:i + extract_chunk])
             for i in range(0, b, extract_chunk)]
    fm = parts[0] if len(parts) == 1 else torch.cat(parts)
    return cbk.write_rows(fm, out)
