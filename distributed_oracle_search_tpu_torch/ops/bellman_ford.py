"""CPD construction: batched min-plus Bellman-Ford + first-move extraction.

The reference builds its CPD with one Dijkstra sweep per owned node under
OpenMP (reference ``README.md:88-95``). Like the JAX package
(``ops/bellman_ford.py``), the build here is **min-plus fixed-point
iteration over a whole batch of targets at once**:

    dist[x, b]  <-  min(dist[x, b],  min_k w[eid[x, k]] + dist[nbr[x, k], b])

in ``[N, B]`` batch-minor layout, so each gather moves whole contiguous
``[B]`` rows. Iteration is Jacobi (every slot reads the previous
iterate), exactly as the JAX ``while_loop``, so a ``max_iters`` cut stops
at the same distances; convergence (no update anywhere in the batch)
ends the loop.

Plain torch, slot by slot with a running min: the one-shot ``[N, K, B]``
candidate tensor would be 11 GB at B=512 on a 264k-node road graph with
K=20. Road graphs are degree-skewed (mean out-degree ~4 under a max of
20), so each slot only touches the nodes for which it is a real edge: a
padding slot (``nbr = x``, weight ``w_pad[M] = INF``) can never lower a
distance or win the strict first-move compare, so skipping it is exact,
and the work per iteration is the edge count M rather than N·K.

First moves fall out in one more pass: the first minimal slot of the same
relaxation expression (strict ``<`` in ascending slot order), matching
the CPU oracle's tie-break (``models.reference.first_move_to_target``).

Distances are directed **node→target** costs: ``dist[x, b] =
d(x → targets[b])``, the quantity the target-owning worker needs.
"""

from __future__ import annotations

import torch

from .device_graph import DeviceGraph, TINF


def _slot_plan(dg: DeviceGraph):
    """Per ELL slot k with at least one real edge: ``(k, rows, nbr, w)``
    — ``rows`` the int64 node ids whose slot k is a real edge (None when
    that is every node), ``nbr`` their slot-k neighbors (int64) and
    ``w`` the slot-k weights as an int32 ``[n_k, 1]`` column."""
    pad_eid = dg.w_pad.shape[0] - 1
    plan = []
    for k in range(dg.k):
        real = dg.out_eid[:, k] != pad_eid
        n_real = int(real.sum())
        if n_real == 0:
            continue
        if n_real == dg.n:
            rows = None
            nbr, eid = dg.out_nbr[:, k], dg.out_eid[:, k]
        else:
            rows = torch.nonzero(real).squeeze(1)
            nbr, eid = dg.out_nbr[rows, k], dg.out_eid[rows, k]
        w = dg.w_pad[eid.long()].unsqueeze(1)
        plan.append((k, rows, nbr.long(), w))
    return plan


def _via(dist_nb: torch.Tensor, nbr: torch.Tensor,
         w: torch.Tensor) -> torch.Tensor:
    """Candidate costs through one slot: ``min(w + dist[nbr], INF)``
    (int32; w ≤ INF and dist ≤ INF, so the sum cannot overflow)."""
    return dist_nb.index_select(0, nbr).add_(w).clamp_max_(TINF)


def _relax_nb(dist_nb: torch.Tensor, plan) -> torch.Tensor:
    """One Jacobi min-plus relaxation in ``[N, B]`` layout."""
    new = dist_nb
    for _, rows, nbr, w in plan:
        via = _via(dist_nb, nbr, w)
        if rows is None:
            new = torch.minimum(new, via, out=via)
        else:
            if new is dist_nb:
                new = dist_nb.clone()
            new.index_copy_(0, rows, torch.minimum(
                new.index_select(0, rows), via, out=via))
    return new


def _dist_nb(dg: DeviceGraph, targets: torch.Tensor, plan,
             max_iters: int = 0) -> torch.Tensor:
    n = dg.n
    b = targets.shape[0]
    limit = (n - 1) if max_iters == 0 else max_iters
    valid = targets >= 0
    t_safe = torch.where(valid, targets, 0).long()
    dist = torch.full((n, b), TINF, dtype=torch.int32, device=dg.device)
    dist[t_safe, torch.arange(b, device=dg.device)] = torch.where(
        valid, 0, TINF).to(torch.int32)
    changed = bool((dist < TINF).any())
    i = 0
    while changed and i < limit:
        new = _relax_nb(dist, plan)
        changed = bool((new < dist).any())
        dist = new
        i += 1
    return dist


def _as_targets(dg: DeviceGraph, targets) -> torch.Tensor:
    return torch.as_tensor(targets, dtype=torch.int32, device=dg.device)


def dist_to_targets(dg: DeviceGraph, targets,
                    max_iters: int = 0) -> torch.Tensor:
    """int32 [B, N] of d(x → targets[b]) for every node x.

    ``targets`` int32 [B]; negative entries are padding rows (left
    all-INF) so shard batches can be rectangular. ``max_iters`` bounds
    the loop (0 = N-1, the Bellman-Ford worst case); convergence exits
    early."""
    targets = _as_targets(dg, targets)
    return _dist_nb(dg, targets, _slot_plan(dg), max_iters).T.contiguous()


def _first_move_nb(dg: DeviceGraph, targets: torch.Tensor,
                   dist_nb: torch.Tensor, plan) -> torch.Tensor:
    best = torch.full_like(dist_nb, TINF)
    fm_nb = torch.zeros(dist_nb.shape, dtype=torch.int8, device=dg.device)
    for k, rows, nbr, w in plan:
        via = _via(dist_nb, nbr, w)
        if rows is None:
            fm_nb.masked_fill_(via < best, k)
            best = torch.minimum(best, via)
        else:
            b_sub = best.index_select(0, rows)
            fm_nb.index_copy_(0, rows, fm_nb.index_select(0, rows)
                              .masked_fill_(via < b_sub, k))
            best.index_copy_(0, rows, torch.minimum(b_sub, via, out=via))
    fm = fm_nb.masked_fill_(best >= TINF, -1).T.contiguous()
    # the target's own column: no move; padding rows: all -1
    valid = targets >= 0
    cols = torch.nonzero(valid).squeeze(1)
    fm[cols, targets[cols].long()] = -1
    fm[~valid] = -1
    return fm


def first_move_from_dist(dg: DeviceGraph, targets,
                         dist: torch.Tensor) -> torch.Tensor:
    """First-move table int8 [B, N] from converged distances [B, N].

    ``fm[b, x]`` = out-edge slot of x minimizing ``w + d(nbr → targets[b])``
    (first minimal slot on ties, same rule as the CPU oracle). ``-1`` for
    unreachable, for the target itself, and for padding rows
    (targets[b] < 0)."""
    targets = _as_targets(dg, targets)
    return _first_move_nb(dg, targets, dist.T.contiguous(), _slot_plan(dg))


def build_fm_columns(dg: DeviceGraph, targets,
                     max_iters: int = 0) -> torch.Tensor:
    """CPD shard build: first-move rows for a batch of targets —
    Bellman-Ford to convergence, then first-move extraction, all on
    ``dg``'s device. Returns int8 [B, N]."""
    targets = _as_targets(dg, targets)
    plan = _slot_plan(dg)
    dist_nb = _dist_nb(dg, targets, plan, max_iters)
    return _first_move_nb(dg, targets, dist_nb, plan)
