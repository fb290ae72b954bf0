"""The plain reference: shortest paths to a set of targets, in plain torch.

Independent of the program: it reads only the edge arrays the harness
made, ``src``, ``dst`` and ``w`` (file order), and imports nothing of
the program or of JAX. Every function runs on any torch device; the
harness runs it on the card after the program's state is freed, a block
of targets at a time.

* :func:`to_targets` — for each target ``t`` and node ``u``, the least
  key of a path ``u -> t``, by Bellman-Ford over the reversed edges to
  a fixed point. With ``key = w`` it is the distance; with ``key = w *
  2**HOP_BITS + 1`` it orders paths by cost, then by hop count, so the
  key holds the distance and the fewest hops among shortest paths.
* :func:`first_moves` — a CPD row: for each node, the out-edge slot of
  the first edge on a shortest path (slot = the edge's rank among the
  node's out-edges in file order; the first minimal slot on ties; -1 at
  the target itself and where the target is unreachable).
* :func:`route_answers` — an s-t query's answer: its cost, the fewest
  hops among its shortest paths, and whether it was reached.

``cap`` saturates every key at a ceiling that also stands for
"unreachable": ``INF`` (10**9) for the int32 travel times the
configurations state, and 32,767 for the int16 control (a saturating
narrower integer, the nearest precision below the stated one).
"""

from __future__ import annotations

import torch

#: the program's "unreachable" (int32 travel times; INF + INF fits)
INF = 10 ** 9
#: the ceiling of an int16 distance: the control's precision
INT16_CAP = 2 ** 15 - 1
#: hop-count bits of a route key (hops < 2**20 nodes)
HOP_BITS = 20
#: Bellman-Ford steps between two fixed-point checks
CHECK_EVERY = 16


def to_targets(n: int, src: torch.Tensor, dst: torch.Tensor,
               key_w: torch.Tensor, targets: torch.Tensor,
               cap: int) -> torch.Tensor:
    """int64 ``[B, N]``: the least key of a path ``u -> targets[b]``
    (sum of ``key_w`` over its edges), saturated at ``cap`` (``cap`` where
    no path is cheaper). ``src``, ``dst``: int64 ``[M]`` edges; ``key_w``:
    int64 ``[M]``; ``targets``: int64 ``[B]``."""
    b = targets.shape[0]
    dev = src.device
    d = torch.full((b, n), cap, dtype=torch.int64, device=dev)
    d[torch.arange(b, device=dev), targets] = 0
    index = src.expand(b, -1)
    step = 0
    while True:
        before = d if step % CHECK_EVERY == 0 else None
        cand = d[:, dst].add_(key_w).clamp_(max=cap)
        d = d.scatter_reduce(1, index, cand, "amin", include_self=True)
        step += 1
        if before is not None and torch.equal(before, d):
            return d
        if step > n + CHECK_EVERY:
            raise RuntimeError("Bellman-Ford found no fixed point")


def out_slots(n: int, src: torch.Tensor) -> torch.Tensor:
    """int64 ``[M]``: each edge's rank among its source's out-edges in
    file (edge id) order."""
    order = torch.sort(src, stable=True).indices
    counts = torch.bincount(src, minlength=n)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(order)
    rank[order] = torch.arange(src.shape[0], device=src.device)
    return rank - starts[src]


def first_moves(n: int, src: torch.Tensor, dst: torch.Tensor,
                w: torch.Tensor, targets: torch.Tensor,
                cap: int = INF) -> torch.Tensor:
    """int8 ``[B, N]`` first-move rows of ``targets`` (int64 ``[B]``)."""
    dist = to_targets(n, src, dst, w, targets, cap)
    b = targets.shape[0]
    via = dist[:, dst].add_(w).clamp_(max=cap)
    index = src.expand(b, -1)
    best = torch.full((b, n), cap, dtype=torch.int64, device=src.device)
    best = best.scatter_reduce(1, index, via, "amin", include_self=True)
    slot = out_slots(n, src).expand(b, -1)
    big = torch.iinfo(torch.int64).max
    pick = torch.where(via == best.gather(1, index), slot,
                       torch.full_like(slot, big))
    fm = torch.full((b, n), big, dtype=torch.int64, device=src.device)
    fm = fm.scatter_reduce(1, index, pick, "amin", include_self=True)
    fm[best >= cap] = -1
    fm[torch.arange(b, device=src.device), targets] = -1
    return fm.to(torch.int8)


def route_answers(n: int, src: torch.Tensor, dst: torch.Tensor,
                  w: torch.Tensor, s: torch.Tensor, t: torch.Tensor,
                  cap: int = INF):
    """``(cost, plen, finished)`` of the queries ``s[q] -> t[q]`` (int64
    ``[Q]``): the distance, the fewest hops among the shortest paths, and
    whether ``t`` is reached below ``cap``; cost and plen 0 where not."""
    key_w = w * (1 << HOP_BITS) + 1
    keys = to_targets(n, src, dst, key_w, t, cap << HOP_BITS)
    key = keys[torch.arange(t.shape[0], device=t.device), s]
    fin = key < (cap << HOP_BITS)
    cost = torch.where(fin, key >> HOP_BITS, 0)
    plen = torch.where(fin, key & ((1 << HOP_BITS) - 1), 0)
    return cost, plen, fin
