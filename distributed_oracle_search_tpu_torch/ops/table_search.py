"""Batched ``table-search``: the plain-torch walk.

The reference's resident query server answers each (s, t) by repeated
first-move table lookups, accumulating cost on the possibly
congestion-perturbed graph (``fifo_auto --alg table-search``, reference
``make_fifos.py:20-22``). Here the whole query batch advances in
lock-step, one gather per step for every lane at once.

This module is the plain version of the walk: the CPU path of
:func:`.cuda_walk.cuda_walk_batch` and the yardstick its CUDA kernel is
held against on the card. It is the port of the JAX package's
``ops/table_search.py`` (the XLA walk), whose semantics it keeps
exactly (and which must match ``models.reference.table_search_walk``):

* moves follow the **free-flow** first-move table; costs accumulate on
  the **query-time** weights (diff applied to ``w_query_pad`` only),
* a query finishes when it reaches its target; it stops unfinished on a
  ``-1`` first move (unreachable) or when the move budget (``k_moves``,
  reference ``args.py:31-36``) runs out,
* ``plen`` = number of edges followed,
* the loop steps ``unroll`` moves per iteration while ``it < limit``, so
  a lane that never halts (a corrupted, cyclic row) takes exactly
  ``ceil(limit / unroll) * unroll`` steps.
"""

from __future__ import annotations

import torch

from .device_graph import DeviceGraph


#: auto-bucketing: target lanes per bucket / bucket-count cap (the JAX
#: walk's values; the torch walk is bucket-invariant and keeps the
#: resolver for signature parity)
BUCKET_LANES = 1024
BUCKET_MAX = 64


def pick_buckets(q: int, n_buckets: int = 0) -> int:
    """Resolve the bucket knob: 0 = auto (≤ ``BUCKET_MAX`` buckets with ≥
    ``BUCKET_LANES`` lanes each). Either way the result is the largest
    divisor of ``q`` not exceeding the requested count, so an awkward
    batch size degrades to the nearest usable split, not to 1."""
    b = min(BUCKET_MAX, max(1, q // BUCKET_LANES)) if n_buckets == 0 \
        else min(max(1, n_buckets), max(q, 1))
    while b > 1 and q % b:
        b -= 1
    return b


def walk_budget(n: int, k_moves: int, max_steps: int,
                unroll: int) -> tuple[int, int | None]:
    """The walk's two bounds: ``(steps, budget)``.

    ``steps`` is the most moves a lane can take — the lock-step loop's
    ``ceil(limit / unroll) * unroll`` with ``limit = max_steps or N``.
    ``budget`` is the per-step ``plen`` cap: None in the unlimited mode
    (``k_moves < 0 and max_steps == 0``, no compare at all), else
    ``limit`` when ``k_moves < 0`` and ``k_moves`` otherwise."""
    limit = n if max_steps == 0 else max_steps
    unroll = max(int(unroll), 1)
    steps = -(-limit // unroll) * unroll if limit > 0 else 0
    if k_moves < 0 and max_steps == 0:
        return steps, None
    return steps, (limit if k_moves < 0 else k_moves)


def walk_pairs(dg: DeviceGraph, w_query_pad: torch.Tensor) -> torch.Tensor:
    """Packed ``(next-node, query-time weight)`` per out-slot: int32
    ``[N, K, 2]`` — one gather (one 8-byte read) per walk step drives
    both the move and the cost, as the JAX walk packs it."""
    return torch.stack([dg.out_nbr.to(torch.int32),
                        w_query_pad[dg.out_eid.long()].to(torch.int32)],
                       dim=-1).contiguous()


def table_search_batch(dg: DeviceGraph, fm: torch.Tensor,
                       t_rows: torch.Tensor, s: torch.Tensor,
                       t: torch.Tensor, w_query_pad: torch.Tensor,
                       valid: torch.Tensor | None = None,
                       k_moves: int = -1, max_steps: int = 0,
                       unroll: int = 8, n_buckets: int = 0):
    """Answer a batch of queries against a first-move shard.

    Parameters
    ----------
    fm          : int8 [R, N] first-move rows (R = targets owned by this shard)
    t_rows      : int32 [Q] row index of each query's target within ``fm``
    s, t        : int32 [Q] global source / target node ids
    w_query_pad : int32 [M+1] query-time weights (diff applied; last = INF)
    valid       : bool [Q] padding mask (False rows return zeros, unfinished)
    k_moves     : per-batch move budget, -1 = unlimited (reference semantics)
    max_steps   : loop bound; 0 = N (safe upper bound for simple paths)
    unroll      : moves per loop iteration — the step-bound quantum above
    n_buckets   : accepted for signature parity; results are
                  bucket-invariant and the batch walks as one

    Returns
    -------
    cost [Q] int32, plen [Q] int32, finished [Q] bool
    """
    del n_buckets
    q = s.shape[0]
    dev = s.device
    if valid is None:
        valid = torch.ones(q, dtype=torch.bool, device=dev)
    steps, budget = walk_budget(dg.n, int(k_moves), int(max_steps), unroll)
    unroll = max(int(unroll), 1)
    rows = t_rows.long()
    t32 = t.to(torch.int32)
    pair = walk_pairs(dg, w_query_pad)

    def slot_at(x):
        return fm[rows, x.long()].to(torch.int32)

    # birth rule: pad lanes start at t (zero-length) and halted; real
    # lanes halt on a -1 first move
    x = torch.where(valid, s.to(torch.int32), t32)
    halted = (slot_at(x) < 0) | ~valid
    cost = torch.zeros(q, dtype=torch.int32, device=dev)
    plen = torch.zeros(q, dtype=torch.int32, device=dev)
    it = 0
    while it < steps and q and not bool(halted.all()):
        for _ in range(unroll):
            slot = slot_at(x)
            can = ~halted & (slot >= 0)
            if budget is not None:
                can &= plen < budget
            nxt_w = pair[x.long(), slot.clamp_min(0).long()]
            cost = torch.where(can, cost + nxt_w[:, 1], cost)
            plen = torch.where(can, plen + 1, plen)
            x = torch.where(can, nxt_w[:, 0], x)
            halted = halted | ~can
        it += unroll
    fin = (x == t32) & valid
    cost = torch.where(valid, cost, 0)
    plen = torch.where(valid, plen, 0)
    return cost, plen, fin


def extract_paths(dg: DeviceGraph, fm: torch.Tensor, t_rows: torch.Tensor,
                  s: torch.Tensor, t: torch.Tensor, k: int):
    """Materialize the first ``k`` moves of each query's CPD path.

    The reference's prefix extraction (``--k-moves``, reference
    ``args.py:31-36``: "number of moves to extract"): beyond a cost, a
    navigation client wants the next few road segments.

    Returns ``(nodes, plen)``: int32 ``[Q, k+1]`` node ids — row q starts
    at ``s[q]``; after the path ends (target reached or stuck) the last
    node repeats — and the number of real moves taken (≤ k).
    """
    rows = t_rows.long()
    t32 = t.to(torch.int32)
    x = s.to(torch.int32)
    nodes = [x]
    plen = torch.zeros(x.shape[0], dtype=torch.int32, device=x.device)
    for _ in range(int(k)):
        slot = fm[rows, x.long()].to(torch.int32)
        can = (slot >= 0) & (x != t32)
        nxt = dg.out_nbr[x.long(), slot.clamp_min(0).long()]
        x = torch.where(can, nxt, x)
        nodes.append(x)
        plen += can.to(torch.int32)
    return torch.stack(nodes, dim=1), plen
