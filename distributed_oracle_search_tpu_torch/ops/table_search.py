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

With ``packed4=True`` the walk reads a pack4-resident table
(``models.resident``), one nibble per slot: the plain version of the
kernel's pack4 entry. :func:`table_search_multi` is the fused multi-diff
walk (D weight sets summed along one trajectory), the plain version of
the kernel's multi entry (``cuda_walk.cuda_walk_multi``).
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
    """The walk's ``(next-node, query-time weight)`` per out-slot, planar:
    int32 ``[2, N, K']`` — plane 0 the next node, plane 1 the weight —
    so one gather per plane drives the move and the cost (the JAX walk
    packs the same pairs interleaved). ``K'`` is ``K`` rounded up to a
    multiple of 4, so each node's next-node row starts on 16 bytes (the
    CUDA walk reads it as 16-byte vectors); the added slots are ELL
    padding (the node itself, the INF weight) and no first move names
    them."""
    nbr, eid = dg.out_nbr, dg.out_eid
    extra = -dg.k % 4
    if extra:
        self_ = torch.arange(dg.n, dtype=nbr.dtype, device=nbr.device)
        nbr = torch.cat([nbr, self_[:, None].expand(dg.n, extra)], dim=1)
        eid = torch.cat([eid, eid.new_full((dg.n, extra),
                                           w_query_pad.shape[0] - 1)], dim=1)
    return torch.stack([nbr.to(torch.int32),
                        w_query_pad[eid.long()].to(torch.int32)]
                       ).contiguous()


def fm_slot(fm: torch.Tensor, rows: torch.Tensor, x: torch.Tensor,
            packed4: bool = False) -> torch.Tensor:
    """int32 first-move slot ``fm[rows, x]`` per lane. ``packed4``: ``fm``
    holds pack4 nibble rows (``models.resident``), slot ``x`` is nibble
    ``x & 1`` of byte ``x >> 1``, and the marker 15 reads as -1."""
    x = x.long()
    if not packed4:
        return fm[rows, x].to(torch.int32)
    byte = fm[rows, x >> 1].to(torch.int32)
    v = (byte >> ((x & 1) * 4).to(torch.int32)) & 0xF
    return torch.where(v == 15, -1, v)


def table_search_batch(dg: DeviceGraph, fm: torch.Tensor,
                       t_rows: torch.Tensor, s: torch.Tensor,
                       t: torch.Tensor, w_query_pad: torch.Tensor,
                       valid: torch.Tensor | None = None,
                       k_moves: int = -1, max_steps: int = 0,
                       unroll: int = 8, n_buckets: int = 0,
                       packed4: bool = False,
                       pair: torch.Tensor | None = None):
    """Answer a batch of queries against a first-move shard.

    Parameters
    ----------
    fm          : int8 [R, N] first-move rows (R = targets owned by this
                  shard), or with ``packed4`` uint8 [R, ceil(N/2)] pack4
                  nibble rows (``models.resident.encode_pack4``)
    t_rows      : int32 [Q] row index of each query's target within ``fm``
    s, t        : int32 [Q] global source / target node ids
    w_query_pad : int32 [M+1] query-time weights (diff applied; last = INF)
    valid       : bool [Q] padding mask (False rows return zeros, unfinished)
    k_moves     : per-batch move budget, -1 = unlimited (reference semantics)
    max_steps   : loop bound; 0 = N (safe upper bound for simple paths)
    unroll      : moves per loop iteration — the step-bound quantum above
    n_buckets   : accepted for signature parity; results are
                  bucket-invariant and the batch walks as one
    packed4     : read each slot from a nibble row (see ``fm``)
    pair        : ``walk_pairs(dg, w_query_pad)`` built beforehand (a
                  caller that walks one weight set many times keeps it);
                  None builds it here

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
    if pair is None:
        pair = walk_pairs(dg, w_query_pad)

    def slot_at(x):
        return fm_slot(fm, rows, x, packed4)

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
            at = (x.long(), slot.clamp_min(0).long())
            cost = torch.where(can, cost + pair[1][at], cost)
            plen = torch.where(can, plen + 1, plen)
            x = torch.where(can, pair[0][at], x)
            halted = halted | ~can
        it += unroll
    fin = (x == t32) & valid
    cost = torch.where(valid, cost, 0)
    plen = torch.where(valid, plen, 0)
    return cost, plen, fin


def walk_eid_pairs(dg: DeviceGraph) -> torch.Tensor:
    """The fused multi-diff walk's ``(next-node, edge id)`` per out-slot,
    planar: int32 ``[2, N, K']`` laid out as :func:`walk_pairs` (``K'``
    a multiple of 4, padding slots the node itself and edge id ``M``,
    the INF row of the weights). Edge ids carry no weight, so one table
    serves every weight set of a graph."""
    return walk_pairs(dg, torch.arange(dg.w_pad.shape[0], dtype=torch.int32,
                                       device=dg.device))


def weights_width(d: int) -> int:
    """Ints a row of the fused walk kernel's :func:`weights_t` takes:
    ``d`` rounded up to 8 (a kernel thread sums 8 weight sets, read as
    two 16-byte vectors)."""
    return -(-d // 8) * 8


def weights_t(w_pads: torch.Tensor, width: int | None = None
              ) -> torch.Tensor:
    """``[M+1, width]`` contiguous int32 (``width`` defaults to D): the
    D padded weight rows transposed, so one move reads its edge's D
    weights as one row, zero past D."""
    d, m1 = w_pads.shape
    if width is None or width == d:
        return w_pads.to(torch.int32).T.contiguous()
    w_t = torch.zeros((m1, width), dtype=torch.int32, device=w_pads.device)
    w_t[:, :d] = w_pads.T
    return w_t


def table_search_multi(dg: DeviceGraph, fm: torch.Tensor,
                       t_rows: torch.Tensor, s: torch.Tensor,
                       t: torch.Tensor, w_pads: torch.Tensor,
                       valid: torch.Tensor | None = None,
                       max_steps: int = 0,
                       pair: torch.Tensor | None = None):
    """Answer a batch under D congestion diffs in ONE walk (the JAX
    package's ``ops/table_search.py::table_search_multi``).

    A trajectory is diff-independent — moves follow the free-flow
    first-move table, only the cost sums see the query-time weights — so
    one walk sums every diff's cost at once: each move reads its
    ``(next node, edge id)`` pair and the edge's D weights.

    Parameters as :func:`table_search_batch`, except ``w_pads``: int32
    ``[D, M+1]``, one padded weight row per diff (include free flow as a
    row to fuse it too). There is no ``k_moves``: the fused path serves
    the unlimited default; an explicit ``max_steps`` caps ``plen`` at
    every step exactly as the single walk's, and a lane that never halts
    stops at the single walk's default bound (``unroll`` 8). ``pair``:
    :func:`walk_eid_pairs`, built here when None.

    Returns ``(cost [D, Q] int32, plen [Q], finished [Q])`` — plen and
    finished are shared across diffs because the trajectory is. Costs
    wrap like int32 adds."""
    q = s.shape[0]
    dev = s.device
    d = w_pads.shape[0]
    if valid is None:
        valid = torch.ones(q, dtype=torch.bool, device=dev)
    unroll = 8
    steps, budget = walk_budget(dg.n, -1, int(max_steps), unroll)
    rows = t_rows.long()
    t32 = t.to(torch.int32)
    if pair is None:
        pair = walk_eid_pairs(dg)
    w_t = weights_t(w_pads)

    x = torch.where(valid, s.to(torch.int32), t32)
    halted = (fm_slot(fm, rows, x) < 0) | ~valid
    cost = torch.zeros((q, d), dtype=torch.int32, device=dev)
    plen = torch.zeros(q, dtype=torch.int32, device=dev)
    it = 0
    while it < steps and q and not bool(halted.all()):
        for _ in range(unroll):
            slot = fm_slot(fm, rows, x)
            can = ~halted & (slot >= 0)
            if budget is not None:
                can &= plen < budget
            at = (x.long(), slot.clamp_min(0).long())
            w_row = w_t[pair[1][at].long()]                  # [Q, D]
            cost = torch.where(can[:, None], cost + w_row, cost)
            plen = torch.where(can, plen + 1, plen)
            x = torch.where(can, pair[0][at], x)
            halted = halted | ~can
        it += unroll
    fin = (x == t32) & valid
    cost = torch.where(valid[:, None], cost, 0).T.contiguous()
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
        slot = fm_slot(fm, rows, x)
        can = (slot >= 0) & (x != t32)
        nxt = dg.out_nbr[x.long(), slot.clamp_min(0).long()]
        x = torch.where(can, nxt, x)
        nodes.append(x)
        plen += can.to(torch.int32)
    return torch.stack(nodes, dim=1), plen
