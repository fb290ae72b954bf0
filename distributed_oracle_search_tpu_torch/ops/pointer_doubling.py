"""Pointer doubling: whole-shard path costs in O(log L) sweeps.

Port of the JAX package's ``ops/pointer_doubling.py`` (jitted XLA there,
no Pallas kernel). A table-search walk is a chain of up to L dependent
gathers. Instead of walking each query, **double the successor
function**: with

    S_0[r, x] = next node on the CPD path from x toward target r
    C_0[r, x] = query-time cost of that one move

repeated squaring

    S_{k+1}[r, x] = S_k[r, S_k[r, x]]
    C_{k+1}[r, x] = C_k[r, x] + C_k[r, S_k[r, x]]

converges in ceil(log2 L) sweeps to the total cost from every node to
every owned target; after that any (s, t) query is one gather, on diffed
weights too.

Self-loops make the recursion total: the target itself and stuck
(unreachable) nodes point at themselves with step cost 0, so their
accumulated cost is exactly the walk's cost-until-stuck. Squaring is
double-buffered (Jacobi): every new value reads the previous sweep's
arrays, as the JAX ``while_loop`` does — an in-place pointer jump is a
different recursion and shows at ``max_len`` cuts. The loop runs
``max((limit - 1).bit_length(), 1)`` sweeps and stops early after the
first sweep that changes no successor.

Layout: each (row, node) entry is one int32 **record** ``(succ, plen,
cost[0:D])`` padded to a multiple of 4 ints (16 bytes), the nodes of a
row in node order or in a caller's ``order``: :func:`record_order`, a
Z-order of the coordinates, puts a successor near its node in the row,
and on the card in the same block's shared memory (``CPDOracle``
computes it once and passes it in). :func:`initial_records` builds the
records in that order and :func:`_finish` puts the tables back in node
order; the recursion is the same on any labelling. On the card a
chunk's rows double on chip (:func:`.cuda_doubling.doubling_rows`, K5):
each row's records are read once into shared memory (a block's, or a
thread-block cluster's), swept until the row's own first sweep that
moves no successor, and written back once with the row's ``settled``
sweep and ``live`` bit (:func:`double_rows` defines both, and is the
plain version the CPU runs). The JAX loop runs the same number of sweeps
K on every row of a chunk; a row may stop at its own count only where
the extra sweeps change nothing, which fails exactly where a fixed point
carries plen or cost (a cycle of a corrupted or zero-weight first-move
table): those rows are doubled again from their first records for
exactly K sweeps. A row no cluster of the card holds is doubled the
same way by teams of co-resident blocks (:func:`.cuda_doubling.
doubling_team`: each block's window of the row in shared memory, the
rest gathered from the row's copies in device memory), the chunk in one
launch; a row no team holds either takes the wide path: one
:func:`.cuda_doubling.doubling_sweep` launch a sweep over device memory,
double-buffered, a flag read after each. :func:`.cuda_doubling.
rows_plan` is the shape rule. Building the
first records (the slot gather) and the final sign-packing are plain
torch.

Results keep the JAX layouts: ``cost [R, N]`` int32 (single) or ``costs
[R, N, D]`` with D innermost (multi), and the sign-packed ``plen``:
finished entries store ``plen``, unfinished ``-plen - 1``, in int16 when
``N < 2^15`` else int32 (:func:`plen_dtype`). A table is 6-8 bytes an
entry (single) or ``4 D + 2-4`` (multi): ``models.cpd.CPDOracle``
gates its size before allocating.
"""

from __future__ import annotations

import numpy as np
import torch

from ..data.graph import Graph
from ..utils.log import get_logger
from .device_graph import DeviceGraph

log = get_logger(__name__)
_logged: set[tuple] = set()


def plen_dtype(n: int) -> torch.dtype:
    """Packed-plen dtype: int16 when every path length (< N) fits with
    the sign bit spare, else int32."""
    return torch.int16 if n < (1 << 15) else torch.int32


def record_width(d: int) -> int:
    """int32 fields a record takes: ``succ, plen, cost[0:d]`` rounded up
    to a multiple of 4 (16 bytes)."""
    return -(-(2 + d) // 4) * 4


def n_sweeps(n: int, max_len: int = 0) -> int:
    """The most sweeps a table takes: ``max((limit - 1).bit_length(),
    1)`` with ``limit = max_len or N``."""
    limit = n if max_len == 0 else max_len
    return max(int(limit - 1).bit_length(), 1)


def record_order(g: Graph, device) -> torch.Tensor:
    """A layout of a row's records (new → old, int64 on ``device``):
    the nodes along the Z-order curve of their coordinates, each scaled
    to 16 bits. Nodes next to each other in it lie near each other on
    the map, so a range of it is a compact region."""
    code = np.zeros(g.n, np.uint64)
    for i, c in enumerate((np.asarray(g.xs), np.asarray(g.ys))):
        lo = c.min() if len(c) else 0
        span = max(int(c.max() - lo), 1) if len(c) else 1
        q = ((c - lo).astype(np.float64) * 65535 / span).astype(np.uint64)
        for b in range(16):
            code |= ((q >> np.uint64(b)) & np.uint64(1)) << np.uint64(2 * b
                                                                      + i)
    return torch.as_tensor(np.argsort(code, kind="stable"),
                           dtype=torch.int64, device=device)


def _inverse(order: torch.Tensor) -> torch.Tensor:
    """The position of each node in ``order`` (old → new), int64."""
    inv = torch.empty_like(order)
    inv[order] = torch.arange(len(order), dtype=order.dtype,
                              device=order.device)
    return inv


def initial_records(dg: DeviceGraph, fm: torch.Tensor,
                    w_pads: torch.Tensor,
                    order: torch.Tensor | None = None) -> torch.Tensor:
    """The one-move records: int32 ``[R, N, P]`` (:func:`record_width`)
    with ``succ`` the free-flow next node (the node itself at its target
    and where stuck), ``plen`` 1 or 0, ``cost[d]`` the move's weight
    under ``w_pads[d]`` (0 on a self-loop) and zero padding. Position
    ``i`` of a row is node ``order[i]`` (node ``i`` when ``order`` is
    None) and ``succ`` a position."""
    r, n = fm.shape
    d = w_pads.shape[0]
    dev = fm.device
    # int32 indices where they fit: the [R, N] index temporaries are the
    # prepare's largest besides the records
    it = torch.int32 if n * dg.k < 2 ** 31 else torch.int64
    if order is None:
        x = torch.arange(n, dtype=it, device=dev)
        slot = fm.to(it)
    else:
        x = order.to(it)
        slot = fm.index_select(1, order).to(it)
    can = slot >= 0
    flat = (x[None, :] * dg.k + slot.clamp_min_(0)).view(-1)  # [R * N]
    del slot
    rec = torch.zeros((r, n, record_width(d)), dtype=torch.int32,
                      device=dev)
    nxt = dg.out_nbr.reshape(-1).index_select(0, flat)
    if order is not None:
        nxt = _inverse(order).to(torch.int32).index_select(0, nxt)
    rec[..., 0] = torch.where(
        can, nxt.view(r, n),
        torch.arange(n, dtype=torch.int32, device=dev)[None, :])
    del nxt
    rec[..., 1] = can
    eid = dg.out_eid.reshape(-1).index_select(0, flat)
    del flat
    w_t = w_pads.to(torch.int32).T.contiguous()              # [M+1, D]
    rec[..., 2:2 + d] = torch.where(
        can[..., None], w_t.index_select(0, eid).view(r, n, d), 0)
    return rec


def _sweep(rec: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One plain doubling sweep of int32 ``[R, N, P]`` records: ``(new
    records, moved [R])``. Every field of the new record reads the old
    arrays: ``succ`` the successor's successor, ``plen`` and each cost
    the own value plus the successor's (int32 adds, wrapping);
    ``moved[r]`` is whether a successor of row r moved."""
    succ = rec[..., 0]
    gat = torch.gather(rec, 1, succ.long()[..., None].expand_as(rec))
    new = rec + gat
    new[..., 0] = gat[..., 0]
    return new, (gat[..., 0] != succ).any(1)


def sweep_records(rec: torch.Tensor) -> tuple[torch.Tensor, bool]:
    """One plain doubling sweep of int32 ``[R, N, P]`` records: ``(new
    records, changed)``, ``changed`` whether any successor moved (the
    wide path's sweep; :func:`_sweep`)."""
    new, moved = _sweep(rec)
    return new, bool(moved.any())


def double_rows(rec: torch.Tensor, d: int, sweeps: int,
                fixed: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain on-chip doubling (:func:`.cuda_doubling.doubling_rows`'s
    CPU branch): every row of int32 ``[R, N, P]`` records doubled in
    place, row by row as the kernel does: up to ``sweeps`` Jacobi sweeps,
    a row stopping after its first sweep that moves no successor, or
    exactly ``sweeps`` a row when ``fixed``. ``d`` is the kernel's
    record shape (``P = record_width(d)``); the sweep reads every field.

    Returns ``(settled int32 [R], live bool [R])``: ``settled[r]`` the
    1-based index of the first sweep that moved no successor of row r (0
    when no successor differs from its node at the start, ``sweeps``
    when none settled within them); ``live[r]`` whether some fixed point
    ``y`` (``succ[y] == y``) of the final records has a field past
    ``succ`` that is not 0 (on :func:`initial_records`' records: plen, a
    cycle; a target or stuck node stays ``(y, 0, 0)``)."""
    r, n, _ = rec.shape
    del d
    x = torch.arange(n, dtype=torch.int32, device=rec.device)
    moving = (rec[..., 0] != x).any(1)
    settled = torch.zeros(r, dtype=torch.int32, device=rec.device)
    run = torch.ones_like(moving) if fixed else moving.clone()
    for i in range(1, sweeps + 1):
        idx = run.nonzero().flatten()
        if idx.numel() == 0:
            break
        new, moved = _sweep(rec[idx])
        rec[idx] = new
        del new
        first = ~moved & moving[idx] & (settled[idx] == 0)
        settled[idx[first]] = i
        if not fixed:
            run[idx[~moved]] = False
    settled = torch.where(moving & (settled == 0), sweeps, settled)
    live = ((rec[..., 0] == x) & (rec[..., 1:] != 0).any(-1)).any(1)
    return settled.to(torch.int32), live


def _finish(rec: torch.Tensor, targets: torch.Tensor, d: int,
            order: torch.Tensor | None = None, out=None):
    """``(costs [R, N, D], plen_packed [R, N])`` in node order from
    converged records laid out in ``order`` (new → old; None: node
    order) — into ``out``, a pair of tensors of those shapes, when
    given."""
    n = rec.shape[1]
    targets = targets.to(device=rec.device, dtype=torch.int32)
    valid = targets >= 0
    t_pos = torch.where(valid, targets, 0)
    inv = None
    if order is not None:
        inv = _inverse(order)
        t_pos = inv[t_pos.long()].to(torch.int32)
    finished = (rec[..., 0] == t_pos[:, None]) & valid[:, None]
    plen = rec[..., 1]
    packed = torch.where(finished, plen, -plen - 1).to(plen_dtype(n))
    costs = rec[..., 2:2 + d]
    # back to node order: node j's value is at position inv[j]
    if out is None:
        if inv is None:
            return costs.contiguous(), packed
        return costs.index_select(1, inv), packed.index_select(1, inv)
    for src, dst in ((costs, out[0]), (packed, out[1])):
        if inv is None:
            dst.copy_(src.reshape(dst.shape))
        elif dst.is_contiguous():
            torch.index_select(src, 1, inv, out=dst.view(src.shape))
        else:
            dst.copy_(src.index_select(1, inv).reshape(dst.shape))
    return out


def doubled_tables_multi(dg: DeviceGraph, fm: torch.Tensor,
                         targets: torch.Tensor, w_pads: torch.Tensor,
                         max_len: int = 0, out=None,
                         order: torch.Tensor | None = None):
    """All-source cost tables for one fm shard under D weight sets at once.

    The successor function is diff-independent (free-flow moves), so the
    recursion is shared: each sweep squares ``succ`` and sums every
    set's costs from one record.

    ``fm``: int8 ``[R, N]``; ``targets``: int32 ``[R]`` global node id
    of each row's target (-1 pad); ``w_pads``: int32 ``[D, M+1]``;
    ``max_len``: path-length bound (0 = N). ``out``: ``(costs [R, N, D],
    plen_packed [R, N])`` to write into. ``order``: the records' layout
    (:func:`record_order`; None: node order). A chunk is one
    ``doubling_rows`` call, or one ``doubling_team`` call past the
    largest cluster (plus one for the rows rerun), or, on the wide path,
    one ``doubling_sweep`` a sweep; their counters count launches and
    ``doubled_tables_multi.sweeps`` the sweeps (K a chunk).

    Returns ``(costs [R, N, D] int32, plen_packed [R, N])`` — ``plen`` and
    ``finished`` ride one sign-packed array because the trajectory is
    shared. Rows with ``targets[r] < 0`` are all-unfinished padding."""
    from .cuda_doubling import (doubling_rows, doubling_team, plan_tier,
                                rows_plan)

    n = fm.shape[1]
    d = w_pads.shape[0]
    limit = n_sweeps(n, max_len)
    plan = rows_plan(n, d, fm.device)
    tier = plan_tier(plan)
    shape = (fm.device.type, n, d)
    if shape not in _logged:
        _logged.add(shape)
        log.info("doubling %d nodes x %d cost sets on %s: %s", n, d,
                 fm.device.type, "the wide path (no team holds a row)"
                 if tier == "sweep" else
                 f"on chip, {plan[0]} block(s) a row of {plan[2]} nodes, "
                 f"{plan[1]} threads and {plan[3]} shared bytes a block"
                 + (f", {plan[4]} teams" if tier == "team" else ""))
    if tier == "sweep":
        rec, k = _double_wide(dg, fm, w_pads, limit, order)
    else:
        double = doubling_team if tier == "team" else doubling_rows
        rec = initial_records(dg, fm, w_pads, order)
        settled, live = double(rec, d, limit)
        k = min(limit, int(settled.max())) if len(settled) else 0
        redo = (live & (settled < k)).nonzero().flatten()
        if redo.numel():
            sub = initial_records(dg, fm[redo], w_pads, order)
            double(sub, d, k, fixed=True)
            rec[redo] = sub
            del sub
    doubled_tables_multi.sweeps += k
    return _finish(rec, targets, d, order, out)


doubled_tables_multi.sweeps = 0


def _double_wide(dg: DeviceGraph, fm: torch.Tensor, w_pads: torch.Tensor,
                 limit: int, order: torch.Tensor | None
                 ) -> tuple[torch.Tensor, int]:
    """The wide path: padded records swept in device memory, one
    :func:`.cuda_doubling.doubling_sweep` a sweep into the other buffer,
    until a sweep moves no successor or ``limit`` sweeps. Returns the
    final records and the sweeps run."""
    from .cuda_doubling import doubling_sweep

    n = fm.shape[1]
    rec = initial_records(dg, fm, w_pads, order)
    x = torch.arange(n, dtype=torch.int32, device=rec.device)
    changed = bool((rec[..., 0] != x[None, :]).any())
    spare = torch.empty_like(rec)
    flag = torch.zeros(1, dtype=torch.int32, device=rec.device)
    i = 0
    while changed and i < limit:
        flag.zero_()
        doubling_sweep(rec, spare, flag)
        rec, spare = spare, rec
        i += 1
        changed = bool(flag.item())
    return rec, i


def doubled_tables(dg: DeviceGraph, fm: torch.Tensor, targets: torch.Tensor,
                   w_query_pad: torch.Tensor, max_len: int = 0, out=None,
                   order: torch.Tensor | None = None):
    """All-source cost + packed-plen tables for one fm shard under one
    weight set (``w_query_pad`` int32 ``[M+1]``): the multi recursion at
    D = 1, whose sums are the same int32 adds. ``out``: ``(cost [R, N],
    plen_packed [R, N])``. Returns ``(cost [R, N] int32, plen_packed
    [R, N])`` (:func:`plen_dtype`); see :func:`doubled_tables_multi`."""
    cost, packed = doubled_tables_multi(
        dg, fm, targets, w_query_pad.reshape(1, -1), max_len=max_len,
        out=out, order=order)
    return cost.reshape(fm.shape), packed


def _decode(pp: torch.Tensor):
    pp = pp.to(torch.int32)
    f = pp >= 0
    return torch.where(f, pp, -pp - 1), f


def lookup_tables(cost: torch.Tensor, plen_packed: torch.Tensor,
                  t_rows: torch.Tensor, s: torch.Tensor,
                  valid: torch.Tensor | None = None):
    """Answer queries from prepared tables: one 2-D gather each.
    ``finished = packed >= 0``, ``plen = packed`` when finished else
    ``-packed - 1``; masked lanes (``valid`` False) come back 0, 0,
    unfinished. Returns ``(cost, plen, finished)``, int32/int32/bool."""
    rows, s = t_rows.long(), s.long()
    c = cost[rows, s]
    p, f = _decode(plen_packed[rows, s])
    if valid is not None:
        c = torch.where(valid, c, 0)
        p = torch.where(valid, p, 0)
        f = f & valid
    return c, p, f


def lookup_tables_multi(costs: torch.Tensor, plen_packed: torch.Tensor,
                        t_rows: torch.Tensor, s: torch.Tensor,
                        valid: torch.Tensor | None = None):
    """Answer queries from fused multi-diff tables: one contiguous
    ``[D]``-wide gather a query plus the shared plen gather. Returns
    ``(cost [D, Q], plen [Q], finished [Q])``."""
    rows, s = t_rows.long(), s.long()
    cost_qd = costs[rows, s]                                 # [Q, D]
    p, f = _decode(plen_packed[rows, s])
    if valid is not None:
        cost_qd = torch.where(valid[:, None], cost_qd, 0)
        p = torch.where(valid, p, 0)
        f = f & valid
    return cost_qd.T, p, f


def unpack_tables(cost: torch.Tensor, plen_packed: torch.Tensor):
    """Whole-table decode ``(cost, plen, finished)`` — for tests and
    direct table consumers; serving uses :func:`lookup_tables`."""
    p, f = _decode(plen_packed)
    return cost, p, f
