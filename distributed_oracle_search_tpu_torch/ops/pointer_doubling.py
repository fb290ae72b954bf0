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
cost[0:D])`` padded to a multiple of 4 ints (16 bytes), so a sweep reads
an entry's successor's whole record in one or two 16-byte loads — the
JAX package packs the same fields for one gather. One sweep is
:func:`.cuda_doubling.doubling_sweep`: the hand kernel (K5) on the card,
:func:`sweep_records` (plain torch) on the CPU. Building the first
records (the slot gather) and the final sign-packing are plain torch.

Results keep the JAX layouts: ``cost [R, N]`` int32 (single) or ``costs
[R, N, D]`` with D innermost (multi), and the sign-packed ``plen``:
finished entries store ``plen``, unfinished ``-plen - 1``, in int16 when
``N < 2^15`` else int32 (:func:`plen_dtype`). A table is 6-8 bytes an
entry (single) or ``4 D + 2-4`` (multi): ``models.cpd.CPDOracle``
gates its size before allocating.
"""

from __future__ import annotations

import torch

from .device_graph import DeviceGraph


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


def initial_records(dg: DeviceGraph, fm: torch.Tensor,
                    w_pads: torch.Tensor) -> torch.Tensor:
    """The one-move records: int32 ``[R, N, P]`` (:func:`record_width`)
    with ``succ`` the free-flow next node (the node itself at its target
    and where stuck), ``plen`` 1 or 0, ``cost[d]`` the move's weight
    under ``w_pads[d]`` (0 on a self-loop) and zero padding."""
    r, n = fm.shape
    d = w_pads.shape[0]
    dev = fm.device
    slot = fm.to(torch.int32)
    can = slot >= 0
    x = torch.arange(n, dtype=torch.int64, device=dev)
    flat = x[None, :] * dg.k + slot.clamp_min(0).long()       # [R, N]
    rec = torch.zeros((r, n, record_width(d)), dtype=torch.int32,
                      device=dev)
    nxt = dg.out_nbr.reshape(-1)[flat]
    rec[..., 0] = torch.where(can, nxt, x.to(torch.int32)[None, :])
    del nxt
    rec[..., 1] = can.to(torch.int32)
    eid = dg.out_eid.reshape(-1)[flat].long()
    del flat
    w_t = w_pads.to(torch.int32).T.contiguous()              # [M+1, D]
    rec[..., 2:2 + d] = torch.where(can[..., None], w_t[eid], 0)
    return rec


def sweep_records(rec: torch.Tensor) -> tuple[torch.Tensor, bool]:
    """One plain doubling sweep of int32 ``[R, N, P]`` records:
    ``(new records, changed)``. Every field of the new record reads the
    old arrays: ``succ`` the successor's successor, ``plen`` and each
    cost the own value plus the successor's (int32 adds, wrapping);
    ``changed`` is whether any successor moved."""
    succ = rec[..., 0]
    gat = torch.gather(rec, 1, succ.long()[..., None].expand_as(rec))
    new = rec + gat
    new[..., 0] = gat[..., 0]
    return new, bool((gat[..., 0] != succ).any())


def _finish(rec: torch.Tensor, targets: torch.Tensor, d: int, out=None):
    """``(costs [R, N, D], plen_packed [R, N])`` from converged records
    (into ``out``, a pair of tensors of those shapes, when given)."""
    n = rec.shape[1]
    targets = targets.to(device=rec.device, dtype=torch.int32)
    valid = targets >= 0
    t_safe = torch.where(valid, targets, 0)
    finished = (rec[..., 0] == t_safe[:, None]) & valid[:, None]
    plen = rec[..., 1]
    packed = torch.where(finished, plen, -plen - 1).to(plen_dtype(n))
    costs = rec[..., 2:2 + d]
    if out is None:
        return costs.contiguous(), packed
    out[0].copy_(costs.reshape(out[0].shape))
    out[1].copy_(packed)
    return out


def doubled_tables_multi(dg: DeviceGraph, fm: torch.Tensor,
                         targets: torch.Tensor, w_pads: torch.Tensor,
                         max_len: int = 0, out=None):
    """All-source cost tables for one fm shard under D weight sets at once.

    The successor function is diff-independent (free-flow moves), so the
    recursion is shared: each sweep squares ``succ`` and sums every
    set's costs from one record.

    ``fm``: int8 ``[R, N]``; ``targets``: int32 ``[R]`` global node id
    of each row's target (-1 pad); ``w_pads``: int32 ``[D, M+1]``;
    ``max_len``: path-length bound (0 = N). ``out``: ``(costs [R, N, D],
    plen_packed [R, N])`` to write into. Each sweep is one
    ``doubling_sweep`` call (its counters count them).

    Returns ``(costs [R, N, D] int32, plen_packed [R, N])`` — ``plen`` and
    ``finished`` ride one sign-packed array because the trajectory is
    shared. Rows with ``targets[r] < 0`` are all-unfinished padding."""
    from .cuda_doubling import doubling_sweep

    n = fm.shape[1]
    d = w_pads.shape[0]
    rec = initial_records(dg, fm, w_pads)
    x = torch.arange(n, dtype=torch.int32, device=rec.device)
    changed = bool((rec[..., 0] != x[None, :]).any())
    spare = torch.empty_like(rec)
    flag = torch.zeros(1, dtype=torch.int32, device=rec.device)
    limit = n_sweeps(n, max_len)
    i = 0
    while changed and i < limit:
        flag.zero_()
        doubling_sweep(rec, spare, flag)
        rec, spare = spare, rec
        i += 1
        changed = bool(flag.item())
    del spare
    return _finish(rec, targets, d, out)


def doubled_tables(dg: DeviceGraph, fm: torch.Tensor, targets: torch.Tensor,
                   w_query_pad: torch.Tensor, max_len: int = 0, out=None):
    """All-source cost + packed-plen tables for one fm shard under one
    weight set (``w_query_pad`` int32 ``[M+1]``): the multi recursion at
    D = 1, whose sums are the same int32 adds. ``out``: ``(cost [R, N],
    plen_packed [R, N])``. Returns ``(cost [R, N] int32, plen_packed
    [R, N])`` (:func:`plen_dtype`); see :func:`doubled_tables_multi`."""
    cost, packed = doubled_tables_multi(
        dg, fm, targets, w_query_pad.reshape(1, -1), max_len=max_len,
        out=out)
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
