"""Batched A*: the whole query batch searches at once.

Port of the JAX package's ``ops/batched_astar.py`` (an XLA stage, no
Pallas kernel there). The reference's A*-family (``--h-scale
--f-scale``, reference ``args.py:30-57``) as a **pruned min-plus fixed
point** over ``[N, Q]`` state, one dense relaxation a sweep, every query
of the batch at once. Per sweep every node ``v`` relaxes over its padded
in-edge table::

    g[v, q]  <-  min(g[v, q],  min_k  w[in_eid[v, k]] + prop[in_nbr[v, k], q])

where ``prop`` masks out the *pruned* sources: nodes whose ``f = g + h``
exceeds the query's incumbent ``ub[q] = g[t_q, q]`` (scaled by
``1 + fscale`` when ``fscale > 0``). ``h`` is the heap engine's heuristic
(``models.astar``), euclidean distance × ``min_cost_per_unit`` ×
``hscale``, as an ``[N, Q]`` int32 table. At ``hscale <= 1`` the
converged costs are optimal; above, bounded by ``hscale`` × optimal.

Telemetry is the batched analogue of the heap counters, summed over the
batch: ``n_expanded`` propagating nodes that changed the sweep before,
``n_surplus`` propagating nodes that did not, ``n_touched`` edge
relaxations issued (propagating nodes × the padded in-degree K),
``n_inserted`` nodes first reached, ``n_updated`` decrease-key events.
Each sweep's exact counts are folded into float32 totals in sweep order
(``n += float32(count)``, ``n_touched += float32(count) * K``), as the
JAX loop accumulates them, so a run equals JAX's while no sweep counts
past 2^24.

The pieces, each bit-equal to the JAX stage:

* :func:`heuristic_table` — the ``h`` table. JAX on the CPU computes
  ``floor(fma(h_raw, 1 - 4e-7, -1))`` with ``h_raw = sqrt(fma(dx, dx,
  dy * dy)) * cpu * hscale``: XLA contracts both a product and the tail
  into fused multiply-adds, and a separately rounded formula differs
  from it in a few entries in ten thousand. The plain version
  (:func:`heuristic_plain`) emulates each fused operation exactly in
  float64, on any device; K6's ``astar_heuristic`` entry spells the same
  operations out with round-to-nearest intrinsics.
* :func:`astar_batch_plain` — a plain copy of the ``while_loop``: the
  ``[N, K, Q]`` ``via``, ``argmin``'s first minimal slot, Jacobi state.
* :func:`sweep_skip_plain` — :func:`sweep_plain` with exactly the slots
  K6's sweep skips masked out (past a node's in-degree, or in range and
  in a query group of 32 that did not change at the source: the
  invariant is proved in ``csrc/batched_astar.cu``); the tests hold it
  equal to :func:`sweep_plain` sweep by sweep; :func:`skip_gathers`
  counts the slots it keeps, K6's gathers. :func:`groups_plain` is
  the dirty-group map a sweep hands the next.
* :func:`astar_batch` — picks by the tensors' device: K6's loop
  (``ops.cuda_astar``) on the card, :func:`astar_batch_plain` on the
  CPU; on CUDA tensors it launches K6 or raises.
* :func:`astar_batch_np` — numpy in and out, power-of-two chunks, the
  deadline checked between chunks (the first always runs), the graph and
  each named weight set cached on the device in ``ctx``; each chunk an
  ``astar.chunk`` span (``obs.trace``), its sweeps added to
  ``astar_batch_np.sweeps``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..data.graph import INF
from ..obs import trace as obs_trace
from ..utils.counts import bump
from ..utils.device import resolve_device

JINF = int(INF)
#: the JAX stage's margin factor ``1.0 - 4e-7`` as float32: a heuristic
#: rounded up past the exact value could break optimality at large
#: magnitudes, so h is taken 4 ulp low and 1 below
H_MARGIN = float(np.float32(1.0 - 4e-7))
#: the clamp that keeps h in int32 range (``2.0e9`` as float32)
H_CLAMP = 2.0e9
#: queries a dirty group covers (a warp's lanes in K6's sweep)
GROUP = 32
#: the largest slot weight K6's sweep may skip: ``w + prop`` cannot wrap
#: int32 for any ``prop <= INF`` (heavier slots are always gathered)
SKIP_W_MAX = 2 ** 31 - 1 - JINF
#: the least threshold at which a query's slots may be skipped:
#: ``thr - h`` cannot wrap for any ``h`` in ``[0, 2e9]``
THR_SAFE = -2 ** 31 + 2_000_000_000
#: the counter names, in the order a sweep's counts are laid out
COUNTERS = ("n_expanded", "n_surplus", "n_touched", "n_inserted",
            "n_updated")


def f32(x: float) -> float:
    """``x`` rounded to float32, as ``jnp.float32(x)`` rounds it."""
    return float(np.float32(x))


def _fma_f32(a: torch.Tensor, b: torch.Tensor, c) -> torch.Tensor:
    """``fma(a, b, c)`` of float32 ``a``, ``b`` and ``c`` (a tensor or a
    number), rounded once to float32, on any device: the product is exact
    in float64, the sum's rounding error is recovered exactly (TwoSum),
    and a sum that lands on a float32 tie is moved by that error's sign."""
    p = a.double() * b.double()
    cc = c.double() if torch.is_tensor(c) else torch.full_like(p, float(c))
    s = p + cc
    bv = s - p
    err = (p - (s - bv)) + (cc - bv)
    r = s.float()
    r64 = r.double()
    nb = torch.nextafter(r, torch.where(s > r64, torch.inf, -torch.inf)
                         .to(r.dtype))
    tie = (s != r64) & ((r64 + nb.double()) * 0.5 == s) & (err != 0)
    up = torch.maximum(r, nb)
    down = torch.minimum(r, nb)
    return torch.where(tie, torch.where(err > 0, up, down), r)


def heuristic_plain(xs: torch.Tensor, ys: torch.Tensor, t: torch.Tensor,
                    cpu: float, hscale: float,
                    rows: int = 1 << 16) -> torch.Tensor:
    """int32 ``[N, Q]`` ``h`` of float32 coordinates ``xs``, ``ys`` [N]
    and targets ``t`` [Q], bit-equal to the JAX stage's on the CPU: every
    fused multiply-add emulated exactly, the square root taken in float64
    (correctly rounded to float32: 53 >= 2 x 24 + 2 bits). Made
    ``rows`` nodes at a time, which bounds the float64 temporaries."""
    tl = t.long()
    one = torch.ones((), dtype=torch.float32, device=xs.device)
    cpu32, hs32, margin = one * f32(cpu), one * f32(hscale), one * H_MARGIN
    h = torch.empty((xs.shape[0], t.shape[0]), dtype=torch.int32,
                    device=xs.device)
    for lo in range(0, xs.shape[0], rows):
        dx = xs[lo:lo + rows, None] - xs[tl][None, :]
        dy = ys[lo:lo + rows, None] - ys[tl][None, :]
        ss = _fma_f32(dx, dx, dy * dy)
        h_raw = torch.sqrt(ss.double()).float() * cpu32 * hs32
        tail = torch.floor(_fma_f32(h_raw, margin, -1.0))
        h[lo:lo + rows] = tail.clamp(max=H_CLAMP, min=0.0)
    return h


def heuristic_table(xs: torch.Tensor, ys: torch.Tensor, t: torch.Tensor,
                    cpu: float, hscale: float) -> torch.Tensor:
    """The ``[N, Q]`` int32 heuristic of JAX ``ops/batched_astar.py:101-
    107``: K6's ``astar_heuristic`` entry on the card, the plain version
    on the CPU (``cpu`` and ``hscale`` rounded to float32 either way)."""
    from .cuda_astar import astar_heuristic

    return astar_heuristic(xs, ys, t, f32(cpu), f32(hscale))


def threshold(ub: torch.Tensor, fscale: float) -> torch.Tensor:
    """The per-query prune threshold from the incumbent ``ub`` (int32
    [Q]): ``ub`` itself at ``fscale == 0`` (exact), else
    ``min(floor((1 + fscale) * float(ub)), 1e9)`` in float32."""
    if not f32(fscale) > 0:
        return ub
    one_plus = (torch.ones((), dtype=torch.float32, device=ub.device)
                * float(np.float32(1.0) + np.float32(fscale)))
    return torch.clamp(torch.floor(one_plus * ub.float()),
                       max=float(JINF)).to(torch.int32)


def _sweep(in_nbr, w_in, h, t, valid, g, hops, changed, fscale,
           keep=None):
    """One Jacobi step; ``keep(thr, nbr)`` (bool ``[N, K, Q]``) masks
    out the slots it is False on, as a sweep that never gathers them."""
    q = g.shape[1]
    qix = torch.arange(q, device=g.device)
    thr = threshold(g[t.long(), qix], fscale)
    pruned = g > (thr[None, :] - h)
    prop = torch.where(pruned, torch.full_like(g, JINF), g)
    nbr = in_nbr.long()
    via = prop[nbr]                                  # [N, K, Q]
    via += w_in[:, :, None]
    via.clamp_(max=JINF)
    if keep is not None:
        via.masked_fill_(~keep(thr, nbr), 2 ** 31 - 1)
    best = via.amin(dim=1)
    slot = via.argmin(dim=1)                         # the first minimal
    del via
    improved = best < g
    src = torch.gather(nbr, 1, slot)                 # [N, Q]
    hop_src = torch.gather(hops, 0, src)
    new_g = torch.where(improved, best, g)
    new_hops = torch.where(improved, hop_src + 1, hops)
    live = (prop < JINF) & valid[None, :]
    reached = g >= JINF
    counts = torch.stack([(live & changed).sum(), (live & ~changed).sum(),
                          live.sum(), (improved & reached).sum(),
                          (improved & ~reached).sum()])
    return new_g, new_hops, improved, counts


def sweep_plain(in_nbr: torch.Tensor, w_in: torch.Tensor, h: torch.Tensor,
                t: torch.Tensor, valid: torch.Tensor, g: torch.Tensor,
                hops: torch.Tensor, changed: torch.Tensor, fscale: float
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
    """One Jacobi step of the JAX ``body`` (``:125-159``): ``(g', hops',
    improved, counts)`` with ``counts`` int64 [5] this sweep's exact
    ``live & changed``, ``live & ~changed``, ``live`` (not yet × K),
    ``improved & g >= INF`` and ``improved & g < INF``."""
    return _sweep(in_nbr, w_in, h, t, valid, g, hops, changed, fscale)


def sweep_skip_plain(in_nbr: torch.Tensor, w_in: torch.Tensor,
                     deg: torch.Tensor, h: torch.Tensor, t: torch.Tensor,
                     valid: torch.Tensor, g: torch.Tensor,
                     hops: torch.Tensor, changed: torch.Tensor,
                     groups: torch.Tensor, fscale: float):
    """:func:`sweep_plain` over only the slots K6's sweep gathers at
    ``skip=1``: slot k of ``(v, q)`` is left out past ``deg[v]``, or when
    its weight is in ``[0, SKIP_W_MAX]``, the query's threshold is at
    least ``THR_SAFE`` and ``groups[in_nbr[v, k], q // GROUP]`` is clear
    (``groups``: :func:`groups_plain` of the ``changed`` the sweep before
    left). Equal to :func:`sweep_plain` on every state a loop reaches
    (tests only)."""
    return _sweep(in_nbr, w_in, h, t, valid, g, hops, changed, fscale,
                  _skip_keep(w_in, deg, groups, g.shape[1]))


def _skip_keep(w_in: torch.Tensor, deg: torch.Tensor, groups: torch.Tensor,
               q: int):
    """``keep(thr, nbr)`` of :func:`_sweep`: bool ``[N, K, Q]``, the slots
    K6's sweep gathers at ``skip=1`` (:func:`sweep_skip_plain`'s rule)."""
    k = w_in.shape[1]
    qgrp = torch.arange(q, device=w_in.device) // GROUP

    def keep(thr, nbr):
        real = (torch.arange(k, device=w_in.device)[None, :]
                < deg.long()[:, None])
        fixed = (w_in < 0) | (w_in > SKIP_W_MAX)
        dirty = groups.bool()[nbr][:, :, qgrp]       # [N, K, Q]
        return real[:, :, None] & (fixed[:, :, None]
                                   | (thr < THR_SAFE)[None, None, :]
                                   | dirty)

    return keep


def skip_gathers(in_nbr: torch.Tensor, w_in: torch.Tensor,
                 deg: torch.Tensor, t: torch.Tensor, g: torch.Tensor,
                 groups: torch.Tensor, fscale: float) -> int:
    """The gathers of a K6 sweep at ``skip=1`` from state ``g`` and the
    dirty groups ``groups``: the (node, slot, query) triples
    :func:`sweep_skip_plain` keeps, every query lane of the chunk, padded
    lanes too (the kernel's ``counts[5]``)."""
    qix = torch.arange(g.shape[1], device=g.device)
    thr = threshold(g[t.long(), qix], fscale)
    keep = _skip_keep(w_in, deg, groups, g.shape[1])
    return int(keep(thr, in_nbr.long()).sum())


def n_groups(q: int) -> int:
    """Dirty groups a node of a ``q``-query chunk: ``ceil(q / 32)``."""
    return -(-q // GROUP)


def groups_plain(improved: torch.Tensor) -> torch.Tensor:
    """uint8 ``[N, ceil(Q / 32)]``: whether any query of each group of
    :data:`GROUP` improved (or changed) at each node."""
    n, q = improved.shape
    pad = n_groups(q) * GROUP - q
    x = torch.nn.functional.pad(improved.bool(), (0, pad))
    return x.reshape(n, -1, GROUP).any(dim=2).to(torch.uint8)


def in_degree(in_eid: torch.Tensor, m: int) -> torch.Tensor:
    """int32 [N]: the slots of each in-edge ELL row before its trailing
    padding (``in_eid == m``, weight ``w_pad[m] = INF`` on the node
    itself), where K6's sweep stops."""
    real = in_eid != m
    last = in_eid.shape[1] - real.flip(1).to(torch.int32).argmax(dim=1)
    return torch.where(real.any(dim=1), last, 0).to(torch.int32)


def init_state(n: int, s: torch.Tensor, valid: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor]:
    """``(g, hops, changed, groups)`` before the first sweep: ``g`` 0 at
    each valid lane's source and INF elsewhere, ``hops`` 0, ``changed``
    the valid lanes' sources, ``groups`` its :func:`groups_plain`."""
    q = s.shape[0]
    dev = s.device
    qix = torch.arange(q, device=dev)
    g = torch.full((n, q), JINF, dtype=torch.int32, device=dev)
    g[s.long(), qix] = torch.where(valid, 0, JINF).to(torch.int32)
    hops = torch.zeros((n, q), dtype=torch.int32, device=dev)
    changed = torch.zeros((n, q), dtype=torch.bool, device=dev)
    changed[s.long(), qix] = valid
    return g, hops, changed, groups_plain(changed)


def fold_counts(counts: np.ndarray, k: int) -> dict[str, float]:
    """Each sweep's exact counts (int64 ``[S, 5]``, the rows of
    :func:`sweep_plain`) folded into float32 totals in sweep order, as
    the JAX loop does; returned as floats holding float32 values."""
    tot = [np.float32(0)] * 5
    fk = np.float32(k)
    for row in np.asarray(counts, np.int64).reshape(-1, 5):
        c = [np.float32(x) for x in row]
        tot[0] = np.float32(tot[0] + c[0])
        tot[1] = np.float32(tot[1] + c[1])
        tot[2] = np.float32(tot[2] + np.float32(c[2] * fk))
        tot[3] = np.float32(tot[3] + c[3])
        tot[4] = np.float32(tot[4] + c[4])
    return {name: float(v) for name, v in zip(COUNTERS, tot)}


def exact_totals(counts: np.ndarray, k: int) -> dict[str, int]:
    """The same totals as :func:`fold_counts` in exact integers."""
    c = np.asarray(counts, np.int64).reshape(-1, 5).sum(axis=0)
    return {"n_expanded": int(c[0]), "n_surplus": int(c[1]),
            "n_touched": int(c[2]) * k, "n_inserted": int(c[3]),
            "n_updated": int(c[4])}


def finish(g: torch.Tensor, hops: torch.Tensor, t: torch.Tensor,
           valid: torch.Tensor):
    """``(cost, plen, finished)`` [Q] from the converged state."""
    qix = torch.arange(g.shape[1], device=g.device)
    cost = g[t.long(), qix]
    fin = (cost < JINF) & valid
    zero = torch.zeros_like(cost)
    return (torch.where(fin, cost, zero),
            torch.where(fin, hops[t.long(), qix], zero), fin)


def astar_batch_plain(in_nbr, in_eid, w_pad, xs, ys, s, t, hscale, fscale,
                      cpu, valid=None, max_iters: int = 0, w_in=None,
                      info: dict | None = None):
    """The JAX ``astar_batch`` as a plain torch loop, on any device: sweeps
    while a node changed and fewer than ``limit`` ran (``max_iters``, 0 =
    N-1). Returns ``(cost int32 [Q], plen int32 [Q], finished bool [Q],
    counters)``, ``counters`` the float32 totals as floats. ``info``
    receives ``sweeps``, ``launches`` (0: no kernel), ``counts`` (int64
    ``[S, 5]``) and ``exact``."""
    n, k = in_nbr.shape
    q = s.shape[0]
    if valid is None:
        valid = torch.ones(q, dtype=torch.bool, device=s.device)
    limit = (n - 1) if max_iters == 0 else max_iters
    h = heuristic_plain(xs, ys, t, cpu, hscale)
    g, hops, changed, _ = init_state(n, s, valid)
    if w_in is None:
        w_in = w_pad[in_eid.long()]
    rows = []
    i = 0
    while i < limit and bool(changed.any()):
        g, hops, changed, c = sweep_plain(in_nbr, w_in, h, t, valid, g,
                                          hops, changed, fscale)
        rows.append(c)
        i += 1
    counts = (torch.stack(rows).cpu().numpy() if rows
              else np.zeros((0, 5), np.int64))
    if info is not None:
        info.update(sweeps=i, launches=0, counts=counts,
                    exact=exact_totals(counts, k))
    return (*finish(g, hops, t, valid), fold_counts(counts, k))


def astar_batch(in_nbr, in_eid, w_pad, xs, ys, s, t, hscale, fscale, cpu,
                valid=None, max_iters: int = 0, w_in=None, deg=None,
                info: dict | None = None):
    """Batched weighted A* from ``s[q]`` to ``t[q]`` for every query q, the
    JAX ``astar_batch``'s signature and results.

    in_nbr, in_eid : int32 [N, K] padded in-edge ELL (self / M padding)
    w_pad          : int32 [M+1] query-time weights; ``w_pad[M] = INF``
    xs, ys         : float32 [N] node coordinates
    s, t           : int32 [Q]
    hscale, fscale, cpu : numbers, rounded to float32 (``cpu`` =
        :func:`..models.astar.min_cost_per_unit` of these weights)
    valid          : bool [Q] padding mask (False lanes return zeros)
    max_iters      : sweep bound; 0 = N-1
    w_in           : ``w_pad[in_eid]`` when the caller holds it (built
                     once a weight set); None builds it
    deg            : :func:`in_degree` of ``in_eid`` when the caller holds
                     it (built once a graph; K6's loop only); None builds
                     it

    On CUDA tensors K6's loop (:func:`.cuda_astar.astar_loop`) or an
    error; on CPU tensors :func:`astar_batch_plain`, each such call
    adding one to ``astar_batch.plain``. Returns ``(cost, plen,
    finished, counters)`` as :func:`astar_batch_plain`; ``info``
    receives ``sweeps``, ``launches``, ``counts`` and ``exact``."""
    kw = dict(valid=valid, max_iters=max_iters, w_in=w_in, info=info)
    if in_nbr.device.type == "cpu":
        bump(astar_batch, "plain")
        return astar_batch_plain(in_nbr, in_eid, w_pad, xs, ys, s, t,
                                 hscale, fscale, cpu, **kw)
    if in_nbr.device.type != "cuda":
        raise ValueError(f"no batched A* for tensors on {in_nbr.device}")
    from .cuda_astar import astar_loop

    return astar_loop(in_nbr, in_eid, w_pad, xs, ys, s, t, hscale, fscale,
                      cpu, deg=deg, **kw)


astar_batch.plain = 0


def _device_graph(graph, ctx: dict, device) -> dict:
    """The in-edge ELL, its rows' in-degrees and the float32 coordinates
    on the device, cached in ``ctx`` (a resident server uploads them
    once)."""
    if "in_nbr" not in ctx:
        dev = resolve_device(device)
        in_nbr, in_eid = graph.ell("in")
        ctx["device"] = dev
        ctx["in_nbr"] = torch.as_tensor(in_nbr, dtype=torch.int32,
                                        device=dev)
        ctx["in_eid"] = torch.as_tensor(in_eid, dtype=torch.int32,
                                        device=dev)
        ctx["deg"] = in_degree(ctx["in_eid"], graph.m)
        ctx["xs"] = torch.as_tensor(np.asarray(graph.xs, np.float32),
                                    device=dev)
        ctx["ys"] = torch.as_tensor(np.asarray(graph.ys, np.float32),
                                    device=dev)
    return ctx


def _weights(graph, w: np.ndarray, ctx: dict, w_key: str | None):
    """``(w_pad, w_in)`` on the ctx's device for weights ``w``: cached
    under ``w_key`` in ``ctx`` (built once a weight set), or made for
    this call when ``w_key`` is None."""
    key = ("w_pad", w_key)
    if w_key is not None and key in ctx:
        return ctx[key]
    w_pad = torch.as_tensor(graph.padded_weights(w), dtype=torch.int32,
                            device=ctx["device"])
    entry = (w_pad, w_pad[ctx["in_eid"].long()])
    if w_key is not None:
        ctx[key] = entry
    return entry


def astar_batch_np(graph, queries: np.ndarray, w: np.ndarray | None = None,
                   hscale: float = 1.0, fscale: float = 0.0,
                   chunk: int = 1024, deadline: float | None = None,
                   cpu: float | None = None, ctx: dict | None = None,
                   w_key: str | None = None, device=None,
                   info: dict | None = None):
    """NumPy in, NumPy out: chunked batched A* (the JAX
    ``astar_batch_np``).

    ``queries [Q, 2]`` run in chunks of at most ``chunk``, each padded to
    a power of two; ``deadline`` (``time.perf_counter()`` seconds) is
    checked between chunks — the first chunk always runs, and the chunks
    left come back unfinished. ``cpu`` skips the ``min_cost_per_unit``
    scan. ``ctx``: a caller-owned dict caching the graph's device arrays
    across calls (and the device they live on); ``w_key`` names the
    weight set so its device copy and ``w_in`` are cached there too (None
    uploads per call). ``device``: where a fresh ``ctx`` puts the graph
    (None → ``cuda``; raises without a GPU unless ``"cpu"``).

    Returns ``(cost, plen, finished, counters)``: int64/bool arrays and
    int counters. ``info`` receives per chunk ``sweeps`` and
    ``launches`` (lists) and the exact int totals under ``exact``. Each
    chunk is an ``astar.chunk`` span (args ``queries``, ``sweeps``) and
    adds its sweeps to ``astar_batch_np.sweeps``."""
    from ..models.astar import min_cost_per_unit

    nq = len(queries)
    w = graph.w if w is None else np.asarray(w)
    if cpu is None:
        cpu = min_cost_per_unit(graph, w)
    ctx = _device_graph(graph, {} if ctx is None else ctx, device)
    dev = ctx["device"]
    w_pad, w_in = _weights(graph, w, ctx, w_key)
    cost = np.zeros(nq, np.int64)
    plen = np.zeros(nq, np.int64)
    fin = np.zeros(nq, bool)
    totals = dict.fromkeys(COUNTERS, 0)
    exact = dict.fromkeys(COUNTERS, 0)
    sweeps: list[int] = []
    launches: list[int] = []
    for lo in range(0, nq, chunk):
        # the first chunk always runs: an expired budget still answers
        # a minimal batch, as the per-query heap engine does
        if lo > 0 and deadline is not None and time.perf_counter() > deadline:
            break
        part = np.asarray(queries[lo:lo + chunk])
        m = len(part)
        qpad = 1 << (m - 1).bit_length() if m > 1 else 1
        sq = np.zeros(qpad, np.int32)
        tq = np.zeros(qpad, np.int32)
        vq = np.zeros(qpad, bool)
        sq[:m] = part[:, 0]
        tq[:m] = part[:, 1]
        vq[:m] = True
        one: dict = {}
        with obs_trace.span("astar.chunk", queries=m) as span:
            c, p, f, counters = astar_batch(
                ctx["in_nbr"], ctx["in_eid"], w_pad, ctx["xs"], ctx["ys"],
                torch.from_numpy(sq).to(dev), torch.from_numpy(tq).to(dev),
                hscale, fscale, cpu, valid=torch.from_numpy(vq).to(dev),
                w_in=w_in, deg=ctx["deg"], info=one)
            cost[lo:lo + m] = c[:m].cpu().numpy()
            plen[lo:lo + m] = p[:m].cpu().numpy()
            fin[lo:lo + m] = f[:m].cpu().numpy()
            span.set(sweeps=one["sweeps"])
        bump(astar_batch_np, "sweeps", one["sweeps"])
        for key, val in counters.items():
            totals[key] += int(val)
        for key, val in one["exact"].items():
            exact[key] += val
        sweeps.append(one["sweeps"])
        launches.append(one["launches"])
    if info is not None:
        info.update(sweeps=sweeps, launches=launches, exact=exact)
    return cost, plen, fin, totals


astar_batch_np.sweeps = 0
