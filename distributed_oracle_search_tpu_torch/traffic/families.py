"""New query families on the shard oracle: matrices, alternatives,
reverse routing.

The serving line protocol (``serving.ingress``) historically speaks one
sentence: ``<s> <t>``. Production traffic asks more kinds of question,
and all three new families decompose into the SAME per-pair shard
dispatch the frontend already batches — they are routing/aggregation
layers, not new kernels:

* ``mat <s> <t1> ... <tk>`` — **one-to-many ETA matrix** row: one pair
  query per target, fanned across target-owner shards (the bulk
  dist-gather path the campaign already drives at 1.1M q/s answers the
  resident-oracle analog), re-assembled in target order. Response:
  ``MAT <s> <k> <c1> ... <ck>`` with ``-1`` for targets that could not
  be answered (unreachable, shed, or errored).
* ``alt <s> <t> <k>`` — **k-alternative routes via penalized
  re-walks**: the oracle's walk follows the free-flow first-move table,
  so penalizing edges cannot bend an existing walk — instead each
  alternative *forces a distinct first edge* out of ``s`` and re-walks
  from that neighbor (cost = live first-edge weight + walk(nbr → t)).
  That is exactly the classic penalize-and-reroute loop collapsed: after
  extracting route i, its first edge is penalized to infinity, and the
  next-best route under that penalty is the best walk through the next
  first edge. All of a node's first edges evaluate in ONE shard batch
  (every sub-query targets ``t`` — same owner), ranked by live cost.
  Response: ``ALT <s> <t> <n> <c1> ... <cn>`` ascending, ``n <= k``.
* ``rev <s> <t>`` — **reverse (source-owner) routing**: the return
  trip ``t -> s``, answered by the worker that owns ``s`` — the
  source-owner of the original pair. On the campaign path the same
  trick is one ``group_queries`` call over the swapped pairs (grouping
  by the reversed target IS grouping by the original source's owner).
  Response: ``REV <s> <t> <cost> <plen> <finished>``.

Every family books its own ``serve_*`` counter so a mixed workload's
composition is visible on the scrape."""

from __future__ import annotations

import time

from ..data.formats import read_diff
from ..obs import metrics as obs_metrics
from ..utils.log import get_logger
from ..serving.request import BUSY, Future, OK, ServeResult

log = get_logger(__name__)

M_MATRIX = obs_metrics.counter(
    "serve_matrix_requests_total",
    "one-to-many ETA matrix requests (mat family)")
M_ALT = obs_metrics.counter(
    "serve_alt_requests_total",
    "k-alternative route requests (alt family)")
M_REV = obs_metrics.counter(
    "serve_reverse_requests_total",
    "reverse source-owner routing requests (rev family)")
M_FAMILY_SHED = obs_metrics.counter(
    "serve_shed_family_total",
    "typed family requests shed by the control plane's brownout ladder")


def parse_family_line(line: str):
    """``(kind, args)`` for a typed family line, or ``None`` for the
    classic pair sentence. Raises ``ValueError`` on a malformed family
    line (the ingress answers it in-order like any malformed line)."""
    toks = line.split()
    kind = toks[0].lower()
    if kind == "mat":
        if len(toks) < 3:
            raise ValueError("want 'mat <s> <t...>'")
        return "mat", (int(toks[1]), [int(t) for t in toks[2:]])
    if kind == "alt":
        if len(toks) != 4:
            raise ValueError("want 'alt <s> <t> <k>'")
        return "alt", (int(toks[1]), int(toks[2]), int(toks[3]))
    if kind == "rev":
        if len(toks) != 3:
            raise ValueError("want 'rev <s> <t>'")
        return "rev", (int(toks[1]), int(toks[2]))
    return None


class CompositeFuture:
    """Waits a list of pair futures and builds one family result.
    ``result(timeout)`` budgets the timeout across the whole set, so a
    stuck shard costs the caller one deadline, not one per target."""

    def __init__(self, futures, build):
        self._futures = futures
        self._build = build

    def result(self, timeout: float | None = None):
        deadline = None if timeout is None else time.monotonic() + timeout
        results = []
        for fut in self._futures:
            remaining = (None if deadline is None
                         else max(0.0, deadline - time.monotonic()))
            results.append(fut.result(remaining))
        return self._build(results)


class MatrixResult:
    """One ``mat`` answer. ``costs[i]`` is ``-1`` when target i was not
    answered OK+finished (unreachable, shed, errored)."""

    def __init__(self, s: int, targets, results):
        self.s = int(s)
        self.targets = [int(t) for t in targets]
        self.results = results
        self.costs = [int(r.cost) if r.ok and r.finished else -1
                      for r in results]

    @classmethod
    def from_mesh(cls, s: int, targets, costs, finished):
        """Build from an on-mesh ``query_mat`` row (no per-target
        result objects — the join already happened on device): the
        encoded MAT sentence is identical to the fan-out path's."""
        out = cls.__new__(cls)
        out.s = int(s)
        out.targets = [int(t) for t in targets]
        out.results = []
        out.costs = [int(c) if f else -1
                     for c, f in zip(costs, finished)]
        return out

    @property
    def ok(self) -> bool:
        return all(r.ok for r in self.results)

    def encode(self) -> str:
        return " ".join(["MAT", str(self.s), str(len(self.costs))]
                        + [str(c) for c in self.costs])


class AltResult:
    """One ``alt`` answer: up to k (cost, first-neighbor) alternatives,
    ascending cost, distinct first edges."""

    def __init__(self, s: int, t: int, k: int, alternatives, results):
        self.s, self.t, self.k = int(s), int(t), int(k)
        self.alternatives = alternatives      # [(cost, via_node), ...]
        self.results = results

    @property
    def ok(self) -> bool:
        return all(r.ok for r in self.results)

    def encode(self) -> str:
        return " ".join(
            ["ALT", str(self.s), str(self.t),
             str(len(self.alternatives))]
            + [str(c) for c, _via in self.alternatives])


class ReverseResult:
    """One ``rev`` answer: the ``t -> s`` return trip, labeled with the
    ORIGINAL (s, t) so clients correlate request and response."""

    def __init__(self, s: int, t: int, result):
        self.s, self.t = int(s), int(t)
        self.result = result

    @property
    def ok(self) -> bool:
        return self.result.ok

    def encode(self) -> str:
        r = self.result
        if r.status != OK:
            line = f"{r.status} {self.s} {self.t}"
            return f"{line} {r.detail}" if r.detail else line
        return (f"REV {self.s} {self.t} {r.cost} {r.plen} "
                f"{int(r.finished)}")


class QueryFamilies:
    """Family planner over one :class:`~..serving.ServingFrontend`.

    ``graph``/``graph_provider`` supply the road graph the ``alt``
    family needs to enumerate first edges (lazy: a frontend that never
    sees an alt query never loads it). ``traffic`` (a
    :class:`~.epochs.DiffEpochManager`) prices first edges under the
    LIVE fusion; without it, the frontend's static diff file is read
    once per diff and overlaid.

    ``oracle`` (a mesh-resident :class:`~..models.cpd.CPDOracle`):
    the ``mat`` family's ON-MESH path — one ``query_mat`` collective
    per row (walk + scatter + psum join on device) instead of one
    frontend future per target through queue/batcher/dispatcher. The
    row is priced under the frontend's CURRENT diff (live fusion
    included — the diff file is re-read per change, cached), so the
    MAT sentence is identical to the fan-out path's; without an
    oracle the fan-out/join path serves as before."""

    def __init__(self, frontend, graph=None, graph_provider=None,
                 traffic=None, oracle=None):
        self.frontend = frontend
        self._graph = graph
        self._graph_provider = graph_provider
        self.traffic = traffic
        self.oracle = oracle
        self._overlay_cache: tuple[str, dict] | None = None
        self._mat_weights: tuple[str, object] | None = None

    # ------------------------------------------------------------ helpers
    def graph(self):
        if self._graph is None:
            if self._graph_provider is None:
                raise ValueError(
                    "alt queries need a graph (pass graph= or "
                    "graph_provider= to QueryFamilies)")
            self._graph = self._graph_provider()
        return self._graph

    def _edge_weight(self, u: int, v: int, base: int) -> int:
        """(u, v)'s live travel time: traffic fusion > static diff
        overlay > free flow."""
        if self.traffic is not None:
            return self.traffic.weight_of(u, v, base)
        diff = self.frontend.diff
        if diff in ("-", "", None):
            return int(base)
        cached = self._overlay_cache
        if cached is None or cached[0] != diff:
            dsrc, ddst, dw = read_diff(diff)
            cached = (diff, {(int(a), int(b)): int(ww)
                             for a, b, ww in zip(dsrc, ddst, dw)})
            self._overlay_cache = cached
        return int(cached[1].get((int(u), int(v)), base))

    def _mat_query_weights(self, diff: str):
        """The edge-weight array ``query_mat`` prices the row under —
        the frontend's current diff (None = free flow), read once per
        diff change."""
        if diff in ("-", "", None):
            return None
        cached = self._mat_weights
        if cached is None or cached[0] != diff:
            w = self.oracle.graph.weights_with_diff(read_diff(diff))
            cached = (diff, w)
            self._mat_weights = cached
        return cached[1]

    # ----------------------------------------------------------- families
    def matrix(self, s: int, targets) -> CompositeFuture:
        M_MATRIX.inc()
        if self.oracle is not None:
            # on-mesh path: one collective answers the whole row. The
            # diff path doubles as the oracle's device-buffer cache
            # key, so rows under one diff share one weights upload.
            diff = self.frontend.diff
            cost, fin = self.oracle.query_mat(
                int(s), [int(t) for t in targets],
                w_query=self._mat_query_weights(diff),
                w_key=None if diff in ("-", "", None) else str(diff))
            res = MatrixResult.from_mesh(s, targets, cost, fin)
            return CompositeFuture([], lambda _results: res)
        futs = [self.frontend.submit(int(s), int(t)) for t in targets]
        return CompositeFuture(
            futs, lambda results: MatrixResult(s, targets, results))

    def reverse(self, s: int, t: int) -> CompositeFuture:
        M_REV.inc()
        fut = self.frontend.submit(int(t), int(s))   # the return trip:
        # target of the swapped pair is s, so the frontend's
        # target-owner routing IS source-owner routing of the original
        return CompositeFuture(
            [fut], lambda results: ReverseResult(s, t, results[0]))

    def alternatives(self, s: int, t: int, k: int) -> CompositeFuture:
        M_ALT.inc()
        g = self.graph()
        s, t = int(s), int(t)
        # pair queries get this check inside ``frontend.submit``; alt
        # indexes the graph BEFORE any submit, and a negative id would
        # not even raise — it silently wraps to another node's edges
        if not (0 <= s < g.n and 0 <= t < g.n):
            raise ValueError("node-out-of-range")
        nbrs, eids = g.out_edges(s)
        first = [(int(v), self._edge_weight(s, int(v), int(g.w[e])))
                 for v, e in zip(nbrs, eids)]
        # one sub-query per distinct first edge; all target t, so the
        # whole family lands in ONE shard's micro-batch
        futs = [self.frontend.submit(v, t) for v, _w in first]

        def build(results):
            alts = []
            for (v, w_first), r in zip(first, results):
                if r.ok and r.finished:
                    alts.append((int(w_first) + int(r.cost), v))
            alts.sort()
            return AltResult(s, t, k, alts[:max(int(k), 0)], results)

        return CompositeFuture(futs, build)

    # ------------------------------------------------------------ ingress
    def submit_line(self, kind: str, args):
        """Dispatch one parsed family line (``serving.ingress``)."""
        shed = getattr(self.frontend, "shed_families", None)
        if shed and kind in shed:
            # brownout ladder level >= 2: expensive fan-out families
            # answer BUSY immediately (in-order, like any shed) while
            # plain pair queries keep flowing
            M_FAMILY_SHED.inc()
            s = int(args[0]) if args else -1
            t = int(args[1]) if kind != "mat" and len(args) > 1 else -1
            return Future.completed(ServeResult(
                BUSY, s, t, detail="brownout-shed"))
        if kind == "mat":
            return self.matrix(args[0], args[1])
        if kind == "alt":
            return self.alternatives(args[0], args[1], args[2])
        if kind == "rev":
            return self.reverse(args[0], args[1])
        raise ValueError(f"unknown query family {kind!r}")
