"""In-memory road-graph representation.

Host-side (NumPy) container with two derived layouts:

* **CSR** (out- and in-edge) — used by the CPU reference oracle
  (Dijkstra), the role warthog's graph classes play in the reference.
* **Padded ELL** — fixed-width neighbor tables ``[N, K]`` (K = max
  degree): every Bellman-Ford relaxation, first-move extraction and walk
  step becomes a gather over the K axis with static shapes.

Weights are int32 travel times. ``INF`` is chosen so that ``INF + INF``
still fits in int32 (no overflow inside min-plus updates).

Congestion diffs perturb **query-time** weights only — the CPD is always
built on the free-flow weights, mirroring the reference (diff files are
passed to ``fifo_auto`` but never to ``make_cpd_auto``: reference
``make_fifos.py:21`` vs ``make_cpds.py:20``).

A copy of the JAX package's ``data/graph.py`` restricted to what the
port's build and walk use; the ELL slot order — the first-move
tie-break — and the structured edge splits the build policy reads
(``shift_split``, ``grid_split``) are the same code, byte for byte.
"""

from __future__ import annotations

import numpy as np

from .formats import read_xy, read_diff

INF = np.int32(10 ** 9)  # INF + INF < int32 max; real path costs stay far below


def _shift_planes(src, dst, w, n: int, max_shifts: int, cap: int):
    """Extract constant-offset edge planes: ``(shifts, w_shift, covered)``.

    ``w_shift[s, u]`` = weight of edge ``u → u+shifts[s]`` (min over
    parallels; INF absent). Offsets beyond ``±cap`` or past the
    ``max_shifts`` most frequent stay uncovered. Shared by
    :meth:`Graph.shift_split` and :meth:`Graph.grid_split`.
    """
    delta = dst - src
    vals, counts = np.unique(delta, return_counts=True)
    ok = np.abs(vals) <= cap
    vals, counts = vals[ok], counts[ok]
    keep = vals[np.argsort(-counts)[:max_shifts]]
    shifts = tuple(int(s) for s in keep)
    w_shift = np.full((len(shifts), n), int(INF), np.int32)
    covered = np.zeros(len(src), bool)
    for si, s in enumerate(shifts):
        mask = delta == s
        np.minimum.at(w_shift[si], src[mask], w[mask])
        covered |= mask
    return shifts, w_shift, covered


def _leftover_ell(src_l, dst_l, w_l, n: int):
    """Pack uncovered edges into a padded ELL table ``(nbr, w)`` [N, K].

    Shared by :meth:`Graph.shift_split` and :meth:`Graph.grid_split`:
    whatever edges a structured relaxation cannot serve gather-free fall
    back to this (small) table. K may be 0 → empty arrays.
    """
    deg = np.bincount(src_l, minlength=n)
    k_left = int(deg.max()) if len(src_l) else 0
    nbr = np.repeat(np.arange(n, dtype=np.int32)[:, None],
                    max(k_left, 1), axis=1)
    w = np.full((n, max(k_left, 1)), int(INF), np.int32)
    if len(src_l):
        order = np.argsort(src_l, kind="stable")
        starts = np.cumsum(np.concatenate([[0], deg[:-1]]))
        slot = np.arange(len(src_l)) - np.repeat(starts, deg)
        nbr[src_l[order], slot] = dst_l[order].astype(np.int32)
        # parallel uncovered edges to the same dst would collide in the
        # ELL slot only if they shared (src, slot); distinct slots keep
        # them separate, min falls out of the relaxation itself
        w[src_l[order], slot] = w_l[order]
    if k_left == 0:
        nbr = nbr[:, :0]
        w = w[:, :0]
    return nbr, w


class Graph:
    """Directed graph with int32 edge weights.

    Attributes
    ----------
    n, m        : node / edge counts
    xs, ys      : int64 [n] node coordinates
    src, dst    : int64 [m] edge endpoints, file order
    w           : int32 [m] free-flow travel times, file order
    out_ptr     : int64 [n+1] CSR row pointers (by src)
    out_eid     : int64 [m] edge ids sorted by src (CSR order)
    in_ptr/in_eid : same for the reverse graph (by dst)
    """

    def __init__(self, xs, ys, src, dst, w):
        self.xs = np.asarray(xs, np.int64)
        self.ys = np.asarray(ys, np.int64)
        self.src = np.asarray(src, np.int64)
        self.dst = np.asarray(dst, np.int64)
        self.w = np.asarray(w, np.int32)
        self.n = len(self.xs)
        self.m = len(self.src)
        if np.any(self.w < 0):
            raise ValueError("negative edge weights are not supported")
        if self.m and (self.src.min() < 0 or self.src.max() >= self.n
                       or self.dst.min() < 0 or self.dst.max() >= self.n):
            raise ValueError("edge endpoint out of range")

        self.out_ptr, self.out_eid = self._csr(self.src)
        self.in_ptr, self.in_eid = self._csr(self.dst)
        self._edge_key_sorted = None
        self._edge_key_order = None
        self._ell_cache: dict = {}

    # ---------------------------------------------------------------- CSR
    def _csr(self, keys: np.ndarray):
        order = np.argsort(keys, kind="stable")
        ptr = np.zeros(self.n + 1, np.int64)
        np.add.at(ptr, keys + 1, 1)
        np.cumsum(ptr, out=ptr)
        return ptr, order

    def out_edges(self, u: int):
        """(dst, eid) arrays of u's out-edges."""
        eids = self.out_eid[self.out_ptr[u]:self.out_ptr[u + 1]]
        return self.dst[eids], eids

    def in_edges(self, v: int):
        eids = self.in_eid[self.in_ptr[v]:self.in_ptr[v + 1]]
        return self.src[eids], eids

    @property
    def max_out_degree(self) -> int:
        return int(np.max(np.diff(self.out_ptr))) if self.n else 0

    @property
    def max_in_degree(self) -> int:
        return int(np.max(np.diff(self.in_ptr))) if self.n else 0

    # ---------------------------------------------------------------- ELL
    def ell(self, direction: str = "out"):
        """Padded fixed-width neighbor table.

        Returns ``(nbr, eid)``: int32 ``[N, K]`` arrays. ``nbr[u, k]`` is the
        k-th neighbor of ``u`` (out- or in-), ``eid[u, k]`` the edge id for
        weight lookup. Padding: ``nbr = u`` itself, ``eid = m`` (one past the
        last edge — weight arrays handed to the device get an extra INF slot
        so padded lanes never win a min).

        Slot order is ascending edge id, which makes first-move slot indices
        deterministic and lets golden tests compare against the CPU oracle's
        tie-breaking.
        """
        if direction in self._ell_cache:
            return self._ell_cache[direction]
        if direction == "out":
            ptr, eid_sorted, n = self.out_ptr, self.out_eid, self.n
        elif direction == "in":
            ptr, eid_sorted, n = self.in_ptr, self.in_eid, self.n
        else:
            raise ValueError(direction)
        deg = np.diff(ptr)
        k = max(int(deg.max()) if n else 0, 1)
        nbr = np.repeat(np.arange(n, dtype=np.int32)[:, None], k, axis=1)
        eid = np.full((n, k), self.m, np.int32)
        # scatter each edge into its row slot
        slot = np.arange(self.m, dtype=np.int64) - np.repeat(ptr[:-1], deg)
        rows = np.repeat(np.arange(n, dtype=np.int64), deg)
        eids = eid_sorted
        other = self.dst[eids] if direction == "out" else self.src[eids]
        nbr[rows, slot] = other.astype(np.int32)
        eid[rows, slot] = eids.astype(np.int32)
        self._ell_cache[direction] = (nbr, eid)
        return nbr, eid

    def padded_weights(self, w: np.ndarray | None = None) -> np.ndarray:
        """Weight vector with the extra INF slot addressed by ELL padding."""
        base = self.w if w is None else np.asarray(w, np.int32)
        return np.concatenate([base, np.asarray([INF], np.int32)])

    def padded_weights_multi(self, w_list) -> np.ndarray:
        """``[D, M+1]`` int32 — one padded weight row per diff round
        (``None`` entries mean free flow): the weight operand of the
        fused multi-diff walk and doubling tables."""
        return np.stack([np.asarray(self.padded_weights(w), np.int32)
                         for w in w_list])

    # --------------------------------------------------------------- diffs
    def _edge_lookup(self):
        if self._edge_key_sorted is None:
            key = self.src * np.int64(self.n) + self.dst
            order = np.argsort(key, kind="stable")
            self._edge_key_sorted = key[order]
            self._edge_key_order = order
        return self._edge_key_sorted, self._edge_key_order

    def edge_ids(self, src: np.ndarray, dst: np.ndarray) -> np.ndarray:
        """Edge ids for (src, dst) pairs; raises if any pair is absent."""
        want_src = np.asarray(src, np.int64)
        want_dst = np.asarray(dst, np.int64)
        if self.m == 0:
            if len(want_src):
                raise KeyError(f"edge {want_src[0]}->{want_dst[0]} not in graph")
            return np.zeros(0, np.int64)
        keys_sorted, order = self._edge_lookup()
        want = want_src * np.int64(self.n) + want_dst
        pos = np.searchsorted(keys_sorted, want)
        ok = (pos < self.m) & (keys_sorted[np.minimum(pos, self.m - 1)] == want)
        if not np.all(ok):
            bad = np.argmin(ok)
            raise KeyError(f"edge {src[bad]}->{dst[bad]} not in graph")
        return order[pos]

    def weights_with_diff(self, diff) -> np.ndarray:
        """Apply a congestion diff → new int32 weight vector (file edge order).

        ``diff`` is a path (``"-"`` → free flow) or ``(src, dst, new_w)``
        arrays. Entries replace the weight of the named edge.
        """
        if isinstance(diff, str) or diff is None:
            dsrc, ddst, dw = read_diff(diff)
        else:
            dsrc, ddst, dw = diff
        w = self.w.copy()
        if len(dsrc):
            w[self.edge_ids(dsrc, ddst)] = dw
        return w

    # ---------------------------------------------------------------- shift
    def shift_split(self, max_shifts: int = 64):
        """Split edges into shift-structured + leftover sets for the
        gather-free relaxation (``ops.shift_relax``).

        Road-network node ids laid out with locality (grid row-major, or
        RCM/BFS orderings) put most edges at a few constant id-offsets
        ``dst - src``. For those, min-plus relaxation needs no gather at
        all: it is a shifted add + min, elementwise work. The remaining
        edges fall back to a (small) padded ELL gather.

        Returns ``(shifts, w_shift, nbr_left, w_left)``:

        * ``shifts``  tuple of ints, the kept offsets (≤ ``max_shifts``,
          most-frequent first),
        * ``w_shift`` int32 ``[S, N]``: weight of edge ``u → u+shifts[s]``
          (min over parallel edges; INF where absent),
        * ``nbr_left``/``w_left`` int32 ``[N, K_left]`` padded ELL of the
          uncovered edges (``K_left`` may be 0 → empty arrays).

        Free-flow weights only — this feeds the CPD build, which is always
        free-flow (reference semantics).
        """
        # magnitude cap: the relaxation pads the distance array by
        # max|shift| rows every iteration, so one frequent long-range
        # offset must not be allowed to blow up the working set — beyond
        # n/8 an offset goes to the leftover gather instead. The floor
        # keeps small graphs (where even the full width is cheap) intact.
        shifts, w_shift, covered = _shift_planes(
            self.src, self.dst, self.w, self.n, max_shifts,
            cap=max(256, self.n // 8))
        nbr_left, w_left = _leftover_ell(
            self.src[~covered], self.dst[~covered], self.w[~covered], self.n)
        return shifts, w_shift, nbr_left, w_left

    def grid_split(self, width: int | None = None):
        """Split edges into 4 directional grid-lattice arrays + leftover ELL
        for the fast-sweeping relaxation (``ops.grid_sweep``).

        Row-major grid ids (``id = y*width + x``) put street edges at offsets
        ``±1`` (same row) and ``±width``. The sweep build relaxes those with
        sequential line scans; everything else (arterials, wrap-arounds)
        goes to the leftover gather.

        Returns ``(width, height, wl, wr, wd, wu, shifts, w_shift,
        src_left, dst_left, w_left)`` where ``wl[u]`` is the weight of edge
        ``u → u-1`` (same row; INF when absent), ``wr``/``wd``/``wu``
        likewise for ``u+1`` / ``u-width`` / ``u+width``; leftover edges on
        frequent constant offsets become shift planes ``shifts``/``w_shift``
        (relaxed gather-free once per sweep cycle) and true stragglers stay
        an explicit ``src_left``/``dst_left``/``w_left`` edge list for
        scatter-min relaxation. Returns ``None`` when no grid layout fits
        (width not inferable, or ``n`` not a multiple of it). Free-flow
        weights only.
        """
        delta = self.dst - self.src
        if width is None:
            big = np.abs(delta[np.abs(delta) > 1])
            if big.size == 0:
                return None
            vals, counts = np.unique(big, return_counts=True)
            width = int(vals[np.argmax(counts)])
        if width < 2 or self.n % width:
            return None
        height = self.n // width
        sx = self.src % width
        masks = {
            "wr": (delta == 1) & (sx < width - 1),
            "wl": (delta == -1) & (sx > 0),
            "wu": delta == width,
            "wd": delta == -width,
        }
        out = {}
        covered = np.zeros(self.m, bool)
        for name, mask in masks.items():
            arr = np.full(self.n, int(INF), np.int32)
            np.minimum.at(arr, self.src[mask], self.w[mask])
            out[name] = arr
            covered |= mask
        rest = ~covered
        shifts, w_shift, cov_s = _shift_planes(
            self.src[rest], self.dst[rest], self.w[rest], self.n,
            max_shifts=32, cap=max(256, self.n // 8))
        rest_idx = np.nonzero(rest)[0][~cov_s]
        # stragglers stay an explicit edge list (scatter-min relaxation):
        # they are rare (clip artifacts at grid borders), so per-edge cost
        # beats any [N, K] table
        return (width, height, out["wl"], out["wr"], out["wd"], out["wu"],
                shifts, w_shift, self.src[rest_idx].astype(np.int32),
                self.dst[rest_idx].astype(np.int32), self.w[rest_idx])

    # ----------------------------------------------------------- ordering
    def reorder(self, perm: np.ndarray) -> "Graph":
        """Relabel nodes: new id ``i`` is old node ``perm[i]``.

        The analog of the reference's ``--order`` NodeOrdering override
        (reference ``args.py:119``). Costs and paths are invariant — only
        labels move (query node ids must be mapped through the inverse
        permutation; see ``cli.reorder``).
        """
        perm = np.asarray(perm, np.int64)
        if not np.array_equal(np.sort(perm), np.arange(self.n)):
            raise ValueError("perm must be a permutation of 0..n-1")
        inv = np.empty(self.n, np.int64)
        inv[perm] = np.arange(self.n)
        return Graph(self.xs[perm], self.ys[perm],
                     inv[self.src], inv[self.dst], self.w)

    def _undirected_csr(self):
        """Symmetrized adjacency (ptr, nbr) for ordering algorithms."""
        su = np.concatenate([self.src, self.dst])
        sv = np.concatenate([self.dst, self.src])
        order = np.argsort(su, kind="stable")
        ptr = np.zeros(self.n + 1, np.int64)
        np.add.at(ptr, su + 1, 1)
        np.cumsum(ptr, out=ptr)
        return ptr, sv[order]

    @staticmethod
    def frontier_neighbors(ptr, nbr, frontier):
        """All neighbors of ``frontier`` via CSR, one vectorized gather
        (the shared inner step of every level-synchronous BFS here)."""
        counts = ptr[frontier + 1] - ptr[frontier]
        idx = np.repeat(ptr[frontier], counts) + (
            np.arange(counts.sum())
            - np.repeat(np.cumsum(counts) - counts, counts))
        return np.unique(nbr[idx])

    def _bfs_traversal(self, seed_order, frontier_key=None) -> np.ndarray:
        """Level-synchronous vectorized BFS visit order (restarting per
        component along ``seed_order``); ``frontier_key(nodes) -> key``
        optionally sorts each new frontier (Cuthill–McKee's degree rule).
        """
        ptr, nbr = self._undirected_csr()
        visited = np.zeros(self.n, bool)
        out = np.empty(self.n, np.int64)
        k = 0
        si = 0
        while k < self.n:
            while visited[seed_order[si]]:
                si += 1
            frontier = np.asarray([seed_order[si]])
            visited[frontier] = True
            while len(frontier):
                out[k:k + len(frontier)] = frontier
                k += len(frontier)
                nxt = self.frontier_neighbors(ptr, nbr, frontier)
                nxt = nxt[~visited[nxt]]
                visited[nxt] = True
                frontier = (nxt if frontier_key is None
                            else nxt[np.argsort(frontier_key(nxt),
                                                kind="stable")])
        return out

    def bfs_order(self, start: int = 0) -> np.ndarray:
        """BFS permutation (new → old), restarting per component."""
        ids = np.arange(self.n)
        return self._bfs_traversal(
            np.concatenate([[start], ids[ids != start]]))

    def rcm_order(self) -> np.ndarray:
        """Reverse Cuthill–McKee permutation (new → old).

        BFS from a low-degree peripheral node, neighbors visited in
        ascending degree, result reversed. Low bandwidth = neighbor ids
        close together = high shift coverage and frontier locality for
        the build kernels.
        """
        ptr, _ = self._undirected_csr()
        deg = np.diff(ptr)
        out = self._bfs_traversal(np.argsort(deg, kind="stable"),
                                  frontier_key=lambda nodes: deg[nodes])
        return out[::-1].copy()

    # ----------------------------------------------------------------- io
    @classmethod
    def from_xy(cls, path: str) -> "Graph":
        xs, ys, src, dst, w = read_xy(path)
        return cls(xs, ys, src, dst, w)

    def __repr__(self):
        return f"Graph(n={self.n}, m={self.m}, Kout={self.max_out_degree})"
