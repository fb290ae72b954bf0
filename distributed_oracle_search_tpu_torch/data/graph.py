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
tie-break — is the same code, byte for byte.
"""

from __future__ import annotations

import numpy as np

from .formats import read_xy, read_diff

INF = np.int32(10 ** 9)  # INF + INF < int32 max; real path costs stay far below


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

    # ----------------------------------------------------------- ordering
    def reorder(self, perm: np.ndarray) -> "Graph":
        """Relabel nodes: new id ``i`` is old node ``perm[i]``.

        The analog of the reference's ``--order`` NodeOrdering override
        (reference ``args.py:119``). Costs and paths are invariant — only
        labels move (query node ids must be mapped through the inverse
        permutation).
        """
        perm = np.asarray(perm, np.int64)
        if not np.array_equal(np.sort(perm), np.arange(self.n)):
            raise ValueError("perm must be a permutation of 0..n-1")
        inv = np.empty(self.n, np.int64)
        inv[perm] = np.arange(self.n)
        return Graph(self.xs[perm], self.ys[perm],
                     inv[self.src], inv[self.dst], self.w)

    # ----------------------------------------------------------------- io
    @classmethod
    def from_xy(cls, path: str) -> "Graph":
        xs, ys, src, dst, w = read_xy(path)
        return cls(xs, ys, src, dst, w)

    def __repr__(self):
        return f"Graph(n={self.n}, m={self.m}, Kout={self.max_out_degree})"
