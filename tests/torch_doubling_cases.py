"""Corrupted first-move rows for the pointer-doubling tests of the
PyTorch port (``test_torch_pointer_doubling.py`` on the CPU,
``test_torch_cuda_serving.py`` on the card). Imports nothing of JAX."""

from __future__ import annotations

import numpy as np

from distributed_oracle_search_tpu_torch.data import Graph


def _slot(g: Graph, a: int, b: int) -> int:
    nbr, eid = g.ell("out")
    hit = np.flatnonzero((nbr[a] == b) & (eid[a] < g.m))
    assert hit.size, (a, b)
    return int(hit[0])


def plant_cycles(g: Graph, fm: np.ndarray, r2: int, r3: int) -> None:
    """Corrupt first-move rows in place: row ``r2`` gets a 2-cycle
    ``a -> b -> a`` and row ``r3`` a 3-cycle ``a -> b -> c -> a`` along
    real edges (every weight is positive), at the first such nodes. A
    2-cycle settles into two fixed points whose cost and plen grow every
    sweep (a live row); a 3-cycle never settles (2^k steps never close
    it)."""
    out: dict[int, set[int]] = {}
    for a, b in zip(g.src.tolist(), g.dst.tolist()):
        if a != b:
            out.setdefault(a, set()).add(b)
    two = next((a, b) for a in sorted(out) for b in sorted(out[a])
               if a in out.get(b, ()))
    three = next((a, b, c) for a in sorted(out) for b in sorted(out[a])
                 for c in sorted(out.get(b, ())) if c != a
                 and a in out.get(c, ()))
    for r, cyc in ((r2, two), (r3, three)):
        for i, a in enumerate(cyc):
            fm[r, a] = _slot(g, a, cyc[(i + 1) % len(cyc)])
