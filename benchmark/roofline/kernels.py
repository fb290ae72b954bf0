"""The bytes and operations a kernel's work needs, from its shapes: a
frozen copy of the chip smoke's arithmetic (``chip_smoke.py``:
``first_moves_vs_plain`` and ``sweep_bytes``). Each input byte counts
once and each output byte once, whatever the kernel reads again."""


def first_moves_bytes(n: int, m: int, b: int, r: int) -> int:
    """K2 (``first_moves``) on ``b`` distance columns of ``n`` nodes over
    ``m`` out-edges, writing ``r`` int8 rows: the int32 ``[N, B]``
    distances, the CSR (row pointers, destinations, weights) and the
    targets read once, the rows written once."""
    return n * b * 4 + (n + 1) * 4 + 2 * m * 4 + b * 4 + r * n


def first_moves_ops(m: int, b: int) -> int:
    """K2's int32 operations: an add, a compare, a select and a min an
    edge and column."""
    return 4 * m * b


def astar_sweep_bytes(n: int, k: int, q: int) -> int:
    """One K6 sweep (``astar_sweep``) of ``q`` queries on ``n`` nodes of
    in-degree ``k``: g, h, hops and changed read, g, hops and improved
    written (22 bytes a cell), the in-edge ELL (neighbours, weights), the
    targets and the valid lanes."""
    return 22 * n * q + 8 * n * k + 5 * q
