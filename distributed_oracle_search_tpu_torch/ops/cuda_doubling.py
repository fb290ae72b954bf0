"""Pointer doubling as hand-written CUDA kernels (K5).

Serves the JAX package's XLA stage ``ops/pointer_doubling.py``
(``doubled_tables(_multi)``'s ``while_loop``; no Pallas kernel there).
The source is ``csrc/pointer_doubling.cu`` with three tiers:

* :func:`doubling_rows`, every sweep of a row in one launch, the row's
  ``(succ, plen, cost[0:D])`` records (16-byte groups) held in shared
  memory (one block a row, or a thread-block cluster a row whose blocks
  read each other's shared memory), written back once with the row's
  ``settled`` sweep and ``live`` bit;
* :func:`doubling_team`, the same contract for rows no cluster holds: a
  team of co-resident blocks a row, each holding its window of the row
  in shared memory and gathering the rest from the row's copies in
  device memory (L2), one team barrier a sweep; the teams stride over a
  chunk's rows in one cooperative launch;
* :func:`doubling_sweep`, the wide path for rows no team of the card
  holds: one sweep over device memory, one thread an entry.

:func:`rows_plan` gives the shape, by :func:`shape_rule` (a pure
function of the card's figures) and :func:`plan_tier` names its tier.
See the note at the top of the source for the design and what bounds
it. The library is built with ``nvcc`` at first use
(``utils.cuda_build``) and called through plain C entry points with
``ctypes``.

Each wrapper picks by the device its tensors lie on: CPU records take
the plain version (:func:`.pointer_doubling.double_rows`,
:func:`.pointer_doubling.sweep_records`), CUDA records launch the kernel
or raise. There is no fallback.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_walk import _check
from ..utils.counts import bump
from .pointer_doubling import double_rows, record_width, sweep_records

#: the CUDA source (``csrc/<KERNEL_NAME>.cu``) and its entry points
KERNEL_NAME = "pointer_doubling"
ENTRY = "doubling_sweep"
ENTRY_ROWS = "doubling_rows"
ENTRY_TEAM = "doubling_team"
ENTRY_CARD = "doubling_card"
#: the row kernels' limits (``csrc/pointer_doubling.cu``): threads a
#: block, nodes a thread, blocks a cluster
ROW_THREADS = 512
MAX_NPT = 16
MAX_CLUSTER = 16

_fns: dict[str, object] = {}
_cards: dict[int, tuple[int, int, int, int]] = {}
_plans: dict[tuple, tuple[int, int, int, int, int]] = {}


def _kernel(entry: str):
    if entry not in _fns:
        from ..utils.cuda_build import load_library

        fn = getattr(load_library(KERNEL_NAME), entry)
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = {ENTRY: [p, p, p, ll, i, i, p],
                       ENTRY_ROWS: [p, ll, i, i, p, i, i, p, p, p],
                       ENTRY_TEAM: [p, p, p, ll, i, i, p, i, i, p, p, p],
                       ENTRY_CARD: [p]}[entry]
        fn.restype = ctypes.c_int
        _fns[entry] = fn
    return _fns[entry]


def shape_rule(n: int, d: int, sms: int, smem: int, resident: int,
               clusters: int = MAX_CLUSTER
               ) -> tuple[int, int, int, int, int]:
    """The shape of a row of ``n`` nodes and ``d`` cost sets on a card of
    ``sms`` SMs, ``smem`` opt-in shared bytes a block, ``resident``
    blocks of the team kernel an SM holds and ``clusters`` the largest
    cluster it holds: ``(blocks a row, threads a block, nodes a block,
    shared bytes a block, teams)``.

    The fewest blocks ``c`` whose shared memory holds ``ceil(n / c)``
    records of :func:`.pointer_doubling.record_width` ints (``2 + d``
    rounded up to 16 bytes; 16 bytes more for an mbarrier and slots) at
    no more than 16 nodes a thread of 512. ``c`` up to ``clusters``: a
    cluster a row (teams 0, :func:`doubling_rows`). Else, ``c`` up to
    the blocks the card holds at once (``sms * resident``): a team a
    row, as many teams as fit (:func:`doubling_team`). Else blocks 0:
    no team holds the row (:func:`doubling_sweep`)."""
    g = record_width(d) // 4
    fit = min(MAX_NPT * ROW_THREADS, (smem - 16) // (16 * g))
    c = max(-(-n // fit), 1) if fit > 0 else 0
    if c == 0 or c > max(clusters, sms * resident):
        return 0, 0, 0, 0, 0
    nl = -(-n // c)
    threads = ROW_THREADS if nl >= ROW_THREADS else -(-nl // 32) * 32
    teams = 0 if c <= clusters else sms * resident // c
    return c, threads, nl, nl * g * 16 + 16, teams


def plan_tier(plan) -> str:
    """The tier a plan of :func:`rows_plan` names: ``"sweep"`` (blocks
    0), ``"team"`` (teams > 0) or ``"cluster"``."""
    if not plan[0]:
        return "sweep"
    return "team" if plan[4] else "cluster"


def card_figures(idx: int) -> tuple[int, int, int, int]:
    """CUDA device ``idx``'s figures for :func:`shape_rule`: ``(SMs,
    opt-in shared bytes a block, team blocks an SM holds, largest
    cluster)``, asked of the C library once (which also readies the
    kernels)."""
    if idx not in _cards:
        out = (ctypes.c_int * 4)()
        with torch.cuda.device(idx):
            err = _kernel(ENTRY_CARD)(ctypes.addressof(out))
        if err != 0:
            raise RuntimeError(f"{ENTRY_CARD} failed: CUDA error {err}")
        _cards[idx] = tuple(out)
    return _cards[idx]


def rows_plan(n: int, d: int, device: torch.device
              ) -> tuple[int, int, int, int, int]:
    """The shape of a row of ``n`` nodes and ``d`` cost sets on
    ``device``: :func:`shape_rule` on the card's figures
    (:func:`card_figures`), made once a (device, n, d); every launch of
    that shape passes it back. On the CPU there is no card: one "block"
    a row (the cluster tier), the plain version."""
    if device.type == "cpu":
        return 1, 0, n, 0, 0
    if device.type != "cuda":
        raise ValueError(f"no doubling for tensors on {device}")
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    key = (idx, n, d)
    if key not in _plans:
        _plans[key] = shape_rule(n, d, *card_figures(idx))
    return _plans[key]


def _rows_operands(rec: torch.Tensor, d: int, sweeps: int,
                   tier: str) -> None:
    """Check CUDA records for a launch of ``tier``; raises when the
    shape rule sends the row to another tier."""
    dev = rec.device
    if d < 1 or rec.dim() != 3 or rec.shape[2] != record_width(d):
        raise ValueError(f"records must be [R, N, record_width(d)] with d "
                         f"= {d}, got {tuple(rec.shape)}")
    _check("records", rec, torch.int32, rec.shape, dev)
    if rec.data_ptr() % 16:
        raise ValueError("records must start on 16 bytes")
    if sweeps < 0:
        raise ValueError(f"sweeps must be >= 0, got {sweeps}")
    n = rec.shape[1]
    if n >= 2 ** 31:
        raise ValueError(f"{n} nodes overflow the kernel's int32 node ids")
    got = plan_tier(rows_plan(n, d, dev))
    if got == "sweep":
        raise ValueError(f"a row of {n} nodes x {record_width(d)} ints "
                         "fits no cluster or team of this card: take the "
                         "wide path (doubling_sweep)")
    if got != tier:
        raise ValueError(f"a row of {n} nodes x {record_width(d)} ints "
                         f"takes the {got} tier on this card: call "
                         f"{ENTRY_TEAM if got == 'team' else ENTRY_ROWS}")


def doubling_rows(rec: torch.Tensor, d: int, sweeps: int,
                  fixed: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Double every row of int32 ``[R, N, P]`` records (``P`` =
    :func:`.pointer_doubling.record_width` of ``d``) in place, a cluster
    a row: up to ``sweeps`` sweeps a row, each row stopping after its
    first sweep that moves no successor, or exactly ``sweeps`` when
    ``fixed``. Returns ``(settled int32 [R], live bool [R])``
    (:func:`.pointer_doubling.double_rows` defines both).

    Each kernel launch adds one to ``doubling_rows.launches``, each call
    on CPU tensors (the plain version) one to ``doubling_rows.plain``."""
    if rec.device.type == "cpu":
        bump(doubling_rows, "plain")
        return double_rows(rec, d, sweeps, fixed)
    if rec.device.type != "cuda":
        raise ValueError(f"no doubling for tensors on {rec.device}")
    _rows_operands(rec, d, sweeps, "cluster")
    r = rec.shape[0]
    settled = torch.empty(r, dtype=torch.int32, device=rec.device)
    live = torch.empty(r, dtype=torch.bool, device=rec.device)
    if r:
        launch_rows(rec, d, sweeps, fixed, settled, live)
    return settled, live


def launch_rows(rec: torch.Tensor, d: int, sweeps: int, fixed: bool,
                settled: torch.Tensor, live: torch.Tensor) -> None:
    """The bare on-chip launch on tensors :func:`doubling_rows` has
    checked and allocated, in the shape :func:`rows_plan` gives: one
    launch on the current stream, no synchronisation; raises if the
    launch is refused. Counts the launch."""
    fn = _kernel(ENTRY_ROWS)
    r, n, p = rec.shape
    dev = rec.device
    plan = (ctypes.c_int * 4)(*rows_plan(n, d, dev)[:4])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(rec.data_ptr(), r, n, p // 4, ctypes.addressof(plan),
                 int(sweeps), int(bool(fixed)), settled.data_ptr(),
                 live.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{ENTRY_ROWS} launch failed: CUDA error {err}")
    bump(doubling_rows, "launches")


doubling_rows.launches = 0
doubling_rows.plain = 0


def doubling_team(rec: torch.Tensor, d: int, sweeps: int,
                  fixed: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`doubling_rows`' contract for rows past the largest cluster
    (the team tier of :func:`rows_plan`): every row of int32 ``[R, N,
    P]`` records doubled in place by a team of co-resident blocks, the
    chunk in one launch; returns ``(settled int32 [R], live bool [R])``.

    Each kernel launch adds one to ``doubling_team.launches``, each call
    on CPU tensors (the plain version, :func:`.pointer_doubling.
    double_rows`) one to ``doubling_team.plain``."""
    if rec.device.type == "cpu":
        bump(doubling_team, "plain")
        return double_rows(rec, d, sweeps, fixed)
    if rec.device.type != "cuda":
        raise ValueError(f"no doubling for tensors on {rec.device}")
    _rows_operands(rec, d, sweeps, "team")
    r = rec.shape[0]
    settled = torch.empty(r, dtype=torch.int32, device=rec.device)
    live = torch.empty(r, dtype=torch.bool, device=rec.device)
    if r:
        launch_team(rec, d, sweeps, fixed, settled, live)
    return settled, live


def launch_team(rec: torch.Tensor, d: int, sweeps: int, fixed: bool,
                settled: torch.Tensor, live: torch.Tensor) -> None:
    """The bare team launch on tensors :func:`doubling_team` has checked
    and allocated, in the shape :func:`rows_plan` gives: the teams' row
    copies and zeroed barrier state allocated, then one cooperative
    launch on the current stream, no synchronisation; raises if the card
    refuses it (no fallback). Counts the launch."""
    fn = _kernel(ENTRY_TEAM)
    r, n, p = rec.shape
    dev = rec.device
    shape = rows_plan(n, d, dev)
    teams = min(shape[4], r)
    scratch = torch.empty((teams, n, p), dtype=torch.int32, device=dev)
    sync = torch.zeros((shape[4], 4), dtype=torch.int32, device=dev)
    plan = (ctypes.c_int * 5)(*shape)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(rec.data_ptr(), scratch.data_ptr(), sync.data_ptr(), r, n,
                 p // 4, ctypes.addressof(plan), int(sweeps),
                 int(bool(fixed)), settled.data_ptr(), live.data_ptr(),
                 stream)
    if err != 0:
        raise RuntimeError(f"{ENTRY_TEAM} launch failed: CUDA error {err}")
    bump(doubling_team, "launches")


doubling_team.launches = 0
doubling_team.plain = 0


def doubling_sweep(cur: torch.Tensor, out: torch.Tensor,
                   flag: torch.Tensor) -> torch.Tensor:
    """One doubling sweep (the wide path) of int32 ``[R, N, P]`` records
    (``P`` a multiple of 4: ``pointer_doubling.record_width``) from
    ``cur`` into ``out`` (a distinct buffer of the same shape); sets
    ``flag[0] = 1`` (int32 ``[1]``) when any successor moved and leaves
    it otherwise. Returns ``out``.

    Each kernel launch adds one to ``doubling_sweep.launches``, each
    sweep on CPU tensors (the plain version) one to
    ``doubling_sweep.plain``."""
    if cur.device.type == "cpu":
        bump(doubling_sweep, "plain")
        new, changed = sweep_records(cur)
        out.copy_(new)
        if changed:
            flag.fill_(1)
        return out
    if cur.device.type != "cuda":
        raise ValueError(f"no doubling sweep for tensors on {cur.device}")
    dev = cur.device
    if cur.dim() != 3 or cur.shape[2] % 4 or cur.shape[2] == 0:
        raise ValueError(f"records must be [R, N, 4 v], got "
                         f"{tuple(cur.shape)}")
    _check("records", cur, torch.int32, cur.shape, dev)
    _check("out", out, torch.int32, cur.shape, dev)
    _check("flag", flag, torch.int32, (1,), dev)
    if cur.data_ptr() == out.data_ptr():
        raise ValueError("the sweep is double-buffered: out must not be "
                         "the records")
    if (cur.data_ptr() | out.data_ptr()) % 16:
        raise ValueError("records must start on 16 bytes")
    r, n, p = cur.shape
    if n >= 2 ** 31 or r * -(-n // 256) >= 2 ** 31:
        raise ValueError(f"{r} x {n} records overflow the kernel's int32 "
                         "node ids and tiles")
    launch_sweep(cur, out, flag)
    return out


def launch_sweep(cur: torch.Tensor, out: torch.Tensor,
                 flag: torch.Tensor) -> None:
    """The bare wide-path launch on tensors :func:`doubling_sweep` has
    checked: one launch on the current stream, no synchronisation; raises
    if the launch is refused. Counts the launch."""
    fn = _kernel(ENTRY)
    r, n, p = cur.shape
    dev = cur.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(cur.data_ptr(), out.data_ptr(), flag.data_ptr(), r, n,
                 p // 4, stream)
    if err != 0:
        raise RuntimeError(f"{ENTRY} launch failed: CUDA error {err}")
    bump(doubling_sweep, "launches")


doubling_sweep.launches = 0
doubling_sweep.plain = 0
