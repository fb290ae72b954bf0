"""Diff epoch manager: fused swap of the active congestion diff.

One :class:`DiffEpochManager` per serving process (frontend or worker)
turns the segment stream into a sequence of **epoch swaps**:

* every ``refresh()`` pulls ALL pending segments and merges them into
  the running edge-weight delta in one pass — the fused multi-diff
  insight (one walk accumulates D diffs' costs; bench measures 3.7×
  fused vs sequential) applied to ingestion: N queued segments cost
  ONE materialized diff, one cache-invalidation pass, and one device
  weights upload, never N sequential swaps;
* the merged delta is materialized as an ordinary ``.diff`` file
  (``fused-e<epoch>.diff`` in the spool dir, atomic write), so the
  entire existing machinery — ``RuntimeConfig`` wire line 2, the
  engine's per-diff weight cache, the FIFO workers — serves the new
  epoch **without restart**: the serve path just starts naming the new
  file. In-flight batches pinned the old file name at dispatch and
  finish on the old epoch's device weights (the engine keeps the last
  ``DOS_TRAFFIC_KEEP_EPOCHS`` weight buffers resident — double
  buffering at the weights-array level);
* each swap reports its **affected-edge set** — the edges whose weight
  actually changed vs the previously active fusion — which is what
  lets the serving cache invalidate *scoped* instead of flushing
  wholesale (``serving.cache.ResultCache.invalidate_scoped``).

The manager never owns a thread: the frontend's epoch pump and the
worker's gate-time refresh call ``refresh()`` from exactly one place
each, so the internal lock only guards the published snapshot, and no
file IO ever happens under it.
"""

from __future__ import annotations

import glob
import os
import time

import numpy as np

from ..data.formats import read_diff, write_diff
from ..obs import metrics as obs_metrics
from ..utils.env import env_cast
from ..utils.locks import OrderedLock
from ..utils.log import get_logger
from .stream import DiffStream

log = get_logger(__name__)

M_SEGS = obs_metrics.counter(
    "traffic_segments_applied_total",
    "diff segments merged into an epoch swap")
M_EDGES = obs_metrics.counter(
    "traffic_edges_updated_total",
    "edges whose weight actually changed across epoch swaps")
G_EPOCH = obs_metrics.gauge(
    "traffic_epoch",
    "active diff epoch (0 = the static base diff, pre-traffic world)")
H_SWAP = obs_metrics.histogram(
    "traffic_swap_seconds",
    "segment merge + fused-diff materialization per epoch swap")


class DiffEpochManager:
    """See module docstring. ``stream`` is a segment source (anything
    with ``poll() -> list[DiffSegment]``) or a directory path (wrapped
    in a :class:`~.stream.DiffStream`). ``materialize=False`` tracks
    epochs without writing fused files — the worker-server gate mode,
    where the head already materialized the file the wire names."""

    def __init__(self, stream, base_diff: str = "-",
                 spool_dir: str | None = None, materialize: bool = True,
                 keep_epochs: int | None = None,
                 scoped_max: int | None = None,
                 sig_moves: int | None = None,
                 poll_ms: float | None = None,
                 on_swap=None):
        if isinstance(stream, str):
            stream = DiffStream(stream)
        self.stream = stream
        self.base_diff = base_diff
        self.materialize = materialize
        default_spool = (os.path.join(stream.dirname, "fused")
                         if isinstance(stream, DiffStream) else None)
        self.spool = spool_dir or default_spool
        if materialize and not self.spool:
            raise ValueError("a materializing DiffEpochManager needs a "
                             "spool dir (tail streams have no default)")
        #: fused diff files (and engine weight buffers) kept live; >= 2
        #: so an in-flight batch can finish on the old epoch's file
        self.keep_epochs = max(
            2, keep_epochs if keep_epochs is not None
            else env_cast("DOS_TRAFFIC_KEEP_EPOCHS", 2, int))
        #: affected-edge count above which scoped invalidation is not
        #: worth the per-entry scan: the cache flushes wholesale
        self.scoped_max = (scoped_max if scoped_max is not None
                           else env_cast("DOS_TRAFFIC_SCOPED_MAX",
                                         4096, int))
        #: path-signature moves the frontend asks the engine for
        self.sig_moves = (sig_moves if sig_moves is not None
                          else env_cast("DOS_TRAFFIC_SIG_MOVES", 64, int))
        self.poll_s = (poll_ms if poll_ms is not None
                       else env_cast("DOS_TRAFFIC_POLL_MS", 200.0,
                                     float)) / 1e3
        # base-diff overlay: (u, v) -> w of the static starting diff,
        # so fused files always carry base + every segment to date
        bsrc, bdst, bw = read_diff(base_diff)
        self._base = {(int(u), int(v)): int(ww)
                      for u, v, ww in zip(bsrc, bdst, bw)}
        self._delta: dict[tuple[int, int], int] = {}
        #: segments polled but not yet published: the stream advances
        #: its cursor inside poll(), so a failed materialization must
        #: NOT drop them — they stay here and the next refresh retries
        #: the fusion (losing one would silently omit its retimes from
        #: every later epoch)
        self._pending: list = []
        self._lock = OrderedLock("traffic.DiffEpochManager")
        self.epoch = 0
        self.difffile = base_diff
        self._affected: frozenset = frozenset()
        self._applied = 0
        #: retime→rebuild trigger hook: called AFTER a swap publishes,
        #: outside the lock, as ``on_swap(epoch, difffile, affected)``
        #: — the seam a delta-rebuild consumer registers on (kick
        #: ``models.cpd.delta_build_index`` for the new weight regime
        #: in the background, then promote the epoch-tagged index via
        #: ``ShardEngine.promote_index``). A raising hook is logged and
        #: never blocks or unwinds the swap itself.
        self.on_swap = on_swap

    # ------------------------------------------------------------- views
    def active(self) -> tuple[int, str, frozenset]:
        """Consistent ``(epoch, difffile, affected_last_swap)``
        snapshot."""
        with self._lock:
            return self.epoch, self.difffile, self._affected

    def weight_of(self, u: int, v: int, default: int) -> int:
        """Edge (u, v)'s weight under the ACTIVE fusion — segments win
        over the base diff, the base diff over ``default`` (the
        free-flow weight). The query-families planner prices first
        edges with this."""
        with self._lock:
            w = self._delta.get((int(u), int(v)))
        if w is None:
            w = self._base.get((int(u), int(v)))
        return int(default if w is None else w)

    def statusz(self) -> dict:
        with self._lock:
            return {
                "diff_epoch": int(self.epoch),
                "difffile": self.difffile,
                "segments_applied": int(self._applied),
                "affected_last_swap": len(self._affected),
            }

    # ------------------------------------------------------------ refresh
    def refresh(self) -> bool:
        """Pull pending segments; on any, fuse them into one new epoch
        and publish it. Returns True iff the epoch advanced. Stream
        errors (a torn mid-stream segment) degrade to "no swap" with a
        log line: serving continues on the last good epoch — the same
        keep-the-current-table rule the membership refresh uses."""
        t0 = time.perf_counter()
        try:
            self._pending.extend(self.stream.poll())
        except (OSError, ValueError) as e:
            log.error("diff stream poll failed: %s (keeping epoch %d)",
                      e, self.epoch)
            return False
        segs = self._pending
        if not segs:
            return False
        new_delta = dict(self._delta)
        affected: set[tuple[int, int]] = set()
        for seg in segs:
            for u, v, w in zip(seg.src, seg.dst, seg.w):
                key = (int(u), int(v))
                prev = new_delta.get(key, self._base.get(key))
                if prev is None or int(prev) != int(w):
                    affected.add(key)
                new_delta[key] = int(w)
        epoch = int(segs[-1].epoch)
        try:
            difffile = self._materialize(epoch, new_delta)
        except OSError as e:
            # keep the segments pending: publishing without the fused
            # file would name a path nobody can read, and dropping them
            # would omit their retimes from every later fusion forever
            log.error("fused diff for epoch %d failed to materialize: "
                      "%s (keeping epoch %d; %d segment(s) stay "
                      "pending)", epoch, e, self.epoch, len(segs))
            return False
        with self._lock:
            self._delta = new_delta
            self.epoch = epoch
            self.difffile = difffile
            self._affected = frozenset(affected)
            self._applied += len(segs)
        self._pending = []
        M_SEGS.inc(len(segs))
        M_EDGES.inc(len(affected))
        G_EPOCH.set(epoch)
        H_SWAP.observe(time.perf_counter() - t0)
        log.info("diff epoch %d active: %d segment(s) fused, %d edge(s) "
                 "changed -> %s", epoch, len(segs), len(affected),
                 difffile)
        if self.on_swap is not None:
            try:
                self.on_swap(epoch, difffile, frozenset(affected))
            except Exception as e:  # noqa: BLE001 — a rebuild trigger
                # must never unwind a published swap; serving continues
                log.error("on_swap hook failed for epoch %d: %s",
                          epoch, e)
        self._prune_spool(epoch)
        return True

    def _materialize(self, epoch: int, delta: dict) -> str:
        """One fused ``.diff`` carrying base + every segment to date —
        the file the wire names from now on (gate-only managers skip
        the write and return the canonical path the head produced)."""
        if not self.materialize:
            # gate-only (worker) mode: the wire names the file the head
            # materialized; this manager only tracks the epoch ladder
            return (self.fused_path(epoch) if self.spool
                    else f"epoch:{epoch}")
        path = self.fused_path(epoch)
        merged = dict(self._base)
        merged.update(delta)
        keys = sorted(merged)           # deterministic bytes per epoch
        src = np.asarray([k[0] for k in keys], np.int64)
        dst = np.asarray([k[1] for k in keys], np.int64)
        w = np.asarray([merged[k] for k in keys], np.int64)
        os.makedirs(self.spool, exist_ok=True)
        write_diff(path, src, dst, w)
        return path

    def fused_path(self, epoch: int) -> str:
        if not self.spool:
            raise ValueError("no spool dir configured")
        return os.path.join(self.spool, f"fused-e{int(epoch):06d}.diff")

    def _prune_spool(self, epoch: int) -> None:
        """Drop fused files older than the keep window. The window is
        >= 2, so the previous epoch's file survives every in-flight
        batch that pinned it at dispatch."""
        if not self.materialize:
            return
        old = sorted(glob.glob(os.path.join(self.spool,
                                            "fused-e*.diff")))
        for p in old[:-self.keep_epochs]:
            try:
                os.remove(p)
            except OSError as e:
                log.warning("cannot prune fused diff %s: %s", p, e)
