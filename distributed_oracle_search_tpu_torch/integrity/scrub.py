"""Resident-table scrubber: re-verify what is actually in memory.

The disk path is already defended (digest-verified loads, quarantine +
heal, replica anti-entropy) — but the resident first-move table a
worker serves from is read billions of times and re-checked never.
This module closes that gap: each pass walks one engine's block files
through the SAME verified load path the engine booted from
(``models.cpd.load_verified_block`` against the manifest), decodes any
pack4/RLE container to dense rows (``models.resident``), and compares
a crc32 of those disk-truth rows against a crc32 of the corresponding
RESIDENT row range — decompressing the resident codec at the point of
check, exactly like the serving path does at the point of use.

Fault taxonomy and response:

* block corrupt/missing ON DISK → the shared ``heal_block``
  quarantine → copy-replica → rebuild path (base table only; an epoch
  index never heals from the free-flow graph — ``promote_index``'s
  wrong-regime rule — it just stops promoting);
* resident rows diverge from verified disk rows → books
  ``scrub_blocks_corrupt_total``, emits a ``scrub_corrupt`` recorder
  event, and re-binds the WHOLE table from disk — a single reference
  swap (``engine.fm`` / the promote gate's ``(epoch, table)`` pair),
  so in-flight batches finish on the old reference and never tear.

Both the base table and an epoch-promoted index are covered; the
promoted gate re-binds under the engine's promote lock keeping its
epoch, or clears to the always-correct base table when the epoch index
is no longer loadable.

The pass is deliberately low-priority: one block is read, decoded, and
compared at a time, with an optional per-pass block budget
(``DOS_SCRUB_BLOCKS_PER_PASS``) and a resume cursor so a huge shard
scrubs incrementally across passes instead of monopolizing the host.

The port of the JAX package's ``integrity/scrub.py``; reports are equal
between packages. The resident table lives on the engine's device (the
card): a raw table is sliced there, a ``CompressedFM`` decodes its rows
there (``decompress_rows``), and each range goes to the host in bounded
row chunks (``models.resident._row_chunks``) whose crc32 chains into the
range's, so a pass never holds a second copy of a shard on the card;
the crc32 reads each array's buffer in place (JAX's copies it to bytes
first: the same digest).
A disk heal rebuilds on the engine's device (K1/K2 on the card), and a
re-bind publishes a table made by the engine's resident policy there.
"""

from __future__ import annotations

import glob
import os
import re
import threading
import time
import zlib

import numpy as np

from ..obs import metrics as obs_metrics
from ..obs import recorder as obs_recorder
from ..utils.locks import OrderedLock
from ..utils.log import get_logger

log = get_logger(__name__)

M_SCRUB_CHECKED = obs_metrics.counter(
    "scrub_blocks_checked_total",
    "resident blocks crc32-compared against their digest-verified "
    "on-disk truth by the resident-table scrubber "
    "(DOS_SCRUB_INTERVAL_S)")
M_SCRUB_CORRUPT = obs_metrics.counter(
    "scrub_blocks_corrupt_total",
    "resident blocks whose rows diverged from verified disk rows — "
    "silent in-memory corruption; the table re-binds from disk")
M_SCRUB_PASSES = obs_metrics.counter(
    "scrub_passes_total", "completed resident-scrub passes")
M_SCRUB_SECONDS = obs_metrics.histogram(
    "scrub_pass_seconds", "wall time of one resident-scrub pass")


def _resident_crc(table, lo: int, hi: int) -> int:
    """crc32 of the dense int8 ``[hi-lo, N]`` row range of the RESIDENT
    table — raw tables slice, compressed tables decompress at the point
    of check (the same ``decompress_rows`` the serving path trusts) —
    equal to ``zlib.crc32`` of the whole range's bytes. The range moves
    to the host in chunks of ``_row_chunks`` rows (a compressed chunk
    decodes on the table's device first), so neither the device nor the
    host holds more than one chunk beside the table."""
    import torch

    from ..models.resident import CompressedFM, _row_chunks

    crc = 0
    n = int(table.shape[1])
    for sl in _row_chunks(hi - lo, n):
        a, b = lo + sl.start, lo + sl.stop
        if isinstance(table, CompressedFM):
            dev = next(iter(table.arrays.values())).device
            part = table.decompress_rows(
                torch.arange(a, b, dtype=torch.int64, device=dev))
        elif isinstance(table, torch.Tensor):
            part = table[a:b]
        else:
            part = torch.as_tensor(np.asarray(table[a:b], np.int8))
        chunk = np.ascontiguousarray(part.to(torch.int8).cpu().numpy())
        crc = zlib.crc32(chunk, crc)
    return crc


def _shard_block_files(outdir: str, shard: int, replica: int,
                       blocks_meta: dict) -> list[str]:
    """The shard's block files in block order — the manifest's view
    when it has one (it knows blocks the glob cannot see), the glob
    otherwise. Mirrors ``worker.engine.load_shard_rows``'s discovery
    so the scrubber checks exactly what the engine loaded."""
    from ..models.cpd import shard_block_name

    prefix = shard_block_name(shard, 0, replica)[:-len("00000.npy")]
    bid_of = lambda p: int(re.search(r"-b(\d+)\.npy$", p).group(1))  # noqa: E731
    manifested = sorted(
        (os.path.join(outdir, f) for f in blocks_meta
         if f.startswith(prefix)), key=bid_of)
    if manifested:
        return manifested
    return sorted(glob.glob(os.path.join(outdir, f"{prefix}*.npy")),
                  key=bid_of)


def scrub_engine_table(engine, outdir: str, table, epoch: int | None,
                       *, budget: int = 0, cursor: tuple = (0, 0),
                       heal: bool = True) -> tuple[dict, tuple]:
    """Scrub ONE resident table (base when ``epoch is None``, the
    promoted index otherwise) against the block files in ``outdir``.

    Returns ``(report, next_cursor)`` — ``next_cursor`` is ``(0, 0)``
    when the pass reached the end (wrap around), else the
    ``(block_index, row_offset)`` to resume from. The report::

        {"checked": n, "corrupt": [fname...], "healed": [fname...],
         "rebound": bool, "errors": [reason...]}
    """
    from ..models.cpd import (check_manifest_version, heal_block,
                              load_verified_block, read_manifest)
    from ..models.resident import maybe_decode_rows

    report: dict = {"checked": 0, "corrupt": [], "healed": [],
                    "rebound": False, "errors": []}
    manifest: dict | None = None
    try:
        manifest = read_manifest(outdir)
        check_manifest_version(manifest, outdir)
    except (OSError, ValueError) as e:
        # pre-manifest partial build: blocks scrub without digests
        # (resident-vs-disk compare still catches memory rot); a
        # NEWER-schema manifest is the one hard stop
        if "manifest schema" in str(e):
            report["errors"].append(str(e))
            return report, (0, 0)
        manifest = None
    blocks_meta = (manifest or {}).get("blocks", {})
    files = _shard_block_files(outdir, engine.shard, engine.replica,
                               blocks_meta)
    if not files:
        report["errors"].append(f"no blocks for shard {engine.shard} "
                                f"in {outdir}")
        return report, (0, 0)
    start, lo = cursor
    if not (0 <= start < len(files)):
        start, lo = 0, 0            # block set changed: restart
    dirty = False
    i = start
    for i in range(start, len(files)):
        if budget and report["checked"] >= budget:
            return report, (i, lo)
        path = files[i]
        fname = os.path.basename(path)
        rows, status, reason = load_verified_block(
            path, blocks_meta.get(fname))
        if rows is None:
            # disk-side rot found by the scrub read: the shared
            # quarantine→heal path fixes the FILE; the resident table
            # was loaded from the pre-rot bytes and stays authoritative
            if epoch is None and heal and manifest is not None:
                try:
                    rows = heal_block(outdir, manifest, fname,
                                      engine.shard, engine.graph,
                                      engine.dc, status=status,
                                      reason=reason,
                                      device=engine.device)
                    report["healed"].append(fname)
                except (OSError, ValueError) as e:
                    report["errors"].append(f"{fname}: unhealable: {e}")
                    return report, (0, 0)
            else:
                report["errors"].append(f"{fname}: {status}: {reason}")
                return report, (0, 0)   # row offsets unknowable past it
        else:
            rows = maybe_decode_rows(rows)
        rows = np.ascontiguousarray(np.asarray(rows, np.int8))
        nrows = int(rows.shape[0])
        res_crc = _resident_crc(table, lo, lo + nrows)
        M_SCRUB_CHECKED.inc()
        report["checked"] += 1
        if zlib.crc32(rows) != res_crc:
            M_SCRUB_CORRUPT.inc()
            dirty = True
            report["corrupt"].append(fname)
            log.error("scrub: resident rows of %s (shard %d%s) diverge "
                      "from verified disk rows — re-binding the table",
                      fname, engine.shard,
                      "" if epoch is None else f", epoch {epoch}")
            obs_recorder.emit("scrub_corrupt", wid=engine.wid,
                              shard=engine.shard, file=fname,
                              epoch=epoch,
                              codec=getattr(engine, "resident_codec",
                                            None))
        lo += nrows
    if dirty:
        report["rebound"] = _rebind(engine, epoch)
    return report, (0, 0)


def _rebind(engine, epoch: int | None) -> bool:
    """Republish a table from its verified disk truth — one atomic
    reference swap, exactly the publish discipline ``promote_index``
    uses, so in-flight batches keep their old reference and the epoch
    gate's ``(epoch, table)`` pair can never tear. The engine reads
    its table once a batch (``ShardEngine._fm_for``): a batch in flight
    keeps walking the old tensor, which the card frees when that batch
    drops it; until then both tables are resident."""
    from ..models.cpd import epoch_index_dir
    from ..worker.engine import load_shard_rows

    if epoch is None:
        rows = load_shard_rows(engine.outdir, engine.shard,
                               dc=engine.dc, graph=engine.graph,
                               replica=engine.replica,
                               device=engine.device)
        engine.fm = engine._make_resident(rows)
        return True
    edir = epoch_index_dir(engine.outdir, epoch)
    rows = None
    try:
        # heal=False, no graph: promote_index's rule — an epoch index
        # must never be healed from the free-flow graph
        rows = load_shard_rows(edir, engine.shard, dc=engine.dc,
                               heal=False, replica=engine.replica)
    except (OSError, ValueError, FileNotFoundError) as e:
        log.error("scrub: epoch %d index for shard %d unreloadable "
                  "(%s); dropping the promotion — the base table is "
                  "the correct fallback", epoch, engine.shard, e)
    with engine._promote_lock:
        cur = engine._fm_promoted
        if cur is None or cur[0] != epoch:
            return False            # a newer promotion won the race
        if rows is not None and rows.shape[0] == cur[1].shape[0]:
            engine._fm_promoted = (epoch, engine._make_resident(rows))
        else:
            engine._fm_promoted = None
    return True


class TableScrubber:
    """Background resident-scrub loop over a set of live engines.

    ``engines_fn`` returns the engines to cover (called every pass, so
    engines built lazily by the dispatcher join the rotation as they
    appear). ``scrub_now(shard)`` — the control loop's divergence-
    quarantine hook — wakes the thread immediately and scrubs that
    shard unbudgeted before re-admission probes can pass.
    """

    def __init__(self, engines_fn, interval_s: float,
                 blocks_per_pass: int = 0, clock=time.monotonic):
        self.engines_fn = engines_fn
        self.interval_s = float(interval_s)
        self.blocks_per_pass = int(blocks_per_pass)
        self.clock = clock
        self._lock = OrderedLock("integrity.TableScrubber")
        self._cursors: dict = {}
        self._asap: set[int] = set()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.passes = 0
        self.last_report: list = []
        self.corrupt_blocks = 0
        self.healed_blocks = 0

    # ---------------------------------------------------------- control
    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, name="dos-scrub", daemon=True)
        self._thread.start()

    def stop(self, join_s: float = 10.0) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=join_s)
            self._thread = None

    def scrub_now(self, shard: int | None = None) -> None:
        """Schedule an immediate, unbudgeted scrub (of one shard, or
        everything) — safe from any thread; returns at once."""
        with self._lock:
            self._asap.add(-1 if shard is None else int(shard))
        self._wake.set()

    # ------------------------------------------------------------- pass
    def run_pass(self, shards: set | None = None,
                 budget: int | None = None) -> list[dict]:
        """One synchronous scrub pass (the thread's body; tests and
        ``scrub_now`` drills call it directly). Returns per-table
        reports."""
        t0 = time.perf_counter()
        budget = self.blocks_per_pass if budget is None else budget
        out = []
        for engine in list(self.engines_fn() or ()):
            if getattr(engine, "alg", None) != "table-search":
                continue
            if getattr(engine, "fm", None) is None:
                continue
            if shards is not None and engine.shard not in shards:
                continue
            out.extend(self._scrub_engine(engine, budget))
        with self._lock:
            self.passes += 1
            self.last_report = out
            self.corrupt_blocks += sum(len(r["corrupt"]) for r in out)
            self.healed_blocks += sum(len(r["healed"]) for r in out)
        M_SCRUB_PASSES.inc()
        M_SCRUB_SECONDS.observe(time.perf_counter() - t0)
        return out

    def _scrub_engine(self, engine, budget: int) -> list[dict]:
        from ..models.cpd import epoch_index_dir

        out = []
        tables = [(engine.outdir, engine.fm, None)]
        promoted = engine._fm_promoted      # one read: (epoch, table)
        if promoted is not None:
            tables.append((epoch_index_dir(engine.outdir, promoted[0]),
                           promoted[1], promoted[0]))
        for outdir, table, epoch in tables:
            if self._stop.is_set():
                break
            key = (id(engine), "base" if epoch is None else epoch)
            with self._lock:
                cursor = self._cursors.get(key, (0, 0))
            try:
                report, nxt = scrub_engine_table(
                    engine, outdir, table, epoch, budget=budget,
                    cursor=cursor)
            except Exception as e:  # noqa: BLE001 — the scrubber must
                # degrade, never take the serve down with it
                log.error("scrub: pass over shard %d failed: %s",
                          engine.shard, e)
                report, nxt = {"checked": 0, "corrupt": [],
                               "healed": [], "rebound": False,
                               "errors": [str(e)]}, (0, 0)
            report.update(shard=engine.shard, epoch=epoch)
            # a rebind replaced the table reference: restart the
            # cursor so the NEW table is verified from block 0
            with self._lock:
                self._cursors[key] = ((0, 0) if report["rebound"]
                                      else nxt)
            out.append(report)
        return out

    def _run(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(timeout=self.interval_s)
            self._wake.clear()
            if self._stop.is_set():
                return
            with self._lock:
                asap, self._asap = self._asap, set()
            if asap:
                # divergence-quarantine path: scrub the implicated
                # shards in full, budget ignored — re-admission waits
                # on this evidence
                self.run_pass(
                    shards=None if -1 in asap else asap, budget=0)
            else:
                self.run_pass()

    # ------------------------------------------------------------ status
    def statusz(self) -> dict:
        with self._lock:
            return {
                "interval_s": self.interval_s,
                "blocks_per_pass": self.blocks_per_pass,
                "passes": self.passes,
                "corrupt_blocks": self.corrupt_blocks,
                "healed_blocks": self.healed_blocks,
                "last": [
                    {k: r.get(k) for k in ("shard", "epoch", "checked",
                                           "corrupt", "healed",
                                           "rebound", "errors")}
                    for r in self.last_report],
            }
