"""The CPD: one worker's shard, and the whole index on one device.

The Compressed Path Database is a ``[R, N]`` int8 first-move table per
worker (owned-target row × node). This module ports, from the JAX
package's ``models/cpd.py``, the single-shard part and the in-process
oracle:

* :func:`pick_build_kernel` — the build policy: ``method`` (``auto`` by
  the graph's structure) resolved to one of the five distance stages
  (``sweep``, ``shift``, ``frontier``, ``ellsplit``, ``ell``) with its
  host-side bundle, by the JAX package's gates;
* :func:`build_worker_shard` — the per-worker build (reference
  ``make_cpd_auto``, ``make_cpds.py:20``): the owned targets in
  ``chunk``-row batches through the resolved stage
  (``parallel.sharded.chunk_compute``) on one device, one ``.npy``
  file per controller block, each written atomically and journaled with
  its crc32 digest in the per-worker build ledger; a re-run resumes
  (``resume=False`` recomputes) and ``replica=r`` writes a shard's rank-r
  replica block set. A ``codec`` persists each block as a compressed
  container (``models.resident``). The block loop is pipelined (a stager
  thread ahead, a flush thread behind; ``DOS_BUILD_PIPELINE``), an
  ``epoch`` keys the ledger lines, and a ``ctx`` dict keeps the compute
  setup across builds. With ``DOS_MESH_DEVICES`` above 1 each chunk is
  built across the worker's lanes (``parallel.sharded.build_fm_lanes``;
  the same bytes). No device-side RLE fetch. On the card every stage
  runs through the hand build kernels (``ops.cuda_build_kernels``).
* delta rebuilds: :func:`delta_affected_targets` (the tense-edge pass,
  K1 on the transposed graph on the card), :func:`delta_build_worker_shard`
  and :func:`delta_build_index` (``make_cpds --delta-from``): an old
  index plus a fused diff epoch give an epoch index
  (:func:`epoch_index_dir`) byte-equal to a build from scratch on the
  retimed graph, clean blocks byte-copied, dirty rows recomputed and
  spliced; ``worker.engine.ShardEngine.promote_index`` serves it.
* :func:`write_index_manifest` / :func:`read_manifest` /
  :func:`validate_manifest` / :func:`check_manifest_version` /
  :func:`check_block` / :func:`load_verified_block` — the ``index.json``
  manifest (schema v2, per-block digests; ``replica_files`` at R > 1)
  and digest-checked block loads. File names, digests, the manifest
  schema and the compressed containers are the JAX package's, so an
  index built by either package loads under the other.
* verify, heal and replicas: :func:`verify_index` /
  :func:`verify_exit_code` (``make_cpds --verify``), :func:`heal_block`
  (quarantine, copy or rebuild on the device, reload; both load paths
  heal through it), :func:`copy_replica_blocks` /
  :func:`build_replica_shards` (replica sets: copied from digest-valid
  primaries, else recomputed), :func:`anti_entropy` (replica digests
  against their primary's) and :func:`adopt_shard_blocks` (an adopter's
  catch-up); each event adds to :data:`COUNTERS`.
* :class:`CPDOracle` — every worker's rows as one ``[W, R, N]`` tensor on
  one device, or spread over a ``[D, W]`` device grid (``mesh=``) and
  over the processes of a multi-controller run: ``build`` (any method;
  ``store_dists=True`` keeps the distances), ``save``, ``load``,
  ``route`` queries to the worker owning their target, and answer a
  round of them in one walk a device
  (``parallel.sharded``). The walk's pair table is built once per weight
  set. The serving methods: ``query_multi`` (D diffs in one fused walk),
  ``query_mat`` (one source to K targets, joined on the device),
  ``query_dist`` (free-flow distances by one gather), and
  ``prepare_weights(_multi)`` with ``query_table(_multi)`` (pointer-
  doubling tables that answer any query by one gather).
"""

from __future__ import annotations

import glob
import hashlib
import io
import json
import os
import queue
import re
import threading
import time
from collections import OrderedDict

import numpy as np
import torch

from ..data.graph import Graph
from ..ops import cuda_build_kernels as cbk
from ..ops.device_graph import TINF, DeviceGraph
from ..ops.ell_split import ell_split_graph, split_ratio
from ..ops.frontier_relax import frontier_graph, locality_fraction
from ..ops.grid_sweep import GridGraph
from ..ops.shift_relax import ShiftGraph, split_coverage
from ..ops.pointer_doubling import plen_dtype, record_order
from ..ops.table_search import walk_eid_pairs, walk_pairs
from ..parallel.partition import DistributionController
from ..parallel.mesh import local_devices, make_worker_mesh
from ..parallel.multihost import gather_to_host, is_primary, process_info
from ..parallel.sharded import (
    build_fm_lanes, build_fm_sharded, build_tables_multi_sharded,
    build_tables_sharded, chunk_compute, gather_cells, grid_parts,
    pad_targets, query_dist_sharded, query_mat_sharded, query_multi_sharded,
    query_paths_sharded, query_sharded, query_tables_multi_sharded,
    query_tables_sharded, scatter_cells,
)
from ..utils.atomicio import (
    SWEEP_MIN_AGE_S, TMP_SUFFIX, AtomicNpyWriter, atomic_copy_file,
    atomic_save_npy, atomic_write_json, digest_bytes, digest_file,
    quarantine,
)
from ..utils.device import resolve_device
from ..utils.env import env_cast, env_flag
from ..utils.log import get_logger
from .resident import (
    block_codec, encode_block, is_container, maybe_decode_rows,
    resident_choice,
)

log = get_logger(__name__)

#: manifest schema version. v2 adds per-block content digests + shapes
#: (``blocks``) and ``digest_algo``; readers tolerate unknown keys, so a
#: bump is MAJOR only when existing keys change meaning — v1 indexes
#: load under v2 code, v(N+1) indexes are rejected by vN code.
INDEX_VERSION = 2

#: index and build counters, under the JAX package's metric names: every
#: verify, corruption, rebuild, resume, replica divergence, replica copy
#: and adopted block in the index data plane adds to one, and so do the
#: build pipeline and the delta rebuilds. The ``*_seconds`` keys are
#: running sums (the JAX package keeps histograms of the stall and stage
#: times; ``build_compute_seconds`` and ``build_flush_seconds`` are the
#: port's own). ``worker.build --metrics-dump`` writes them beside the
#: kernel launches
COUNTERS = dict.fromkeys((
    "cpd_blocks_verified_total",         # blocks that passed verification
    "cpd_blocks_corrupt_total",          # missing/torn/digest-mismatched
    "cpd_blocks_rebuilt_total",          # corrupt blocks rebuilt in place
    "build_blocks_resumed_total",        # blocks a resumed build skipped
    "replica_digest_mismatches_total",   # replicas diverged from primary
    "replica_blocks_copied_total",       # replicas copied from a primary
    "reshard_blocks_adopted_total",      # blocks an adopter verified
    "build_rows_staged_total",           # rows the block stager prepared
    "build_delta_rows_recomputed_total",  # rows a delta recomputed
    "build_delta_skipped_blocks_total",  # blocks a delta byte-copied
    "build_pipeline_stall_seconds",      # build loop waiting on the stager
                                         # or for a free flush buffer
    "build_stage_overlap_seconds",       # staging a block's inputs
    "build_compute_seconds",             # build loop: a block's kernels
                                         # and the copy-out queued
    "build_flush_seconds",               # encode, write, fsync, ledger
), 0)


def shard_block_name(wid: int, bid: int, replica: int = 0) -> str:
    """Block file name. ``replica=0`` (the primary copy) keeps the plain
    name; replica rank r's copy — the same rows, hosted by worker
    ``(wid + r) % W`` — is a separate block set ``cpd-w<wid>-r<r>-b<bid>``
    so primaries and replicas verify and heal independently."""
    if replica:
        return f"cpd-w{wid:05d}-r{replica:02d}-b{bid:05d}.npy"
    return f"cpd-w{wid:05d}-b{bid:05d}.npy"


def block_file_replica(fname: str) -> int:
    """Replica rank encoded in a block file name (0 for primaries)."""
    parts = fname.split("-")
    if len(parts) >= 4 and parts[2].startswith("r"):
        return int(parts[2][1:])
    return 0


def ledger_path(outdir: str, wid: int, replica: int = 0) -> str:
    if replica:
        return os.path.join(outdir,
                            f"build-w{wid:05d}-r{replica:02d}.ledger")
    return os.path.join(outdir, f"build-w{wid:05d}.ledger")


class BuildLedger:
    """Per-worker build journal: one JSON line per completed,
    digest-valid block.

    A block counts as done only when its line is in the journal AND the
    file on disk still matches the recorded digest. Appends are
    flushed+fsynced per line; a torn trailing line (crash mid-append)
    is skipped on read. Later entries for the same file win."""

    def __init__(self, outdir: str, wid: int, replica: int = 0):
        self.path = ledger_path(outdir, wid, replica)

    def entries(self) -> dict[str, dict]:
        out: dict[str, dict] = {}
        try:
            with open(self.path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        ent = json.loads(line)
                    except ValueError:
                        continue          # torn trailing append
                    if isinstance(ent, dict) and "file" in ent:
                        out[ent["file"]] = ent
        except OSError:
            pass
        return out

    def record(self, fname: str, digest: str, shape, dtype: str,
               epoch: int | None = None,
               codec: str | None = None) -> None:
        """Journal one completed block. ``epoch`` keys the line to a
        diff-epoch build (delta rebuilds and their full-build degrade): a
        resume of an epoch-keyed build treats lines of any other epoch as
        invalid (:func:`_block_done`). ``codec`` records a compressed
        block's encoding so the manifest harvest can carry it. Each key
        is written only when given, so plain raw builds keep their ledger
        lines unchanged."""
        ent = {"file": fname, "digest": digest,
               "shape": list(shape), "dtype": dtype}
        if epoch is not None:
            ent["epoch"] = int(epoch)
        if codec is not None:
            ent["codec"] = str(codec)
        line = json.dumps(ent)
        with open(self.path, "a") as f:
            f.write(line + "\n")
            f.flush()
            os.fsync(f.fileno())


def block_complete(outdir: str, fname: str,
                   ledger_entries: dict[str, dict]) -> bool:
    """Is an on-disk block safe to skip on resume? Ledgered blocks must
    match their recorded digest; un-ledgered blocks must at least parse
    as a ``.npy``."""
    path = os.path.join(outdir, fname)
    if not os.path.exists(path):
        return False
    ent = ledger_entries.get(fname)
    if ent is not None:
        return digest_file(path) == ent.get("digest")
    try:
        np.load(path, mmap_mode="r")
        return True
    except Exception as e:  # noqa: BLE001 — any unreadable file means
        # rebuild, as in the JAX package
        log.debug("unledgered block %s unreadable (%s); rebuilding",
                  fname, e)
        return False


def _block_done(outdir: str, fname: str, entries: dict[str, dict],
                epoch: int | None) -> bool:
    """The resume check with epoch-keyed invalidation: a plain build
    (``epoch=None``) keeps :func:`block_complete`'s rules; an epoch-keyed
    build skips a block only when a ledger line of THAT epoch records it
    with the digest on disk — a parseable block of another weight regime
    is never adopted into the new index."""
    if epoch is None:
        return block_complete(outdir, fname, entries)
    ent = entries.get(fname)
    if ent is None or ent.get("epoch") != int(epoch):
        return False
    try:
        return digest_file(os.path.join(outdir, fname)) == ent.get("digest")
    except OSError:
        return False


def length_estimate(graph: Graph, s: np.ndarray, t: np.ndarray):
    """Cheap host-side walk-length predictor: L1 coordinate distance.
    Used only to ORDER queries so similar lengths sit together — never
    affects answers."""
    xs, ys = graph.xs, graph.ys
    return np.abs(xs[s] - xs[t]) + np.abs(ys[s] - ys[t])


# ------------------------------------------------------- build policy

#: shift coverage below which auto falls back to the ELL gather relaxation
SHIFT_COVERAGE_MIN = 0.9

#: lattice-edge share below which auto will not pick the fast-sweeping
#: build (shift planes keep sweep correct on any graph, but only lattice
#: edges benefit from the quadrant scans)
SWEEP_COVERAGE_MIN = 0.75

#: below this node count auto keeps the per-hop shift relaxation over
#: the sweep (the JAX package's crossover: the port keeps every gate of
#: the policy, so both packages pick the same kind on the same graph)
SWEEP_MIN_NODES = 32_768

#: modeled ELL+COO split cost ratio below which auto prefers the split
#: over the plain padded-ELL gather (degree-skewed graphs: road networks
#: pad K to the max degree while the mean is ~4)
ELLSPLIT_RATIO_MAX = 0.75

#: below this node count the dense kernels' full sweeps are cheap enough
#: that the frontier queue's per-pop overhead does not pay
FRONTIER_MIN_NODES = 32_768

#: minimum edge id-locality (ops.frontier_relax.locality_fraction) for
#: the delta-stepping frontier build: under it the union wavefront of a
#: clustered target batch degenerates to the whole graph (measured 0.4-
#: 0.6 after RCM/BFS reorder vs 0.02 on shuffled ids)
FRONTIER_LOCALITY_MIN = 0.25


def pick_build_kernel(graph: Graph, method: str = "auto"):
    """Resolve the build-method knob to ``(kind, structure)``.

    ``kind`` ∈ {"sweep", "shift", "frontier", "ellsplit", "ell"};
    ``structure`` is the matching host-side bundle (GridGraph /
    ShiftGraph / FrontierGraph / ELLSplitGraph / None). The coverage
    decisions happen on host-side split arrays — graphs that fall back
    never pay a device transfer.

    ``auto`` picks the fast-sweeping build for large grid-structured
    graphs (O(cycles) not O(hop-diameter) — the only build that scales to
    the 100k+-node regime), the shift relaxation for smaller or
    non-lattice-but-banded graphs, the delta-stepping frontier queue for
    large locality-ordered irregular graphs (road networks after
    BFS/RCM reorder — the only irregular build whose work tracks the
    frontier instead of N x diameter), the ELL+COO split for the
    remaining degree-skewed irregular graphs, and the padded-ELL gather
    otherwise.
    """
    if method not in ("auto", "ell", "ellsplit", "frontier", "shift",
                      "sweep"):
        raise ValueError(f"unknown build method {method!r}")
    if method == "ell":
        return "ell", None
    if method == "frontier":
        return "frontier", frontier_graph(graph)
    if method == "ellsplit":
        _, k0 = split_ratio(np.diff(graph.out_ptr), graph.max_out_degree)
        return "ellsplit", ell_split_graph(graph, k0=k0)
    if method in ("auto", "sweep"):
        split = graph.grid_split()
        if split is not None:
            if method == "sweep":
                return "sweep", GridGraph(*split)
            # lattice share from the HOST arrays (no device transfer for
            # graphs the gate rejects): what the quadrant scans serve
            _, _, wl, wr, wd, wu, _, w_shift, src_left, _, _ = split
            on_grid = sum(int((np.asarray(a) < TINF).sum())
                          for a in (wl, wr, wd, wu))
            total = (on_grid + int((np.asarray(w_shift) < TINF).sum())
                     + len(src_left))
            if (total and on_grid / total >= SWEEP_COVERAGE_MIN
                    and graph.n >= SWEEP_MIN_NODES):
                return "sweep", GridGraph(*split)
        elif method == "sweep":
            raise ValueError("method='sweep' but no grid layout fits "
                             "(Graph.grid_split returned None)")
    shifts, w_shift, nbr_left, w_left = graph.shift_split()
    if method == "auto" and split_coverage(w_shift,
                                           w_left) < SHIFT_COVERAGE_MIN:
        # irregular graph: the frontier queue when ids have locality
        # (post-reorder road networks — its work tracks the wavefront,
        # not N x diameter), else split the padded ELL when the degree
        # skew makes it worthwhile (cost model in ops.ell_split)
        if (graph.n >= FRONTIER_MIN_NODES
                and locality_fraction(graph) >= FRONTIER_LOCALITY_MIN):
            return "frontier", frontier_graph(graph)
        ratio, k0 = split_ratio(np.diff(graph.out_ptr),
                                graph.max_out_degree)
        if ratio <= ELLSPLIT_RATIO_MAX:
            return "ellsplit", ell_split_graph(graph, k0=k0)
        return "ell", None
    return "shift", ShiftGraph(shifts, w_shift, nbr_left, w_left, graph.n)


# ------------------------------------------------------- build pipeline

def build_pipeline_enabled() -> bool:
    """``DOS_BUILD_PIPELINE`` (default on): :func:`build_worker_shard`
    runs its blocks through the pipeline — a stager thread ahead of the
    build loop, a flush thread behind it. Off = the serial loop; both
    write the same bytes and ledger lines."""
    return env_flag("DOS_BUILD_PIPELINE", True)


def build_stage_depth() -> int:
    """``DOS_BUILD_STAGE_DEPTH`` (default 2, at least 1): blocks the
    stager keeps prepared ahead of the build loop, and blocks the flush
    thread may hold behind it (the host buffers of that many blocks)."""
    return max(env_cast("DOS_BUILD_STAGE_DEPTH", 2, int), 1)


def build_chunk_rows(graph: Graph, chunk: int, n_owned: int,
                     kind: str = "ell") -> int:
    """Rows per build call. An explicit ``chunk`` wins; with ``chunk=0``
    and ``DOS_BUILD_HBM_MB`` set, the chunk is sized to that device
    memory budget from the JAX package's per-row working-set estimate
    (the padded gather's ``[N, K + 2]`` int32 for ``ell``/``ellsplit``,
    three int32 planes otherwise), floored to a power of two — the JAX
    package's chunk on the same graph; unset keeps the whole shard in
    one batch."""
    if chunk > 0:
        return chunk
    budget_mb = env_cast("DOS_BUILD_HBM_MB", 0.0, float)
    if budget_mb <= 0:
        return max(n_owned, 1)
    k = max(graph.max_out_degree, 1)
    per_row = graph.n * ((k + 2) * 4 if kind in ("ell", "ellsplit")
                         else 12)
    rows = int(budget_mb * 1e6) // max(per_row, 1)
    rows = max(min(rows, max(n_owned, 1)), 1)
    return 1 << (int(rows).bit_length() - 1)


def _compute_ctx(ctx: dict | None, graph: Graph, method: str,
                 max_iters: int, dev: torch.device) -> dict:
    """The build's per-graph compute setup, kept in ``ctx`` so that a
    repeat build (a resident rebuild, a timed repeat, every shard of one
    delta) launches kernels without redoing any of it: the resolved
    ``(kind, structure)`` under ``kernel``, the ``DeviceGraph`` upload
    under ``dg``, the worker's lane list under ``mesh``
    (``parallel.mesh.make_worker_mesh`` over ``dev``'s devices:
    ``DOS_MESH_DEVICES``; None at one lane) and the build closure under
    ``compute``. Another graph or device clears it; another ``method``
    re-picks the kind and another ``max_iters`` makes a new closure.

    ``compute(targets, out=None, dist_out=None)`` is
    ``parallel.sharded.chunk_compute``'s closure, except that with lanes
    a target batch the lane count divides is built across them
    (``parallel.sharded.build_fm_lanes``, one closure and graph copy a
    distinct lane device) — the same rows, byte for byte. Other batches
    (and any asking for distances) build on ``dev``."""
    ctx = {} if ctx is None else ctx
    if ctx.get("graph") is not graph or ctx.get("device") != dev:
        ctx.clear()
        ctx.update(graph=graph, device=dev,
                   dg=DeviceGraph.from_graph(graph, device=dev),
                   mesh=make_worker_mesh(devices=local_devices(dev)))
    if ctx.get("method") != method:
        ctx.update(method=method, kernel=pick_build_kernel(graph, method))
        ctx.pop("compute", None)
    if "compute" not in ctx or ctx.get("max_iters") != max_iters:
        single = chunk_compute(ctx["dg"], ctx["kernel"], max_iters)
        mesh = ctx["mesh"]
        if mesh is None:
            compute = single
        else:
            kind, structure = ctx["kernel"]
            computes = {dev: single}

            def compute(t, out=None, dist_out=None):
                if dist_out is not None or len(t) % len(mesh):
                    return single(t, out=out, dist_out=dist_out)
                return build_fm_lanes(ctx["dg"], t, mesh, kind, structure,
                                      max_iters=max_iters, out=out,
                                      computes=computes)
        ctx.update(max_iters=max_iters, compute=compute)
    return ctx


class _BackgroundStager:
    """Bounded-depth staging thread of the pipelined build: prepares the
    next blocks' inputs (padded targets uploaded to the device, the
    pre-opened atomic block writer) while the build loop computes the
    current one. Iterating yields the staged items in block order; the
    wait for one adds to ``build_pipeline_stall_seconds``. An exception
    of the stager is re-raised in the consuming loop. ``close()`` stops
    the thread and aborts every staged writer the loop never took, so an
    error leaves no temp file behind."""

    def __init__(self, bids, stage_fn, depth: int, wid: int):
        self._q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, args=(list(bids), stage_fn),
            name=f"dos-build-stager-w{wid}", daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Stop-aware bounded put; False when close() raced it."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _run(self, bids, stage_fn) -> None:
        try:
            for bid in bids:
                if self._stop.is_set():
                    return
                item = stage_fn(bid)
                if not self._put(("item", item)):
                    item[-1].abort()      # the writer never reaches the loop
                    return
        except BaseException as e:  # noqa: BLE001 — carried to the
            # consuming build loop, which re-raises it
            self._put(("err", e))
            return
        self._put(("done", None))

    def __iter__(self):
        while True:
            t0 = time.perf_counter()
            kind, val = self._q.get()
            COUNTERS["build_pipeline_stall_seconds"] += (
                time.perf_counter() - t0)
            if kind == "done":
                return
            if kind == "err":
                raise val
            yield val

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=10)
        while True:
            try:
                kind, val = self._q.get_nowait()
            except queue.Empty:
                break
            if kind == "item":
                val[-1].abort()


class _BlockFlusher:
    """The flush side of the pipelined build: ONE thread that lands the
    computed blocks in block order — wait for the block's device-to-host
    copy (the event recorded after it), encode, atomic write with fsync,
    ledger line — while the build loop drives the next block's kernels.

    The host rows come from a pool of ``depth`` block buffers (pinned
    on the card, so the copy queued after a block's extraction runs
    asynchronously and precedes the next block's kernels in stream
    order): at most ``depth`` blocks wait to be flushed, and the loop's
    wait for a free buffer adds to ``build_pipeline_stall_seconds``. A
    flush error is kept and re-raised in the build loop (:meth:`check`,
    :meth:`acquire`, :meth:`submit`, :meth:`finish`); the failed block's
    writer and every writer queued behind it are aborted, so no temp file
    is left. ``threaded=False`` lands each block inline (the serial
    loop)."""

    def __init__(self, flush_fn, shape, pin: bool, depth: int,
                 threaded: bool, wid: int):
        self._flush_fn = flush_fn
        self._shape = shape
        self._pin = pin
        self._depth = max(depth, 1)
        self._n_bufs = 0
        self._free: queue.Queue = queue.Queue()
        self._q: queue.Queue = queue.Queue()
        self._abort = False
        self.error: BaseException | None = None
        self._thread = None
        if threaded:
            self._thread = threading.Thread(
                target=self._run, name=f"dos-build-flush-w{wid}",
                daemon=True)
            self._thread.start()

    def check(self) -> None:
        if self.error is not None:
            raise self.error

    def acquire(self) -> torch.Tensor:
        """A free ``[block rows, N]`` int8 host buffer: allocated while
        fewer than ``depth`` exist, else the next one a flush returns."""
        try:
            return self._free.get_nowait()
        except queue.Empty:
            pass
        if self._n_bufs < self._depth:
            self._n_bufs += 1
            return torch.empty(self._shape, dtype=torch.int8,
                               pin_memory=self._pin)
        t0 = time.perf_counter()
        while True:
            self.check()
            try:
                buf = self._free.get(timeout=0.05)
                break
            except queue.Empty:
                continue
        COUNTERS["build_pipeline_stall_seconds"] += time.perf_counter() - t0
        return buf

    def submit(self, fname: str, rows: int, buf: torch.Tensor, event,
               writer) -> None:
        """Hand block ``fname`` (its first ``rows`` rows of ``buf``, ready
        once ``event`` completes) and its pre-opened writer over."""
        item = (fname, rows, buf, event, writer)
        if self._thread is None:
            self._land(item)
            return
        self.check()
        self._q.put(item)

    def _land(self, item) -> None:
        fname, rows, buf, event, writer = item
        try:
            if event is not None:
                event.synchronize()
            t0 = time.perf_counter()
            self._flush_fn(fname, buf[:rows].numpy(), writer)
            COUNTERS["build_flush_seconds"] += time.perf_counter() - t0
        except BaseException:
            writer.abort()
            raise
        finally:
            self._free.put(buf)

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            if self.error is not None or self._abort:
                item[4].abort()
                self._free.put(item[2])
                continue
            try:
                self._land(item)
            except BaseException as e:  # noqa: BLE001 — re-raised in the
                # build loop by check()
                self.error = e

    def _join(self) -> None:
        if self._thread is not None:
            self._q.put(None)
            self._thread.join()
            self._thread = None

    def finish(self) -> None:
        """Wait until every submitted block has landed; re-raise a flush
        error."""
        self._join()
        self.check()

    def close(self) -> None:
        """Error path: abort every writer not yet landed and stop."""
        self._abort = True
        self._join()


def build_worker_shard(graph: Graph, dc: DistributionController, wid: int,
                       outdir: str, chunk: int = 0,
                       device=None, codec: str | None = None,
                       method: str = "auto",
                       max_iters: int = 0, resume: bool = True,
                       replica: int = 0, epoch: int | None = None,
                       ctx: dict | None = None) -> list[str]:
    """Build and persist ONE worker's CPD block files on one device.

    The owned targets run through the build kind ``method`` resolves to
    (:func:`pick_build_kernel`; ``auto`` by the graph's structure) in
    ``chunk``-row batches (0 = :func:`build_chunk_rows`: the whole shard
    in one batch unless ``DOS_BUILD_HBM_MB`` sizes it; the last batch is
    padded with ``-1`` targets to the fixed width; ``max_iters`` cuts the
    distance loop, 0 = converge) and each controller block
    (``dc.block_size`` rows) is written as ``cpd-w<wid>-b<bid>.npy``
    through an atomic write, journaled with its digest in the build
    ledger. ``resume=True`` skips blocks the ledger records as complete
    with a matching on-disk digest (un-ledgered blocks if they parse);
    ``resume=False`` recomputes every block. ``replica=r`` builds shard
    ``wid``'s rank-r replica block set (the same rows under
    ``cpd-w<wid>-r<rr>-b<bid>.npy``, its own ledger): the kernels are
    deterministic, so a recomputed replica is bit-identical to the
    primary. ``device``: None → ``cuda`` (raises without a GPU unless
    ``device="cpu"``). ``codec`` (``raw``/``pack4``/``rle``/``auto``;
    None → ``DOS_CPD_RESIDENT``) writes each block as a compressed
    container (``encode_block``); a block whose rows the codec cannot
    take is written raw. Returns the file names written, in block order.

    With more than one block missing and ``DOS_BUILD_PIPELINE`` on (the
    default) the loop is a pipeline: a stager thread prepares the next
    blocks' padded targets on the device and pre-opens their writers
    (:class:`_BackgroundStager`, ``DOS_BUILD_STAGE_DEPTH`` ahead), the
    build loop drives a block's kernels and queues the copy of its rows
    into a host buffer right after its extraction, and one flush thread
    encodes, writes with fsync and journals the blocks in order while the
    loop runs the next (:class:`_BlockFlusher`). The loop reads a flag
    after every relax step, so a copy issued after the next block's
    launches would wait for them: the copy goes first, the flush runs
    beside. Blocks and ledger lines are the serial loop's, byte for byte.
    (The JAX package's ``DOS_BUILD_DONATE`` has no counterpart: a drained
    block's device rows are one buffer the next block overwrites.)

    ``epoch``: key the ledger lines to a diff epoch (delta rebuilds): a
    resume skips only blocks journaled under the SAME epoch with a
    matching digest (:func:`_block_done`). ``ctx``: a dict shared across
    calls that keeps the compute setup (:func:`_compute_ctx`), so a
    repeat build pays no graph upload, kind pick or CSR again.
    """
    dev = resolve_device(device)
    os.makedirs(outdir, exist_ok=True)
    # sweep THIS block set's atomic-write debris from a killed build (old
    # enough not to be a live write by a concurrent same-wid process)
    now = time.time()
    stem = shard_block_name(wid, 0, replica)[:-len("00000.npy")]
    for p in glob.glob(os.path.join(outdir, f"{stem}*{TMP_SUFFIX}.*")):
        try:
            if now - os.path.getmtime(p) >= SWEEP_MIN_AGE_S:
                os.remove(p)
        except OSError:
            pass
    owned = dc.owned(wid)
    bs = dc.block_size
    n_blocks = (len(owned) + bs - 1) // bs
    ledger = BuildLedger(outdir, wid, replica)
    entries = ledger.entries() if resume else {}
    missing = [bid for bid in range(n_blocks)
               if not (resume and _block_done(
                   outdir, shard_block_name(wid, bid, replica), entries,
                   epoch))]
    resumed = n_blocks - len(missing)
    if resumed:
        COUNTERS["build_blocks_resumed_total"] += resumed
        log.info("worker %d build resume: %d/%d block(s) already "
                 "complete and digest-valid", wid, resumed, n_blocks)
    if not missing:
        return []
    ctx = _compute_ctx(ctx, graph, method, max_iters, dev)
    kind = ctx["kernel"][0]
    log.info("worker %d build kind: %s (method %s)", wid, kind, method)
    compute = ctx["compute"]
    chunk = build_chunk_rows(graph, chunk, len(owned), kind=kind)
    if ctx["mesh"] is not None and chunk % len(ctx["mesh"]):
        log.warning("worker %d: chunk %d does not divide over %d mesh "
                    "lane(s); building single-device", wid, chunk,
                    len(ctx["mesh"]))
    codec_req = resident_choice() if codec is None else codec

    def stage(bid: int):
        """One block's inputs: its padded targets on the device and its
        pre-opened writer."""
        t0 = time.perf_counter()
        blk = owned[bid * bs: min((bid + 1) * bs, len(owned))]
        pads = []
        for i in range(0, len(blk), chunk):
            part = blk[i:i + chunk]
            pad = np.full(chunk, -1, np.int32)   # fixed batch width
            pad[:len(part)] = part
            pads.append((torch.from_numpy(pad).to(dev), len(part)))
        fname = shard_block_name(wid, bid, replica)
        writer = AtomicNpyWriter(os.path.join(outdir, fname))
        COUNTERS["build_rows_staged_total"] += len(blk)
        COUNTERS["build_stage_overlap_seconds"] += time.perf_counter() - t0
        return bid, fname, pads, writer

    def flush(fname: str, arr: np.ndarray, writer) -> None:
        # the container goes through the same atomic writer: digest and
        # ledger cover the container bytes
        enc = encode_block(arr, codec_req)
        arr, blk_codec = enc if enc is not None else (arr, None)
        digest = writer.commit(arr)
        # a kill between the commit and the ledger line leaves a complete
        # un-journaled file, which the resume check accepts if it parses
        ledger.record(fname, digest, arr.shape, str(arr.dtype),
                      epoch=epoch, codec=blk_codec)

    pipelined = build_pipeline_enabled() and len(missing) > 1
    depth = build_stage_depth()
    rows_max = min(bs, len(owned))
    on_card = dev.type == "cuda"
    flusher = _BlockFlusher(flush, (rows_max, graph.n), pin=on_card,
                            depth=depth if pipelined else 1,
                            threaded=pipelined, wid=wid)
    # on the card a block's rows land in one device buffer, reused: the
    # copy out of it precedes the next block's kernels in stream order
    dev_rows = (torch.empty((rows_max, graph.n), dtype=torch.int8,
                            device=dev) if on_card else None)
    stager = (_BackgroundStager(missing, stage, depth, wid)
              if pipelined else None)
    staged = iter(stager) if stager is not None \
        else (stage(bid) for bid in missing)
    written: list[str] = []
    landed = False
    try:
        for _bid, fname, pads, writer in staged:
            try:
                t0 = time.perf_counter()
                rows = sum(n for _, n in pads)
                buf = None if on_card else flusher.acquire()
                dst = dev_rows if on_card else buf
                off = 0
                for pad, n in pads:
                    compute(pad, out=dst[off:off + n])
                    off += n
                event = None
                COUNTERS["build_compute_seconds"] += (
                    time.perf_counter() - t0)
                if on_card:
                    buf = flusher.acquire()
                    buf[:rows].copy_(dev_rows[:rows], non_blocking=True)
                    event = torch.cuda.Event()
                    event.record()
                flusher.submit(fname, rows, buf, event, writer)
            except BaseException:
                writer.abort()        # never handed to the flusher
                raise
            written.append(fname)
        flusher.finish()
        landed = True
    finally:
        if not landed:
            flusher.close()
        if stager is not None:
            stager.close()
    return written


# --------------------------------------------------------- delta builds

def epoch_index_dir(outdir: str, epoch: int) -> str:
    """Where a delta rebuild for diff epoch ``epoch`` lands: a subdir of
    the base index, so promotion finds every epoch's index from the one
    path it knows."""
    return os.path.join(outdir, f"epoch-e{int(epoch):06d}")


def diff_epoch_of(difffile: str) -> int | None:
    """The diff epoch a fused-diff file name carries
    (``fused-e<epoch>.diff``); None for names without one."""
    m = re.search(r"-e(\d+)\.diff$", os.path.basename(difffile or ""))
    return int(m.group(1)) if m else None


def delta_affected_targets(graph: Graph, changed_eids: np.ndarray,
                           w_old: np.ndarray, w_new: np.ndarray,
                           max_seeds: int | None = None,
                           seed_chunk: int = 512,
                           device=None) -> np.ndarray | None:
    """Target rows whose first-move entries CAN change when the named
    edges change weight — the delta build's dirty set (the JAX package's
    tense-edge pass).

    ``d_old(e → t)`` for every changed edge endpoint ``e`` comes from one
    relaxation on the TRANSPOSED graph under the old weights (B =
    endpoints, not N): K1's loop over the transposed edge list's CSR
    (``cuda_build_kernels.csr_from_edges(dst, src, w_old)`` +
    ``jacobi_dist``; on the CPU its plain relax step). Target ``t`` is dirty
    iff some changed edge ``(u, v)`` has ``d_old(v→t) < INF`` and
    ``min(w_old, w_new)(u,v) + d_old(v→t) <= d_old(u→t)`` (int64; ``<=``
    keeps argmin ties dirty, which makes a spliced delta byte-equal to a
    build from scratch). The endpoints go in chunks of ``seed_chunk //
    2`` edges, each padded to the power of two of its endpoint count
    (capped at ``seed_chunk``); the test and its ``any`` over the chunk's
    edges run on the device, and only the ``[N]`` dirty mask comes back.

    Returns the sorted dirty target ids, or None when the changed edges'
    endpoints exceed ``max_seeds`` (``DOS_BUILD_DELTA_MAX_SEEDS``, default
    4,096; <= 0 = unbounded): the caller then rebuilds in full.
    ``device``: None → ``cuda`` (raises without a GPU unless ``"cpu"``).
    """
    dev = resolve_device(device)
    changed_eids = np.asarray(changed_eids, np.int64)
    if len(changed_eids) == 0:
        return np.zeros(0, np.int64)
    ends_all = np.unique(np.concatenate(
        [graph.src[changed_eids], graph.dst[changed_eids]]))
    if max_seeds is None:
        max_seeds = env_cast("DOS_BUILD_DELTA_MAX_SEEDS", 4096, int)
    if max_seeds > 0 and len(ends_all) > max_seeds:
        log.info("delta pass: %d changed-edge endpoints exceed the "
                 "DOS_BUILD_DELTA_MAX_SEEDS=%d bound; degrading to a "
                 "full rebuild", len(ends_all), max_seeds)
        return None
    # d_T(x -> e) on the transposed graph = d_old(e -> x): [N, B]
    csr_t = cbk.csr_from_edges(graph.dst, graph.src, w_old, graph.n, dev)
    minw_all = np.minimum(np.asarray(w_old, np.int64)[changed_eids],
                          np.asarray(w_new, np.int64)[changed_eids])
    dirty = torch.zeros(graph.n, dtype=torch.bool, device=dev)
    per = max(seed_chunk // 2, 1)
    for i in range(0, len(changed_eids), per):
        eids = changed_eids[i:i + per]
        eu, ev = graph.src[eids], graph.dst[eids]
        ends = np.unique(np.concatenate([eu, ev]))
        csize = min(seed_chunk, 1 << (max(len(ends), 1) - 1).bit_length())
        pad = np.full(csize, -1, np.int32)
        pad[:len(ends)] = ends
        d = cbk.jacobi_dist(csr_t, torch.from_numpy(pad).to(dev))[0]
        iu = torch.from_numpy(np.searchsorted(ends, eu)).to(dev)
        iv = torch.from_numpy(np.searchsorted(ends, ev)).to(dev)
        du, dv = d[:, iu], d[:, iv].long()                    # [N, E]
        minw = torch.from_numpy(minw_all[i:i + per]).to(dev)
        tense = (dv < TINF) & (dv + minw <= du)
        dirty |= tense.any(dim=1)
    return torch.nonzero(dirty).squeeze(1).cpu().numpy().astype(np.int64)


def _compute_rows_batched(compute, tgts: np.ndarray, chunk_rows: int,
                          dev: torch.device) -> np.ndarray:
    """First-move rows of an arbitrary target list in ``chunk_rows``
    batches — the delta paths' recompute. The final partial batch pads to
    its own power of two (capped at the chunk), so a handful of dirty
    rows never pays a whole chunk's solve."""
    parts = []
    for i in range(0, len(tgts), chunk_rows):
        part = tgts[i:i + chunk_rows]
        csize = min(chunk_rows, 1 << (max(len(part), 1) - 1).bit_length())
        pad = np.full(csize, -1, np.int32)
        pad[:len(part)] = part
        fm = compute(torch.from_numpy(pad).to(dev))
        parts.append(fm[:len(part)].cpu().numpy())
    return parts[0] if len(parts) == 1 else np.concatenate(parts)


def _delta_single_block(graph_new: Graph, blk: np.ndarray, chunk: int,
                        n_owned: int, method: str, max_iters: int,
                        compute_ctx: dict | None,
                        dev: torch.device) -> np.ndarray:
    """Recompute one whole block outside the shard-wide batch: the rare
    fallback when a copy or an old block fails between the passes."""
    ctx = _compute_ctx(compute_ctx, graph_new, method, max_iters, dev)
    chunk_rows = build_chunk_rows(graph_new, chunk, n_owned,
                                  kind=ctx["kernel"][0])
    return _compute_rows_batched(ctx["compute"], blk, chunk_rows, dev)


def delta_build_worker_shard(graph_new: Graph, dc: DistributionController,
                             wid: int, old_outdir: str, outdir: str,
                             dirty: np.ndarray | None,
                             old_blocks_meta: dict | None = None,
                             chunk: int = 0, max_iters: int = 0,
                             resume: bool = True, method: str = "auto",
                             epoch: int = 0,
                             compute_ctx: dict | None = None,
                             device=None) -> dict:
    """One worker's shard of a DELTA rebuild on ``device`` (None →
    ``cuda``). Blocks with no dirty row are byte-copied from the old index
    (the copy's digest checked against the old manifest; no device work);
    dirty blocks recompute ONLY their dirty rows on the retimed graph and
    splice them into the old block's clean rows (a compressed old block
    decoded first; the block keeps the old block's codec). ``dirty`` is
    the ``[N]`` bool mask of :func:`delta_affected_targets`; None, or a
    dirty share of the shard above ``DOS_BUILD_DELTA_MAX_FRAC`` (default
    0.75), degrades the shard to a full pipelined build that keeps the
    old index's codec.

    Two passes: the first classifies every block (resumed, copied or
    recomputed) and gathers the recomputed blocks' dirty targets, which
    are then solved in shard-wide chunk batches; the second lands the
    blocks in block order, each through an atomic write and an
    epoch-keyed ledger line, so an interrupted delta resumes block by
    block and a journal of another epoch never satisfies the resume.
    Returns ``{"blocks", "rows_recomputed", "blocks_skipped",
    "blocks_resumed", "degraded_full"}``."""
    dev = resolve_device(device)
    os.makedirs(outdir, exist_ok=True)
    owned = dc.owned(wid)
    bs = dc.block_size
    n_blocks = (len(owned) + bs - 1) // bs
    report = {"blocks": n_blocks, "rows_recomputed": 0,
              "blocks_skipped": 0, "blocks_resumed": 0,
              "degraded_full": False}
    dirty_owned = (np.ones(len(owned), bool) if dirty is None
                   else np.asarray(dirty, bool)[owned])
    max_frac = env_cast("DOS_BUILD_DELTA_MAX_FRAC", 0.75, float)
    if dirty is None or (len(owned) and dirty_owned.mean() > max_frac):
        # the degraded full build keeps the old index's codec (the first
        # one recorded: an index is built under one knob), so a
        # compressed index's delta chain stays compressed
        codec_hint = next(
            (m.get("codec") for m in (old_blocks_meta or {}).values()
             if isinstance(m, dict) and m.get("codec")), "raw")
        written = build_worker_shard(graph_new, dc, wid, outdir,
                                     chunk=chunk, device=dev,
                                     codec=codec_hint, method=method,
                                     max_iters=max_iters, resume=resume,
                                     epoch=epoch, ctx=compute_ctx)
        report["degraded_full"] = True
        report["rows_recomputed"] = int(min(len(written) * bs, len(owned)))
        COUNTERS["build_delta_rows_recomputed_total"] += (
            report["rows_recomputed"])
        return report
    ledger = BuildLedger(outdir, wid)
    entries = ledger.entries() if resume else {}
    old_blocks_meta = old_blocks_meta or {}

    # pass 1: classify every block and collect the recomputed blocks'
    # dirty targets (only the old block's verify status is kept: pass 2
    # re-reads each old block as it lands, one block of host memory)
    todo: list[tuple] = []        # (bid, fname, blk, bmask | None, old_ok)
    recompute_tgts: list[np.ndarray] = []
    for bid in range(n_blocks):
        fname = shard_block_name(wid, bid)
        if resume and _block_done(outdir, fname, entries, epoch):
            report["blocks_resumed"] += 1
            COUNTERS["build_blocks_resumed_total"] += 1
            continue
        lo, hi = bid * bs, min((bid + 1) * bs, len(owned))
        blk = owned[lo:hi]
        bmask = dirty_owned[lo:hi].copy()
        if not bmask.any():
            todo.append((bid, fname, blk, None, False))   # byte copy
            continue
        status, reason = check_block(os.path.join(old_outdir, fname),
                                     old_blocks_meta.get(fname))
        old_ok = status in ("ok", "unverified")
        if not old_ok:
            if status != "missing":
                log.warning("delta rebuild of %s: old block is %s (%s); "
                            "recomputing every row", fname, status, reason)
            bmask[:] = True          # no clean base to splice into
        todo.append((bid, fname, blk, bmask, old_ok))
        recompute_tgts.append(blk[bmask])

    rows_new = None
    if recompute_tgts:
        compute_ctx = _compute_ctx(compute_ctx, graph_new, method,
                                   max_iters, dev)
        chunk_rows = build_chunk_rows(graph_new, chunk, len(owned),
                                      kind=compute_ctx["kernel"][0])
        rows_new = _compute_rows_batched(
            compute_ctx["compute"], np.concatenate(recompute_tgts),
            chunk_rows, dev)

    # pass 2: land the blocks in block order
    off = 0
    for _bid, fname, blk, bmask, old_ok in todo:
        old_path = os.path.join(old_outdir, fname)
        old_meta = old_blocks_meta.get(fname)
        out_codec = (old_meta or {}).get("codec")
        if bmask is None:
            # clean block: a byte copy whose digest must be the old
            # manifest's; a missing or torn source recomputes instead
            try:
                digest = atomic_copy_file(old_path,
                                          os.path.join(outdir, fname))
            except OSError as e:
                log.warning("delta copy of %s failed (%s); recomputing",
                            fname, e)
                digest = None
            if digest is None or (old_meta and old_meta.get("digest")
                                  and digest != old_meta["digest"]):
                if digest is not None:
                    log.warning("delta copy of %s does not match the old "
                                "manifest digest (%s != %s); recomputing",
                                fname, digest, old_meta["digest"])
                arr = _delta_single_block(graph_new, blk, chunk,
                                          len(owned), method, max_iters,
                                          compute_ctx, dev)
                n_new = len(blk)
            else:
                arr = np.load(os.path.join(outdir, fname), mmap_mode="r")
                ledger.record(fname, digest, arr.shape, str(arr.dtype),
                              epoch=epoch, codec=out_codec)
                report["blocks_skipped"] += 1
                COUNTERS["build_delta_skipped_blocks_total"] += 1
                continue
        else:
            n_new = int(bmask.sum())
            fresh = rows_new[off:off + n_new]
            off += n_new
            if not old_ok:
                arr = fresh          # bmask was forced all-dirty
            else:
                rows_old, status, reason = load_verified_block(old_path,
                                                               old_meta)
                if rows_old is not None:
                    try:
                        rows_old = maybe_decode_rows(rows_old)
                    except ValueError as e:
                        rows_old, status, reason = (
                            None, "corrupt", f"undecodable: {e}")
                if rows_old is None:
                    # gone or torn between the passes: the batch covered
                    # only bmask, so the whole block recomputes
                    log.warning("delta splice of %s: old block became %s "
                                "between passes (%s); recomputing every "
                                "row", fname, status, reason)
                    arr = _delta_single_block(graph_new, blk, chunk,
                                              len(owned), method,
                                              max_iters, compute_ctx, dev)
                    n_new = len(blk)
                else:
                    arr = np.asarray(rows_old).copy()
                    arr[bmask] = fresh
        enc = encode_block(arr, out_codec)
        arr, out_codec = enc if enc is not None else (arr, None)
        digest = atomic_save_npy(os.path.join(outdir, fname), arr)
        ledger.record(fname, digest, arr.shape, str(arr.dtype),
                      epoch=epoch, codec=out_codec)
        report["rows_recomputed"] += n_new
        COUNTERS["build_delta_rows_recomputed_total"] += n_new
    return report


def delta_build_index(graph: Graph, dc: DistributionController,
                      old_outdir: str, difffile: str,
                      epoch: int | None = None,
                      out_root: str | None = None, chunk: int = 0,
                      max_iters: int = 0, method: str = "auto",
                      resume: bool = True, workers=None,
                      device=None) -> dict:
    """Delta rebuild on ``device`` (None → ``cuda``): an old index plus a
    fused diff epoch → a NEW epoch index (:func:`epoch_index_dir` under
    ``out_root``, default the old index) byte-equal to a build from
    scratch on the retimed graph, recomputing only the rows the changed
    edges can affect.

    The changed edges are ``w_new != w_old``, ``w_old`` from the old
    manifest's ``diff_file`` (absent = free flow), so deltas chain; an
    old diff that cannot be read degrades the delta to a full build. The
    epoch is ``epoch``, else the one the diff's name carries
    (:func:`diff_epoch_of`), else the old manifest's ``diff_epoch`` + 1.
    Every shard (``workers``: a subset, and then no manifest is written)
    goes through :func:`delta_build_worker_shard` with one shared compute
    context; replica sets copy from the new primaries; the manifest
    carries ``diff_epoch`` and ``diff_file``. Returns the JAX package's
    report: ``epoch``, ``outdir``, ``changed_edges``, ``affected_rows``,
    ``rows_recomputed``, ``blocks_skipped``, ``blocks_resumed``,
    ``degraded_full``, ``shards``."""
    dev = resolve_device(device)
    old_manifest = read_manifest(old_outdir)
    check_manifest_version(old_manifest, old_outdir)
    old_diff = old_manifest.get("diff_file", "-")
    try:
        w_old = graph.weights_with_diff(old_diff)
    except OSError as e:
        # the old index's fused diff is gone: the changed edges are
        # unknowable, so the delta degrades to a full build
        log.warning("old index %s records diff_file %s which is "
                    "unreadable (%s); delta degrades to a full rebuild",
                    old_outdir, old_diff, e)
        w_old = None
    w_new = graph.weights_with_diff(difffile)
    changed = (np.nonzero(w_new != w_old)[0] if w_old is not None
               else np.zeros(0, np.int64))
    if epoch is None:
        epoch = diff_epoch_of(difffile)
    if epoch is None:
        epoch = int(old_manifest.get("diff_epoch", 0)) + 1
    outdir = epoch_index_dir(out_root or old_outdir, int(epoch))
    graph_new = Graph(graph.xs, graph.ys, graph.src, graph.dst, w_new)
    if w_old is None:
        dirty = None                          # unknown delta: full
    elif len(changed) == 0:
        dirty = np.zeros(graph.n, bool)       # empty delta: copy all
    else:
        affected = delta_affected_targets(graph, changed, w_old, w_new,
                                          device=dev)
        if affected is None:
            dirty = None                      # degrade to full
        else:
            dirty = np.zeros(graph.n, bool)
            dirty[affected] = True
    report: dict = {
        "epoch": int(epoch), "outdir": outdir,
        "changed_edges": int(len(changed)),
        "affected_rows": (int(graph.n) if dirty is None
                          else int(dirty.sum())),
        "rows_recomputed": 0, "blocks_skipped": 0,
        "blocks_resumed": 0, "degraded_full": False, "shards": 0,
    }
    ctx: dict = {}
    for wid in (range(dc.maxworker) if workers is None else workers):
        rep = delta_build_worker_shard(
            graph_new, dc, wid, old_outdir, outdir, dirty,
            old_blocks_meta=old_manifest.get("blocks", {}),
            chunk=chunk, max_iters=max_iters, resume=resume,
            method=method, epoch=int(epoch), compute_ctx=ctx, device=dev)
        report["shards"] += 1
        for key in ("rows_recomputed", "blocks_skipped", "blocks_resumed"):
            report[key] += rep[key]
        report["degraded_full"] |= rep["degraded_full"]
    if workers is None and dc.replication > 1:
        # replica sets copy from the NEW primaries in the same dir
        for host in range(dc.maxworker):
            for r in range(1, dc.replication):
                copy_replica_blocks(dc, (host - r) % dc.maxworker, r,
                                    outdir, resume=resume)
    if workers is None:
        write_index_manifest(
            outdir, dc, rows_per_worker=old_manifest.get("rows_per_worker"),
            extra={"diff_epoch": int(epoch),
                   "diff_file": os.path.abspath(difffile)})
    log.info("delta build epoch %d: %d changed edge(s) -> %d/%d rows "
             "recomputed, %d block(s) copied%s -> %s", epoch,
             report["changed_edges"], report["rows_recomputed"], graph.n,
             report["blocks_skipped"],
             " (degraded to full)" if report["degraded_full"] else "",
             outdir)
    return report


# ------------------------------------------------------------- replicas

def _primary_codec(outdir: str, shard: int) -> str:
    """The codec shard ``shard``'s PRIMARY blocks were written with
    (ledger first, block sniff second, raw default) — what a replica
    recompute must use so its digest can ever match the primary's in
    the anti-entropy cross-check."""
    for ent in BuildLedger(outdir, shard).entries().values():
        if ent.get("codec"):
            return str(ent["codec"])
    try:
        arr = np.load(os.path.join(outdir, shard_block_name(shard, 0)),
                      mmap_mode="r")
        if is_container(arr):
            return str(block_codec(arr))
    except (OSError, ValueError) as e:
        log.debug("primary codec sniff for shard %d failed (%s); "
                  "assuming raw", shard, e)
    return "raw"


def copy_replica_blocks(dc: DistributionController, shard: int,
                        replica: int, outdir: str,
                        resume: bool = True) -> list[str]:
    """Materialize shard ``shard``'s rank-``replica`` block set by
    copying digest-valid PRIMARY blocks (the build and the primary share
    a filesystem; the kernels are deterministic, so the copy is exactly
    what a recompute would write). Blocks whose primary is missing or
    unreadable are skipped: the caller recomputes them with
    ``build_worker_shard(..., replica=r)``. Copies go through the same
    atomic write and ledger journal as built blocks, and a compressed
    primary copies as its container. Returns the names written."""
    os.makedirs(outdir, exist_ok=True)
    bs = dc.block_size
    n_blocks = (dc.n_owned(shard) + bs - 1) // bs
    ledger = BuildLedger(outdir, shard, replica)
    entries = ledger.entries() if resume else {}
    prim_ledger = BuildLedger(outdir, shard).entries()
    written = []
    for bid in range(n_blocks):
        fname = shard_block_name(shard, bid, replica)
        if resume and block_complete(outdir, fname, entries):
            continue
        prim = shard_block_name(shard, bid)
        prim_ent = prim_ledger.get(prim)
        rows, _status, _reason = _verify_block(
            os.path.join(outdir, prim),
            {"digest": prim_ent["digest"]} if prim_ent else None,
            want_rows=True)
        if rows is None:
            continue        # no healthy primary: the caller recomputes
        digest = atomic_save_npy(os.path.join(outdir, fname), rows)
        ledger.record(fname, digest, rows.shape, str(rows.dtype),
                      codec=(block_codec(rows) if is_container(rows)
                             else None))
        COUNTERS["replica_blocks_copied_total"] += 1
        written.append(fname)
    return written


def build_replica_shards(graph: Graph, dc: DistributionController,
                         host_wid: int, outdir: str, chunk: int = 0,
                         resume: bool = True, method: str = "auto",
                         device=None) -> dict[int, list[str]]:
    """Build every replica block set worker ``host_wid`` hosts (rank r
    of shard ``(host_wid - r) % W`` for r in 1..R-1): copy from
    digest-valid primaries first, recompute the rest on ``device`` with
    the primary's codec (a raw recompute of a compressed primary would
    never pass the anti-entropy cross-check). No-op at R = 1. Returns
    ``{shard: [files written]}``."""
    out: dict[int, list[str]] = {}
    for r in range(1, dc.replication):
        shard = (host_wid - r) % dc.maxworker
        copied = copy_replica_blocks(dc, shard, r, outdir, resume=resume)
        computed = build_worker_shard(graph, dc, shard, outdir,
                                      chunk=chunk, device=device,
                                      codec=_primary_codec(outdir, shard),
                                      method=method, replica=r)
        out[shard] = sorted(set(copied) | set(computed))
        if copied or computed:
            log.info("worker %d: replica r%d of shard %d ready "
                     "(%d copied, %d computed)", host_wid, r, shard,
                     len(copied), len(computed))
    return out


def _block_meta_for(outdir: str, fname: str,
                    ledgers: dict[tuple[int, int], dict]) -> dict:
    """Digest/shape/dtype (and a compressed block's codec) for one block
    file, cheapest source first: the block set's build ledger (keyed by
    ``(wid, replica)``), else read the file once."""
    wid = int(fname.split("-")[1][1:])
    key = (wid, block_file_replica(fname))
    if key not in ledgers:
        ledgers[key] = BuildLedger(outdir, *key).entries()
    ent = ledgers[key].get(fname)
    if ent is not None and "digest" in ent:
        meta = {"digest": ent["digest"], "shape": list(ent["shape"]),
                "dtype": ent["dtype"]}
        if ent.get("codec"):
            meta["codec"] = ent["codec"]
        return meta
    path = os.path.join(outdir, fname)
    arr = np.load(path, mmap_mode="r")
    meta = {"digest": digest_file(path), "shape": list(arr.shape),
            "dtype": str(arr.dtype)}
    # containers are self-describing: an un-ledgered one still gets its
    # codec into the manifest
    if is_container(arr):
        meta["codec"] = block_codec(arr)
    return meta


def write_index_manifest(outdir: str, dc: DistributionController,
                         rows_per_worker: int | None = None,
                         workers=None, block_meta: dict | None = None,
                         extra: dict | None = None) -> dict:
    """Write ``index.json`` describing a per-block CPD index, atomically.

    Records per-block content digests, shapes and dtypes under
    ``blocks``: from ``block_meta`` (computed as the blocks were
    written), else harvested from the build ledgers, else read from
    disk. ``workers``: optional subset of worker ids — a PARTIAL index
    for single-worker serving (the reference's ``-w`` filter). With
    ``dc.replication`` R > 1 every block's rank 1..R-1 replicas must be
    on disk too: they are listed under ``replica_files`` (with their
    digests in ``blocks``) and ``replication`` records R. At R = 1 the
    manifest has neither key. ``extra``: more top-level keys (a delta
    index's ``diff_epoch`` and ``diff_file``), written last."""
    files = []
    replica_files = []
    bs = dc.block_size
    for wid in (range(dc.maxworker) if workers is None else workers):
        for bid in range((dc.n_owned(wid) + bs - 1) // bs):
            fname = shard_block_name(wid, bid)
            if not os.path.exists(os.path.join(outdir, fname)):
                raise FileNotFoundError(
                    f"index incomplete: missing {fname} "
                    f"(worker {wid} block {bid})")
            files.append(fname)
            for r in range(1, dc.replication):
                rname = shard_block_name(wid, bid, r)
                if not os.path.exists(os.path.join(outdir, rname)):
                    raise FileNotFoundError(
                        f"index incomplete: missing replica {rname} "
                        f"(shard {wid} block {bid} rank {r}, hosted by "
                        f"worker {(wid + r) % dc.maxworker})")
                replica_files.append(rname)
    ledgers: dict[tuple[int, int], dict] = {}
    manifest = {
        "version": INDEX_VERSION,
        "digest_algo": "crc32",
        "nodenum": dc.nodenum,
        "maxworker": dc.maxworker,
        "partmethod": dc.partmethod,
        "partkey": (list(dc.partkey)
                    if isinstance(dc.partkey, (list, tuple)) else dc.partkey),
        "block_size": bs,
        "rows_per_worker": (rows_per_worker if rows_per_worker is not None
                            else max(dc.max_owned, 1)),
        "files": files,
        "blocks": {f: (block_meta or {}).get(f)
                   or _block_meta_for(outdir, f, ledgers)
                   for f in files + replica_files},
    }
    if dc.replication > 1:
        manifest["replication"] = dc.replication
        manifest["replica_files"] = replica_files
    if extra:
        manifest.update(extra)
    atomic_write_json(os.path.join(outdir, "index.json"), manifest)
    return manifest


def read_manifest(outdir: str) -> dict:
    with open(os.path.join(outdir, "index.json")) as f:
        return json.load(f)


def check_manifest_version(manifest: dict, outdir: str) -> None:
    """Reject a manifest NEWER than this code: it may have changed the
    meaning of keys we would silently misread."""
    version = int(manifest.get("version", 1))
    if version > INDEX_VERSION:
        raise ValueError(
            f"index {outdir} has manifest schema v{version}; this build "
            f"reads up to v{INDEX_VERSION} — upgrade the serving code "
            "(unknown keys are tolerated, newer major versions are not)")


def validate_manifest(manifest: dict, dc: DistributionController,
                      outdir: str) -> None:
    """Check a loaded ``index.json`` against the serving controller: the
    same partition quadruple and block size must have built it."""
    check_manifest_version(manifest, outdir)
    my_partkey = (list(dc.partkey)
                  if isinstance(dc.partkey, (list, tuple)) else dc.partkey)
    for key, mine in (("nodenum", dc.nodenum),
                      ("maxworker", dc.maxworker),
                      ("partmethod", dc.partmethod),
                      ("partkey", my_partkey),
                      ("block_size", dc.block_size)):
        if key not in manifest:
            raise ValueError(
                f"index {outdir} manifest is missing required key "
                f"{key!r}")
        if manifest[key] != mine:
            raise ValueError(
                f"index {outdir} was built with {key}={manifest[key]}, "
                f"controller has {mine}")


def _verify_block(path: str, meta: dict | None, want_rows: bool):
    """One block's verification against its manifest entry, behind both
    :func:`check_block` (streamed digest and an mmap'd header: no rows
    materialized) and :func:`load_verified_block` (one file read: the
    digest over the bytes in memory, then those same bytes parsed).
    Returns ``(rows | None, status, reason)`` with status ``ok``
    (digest-verified), ``unverified`` (parses, no digest to check — v1
    manifest), ``missing`` or ``corrupt``; rows is None unless
    ``want_rows`` and the block is servable. A compressed container
    comes back as it is (``maybe_decode_rows`` inflates it); when the
    manifest names a codec, the container's header must parse and name
    the same one, else the block is ``corrupt``. Whatever a torn file
    raises (a short payload, a foreign or torn header) reports
    ``corrupt``, never escapes."""
    if not os.path.exists(path):
        return None, "missing", "file absent"
    need_digest = bool(meta and meta.get("digest"))
    try:
        if want_rows:
            with open(path, "rb") as f:
                data = f.read()
            got = digest_bytes(data) if need_digest else None
            arr = np.load(io.BytesIO(data))
        else:
            got = digest_file(path) if need_digest else None
            arr = np.load(path, mmap_mode="r")
        if need_digest and got != meta["digest"]:
            return None, "corrupt", (f"digest {got} != manifest "
                                     f"{meta['digest']}")
        if meta:
            if "shape" in meta and list(arr.shape) != list(meta["shape"]):
                return None, "corrupt", (
                    f"shape {list(arr.shape)} != manifest "
                    f"{list(meta['shape'])}")
            if "dtype" in meta and str(arr.dtype) != meta["dtype"]:
                return None, "corrupt", (f"dtype {arr.dtype} != "
                                         f"manifest {meta['dtype']}")
            if meta.get("codec"):
                # a payload that digests clean but is not a container of
                # the manifest's codec (or whose header is torn) is
                # corrupt, not servable
                got_codec = block_codec(arr) if is_container(arr) else None
                if got_codec != meta["codec"]:
                    return None, "corrupt", (
                        f"codec {got_codec!r} != manifest "
                        f"{meta['codec']!r}")
    except Exception as e:  # noqa: BLE001 — torn header, short file, ...
        return None, "corrupt", f"unreadable: {type(e).__name__}: {e}"
    return (arr if want_rows else None,
            "ok" if need_digest else "unverified", "")


def check_block(path: str, meta: dict | None) -> tuple[str, str]:
    """Verify one block file WITHOUT materializing the rows (streamed
    digest, mmap'd header); returns ``(status, reason)``."""
    _, status, reason = _verify_block(path, meta, want_rows=False)
    return status, reason


def load_verified_block(path: str, meta: dict | None):
    """Load one block with verification in a SINGLE file read; returns
    ``(block | None, status, reason)`` — the block is None whenever the
    status is ``missing`` or ``corrupt`` (see :func:`_verify_block`)."""
    return _verify_block(path, meta, want_rows=True)


def _fresh_meta(path: str, rows) -> dict:
    """A manifest entry for a block just healed: its digest, shape,
    dtype and, for a container, its codec."""
    meta = {"digest": digest_file(path), "shape": list(rows.shape),
            "dtype": str(rows.dtype)}
    if is_container(rows):
        meta["codec"] = block_codec(rows)
    return meta


def heal_block(outdir: str, manifest: dict | None, fname: str, wid: int,
               graph: Graph, dc: DistributionController,
               status: str = "corrupt", reason: str = "",
               device=None) -> np.ndarray:
    """The self-heal sequence of both load paths (``CPDOracle.load`` and
    the engine's ``load_shard_rows``): quarantine the bad block
    (``<file>.quarantined``), copy a replica from its primary when that
    is digest-valid, else rebuild it in place from the graph on
    ``device`` (``build_worker_shard`` with resume recomputes exactly
    the blocks whose ledger/digest check fails — here the quarantined
    one) keeping the manifest's codec, reload it, and refresh the
    manifest entry only when the new digest differs from the recorded
    one (else every later load would flag the healthy rebuild again).
    Returns the dense rows; raises ``ValueError`` when no loadable block
    comes out."""
    path = os.path.join(outdir, fname)
    qpath = quarantine(path)
    replica = block_file_replica(fname)
    meta = (manifest or {}).get("blocks", {}).get(fname)
    log.warning("CPD block %s is %s (%s); %srebuilding from the graph",
                fname, status, reason,
                f"quarantined to {qpath}; " if qpath else "")
    if replica:
        copy_replica_blocks(dc, wid, replica, outdir)
    # the manifest, not the process env, owns the block's format: a
    # healed compressed index stays compressed (and a raw one raw)
    build_worker_shard(graph, dc, wid, outdir, device=device,
                       codec=(meta or {}).get("codec", "raw"),
                       replica=replica)
    rows, _status, reason2 = load_verified_block(path, None)
    if rows is None:
        raise ValueError(
            f"CPD block {fname} in {outdir} could not be rebuilt: "
            f"{reason2} (original fault: {reason})")
    COUNTERS["cpd_blocks_rebuilt_total"] += 1
    new_meta = _fresh_meta(path, rows)
    if meta is not None and meta.get("digest") != new_meta["digest"]:
        if meta.get("digest"):
            log.warning(
                "rebuilt %s has digest %s != manifest %s (different "
                "build kernel?); refreshing the manifest entry",
                fname, new_meta["digest"], meta["digest"])
        manifest["blocks"][fname] = new_meta
        atomic_write_json(os.path.join(outdir, "index.json"), manifest)
    return maybe_decode_rows(rows)


def verify_index(outdir: str, dc: DistributionController | None = None,
                 manifest: dict | None = None) -> dict:
    """Check-only integrity pass over a CPD index (``make_cpds
    --verify``): every manifest block, replicas included, is digest- and
    shape-verified in place. Returns::

        {"total": N, "ok": n, "unverified": [...],   # no digest (v1)
         "missing": [...], "corrupt": [{"file","reason"}, ...],
         "fatal": "..."}                              # manifest-level

    ``dc`` also cross-checks the partition quadruple.
    :func:`verify_exit_code` maps the report to 0/3/4."""
    report: dict = {"total": 0, "ok": 0, "unverified": [],
                    "missing": [], "corrupt": []}
    if manifest is None:
        try:
            manifest = read_manifest(outdir)
        except (OSError, ValueError) as e:
            report["fatal"] = f"no readable manifest in {outdir}: {e}"
            return report
    if dc is not None:
        try:
            validate_manifest(manifest, dc, outdir)
        except ValueError as e:
            report["fatal"] = str(e)
            return report
    blocks_meta = manifest.get("blocks", {})
    all_files = (list(manifest.get("files", []))
                 + list(manifest.get("replica_files", [])))
    report["total"] = len(all_files)
    for fname in all_files:
        status, reason = check_block(os.path.join(outdir, fname),
                                     blocks_meta.get(fname))
        if status == "ok":
            COUNTERS["cpd_blocks_verified_total"] += 1
            report["ok"] += 1
        elif status == "unverified":
            report["unverified"].append(fname)
        elif status == "missing":
            COUNTERS["cpd_blocks_corrupt_total"] += 1
            report["missing"].append(fname)
        else:
            COUNTERS["cpd_blocks_corrupt_total"] += 1
            report["corrupt"].append({"file": fname, "reason": reason})
    return report


def verify_exit_code(report: dict) -> int:
    """0 clean (every block ok or unverified), 3 degraded (some blocks
    bad), 4 corrupt (manifest unreadable or mismatched, or no block
    survived) — ``process_query``'s 0/3/4 convention."""
    if report.get("fatal"):
        return 4
    bad = len(report["missing"]) + len(report["corrupt"])
    if bad == 0:
        return 0
    good = report["ok"] + len(report["unverified"])
    return 3 if good > 0 else 4


def anti_entropy(outdir: str, dc: DistributionController,
                 graph: Graph | None = None,
                 manifest: dict | None = None, heal: bool = True,
                 device=None) -> dict:
    """Replica anti-entropy pass: cross-check every replica block's crc32
    digest against its PRIMARY's (the manifest's digest, else the file's)
    and, with ``heal=True``, quarantine each divergent or missing replica
    and make it again — a copy of a digest-valid primary, else a
    recompute from ``graph`` on ``device`` with the primary's codec —
    refreshing its manifest entry, with one manifest rewrite for the
    whole pass. The primary wins. Returns ``{"checked": n,
    "mismatched": [...], "healed": [...], "missing_primary": [...]}``;
    a no-op at R = 1."""
    report: dict = {"checked": 0, "mismatched": [], "healed": [],
                    "missing_primary": []}
    if dc.replication <= 1:
        return report
    if manifest is None:
        try:
            manifest = read_manifest(outdir)
        except (OSError, ValueError):
            manifest = None
    blocks_meta = (manifest or {}).get("blocks", {})
    manifest_dirty = False
    bs = dc.block_size
    for shard in range(dc.maxworker):
        for bid in range((dc.n_owned(shard) + bs - 1) // bs):
            prim = shard_block_name(shard, bid)
            prim_meta = blocks_meta.get(prim)
            prim_digest = (prim_meta or {}).get("digest")
            if prim_digest is None:
                try:
                    prim_digest = digest_file(os.path.join(outdir, prim))
                except OSError:
                    report["missing_primary"].append(prim)
                    continue      # nothing to cross-check against
            for r in range(1, dc.replication):
                rname = shard_block_name(shard, bid, r)
                rpath = os.path.join(outdir, rname)
                report["checked"] += 1
                try:
                    got = digest_file(rpath)
                except OSError:
                    got = None        # a missing replica is divergent
                if got == prim_digest:
                    continue
                COUNTERS["replica_digest_mismatches_total"] += 1
                report["mismatched"].append(
                    {"file": rname, "digest": got,
                     "primary_digest": prim_digest})
                if not heal:
                    continue
                quarantine(rpath)
                copied = copy_replica_blocks(dc, shard, r, outdir)
                if rname not in copied and graph is not None:
                    build_worker_shard(
                        graph, dc, shard, outdir, device=device,
                        codec=(prim_meta or {}).get(
                            "codec", _primary_codec(outdir, shard)),
                        replica=r)
                rows, status, reason = load_verified_block(rpath, None)
                if rows is None:
                    log.error("anti-entropy could not heal %s: %s (%s)",
                              rname, status, reason)
                    continue
                report["healed"].append(rname)
                new_meta = _fresh_meta(rpath, rows)
                if (manifest is not None
                        and blocks_meta.get(rname, {}).get("digest")
                        != new_meta["digest"]):
                    blocks_meta[rname] = new_meta
                    manifest_dirty = True
    if manifest_dirty:
        manifest["blocks"] = blocks_meta
        atomic_write_json(os.path.join(outdir, "index.json"), manifest)
    if report["mismatched"]:
        log.warning("anti-entropy: %d/%d replica block(s) diverged from "
                    "their primary (%d healed)", len(report["mismatched"]),
                    report["checked"], len(report["healed"]))
    return report


def adopt_shard_blocks(graph: Graph, dc: DistributionController,
                       shard: int, outdir: str, device=None) -> dict:
    """Adopter catch-up for a shard ownership transfer: make shard
    ``shard``'s PRIMARY block set servable on this filesystem — every
    block digest-verified against the manifest, anything missing or torn
    healed through :func:`heal_block` on ``device``. Idempotent and
    crash-resumable (rebuilt blocks are journaled by the build ledger).
    Returns ``{"shard", "blocks", "ok", "unverified", "healed": [...]}``;
    raises when a block can neither be verified nor healed."""
    try:
        manifest = read_manifest(outdir)
    except (OSError, ValueError):
        manifest = None             # pre-manifest build: heal from graph
    if manifest is not None:
        check_manifest_version(manifest, outdir)
    blocks_meta = (manifest or {}).get("blocks", {})
    bs = dc.block_size
    n_blocks = (dc.n_owned(int(shard)) + bs - 1) // bs
    report: dict = {"shard": int(shard), "blocks": n_blocks, "ok": 0,
                    "unverified": 0, "healed": []}
    for bid in range(n_blocks):
        fname = shard_block_name(int(shard), bid)
        status, reason = check_block(os.path.join(outdir, fname),
                                     blocks_meta.get(fname))
        if status == "ok":
            report["ok"] += 1
        elif status == "unverified":
            report["unverified"] += 1
        else:
            COUNTERS["cpd_blocks_corrupt_total"] += 1
            heal_block(outdir, manifest, fname, int(shard), graph, dc,
                       status=status, reason=reason, device=device)
            report["healed"].append(fname)
        COUNTERS["reshard_blocks_adopted_total"] += 1
    return report


class CPDOracle:
    """Every worker's CPD rows resident on the device(s), answering
    routed query rounds with one walk a device.

    Port of the JAX package's ``CPDOracle``, whose ``[W, R, N]`` table is
    sharded over a mesh's ``worker`` axis. With no ``mesh`` (the default)
    the table is one int8 tensor on ``device`` (None → ``cuda``; raises
    without a GPU unless ``device="cpu"``) and a round is one walk over
    every worker. On the card a round's walk is the CUDA kernel (the
    fused multi-diff walk and the doubling sweep too), on the CPU the
    plain torch version.

    ``mesh``: a ``[D, W]`` grid of devices (``parallel.mesh.make_mesh`` /
    ``mesh_from_config``; ``W`` must be ``maxworker``, as in JAX). The
    router deals each worker's queries over the ``D`` data rows. A grid
    that names one device throughout keeps the single-table path on that
    device; otherwise each device holds the rows of the workers whose
    column names it, once, and walks the lanes of its cells
    (``parallel.sharded.grid_parts``): one walk a device a round, the
    answers joined on the host. ``fm`` (and ``dists``) is then a tuple of
    the devices' ``[Wp, R, N]`` tables, in ``grid_parts`` order.

    Multi-controller runs (``parallel.multihost``, P processes): process
    p holds and walks only its contiguous block of W/P workers (the
    workers JAX's global mesh puts on its devices), builds and loads only
    their rows, and every result merges across the processes by one
    all-gather (each lane is answered by exactly one process). ``save``
    gathers each worker's rows and only the primary writes.

    The walk's ``(next, w)`` pair table (``ops.table_search.walk_pairs``)
    is built once per weight set and device — free flow, and each
    distinct diffed weight vector, or each ``w_key`` of ``query_mat`` —
    and kept beside its padded weights in an LRU
    (``DOS_TRAFFIC_WEIGHT_EPOCHS`` entries a device, at least 2), as
    ``ShardEngine`` keeps them."""

    def __init__(self, graph: Graph, controller: DistributionController,
                 device=None, mesh=None):
        self.graph = graph
        self.dc = controller
        self.targets_wr = pad_targets(controller)
        w = controller.maxworker
        self.pidx, self.pcount = process_info()
        if w % self.pcount:
            raise ValueError(f"{w} workers do not split over "
                             f"{self.pcount} processes")
        per = w // self.pcount
        #: the workers this process holds: every worker on one
        #: controller, its contiguous block of W/P across P processes
        self.workers = np.arange(self.pidx * per, (self.pidx + 1) * per)
        if mesh is None:
            self.mesh = None
            grid = np.empty((1, w), dtype=object)
            grid[:] = resolve_device(device)
        else:
            grid = np.asarray(mesh, dtype=object)
            if grid.ndim != 2 or grid.shape[1] != w:
                raise ValueError(
                    f"mesh worker axis {grid.shape[-1]} != maxworker {w}; "
                    "partmethod=tpu requires one mesh shard per worker")
            self.mesh = grid
        #: the devices' shares (``parallel.sharded.grid_parts``); one
        #: part holding every worker is the single-table path
        self.parts = grid_parts(grid, self.workers)
        for part in self.parts:
            resolve_device(part.device)
        self.n_data = grid.shape[0]
        self.device = self.parts[0].device
        self.dg = DeviceGraph.from_graph(graph, device=self.device)
        self._dgs = {self.device: self.dg}
        #: int8 [W, R, N] (a tuple of the parts' tables on a split grid)
        self.fm = None
        #: optional int32 distances, laid out as ``fm``
        #: (``build(store_dists=True)``)
        self.dists = None
        #: the build kind ``build`` resolved (None before a build)
        self.build_kind: str | None = None
        #: the fused walk's (next, edge id) tables, one a device
        self._eid_pair: dict = {}
        #: the doubling records' layout (``record_order``), one a device
        self._record_order: dict = {}
        #: (weight-set key, device) -> (padded weights, pair table); the
        #: key is None for free flow, a caller's ``w_key``, else a digest
        #: of the weight vector
        self._weights: OrderedDict = OrderedDict()
        self._weight_keep = max(
            2, env_cast("DOS_TRAFFIC_WEIGHT_EPOCHS", 4, int)) * len(
                self.parts)

    @property
    def single(self) -> bool:
        """One device holds every worker's rows (``fm`` is one tensor)."""
        return len(self.parts) == 1 and self.pcount == 1

    def _tables(self, tbl):
        """A table attribute (``fm``, ``dists``, a tables handle) as the
        list of its parts' tables."""
        return [tbl] if self.single else list(tbl)

    def _store(self, tables):
        return tables[0] if self.single else tuple(tables)

    def _dg_on(self, dev: torch.device) -> DeviceGraph:
        if dev not in self._dgs:
            self._dgs[dev] = DeviceGraph.from_graph(self.graph, device=dev)
        return self._dgs[dev]

    # ------------------------------------------------------------- build
    def build(self, chunk: int = 0, max_iters: int = 0,
              store_dists: bool = False,
              method: str = "auto") -> "CPDOracle":
        """Precompute the held workers' first-move rows on their devices.

        ``store_dists=True`` also keeps the converged distance table,
        int32, laid out as ``fm`` in ``dists`` (4x the fm memory),
        enabling :meth:`query_dist` — free-flow answers by one gather
        instead of a walk. Distances are free-flow only and :meth:`save`
        does not persist them (they are a pure derivative of the graph).

        ``method``: ``"sweep"`` forces the fast-sweeping build, ``"shift"``
        the shift relaxation, ``"frontier"`` the delta-stepping queue,
        ``"ell"``/``"ellsplit"`` the (split) padded-ELL relaxation;
        ``"auto"`` resolves per :func:`pick_build_kernel`. Every method
        gives the same table; the kind it resolved to is kept in
        ``build_kind``."""
        kind, structure = pick_build_kernel(self.graph, method)
        self.build_kind = kind
        built = [build_fm_sharded(self._dg_on(p.device),
                                  self.targets_wr[p.workers], chunk=chunk,
                                  max_iters=max_iters,
                                  kernel=(kind, structure),
                                  with_dists=store_dists)
                 for p in self.parts]
        if store_dists:
            self.fm = self._store([b[0] for b in built])
            self.dists = self._store([b[1] for b in built])
        else:
            self.fm = self._store(built)
        return self

    # ------------------------------------------------------- persistence
    def _worker_rows(self, wid: int) -> np.ndarray | None:
        """Worker ``wid``'s ``[n_owned, N]`` rows on the host, from the
        first part holding it (None when this process holds none)."""
        n_owned = self.dc.n_owned(wid)
        for part, fm in zip(self.parts, self._tables(self.fm)):
            hit = np.flatnonzero(part.workers == wid)
            if hit.size:
                return fm[int(hit[0]), :n_owned].cpu().numpy()
        return None

    def save(self, outdir: str, codec: str | None = None) -> None:
        """Write the CPD index: one ``.npy`` per (worker, block), each
        written atomically, plus the manifest with their digests.

        ``codec``: persist blocks compressed (``models.resident``
        containers; None resolves ``DOS_CPD_RESIDENT``, whose ``raw``
        default keeps the plain layout); a block the codec cannot take
        is written raw. Blocks are byte-identical to the JAX package's.

        Multi-controller: each worker's rows are all-gathered from the
        process holding them (host memory peaks at P/W of the table) and
        only the primary writes, so the controllers never race on the
        shared index directory. Every process must call it."""
        if self.fm is None:
            raise RuntimeError("build() or load() before save()")
        codec_req = resident_choice() if codec is None else codec
        primary = is_primary()
        if primary:
            os.makedirs(outdir, exist_ok=True)
        bs = self.dc.block_size
        per = self.dc.maxworker // self.pcount
        block_meta: dict[str, dict] = {}
        for wid in range(self.dc.maxworker):
            n_owned = self.dc.n_owned(wid)
            # one device-to-host copy per worker: host memory peaks at
            # 1/W of the table
            rows_w = self._worker_rows(wid)
            if self.pcount > 1:
                mine = rows_w if rows_w is not None else np.zeros(
                    (n_owned, self.graph.n), np.int8)
                rows_w = gather_to_host(mine)[wid // per]
            if primary:
                for b0 in range(0, n_owned, bs):
                    fname = shard_block_name(wid, b0 // bs)
                    arr = np.ascontiguousarray(
                        rows_w[b0:min(b0 + bs, n_owned)])
                    enc = encode_block(arr, codec_req)
                    blk_codec = None
                    if enc is not None:
                        arr, blk_codec = enc
                    digest = atomic_save_npy(os.path.join(outdir, fname),
                                             arr)
                    block_meta[fname] = {"digest": digest,
                                         "shape": list(arr.shape),
                                         "dtype": str(arr.dtype)}
                    if blk_codec is not None:
                        block_meta[fname]["codec"] = blk_codec
            del rows_w
        if primary:
            write_index_manifest(
                outdir, self.dc,
                rows_per_worker=int(self.targets_wr.shape[1]),
                block_meta=block_meta)

    def load(self, outdir: str, heal: bool = True) -> "CPDOracle":
        """Load a saved index onto the device(s), checking the manifest
        against the controller's partition and every block's digest,
        shape and codec as it loads. Only the held workers' blocks load.
        Compressed containers inflate: the oracle is raw-resident. Rows no
        block covers stay ``-1``.

        ``heal=True`` (default): a missing or corrupt block is
        quarantined (``<file>.quarantined``) and rebuilt in place from
        the graph on its part's device (:func:`heal_block`), then
        reloaded; the manifest entry is refreshed only when the rebuilt
        digest differs. ``heal=False`` raises ``ValueError`` with the
        per-block diagnostic on the first bad block."""
        manifest = read_manifest(outdir)
        validate_manifest(manifest, self.dc, outdir)
        blocks_meta = manifest.get("blocks", {})
        r = self.targets_wr.shape[1]
        tables = [torch.full((len(p.workers), r, self.graph.n), -1,
                             dtype=torch.int8, device=p.device)
                  for p in self.parts]
        bs = self.dc.block_size
        for fname in manifest["files"]:
            _, wpart, bpart = fname[:-len(".npy")].split("-")
            wid, bid = int(wpart[1:]), int(bpart[1:])
            held = [(t, int(np.flatnonzero(p.workers == wid)[0]), p.device)
                    for p, t in zip(self.parts, tables)
                    if (p.workers == wid).any()]
            if not held:
                continue
            rows, status, reason = load_verified_block(
                os.path.join(outdir, fname), blocks_meta.get(fname))
            if rows is None:
                COUNTERS["cpd_blocks_corrupt_total"] += 1
                if not heal:
                    raise ValueError(f"CPD block {fname} in {outdir} is "
                                     f"{status}: {reason}")
                rows = heal_block(outdir, manifest, fname, wid, self.graph,
                                  self.dc, status=status, reason=reason,
                                  device=held[0][2])
            elif status == "ok":
                # only digest-checked blocks count as verified
                COUNTERS["cpd_blocks_verified_total"] += 1
            rows = torch.from_numpy(np.ascontiguousarray(
                maybe_decode_rows(rows)))
            for t, pos, dev in held:
                t[pos, bid * bs: bid * bs + len(rows)] = rows.to(dev)
        self.fm = self._store(tables)
        return self

    # ------------------------------------------------------------- query
    def _length_estimate(self, queries: np.ndarray) -> np.ndarray:
        return length_estimate(self.graph, queries[:, 0], queries[:, 1])

    def route(self, queries: np.ndarray, active_worker: int = -1):
        """Pack (s, t) queries into ``[D, W, Q]`` arrays, ``D`` the
        grid's data rows (1 without a mesh).

        Returns ``(t_rows, s, t, valid, scatter)`` where ``scatter`` maps
        each input query to its (d, w, q) slot for unpacking results.
        Within each worker group, queries are ordered by expected walk
        length (:meth:`_length_estimate`) and dealt round-robin over the
        data rows; ``Q`` is the largest share padded to a power of
        two."""
        queries = np.asarray(queries, np.int64)
        nq = len(queries)
        d = self.n_data
        w = self.dc.maxworker
        wids = self.dc.worker_of(queries[:, 1])
        rows = self.dc.owned_index_of(queries[:, 1])

        active = np.ones(nq, bool) if active_worker == -1 \
            else wids == active_worker
        # round-robin each worker's queries over the data axis (vectorized):
        # the k-th query of worker w goes to data slot k % d, column k // d
        slot_d = np.zeros(nq, np.int64)
        slot_q = np.zeros(nq, np.int64)
        est = self._length_estimate(queries)
        # sort by (worker, est): worker-major grouping; est ordering
        # within a group makes slot_q ascend with walk length
        idxs = np.nonzero(active)[0][np.lexsort(
            (est[active], wids[active]))]
        wids_sorted = wids[idxs]
        group_sizes = np.bincount(wids_sorted, minlength=w)
        starts = np.concatenate([[0], np.cumsum(group_sizes)[:-1]])
        seq = np.arange(len(idxs)) - np.repeat(starts, group_sizes)
        slot_d[idxs] = seq % d
        slot_q[idxs] = seq // d
        qmax = max(int(np.ceil(group_sizes.max() / d)) if len(idxs) else 0, 1)
        # the padded length rounds up to a power of two
        qmax = 1 << (qmax - 1).bit_length()

        s_arr = np.zeros((d, w, qmax), np.int32)
        t_arr = np.zeros((d, w, qmax), np.int32)
        r_arr = np.zeros((d, w, qmax), np.int32)
        valid = np.zeros((d, w, qmax), bool)
        s_arr[slot_d[active], wids[active], slot_q[active]] = queries[active, 0]
        t_arr[slot_d[active], wids[active], slot_q[active]] = queries[active, 1]
        r_arr[slot_d[active], wids[active], slot_q[active]] = rows[active]
        valid[slot_d[active], wids[active], slot_q[active]] = True
        scatter = (active, slot_d, wids, slot_q)
        return r_arr, s_arr, t_arr, valid, scatter

    @staticmethod
    def _unroute(scatter, nq: int, arrays, lead_flags=None):
        """Scatter routed ``[D, W, Q, ...]`` results back to input query
        order (the inverse of :meth:`route`'s packing). Arrays flagged in
        ``lead_flags`` carry a leading per-diff axis (``[Dd, D, W, Q]``)
        that is preserved. Bool arrays come back bool; everything else
        int64. Inactive queries stay zero, the reference's ``-w`` filter
        semantics (``process_query.py:59``)."""
        active, sd, sw, sq = scatter
        if lead_flags is None:
            lead_flags = (False,) * len(arrays)
        outs = []
        for a, lead in zip(arrays, lead_flags):
            a = np.asarray(a)
            dt = bool if a.dtype == np.bool_ else np.int64
            if lead:
                out = np.zeros((a.shape[0], nq) + a.shape[4:], dt)
                out[:, active] = a[:, sd[active], sw[active], sq[active]]
            else:
                out = np.zeros((nq,) + a.shape[3:], dt)
                out[active] = a[sd[active], sw[active], sq[active]]
            outs.append(out)
        return outs

    def _merge(self, *arrays):
        """Join the processes' results (a no-op on one controller): each
        routed lane is answered by exactly one process and is zero
        elsewhere, so the all-gathered copies sum (bools: any) to the
        whole answer on every process."""
        if self.pcount == 1:
            return arrays
        out = []
        for a in arrays:
            g = gather_to_host(a)
            out.append(g.any(axis=0) if a.dtype == np.bool_
                       else g.sum(axis=0, dtype=a.dtype))
        return tuple(out)

    def _on_parts(self, run, lanes, outs, lead=()):
        """One call of ``run(part, table index, flat lanes...)`` a part,
        on ``part``'s lanes of the routed ``[D, W, Q]`` arrays ``lanes``
        (``t_rows`` first; ``parallel.sharded.gather_cells``); its
        results scattered into ``outs`` (numpy, zero-filled, ``[..., D,
        W, Q, ...]``; the indexes in ``lead`` carry a per-diff axis) and
        merged across processes."""
        r = self.targets_wr.shape[1]
        for i, part in enumerate(self.parts):
            got = run(part, i, *gather_cells(part, r, *lanes))
            for j, (o, g) in enumerate(zip(outs, got)):
                scatter_cells(part, o, g, lead=j in lead)
        return self._merge(*outs)

    @staticmethod
    def _one_worker(t: torch.Tensor) -> torch.Tensor:
        """A ``[Wp, R, ...]`` table viewed as one ``[1, Wp·R, ...]``
        worker (the routed lanes of :meth:`_on_parts` are offset for
        it)."""
        return t.view(1, t.shape[0] * t.shape[1], *t.shape[2:])

    def _flat(self, tbl, i: int) -> torch.Tensor:
        """Part ``i``'s table of ``tbl`` as one worker."""
        return self._one_worker(self._tables(tbl)[i])

    def _weights_for(self, w_query: np.ndarray | None,
                     w_key: str | None = None, device=None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        """``(w_pad, pair)`` for one weight set on ``device`` (None: the
        oracle's first device): the padded query-time weights and the
        walk's pair table built from them, cached together under
        ``w_key`` when the caller names the weights, else under the
        weights' digest."""
        dev = self.device if device is None else device
        key = None if w_query is None else w_key if w_key is not None \
            else hashlib.blake2b(
                np.ascontiguousarray(w_query, np.int32).tobytes(),
                digest_size=16).digest()
        if (key, dev) in self._weights:
            self._weights.move_to_end((key, dev))
            return self._weights[(key, dev)]
        dg = self._dg_on(dev)
        w_pad = dg.w_pad if w_query is None else torch.as_tensor(
            self.graph.padded_weights(w_query), dtype=torch.int32,
            device=dev)
        entry = (w_pad, walk_pairs(dg, w_pad))
        self._weights[(key, dev)] = entry
        while len(self._weights) > self._weight_keep:
            self._weights.popitem(last=False)
        return entry

    def query(self, queries: np.ndarray, w_query: np.ndarray | None = None,
              k_moves: int = -1, active_worker: int = -1,
              max_steps: int = 0):
        """Answer queries in input order, one walk a device.

        ``w_query``: perturbed edge weights (file order), None = free
        flow. Returns ``(cost, plen, finished)`` int64/bool arrays [Q];
        queries outside ``active_worker`` (when set) come back cost 0 /
        unfinished, like the reference's ``-w`` filter drops them
        (``process_query.py:59``)."""
        if self.fm is None:
            raise RuntimeError("build() or load() before query()")
        r_arr, s_arr, t_arr, valid, scatter = self.route(
            queries, active_worker)

        def run(part, i, rows, s, t, v):
            w_pad, pair = self._weights_for(w_query, device=part.device)
            return query_sharded(self._dg_on(part.device),
                                 self._flat(self.fm, i), rows, s, t, v,
                                 w_pad, k_moves=k_moves,
                                 max_steps=max_steps, pair=pair)
        outs = self._on_parts(run, (r_arr, s_arr, t_arr, valid),
                              [np.zeros(r_arr.shape, np.int64),
                               np.zeros(r_arr.shape, np.int64),
                               np.zeros(r_arr.shape, bool)])
        return tuple(self._unroute(scatter, len(queries), outs))

    def query_paths(self, queries: np.ndarray, k: int,
                    active_worker: int = -1):
        """Materialize each query's first ``k`` path nodes (the
        reference's ``--k-moves`` extraction, reference ``args.py:31-36``).

        Returns ``(nodes, moves)``: int64 ``[Q, k+1]`` — row q starts at
        ``s``, the last node repeats once the path ends — and the number
        of real moves taken (≤ k). Queries outside ``active_worker`` get
        all-zero rows, matching :meth:`query`'s filter semantics."""
        if self.fm is None:
            raise RuntimeError("build() or load() before query_paths()")
        if k <= 0:
            raise ValueError("k must be positive")
        r_arr, s_arr, t_arr, _valid, scatter = self.route(
            queries, active_worker)
        outs = self._on_parts(
            lambda part, i, rows, s, t: query_paths_sharded(
                self._dg_on(part.device), self._flat(self.fm, i), rows, s,
                t, k=k),
            (r_arr, s_arr, t_arr),
            [np.zeros(r_arr.shape + (k + 1,), np.int64),
             np.zeros(r_arr.shape, np.int64)])
        return tuple(self._unroute(scatter, len(queries), outs))

    # ------------------------------------------------- multi-diff, mat
    def _pads_multi(self, w_diffs, device) -> torch.Tensor:
        return torch.as_tensor(self.graph.padded_weights_multi(w_diffs),
                               dtype=torch.int32, device=device)

    def query_multi(self, queries: np.ndarray,
                    w_diffs: list[np.ndarray | None],
                    active_worker: int = -1, max_steps: int = 0):
        """Answer queries under D congestion diffs in ONE fused walk a
        device.

        The reference campaign runs one round per diff file over the same
        scenario (``process_query.py:178``), re-walking every query each
        round. Trajectories are diff-independent (moves follow the
        free-flow table; diffs only change cost sums), so the fused walk
        (``cuda_walk_multi``: K4 on the card) walks once and sums every
        diff's costs.

        ``w_diffs``: per-diff edge-weight arrays (file order); ``None``
        entries mean free flow. Returns ``(cost [D, Q], plen [Q],
        finished [Q])`` in input query order."""
        if self.fm is None:
            raise RuntimeError("build() or load() before query_multi()")
        if not w_diffs:
            raise ValueError("w_diffs must name at least one round")
        r_arr, s_arr, t_arr, valid, scatter = self.route(
            queries, active_worker)

        def run(part, i, rows, s, t, v):
            dev = part.device
            if dev not in self._eid_pair:
                self._eid_pair[dev] = walk_eid_pairs(self._dg_on(dev))
            return query_multi_sharded(
                self._dg_on(dev), self._flat(self.fm, i), rows, s, t, v,
                self._pads_multi(w_diffs, dev), max_steps=max_steps,
                pair=self._eid_pair[dev])
        outs = self._on_parts(run, (r_arr, s_arr, t_arr, valid),
                              [np.zeros((len(w_diffs),) + r_arr.shape,
                                        np.int64),
                               np.zeros(r_arr.shape, np.int64),
                               np.zeros(r_arr.shape, bool)], lead=(0,))
        return tuple(self._unroute(scatter, len(queries), outs,
                                   (True, False, False)))

    def query_mat(self, s: int, targets,
                  w_query: np.ndarray | None = None,
                  w_key: str | None = None):
        """One ``mat`` family row — one source, K targets — in one walk a
        device, the answers scattered into a dense row in target order on
        the device (``parallel.sharded.query_mat_sharded``; the JAX
        oracle's on-mesh join) and the devices' rows summed on the host
        (each target lives in exactly one slot).

        ``w_key``: a stable identity for ``w_query`` (the diff file path)
        — given one, the padded weights and their pair table are cached
        under it (the oracle's weight cache, least recently used dropped
        first), so many rows under one diff pay one upload and no digest
        of the vector; rows under one key walk the weights first cached
        for it, as the JAX oracle's. The JAX oracle's
        collective-time histogram (``M_MESH_COLLECTIVE``) is
        observability, which waits for ``ROADMAP.md`` A14.

        Returns ``(cost [K] int64, finished [K] bool)`` in target order;
        an out-of-range target comes back unfinished with cost 0 (the
        router cannot place it) rather than raising."""
        if self.fm is None:
            raise RuntimeError("build() or load() before query_mat()")
        targets = np.asarray(targets, np.int64).reshape(-1)
        k = len(targets)
        ok = (targets >= 0) & (targets < self.graph.n)
        cost = np.zeros(k, np.int64)
        fin = np.zeros(k, bool)
        if not ok.any() or not (0 <= int(s) < self.graph.n):
            return cost, fin
        tgts = targets[ok]
        queries = np.stack(
            [np.full(len(tgts), int(s), np.int64), tgts], axis=1)
        r_arr, s_arr, t_arr, valid, scatter = self.route(queries)
        # each routed slot's position in the output row: the scatter
        # writes answers straight into target order
        _active, sd, sw, sq = scatter
        slots = np.full(r_arr.shape, -1, np.int32)
        slots[sd, sw, sq] = np.arange(len(tgts), dtype=np.int32)
        # the row width pads to the next power of two (the JAX oracle's
        # stable-shape rule); pad slots never receive an answer
        k_pad = 1 << (len(tgts) - 1).bit_length()
        row_c = np.zeros(k_pad, np.int64)
        row_f = np.zeros(k_pad, bool)
        r = self.targets_wr.shape[1]
        for i, part in enumerate(self.parts):
            rows, s_l, t_l, v_l, sl_l = gather_cells(
                part, r, r_arr, s_arr, t_arr, valid, slots)
            w_pad, pair = self._weights_for(w_query, w_key, part.device)
            c, f = query_mat_sharded(
                self._dg_on(part.device), self._flat(self.fm, i), rows,
                s_l, t_l, v_l, sl_l, w_pad, k_out=k_pad, pair=pair)
            row_c += c.cpu().numpy()
            row_f |= f.cpu().numpy()
        row_c, row_f = self._merge(row_c, row_f)
        cost[ok] = row_c[:len(tgts)]
        fin[ok] = row_f[:len(tgts)]
        return cost, fin

    def query_dist(self, queries: np.ndarray, active_worker: int = -1):
        """Free-flow fast path: answer d(s → t) by one gather.

        Requires ``build(store_dists=True)``. Returns ``(cost,
        finished)`` — no ``plen``: no path is materialized. Costs on a
        diffed graph still need :meth:`query`."""
        if self.dists is None:
            raise RuntimeError(
                "distance table not resident; build(store_dists=True)")
        r_arr, s_arr, _t_arr, _valid, scatter = self.route(
            queries, active_worker)
        (cost,) = self._on_parts(
            lambda part, i, rows, s: (query_dist_sharded(
                self._flat(self.dists, i), rows, s),),
            (r_arr, s_arr), [np.zeros(r_arr.shape, np.int64)])
        nq = len(queries)
        active, sd, sw, sq = scatter
        out_c = np.zeros(nq, np.int64)
        out_f = np.zeros(nq, bool)
        got = cost[sd[active], sw[active], sq[active]]
        fin = got < TINF
        out_c[active] = np.where(fin, got, 0)
        out_f[active] = fin
        return out_c, out_f

    # ------------------------------------------------- prepared tables
    def _table_need(self, per_entry: int) -> int:
        """Bytes of prepared tables on the busiest device."""
        rows = max(len(p.workers) for p in self.parts)
        return rows * self.targets_wr.shape[1] * self.graph.n * per_entry

    def table_memory_bytes(self) -> int:
        """Device bytes the prepared tables will occupy on the busiest
        device: int32 cost + sign-packed plen (int16 when N < 2^15) per
        (held worker, row, node)."""
        return self._table_need(
            4 + torch.iinfo(plen_dtype(self.graph.n)).bits // 8)

    @property
    def TABLE_BUDGET(self) -> int:
        """Device budget for prepared tables (bytes), read at each call
        from ``DOS_TABLE_BUDGET_GB`` (default 8; a malformed or
        non-positive value falls back to it)."""
        gb = env_cast("DOS_TABLE_BUDGET_GB", 8.0, float)
        return int((gb if gb > 0 else 8.0) * 1e9)

    def prepare_weights(self, w_query: np.ndarray | None = None,
                        max_len: int = 0, chunk: int = 2048):
        """Pointer doubling: precompute cost + packed plen for EVERY
        (source, owned-target) pair under ``w_query`` in O(log L) sweeps
        (``ops.pointer_doubling``; each sweep K5 on the card). After this,
        :meth:`query_table` answers any query on these weights by one
        gather — the amortization path for large campaigns, congestion-
        diffed rounds included, where :meth:`query_dist` does not apply.

        Memory: 6-8 bytes an entry, 6-8x the fm table. A device holds the
        tables of every worker it holds, so that need is held against the
        budget (``DOS_TABLE_BUDGET_GB``, default 8): the JAX gate with
        one worker shard. Over it, the call raises with the math instead
        of faulting mid-campaign. ``chunk`` bounds the rows a worker
        doubles at once (two ``[chunk, N, 4]`` int32 record buffers
        live).

        Returns a tables handle, laid out as ``fm``: ``(cost [W, R, N],
        plen_packed [W, R, N])``, or a tuple of the parts' pairs on a
        split grid, for :meth:`query_table`."""
        if self.fm is None:
            raise RuntimeError("build() or load() before prepare_weights()")
        need = self.table_memory_bytes()
        budget = self.TABLE_BUDGET
        if need > budget:
            w, r = self.targets_wr.shape
            raise ValueError(
                f"prepared tables need {need / 1e9:.1f} GB "
                f"({w}x{r}x{self.graph.n} entries x "
                f"{need // self._table_need(1)} B, sharded over 1 "
                f"worker shard(s) = {need / 1e9:.1f} GB/device) — "
                f"over the {budget / 1e9:.1f} GB/device budget "
                "(DOS_TABLE_BUDGET_GB). At this scale serve via the walk "
                "or StreamedCPDOracle instead (models.streamed).")
        r, n = self.targets_wr.shape[1], self.graph.n
        handles = []
        for part, fm in zip(self.parts, self._tables(self.fm)):
            dev, wp = part.device, len(part.workers)
            w_pad, _pair = self._weights_for(w_query, device=dev)
            out = (torch.empty((wp, r, n), dtype=torch.int32, device=dev),
                   torch.empty((wp, r, n), dtype=plen_dtype(n),
                               device=dev))
            handles.append(self._chunked_tables(
                lambda fm_, tw_, o, dev=dev, w_pad=w_pad:
                    build_tables_sharded(
                        self._dg_on(dev), fm_, tw_, w_pad, max_len=max_len,
                        out=o, order=self._order(dev)),
                chunk, out, fm, self.targets_wr[part.workers]))
        return self._store(handles)

    def _order(self, dev=None) -> torch.Tensor:
        """The doubling records' layout on ``dev`` (None: the oracle's
        first device), a Z-order of the coordinates
        (``ops.pointer_doubling.record_order``), made once a device."""
        dev = self.device if dev is None else dev
        if dev not in self._record_order:
            self._record_order[dev] = record_order(self.graph, dev)
        return self._record_order[dev]

    @staticmethod
    def _chunked_tables(build_one, chunk: int, out, fm_all, targets_wr):
        """Run a table builder over row chunks of the target axis of one
        device's table ``fm_all`` (``[Wp, R, N]``, targets
        ``targets_wr``), each chunk's rows written into ``out``'s — the
        shared scaffolding of :meth:`prepare_weights` and
        :meth:`prepare_weights_multi`. As in the JAX oracle every chunk
        is ``chunk`` rows: a short tail is padded with -1 targets and -1
        fm rows and trimmed."""
        r = targets_wr.shape[1]
        if chunk <= 0 or chunk >= r:
            return build_one(fm_all, targets_wr, out)
        w, _, n = fm_all.shape
        for i in range(0, r, chunk):
            c = min(chunk, r - i)
            fm = fm_all[:, i:i + c]
            tw = targets_wr[:, i:i + c]
            if c == chunk:
                build_one(fm, tw, tuple(o[:, i:i + c] for o in out))
                continue
            fm = torch.cat([fm, torch.full((w, chunk - c, n), -1,
                                           dtype=fm.dtype,
                                           device=fm.device)], dim=1)
            tw = np.concatenate(
                [tw, np.full((w, chunk - c), -1, tw.dtype)], axis=1)
            for o, part in zip(out, build_one(fm, tw, None)):
                o[:, i:i + c] = part[:, :c]
        return out

    def query_table(self, tables, queries: np.ndarray,
                    active_worker: int = -1):
        """Answer queries from :meth:`prepare_weights` tables. Returns
        ``(cost, plen, finished)`` — identical to :meth:`query` on the
        same weights, by one gather a query."""
        r_arr, s_arr, _t_arr, valid, scatter = self.route(
            queries, active_worker)
        handles = self._tables(tables)
        outs = self._on_parts(
            lambda part, i, rows, s, v: query_tables_sharded(
                tuple(self._one_worker(t) for t in handles[i]), rows, s, v),
            (r_arr, s_arr, valid),
            [np.zeros(r_arr.shape, np.int64),
             np.zeros(r_arr.shape, np.int64),
             np.zeros(r_arr.shape, bool)])
        return tuple(self._unroute(scatter, len(queries), outs))

    def prepare_weights_multi(self, w_diffs: list[np.ndarray | None],
                              max_len: int = 0, chunk: int = 1024):
        """Fused pointer-doubling tables for D diffs at once: the doubling
        recursion is shared across diffs (free-flow successors), so each
        sweep sums every diff's costs from one record
        (``ops.pointer_doubling.doubled_tables_multi``). Memory: ``4 D +
        2-4`` bytes an entry, gated like :meth:`prepare_weights`.
        ``chunk`` defaults lower than the single-diff path because each
        record widens by the D costs.

        Returns a tables handle ``(costs [W, R, N, D], plen_packed [W, R,
        N])`` (a tuple of the parts' pairs on a split grid) for
        :meth:`query_table_multi`."""
        if self.fm is None:
            raise RuntimeError(
                "build() or load() before prepare_weights_multi()")
        if not w_diffs:
            raise ValueError("w_diffs must name at least one round")
        d = len(w_diffs)
        per_entry = 4 * d + torch.iinfo(plen_dtype(self.graph.n)).bits // 8
        need = self._table_need(per_entry)
        budget = self.TABLE_BUDGET
        if need > budget:
            raise ValueError(
                f"fused tables for {d} diffs need {need / 1e9:.1f} GB "
                f"({per_entry} B/entry over 1 worker shard(s) = "
                f"{need / 1e9:.1f} GB/device) — over the "
                f"{budget / 1e9:.1f} GB/device budget "
                "(DOS_TABLE_BUDGET_GB). Prepare fewer diffs per call or "
                "serve via the fused walk (query_multi) instead.")
        r, n = self.targets_wr.shape[1], self.graph.n
        handles = []
        for part, fm in zip(self.parts, self._tables(self.fm)):
            dev, wp = part.device, len(part.workers)
            w_pads = self._pads_multi(w_diffs, dev)
            out = (torch.empty((wp, r, n, d), dtype=torch.int32,
                               device=dev),
                   torch.empty((wp, r, n), dtype=plen_dtype(n),
                               device=dev))
            handles.append(self._chunked_tables(
                lambda fm_, tw_, o, dev=dev, w_pads=w_pads:
                    build_tables_multi_sharded(
                        self._dg_on(dev), fm_, tw_, w_pads,
                        max_len=max_len, out=o, order=self._order(dev)),
                chunk, out, fm, self.targets_wr[part.workers]))
        return self._store(handles)

    def query_table_multi(self, tables, queries: np.ndarray,
                          active_worker: int = -1):
        """Answer queries from :meth:`prepare_weights_multi` tables: one
        ``[D]``-wide gather a query. Returns ``(cost [D, Q], plen [Q],
        finished [Q])`` — row d identical to :meth:`query_table` on diff
        d's tables."""
        r_arr, s_arr, _t_arr, valid, scatter = self.route(
            queries, active_worker)
        handles = self._tables(tables)
        d = handles[0][0].shape[-1]
        outs = self._on_parts(
            lambda part, i, rows, s, v: query_tables_multi_sharded(
                tuple(self._one_worker(t) for t in handles[i]), rows, s, v),
            (r_arr, s_arr, valid),
            [np.zeros((d,) + r_arr.shape, np.int64),
             np.zeros(r_arr.shape, np.int64),
             np.zeros(r_arr.shape, bool)], lead=(0,))
        return tuple(self._unroute(scatter, len(queries), outs,
                                   (True, False, False)))
