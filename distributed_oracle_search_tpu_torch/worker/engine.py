"""Per-shard query engine: the worker-resident compute path.

Role parity with the reference's resident ``fifo_auto`` process: load the
graph and THIS worker's CPD shard onto one device, then answer query
batches for targets this shard owns with the table-search walk — on the
card through the hand-written CUDA kernel (``ops.cuda_walk``), on the CPU
through the plain torch walk. Port of the JAX package's
``worker/engine.py`` for ``alg="table-search"`` on one device.

Residency follows ``DOS_CPD_RESIDENT`` (``models.resident``): the shard
lives on the card raw, pack4 or rle. A pack4 batch that does not extract
walks the packed table through the pack4 kernel; every other compressed
batch (rle, or pack4 with ``extract``) inflates the batch's distinct
target rows once into a dense block and walks and extracts from that.

The walk's ``(next, w)`` pair table (``ops.table_search.walk_pairs``) is
built once per weight set and cached beside its weight vector in the
per-diff LRU, so no walk call, deadline chunk or repeat rebuilds it.

Runtime knobs honored per batch (reference ``process_query.py:149-160``):
``k_moves`` (move budget), ``itrs`` (repeat count; last result wins),
``no_cache`` (drop the per-diff weight cache), ``extract`` (path
prefixes) and ``time`` (ns budget). ``time`` truncates INSIDE a batch
like the reference's engine (reference ``args.py:30-57``): the
length-sorted batch runs in fixed-size chunks with the deadline checked
between chunks, so an expired budget returns partial ``finished`` counts
(cheapest queries answered first; the first chunk always runs). Batches
at or below one chunk stay all-or-nothing. Extraction still covers every
query of a truncated batch, so ``last_paths`` holds prefixes for queries
reported unfinished — the same asymmetry as the JAX engine.

The load heals: a missing or corrupt block is quarantined and rebuilt
on the engine's device through the build kernels (``models.cpd.
heal_block``). An engine may serve another shard's rows from the replica
block set its worker hosts (``shard=``, ``replica=``).

``alg="astar"`` (the hscale/fscale weighted-A* family) loads no shard:
a batch searches the graph directly, on the raw batch (no dedupe, no
length sort), through the batched search on the engine's device
(``ops.batched_astar``; K6 on the card) in ``time_chunk`` chunks with the
deadline checked between chunks, or through the per-query heap engine
(``models.astar``) under ``debug``.

Index promotion: :meth:`ShardEngine.promote_index` (or its background
form) loads this shard's rows from a delta-rebuilt epoch index
(``models.cpd.delta_build_index``), digest-checked and never healed, and
publishes them as the promoted table; a batch that names that epoch's
fused diff (``fused-e<N>.diff``) walks it, every other batch the base
table (:meth:`ShardEngine._fm_for`). Promotion is monotone in the epoch.

Worker lanes (``mesh=``, else ``DOS_MESH_DEVICES``:
``parallel.mesh.make_worker_mesh``): the PRIMARY ``table-search`` engine
of a worker that drives L lanes pads each batch to at least L and splits
every walk call — the whole batch, or each deadline chunk — over them
(``parallel.sharded.walk_lanes``: lane l walks the l-th contiguous part
of the length-sorted batch, one B1 launch a lane on its card). The
rows, graph and weights live once a distinct lane device; lanes on one
device share them. A compressed table under lanes inflates the batch's
distinct rows and walks them raw (the pack4 kernel does not run under
lanes). A replica engine (rank r > 0) does not split: it pins its table
to lane ``r % L``'s device; A* engines keep one device. Answers are
bit-identical to the single-device engine's.

Not ported: path signatures (``sig_k``), promotion by the diff-epoch
manager with the serving cache's flush, the resident scrubber and the
observability hooks (A14).
"""

from __future__ import annotations

import glob
import os
import re
import threading
import time
from collections import OrderedDict

import numpy as np
import torch

from ..data.formats import read_diff
from ..data.graph import Graph
from ..models.cpd import (
    COUNTERS, check_manifest_version, diff_epoch_of, heal_block,
    length_estimate, load_verified_block, read_manifest, shard_block_name,
)
from ..models.astar import AstarStats, astar, min_cost_per_unit
from ..models.resident import CompressedFM, make_resident, maybe_decode_rows
from ..ops.batched_astar import astar_batch_np
from ..ops.cuda_walk import cuda_walk_batch
from ..ops.device_graph import DeviceGraph
from ..ops.table_search import extract_paths, walk_pairs
from ..parallel.mesh import (
    canonical, distinct, local_devices, make_worker_mesh,
)
from ..parallel.partition import DistributionController
from ..parallel.sharded import walk_lanes
from ..transport.wire import RuntimeConfig, StatsRow
from ..utils.device import resolve_device
from ..utils.env import env_cast
from ..utils.log import get_logger, set_worker_id

log = get_logger(__name__)


def _block_id(path: str) -> int:
    return int(re.search(r"-b(\d+)\.npy$", path).group(1))


def load_shard_rows(outdir: str, wid: int,
                    dc: DistributionController | None = None,
                    graph: Graph | None = None, heal: bool = True,
                    replica: int = 0, device=None) -> np.ndarray:
    """Load one worker's CPD rows from the block files the build wrote
    (``cpd-w<wid>-b<bid>.npy``; the index manifest is optional so a
    shard can serve before the whole cluster's build completes).

    When the manifest is present its per-block digests are verified as
    the rows load. A missing or corrupt block is quarantined and — when
    the caller gives ``graph`` and ``dc`` (``ShardEngine`` does) and
    ``heal`` — rebuilt in place on ``device`` (``models.cpd.heal_block``);
    else the load raises ``ValueError`` with the per-block diagnostic.

    ``replica``: load shard ``wid``'s rank-``replica`` replica block set
    (``cpd-w<wid>-r<rr>-b<bid>.npy``). With no replica blocks on disk the
    load falls back to the primary set (the rows are identical by
    construction: a shared filesystem holds them). Compressed containers
    inflate to dense rows here; whether the resident table re-compresses
    is ``ShardEngine``'s policy."""
    manifest: dict | None = None
    try:
        manifest = read_manifest(outdir)
    except (OSError, ValueError):
        pass                       # pre-manifest partial build: no digests
    if manifest is not None:
        check_manifest_version(manifest, outdir)
    blocks_meta = (manifest or {}).get("blocks", {})
    # the name up to the block id: primary names never match a replica
    # set's, nor the other way round
    prefix = shard_block_name(wid, 0, replica)[:-len("00000.npy")]
    files = sorted(glob.glob(os.path.join(outdir, f"{prefix}*.npy")),
                   key=_block_id)
    # the manifest knows blocks the glob cannot see (deleted on disk)
    manifested = sorted((os.path.join(outdir, f) for f in blocks_meta
                         if f.startswith(prefix)), key=_block_id)
    files = manifested if manifested else files
    if not files and replica:
        log.warning("no rank-%d replica blocks for shard %d in %s; "
                    "falling back to the primary block set (same rows, "
                    "shared filesystem)", replica, wid, outdir)
        return load_shard_rows(outdir, wid, dc=dc, graph=graph, heal=heal,
                               device=device)
    if not files:
        raise FileNotFoundError(f"no CPD blocks for worker {wid} in {outdir}")
    parts = []
    for path in files:
        fname = os.path.basename(path)
        rows, status, reason = load_verified_block(path,
                                                   blocks_meta.get(fname))
        if rows is None:
            COUNTERS["cpd_blocks_corrupt_total"] += 1
            if not heal or graph is None or dc is None:
                raise ValueError(
                    f"CPD block {fname} in {outdir} is {status}: {reason}"
                    + ("" if heal else " (healing disabled)")
                    + ("" if graph is not None and dc is not None
                       else " — no graph/controller to rebuild from; "
                            "load degraded"))
            parts.append(heal_block(outdir, manifest, fname, wid, graph,
                                    dc, status=status, reason=reason,
                                    device=device))
            continue
        if status == "ok":
            COUNTERS["cpd_blocks_verified_total"] += 1
        try:
            parts.append(maybe_decode_rows(rows))
        except ValueError as e:        # torn container, no manifest codec
            raise ValueError(f"CPD block {fname} in {outdir} is corrupt: "
                             f"{e} (rebuild the shard to heal it)") from e
    return parts[0] if len(parts) == 1 else np.concatenate(parts, axis=0)


class ShardEngine:
    """One shard's rows resident on one device, answering
    ``table-search`` batches, or an ``astar`` engine that holds no rows.
    ``device``: None → ``cuda`` (raises without a GPU unless
    ``device="cpu"``). The table is kept raw, pack4 or rle under
    ``DOS_CPD_RESIDENT``; ``resident_codec`` says what it resolved to
    and ``resident_bytes`` what it occupies (``"raw"`` and 0 for A*).

    ``shard``: the shard whose rows the engine answers — ``wid`` itself
    (the default), or another shard when worker ``wid`` hosts one of its
    replicas. ``replica``: the block set the rows load from (None → the
    rank with which ``wid`` holds ``shard``, 0 for its own). The load
    gets the graph and the controller, so a missing or corrupt block is
    rebuilt on ``device`` (``load_shard_rows``).

    ``mesh``: the worker's lanes, a list of devices that may repeat one
    (None → ``DOS_MESH_DEVICES`` over ``device``'s devices,
    ``parallel.mesh.make_worker_mesh``). The primary engine then lives on
    lane 0's device and splits its walks over the lanes; a replica of
    rank r lives on lane ``r % L``'s device (see the module note)."""

    def __init__(self, graph: Graph, dc: DistributionController, wid: int,
                 outdir: str, alg: str = "table-search", device=None,
                 shard: int | None = None, replica: int | None = None,
                 mesh=None):
        if alg not in ("table-search", "astar"):
            raise ValueError(f"unknown algorithm {alg!r}")
        self.device = resolve_device(device)
        self.alg = alg
        self.graph = graph
        self.dc = dc
        self.wid = wid
        self.outdir = outdir
        self.shard = wid if shard is None else int(shard)
        if replica is not None:
            self.replica = int(replica)
        else:
            self.replica = (dc.replica_rank(self.shard, wid)
                            if self.shard != wid else 0)
        #: the worker's lane list (an explicit ``mesh=`` wins over
        #: ``DOS_MESH_DEVICES``); None: one device
        self.mesh = mesh if mesh is not None else make_worker_mesh(
            devices=local_devices(self.device))
        if self.mesh is not None:
            self.mesh = [canonical(d) for d in self.mesh]
        self.n_lanes = len(self.mesh) if self.mesh is not None else 1
        #: REPLICA LANE: replica rank r serves from lane r % L's device;
        #: the primary keeps every lane and splits its batches instead
        self._lane_device = (self.mesh[self.replica % self.n_lanes]
                             if self.mesh is not None and self.replica
                             else None)
        if self._lane_device is not None:
            self.device = self._lane_device
        elif self._lane_split:
            self.device = self.mesh[0]
        #: (id, device) -> (tensor, its copy on another lane device),
        #: least recently used dropped first
        self._lane_copies: OrderedDict = OrderedDict()
        self._dgs: dict = {}
        self.resident_codec = "raw"
        self.resident_bytes = 0
        #: diff epoch of the PROMOTED table (0: none yet); the gate itself
        #: is ``_fm_promoted``, ONE ``(epoch, table)`` reference that
        #: :meth:`promote_index` replaces whole under ``_promote_lock``
        self.index_epoch = 0
        self._fm_promoted: tuple | None = None
        self._promote_lock = threading.Lock()
        self.fm = self.dg = None
        if alg == "table-search":         # A* needs no first-move shard
            rows = load_shard_rows(outdir, self.shard, dc=dc, graph=graph,
                                   replica=self.replica, device=self.device)
            owned = dc.owned(self.shard)
            if len(owned) != rows.shape[0]:
                raise ValueError(
                    f"shard w{self.shard}: {rows.shape[0]} CPD rows but "
                    f"controller owns {len(owned)} nodes — partition "
                    "mismatch")
            self.fm = self._make_resident(rows)
            self.dg = DeviceGraph.from_graph(graph, device=self.device)
            self._dgs[self.device] = self.dg
        #: per-diff weights, LRU-bounded (≥ 2: the double buffer an epoch
        #: swap needs): the walk's device weights with the ``(next, w)``
        #: pair table built from them once, and A*'s raw host weights
        #: with their heuristic scale under ``("raw", diff)``; a re-upload
        #: after eviction is a read + transfer, never a correctness event
        self._weight_cache: OrderedDict[object, tuple] = OrderedDict()
        self._weight_keep = max(
            2, env_cast("DOS_TRAFFIC_WEIGHT_EPOCHS", 4, int))
        #: device-batch rows per deadline-checked chunk (the walk's under
        #: a time budget; every A* batch's)
        self.time_chunk = 1024
        #: A*'s device graph (in-edge ELL, coordinates) and each named
        #: weight set's device copy, uploaded once
        #: (``ops.batched_astar.astar_batch_np``'s ``ctx``)
        self._astar_ctx: dict = {}
        #: path prefixes of the most recent extract batch (see answer())
        self.last_paths: tuple[np.ndarray, np.ndarray] | None = None

    # ------------------------------------------------------------- lanes
    @property
    def _lane_split(self) -> bool:
        """Whether this engine splits its walk batches over lanes: the
        PRIMARY ``table-search`` engine of a worker that drives several;
        replica engines pin to their lane's device and A* keeps one."""
        return (self.mesh is not None and not self.replica
                and self.alg == "table-search")

    def _copy_to(self, x: torch.Tensor, dev: torch.device) -> torch.Tensor:
        """``x`` on lane device ``dev``: itself when it lies there, else
        one copy kept while ``x`` is among the recently used."""
        if x.device == dev:
            return x
        key = (id(x), dev)
        hit = self._lane_copies.get(key)
        if hit is not None and hit[0] is x:
            self._lane_copies.move_to_end(key)
            return hit[1]
        self._lane_copies[key] = (x, x.to(dev))
        while len(self._lane_copies) > 8 * self.n_lanes:
            self._lane_copies.popitem(last=False)
        return self._lane_copies[key][1]

    def _placed(self, fm_walk, w_pad, pair) -> dict:
        """A batch's walk operands ``(dg, fm, w_pad, pair)`` on each
        distinct lane device (one copy a device; none on this engine's
        own device)."""
        out = {}
        for dev in distinct(self.mesh):
            if dev not in self._dgs:
                self._dgs[dev] = DeviceGraph(
                    *(self._copy_to(a, dev) for a in self.dg))
            out[dev] = (self._dgs[dev], self._copy_to(fm_walk, dev),
                        self._copy_to(w_pad, dev),
                        self._copy_to(pair, dev))
        return out

    def _make_resident(self, rows: np.ndarray):
        """The resident table under ``DOS_CPD_RESIDENT``: the raw int8
        tensor, or a :class:`CompressedFM` whose arrays live compressed
        on the device and inflate per batch at the point of use."""
        fm, codec = make_resident(rows, device=self.device)
        self.resident_codec = codec
        self.resident_bytes = int(fm.nbytes)
        return fm

    # ---------------------------------------------------------- promotion
    def _fm_for(self, difffile: str):
        """The table a batch walks: the promoted epoch's table when the
        batch names that epoch's fused diff (``fused-e<N>.diff``), the
        base table otherwise — so a batch of an older epoch, or free
        flow, keeps its answers exactly. The published ``(epoch, table)``
        pair is read once, so a concurrent promotion cannot pair one
        epoch with another's table."""
        promoted = self._fm_promoted
        if promoted is not None and diff_epoch_of(difffile) == promoted[0]:
            return promoted[1]
        return self.fm

    def promote_index(self, new_outdir: str, epoch: int) -> bool:
        """Serve epoch ``epoch``'s delta-rebuilt index (``new_outdir``,
        ``models.cpd.epoch_index_dir``) for the batches that name its
        fused diff: load this shard's rows from it, digest-checked, and
        publish them as the promoted table (through the resident policy,
        ``_make_resident``). ``table-search`` engines only. The load never
        heals: a heal would rebuild a bad block from this engine's
        free-flow graph and serve wrong-regime rows as the epoch's. The
        row count must be the base table's, and the epoch must be above
        the promoted one (two promotions finishing out of order must not
        let the older win). Returns False, and changes nothing, when any
        of that fails: the base table is always a correct answer."""
        if self.alg != "table-search":
            return False
        try:
            rows = load_shard_rows(new_outdir, self.shard, dc=self.dc,
                                   heal=False, replica=self.replica,
                                   device=self.device)
        except (OSError, ValueError) as e:
            log.error("worker %d: cannot promote epoch %d index from %s: "
                      "%s (keeping epoch %d)", self.wid, epoch, new_outdir,
                      e, self.index_epoch)
            return False
        if rows.shape[0] != self.fm.shape[0]:
            log.error("worker %d: epoch %d index has %d rows, resident "
                      "table %d — partition mismatch, not promoting",
                      self.wid, epoch, rows.shape[0], self.fm.shape[0])
            return False
        with self._promote_lock:
            cur = self._fm_promoted
            if cur is not None and int(epoch) <= cur[0]:
                log.warning("worker %d: not promoting epoch %d over "
                            "already-promoted epoch %d", self.wid, epoch,
                            cur[0])
                return False
            self._fm_promoted = (int(epoch), self._make_resident(rows))
            self.index_epoch = int(epoch)
        log.info("worker %d: promoted shard %d to diff-epoch %d index (%s)",
                 self.wid, self.shard, epoch, new_outdir)
        return True

    def promote_index_async(self, new_outdir: str,
                            epoch: int) -> threading.Thread:
        """:meth:`promote_index` on a daemon thread (the load runs off the
        serving path; the publish is one reference swap). Returns the
        thread; a failure is logged and keeps the old table."""
        def _run():
            try:
                self.promote_index(new_outdir, epoch)
            except Exception as e:  # noqa: BLE001 — a failed promotion
                # keeps the old table; serving must not die of it
                log.error("worker %d: async promotion to epoch %d "
                          "failed: %s", self.wid, epoch, e)

        t = threading.Thread(target=_run,
                             name=f"dos-build-promote-w{self.wid}",
                             daemon=True)
        t.start()
        return t

    # ------------------------------------------------------------ weights
    def _weights_for(self, difffile: str, no_cache: bool
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        """``(w_pad, pair)`` for ``difffile``: the padded query-time
        weights and the walk's pair table built from them, cached together
        (the pair table lives and is evicted with its weight vector)."""
        if difffile in self._weight_cache and not no_cache:
            self._weight_cache.move_to_end(difffile)
            return self._weight_cache[difffile]
        if difffile == "-":
            w_pad = self.dg.w_pad
        else:
            w = self.graph.weights_with_diff(read_diff(difffile))
            w_pad = torch.as_tensor(self.graph.padded_weights(w),
                                    dtype=torch.int32, device=self.device)
        entry = (w_pad, walk_pairs(self.dg, w_pad))
        if no_cache:
            self._weight_cache.clear()
        else:
            self._weight_cache[difffile] = entry
            self._trim_weight_cache()
        return entry

    def _trim_weight_cache(self) -> None:
        while len(self._weight_cache) > self._weight_keep:
            self._weight_cache.popitem(last=False)

    def _raw_weights_for(self, difffile: str, no_cache: bool
                         ) -> tuple[np.ndarray, float]:
        """A*'s raw (unpadded) query weights and heuristic scale
        (``min_cost_per_unit``), cached per diff like the walk's."""
        key = ("raw", difffile)
        if key in self._weight_cache and not no_cache:
            self._weight_cache.move_to_end(key)
            return self._weight_cache[key]
        w = (self.graph.w if difffile == "-"
             else self.graph.weights_with_diff(read_diff(difffile)))
        entry = (w, min_cost_per_unit(self.graph, w))
        if no_cache:
            self._weight_cache.pop(key, None)
        else:
            self._weight_cache[key] = entry
            self._trim_weight_cache()
        return entry

    def preload(self, difffile: str) -> None:
        """Load ``difffile``'s weights ahead of the first batch, as the
        reference server loads its first diff (what the algorithm
        reads: the walk's device weights, or A*'s raw weights)."""
        if self.alg == "astar":
            self._raw_weights_for(difffile, no_cache=False)
        else:
            self._weights_for(difffile, no_cache=False)

    # -------------------------------------------------------------- batch
    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def answer(self, queries: np.ndarray, config: RuntimeConfig,
               difffile: str = "-") -> tuple[np.ndarray, np.ndarray,
                                             np.ndarray, StatsRow]:
        """Answer a batch; returns (cost, plen, finished, stats).

        With ``config.extract`` and ``k_moves > 0`` the extracted path
        prefixes land on ``self.last_paths`` as ``(nodes [Q, k+1],
        moves [Q])``.
        """
        set_worker_id(self.wid)
        t0 = time.perf_counter()
        self.last_paths = None
        queries = np.asarray(queries, np.int64).reshape(-1, 2)
        # routing invariant FIRST — before any shard-local row lookup
        if len(queries):
            owner = self.dc.worker_of(queries[:, 1])
            if (owner != self.shard).any():
                bad = int((owner != self.shard).sum())
                raise ValueError(
                    f"shard w{self.shard} received {bad} queries for "
                    "other workers — routing invariant violated")
        nq = len(queries)
        extracting = config.extract and config.k_moves > 0
        if self.alg == "table-search":
            w_pad, pair = self._weights_for(difffile, config.no_cache)
        if nq == 0:
            if extracting:
                self.last_paths = (
                    np.zeros((0, config.k_moves + 1), np.int64),
                    np.zeros(0, np.int64))
            return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                    np.zeros(0, bool), StatsRow())
        if self.alg == "astar":
            # the raw batch: A*'s counters measure the work done for
            # every query sent, duplicates included
            t1 = time.perf_counter()
            deadline = t1 + config.time / 1e9 if config.time else None
            for _ in range(max(config.itrs, 1)):
                cost, plen, fin, counters = self._answer_astar(
                    queries, config, difffile, deadline=deadline)
                if deadline is not None and time.perf_counter() > deadline:
                    break
            t2 = time.perf_counter()
            return cost, plen, fin, StatsRow(
                **counters, t_receive=t1 - t0, t_astar=t2 - t1,
                t_search=t2 - t0)
        # dedupe identical (s, t) pairs: the kernel walks each distinct
        # pair once and answers fan back out through `inverse`
        uniq, inverse = np.unique(queries, axis=0, return_inverse=True)
        inverse = inverse.reshape(-1)
        nu = len(uniq)
        # order by expected walk length (answers are unsorted back)
        order = np.argsort(
            length_estimate(self.graph, uniq[:, 0], uniq[:, 1]),
            kind="stable")
        unsort = np.argsort(order)
        qsorted = uniq[order]
        # pad to the next power of two: a few stable batch shapes; under
        # lanes to at least the lane count, so every batch splits evenly
        # (the extra rows are valid=False lanes)
        qpad = 1 << (nu - 1).bit_length()
        if self._lane_split:
            qpad = max(qpad, self.n_lanes)
        s = np.zeros(qpad, np.int32)
        t = np.zeros(qpad, np.int32)
        valid = np.zeros(qpad, bool)
        s[:nu] = qsorted[:, 0]
        t[:nu] = qsorted[:, 1]
        valid[:nu] = True
        rows = np.zeros(qpad, np.int32)
        rows[:nu] = self.dc.owned_index_of(qsorted[:, 1])
        t1 = time.perf_counter()
        # the table is epoch-gated a batch: a promoted epoch's table
        # serves only the batches naming its fused diff (_fm_for).
        # Compressed residency: a pack4 table feeds the pack4 kernel
        # directly; every other compressed batch (rle, pack4 with
        # extraction, any batch under lanes) inflates exactly the batch's
        # distinct target rows once and remaps the row ids onto that
        # dense block — bounded by the batch, freed with it,
        # bit-identical to the raw table
        fm_walk = fm_tbl = self._fm_for(difffile)
        packed4 = False
        if isinstance(fm_tbl, CompressedFM):
            if fm_tbl.codec == "pack4" and not extracting \
                    and not self._lane_split:
                fm_walk, packed4 = fm_tbl.packed, True
            else:
                urows, rinv = np.unique(rows[:nu], return_inverse=True)
                rpad = 1 << (len(urows) - 1).bit_length()
                rows_u = np.zeros(rpad, np.int32)
                rows_u[:len(urows)] = urows
                fm_walk = fm_tbl.decompress_rows(self._dev(rows_u))
                rows = np.zeros(qpad, np.int32)
                rows[:nu] = rinv.reshape(-1)

        placed = (self._placed(fm_walk, w_pad, pair) if self._lane_split
                  else None)

        def run_walk(sl: slice):
            if placed is not None:
                # one walk call a lane, on its slice of the sorted batch
                return walk_lanes(
                    self.dg, fm_walk, rows[sl], s[sl], t[sl], valid[sl],
                    w_pad, self.mesh, k_moves=config.k_moves, pair=pair,
                    placed=placed)
            return cuda_walk_batch(
                self.dg, fm_walk, self._dev(rows[sl]), self._dev(s[sl]),
                self._dev(t[sl]), w_pad, valid=self._dev(valid[sl]),
                k_moves=config.k_moves, packed4=packed4, pair=pair)

        deadline = t1 + config.time / 1e9 if config.time else None
        for _ in range(max(config.itrs, 1)):
            if deadline is None or qpad <= self.time_chunk:
                cost, plen, fin = (a.cpu().numpy()
                                   for a in run_walk(slice(0, qpad)))
            else:
                # ns budget truncates INSIDE the batch: the sorted batch
                # runs in fixed-size chunks — cheap queries first — with
                # the deadline checked between chunks. The first chunk
                # always runs; skipped chunks come back unfinished. One
                # chunk stays in flight ahead (launch k+1, then land k)
                ch = self.time_chunk          # pow2, divides qpad
                cost = np.zeros(qpad, np.int64)
                plen = np.zeros(qpad, np.int64)
                fin = np.zeros(qpad, bool)
                pending = None

                def _land(entry):
                    sl_p, outs = entry
                    cost[sl_p], plen[sl_p], fin[sl_p] = (
                        a.cpu().numpy() for a in outs)
                for off in range(0, qpad, ch):
                    if off and time.perf_counter() > deadline:
                        break
                    sl = slice(off, off + ch)
                    outs = run_walk(sl)
                    if pending is not None:
                        _land(pending)
                    pending = (sl, outs)
                if pending is not None:
                    _land(pending)
            if deadline is not None and time.perf_counter() > deadline:
                break
        if extracting:
            nodes, moves = extract_paths(
                self.dg, fm_walk, self._dev(rows), self._dev(s),
                self._dev(t), k=config.k_moves)
            nodes = nodes.cpu().numpy()[:nu].astype(np.int64)[unsort]
            moves = moves.cpu().numpy()[:nu].astype(np.int64)[unsort]
            self.last_paths = (nodes[inverse], moves[inverse])
        t2 = time.perf_counter()

        cost = np.asarray(cost[:nu], np.int64)[unsort][inverse]
        plen = np.asarray(plen[:nu], np.int64)[unsort][inverse]
        fin = np.asarray(fin[:nu], bool)[unsort][inverse]
        # sums per ORIGINAL query: taken after the fan-out
        stats = StatsRow(
            n_expanded=int(plen.sum()),   # node expansions = moves walked
            n_touched=nq,
            plen=int(plen.sum()),
            finished=int(fin.sum()),
            t_receive=t1 - t0,
            t_astar=t2 - t1,
            t_search=t2 - t0,
        )
        return cost, plen, fin, stats

    def _answer_astar(self, queries: np.ndarray, config: RuntimeConfig,
                      difffile: str = "-", deadline: float | None = None):
        """hscale/fscale weighted A*: the batched search on the engine's
        device (``ops.batched_astar.astar_batch_np``, K6 on the card) in
        ``time_chunk`` chunks, the deadline checked between chunks (the
        first always runs, the rest come back unfinished); under
        ``config.debug`` the per-query heap engine (``models.astar``),
        the deadline checked before each query. ``k_moves`` does not
        apply: "K-moves are only available with extractions while hScale
        only influences A*" (reference ``args.py:28``)."""
        w, cpu = self._raw_weights_for(difffile, config.no_cache)
        if not config.debug:
            if config.no_cache:
                # re-read the diff next time: its device copy goes too
                for k in [k for k in self._astar_ctx
                          if isinstance(k, tuple) and k[0] == "w_pad"]:
                    del self._astar_ctx[k]
            cost, plen, fin, counters = astar_batch_np(
                self.graph, queries, w, hscale=config.hscale,
                fscale=config.fscale, deadline=deadline, cpu=cpu,
                chunk=self.time_chunk, ctx=self._astar_ctx,
                w_key=None if config.no_cache else difffile,
                device=self.device)
            counters["plen"] = int(plen.sum())
            counters["finished"] = int(fin.sum())
            return cost, plen, fin, counters
        st = AstarStats()
        cost = np.zeros(len(queries), np.int64)
        plen = np.zeros(len(queries), np.int64)
        fin = np.zeros(len(queries), bool)
        for i, (s, t) in enumerate(queries):
            if deadline is not None and time.perf_counter() > deadline:
                break
            cost[i], plen[i], fin[i] = astar(
                self.graph, int(s), int(t), w, hscale=config.hscale,
                fscale=config.fscale, cpu=cpu, stats=st)
        counters = dict(
            n_expanded=st.n_expanded, n_inserted=st.n_inserted,
            n_touched=st.n_touched, n_updated=st.n_updated,
            n_surplus=st.n_surplus, plen=st.plen, finished=st.finished)
        return cost, plen, fin, counters
