"""Per-shard query engine: the worker-resident compute path.

Role parity with the reference's resident ``fifo_auto`` process: load the
graph and THIS worker's CPD shard onto one device, then answer query
batches for targets this shard owns with the table-search walk — on the
card through the hand-written CUDA kernel (``ops.cuda_walk``), on the CPU
through the plain torch walk. Port of the JAX package's
``worker/engine.py`` for ``alg="table-search"`` with raw residency on one
device.

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

Not ported: A*, worker lane meshes, compressed residency, path
signatures (``sig_k``), index promotion, observability hooks and
self-healing (a corrupt block raises instead of being rebuilt).
"""

from __future__ import annotations

import glob
import os
import re
import time
from collections import OrderedDict

import numpy as np
import torch

from ..data.formats import read_diff
from ..data.graph import Graph
from ..models.cpd import (
    check_manifest_version, length_estimate, load_verified_block,
    read_manifest, shard_block_name,
)
from ..ops.cuda_walk import cuda_walk_batch
from ..ops.device_graph import DeviceGraph
from ..ops.table_search import extract_paths
from ..parallel.partition import DistributionController
from ..transport.wire import RuntimeConfig, StatsRow
from ..utils.device import resolve_device
from ..utils.env import env_cast
from ..utils.log import get_logger, set_worker_id

log = get_logger(__name__)


def _block_id(path: str) -> int:
    return int(re.search(r"-b(\d+)\.npy$", path).group(1))


def load_shard_rows(outdir: str, wid: int) -> np.ndarray:
    """Load one worker's CPD rows from the block files the build wrote
    (``cpd-w<wid>-b<bid>.npy``; the index manifest is optional so a
    shard can serve before the whole cluster's build completes).

    When the manifest is present its per-block digests are verified as
    the rows load; a corrupt or missing block raises ``ValueError`` with
    the per-block diagnostic instead of serving garbage answers."""
    manifest: dict | None = None
    try:
        manifest = read_manifest(outdir)
    except (OSError, ValueError):
        pass                       # pre-manifest partial build: no digests
    if manifest is not None:
        check_manifest_version(manifest, outdir)
    blocks_meta = (manifest or {}).get("blocks", {})
    prefix = shard_block_name(wid, 0)[:-len("00000.npy")]
    files = sorted(glob.glob(os.path.join(outdir, f"{prefix}*.npy")),
                   key=_block_id)
    # the manifest knows blocks the glob cannot see (deleted on disk)
    manifested = sorted((os.path.join(outdir, f) for f in blocks_meta
                         if f.startswith(prefix)), key=_block_id)
    files = manifested if manifested else files
    if not files:
        raise FileNotFoundError(f"no CPD blocks for worker {wid} in {outdir}")
    parts = []
    for path in files:
        fname = os.path.basename(path)
        rows, status, reason = load_verified_block(path,
                                                   blocks_meta.get(fname))
        if rows is None:
            raise ValueError(f"CPD block {fname} in {outdir} is {status}: "
                             f"{reason} (rebuild the shard to heal it)")
        parts.append(rows)
    return parts[0] if len(parts) == 1 else np.concatenate(parts, axis=0)


class ShardEngine:
    """One worker's resident shard on one device, answering
    ``table-search`` batches. ``device``: None → ``cuda`` (raises
    without a GPU unless ``device="cpu"``)."""

    def __init__(self, graph: Graph, dc: DistributionController, wid: int,
                 outdir: str, alg: str = "table-search", device=None):
        if alg != "table-search":
            raise ValueError(f"algorithm {alg!r} is not ported (only "
                             "table-search)")
        self.device = resolve_device(device)
        self.alg = alg
        self.graph = graph
        self.dc = dc
        self.wid = wid
        self.outdir = outdir
        rows = load_shard_rows(outdir, self.wid)
        owned = dc.owned(self.wid)
        if len(owned) != rows.shape[0]:
            raise ValueError(
                f"shard w{self.wid}: {rows.shape[0]} CPD rows but "
                f"controller owns {len(owned)} nodes — partition mismatch")
        self.fm = torch.from_numpy(rows).to(self.device)
        self.dg = DeviceGraph.from_graph(graph, device=self.device)
        #: per-diff device weight buffers, LRU-bounded (≥ 2: the double
        #: buffer an epoch swap needs); a re-upload after eviction is a
        #: read + transfer, never a correctness event
        self._weight_cache: OrderedDict[str, torch.Tensor] = OrderedDict()
        self._weight_keep = max(
            2, env_cast("DOS_TRAFFIC_WEIGHT_EPOCHS", 4, int))
        #: device-batch rows per deadline-checked chunk
        self.time_chunk = 1024
        #: path prefixes of the most recent extract batch (see answer())
        self.last_paths: tuple[np.ndarray, np.ndarray] | None = None

    # ------------------------------------------------------------ weights
    def _weights_for(self, difffile: str, no_cache: bool) -> torch.Tensor:
        if difffile in self._weight_cache and not no_cache:
            self._weight_cache.move_to_end(difffile)
            return self._weight_cache[difffile]
        if difffile == "-":
            w_pad = self.dg.w_pad
        else:
            w = self.graph.weights_with_diff(read_diff(difffile))
            w_pad = torch.as_tensor(self.graph.padded_weights(w),
                                    dtype=torch.int32, device=self.device)
        if no_cache:
            self._weight_cache.clear()
        else:
            self._weight_cache[difffile] = w_pad
            while len(self._weight_cache) > self._weight_keep:
                self._weight_cache.popitem(last=False)
        return w_pad

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
            if (owner != self.wid).any():
                bad = int((owner != self.wid).sum())
                raise ValueError(
                    f"shard w{self.wid} received {bad} queries for "
                    "other workers — routing invariant violated")
        w_pad = self._weights_for(difffile, config.no_cache)
        nq = len(queries)
        extracting = config.extract and config.k_moves > 0
        if nq == 0:
            if extracting:
                self.last_paths = (
                    np.zeros((0, config.k_moves + 1), np.int64),
                    np.zeros(0, np.int64))
            return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                    np.zeros(0, bool), StatsRow())
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
        # pad to the next power of two: a few stable batch shapes
        qpad = 1 << (nu - 1).bit_length()
        s = np.zeros(qpad, np.int32)
        t = np.zeros(qpad, np.int32)
        valid = np.zeros(qpad, bool)
        s[:nu] = qsorted[:, 0]
        t[:nu] = qsorted[:, 1]
        valid[:nu] = True
        rows = np.zeros(qpad, np.int32)
        rows[:nu] = self.dc.owned_index_of(qsorted[:, 1])
        t1 = time.perf_counter()

        def run_walk(sl: slice):
            return cuda_walk_batch(
                self.dg, self.fm, self._dev(rows[sl]), self._dev(s[sl]),
                self._dev(t[sl]), w_pad, valid=self._dev(valid[sl]),
                k_moves=config.k_moves)

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
                self.dg, self.fm, self._dev(rows), self._dev(s),
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
