"""Streamed CPD serving: answer campaigns whose index exceeds device memory.

Port of the JAX package's ``models/streamed.py``. The resident
:class:`~.cpd.CPDOracle` holds every worker's ``[W, R, N]`` first-move
table on one card, which stops fitting once ``W * R * N`` bytes outgrow
its memory: a 264k-node road graph is a 70 GB single-shard table. The
streamed oracle keeps the index on disk (the per-block ``.npy`` files are
the serving format) and, per campaign, uploads only the fm rows the
queries target, in bounded ``[C, N]`` row-chunks. Each uploaded chunk
answers every query aimed at its rows in one walk: on the card one launch
of the CUDA walk kernel a chunk (``ops.cuda_walk.cuda_walk_batch``, or
the fused multi-diff walk ``cuda_walk_multi`` for :meth:`query_multi`),
on the CPU their plain versions.

Row-chunks follow the JAX module: contiguous row ranges straight off the
mmap when the campaign's targets are dense (range mode), the distinct
target rows gathered otherwise (compacted mode, ``DOS_STREAM_RANGE_
DENSITY``). Uploaded chunks live on the device in a bounded LRU
(``cache_bytes``, by default a quarter of the card's memory), keyed
independently of the query-time weights: a diff round after a free-flow
round streams nothing, since fm rows hold free-flow first moves.

Wire codecs, best first, each falling back per chunk (the host encoders
are numpy copies of the JAX package's, so their arrays are byte-equal):

* transposed run-length (``DOS_STREAM_RLE``): runs along the target axis
  of each source column, ``lens`` uint8, ``vals`` int8, ``counts`` int32
  a column; persisted as ``rle-*.npz`` sidecars next to the block files
  (``DOS_STREAM_RLE_SIDECAR``), fingerprinted by the blocks' size and
  mtime, in the JAX package's names, keys and dtypes, so either package
  hits the other's;
* 4-bit nibbles with an exception list for slots >= 14
  (``DOS_STREAM_PACK4``);
* raw int8 rows.

The device decoders :func:`_unpack_rle` and :func:`_unpack4` are plain
torch (XLA stages in the JAX package, not Pallas kernels), indexing with
int64 throughout so a chunk of ``N * C >= 2**31`` cells decodes.

The host prepares chunk k+1 (read, encode, copy into pinned memory) while
the card decodes and walks chunk k: uploads are queued from pinned
buffers with ``non_blocking=True``, results land in pinned buffers behind
an event, and a chunk's results are read ``DEPTH`` chunks later. Each
campaign's seconds are split in :attr:`StreamedCPDOracle.last_seconds`.
"""

from __future__ import annotations

import hashlib
import os
import time
from collections import OrderedDict

import numpy as np
import torch

from ..data.graph import Graph
from ..ops.cuda_walk import cuda_walk_batch, cuda_walk_multi
from ..ops.device_graph import DeviceGraph
from ..ops.table_search import extract_paths, walk_eid_pairs, walk_pairs
from ..parallel.partition import DistributionController
from ..utils.device import resolve_device
from ..utils.env import env_cast, env_flag
from ..utils.log import get_logger
from .cpd import (
    length_estimate, read_manifest, shard_block_name, validate_manifest,
)
from .resident import is_container, maybe_decode_rows

log = get_logger(__name__)


#: 4-bit packed uploads: slots 0..13 pack directly into a nibble, 0xF is
#: the -1 "no move" marker, and 0xE escapes to a per-chunk exception list
#: (row, col, true slot) scattered on device after the nibble unpack — so
#: packing works for ANY degree, at half the wire bytes plus ~7 bytes per
#: exceptional entry.
PACK4_ESCAPE = 14
PACK4_MARKER = 15
#: skip packing when more than this fraction of a chunk's entries escape
#: (the nibble saves 0.5 bytes an entry; an exception costs up to ~14
#: with the pow2 padding: 0.5 / 14 ≈ 3.5%, rounded down)
PACK4_MAX_ESCAPE_FRAC = 0.03


def _unpack4(packed: torch.Tensor, n: int, exc_r: torch.Tensor,
             exc_c: torch.Tensor, exc_v: torch.Tensor) -> torch.Tensor:
    """[C, ceil(N/2)] uint8 nibbles -> [C, N] int8 fm, on their device.

    0xF -> -1; 0xE entries are overwritten by the exception triples.
    ``exc_r`` holds the wire's uint16 rows (as uint16, or their bytes as
    int16: torch indexes with no unsigned 16-bit type) and is widened to
    int64 here. Pad triples are ``(0, 0, fm[0, 0])``: every write to
    (0, 0) carries the same value, so the duplicate indices stay
    deterministic."""
    c = packed.shape[0]
    v = torch.stack([packed & 0xF, packed >> 4], dim=-1).reshape(c, -1)
    v = v[:, :n].to(torch.int8)
    v = torch.where(v == PACK4_MARKER, -1, v).contiguous()
    rows = exc_r.view(torch.int16).to(torch.int64) & 0xFFFF
    v[rows, exc_c.to(torch.int64)] = exc_v
    return v


def _pack4(fm_np: np.ndarray):
    """[C, N] int8 fm -> (packed nibbles, exc_rows, exc_cols, exc_vals)
    or None when too many entries escape (degenerate packing)."""
    if fm_np.shape[0] > 65536:
        # escape rows are uint16; a taller chunk would silently wrap
        # the scatter indices and corrupt unpacked moves — fall back
        return None
    esc_r, esc_c = np.nonzero(fm_np >= PACK4_ESCAPE)
    if len(esc_r) > PACK4_MAX_ESCAPE_FRAC * fm_np.size:
        return None
    a = fm_np.astype(np.uint8)
    a = np.where(fm_np < 0, np.uint8(PACK4_MARKER),
                 np.minimum(a, PACK4_ESCAPE))
    if a.shape[1] % 2:
        a = np.concatenate(
            [a, np.full((a.shape[0], 1), np.uint8(PACK4_MARKER))],
            axis=1)
    packed = a[:, 0::2] | (a[:, 1::2] << 4)
    exc_v = fm_np[esc_r, esc_c]
    # pad the exception list to a power of two (the JAX package's
    # compile-stable shape); pads are (0, 0, fm[0, 0]) identity writes
    # (see _unpack4). uint16 rows: the chunk axis is bounded by
    # row_chunk << 65536; cols span N and need int32.
    cap = 1 << max(int(len(esc_r)) - 1, 0).bit_length()
    cap = max(cap, 1)
    er = np.zeros(cap, np.uint16)
    ec = np.zeros(cap, np.int32)
    ev = np.full(cap, fm_np[0, 0], np.int8)
    er[:len(esc_r)] = esc_r
    ec[:len(esc_r)] = esc_c
    ev[:len(esc_r)] = exc_v
    return packed, er, ec, ev


#: Transposed run-length wire coding. A ``[C, N]`` chunk's row is "first
#: move toward one target FROM every source", and adjacent sources' slots
#: are uncorrelated; the coherence lives on the TARGET axis (nearby owned
#: targets are reached the same way from almost every source). So the
#: wire format run-length codes the TRANSPOSED chunk: per source column,
#: runs of consecutive target rows sharing a first move. Layout (flat, no
#: per-column padding): ``lens`` uint8 run lengths in column-major order
#: (runs > 255 split), ``vals`` int8 run first-moves, ``counts`` int32 runs
#: per column — ~2 bytes per run + 4 per column. Chunks fall back to
#: pack4/raw when runs are too short to pay (``RLE_MAX_FRAC`` of the best
#: dense alternative). The host encode is a few full passes over the raw
#: chunk, so the first miss of a range chunk persists the triple as an
#: ``rle-*.npz`` sidecar; later cold rounds read it instead of the rows.
RLE_MAX_FRAC = 0.9


def _pack_rle(fm_np: np.ndarray, pack4_viable: bool):
    """[C, N] int8 fm -> (lens u8 [T], vals i8 [T], counts i32 [N]) in
    TRANSPOSED (column-major, target-axis-runs) order, or None when the
    encoding would not beat the best dense upload (pack4 when viable,
    else raw)."""
    c, n = fm_np.shape
    if c < 2 or n == 0:
        return None
    dense = fm_np.size // 2 if pack4_viable else fm_np.size
    # cheap reject BEFORE the transposed copy: the total run count is
    # countable straight off the row-major array (runs only grow after
    # the 255-splits, so an over-budget count here is final)
    runs_min = int(np.count_nonzero(fm_np[1:] != fm_np[:-1])) + n
    if 2 * (1 << max(runs_min - 1, 0).bit_length()) + 4 * n >= \
            RLE_MAX_FRAC * dense:
        return None
    a = np.ascontiguousarray(fm_np.T)                    # [N, C]
    ch = np.empty((n, c), bool)
    ch[:, 0] = True
    ch[:, 1:] = a[:, 1:] != a[:, :-1]
    idx = np.flatnonzero(ch.reshape(-1))                 # run starts
    # exact budget after the 255-splits; each run costs 2 wire bytes
    # (+ the fixed 4/column)
    lengths = np.diff(idx, append=n * c)
    pieces = -(-lengths // 255)                          # uint8 splits
    tot = int(pieces.sum())
    cap = 1 << max(tot - 1, 0).bit_length()
    wire = 2 * cap + 4 * n
    if wire >= RLE_MAX_FRAC * dense:
        return None
    flat_vals = a.reshape(-1)[idx]
    plen = np.full(cap, 0, np.uint8)
    pval = np.full(cap, flat_vals[-1] if len(flat_vals) else 0, np.int8)
    # split runs longer than 255 into 255-length pieces + remainder;
    # continuation pieces repeat the run's value (delta 0 on device)
    last = np.cumsum(pieces) - 1
    pl = np.full(tot, 255, np.uint8)
    pl[last] = (lengths - 255 * (pieces - 1)).astype(np.uint8)
    plen[:tot] = pl
    pval[:tot] = np.repeat(flat_vals, pieces)
    counts = np.bincount(np.repeat(idx // c, pieces),
                         minlength=n).astype(np.int32)
    return plen, pval, counts


def _unpack_rle(plen: torch.Tensor, vals: torch.Tensor,
                counts: torch.Tensor, c: int) -> torch.Tensor:
    """Transposed-RLE wire triple -> [C, N] int8 fm, on their device.

    Each run's value delta lands at its global start in a zeroed int16
    ``[N * C]`` buffer, whose int16 prefix sum is the decoded column-major
    chunk (deltas telescope: every partial sum is a run value, so int16
    is exact). Real run starts are distinct, so an index assignment is
    exact; pad runs (length 0) start at ``N * C`` and are masked out.
    Every index is int64, so chunks of ``N * C >= 2**31`` cells decode."""
    dev = plen.device
    n = counts.shape[0]
    t = plen.shape[0]
    pl = plen.to(torch.int64)
    s = torch.cumsum(pl, 0) - pl                         # exclusive
    cnt = counts.to(torch.int64)
    coff = torch.cumsum(cnt, 0) - cnt                    # exclusive
    col = torch.searchsorted(
        coff, torch.arange(t, dtype=torch.int64, device=dev),
        right=True) - 1
    g_start = col * c + s - s[coff[col]]
    del pl, cnt, col
    v16 = vals.to(torch.int16)
    delta = v16.clone()
    delta[1:] -= v16[:-1]
    real = g_start < n * c
    out = torch.zeros(n * c, dtype=torch.int16, device=dev)
    out[g_start[real]] = delta[real]
    del g_start, delta, real, s, coff
    out = torch.cumsum(out, 0, dtype=torch.int16)
    fm = torch.empty((c, n), dtype=torch.int8, device=dev)
    fm.copy_(out.view(n, c).t())
    return fm


#: the torch dtype of each wire and lane array
_TORCH_DTYPES = {np.dtype(np.int8): torch.int8,
                 np.dtype(np.uint8): torch.uint8,
                 np.dtype(np.int16): torch.int16,
                 np.dtype(np.int32): torch.int32}


def default_cache_bytes(device) -> int:
    """Device-residency budget for cached fm row-chunks: a quarter of the
    card's memory (~20 GB on an 80 GB card); 1 GiB on the CPU, the JAX
    package's fallback when a backend reports no limit. Streaming exists
    for indexes bigger than the card, so the cache scales with it."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_properties(dev).total_memory // 4
    return 1 << 30


class StreamedCPDOracle:
    """Serve table-search queries from an on-disk CPD index, streaming
    only the rows each campaign needs.

    Parameters
    ----------
    graph      : the (free-flow) road graph
    controller : partition controller — must match the built index
    outdir     : CPD index directory (``index.json`` + block files)
    row_chunk  : fm rows resident per upload; the device-memory knob.
                 Working set ≈ ``row_chunk * N`` bytes of int8 fm plus the
                 decode buffers (~5x that while a chunk decodes) — e.g.
                 4096 rows x 264k nodes ≈ 1.1 GB a chunk.
    cache_bytes: device bytes of uploaded chunks kept in an LRU across
                 campaigns (0 disables; None → :func:`default_cache_bytes`).
    device     : None → ``cuda`` (raises without a GPU unless ``"cpu"``).
    """

    #: decoded compressed blocks kept host-side at once: the streamed
    #: oracle's contract is a bounded working set, and caching every
    #: decoded block would re-materialize the raw table exactly when
    #: compression matters most
    _DECODED_KEEP = 4
    #: chunks whose results are in flight before the oracle reads the
    #: oldest. Device residency is DEPTH in-flight chunks plus up to
    #: ``cache_bytes`` of cached ones (cached chunks stay after a drain:
    #: that is the point of the cache)
    DEPTH = 4

    def __init__(self, graph: Graph, controller: DistributionController,
                 outdir: str, row_chunk: int = 4096,
                 cache_bytes: int | None = None, device=None):
        self.device = resolve_device(device)
        self.graph = graph
        self.dc = controller
        self.outdir = outdir
        self.row_chunk = int(row_chunk)
        self.cache_bytes = (default_cache_bytes(self.device)
                            if cache_bytes is None else int(cache_bytes))
        self.dg = DeviceGraph.from_graph(graph, device=self.device)
        validate_manifest(read_manifest(outdir), controller, outdir)
        self._blocks: dict[tuple[int, int], np.ndarray] = {}
        # bounded LRUs: decoded compressed blocks (host) and uploaded
        # [C, N] chunks (device); insertion order is the recency order
        self._decoded: OrderedDict[tuple[int, int], np.ndarray] = \
            OrderedDict()
        self._chunk_cache: OrderedDict[tuple, torch.Tensor] = OrderedDict()
        #: the walk's pair tables: free flow's and the fused walk's
        #: edge-id table, made at first use (a diffed campaign builds its
        #: own once)
        self._ff_pair: torch.Tensor | None = None
        self._eid_pair: torch.Tensor | None = None
        self.pack4 = env_flag("DOS_STREAM_PACK4", True)
        self.rle = env_flag("DOS_STREAM_RLE", True)
        self.rle_sidecar = (self.rle
                            and env_flag("DOS_STREAM_RLE_SIDECAR", True))
        #: telemetry of the most recent campaign (the JAX package's keys)
        self.last_stats: dict = {}
        #: the most recent campaign's seconds: host ``read``, ``encode``,
        #: ``sidecar_read``/``sidecar_write``, ``stage`` (copies into
        #: pinned memory), ``drain_wait`` (the host waiting for results);
        #: on the card, by CUDA events, ``h2d`` (the queued uploads),
        #: ``decode`` and ``walk``
        self.last_seconds: dict = {}

    def clear_cache(self) -> None:
        """Drop every device-resident cached chunk (frees device memory;
        the next campaign re-streams from disk)."""
        self._chunk_cache.clear()

    def _cache_get(self, key):
        hit = self._chunk_cache.get(key)
        if hit is not None:
            self._chunk_cache.move_to_end(key)
        return hit

    def _cache_put(self, key, fm_d: torch.Tensor) -> None:
        if self.cache_bytes <= 0 or fm_d.nbytes > self.cache_bytes:
            return
        held = sum(v.nbytes for v in self._chunk_cache.values())
        while self._chunk_cache and held + fm_d.nbytes > self.cache_bytes:
            _, old = self._chunk_cache.popitem(last=False)
            held -= old.nbytes
        self._chunk_cache[key] = fm_d

    def _chunk_fingerprint(self, pairs) -> np.ndarray:
        """Stat fingerprint of the block files a chunk reads from:
        ``[bytes, mtime_ns]`` per (wid, bid) pair, ordered. A rebuilt
        index changes it, invalidating any persisted sidecar."""
        out = []
        for wid, bid in pairs:
            st = os.stat(os.path.join(self.outdir,
                                      shard_block_name(wid, bid)))
            out.append((st.st_size, st.st_mtime_ns))
        return np.asarray(out, np.int64)

    def _sidecar_load(self, path: str, fp: np.ndarray):
        """RLE wire triple from a sidecar; ``"fallback"`` when a valid
        sidecar records that this chunk measured incompressible; None
        when absent, stale or unreadable."""
        try:
            with np.load(path) as z:
                if z["fp"].shape == fp.shape and (z["fp"] == fp).all():
                    if "fallback" in z:
                        return "fallback"
                    return z["lens"], z["vals"], z["counts"]
        except Exception as e:  # noqa: BLE001 — corrupt zip, missing
            # keys, IO: any failure means "re-encode", never raise
            log.debug("RLE sidecar %s unusable (%s); re-encoding", path, e)
        return None

    def _sidecar_save(self, path: str, fp: np.ndarray, enc) -> None:
        """Persist a chunk's encoding (``enc=None``: the negative marker
        of an incompressible chunk) by tmp file and rename. A sidecar is
        a cache checked against the blocks' fingerprint at every read,
        not a durable write: no fsync, and any IO error (a read-only
        index dir, a full disk, a race) just skips it."""
        tmp = f"{path}.{os.getpid()}.tmp.npz"       # savez keeps .npz
        try:
            if enc is None:
                np.savez(tmp, fp=fp, fallback=np.int8(1))
            else:
                np.savez(tmp, fp=fp, lens=enc[0], vals=enc[1],
                         counts=enc[2])
            os.replace(tmp, path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass

    def _block(self, wid: int, bid: int) -> np.ndarray:
        """Memory-mapped block file (cached handle, not cached data).
        Compressed-container blocks decode on touch into the small
        ``_DECODED_KEEP`` LRU."""
        key = (wid, bid)
        hit = self._decoded.get(key)
        if hit is not None:
            self._decoded.move_to_end(key)
            return hit
        if key not in self._blocks:
            self._blocks[key] = np.load(
                os.path.join(self.outdir, shard_block_name(wid, bid)),
                mmap_mode="r")
        arr = self._blocks[key]
        if is_container(arr):
            arr = maybe_decode_rows(arr)
            self._decoded[key] = arr
            while len(self._decoded) > self._DECODED_KEEP:
                self._decoded.popitem(last=False)
        return arr

    def _row_range(self, wid: int, r0: int, count: int) -> np.ndarray:
        """Contiguous owned-row slice [count, N] (tail-padded with stuck
        rows past the worker's last row). A single block's slice is a
        zero-copy view of its mmap."""
        bs = self.dc.block_size
        hi = min(r0 + count, self.dc.n_owned(wid))
        parts = []
        r = r0
        while r < hi:
            bid = r // bs
            stop = min(hi, (bid + 1) * bs)
            parts.append(self._block(wid, bid)[r - bid * bs:
                                               stop - bid * bs])
            r = stop
        if len(parts) == 1 and hi - r0 == count:
            return parts[0]
        out = np.full((count, self.graph.n), -1, np.int8)
        if parts:
            seg = parts[0] if len(parts) == 1 else np.concatenate(parts)
            out[:hi - r0] = seg
        return out

    def _gather_rows(self, wids: np.ndarray, rows: np.ndarray) -> np.ndarray:
        """Host-side gather of fm rows (wid, owned-row) -> [C, N] int8."""
        bs = self.dc.block_size
        out = np.empty((len(rows), self.graph.n), np.int8)
        bids = rows // bs
        # group by (wid, bid) so each mmapped file is fancy-indexed once
        order = np.lexsort((rows, bids, wids))
        i = 0
        while i < len(order):
            j = i
            wid, bid = wids[order[i]], bids[order[i]]
            while (j < len(order) and wids[order[j]] == wid
                   and bids[order[j]] == bid):
                j += 1
            sel = order[i:j]
            out[sel] = self._block(int(wid), int(bid))[rows[sel] - bid * bs]
            i = j
        return out

    # ------------------------------------------------------------ serving
    def query(self, queries: np.ndarray, w_query: np.ndarray | None = None,
              k_moves: int = -1, max_steps: int = 0):
        """Answer (s, t) queries in input order: ``(cost, plen,
        finished)`` int64/bool ``[Q]``, the resident :meth:`~.cpd.
        CPDOracle.query` semantics exactly; only the memory plan differs.
        One walk launch a chunk."""
        if w_query is None:
            w_pad, pair = self.dg.w_pad, self._free_flow_pair()
        else:
            w_pad = torch.as_tensor(self.graph.padded_weights(w_query),
                                    dtype=torch.int32, device=self.device)
            pair = walk_pairs(self.dg, w_pad)
        return self._campaign(queries, (w_pad, pair), None, k_moves,
                              max_steps)

    def query_paths(self, queries: np.ndarray, k: int):
        """Each query's first ``k`` path nodes from the streamed index
        (``ops.table_search.extract_paths`` on each uploaded chunk):
        ``(nodes int64 [Q, k+1], moves int64 [Q])``, the resident
        :meth:`~.cpd.CPDOracle.query_paths` semantics."""
        if k <= 0:
            raise ValueError("k must be positive")
        return self._campaign(queries, None, None, -1, 0, paths_k=k)

    def query_multi(self, queries: np.ndarray,
                    w_diffs: list[np.ndarray | None], max_steps: int = 0):
        """Answer queries under D congestion diffs in ONE streamed pass:
        each chunk is walked once by the fused walk and every diff's
        costs are summed together. Returns ``(cost [D, Q], plen [Q],
        finished [Q])`` in input order."""
        if not w_diffs:
            raise ValueError("w_diffs must name at least one round")
        w_pads = torch.as_tensor(self.graph.padded_weights_multi(w_diffs),
                                 dtype=torch.int32, device=self.device)
        if self._eid_pair is None:
            self._eid_pair = walk_eid_pairs(self.dg)
        return self._campaign(queries, None, (w_pads, self._eid_pair), -1,
                              max_steps)

    def _free_flow_pair(self) -> torch.Tensor:
        if self._ff_pair is None:
            self._ff_pair = walk_pairs(self.dg, self.dg.w_pad)
        return self._ff_pair

    def _host_copies(self, arrays) -> list[torch.Tensor]:
        """Host arrays as fresh tensors: in pinned memory on the card (so
        their uploads can be queued), plain on the CPU (where the copy is
        the tensor the walk reads). uint16 arrays travel as their int16
        bytes."""
        out = []
        for arr in arrays:
            if arr.dtype == np.uint16:
                arr = arr.view(np.int16)
            host = torch.empty(arr.shape, dtype=_TORCH_DTYPES[arr.dtype],
                               pin_memory=self.device.type == "cuda")
            host.numpy()[...] = arr
            out.append(host)
        return out

    def _upload(self, hosts: list[torch.Tensor],
                keep: list) -> list[torch.Tensor]:
        """Queue the uploads of pinned tensors (``non_blocking``), holding
        each in ``keep`` until the chunk's results are read; CPU tensors
        are returned as they are."""
        if self.device.type != "cuda":
            return hosts
        keep.extend(hosts)
        return [h.to(self.device, non_blocking=True) for h in hosts]

    def _campaign(self, queries, single, multi, k_moves, max_steps,
                  paths_k: int = 0):
        """Shared streamed-campaign driver. ``single`` = ``(w_pad, pair)``
        selects the walk, ``multi`` = ``(w_pads, eid_pair)`` the fused
        multi-diff walk, neither (``paths_k`` > 0) path-prefix
        extraction."""
        queries = np.asarray(queries, np.int64)
        nq = len(queries)
        s_all, t_all = queries[:, 0], queries[:, 1]
        n_multi = 0 if multi is None else int(multi[0].shape[0])
        cuda = self.device.type == "cuda"
        secs = dict.fromkeys(("read", "encode", "sidecar_read",
                              "sidecar_write", "stage", "drain_wait"), 0.0)
        # (name, start, end) CUDA event pairs, read after the last drain
        spans: list[tuple[str, torch.cuda.Event, torch.cuda.Event]] = []

        def timed(name, fn, *a, **kw):
            if not cuda:
                return fn(*a, **kw)
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
            out = fn(*a, **kw)
            ev1.record()
            spans.append((name, ev0, ev1))
            return out

        # distinct targets, ordered block-contiguously for the host gather
        uniq_t, inv = np.unique(t_all, return_inverse=True)
        u_wid = self.dc.worker_of(uniq_t)
        u_row = self.dc.owned_index_of(uniq_t)
        c = self.row_chunk

        # chunking mode: dense campaigns upload CONTIGUOUS row ranges
        # straight off the mmap, sparse ones compact the distinct rows
        thresh = env_cast("DOS_STREAM_RANGE_DENSITY", 0.45, float)
        n_range = max(-(-max(self.dc.max_owned, 1) // c), 1)
        rkey = u_wid.astype(np.int64) * n_range + u_row // c
        uniq_key = np.unique(rkey)
        density = (len(uniq_t) / (len(uniq_key) * c)
                   if len(uniq_key) else 1.0)
        range_mode = density >= thresh

        if range_mode:
            chunk_of_uniq = np.searchsorted(uniq_key, rkey)
            r0_of_chunk = (uniq_key % n_range) * c
            wid_of_chunk = uniq_key // n_range
            q_chunk = chunk_of_uniq[inv]
            q_row = u_row[inv] - r0_of_chunk[q_chunk]
            n_chunks = len(uniq_key)
        else:
            u_order = np.lexsort((u_row, u_wid))
            pos_of_uniq = np.empty(len(uniq_t), np.int64)
            pos_of_uniq[u_order] = np.arange(len(uniq_t))
            q_pos = pos_of_uniq[inv]          # stream position per query
            q_chunk = q_pos // c
            q_row = q_pos % c
            n_chunks = -(-len(uniq_t) // c) if len(uniq_t) else 0

        if paths_k:
            out_nodes = np.zeros((nq, paths_k + 1), np.int64)
        out_c = np.zeros((n_multi, nq) if n_multi else nq, np.int64)
        out_p = np.zeros(nq, np.int64)
        out_f = np.zeros(nq, bool)
        stats = dict.fromkeys(("bytes_streamed", "bytes_raw", "cache_hits",
                               "cache_misses", "chunks_packed",
                               "chunks_rle", "sidecar_hits"), 0)
        # one sort up front; each chunk's queries are then a slice
        q_by_chunk = np.argsort(q_chunk, kind="stable")
        bounds = np.searchsorted(q_chunk[q_by_chunk],
                                 np.arange(n_chunks + 1))
        def upload(arrays, keep):
            t0 = time.perf_counter()
            hosts = self._host_copies(arrays)
            secs["stage"] += time.perf_counter() - t0
            return timed("h2d", self._upload, hosts, keep)

        def read_chunk(ci, keep):
            """The chunk's fm on the device: from the LRU, else read
            (or its sidecar), encoded, uploaded and decoded."""
            if range_mode:
                wid_c, r0_c = int(wid_of_chunk[ci]), int(r0_of_chunk[ci])
                key = (wid_c, r0_c, c)
            else:
                take = u_order[ci * c:(ci + 1) * c]
                key = ("compacted", c,
                       hashlib.blake2b(u_wid[take].tobytes()
                                       + u_row[take].tobytes(),
                                       digest_size=16).digest())
            fm_dev = self._cache_get(key)
            if fm_dev is not None:
                stats["cache_hits"] += 1
                return fm_dev
            stats["cache_misses"] += 1
            # sidecars persist for RANGE chunks only: their names are
            # bounded by the index's row ranges, while compacted chunks
            # are per-campaign row sets that would grow the dir unbounded
            sc_path = fp = rk = None
            if self.rle_sidecar and range_mode:
                t0 = time.perf_counter()
                bs = self.dc.block_size
                hi = min(r0_c + c, self.dc.n_owned(wid_c))
                pairs = [(wid_c, b)
                         for b in range(r0_c // bs, (hi - 1) // bs + 1)]
                sc_path = os.path.join(
                    self.outdir, f"rle-w{wid_c:05d}-r{r0_c:09d}-c{c}.npz")
                fp = self._chunk_fingerprint(pairs)
                rk = self._sidecar_load(sc_path, fp)
                if rk is not None:
                    stats["sidecar_hits"] += 1
                secs["sidecar_read"] += time.perf_counter() - t0
            skip_rle = isinstance(rk, str)           # "fallback" marker
            if skip_rle:
                rk = None
            if rk is None:
                t0 = time.perf_counter()
                if range_mode:
                    fm_np = self._row_range(wid_c, r0_c, c)
                else:
                    fm_np = self._gather_rows(u_wid[take], u_row[take])
                    if len(take) < c:     # stable chunk shape: pad
                        fm_np = np.concatenate(  # with stuck rows
                            [fm_np, np.full((c - len(take), self.graph.n),
                                            -1, np.int8)])
                t1 = time.perf_counter()
                secs["read"] += t1 - t0
                # wire coding, best first: transposed RLE, then 4-bit
                # pack, then raw (RLE's break-even assumes pack4 would
                # succeed whenever it is enabled)
                rk = (_pack_rle(fm_np, self.pack4)
                      if self.rle and not skip_rle else None)
                secs["encode"] += time.perf_counter() - t1
                if sc_path is not None and not skip_rle:
                    # persist the encoding OR the negative result, so an
                    # incompressible chunk does not re-pay the attempt
                    t0 = time.perf_counter()
                    self._sidecar_save(sc_path, fp, rk)
                    secs["sidecar_write"] += time.perf_counter() - t0
            t0 = time.perf_counter()
            pk = None
            if rk is None and self.pack4:
                pk = _pack4(fm_np)
                secs["encode"] += time.perf_counter() - t0
            wire = rk if rk is not None else pk if pk is not None \
                else (fm_np,)
            staged = upload(wire, keep)
            if rk is not None:
                fm_dev = timed("decode", _unpack_rle, *staged, c=c)
                stats["chunks_rle"] += 1
            elif pk is not None:
                fm_dev = timed("decode", _unpack4, staged[0], self.graph.n,
                               *staged[1:])
                stats["chunks_packed"] += 1
            else:
                fm_dev = staged[0]
            stats["bytes_streamed"] += sum(a.nbytes for a in wire)
            stats["bytes_raw"] += c * self.graph.n
            self._cache_put(key, fm_dev)
            return fm_dev

        def drain(entry):
            """Scatter one finished chunk's results into the outputs."""
            q_idx, host, event, _inputs = entry
            t0 = time.perf_counter()
            if event is not None:
                event.synchronize()
            secs["drain_wait"] += time.perf_counter() - t0
            got = [h.numpy() for h in host]
            if paths_k:
                out_nodes[q_idx], out_p[q_idx] = got
                return
            cost, plen, fin = got
            if n_multi:
                out_c[:, q_idx] = cost
            else:
                out_c[q_idx] = cost
            out_p[q_idx], out_f[q_idx] = plen, fin

        # (q_idx, host results, event, pinned inputs) per chunk in flight
        pending = []
        for ci in range(n_chunks):
            keep: list[torch.Tensor] = []
            fm_d = read_chunk(ci, keep)
            q_idx = q_by_chunk[bounds[ci]:bounds[ci + 1]]
            # order by expected walk length so similar lanes sit together
            # (never affects answers)
            est = length_estimate(self.graph, s_all[q_idx], t_all[q_idx])
            q_idx = q_idx[np.argsort(est, kind="stable")]
            rows_d, s_d, t_d = upload(
                [np.ascontiguousarray(a, np.int32)
                 for a in (q_row[q_idx], s_all[q_idx], t_all[q_idx])], keep)
            if paths_k:
                outs = timed("walk", extract_paths, self.dg, fm_d, rows_d,
                             s_d, t_d, k=paths_k)
            elif n_multi:
                outs = timed("walk", cuda_walk_multi, self.dg, fm_d, rows_d,
                             s_d, t_d, multi[0], max_steps=max_steps,
                             pair=multi[1])
            else:
                outs = timed("walk", cuda_walk_batch, self.dg, fm_d, rows_d,
                             s_d, t_d, single[0], k_moves=k_moves,
                             max_steps=max_steps, pair=single[1])
            event = None
            if cuda:
                host = [torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
                        for o in outs]
                for h, o in zip(host, outs):
                    h.copy_(o, non_blocking=True)
                event = torch.cuda.Event()
                event.record()
            else:
                host = list(outs)
            pending.append((q_idx, host, event, keep))
            if len(pending) >= self.DEPTH:
                drain(pending.pop(0))
        for entry in pending:
            drain(entry)
        for name, ev0, ev1 in spans:
            secs[name] = secs.get(name, 0.0) + ev0.elapsed_time(ev1) / 1e3
        self.last_seconds = secs
        self.last_stats = {
            "n_queries": nq,
            "distinct_targets": int(len(uniq_t)),
            "row_chunks": n_chunks,
            # wire bytes actually uploaded; bytes_raw = the unpacked fm
            # bytes those chunks represent
            "bytes_streamed": int(stats["bytes_streamed"]),
            "bytes_raw": int(stats["bytes_raw"]),
            # the codecs enabled; the chunk counts say which ran
            "pack4": self.pack4,
            "rle": self.rle,
            "chunks_packed": stats["chunks_packed"],
            "chunks_rle": stats["chunks_rle"],
            "sidecar_hits": stats["sidecar_hits"],
            "cache_hits": stats["cache_hits"],
            "cache_misses": stats["cache_misses"],
            "mode": "range" if range_mode else "compacted",
        }
        if paths_k:
            return out_nodes, out_p
        return out_c, out_p, out_f
