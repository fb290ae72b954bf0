"""One worker's CPD shard: build, persist, verify, load.

The Compressed Path Database is a ``[R, N]`` int8 first-move table per
worker (owned-target row × node). This module is the single-shard part of
the JAX package's ``models/cpd.py``:

* :func:`build_worker_shard` — the per-worker build (reference
  ``make_cpd_auto``, ``make_cpds.py:20``): the owned targets in
  ``chunk``-row batches through the ELL Bellman-Ford build
  (``ops.bellman_ford.build_fm_columns``) on one device, one ``.npy``
  file per controller block, each written atomically and journaled with
  its crc32 digest in the per-worker build ledger. A ``codec`` persists
  each block as a compressed container (``models.resident``). The loop
  is serial: no background stager, lane mesh, RLE fetch, replica or
  epoch.
* :func:`write_index_manifest` / :func:`read_manifest` /
  :func:`validate_manifest` / :func:`check_manifest_version` /
  :func:`load_verified_block` — the ``index.json`` manifest (schema v2,
  per-block digests) and digest-checked block loads. File names,
  digests, the manifest schema and the compressed containers are the
  JAX package's, so an index built by either package loads under the
  other.
"""

from __future__ import annotations

import glob
import io
import json
import os
import time

import numpy as np
import torch

from ..data.graph import Graph
from ..ops.bellman_ford import build_fm_columns
from ..ops.device_graph import DeviceGraph
from ..parallel.partition import DistributionController
from ..utils.atomicio import (
    SWEEP_MIN_AGE_S, TMP_SUFFIX, AtomicNpyWriter, atomic_write_json,
    digest_bytes, digest_file,
)
from ..utils.device import resolve_device
from ..utils.log import get_logger
from .resident import (
    block_codec, encode_block, is_container, resident_choice,
)

log = get_logger(__name__)

#: manifest schema version. v2 adds per-block content digests + shapes
#: (``blocks``) and ``digest_algo``; readers tolerate unknown keys, so a
#: bump is MAJOR only when existing keys change meaning — v1 indexes
#: load under v2 code, v(N+1) indexes are rejected by vN code.
INDEX_VERSION = 2


def shard_block_name(wid: int, bid: int) -> str:
    """Block file name of worker ``wid``'s block ``bid`` (primary copy)."""
    return f"cpd-w{wid:05d}-b{bid:05d}.npy"


def ledger_path(outdir: str, wid: int) -> str:
    return os.path.join(outdir, f"build-w{wid:05d}.ledger")


class BuildLedger:
    """Per-worker build journal: one JSON line per completed,
    digest-valid block.

    A block counts as done only when its line is in the journal AND the
    file on disk still matches the recorded digest. Appends are
    flushed+fsynced per line; a torn trailing line (crash mid-append)
    is skipped on read. Later entries for the same file win."""

    def __init__(self, outdir: str, wid: int):
        self.path = ledger_path(outdir, wid)

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
               codec: str | None = None) -> None:
        """Journal one completed block. ``codec`` records a compressed
        block's encoding so the manifest harvest can carry it; raw blocks
        omit the key, keeping their ledger lines unchanged."""
        ent = {"file": fname, "digest": digest,
               "shape": list(shape), "dtype": dtype}
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
    except (OSError, ValueError) as e:
        log.debug("unledgered block %s unreadable (%s); rebuilding",
                  fname, e)
        return False


def length_estimate(graph: Graph, s: np.ndarray, t: np.ndarray):
    """Cheap host-side walk-length predictor: L1 coordinate distance.
    Used only to ORDER queries so similar lengths sit together — never
    affects answers."""
    xs, ys = graph.xs, graph.ys
    return np.abs(xs[s] - xs[t]) + np.abs(ys[s] - ys[t])


def build_worker_shard(graph: Graph, dc: DistributionController, wid: int,
                       outdir: str, chunk: int = 0,
                       device=None, codec: str | None = None) -> list[str]:
    """Build and persist ONE worker's CPD block files on one device.

    The owned targets run through the ELL build in ``chunk``-row batches
    (0 = the whole shard in one batch; the last batch is padded with
    ``-1`` targets to the fixed width) and each controller block
    (``dc.block_size`` rows) is written as ``cpd-w<wid>-b<bid>.npy``
    through an atomic write, journaled with its digest in the build
    ledger. A re-run resumes: blocks the ledger records as complete
    with a matching on-disk digest are skipped. ``device``: None →
    ``cuda`` (raises without a GPU unless ``device="cpu"``). ``codec``
    (``raw``/``pack4``/``rle``/``auto``; None → ``DOS_CPD_RESIDENT``)
    writes each block as a compressed container (``encode_block``); a
    block whose rows the codec cannot take is written raw. Returns the
    file names written.
    """
    dev = resolve_device(device)
    os.makedirs(outdir, exist_ok=True)
    # sweep THIS worker's atomic-write debris from a killed build (old
    # enough not to be a live write by a concurrent same-wid process)
    now = time.time()
    for p in glob.glob(os.path.join(
            outdir, f"cpd-w{wid:05d}-b*{TMP_SUFFIX}.*")):
        try:
            if now - os.path.getmtime(p) >= SWEEP_MIN_AGE_S:
                os.remove(p)
        except OSError:
            pass
    owned = dc.owned(wid)
    bs = dc.block_size
    n_blocks = (len(owned) + bs - 1) // bs
    ledger = BuildLedger(outdir, wid)
    entries = ledger.entries()
    missing = [bid for bid in range(n_blocks)
               if not block_complete(outdir, shard_block_name(wid, bid),
                                     entries)]
    if len(missing) < n_blocks:
        log.info("worker %d build resume: %d/%d block(s) already "
                 "complete and digest-valid", wid, n_blocks - len(missing),
                 n_blocks)
    if not missing:
        return []
    dg = DeviceGraph.from_graph(graph, device=dev)
    chunk = chunk if chunk > 0 else max(len(owned), 1)
    codec_req = resident_choice() if codec is None else codec
    written = []
    for bid in missing:
        blk = owned[bid * bs: min((bid + 1) * bs, len(owned))]
        parts = []
        for i in range(0, len(blk), chunk):
            part = blk[i:i + chunk]
            pad = np.full(chunk, -1, np.int32)   # fixed batch width
            pad[:len(part)] = part
            fm = build_fm_columns(dg, torch.from_numpy(pad).to(dev))
            parts.append(fm[:len(part)].cpu().numpy())
        arr = parts[0] if len(parts) == 1 else np.concatenate(parts)
        # the container goes through the same atomic writer: digest and
        # ledger cover the container bytes
        enc = encode_block(arr, codec_req)
        arr, blk_codec = enc if enc is not None else (arr, None)
        fname = shard_block_name(wid, bid)
        writer = AtomicNpyWriter(os.path.join(outdir, fname))
        try:
            digest = writer.commit(arr)
        except BaseException:
            writer.abort()
            raise
        # a kill between the commit and the ledger line leaves a complete
        # un-journaled file, which the resume check accepts if it parses
        ledger.record(fname, digest, arr.shape, str(arr.dtype),
                      codec=blk_codec)
        written.append(fname)
    return written


def _block_meta_for(outdir: str, fname: str,
                    ledgers: dict[int, dict]) -> dict:
    """Digest/shape/dtype (and a compressed block's codec) for one block
    file, cheapest source first: the worker's build ledger, else read the
    file once."""
    wid = int(fname.split("-")[1][1:])
    if wid not in ledgers:
        ledgers[wid] = BuildLedger(outdir, wid).entries()
    ent = ledgers[wid].get(fname)
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
                         workers=None) -> dict:
    """Write ``index.json`` describing a per-block CPD index, atomically.

    Records per-block content digests, shapes and dtypes under
    ``blocks`` (harvested from the build ledgers, else read from disk).
    ``workers``: optional subset of worker ids — a PARTIAL index for
    single-worker serving (the reference's ``-w`` filter)."""
    files = []
    bs = dc.block_size
    for wid in (range(dc.maxworker) if workers is None else workers):
        for bid in range((dc.n_owned(wid) + bs - 1) // bs):
            fname = shard_block_name(wid, bid)
            if not os.path.exists(os.path.join(outdir, fname)):
                raise FileNotFoundError(
                    f"index incomplete: missing {fname} "
                    f"(worker {wid} block {bid})")
            files.append(fname)
    ledgers: dict[int, dict] = {}
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
        "blocks": {f: _block_meta_for(outdir, f, ledgers) for f in files},
    }
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


def load_verified_block(path: str, meta: dict | None):
    """Load one block with verification in a SINGLE file read; returns
    ``(block | None, status, reason)`` with status ``ok``
    (digest-verified), ``unverified`` (parses, no digest to check — v1
    manifest), ``missing`` or ``corrupt``; the block is None for the last
    two. A compressed container comes back as it is (``maybe_decode_rows``
    inflates it); when the manifest names a codec, the container's header
    must parse and name the same one, else the block is ``corrupt``."""
    if not os.path.exists(path):
        return None, "missing", "file absent"
    need_digest = bool(meta and meta.get("digest"))
    try:
        with open(path, "rb") as f:
            data = f.read()
        got = digest_bytes(data) if need_digest else None
        arr = np.load(io.BytesIO(data))
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
    except (OSError, ValueError, EOFError) as e:
        return None, "corrupt", f"unreadable: {type(e).__name__}: {e}"
    return arr, ("ok" if need_digest else "unverified"), ""
