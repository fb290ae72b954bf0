"""Crash-safe artifact IO: atomic writes, content digests, debris sweep.

The CPD index *is* the system checkpoint: build once, serve statelessly,
reload on restart. That contract only holds if no observable artifact is
ever torn — a build killed mid-``np.save`` must not leave a half-written
block that later loads as garbage. Every artifact writer goes through
one discipline:

1. write the full payload to ``<path>.tmp.<pid>`` in the same directory;
2. ``fsync`` the temp file (the bytes are durable before the name is);
3. ``os.rename`` onto the final name (atomic on POSIX: readers see the
   old file or the new file, never a prefix);
4. ``fsync`` the directory so the rename itself survives a power cut.

A crash between (1) and (3) leaves only ``*.tmp.*`` debris, which
:func:`sweep_stale_artifacts` removes at build start.

Digests are ``crc32:<8 hex>`` over the FULL ``.npy`` file bytes — the
same bytes and the same checksum as the JAX package writes, so an index
built by either package verifies under the other.
"""

from __future__ import annotations

import contextlib
import glob
import io
import json
import os
import time
import zlib

import numpy as np

from ..obs import metrics as obs_metrics
from .log import get_logger

log = get_logger(__name__)

M_SWEPT = obs_metrics.counter(
    "artifacts_swept_total",
    "stale *.tmp / *.quarantined artifact files removed at start")

#: suffix family of in-flight atomic writes (pid-qualified so concurrent
#: writers in the same dir never collide on the temp name)
TMP_SUFFIX = ".tmp"
#: suffix a corrupt block is renamed to when a load path quarantines it
QUARANTINE_SUFFIX = ".quarantined"


def digest_bytes(data: bytes) -> str:
    """Content digest of a byte payload, algorithm-prefixed."""
    return f"crc32:{zlib.crc32(data) & 0xFFFFFFFF:08x}"


def digest_file(path: str) -> str:
    """Digest of a file's full contents (streamed, bounded memory)."""
    crc = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                break
            crc = zlib.crc32(chunk, crc)
    return f"crc32:{crc & 0xFFFFFFFF:08x}"


def npy_bytes(arr: np.ndarray) -> bytes:
    """Serialize an array to ``.npy`` format in memory — so the recorded
    digest is computed from the exact bytes that hit the disk."""
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def _fsync_dir(dirname: str) -> None:
    """Durable-rename half of the protocol; best-effort on filesystems
    that refuse directory fds (the rename is still atomic there)."""
    try:
        fd = os.open(dirname or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write_bytes(path: str, data: bytes) -> None:
    """tmp-file + fsync + rename: readers never observe a torn ``path``."""
    tmp = f"{path}{TMP_SUFFIX}.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp, path)
    _fsync_dir(os.path.dirname(path))


def atomic_replace_bytes(path: str, data: bytes) -> None:
    """Atomic VISIBILITY without durability: tmp + rename, no fsync.

    For transient data-plane files (per-batch query, paths and results
    files) that are deleted after one round trip: a concurrent reader
    must never observe torn bytes, but an fsync pair per batch on a
    shared dir is a hot-path round trip the data is not worth. Durable
    artifacts keep :func:`atomic_write_bytes`."""
    tmp = f"{path}{TMP_SUFFIX}.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
    os.rename(tmp, path)


def atomic_write_json(path: str, obj) -> None:
    atomic_write_bytes(path, (json.dumps(obj, indent=2) + "\n").encode())


@contextlib.contextmanager
def atomic_writer(path: str, mode: str = "w"):
    """Streaming form of :func:`atomic_write_bytes`: yields the open
    temp file so large artifacts (campaign CSVs) stream row by row in
    constant memory, then fsync+rename on clean exit. An exception
    removes the temp file — the final name never appears."""
    tmp = f"{path}{TMP_SUFFIX}.{os.getpid()}"
    f = open(tmp, mode)
    try:
        yield f
        f.flush()
        os.fsync(f.fileno())
    except BaseException:
        f.close()
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    f.close()
    os.rename(tmp, path)
    _fsync_dir(os.path.dirname(path))


def atomic_save_npy(path: str, arr: np.ndarray) -> str:
    """Atomically persist an array; returns the content digest of the
    written file bytes."""
    data = npy_bytes(arr)
    atomic_write_bytes(path, data)
    return digest_bytes(data)


class AtomicNpyWriter:
    """Pre-openable atomic ``.npy`` block writer: the temp file opens at
    construction, :meth:`commit` writes + fsyncs + renames. The final
    name never names torn bytes; :meth:`abort` removes an un-committed
    temp file."""

    def __init__(self, path: str):
        self.path = path
        self._tmp = f"{path}{TMP_SUFFIX}.{os.getpid()}"
        self._f = open(self._tmp, "wb")

    def commit(self, arr: np.ndarray) -> str:
        """Write + fsync + rename; returns the content digest."""
        data = npy_bytes(arr)
        try:
            self._f.write(data)
            self._f.flush()
            os.fsync(self._f.fileno())
        finally:
            self._f.close()
        os.rename(self._tmp, self.path)
        _fsync_dir(os.path.dirname(self.path))
        return digest_bytes(data)

    def abort(self) -> None:
        try:
            self._f.close()
        except OSError:
            pass
        try:
            os.remove(self._tmp)
        except OSError:
            pass


def atomic_copy_file(src: str, dst: str) -> str:
    """Copy a file atomically (tmp + fsync + rename) and return the crc32
    digest of the bytes copied — the delta build's reuse of an untouched
    block, whose digest then feeds the new ledger without a read-back. A
    failed copy leaves no temp file."""
    tmp = f"{dst}{TMP_SUFFIX}.{os.getpid()}"
    crc = 0
    with open(src, "rb") as fin:
        try:
            with open(tmp, "wb") as fout:
                while True:
                    chunk = fin.read(1 << 20)
                    if not chunk:
                        break
                    crc = zlib.crc32(chunk, crc)
                    fout.write(chunk)
                fout.flush()
                os.fsync(fout.fileno())
            os.rename(tmp, dst)
        except BaseException:
            with contextlib.suppress(OSError):
                os.remove(tmp)
            raise
    _fsync_dir(os.path.dirname(dst))
    return f"crc32:{crc & 0xFFFFFFFF:08x}"


#: default age below which sweep leaves a file alone: stale debris from
#: a dead process is minutes old, while a file this young may be a LIVE
#: atomic write by another process in this dir
SWEEP_MIN_AGE_S = 60.0


def sweep_stale_artifacts(dirname: str,
                          min_age_s: float = SWEEP_MIN_AGE_S) -> int:
    """Remove ``*.tmp.*`` debris from killed atomic writes and leftover
    ``*.quarantined`` blocks. Files younger than ``min_age_s`` are kept:
    the sweeping process cannot tell debris from another live process's
    in-flight atomic write. Returns the number of files removed."""
    if not dirname or not os.path.isdir(dirname):
        return 0
    now = time.time()
    n = 0
    for pat in (f"*{TMP_SUFFIX}.*", f"*{QUARANTINE_SUFFIX}"):
        for p in glob.glob(os.path.join(dirname, pat)):
            try:
                if (os.path.isfile(p)
                        and now - os.path.getmtime(p) >= min_age_s):
                    os.remove(p)
                    n += 1
            except OSError:
                continue
    if n:
        log.info("swept %d stale artifact file(s) in %s", n, dirname)
        M_SWEPT.inc(n)
    return n


def quarantine(path: str) -> str | None:
    """Move a corrupt artifact aside (``<path>.quarantined``) instead of
    deleting it — the bad bytes stay inspectable until the next sweep.
    Returns the quarantine path, or None when nothing was there."""
    if not os.path.exists(path):
        return None
    qpath = path + QUARANTINE_SUFFIX
    try:
        os.replace(path, qpath)
    except OSError as e:
        log.warning("could not quarantine %s (%s); removing instead",
                    path, e)
        try:
            os.remove(path)
        except OSError:
            return None
        return None
    return qpath
