"""Epoch-tagged diff segment codec.

A *segment* is one increment of the congestion stream: "these edges'
travel times changed, effective at diff epoch E". On disk it is a plain
text file so the same NFS data plane that carries query files carries
the stream:

.. code-block:: text

    {"kind": "dos-traffic-segment", "schema": 1, "epoch": 5, "entries": 2}
    17 42 900
    42 17 900

Line 1 is a JSON header; the remaining ``entries`` lines are
``src dst new_w`` exactly like a ``.diff`` body (``data.formats``).
The header follows the repo-wide wire-compat contract
(``RuntimeConfig`` / manifest v2 / membership state): **unknown keys
are tolerated** (a newer producer may annotate segments freely) and
**only a NEWER schema version rejects** — an old segment always loads
under new code.

Writers go through ``utils.atomicio`` so a reader can never see a torn
segment *file*; a torn *tail* can still appear when a non-atomic
producer (or a partial copy) is mid-write, which is why
:func:`list_segments` ignores an unreadable newest segment instead of
failing the stream.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import re

import numpy as np

from ..utils.atomicio import atomic_write_bytes
from ..utils.log import get_logger

log = get_logger(__name__)

#: this writer's segment header schema version; readers reject only
#: NEWER versions (wire-compat contract)
SEGMENT_SCHEMA = 1

SEGMENT_KIND = "dos-traffic-segment"

_SEG_RE = re.compile(r"seg-(\d+)\.diff$")


@dataclasses.dataclass
class DiffSegment:
    """One decoded stream increment: epoch + the edges it retimes."""

    epoch: int
    src: np.ndarray
    dst: np.ndarray
    w: np.ndarray

    def __len__(self) -> int:
        return len(self.src)

    def pairs(self):
        """``(src, dst)`` tuples of the edges this segment updates."""
        return [(int(u), int(v)) for u, v in zip(self.src, self.dst)]


def segment_path(dirname: str, epoch: int) -> str:
    """Canonical on-disk name of epoch ``epoch``'s segment."""
    return os.path.join(dirname, f"seg-{int(epoch):06d}.diff")


def encode_segment(epoch: int, src, dst, w, extra: dict | None = None) -> bytes:
    """Segment bytes: header line + ``src dst new_w`` entries.
    ``extra`` keys ride the header (a reader that predates them filters
    them — that tolerance is pinned by the compat tests)."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    w = np.asarray(w, np.int64)
    if not (len(src) == len(dst) == len(w)):
        raise ValueError("src/dst/w length mismatch")
    header = {"kind": SEGMENT_KIND, "schema": SEGMENT_SCHEMA,
              "epoch": int(epoch), "entries": int(len(src))}
    if extra:
        header.update(extra)
    out = [json.dumps(header)]
    out += ["%d %d %d" % (u, v, ww) for u, v, ww in zip(src, dst, w)]
    return ("\n".join(out) + "\n").encode()


def write_segment(dirname: str, epoch: int, src, dst, w,
                  extra: dict | None = None) -> str:
    """Atomically write epoch ``epoch``'s segment into the stream
    directory; returns its path. Atomic visibility is what lets a
    :class:`~.stream.DiffStream` watcher poll the directory without a
    coordination channel."""
    os.makedirs(dirname, exist_ok=True)
    path = segment_path(dirname, epoch)
    atomic_write_bytes(path, encode_segment(epoch, src, dst, w, extra))
    return path


def decode_segment(text: str, origin: str = "<segment>") -> DiffSegment:
    """Decode one segment's text. Raises ``ValueError`` with a
    diagnostic naming ``origin`` on any structural problem (torn body,
    bad header, NEWER schema)."""
    lines = text.split("\n")
    try:
        header = json.loads(lines[0])
    except (ValueError, IndexError) as e:
        raise ValueError(f"{origin}: bad segment header: {e}") from e
    if not isinstance(header, dict):
        raise ValueError(f"{origin}: segment header is not an object")
    schema = header.get("schema", 1)
    if isinstance(schema, (int, float)) and schema > SEGMENT_SCHEMA:
        # the only rejection the version gate allows: a NEWER producer's
        # segment may carry semantics this reader would misapply
        raise ValueError(
            f"{origin}: segment schema {schema} is newer than this "
            f"reader's {SEGMENT_SCHEMA}; upgrade to read it")
    try:
        epoch = int(header["epoch"])
        entries = int(header["entries"])
    except (KeyError, TypeError, ValueError) as e:
        raise ValueError(
            f"{origin}: segment header missing epoch/entries: {e}") from e
    src = np.empty(entries, np.int64)
    dst = np.empty(entries, np.int64)
    w = np.empty(entries, np.int64)
    body = [ln for ln in lines[1:] if ln.strip()]
    if len(body) < entries:
        raise ValueError(
            f"{origin}: torn segment — header says {entries} entries, "
            f"found {len(body)}")
    for i in range(entries):
        toks = body[i].split()
        if len(toks) != 3:
            raise ValueError(f"{origin}: bad entry line {i}: {body[i]!r}")
        src[i], dst[i], w[i] = (int(t) for t in toks)
    return DiffSegment(epoch=epoch, src=src, dst=dst, w=w)


def read_segment(path: str) -> DiffSegment:
    """Read + decode one segment file; the file-name epoch (when the
    name matches the canonical pattern) must agree with the header's —
    a renamed segment would silently reorder the stream."""
    with open(path) as f:
        seg = decode_segment(f.read(), origin=path)
    m = _SEG_RE.search(os.path.basename(path))
    if m is not None and int(m.group(1)) != seg.epoch:
        raise ValueError(
            f"{path}: file name says epoch {int(m.group(1))} but header "
            f"says {seg.epoch}")
    return seg


def list_segments(dirname: str, after: int = 0) -> list[DiffSegment]:
    """All complete segments with epoch > ``after``, in epoch order.

    The **torn tail** rule: the newest segment failing to decode is
    skipped silently-but-logged (a non-atomic producer is mid-write;
    the next poll picks it up complete). An unreadable segment that is
    NOT the tail is real data loss in the middle of the stream and
    raises — serving on weights with a silently missing increment would
    be wrong forever, not briefly."""
    paths = []
    for p in glob.glob(os.path.join(dirname, "seg-*.diff")):
        m = _SEG_RE.search(os.path.basename(p))
        if m is not None and int(m.group(1)) > after:
            paths.append((int(m.group(1)), p))
    paths.sort()
    out: list[DiffSegment] = []
    for i, (_, p) in enumerate(paths):
        try:
            out.append(read_segment(p))
        except (OSError, ValueError) as e:
            if i == len(paths) - 1:
                log.info("ignoring torn tail segment %s (%s)", p, e)
                break
            raise ValueError(
                f"unreadable mid-stream segment {p}: {e}") from e
    return out
