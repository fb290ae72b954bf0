"""Diff stream sources: where segments come from.

Two shapes cover the deployments we have:

* :class:`DiffStream` — **directory watch**: a producer drops
  ``seg-<epoch>.diff`` files (atomic writes) into a shared directory;
  each ``poll()`` returns the complete segments newer than the last
  one seen, in epoch order. This is the shared-NFS deployment — the
  same data plane that carries query files carries the stream, no new
  transport.
* :class:`TailDiffStream` — **file tail**: segments appended
  back-to-back to ONE spool file (a producer that can only append —
  a pipe drain, a log shipper). ``poll()`` parses complete frames from
  the last read offset; an incomplete tail frame stays unread until
  its remaining lines land (the torn-tail rule again, applied to a
  byte offset instead of a file name).

Both are *pull* sources with no threads of their own: the serving
frontend's epoch pump (``ServingFrontend``) and the worker server's
gate-time refresh own the polling cadence.
"""

from __future__ import annotations

import os

from ..utils.log import get_logger
from .segments import DiffSegment, decode_segment, list_segments

log = get_logger(__name__)


class DiffStream:
    """Directory-watch segment source (see module docstring)."""

    def __init__(self, dirname: str, start_epoch: int = 0):
        self.dirname = dirname
        #: highest epoch already handed out; poll() only returns newer
        self.seen_epoch = int(start_epoch)
        self._synced = False   # a segment has been handed out before

    def poll(self) -> list[DiffSegment]:
        """Complete segments newer than the last poll, epoch order.
        A missing directory is an empty stream (the operator may start
        the consumer before the producer), not an error.

        Epochs must advance CONTIGUOUSLY once the stream is synced: on
        a shared filesystem a higher-numbered segment can become
        visible before a lower one (cross-client readdir skew), and
        skipping past the gap would omit that segment's retimes from
        every later fusion forever. A segment past a gap is held back
        (with a warning) until the missing epoch appears. The FIRST
        segment a consumer ever sees may carry any epoch — a late
        joiner syncs to wherever the stream is."""
        if not os.path.isdir(self.dirname):
            return []
        segs = list_segments(self.dirname, after=self.seen_epoch)
        out: list[DiffSegment] = []
        for seg in segs:
            if ((self._synced or out)
                    and seg.epoch != self.seen_epoch + 1):
                log.warning(
                    "%s: segment epoch %d visible but epoch %d is "
                    "not; holding it back until the gap fills",
                    self.dirname, seg.epoch, self.seen_epoch + 1)
                break
            self.seen_epoch = seg.epoch
            self._synced = True
            out.append(seg)
        return out


class TailDiffStream:
    """Single append-only spool file segment source."""

    def __init__(self, path: str, start_epoch: int = 0):
        self.path = path
        self.seen_epoch = int(start_epoch)
        self._offset = 0

    def poll(self) -> list[DiffSegment]:
        # binary read end to end: the resume offset both counts and
        # seeks BYTES — a text-mode read would count characters while
        # seek positions bytes, and the first multi-byte header
        # annotation (producers may add keys freely) would desync the
        # frame parse permanently
        try:
            with open(self.path, "rb") as f:
                f.seek(self._offset)
                data = f.read()
        except OSError:
            return []           # producer not started yet
        import json as _json

        out: list[DiffSegment] = []
        # split keeps the unterminated remainder as the LAST element
        # (empty when the data ends on a newline) — a frame may only
        # use fully newline-terminated lines, i.e. indices < len - 1
        lines = data.split(b"\n")
        i = 0
        consumed = 0            # bytes of COMPLETE frames handed out
        while i < len(lines) - 1:
            if not lines[i].strip():
                consumed += len(lines[i]) + 1
                i += 1
                continue
            # a frame is one header line + `entries` body lines; stop
            # at the first incomplete frame (torn tail: the producer is
            # mid-append, the next poll re-reads from this offset)
            try:
                header = _json.loads(lines[i])
                n = int(header["entries"])
            except (ValueError, KeyError, TypeError):
                log.error("%s: undecodable frame header at offset %d; "
                          "tail stream stalled", self.path,
                          self._offset + consumed)
                break
            if i + n >= len(lines) - 1:
                break           # incomplete tail frame
            frame = lines[i:i + 1 + n]
            try:
                seg = decode_segment(
                    (b"\n".join(frame) + b"\n").decode(),
                    origin=self.path)
            except ValueError as e:   # UnicodeDecodeError included
                log.error("%s: undecodable frame at offset %d (%s); "
                          "tail stream stalled", self.path,
                          self._offset + consumed, e)
                break
            consumed += sum(len(ln) + 1 for ln in frame)
            i += 1 + n
            if seg.epoch > self.seen_epoch:
                out.append(seg)
                self.seen_epoch = seg.epoch
        self._offset += consumed
        return out

    def append(self, seg_bytes: bytes) -> None:
        """Producer half (tests / replay): append one encoded frame."""
        with open(self.path, "ab") as f:
            f.write(seg_bytes)
