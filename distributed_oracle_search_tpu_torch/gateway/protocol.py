"""The client-facing binary protocol: frame vocabulary + codecs.

The gateway tier speaks the SAME length-prefixed frame container as the
head↔worker RPC lane (:mod:`..transport.frames` — magic, schema-gated
JSON header, 8-aligned raw ndarray segments), pointed the other
direction: client → frontend. This module is the pure codec — frame
encoders and parsers with no sockets in them — so the server, the
client library, and the tests all agree on one wire shape.

Frame vocabulary (header ``kind``):

* ``hello`` — first frame on a connection, both directions. The
  gateway's hello advertises ``{"gv": GATEWAY_SCHEMA_VERSION,
  "frontend": fid, "credit": N, "epoch": e, "diff_epoch": de}``; a
  client MAY answer with its own ``{"kind": "hello", "gv": ...}``.
  Version negotiation follows the repo-wide tolerate-older /
  gate-newer contract: either side refuses a peer whose ``gv`` is
  NEWER than its own build and serves anything older.
* ``q`` — one multiplexed query frame: ``{"id": n, "family":
  "pair"|"mat"|"alt"|"rev", "deadline_ms": optional, "epoch":
  optional, "diff_epoch": optional, "cid": optional client identity
  token, "resubmit": optional}``. ``cid`` + ``id`` together name one
  logical request across connections and frontends: a failover client
  resubmits an unanswered frame with its ORIGINAL id, ``resubmit``
  stamped true, and a frontend that already answered ``(cid, id)``
  replays its memoized reply instead of double-booking counters and
  cache inserts — exactly-once *accounting* over at-least-once
  *execution* (answers are deterministic, so a re-execution on a
  different frontend is bit-identical). Both keys ride the
  unknown-key contract: pre-HA gateways simply ignore them.
  ``pair``/``rev`` carry one
  int64 ``[Q, 2]`` payload segment of (s, t) rows — a BATCH per
  frame, retiring per-line text parsing from the hot ingress path;
  ``mat`` carries ``s`` in the header and an int64 ``[K]`` targets
  segment; ``alt`` is header-only (``s``, ``t``, ``k``). The epochs
  are advisory staleness hints; replies carry the serving truth.
* ``r`` — the answer, correlated by ``id``. ``pair``/``rev``:
  per-row ``status``/``detail``/``cached`` lists in the header plus
  ``[cost, plen, finished]`` int64/int64/uint8 segments; ``mat``:
  ``s`` + one costs segment (−1 per unanswered target, exactly the
  MAT sentence semantics); ``alt``: ascending ``[costs, vias]``
  segments. Every reply stamps ``frontend``/``epoch``/``diff_epoch``.
* ``busy`` — explicit backpressure: the frame arrived past the
  connection's advertised credit window. Never silently queued.
* ``err`` — a typed error for a frame the gateway could not serve
  (malformed family, bad payload, newer schema). A malformed frame
  ALWAYS answers ``err`` — never a torn connection.
* ``ping`` / ``health`` — liveness probe and its reply.

All parsers are unknown-key tolerant (new fields ride along for older
peers) and gate only on NEWER ``gv``.
"""

from __future__ import annotations

import numpy as np

from ..transport.frames import Frame

#: bump when the gateway frame vocabulary changes shape. Distinct from
#: the container's FRAME_SCHEMA_VERSION: the container gates how bytes
#: frame, this gates what the frames MEAN.
GATEWAY_SCHEMA_VERSION = 1

FAMILIES = ("pair", "mat", "alt", "rev")


class GatewayProtocolError(ValueError):
    """A frame this build cannot serve (malformed or newer-schema).
    The server answers a typed ``err`` frame and keeps the connection."""


class GatewaySchemaError(GatewayProtocolError):
    """Peer speaks a NEWER gateway schema than this build."""


def check_hello(header: dict) -> dict:
    """Gate a peer hello: tolerate older, refuse newer. Returns the
    header (unknown keys and all) for the caller to pick fields from."""
    gv = header.get("gv", 0)
    if isinstance(gv, (int, float)) and int(gv) > GATEWAY_SCHEMA_VERSION:
        raise GatewaySchemaError(
            f"peer gateway schema v{int(gv)} is newer than "
            f"v{GATEWAY_SCHEMA_VERSION}")
    return header


def hello_header(fid: int, credit: int, *, epoch: int = 0,
                 diff_epoch: int = 0) -> dict:
    return {"kind": "hello", "gv": GATEWAY_SCHEMA_VERSION,
            "frontend": int(fid), "credit": int(credit),
            "epoch": int(epoch), "diff_epoch": int(diff_epoch)}


# ------------------------------------------------------------- queries
def _q_header(fid: int, family: str, deadline_ms=None, epoch=None,
              diff_epoch=None, cid=None, resubmit=None) -> dict:
    h = {"kind": "q", "id": int(fid), "family": family,
         "gv": GATEWAY_SCHEMA_VERSION}
    if deadline_ms is not None:
        h["deadline_ms"] = float(deadline_ms)
    if epoch is not None:
        h["epoch"] = int(epoch)
    if diff_epoch is not None:
        h["diff_epoch"] = int(diff_epoch)
    if cid is not None:
        h["cid"] = str(cid)
    if resubmit:
        h["resubmit"] = True
    return h


def encode_pairs(fid: int, pairs, family: str = "pair",
                 **kw) -> tuple[dict, list]:
    """One batched pair/rev frame: ``pairs`` is anything ndarray-able
    to int64 ``[Q, 2]`` (s, t) rows."""
    arr = np.ascontiguousarray(np.asarray(pairs, dtype=np.int64))
    if arr.ndim != 2 or arr.shape[1] != 2:
        raise GatewayProtocolError(f"pairs must be [Q, 2] "
                                   f"(got shape {arr.shape})")
    return _q_header(fid, family, **kw), [arr]


def encode_mat(fid: int, s: int, targets, **kw) -> tuple[dict, list]:
    h = _q_header(fid, "mat", **kw)
    h["s"] = int(s)
    arr = np.ascontiguousarray(np.asarray(targets, dtype=np.int64))
    if arr.ndim != 1 or not len(arr):
        raise GatewayProtocolError("mat targets must be a non-empty "
                                   "1-D array")
    return h, [arr]


def encode_alt(fid: int, s: int, t: int, k: int, **kw) -> tuple[dict,
                                                                list]:
    h = _q_header(fid, "alt", **kw)
    h.update(s=int(s), t=int(t), k=int(k))
    return h, []


def parse_query_frame(fr: Frame):
    """``(family, payload)`` for one ``q`` frame — ``payload`` is the
    ``[Q, 2]`` pairs array (pair/rev), ``(s, targets)`` (mat), or
    ``(s, t, k)`` (alt). Unknown header keys ride along untouched;
    only a NEWER ``gv`` refuses. Raises :class:`GatewayProtocolError`
    on anything malformed — the server turns that into a typed ``err``
    frame, never a torn connection."""
    check_hello(fr.header)       # same gate: "gv" newer → refuse typed
    family = fr.header.get("family")
    if family not in FAMILIES:
        raise GatewayProtocolError(f"unknown family {family!r}")
    try:
        if family in ("pair", "rev"):
            if len(fr.arrays) != 1:
                raise GatewayProtocolError(
                    f"{family} frame wants 1 payload segment "
                    f"(got {len(fr.arrays)})")
            pairs = np.asarray(fr.arrays[0])
            if pairs.ndim != 2 or pairs.shape[1] != 2:
                raise GatewayProtocolError(
                    f"{family} payload must be [Q, 2] "
                    f"(got shape {pairs.shape})")
            return family, pairs.astype(np.int64, copy=False)
        if family == "mat":
            if len(fr.arrays) != 1:
                raise GatewayProtocolError(
                    f"mat frame wants 1 targets segment "
                    f"(got {len(fr.arrays)})")
            targets = np.asarray(fr.arrays[0]).reshape(-1)
            if not len(targets):
                raise GatewayProtocolError("mat frame with no targets")
            return family, (int(fr.header["s"]),
                            targets.astype(np.int64, copy=False))
        # alt: header-only
        return family, (int(fr.header["s"]), int(fr.header["t"]),
                        int(fr.header["k"]))
    except GatewayProtocolError:
        raise
    except (KeyError, TypeError, ValueError) as e:
        raise GatewayProtocolError(f"malformed {family} frame: {e}")


def frame_id(fr: Frame) -> int:
    """The correlation id, or −1 when the frame has none (the typed
    ``err`` answer to an id-less frame still correlates as 'not any
    in-flight request')."""
    fid = fr.header.get("id", -1)
    return int(fid) if isinstance(fid, (int, float)) else -1


def frame_cid(fr: Frame) -> str | None:
    """The client identity token, or ``None`` when the frame carries
    none (pre-HA clients) — dedup only engages for tokened frames."""
    cid = fr.header.get("cid")
    return cid if isinstance(cid, str) and cid else None


# -------------------------------------------------------------- replies
def _r_header(fid: int, family: str, *, frontend: int, epoch: int,
              diff_epoch: int) -> dict:
    return {"kind": "r", "id": int(fid), "family": family,
            "gv": GATEWAY_SCHEMA_VERSION, "frontend": int(frontend),
            "epoch": int(epoch), "diff_epoch": int(diff_epoch)}


def reply_pairs(fid: int, family: str, results, **ident) -> tuple[dict,
                                                                  list]:
    """``results`` is the in-order list of per-row
    :class:`~..serving.request.ServeResult`."""
    h = _r_header(fid, family, **ident)
    h["status"] = [r.status for r in results]
    h["detail"] = [r.detail for r in results]
    h["cached"] = [bool(r.cached) for r in results]
    cost = np.asarray([int(r.cost) for r in results], np.int64)
    plen = np.asarray([int(r.plen) for r in results], np.int64)
    fin = np.asarray([bool(r.finished) for r in results], np.uint8)
    return h, [cost, plen, fin]


def reply_mat(fid: int, s: int, costs, **ident) -> tuple[dict, list]:
    h = _r_header(fid, "mat", **ident)
    h["s"] = int(s)
    return h, [np.asarray(costs, np.int64)]


def reply_alt(fid: int, s: int, t: int, alternatives,
              **ident) -> tuple[dict, list]:
    """``alternatives`` is the ascending ``[(cost, via), ...]`` list of
    :class:`~..traffic.families.AltResult`."""
    h = _r_header(fid, "alt", **ident)
    h.update(s=int(s), t=int(t))
    costs = np.asarray([int(c) for c, _v in alternatives], np.int64)
    vias = np.asarray([int(v) for _c, v in alternatives], np.int64)
    return h, [costs, vias]


def reply_shed(fid: int, family: str, status: str, detail: str,
               **ident) -> tuple[dict, list]:
    """A whole-frame terminal status (family shed by the brownout
    ladder, or a family future that errored): no payload rows, the
    ``status`` field carries the single frame-level verdict."""
    h = _r_header(fid, family, **ident)
    h["status"] = str(status)
    h["detail"] = str(detail)
    return h, []


def busy_frame(fid: int, **ident) -> tuple[dict, list]:
    h = _r_header(fid, "busy", **ident)
    h["kind"] = "busy"
    return h, []


def error_frame(fid: int, detail: str, **ident) -> tuple[dict, list]:
    h = _r_header(fid, "err", **ident)
    h["kind"] = "err"
    h["error"] = str(detail)
    return h, []
