"""Wire formats of the head↔worker data plane.

A copy of the JAX package's ``transport/wire.py``, so a head of either
package drives a worker of the other byte for byte. The reference's
de-facto RPC schema (reference ``process_query.py:66-111``) is kept
exactly:

* **request** — two text lines pushed through a worker's command FIFO:
  line 1 = JSON runtime config (``hscale, fscale, time, itrs, k_moves,
  threads, verbose, debug, thread_alloc, no_cache`` —
  reference ``process_query.py:149-160`` — plus the JAX package's wire
  extensions); line 2 = ``<queryfile> <answerfifo> <difffile>``
  (reference ``process_query.py:89``).
* **query file** — first line = count, then one ``s t`` pair per line
  (reference ``process_query.py:93-96``).
* **response** — ONE CSV line of batch stats, field order fixed by the
  header at reference ``process_query.py:198-213``:
  ``n_expanded, n_inserted, n_touched, n_updated, n_surplus, plen,
  finished, t_receive, t_astar, t_search``; the head appends
  ``t_prepare, t_partition, size``. A failed batch answers the ``FAIL``
  sentinel instead.

Everything here is pure encode/decode plus the query, paths and results
file helpers, answer fingerprints (the integrity extension) included.
"""

from __future__ import annotations

import dataclasses
import io
import json

import numpy as np

from ..utils.atomicio import atomic_replace_bytes

#: engine-side stats fields, in wire order
ENGINE_STAT_FIELDS = (
    "n_expanded", "n_inserted", "n_touched", "n_updated", "n_surplus",
    "plen", "finished", "t_receive", "t_astar", "t_search",
)
#: head-side appended fields
HEAD_STAT_FIELDS = ("t_prepare", "t_partition", "size")

#: answer-FIFO sentinel for an engine-side failure (a success row is a
#: 10-field CSV line and can never equal this)
FAIL_LINE = "FAIL"

#: answer-FIFO sentinel for the fleet-membership version gate: a worker
#: whose partition-table epoch is OLDER than the request's
#: ``RuntimeConfig.epoch`` (and that stayed older after refreshing its
#: membership state) refuses the batch with this line instead of
#: serving rows it may no longer own. New heads read it as a failed row
#: with ``stale_epoch`` set (failover walks on to the next candidate);
#: old heads see an undecodable line and book the same failed row —
#: the sentinel only ever appears when a NEW head stamped a nonzero
#: epoch, so legacy deployments never meet it.
STALE_EPOCH_LINE = "STALE_EPOCH"

#: answer-FIFO sentinel for the live-traffic version gate: a worker
#: whose DIFF epoch is OLDER than the request's
#: ``RuntimeConfig.diff_epoch`` (and that stayed older after refreshing
#: its segment stream) refuses the batch rather than read a fused diff
#: file its filesystem view may not have yet. Same compat shape as
#: ``STALE_EPOCH``: new heads read a failed row with ``stale_diff``
#: set; the sentinel only appears when a new head stamped a nonzero
#: diff epoch, so legacy deployments never meet it.
STALE_DIFF_LINE = "STALE_DIFF"

#: liveness control frame: ``__DOS_PING__ <answerfifo>`` as a single
#: command-FIFO line asks the server to write one health JSON line
#: (:class:`HealthStatus`) to the named FIFO
PING_TOKEN = "__DOS_PING__"

#: shutdown control frame: a command-FIFO line holding it stops the
#: server cleanly (``echo __DOS_STOP__ > <fifo>``)
STOP_TOKEN = "__DOS_STOP__"

#: full per-row CSV header (reference ``process_query.py:198-213`` plus the
#: leading experiment index the print path shows)
STATS_HEADER = ["expe", *ENGINE_STAT_FIELDS, *HEAD_STAT_FIELDS]


@dataclasses.dataclass
class RuntimeConfig:
    """Per-batch engine knobs (wire line 1). Same fields, defaults and
    JSON as the JAX package's, wire extensions included; ``from_json``
    drops keys it does not know, so peers of either age read each
    other's lines. The port's server reads every field: ``time``,
    ``itrs``, ``k_moves``, ``no_cache``, ``extract`` (path prefixes into
    ``<queryfile>.paths``), ``results`` (per-query answers into
    ``<queryfile>.results``), ``trace_id``, ``epoch`` (the membership
    version gate: a batch routed under a NEWER table than the worker's,
    even after a refresh, is refused with ``STALE_EPOCH``), ``diff_epoch``
    (the same gate on the live-traffic stream, ``STALE_DIFF``),
    ``sig_k`` (a path signature of ``sig_k`` moves beside the answers,
    through the ``.paths`` sidecar; the walk and its move budget stay
    ``k_moves``'s) and ``answer_fp`` (a crc32 answer fingerprint on the
    results header, ``fp=<hex8>``, or the RPC reply header's ``fp``,
    re-checked by the dispatcher: a mismatch is a dispatch error, never
    a served answer)."""

    hscale: float = 1.0
    fscale: float = 0.0
    time: int = 0            # ns budget; 0 = unlimited
    itrs: int = 1
    k_moves: int = -1
    threads: int = 0         # 0 = all
    verbose: int = 0
    debug: bool = False
    thread_alloc: int = 0
    no_cache: bool = False
    extract: bool = False
    trace_id: str = ""
    results: bool = False
    epoch: int = 0
    diff_epoch: int = 0
    sig_k: int = 0
    answer_fp: bool = False

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, line: str) -> "RuntimeConfig":
        d = json.loads(line)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


@dataclasses.dataclass
class Request:
    """A full 2-line command-FIFO request."""

    config: RuntimeConfig
    queryfile: str
    answerfifo: str
    difffile: str = "-"

    def encode(self) -> str:
        return (self.config.to_json() + "\n"
                + f"{self.queryfile} {self.answerfifo} {self.difffile}\n")

    @classmethod
    def decode(cls, text: str) -> "Request":
        lines = text.strip("\n").split("\n")
        if len(lines) < 2:
            raise ValueError(f"request needs 2 lines, got {len(lines)}")
        qf, af, df = lines[1].split()
        return cls(RuntimeConfig.from_json(lines[0]), qf, af, df)


@dataclasses.dataclass
class StatsRow:
    """One batch's engine stats (wire CSV line)."""

    n_expanded: int = 0
    n_inserted: int = 0
    n_touched: int = 0
    n_updated: int = 0
    n_surplus: int = 0
    plen: int = 0
    finished: int = 0
    t_receive: float = 0.0
    t_astar: float = 0.0
    t_search: float = 0.0
    ok: bool = True          # head-side: False marks a failed worker batch
    #: head-side: the worker refused the batch because its partition
    #: table is OLDER than the request's epoch (the ``STALE_EPOCH``
    #: wire sentinel) — a routing-state failure, not an engine one
    stale_epoch: bool = False
    #: head-side: the worker refused the batch because its DIFF epoch
    #: is OLDER than the request's ``diff_epoch`` (the ``STALE_DIFF``
    #: wire sentinel) — the traffic-plane twin of ``stale_epoch``
    stale_diff: bool = False

    def encode(self) -> str:
        vals = [getattr(self, f) for f in ENGINE_STAT_FIELDS]
        return ",".join(repr(v) if isinstance(v, float) else str(v)
                        for v in vals)

    @classmethod
    def decode(cls, line: str) -> "StatsRow":
        if line.strip() == FAIL_LINE:
            return cls.failed()
        if line.strip().startswith(STALE_EPOCH_LINE):
            # "STALE_EPOCH [<worker epoch>]": a failed row flagged so
            # the head can tell a routing-state refusal from an engine
            # crash (failover treats both the same; operators do not)
            return cls(ok=False, stale_epoch=True)
        if line.strip().startswith(STALE_DIFF_LINE):
            return cls(ok=False, stale_diff=True)
        parts = line.strip().split(",")
        if len(parts) != len(ENGINE_STAT_FIELDS):
            raise ValueError(
                f"stats row has {len(parts)} fields, "
                f"want {len(ENGINE_STAT_FIELDS)}: {line!r}")
        kwargs = {}
        for name, raw in zip(ENGINE_STAT_FIELDS, parts):
            kwargs[name] = float(raw) if name.startswith("t_") else int(
                float(raw))
        return cls(**kwargs)

    @classmethod
    def failed(cls) -> "StatsRow":
        """Explicit failure marker (vs the reference's garbage-row behavior,
        reference ``process_query.py:107-109``)."""
        return cls(ok=False)

    def encode_wire(self) -> str:
        """Wire line including the failure marker: failed rows encode as the
        ``FAIL`` sentinel so the head can tell them from an all-zero batch
        (success rows keep the reference's 10-field CSV exactly;
        stale-epoch refusals carry their own sentinel)."""
        if self.stale_epoch:
            return STALE_EPOCH_LINE
        if self.stale_diff:
            return STALE_DIFF_LINE
        return FAIL_LINE if not self.ok else self.encode()

    def as_list(self, t_prepare: float = 0.0, t_partition: float = 0.0,
                size: int = 0) -> list:
        """Full head-side row (engine fields + appended head fields)."""
        return ([getattr(self, f) for f in ENGINE_STAT_FIELDS]
                + [t_prepare, t_partition, size])


@dataclasses.dataclass
class HealthStatus:
    """One server's answer to a ``__DOS_PING__`` control frame.

    Same compat contract as :class:`RuntimeConfig`: ``from_json`` filters
    unknown keys symmetrically, so old heads can probe new servers and
    vice versa. ``dropped``/``batch_failures`` mirror the server's obs
    counters so a head-side probe can read a remote worker's failure
    counters without a metrics endpoint."""

    ok: bool = True
    wid: int = -1
    pid: int = 0
    uptime_s: float = 0.0
    batches: int = 0            # requests answered since start
    batch_failures: int = 0     # batches answered with FAIL
    dropped: int = 0            # replies dropped (no reader)
    last_error: str = ""

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, line: str) -> "HealthStatus":
        d = json.loads(line)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


# ------------------------------------------------------------ paths files

def paths_file_for(queryfile: str) -> str:
    """Where a server materializes extracted path prefixes for a batch."""
    return queryfile + ".paths"


def write_paths_file(path: str, nodes: np.ndarray, plen: np.ndarray) -> None:
    """``Q k`` header, then per query: ``<moves taken> n0 n1 ... nk``
    (node ids; after the path ends the last node repeats — the layout of
    ``ops.extract_paths``)."""
    nodes = np.asarray(nodes)
    plen = np.asarray(plen).reshape(-1, 1)
    buf = io.BytesIO()
    buf.write(f"{nodes.shape[0]} {nodes.shape[1] - 1}\n".encode())
    np.savetxt(buf, np.concatenate([plen, nodes], axis=1), fmt="%d")
    atomic_replace_bytes(path, buf.getvalue())


def read_paths_file(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Returns ``(nodes [Q, k+1], plen [Q])``."""
    with open(path) as f:
        q, k = (int(x) for x in f.readline().split())
        if q == 0:
            return np.zeros((0, k + 1), np.int64), np.zeros(0, np.int64)
        out = np.loadtxt(f, dtype=np.int64, ndmin=2)
    if out.shape != (q, k + 2):
        raise ValueError(f"{path}: header says {(q, k + 2)}, "
                         f"found {out.shape}")
    return out[:, 1:], out[:, 0]


# ---------------------------------------------------------- results files

def results_file_for(queryfile: str) -> str:
    """Where a server materializes per-query answers for a batch when the
    request set ``RuntimeConfig.results`` (online-serving wire
    extension)."""
    return queryfile + ".results"


def write_results_file(path: str, cost: np.ndarray, plen: np.ndarray,
                       finished: np.ndarray,
                       fp: int | None = None) -> None:
    """``Q`` header, then one ``cost plen finished`` row per query, in
    the query file's order.

    ``fp`` (the ``RuntimeConfig.answer_fp`` extension) rides the header
    line as an extra ``fp=<hex8>`` token — old readers take
    ``int(header[0])`` and ignore trailing tokens, so a fingerprinting
    server stays readable by a pre-integrity head."""
    cost = np.asarray(cost, np.int64)
    plen = np.asarray(plen, np.int64)
    fin = np.asarray(finished).astype(np.int64)
    buf = io.BytesIO()
    header = f"{len(cost)}"
    if fp is not None:
        header += f" fp={int(fp) & 0xFFFFFFFF:08x}"
    buf.write((header + "\n").encode())
    np.savetxt(buf, np.stack([cost, plen, fin], axis=1), fmt="%d")
    atomic_replace_bytes(path, buf.getvalue())


def read_results_file(path: str) -> tuple[np.ndarray, np.ndarray,
                                          np.ndarray]:
    """Returns ``(cost [Q] int64, plen [Q] int64, finished [Q] bool)``.

    When the header carries an ``fp=`` fingerprint token the answer
    bytes are re-checked before being returned; a mismatch raises
    :class:`~..integrity.fingerprint.FingerprintError` (a ``ValueError``
    subclass, so pre-integrity decode-error handlers still fail over)
    and books ``answer_fp_mismatch_total`` — a corrupted sidecar is
    never handed up."""
    with open(path) as f:
        header = f.readline().split()
        if not header:
            # a worker killed between creating the sidecar and writing
            # the header leaves a zero-byte file — a decode error the
            # dispatcher translates, not an opaque IndexError
            raise ValueError(f"{path}: empty results file")
        count = int(header[0])
        fp_want = None
        for tok in header[1:]:
            if tok.startswith("fp="):
                fp_want = int(tok[3:], 16)
        if count == 0:
            out = np.zeros((0, 3), np.int64)
        else:
            out = np.loadtxt(f, dtype=np.int64, ndmin=2)
    if out.shape != (count, 3):
        raise ValueError(f"{path}: header says {(count, 3)}, "
                         f"found {out.shape}")
    cost, plen, fin = out[:, 0], out[:, 1], out[:, 2] != 0
    if fp_want is not None:
        # lazy import: legacy (fingerprint-less) decode stays free of
        # the integrity package entirely
        from ..integrity.fingerprint import (
            FingerprintError, M_FP_MISMATCH, answer_fingerprint)
        got = answer_fingerprint(cost, plen, fin)
        if got != fp_want:
            M_FP_MISMATCH.inc()
            raise FingerprintError(
                f"{path}: answer fingerprint mismatch (header "
                f"{fp_want:08x}, computed {got:08x}) — corrupted "
                "results sidecar")
    return cost, plen, fin


# ----------------------------------------------------------- query files

def write_query_file(path: str, queries: np.ndarray) -> None:
    """count line, then ``s t`` per line (reference process_query.py:93-96)."""
    queries = np.asarray(queries)
    buf = io.BytesIO()
    buf.write(f"{len(queries)}\n".encode())
    np.savetxt(buf, queries, fmt="%d")
    atomic_replace_bytes(path, buf.getvalue())


def read_query_file(path: str) -> np.ndarray:
    with open(path) as f:
        count = int(f.readline().split()[0])
        if count == 0:
            return np.zeros((0, 2), np.int64)
        out = np.loadtxt(f, dtype=np.int64, ndmin=2)
    if len(out) != count:
        raise ValueError(f"{path}: header says {count} queries, "
                         f"found {len(out)}")
    return out.reshape(count, 2) if count else np.zeros((0, 2), np.int64)
