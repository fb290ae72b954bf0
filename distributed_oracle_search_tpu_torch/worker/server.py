"""Resident query server: the port's ``fifo_auto``.

Behavior parity with reference C3 (SURVEY.md §2.2) and the JAX package's
``worker/server.py``: on start, load the graph, this worker's CPD shard
(:class:`~.engine.ShardEngine`, on the card unless ``--device cpu``) and
the first diff's weights; create the command FIFO
``/tmp/worker<wid>.fifo`` (or ``--fifo``) and block on it. Per request:
parse the 2-line frame (JSON knobs + ``queryfile answerfifo difffile``),
read the query file, answer the batch with the table-search walk (or,
with ``--alg astar``, the batched A* search, which needs no index),
write ONE CSV stats line to the answer FIFO. Stays resident across
requests.

* ``__DOS_STOP__`` on the command FIFO shuts the server down cleanly;
  ``__DOS_PING__ <fifo>`` gets one health JSON line;
* an engine error (a refused kernel launch included) answers the
  ``FAIL`` sentinel, never a silent zero row, and never leaves the head
  blocked on ``cat <answer>``;
* ``--metrics-dump PATH`` writes the server's counters, the walk
  kernel's and the A* kernels' launches and plain runs, the device name
  and the peak device memory as JSON on clean shutdown.

    python -m distributed_oracle_search_tpu_torch.worker.server \\
        -c conf.json --workerid N [--alg astar] [--device cpu] \\
        [--metrics-dump m.json]

Serves a static fleet. With ``replication`` R > 1 a batch whose targets
all lie in a shard this worker hosts as a replica is answered by a
replica engine made on first use from that shard's replica block set
(:meth:`FifoServer.engine_for_shard`; counted in
``server_replica_batches_total``); a batch for a shard it does not host
fails the routing invariant. The head's failover over replicas is not
ported (A14). Not ported, and refused with the ``ROADMAP.md`` item that
ports each: adoption engines and the membership epoch gate (A14), the
worker L2 cache and ``--traffic-dir`` (A14), the RPC serve loop,
``--rpc-*``, ``--obs-port`` and telemetry (A14), answer fingerprints
(A14).
"""

from __future__ import annotations

import argparse
import errno
import fcntl
import os
import select
import stat
import sys
import time

import numpy as np
import torch

from ..data.graph import Graph
from ..ops.batched_astar import astar_batch
from ..ops.cuda_astar import astar_heuristic, astar_sweep
from ..ops.cuda_walk import cuda_walk_batch
from ..parallel.partition import DistributionController
from ..transport.fifo import command_fifo_path
from ..transport.wire import (
    HealthStatus, PING_TOKEN, STOP_TOKEN, Request, StatsRow,
    paths_file_for, read_query_file, results_file_for, write_paths_file,
    write_results_file,
)
from ..utils.atomicio import atomic_write_json
from ..utils.config import ClusterConfig
from ..utils.env import env_cast
from ..utils.log import get_logger, set_verbosity, set_worker_id
from .engine import ShardEngine

log = get_logger(__name__)

#: the serve loop's counters (``FifoServer.counters``), under the JAX
#: package's metric names
COUNTER_NAMES = (
    "worker_batches_total",              # batches answered (not FAIL)
    "worker_queries_total",              # queries in those batches
    "server_frames_received_total",      # frame starts seen
    "server_frames_malformed_total",     # stray lines + undecodable frames
    "server_frames_half_total",          # frames whose line 2 never came
    "server_batches_failed_total",       # batches answered with FAIL
    "server_replies_sent_total",         # stats lines written
    "server_replies_dropped_total",      # replies with no reader in time
    "server_pings_answered_total",       # health lines written
    "server_replica_batches_total",      # batches a replica engine answered
)


class FifoServer:
    """One worker's resident server over its command FIFO.

    ``device``: None → ``cuda`` (raises without a GPU unless ``"cpu"``);
    the shard, the graph and every walk live there. ``counters`` holds
    the serve loop's counts (:data:`COUNTER_NAMES`); only the thread in
    :meth:`serve_forever` changes them."""

    #: bound on the gap between a frame's two lines (one atomic writer
    #: write puts both in the pipe together; only garbage arrives alone)
    FRAME_TIMEOUT_S = 2.0
    #: reader-wait for best-effort malformed replies: a garbage frame's
    #: "answer FIFO" may be a stray path nobody reads
    MALFORMED_REPLY_DEADLINE_S = 2.0
    #: reader-wait for ping replies: the prober is already blocked on its
    #: answer FIFO when the ping lands
    PING_REPLY_DEADLINE_S = 5.0

    def __init__(self, conf: ClusterConfig, wid: int,
                 command_fifo: str | None = None,
                 alg: str = "table-search", device=None):
        if alg not in ("table-search", "astar"):
            raise ValueError(f"unknown algorithm {alg!r}")
        if os.path.exists(os.path.join(conf.outdir, "membership.json")):
            raise ValueError(
                f"{conf.outdir} holds a membership state: elastic fleets "
                "are not ported (ROADMAP.md A14)")
        self.conf = conf
        self.wid = wid
        self.alg = alg
        self.counters = dict.fromkeys(COUNTER_NAMES, 0)
        self.command_fifo = command_fifo or command_fifo_path(wid)
        self.graph = Graph.from_xy(conf.xy_file)
        self.dc = DistributionController(
            conf.partmethod, conf.partkey, conf.maxworker, self.graph.n,
            replication=conf.effective_replication())
        self.device = device
        self.engine = ShardEngine(self.graph, self.dc, wid, conf.outdir,
                                  alg=alg, device=device)
        #: engines by shard: this worker's own, and the replica engines
        #: made on first use for the shards it hosts
        self._replica_engines: dict[int, ShardEngine] = {wid: self.engine}
        # preload the first diff's weights like the reference server
        # does (make_fifos.py:18 loads only diffs[0])
        if conf.diffs:
            self.engine.preload(conf.diffs[0])

    def engine_for_shard(self, shard: int) -> ShardEngine:
        """The engine serving ``shard``'s rows: this worker's own engine
        for its shard, a replica engine (made on first use from the
        shard's replica block set) for a shard it hosts as a replica,
        and a routing-invariant error naming the hosted shards for any
        other."""
        eng = self._replica_engines.get(shard)
        if eng is None:
            hosted = sorted(int(x) for x in self.dc.replica_shards(self.wid))
            if shard not in hosted:
                raise ValueError(
                    f"worker {self.wid} hosts no replica of shard {shard} "
                    f"(hosted: {hosted}) — routing invariant violated")
            log.info("worker %d: loading shard %d's replica for failover "
                     "traffic", self.wid, shard)
            eng = ShardEngine(self.graph, self.dc, self.wid,
                              self.conf.outdir, alg=self.alg,
                              device=self.device, shard=shard)
            self._replica_engines[shard] = eng
        return eng

    # ------------------------------------------------------------ serving
    def _ensure_fifo(self) -> None:
        if os.path.exists(self.command_fifo):
            os.remove(self.command_fifo)
        os.mkfifo(self.command_fifo)

    def handle(self, req: Request) -> StatsRow:
        queries = read_query_file(req.queryfile)
        cost, plen, fin, stats, paths = self.answer_queries(
            queries, req.config, req.difffile)
        if paths is not None:
            # extraction rides the shared dir, not the stats FIFO
            write_paths_file(paths_file_for(req.queryfile), *paths)
        if req.config.results:
            write_results_file(results_file_for(req.queryfile),
                               cost, plen, fin)
        return stats

    def answer_queries(self, queries: np.ndarray, config, difffile: str):
        """One batch on the engine of the shard its targets lie in:
        ``(cost, plen, fin, stats, paths)`` with ``paths =
        engine.last_paths`` (None unless extracting). A batch for one
        shard this worker hosts as a replica goes to that shard's
        replica engine; any other batch meets its engine's routing
        invariant."""
        engine = self.engine
        if len(queries):
            shards = np.unique(self.dc.worker_of(
                np.asarray(queries, np.int64).reshape(-1, 2)[:, 1]))
            if len(shards) == 1 and int(shards[0]) != engine.shard:
                engine = self.engine_for_shard(int(shards[0]))
                self.counters["server_replica_batches_total"] += 1
        cost, plen, fin, stats = engine.answer(queries, config, difffile)
        self.counters["worker_queries_total"] += len(queries)
        return cost, plen, fin, stats, engine.last_paths

    def serve_forever(self) -> None:
        """Framed request loop over a PERSISTENT command-FIFO read session.

        A naive open-to-EOF session per request re-inherits the
        reference's FIFO race (reference README.md:125-127): a writer
        that opens before the server sees the previous writer's EOF
        lands in the dying session and is dropped. So the server opens
        the FIFO once with ``O_RDWR`` (its own write end means reads
        never see EOF, only block) and parses frame by frame: exactly
        two newline-terminated lines each. A request under ``PIPE_BUF``
        is written atomically, so back-to-back writers queue and never
        interleave.
        """
        self._ensure_fifo()
        set_worker_id(self.wid)
        log.info("worker %d serving on %s", self.wid, self.command_fifo)
        self._t_start = time.monotonic()
        self._last_error = ""
        fd = os.open(self.command_fifo, os.O_RDWR)
        self._rdbuf = b""
        try:
            while True:
                line1 = self._next_line(fd)
                if STOP_TOKEN in line1:
                    log.info("worker %d: stop requested", self.wid)
                    return
                if not line1.strip():
                    continue
                if line1.lstrip().startswith(PING_TOKEN):
                    # single-line control frame: never a data frame
                    self._answer_ping(line1)
                    continue
                self.counters["server_frames_received_total"] += 1
                if not line1.lstrip().startswith("{"):
                    # a config line is always a JSON object, a paths line
                    # never is: a stray line is handled alone so it can
                    # never eat the next writer's config line
                    log.error("stray non-frame line: %r", line1)
                    self.counters["server_frames_malformed_total"] += 1
                    self._answer_malformed(line1)
                    continue
                line2 = self._next_line(fd, timeout=self.FRAME_TIMEOUT_S)
                if line2 is None:
                    log.error("half frame (no line 2 within %.1fs): %r",
                              self.FRAME_TIMEOUT_S, line1)
                    self.counters["server_frames_half_total"] += 1
                    continue
                if STOP_TOKEN in line2:
                    # a stop chasing a truncated request still wins
                    log.info("worker %d: stop requested", self.wid)
                    return
                if line2.lstrip().startswith("{"):
                    # the previous writer truncated: this config line
                    # starts the next frame
                    log.error("config-only half frame: %r", line1)
                    self.counters["server_frames_half_total"] += 1
                    self._rdbuf = line2.encode() + self._rdbuf
                    continue
                text = line1 + line2
                try:
                    req = Request.decode(text)
                except ValueError as e:
                    log.error("bad request: %s", e)
                    self.counters["server_frames_malformed_total"] += 1
                    self._answer_malformed(text)
                    continue
                try:
                    stats = self.handle(req)
                    self.counters["worker_batches_total"] += 1
                except Exception as e:  # noqa: BLE001 — never leave the
                    # head blocked on `cat answer`: answer FAIL. A CUDA
                    # error is sticky, so every later batch fails too
                    log.exception("batch failed: %s", e)
                    self.counters["server_batches_failed_total"] += 1
                    self._last_error = f"{type(e).__name__}: {e}"
                    stats = StatsRow.failed()
                self._reply(req.answerfifo, stats.encode_wire() + "\n")
        finally:
            os.close(fd)
            if os.path.exists(self.command_fifo):
                os.remove(self.command_fifo)

    def _next_line(self, fd: int, timeout: float | None = None):
        """Next newline-terminated line off the persistent FIFO fd (own
        buffering: a buffered file object would hide pipe data from
        ``select``). ``timeout`` bounds the TOTAL wait (None = forever),
        so a byte-trickling writer cannot hold a half-frame wait open.
        Returns None on timeout."""
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        while True:
            nl = self._rdbuf.find(b"\n")
            if nl >= 0:
                line = self._rdbuf[:nl + 1]
                self._rdbuf = self._rdbuf[nl + 1:]
                return line.decode(errors="replace")
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                ready, _, _ = select.select([fd], [], [], remaining)
                if not ready:
                    return None
            chunk = os.read(fd, 4096)
            if not chunk:       # cannot happen with our own O_RDWR write
                time.sleep(0.01)
            self._rdbuf += chunk

    @property
    def reply_deadline_s(self) -> float:
        """How long to wait for the head to open its answer-FIFO reader
        (``DOS_REPLY_DEADLINE_S``, default 30; a value ≤ 0 degrades to
        the default)."""
        v = env_cast("DOS_REPLY_DEADLINE_S", 30.0, float)
        return v if v > 0 else 30.0

    def _reply(self, answerfifo: str, line: str,
               deadline_s: float | None = None,
               count_drop: bool = True) -> bool:
        """Write one line without ever wedging the server: a blocking
        ``open(fifo, 'w')`` would hang forever if the head's ``cat`` died
        before opening its end. Non-blocking open with a bounded
        deadline; the reply is dropped (logged, and counted unless
        ``count_drop`` is False) if no reader appears. Returns True iff
        the line was written."""
        wait_s = (deadline_s if deadline_s is not None
                  else self.reply_deadline_s)
        deadline = time.monotonic() + wait_s
        fd = -1
        while fd < 0:
            try:
                fd = os.open(answerfifo, os.O_WRONLY | os.O_NONBLOCK)
            except OSError as e:
                if (e.errno not in (errno.ENXIO, errno.ENOENT)
                        or time.monotonic() > deadline):
                    log.error("no reader on %s (%s); dropping reply",
                              answerfifo, e)
                    if count_drop:
                        self.counters["server_replies_dropped_total"] += 1
                    return False
                time.sleep(0.05)
        try:
            # reader present: restore blocking mode for the write itself
            fcntl.fcntl(fd, fcntl.F_SETFL,
                        fcntl.fcntl(fd, fcntl.F_GETFL) & ~os.O_NONBLOCK)
            os.write(fd, line.encode())
            if count_drop:
                self.counters["server_replies_sent_total"] += 1
            return True
        except OSError as e:
            # reader vanished between open and write: drop, never crash
            log.error("reply to %s failed: %s", answerfifo, e)
            if count_drop:
                self.counters["server_replies_dropped_total"] += 1
            return False
        finally:
            os.close(fd)

    def _answer_malformed(self, text: str) -> None:
        """Best effort: find an answer-FIFO path among the tokens of a
        malformed request and send the failure sentinel, so the head's
        ``cat <answer>`` never blocks forever."""
        for line in text.strip("\n").split("\n"):
            for tok in line.split():
                try:
                    if stat.S_ISFIFO(os.stat(tok).st_mode):
                        self._reply(
                            tok, StatsRow.failed().encode_wire() + "\n",
                            deadline_s=self.MALFORMED_REPLY_DEADLINE_S)
                        return
                except OSError:
                    continue

    def _answer_ping(self, line: str) -> None:
        """Answer ``__DOS_PING__ <answerfifo>`` with one health line."""
        toks = line.split()
        if len(toks) < 2:
            log.error("ping frame names no answer FIFO: %r", line)
            return
        if self._reply(toks[1], self._health_status().to_json() + "\n",
                       deadline_s=self.PING_REPLY_DEADLINE_S,
                       count_drop=False):
            self.counters["server_pings_answered_total"] += 1

    def _health_status(self) -> HealthStatus:
        c = self.counters
        return HealthStatus(
            ok=True, wid=self.wid, pid=os.getpid(),
            uptime_s=time.monotonic() - self._t_start,
            batches=(c["worker_batches_total"]
                     + c["server_batches_failed_total"]),
            batch_failures=c["server_batches_failed_total"],
            dropped=c["server_replies_dropped_total"],
            last_error=self._last_error,
        )

    def stop_file(self) -> None:
        """Write the stop token into our own FIFO (for another process)."""
        stop_server(self.command_fifo)

    # ------------------------------------------------------------ metrics
    def metrics_snapshot(self) -> dict:
        """The ``--metrics-dump`` payload: the serve loop's counters, the
        walk's kernel launches (raw, pack4) and plain walks, the A*
        kernels' launches (K6: the sweep, its launches without the skip,
        the heuristic) and plain runs (the batch loop, the heuristic),
        and the device with its peak allocated bytes."""
        dev = self.engine.device
        on_card = dev.type == "cuda"
        return {
            "counters": {
                **self.counters,
                "cuda_walk_batch.launches": cuda_walk_batch.launches,
                "cuda_walk_batch.launches_pack4":
                    cuda_walk_batch.launches_pack4,
                "cuda_walk_batch.plain": cuda_walk_batch.plain,
                "astar_sweep.launches": astar_sweep.launches,
                "astar_sweep.dense": astar_sweep.dense,
                "astar_batch.plain": astar_batch.plain,
                "astar_heuristic.launches": astar_heuristic.launches,
                "astar_heuristic.plain": astar_heuristic.plain,
            },
            "alg": self.alg,
            "device": {
                "type": dev.type,
                "name": (torch.cuda.get_device_name(dev) if on_card
                         else "cpu"),
                "max_memory_allocated": (
                    int(torch.cuda.max_memory_allocated(dev)) if on_card
                    else 0),
                "resident_codec": self.engine.resident_codec,
                "resident_bytes": self.engine.resident_bytes,
            },
            "wid": self.wid,
            "pid": os.getpid(),
        }


def stop_server(command_fifo: str, deadline_s: float = 2.0) -> bool:
    """Push the stop token; never wedge the caller.

    A blocking ``open(fifo, "w")`` hangs forever when the server is
    already dead (its FIFO left behind with no reader), so open
    non-blocking and give up, logged, after ``deadline_s``. Returns True
    iff the token was delivered."""
    deadline = time.monotonic() + deadline_s
    fd = -1
    while fd < 0:
        try:
            fd = os.open(command_fifo, os.O_WRONLY | os.O_NONBLOCK)
        except OSError as e:
            if e.errno == errno.ENOENT:
                log.info("no FIFO at %s; server already gone",
                         command_fifo)
                return False
            if e.errno != errno.ENXIO:
                log.error("cannot open %s to stop server: %s",
                          command_fifo, e)
                return False
            if time.monotonic() > deadline:
                log.warning("no server reading %s within %.1fs; "
                            "skipping stop", command_fifo, deadline_s)
                return False
            time.sleep(0.05)
    try:
        os.write(fd, (STOP_TOKEN + "\n").encode())
        return True
    except OSError as e:
        log.warning("stop token to %s failed: %s", command_fifo, e)
        return False
    finally:
        os.close(fd)


#: flags of the JAX server that parse here and are refused, with the item
#: that ports each
REFUSED_FLAGS = {
    "traffic_dir": ("--traffic-dir", "A14"),
    "rpc_socket": ("--rpc-socket", "A14"),
    "rpc_port": ("--rpc-port", "A14"),
    "obs_port": ("--obs-port", "A14"),
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-c", default="./example-cluster-conf.json",
                   help="cluster config JSON")
    p.add_argument("-w", "--workerid", type=int, required=True)
    p.add_argument("--fifo", default=None,
                   help="command FIFO path override")
    p.add_argument("--alg", default="table-search",
                   choices=["table-search", "astar"],
                   help="serving algorithm: table-search (the "
                        "reference's, make_fifos.py:20) or astar (the "
                        "hscale/fscale weighted-A* family; batched on the "
                        "device, no index needed)")
    p.add_argument("--device", default="cuda",
                   help="torch device the shard is served from "
                        "(default: cuda; raises without a GPU)")
    p.add_argument("-v", "--verbose", action="count", default=0)
    p.add_argument("--metrics-dump", default="",
                   help="write the server's counters, walk launches, "
                        "device and peak device memory as JSON to this "
                        "path on clean shutdown")
    for dest, (flag, _item) in REFUSED_FLAGS.items():
        p.add_argument(flag, dest=dest, default=None,
                       help=argparse.SUPPRESS)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    for dest, (flag, item) in REFUSED_FLAGS.items():
        if getattr(args, dest) is not None:
            raise SystemExit(f"{flag} is not ported (ROADMAP.md {item})")
    set_verbosity(args.verbose)
    set_worker_id(args.workerid)
    conf = ClusterConfig.load(args.c)
    server = FifoServer(conf, args.workerid, command_fifo=args.fifo,
                        alg=args.alg, device=args.device)
    try:
        server.serve_forever()
    finally:
        if args.metrics_dump:
            atomic_write_json(args.metrics_dump, server.metrics_snapshot())
    return 0


if __name__ == "__main__":
    sys.exit(main())
