"""Line-protocol ingress: stdin, unix socket, and file-tail.

Protocol (one request per line, responses in request order):

    request:   ``<s> <t>``            (node ids; blank lines and
                                       ``#`` comments are skipped)
               ``mat <s> <t1> ... <tk>``   one-to-many ETA matrix row
               ``alt <s> <t> <k>``         k-alternative routes
               ``rev <s> <t>``             reverse (return-trip) route
    response:  ``OK <s> <t> <cost> <plen> <finished> [cached]``
               ``MAT <s> <k> <c1> ... <ck>``    (-1 = unanswered)
               ``ALT <s> <t> <n> <c1> ... <cn>`` (ascending, n <= k)
               ``REV <s> <t> <cost> <plen> <finished>``
               ``BUSY|UNAVAILABLE|TIMEOUT|ERROR <s> <t> [detail]``
    control:   ``quit``               closes the session

The typed family sentences (``traffic.families``) are accepted only
when the caller wires a :class:`~..traffic.QueryFamilies` planner;
without one they answer ``ERROR`` like any malformed line, so a plain
pair-only deployment's protocol surface is unchanged.

The reader NEVER blocks per request — it submits and moves on, which is
what lets back-to-back lines coalesce into real micro-batches; a writer
thread completes responses in submission order. A malformed line gets an
in-order ``ERROR -1 -1 malformed-line`` response instead of desyncing
the stream.
"""

from __future__ import annotations

import os
import queue as _stdqueue
import socket
import threading
import time

from ..utils.log import get_logger
from .frontend import ServingFrontend
from .request import ERROR, Future, ServeResult

log = get_logger(__name__)

QUIT_TOKEN = "quit"


def parse_query_line(line: str) -> tuple[int, int]:
    toks = line.split()
    if len(toks) != 2:
        raise ValueError(f"want '<s> <t>', got {line!r}")
    return int(toks[0]), int(toks[1])


def serve_stream(frontend: ServingFrontend, rfile, wfile,
                 result_timeout_s: float | None = None,
                 families=None) -> int:
    """Run the line protocol over a text-file pair until EOF or
    ``quit``; returns the number of requests handled. The writer drains
    futures in submission order on its own thread so slow shards never
    stall ingestion (ingestion is bounded by the shard queues, which is
    the point). ``families`` (a ``traffic.QueryFamilies``) enables the
    typed mat/alt/rev sentences."""
    if result_timeout_s is None:
        result_timeout_s = frontend.sconf.deadline_s + 30.0
    pending: _stdqueue.Queue = _stdqueue.Queue()
    n = 0

    def _write_loop():
        while True:
            fut = pending.get()
            if fut is None:
                return
            try:
                res = fut.result(result_timeout_s)
            except TimeoutError:
                res = ServeResult(ERROR, -1, -1, detail="result-timeout")
            try:
                wfile.write(res.encode() + "\n")
                wfile.flush()
            except (OSError, ValueError):
                # client gone: keep draining futures so submitters and
                # batcher completions are not stranded, drop the writes
                continue

    writer = threading.Thread(target=_write_loop, daemon=True,
                              name="dos-serve-writer")
    writer.start()
    if families is not None:       # once, not per line on the hot loop
        from ..traffic.families import parse_family_line
    try:
        for line in rfile:
            body = line.strip()
            if not body or body.startswith("#"):
                continue
            if body == QUIT_TOKEN:
                break
            if families is not None:
                try:
                    fam = parse_family_line(body)
                except ValueError:
                    pending.put(Future.completed(ServeResult(
                        ERROR, -1, -1, detail="malformed-line")))
                    continue
                if fam is not None:
                    try:
                        fut = families.submit_line(*fam)
                    except Exception as e:  # noqa: BLE001 — a bad
                        # family request (out-of-range node, missing
                        # graph) must answer in-order like a malformed
                        # line, never kill the whole session
                        detail = (str(e).split("\n")[0]
                                  .replace(" ", "-") or "family-failed")
                        pending.put(Future.completed(ServeResult(
                            ERROR, -1, -1, detail=detail)))
                        continue
                    pending.put(fut)
                    n += 1
                    continue
            try:
                s, t = parse_query_line(body)
            except ValueError:
                pending.put(Future.completed(ServeResult(
                    ERROR, -1, -1, detail="malformed-line")))
                continue
            pending.put(frontend.submit(s, t))
            n += 1
    finally:
        pending.put(None)
        writer.join(timeout=result_timeout_s + 5.0)
    return n


def serve_stdin(frontend: ServingFrontend, families=None) -> int:
    import sys

    return serve_stream(frontend, sys.stdin, sys.stdout,
                        families=families)


def serve_unix_socket(frontend: ServingFrontend, path: str,
                      stop: threading.Event | None = None,
                      families=None) -> None:
    """Accept loop on a unix stream socket; one ``serve_stream`` session
    per connection. Bounded accept timeout so ``stop`` (or KeyboardInterrupt)
    is honored promptly; connection threads are joined on exit."""
    stop = stop or threading.Event()
    if os.path.exists(path):
        os.remove(path)
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(path)
    srv.listen(16)
    srv.settimeout(0.25)
    log.info("serving line protocol on unix socket %s", path)
    conns: list[threading.Thread] = []

    def _session(sock: socket.socket) -> None:
        with sock:
            rfile = sock.makefile("r")
            wfile = sock.makefile("w")
            try:
                serve_stream(frontend, rfile, wfile,
                             families=families)
            except Exception as e:  # noqa: BLE001 — one bad client
                # must not kill the accept loop
                log.warning("socket session failed: %s", e)

    try:
        while not stop.is_set():
            try:
                sock, _ = srv.accept()
            except socket.timeout:
                continue
            th = threading.Thread(target=_session, args=(sock,),
                                  daemon=True, name="dos-serve-conn")
            th.start()
            # prune finished sessions so a long-lived service doesn't
            # accumulate one dead Thread per connection forever
            conns = [t for t in conns if t.is_alive()]
            conns.append(th)
    finally:
        srv.close()
        if os.path.exists(path):
            os.remove(path)
        for th in conns:
            th.join(timeout=5.0)


def tail_file(frontend: ServingFrontend, path: str,
              out_path: str | None = None,
              stop: threading.Event | None = None,
              poll_s: float = 0.2, families=None) -> int:
    """Follow ``path`` for appended request lines (the dead-simple
    ingress for batch producers that can only write files); responses
    append to ``<path>.answers``. A ``quit`` line ends the tail."""
    stop = stop or threading.Event()
    out_path = out_path or path + ".answers"
    n = 0
    with open(out_path, "a") as wfile:
        # wait for the input to exist so an operator can start the
        # server before the producer
        while not os.path.exists(path):
            if stop.is_set():
                return 0
            time.sleep(poll_s)
        with open(path) as rfile:

            def _lines():
                while not stop.is_set():
                    line = rfile.readline()
                    if not line:
                        time.sleep(poll_s)
                        continue
                    if not line.endswith("\n"):
                        # partial write: wait for the rest of the line
                        while (not line.endswith("\n")
                               and not stop.is_set()):
                            chunk = rfile.readline()
                            if not chunk:
                                time.sleep(poll_s)
                                continue
                            line += chunk
                    yield line

            n = serve_stream(frontend, _lines(), wfile,
                             families=families)
    return n
