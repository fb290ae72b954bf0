"""Per-shard adaptive micro-batcher: two threads, one batch in flight.

The **collector** thread forms batches off the shard's
:class:`~.queue.ShardQueue` (flush at the power-of-two ``max_batch`` or
on ``max_wait_ms`` expiry) and hands them through a depth-1 queue to the
**runner** thread, which executes the dispatch callback. The depth-1
handoff is the pipelining contract: exactly ONE batch is in flight on
the shard while the collector is already forming (and the frontend's
dispatch callback is host-prepping) the next — and when the shard falls
behind, the handoff's backpressure makes waiting batches grow toward
``max_batch`` instead of racing out as singletons, which is what makes
the batching *adaptive*: batch size tracks load.

Threads are named ``dos-serve-*`` — the test suite's leak check
(tests/conftest.py) holds every ``dos-*`` thread to the
joined-on-shutdown contract, and :meth:`MicroBatcher.stop` joins both.
"""

from __future__ import annotations

import queue as _stdqueue
import threading
import time

from ..obs import metrics as obs_metrics
from ..utils.log import get_logger
from .queue import ShardQueue
from .request import ERROR, ServeRequest, ServeResult

log = get_logger(__name__)

M_BATCHES = obs_metrics.counter(
    "serve_batches_total", "batches dispatched by the micro-batchers")
M_FLUSH_FULL = obs_metrics.counter(
    "serve_flush_full_total", "flushes triggered by max_batch")
M_FLUSH_WAIT = obs_metrics.counter(
    "serve_flush_wait_total", "flushes triggered by max_wait_ms expiry")
# dos-lint: disable=metric-registry -- serve_batch_fill is a
#   dimensionless batch-SIZE histogram, not a latency: the power-of-two
#   buckets are the unit, a _seconds suffix would misdescribe it
H_FILL = obs_metrics.histogram(
    "serve_batch_fill", "dispatched batch size (requests)",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024))
H_FLUSH = obs_metrics.histogram(
    "serve_time_to_flush_seconds",
    "first request enqueued until its batch flushed")
H_DISPATCH = obs_metrics.histogram(
    "serve_dispatch_seconds", "batch dispatch (engine call or wire "
    "round-trip) as seen by the runner thread")
G_INFLIGHT = obs_metrics.gauge(
    "serve_batches_in_flight", "batches currently executing")


class MicroBatcher:
    """One shard's batcher. ``dispatch(batch)`` must complete every
    request's future; the runner backstops a raising dispatch so no
    future is ever left pending."""

    def __init__(self, wid: int, shard_queue: ShardQueue, dispatch,
                 max_batch: int, max_wait_s: float):
        self.wid = wid
        self.queue = shard_queue
        self.dispatch = dispatch
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_s)
        self._handoff: _stdqueue.Queue = _stdqueue.Queue(maxsize=1)
        self._stop = threading.Event()
        #: THIS batcher's dispatch-in-progress flag — stop() must drain
        #: on it, not on the process-global in-flight gauge, or one busy
        #: shard (or a second frontend) would stall every other shard's
        #: shutdown for the full drain budget
        self._dispatching = False
        self._collector = threading.Thread(
            target=self._collect_loop, daemon=True,
            name=f"dos-serve-collect-w{wid}")
        self._runner = threading.Thread(
            target=self._run_loop, daemon=True,
            name=f"dos-serve-dispatch-w{wid}")

    def start(self) -> None:
        self._collector.start()
        self._runner.start()

    # ---------------------------------------------------------- threads
    def _collect_loop(self) -> None:
        while True:
            batch = self.queue.get_batch(self.max_batch, self.max_wait_s,
                                         self._stop)
            if not batch:
                # a closed, drained queue is terminal (try_put refuses
                # once closed): exit instead of spinning on instant
                # empty get_batch returns until stop() gets to us
                if self._stop.is_set() or self.queue.closed:
                    return
                continue
            H_FILL.observe(len(batch))
            H_FLUSH.observe(time.monotonic() - batch[0].t_enqueue)
            (M_FLUSH_FULL if len(batch) >= self.max_batch
             else M_FLUSH_WAIT).inc()
            while True:
                try:
                    self._handoff.put(batch, timeout=_HANDOFF_TICK_S)
                    break
                except _stdqueue.Full:
                    if self._stop.is_set():
                        _fail_batch(batch, "shutdown")
                        return

    def _run_loop(self) -> None:
        while True:
            try:
                batch = self._handoff.get(timeout=_HANDOFF_TICK_S)
            except _stdqueue.Empty:
                if self._stop.is_set():
                    return
                continue
            self._dispatching = True
            G_INFLIGHT.add(1)
            t0 = time.perf_counter()
            try:
                self.dispatch(batch)
            except Exception as e:  # noqa: BLE001 — a dispatch bug must
                # never strand waiters or kill the shard's runner
                log.exception("shard w%d batch dispatch raised: %s",
                              self.wid, e)
            finally:
                G_INFLIGHT.add(-1)
                self._dispatching = False
                H_DISPATCH.observe(time.perf_counter() - t0)
                M_BATCHES.inc()
                _fail_batch(batch, "dispatch-raised")  # only undone ones

    # --------------------------------------------------------- shutdown
    def stop(self, drain_s: float = 5.0) -> None:
        """Close the queue, give in-flight/queued work ``drain_s`` to
        finish, then stop both threads and fail anything left — every
        admitted request still terminates."""
        self.queue.close()
        deadline = time.monotonic() + max(drain_s, 0.0)
        while time.monotonic() < deadline:
            if (len(self.queue) == 0 and self._handoff.empty()
                    and not self._dispatching):
                break
            time.sleep(0.01)
        self._stop.set()
        for t in (self._collector, self._runner):
            if t.is_alive():
                t.join(timeout=drain_s + 1.0)
        _fail_batch(self.queue.drain(), "shutdown")
        while True:
            try:
                _fail_batch(self._handoff.get_nowait(), "shutdown")
            except _stdqueue.Empty:
                break


#: wakeup tick for the depth-1 handoff waits (stop-signal latency bound)
_HANDOFF_TICK_S = 0.05


def _fail_batch(batch: list[ServeRequest], detail: str) -> None:
    """Complete every still-pending request with ERROR (idempotent:
    completed futures are skipped)."""
    now = time.monotonic()
    for r in batch:
        if not r.future.done():
            r.future.set(ServeResult(ERROR, r.s, r.t, detail=detail,
                                     t_done=now))
