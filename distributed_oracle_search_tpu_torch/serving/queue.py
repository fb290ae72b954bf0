"""Bounded per-shard request queue — the admission-control half of the
online path.

``try_put`` NEVER blocks: a full queue returns False and the frontend
sheds the request ``BUSY`` immediately (load beyond the bound must turn
into fast, explicit rejections, not latency). ``get_batch`` is the
micro-batcher's collection primitive: block for the first request, then
keep collecting until the batch hits ``max_batch`` or ``max_wait_s``
has elapsed since that FIRST request was enqueued — the adaptive
trade of a few milliseconds of waiting for fuller compiled-program
batches.
"""

from __future__ import annotations

import threading
import time
from collections import deque

from ..obs import metrics as obs_metrics
from ..utils.locks import ordered_condition
from .request import ServeRequest

G_DEPTH = obs_metrics.gauge(
    "serve_queue_depth", "requests queued across all shard queues")

#: idle wakeup tick: bounds how long get_batch sleeps past a stop/close
#: signal (waits are condition-based, so real work wakes it instantly)
_IDLE_TICK_S = 0.05


class ShardQueue:
    def __init__(self, depth: int, gauge=None):
        if depth <= 0:
            raise ValueError("queue depth must be positive")
        self.depth = int(depth)
        #: optional per-shard depth gauge (the replicated frontend wires
        #: one per queue so failover load shifts are visible per shard;
        #: the aggregate ``serve_queue_depth`` always updates)
        self._gauge = gauge
        self._q: deque[ServeRequest] = deque()
        self._cond = ordered_condition("serving.ShardQueue")
        self._closed = False

    def _book(self, delta: int) -> None:
        G_DEPTH.add(delta)
        if self._gauge is not None:
            self._gauge.add(delta)

    def __len__(self) -> int:
        with self._cond:
            return len(self._q)

    @property
    def closed(self) -> bool:
        return self._closed

    def try_put(self, req: ServeRequest) -> bool:
        """Admit ``req`` unless the queue is full or closed. Never
        blocks; stamps ``req.t_enqueue`` on success."""
        with self._cond:
            if self._closed or len(self._q) >= self.depth:
                return False
            req.t_enqueue = time.monotonic()
            self._q.append(req)
            self._book(1)
            self._cond.notify()
            return True

    def close(self) -> None:
        """Refuse new requests; pending ones stay collectable so a
        drain can finish them."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def drain(self) -> list[ServeRequest]:
        """Take everything still queued (shutdown path: the caller
        completes them so no waiter ever hangs)."""
        with self._cond:
            out = list(self._q)
            self._q.clear()
            if out:
                self._book(-len(out))
            return out

    def get_batch(self, max_batch: int, max_wait_s: float,
                  stop: threading.Event) -> list[ServeRequest]:
        """Collect the next batch (see module docstring). Returns ``[]``
        when ``stop`` is set (or the queue closed) and nothing is
        queued. If requests already waited past ``max_wait_s`` while an
        earlier batch was in flight, the flush is immediate."""
        with self._cond:
            while not self._q:
                if stop.is_set() or self._closed:
                    return []
                self._cond.wait(_IDLE_TICK_S)
            flush_at = self._q[0].t_enqueue + max_wait_s
            while len(self._q) < max_batch and not stop.is_set():
                remaining = flush_at - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(min(remaining, _IDLE_TICK_S))
            n = min(max_batch, len(self._q))
            batch = [self._q.popleft() for _ in range(n)]
            self._book(-n)
            return batch
