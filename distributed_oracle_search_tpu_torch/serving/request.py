"""Request/result types of the online path + a minimal future.

Statuses are the line protocol's first token and carry the shed
semantics the frontend guarantees:

* ``OK`` — answered; ``cost plen finished`` follow.
* ``BUSY`` — shed at admission: the target shard's bounded queue is
  full. The client should back off and retry; nothing was enqueued.
* ``UNAVAILABLE`` — shed at admission: the target shard's circuit
  breaker is OPEN (worker dead/sick, ``transport.resilience``) or the
  frontend is shutting down. Retrying immediately will keep failing
  until the breaker's probes heal it.
* ``TIMEOUT`` — admitted, but the per-request deadline expired before
  the batch dispatched (overload deeper than the queue bound).
* ``ERROR`` — dispatch ran and failed (engine exception, wire failure,
  malformed input).

Every submitted request terminates in exactly one of these — an
overloaded or broken serving path answers, it never hangs.
"""

from __future__ import annotations

import dataclasses
import threading

OK = "OK"
BUSY = "BUSY"
UNAVAILABLE = "UNAVAILABLE"
TIMEOUT = "TIMEOUT"
ERROR = "ERROR"

#: statuses shed at admission (nothing was enqueued)
SHED = (BUSY, UNAVAILABLE)


class Future:
    """Single-assignment result slot (threading.Event based — no
    executor machinery; the batcher threads call :meth:`set` exactly
    once per request)."""

    __slots__ = ("_ev", "_result")

    def __init__(self):
        self._ev = threading.Event()
        self._result = None

    def set(self, result: "ServeResult") -> None:
        self._result = result
        self._ev.set()

    def done(self) -> bool:
        return self._ev.is_set()

    def result(self, timeout: float | None = None) -> "ServeResult":
        if not self._ev.wait(timeout):
            raise TimeoutError("serve request still pending")
        return self._result

    @classmethod
    def completed(cls, result: "ServeResult") -> "Future":
        f = cls()
        f.set(result)
        return f


@dataclasses.dataclass
class ServeResult:
    """One request's terminal answer (see module docstring for the
    status semantics). ``t_done`` is the completion monotonic timestamp
    (stamped by the frontend) so open-loop load generators can measure
    per-request latency without wrapping every future."""

    status: str
    s: int
    t: int
    cost: int = 0
    plen: int = 0
    finished: bool = False
    cached: bool = False
    detail: str = ""
    t_done: float = 0.0

    @property
    def ok(self) -> bool:
        return self.status == OK

    def encode(self) -> str:
        """Line-protocol response: ``OK <s> <t> <cost> <plen>
        <finished> [cached]`` or ``<STATUS> <s> <t> [detail]``."""
        if self.status == OK:
            line = (f"OK {self.s} {self.t} {self.cost} {self.plen} "
                    f"{int(self.finished)}")
            return line + " cached" if self.cached else line
        line = f"{self.status} {self.s} {self.t}"
        return f"{line} {self.detail}" if self.detail else line


@dataclasses.dataclass
class ServeRequest:
    """One admitted in-flight request. ``t_submit`` anchors the
    end-to-end latency histogram; ``t_enqueue`` (stamped by the queue)
    anchors the batcher's time-to-flush; ``deadline`` is absolute
    monotonic time after which dispatch completes the request
    ``TIMEOUT`` instead of running it."""

    s: int
    t: int
    wid: int
    key: tuple
    t_submit: float
    deadline: float | None = None
    future: Future = dataclasses.field(default_factory=Future)
    t_enqueue: float = 0.0
    #: the batch trace id this request dispatched under (stamped by the
    #: frontend when tracing is on) — the exemplar key that links a bad
    #: latency observation to its Perfetto timeline
    trace_id: str = ""

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now > self.deadline
