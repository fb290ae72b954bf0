"""Lock-order discipline: a drop-in lock with a runtime cycle detector.

The threaded stack (serving queues/batchers, hedged dispatch, circuit
breakers, the supervisor, the metrics registry) holds ~20 locks with no
machine-checked ordering — exactly the setting where a refactor
reintroduces an ABBA deadlock that only fires under production
interleavings. :class:`OrderedLock` is the runtime half of the defense
(``dos-lint``'s ``lock-scope`` rule is the static half):

* **off by default** — without ``DOS_LOCK_CHECK`` an acquire is one
  extra attribute hop over a raw ``threading.Lock``; no graph, no
  bookkeeping. Hot paths (every metric increment) stay cheap.
* **witness mode** (``DOS_LOCK_CHECK=1``, set by the tier-1 conftest) —
  every acquire records the edge *held-lock → acquired-lock* in a
  process-wide lock-order graph keyed by lock NAME (a class of locks,
  e.g. ``resilience.CircuitBreaker``, not one instance — the graph must
  generalize across instances to catch an ABBA pair that one run only
  exercises as AB). A new edge that closes a cycle raises
  :class:`LockOrderError` at the acquire that would make deadlock
  *possible*, even though this particular interleaving did not hang.
  Same-instance re-acquire (self-deadlock of a non-reentrant lock) is
  an immediate error too.
* ``DOS_LOCK_CHECK=warn`` records and logs violations without raising
  (production triage mode); :func:`violations` exposes what fired.

The witness graph persists edges across the process lifetime, so the
detector is cumulative: tier-1's threaded serving/replication/obs tests
double as a continuous lock-order regression suite.

This module must stay import-light (stdlib + ``utils.env``/``log``):
``obs.metrics`` builds its locks from here, so importing ``obs`` back
would cycle.

A copy of the JAX package's ``utils/locks.py``; the lock names, the
witness graph and the check modes are the same.
"""

from __future__ import annotations

import threading

from .env import env_str
from .log import get_logger

log = get_logger(__name__)

#: check modes
OFF, RAISE, WARN = "off", "raise", "warn"


def _mode_from_env() -> str:
    raw = (env_str("DOS_LOCK_CHECK", "") or "").strip().lower()
    if raw in ("1", "true", "yes", "on", "raise"):
        return RAISE
    if raw == "warn":
        return WARN
    return OFF


#: process-wide mode, fixed at import (the tier-1 conftest exports
#: DOS_LOCK_CHECK=1 before the package imports); tests may override via
#: set_checking() for their own scoped locks
_MODE = _mode_from_env()


def checking() -> bool:
    return _MODE != OFF


def set_checking(mode: str | bool) -> str:
    """Override the check mode (tests / debug REPLs). Returns the
    previous mode so callers can restore it."""
    global _MODE
    prev = _MODE
    if mode is True:
        _MODE = RAISE
    elif mode is False:
        _MODE = OFF
    elif mode in (OFF, RAISE, WARN):
        _MODE = mode
    else:
        raise ValueError(f"unknown lock-check mode {mode!r}")
    return prev


class LockOrderError(RuntimeError):
    """Acquiring this lock here makes a deadlock possible (cycle in the
    witness graph) or certain (same-instance re-acquire)."""


class _WitnessGraph:
    """The process-wide lock-order graph: edge A -> B means some thread
    acquired a B-named lock while holding an A-named lock. A cycle means
    two code paths disagree about the order — the ABBA precondition."""

    def __init__(self):
        self._edges: dict[str, set[str]] = {}
        self._violations: list[str] = []
        self._mu = threading.Lock()

    def _path(self, src: str, dst: str) -> list[str] | None:
        """DFS path src -> dst over recorded edges (caller holds _mu)."""
        stack = [(src, [src])]
        seen = {src}
        while stack:
            node, path = stack.pop()
            for nxt in self._edges.get(node, ()):
                if nxt == dst:
                    return path + [dst]
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None

    def add_edge(self, held: str, acquired: str) -> str | None:
        """Record held -> acquired; returns a violation message when the
        edge closes a cycle (the reverse direction was already
        witnessed), None when the order is consistent."""
        with self._mu:
            if acquired in self._edges.get(held, ()):
                return None     # known-good edge, fast path
            back = (self._path(acquired, held)
                    if held != acquired else [held, held])
            self._edges.setdefault(held, set()).add(acquired)
            if back is None:
                return None
            msg = (f"lock-order cycle: acquiring {acquired!r} while "
                   f"holding {held!r}, but the reverse order "
                   f"{' -> '.join(back)} was already witnessed")
            self._violations.append(msg)
            return msg

    def record(self, msg: str) -> None:
        with self._mu:
            self._violations.append(msg)

    def violations(self) -> list[str]:
        with self._mu:
            return list(self._violations)

    def edges(self) -> dict[str, set[str]]:
        with self._mu:
            return {k: set(v) for k, v in self._edges.items()}

    def reset(self) -> None:
        with self._mu:
            self._edges.clear()
            self._violations.clear()


#: the process-wide graph (tests may instantiate their own)
GRAPH = _WitnessGraph()

#: per-thread stack of (name, lock-instance) currently held
_HELD = threading.local()


def _held_stack() -> list:
    st = getattr(_HELD, "stack", None)
    if st is None:
        st = _HELD.stack = []
    return st


def violations() -> list[str]:
    """Every lock-order violation witnessed so far (warn mode keeps
    running; raise mode usually dies at the first)."""
    return GRAPH.violations()


class OrderedLock:
    """``threading.Lock`` plus the witness bookkeeping above.

    ``name`` identifies the lock's CLASS in the order graph — use one
    name per lock role (``"metrics.Counter"``, ``"serving.ShardQueue"``),
    not per instance. Works as a ``with`` target and as the underlying
    lock of a ``threading.Condition`` (``acquire``/``release`` are the
    whole protocol Condition needs).
    """

    __slots__ = ("name", "_lock", "_graph")

    def __init__(self, name: str, graph: _WitnessGraph | None = None):
        self.name = name
        self._lock = threading.Lock()
        self._graph = graph or GRAPH

    # ------------------------------------------------------------ check
    def _check_acquire(self) -> None:
        stack = _held_stack()
        msg = None
        certain = False
        for held_name, held_lock in stack:
            if held_lock is self:
                msg = (f"self-deadlock: thread re-acquiring "
                       f"non-reentrant lock {self.name!r} it already "
                       f"holds")
                certain = True
                self._graph.record(msg)
                break
        else:
            if stack:
                msg = self._graph.add_edge(stack[-1][0], self.name)
        if msg is not None:
            log.error("%s", msg)
            # warn mode downgrades ORDER cycles (deadlock possible) to
            # a log line, but a same-instance re-acquire is deadlock
            # CERTAIN: proceeding would block this thread forever, so
            # it raises in every checking mode
            if _MODE == RAISE or certain:
                raise LockOrderError(msg)

    # ------------------------------------------------------- lock proto
    def acquire(self, blocking: bool = True,
                timeout: float = -1) -> bool:
        if _MODE != OFF:
            self._check_acquire()
            got = self._lock.acquire(blocking, timeout)
            if got:
                _held_stack().append((self.name, self))
            return got
        return self._lock.acquire(blocking, timeout)

    def release(self) -> None:
        # pop unconditionally (not gated on _MODE): a set_checking()
        # flip between a thread's acquire and its release must not
        # strand a stale entry that later reads as a false
        # self-deadlock; in off mode nothing was pushed and the scan
        # sees an empty stack
        stack = getattr(_HELD, "stack", None)
        if stack:
            for i in range(len(stack) - 1, -1, -1):
                if stack[i][1] is self:
                    del stack[i]
                    break
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def _is_owned(self) -> bool:
        """Ownership probe for ``threading.Condition``: without this,
        Condition falls back to a non-blocking ``acquire(False)`` on a
        lock the calling thread already holds — which the self-deadlock
        check would (rightly) flag. In checking mode the held stack
        answers exactly; in off mode, stdlib's own approximation."""
        if _MODE != OFF:
            return any(lck is self for _, lck in _held_stack())
        if self._lock.acquire(False):
            self._lock.release()
            return False
        return True

    def __enter__(self) -> "OrderedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<OrderedLock {self.name!r} {'locked' if self.locked() else 'unlocked'}>"


def ordered_condition(name: str) -> threading.Condition:
    """A ``Condition`` whose mutex participates in the order graph
    (``wait`` releases through :meth:`OrderedLock.release`, so the held
    stack stays truthful across waits)."""
    return threading.Condition(OrderedLock(name))
