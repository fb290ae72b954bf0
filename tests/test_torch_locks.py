"""PyTorch port, ``utils.locks`` against the JAX package's: every case of
``tests/test_locks.py`` (consistent orders, ABBA and longer cycles,
self-deadlock, same-name instances, warn / off / raise modes, a mode
flip mid-hold, out-of-order release, non-blocking acquire under
contention, ``threading.Condition`` over an ordered lock) runs on a
private witness graph of each package, and the outcomes — what raised,
the violation messages, the recorded edges — are equal. The port's own
serve-path locks (breakers, RPC client, metrics) record edges in its
process-wide graph without a violation."""

import threading

import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)

from distributed_oracle_search_tpu.utils import locks as j_locks  # noqa: E402
from distributed_oracle_search_tpu_torch.utils import locks as t_locks  # noqa: E402

PACKAGES = {"jax": j_locks, "torch": t_locks}


def _raises(fn) -> str | None:
    """The message of the ``LockOrderError`` ``fn`` raised, else None."""
    try:
        fn()
    except RuntimeError as e:
        assert type(e).__name__ == "LockOrderError"
        return str(e)
    return None


def consistent(m, g):
    a, b = m.OrderedLock("t.A", g), m.OrderedLock("t.B", g)
    for _ in range(3):
        with a:
            with b:
                pass
    return None


def abba(m, g):
    a, b = m.OrderedLock("t.A", g), m.OrderedLock("t.B", g)
    with a:
        with b:
            pass

    def reverse():
        with b:
            with a:
                pass
    return _raises(reverse)


def longer_cycle(m, g):
    a, b, c = (m.OrderedLock(n, g) for n in ("t.A", "t.B", "t.C"))
    with a:
        with b:
            pass
    with b:
        with c:
            pass

    def close():
        with c:
            with a:
                pass
    return _raises(close)


def self_deadlock(m, g):
    a = m.OrderedLock("t.A", g)
    with a:
        return _raises(a.acquire)


def same_name(m, g):
    a1, a2 = m.OrderedLock("t.Peer", g), m.OrderedLock("t.Peer", g)
    with a1:
        return _raises(a2.acquire)


def warn_self_deadlock(m, g):
    m.set_checking("warn")
    return self_deadlock(m, g)


def _plain_abba(m, g):
    a, b = m.OrderedLock("t.A", g), m.OrderedLock("t.B", g)
    with a:
        with b:
            pass
    with b:
        with a:
            pass


def warn_records(m, g):
    m.set_checking("warn")
    _plain_abba(m, g)


def off_mode(m, g):
    m.set_checking(False)
    _plain_abba(m, g)


def mode_flip(m, g):
    a = m.OrderedLock("t.Flip", g)
    a.acquire()
    m.set_checking(False)
    a.release()
    m.set_checking("raise")

    def again():
        with a:
            pass
    return _raises(again)


def out_of_order_release(m, g):
    a, b = m.OrderedLock("t.A", g), m.OrderedLock("t.B", g)
    a.acquire()
    b.acquire()
    a.release()
    b.release()
    return None


def nonblocking(m, g):
    lock = m.OrderedLock("t.NB", g)
    got = lock.acquire(blocking=False)
    holder = {}
    th = threading.Thread(
        target=lambda: holder.update(got=lock.acquire(blocking=False)))
    th.start()
    th.join()
    lock.release()
    return (got, holder["got"])


def condition(m, g):
    cond = threading.Condition(m.OrderedLock("t.Cond", g))
    state = {"ready": False, "seen": False}

    def waiter():
        with cond:
            while not state["ready"]:
                cond.wait(timeout=5.0)
            state["seen"] = True

    th = threading.Thread(target=waiter)
    th.start()
    with cond:
        state["ready"] = True
        cond.notify()
    th.join(timeout=5.0)
    return state["seen"]


CASES = {
    "consistent": (consistent, None),
    "abba": (abba, "cycle"),
    "longer-cycle": (longer_cycle, "t.A"),
    "self-deadlock": (self_deadlock, "self-deadlock"),
    "same-name": (same_name, ""),
    "warn-self-deadlock": (warn_self_deadlock, "self-deadlock"),
    "warn-records": (warn_records, None),
    "off-mode": (off_mode, None),
    "mode-flip": (mode_flip, None),
    "out-of-order-release": (out_of_order_release, None),
    "nonblocking": (nonblocking, None),
    "condition": (condition, None),
}


def _outcome(m, fn):
    g = m._WitnessGraph()
    prev = m.set_checking("raise")
    try:
        out = fn(m, g)
    finally:
        m.set_checking(prev)
    return out, g.violations(), {k: sorted(v) for k, v in
                                 sorted(g.edges().items())}


@pytest.mark.parametrize("case", list(CASES))
def test_lock_order_detector_equals_jax(case):
    fn, expect = CASES[case]
    got = {name: _outcome(m, fn) for name, m in PACKAGES.items()}
    assert got["torch"] == got["jax"]
    out, violations, edges = got["torch"]
    if expect is None:
        assert not (isinstance(out, str) and out)
    else:
        assert isinstance(out, str) and expect in out
    if case in ("consistent", "out-of-order-release", "mode-flip",
                "nonblocking", "condition"):
        assert violations == []
    if case == "consistent":
        assert edges == {"t.A": ["t.B"]}
    if case == "warn-records":
        assert any("cycle" in v for v in violations)
    if case == "off-mode":
        assert violations == [] and edges == {}
    if case == "nonblocking":
        assert out == (True, False)
    if case == "condition":
        assert out is True


def test_port_serve_path_locks_are_acyclic():
    """The port's breaker registry, RPC client cache and metrics record
    edges in the process-wide witness graph (raise mode), none closing a
    cycle."""
    from distributed_oracle_search_tpu_torch.transport import rpc
    from distributed_oracle_search_tpu_torch.transport.resilience import (
        BreakerRegistry,
    )

    prev = t_locks.set_checking("raise")
    try:
        reg = BreakerRegistry(threshold=1, enabled=True)
        for wid in (0, 1):
            assert reg.allow((wid, "h"))
            reg.record((wid, "h"), wid == 0)
        reg.shutdown()
        rpc.client_for(0).close()
        rpc.close_clients()
        assert "metrics.Counter" in t_locks.GRAPH.edges().get(
            "resilience.CircuitBreaker", set())
        assert t_locks.violations() == []
    finally:
        t_locks.set_checking(prev)
