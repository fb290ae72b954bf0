"""PyTorch port, the closed-loop control plane (``control/``) against
the JAX package's.

The JAX package's ``tests/test_control.py`` cases run over the port
(``torch_port_cases``), on CPU engines, all of them: the cases that
drive a ``WorkerSupervisor`` run over the port's
``worker/supervisor.py``."""

import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)
from torch_port_cases import load_cases  # noqa: E402

globals().update(load_cases("test_control.py", __name__, drop={}))


# ------------------------------------------- across the two packages

import numpy as np  # noqa: E402

from torch_parity import both  # noqa: E402


def _signal_seq(P, seed, n=80):
    """One seeded sequence of sensor snapshots for a 4-worker fleet."""
    rng = np.random.default_rng(seed)
    seq = []
    for i in range(n):
        wids = range(4)
        seq.append(P.signals.ControlSignals(
            now=100.0 + 2.0 * i,
            fast_burn=(None if i % 17 == 3
                       else float(rng.choice([0.5, 3.0, 12.0, 30.0]))),
            queue_frac=float(rng.random()),
            queue_depths={w: int(rng.integers(0, 64)) for w in wids},
            credit_frac=float(rng.random()),
            worker_running={w: bool(rng.random() > 0.1) for w in wids},
            ping_failures={w: int(rng.integers(0, 4)) for w in wids},
            telemetry_lag_s={w: float(rng.integers(0, 40))
                             for w in wids},
            hot_shard=int(rng.integers(0, 4)),
            hot_frac=float(rng.random()),
            gateway_dead=tuple(int(f) for f in range(3)
                               if rng.random() > 0.8),
            gateway_lease_stale_s={0: float(rng.random() * 9)},
            audit_divergent={5: i // 9, 2: i // 30}))
    return seq


def _policy_run(P, seed):
    pol = P.policy
    brown = pol.BrownoutLadder(burn_trip=10.0, clear_frac=0.5,
                               hold_ticks=2, cooldown_s=5.0)
    quar = pol.QuarantineManager(unhealthy_pings=3, clean_probes=2,
                                 dead_after_s=12.0, telemetry_lag_s=30.0,
                                 readmit_grace_s=4.0)
    rep = pol.RepairScaler(starve_frac=0.8, hot_frac=0.6, clear_frac=0.5,
                           hold_ticks=2, cooldown_s=6.0,
                           join_host="h9")
    gw = pol.GatewayWatch(cooldown_s=10.0)
    div = pol.DivergenceWatch(cooldown_s=8.0)
    budget = pol.ActionBudget(3, 20.0)
    rng = np.random.default_rng(seed + 1)
    log = []
    for sig in _signal_seq(P, seed):
        now = sig.now
        out = [("brownout", brown.decide(sig.fast_burn, now))]
        for d in quar.decide(sig, now):
            out.append(d)
            if d[0] == "quarantine":
                quar.probe_result(d[1], bool(rng.random() > 0.3))
        out += rep.decide(sig, now) + gw.decide(sig, now)
        out += div.decide(sig, now)
        allowed = budget.allow(now)
        if allowed:
            budget.book(now)
        log.append((out, allowed, quar.quarantined(), brown.level))
    return log


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_policy_decisions_equal_jax(seed):
    """Every policy arm, fed one seeded signal sequence, decides the
    same as the JAX package's, tick for tick."""
    got = both(lambda P: _policy_run(P, seed))
    assert got["torch"] == got["jax"]
    assert any(out for out, *_ in got["torch"])


class _Auditor:
    def __init__(self, counts):
        self.counts = counts

    def snapshot(self):
        return dict(self.counts)


def _daemon_run(P):
    """A daemon over an auditor whose counts grow and a probe that
    fails once: the decisions, the breaker, the recorder events and the
    statusz it keeps."""
    counts = {}
    scrubbed = []
    probes = iter([False, True, True, True, True])
    reg = P.resilience.BreakerRegistry(threshold=3, cooldown_s=600.0,
                                       enabled=True)
    d = P.control.ControlDaemon(
        P.control.ControlConfig(enabled=True, hold_ticks=1,
                                cooldown_s=0.0, clean_probes=1),
        registry=reg, breaker_key=lambda w: w,
        integrity=_Auditor(counts), scrub_fn=scrubbed.append,
        probe_fn=lambda wid: next(probes))
    P.recorder.drain_pending()
    out = []
    try:
        for i in range(6):
            if i in (1, 4):
                counts[5] = counts.get(5, 0) + 1
            d.tick(now=100.0 + i)
            evs = [{k: v for k, v in e.items() if k not in ("ts", "pid")}
                   for e in P.recorder.drain_pending()
                   if e["kind"].startswith("control_")]
            out.append((d.last_action, d.quarantine.quarantined(),
                        reg.allow(5), evs))
    finally:
        reg.shutdown()
    st = d.statusz()
    return out, scrubbed, {k: st[k] for k in sorted(st)
                           if k not in ("uptime_s",)}


def test_daemon_divergence_arm_equal_jax():
    """The daemon's divergence-quarantine loop (quarantine, scrub-now,
    probed re-admission) acts, books and reports as the JAX daemon."""
    got = both(_daemon_run)
    assert got["torch"] == got["jax"]
    assert got["torch"][1] == [5, 5]
