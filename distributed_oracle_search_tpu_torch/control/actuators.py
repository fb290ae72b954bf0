"""Act: every reconfiguration the daemon can execute, behind one seam.

The daemon never touches a subsystem directly — it calls these
methods, which makes dry-run trivial (skip the call, book the
decision), keeps every action unit-testable against stubs, and gives
the chaos drill one place to spy on. Slow actions (membership moves)
run on short-lived worker threads so a multi-second catch-up never
stalls the sense loop; the daemon joins them on stop.

Brownout state is owned here: the pristine frontend knobs are captured
the first time level 0 is left, and level 0 restores them exactly —
the ladder can never drift the configuration."""

from __future__ import annotations

import threading

from ..utils.log import get_logger
from .policy import (BROWNOUT_DEADLINE_SCALE, BROWNOUT_HEDGE_SCALE,
                     BROWNOUT_SHED_FAMILIES)

log = get_logger(__name__)


class Actuators:
    """Execution seam. Every provider is optional; an action whose
    provider is absent raises ``RuntimeError`` (the daemon books it as
    an error — a policy firing actions it has no actuator for is a
    wiring bug worth surfacing, not silently ignoring)."""

    def __init__(self, *, frontend=None, supervisor=None, registry=None,
                 breaker_key=None, membership=None, replicate_fn=None,
                 warm_fns=(), gateway_respawn_fn=None, scrub_fn=None):
        self.frontend = frontend
        self.supervisor = supervisor
        self.registry = registry
        if breaker_key is None and frontend is not None:
            breaker_key = getattr(frontend, "_breaker_key", None)
        self.breaker_key = breaker_key or (lambda wid: wid)
        self.membership = membership
        self.replicate_fn = replicate_fn
        self.warm_fns = list(warm_fns)
        self.gateway_respawn_fn = gateway_respawn_fn
        #: ``scrub_fn(shard)`` asks the resident-table scrubber for an
        #: immediate pass over one shard (``TableScrubber.scrub_now``)
        self.scrub_fn = scrub_fn
        self._orig = None           # pristine (hedge_budget, deadline_ms)
        self._threads: list[threading.Thread] = []
        self._tlock = threading.Lock()

    # -------------------------------------------------------- brownout
    def apply_brownout(self, level: int) -> None:
        fe = self.frontend
        if fe is None:
            raise RuntimeError("no serving frontend to brown out")
        if self._orig is None:
            self._orig = (fe.hedge.config.budget, fe.sconf.deadline_ms)
        budget0, deadline0 = self._orig
        fe.set_hedge_budget(budget0 * BROWNOUT_HEDGE_SCALE
                            if level >= 1 else budget0)
        fe.set_family_shed(BROWNOUT_SHED_FAMILIES if level >= 2 else ())
        fe.set_deadline_ms(deadline0 * BROWNOUT_DEADLINE_SCALE
                           if level >= 3 else deadline0)

    # ------------------------------------------------------ quarantine
    def quarantine(self, wid: int, why: str) -> None:
        did = False
        if self.registry is not None:
            did |= bool(self.registry.force_open(
                self.breaker_key(wid), why=why))
        if self.supervisor is not None:
            self.supervisor.kick(wid)
            did = True
        if not did:
            raise RuntimeError("no registry or supervisor to "
                               "quarantine with")

    def divergence_quarantine(self, wid: int, why: str) -> None:
        """Pull a shard serving WRONG answers out of routing: force its
        breaker open (wrong answers demand an immediate stop, not a
        supervisor respawn — the process is healthy, its data is not)
        and trigger a scrub-now of that shard so the resident-table
        check runs before the probation loop's clean probes can earn
        re-admission. The scrub half is best-effort: with no scrubber
        wired the breaker pin alone still stops the bleeding."""
        if self.registry is None:
            raise RuntimeError("no breaker registry to quarantine a "
                               "divergent shard with")
        self.registry.force_open(self.breaker_key(wid), why=why)
        if self.scrub_fn is not None:
            try:
                self.scrub_fn(int(wid))
            except Exception as e:  # noqa: BLE001 — the breaker pin is
                # the safety action; a scrub hiccup must not undo it
                log.warning("control: scrub-now of shard %d failed: %s",
                            wid, e)

    def kick_frontend(self, fid: int) -> None:
        """Recover a gateway frontend whose endpoint lease expired:
        the tier runner's ``gateway_respawn_fn`` (which respawns the
        replica in place and re-registers it) when wired, else the
        worker supervisor's kick (gateway-over-supervised-process
        deployments), else a wiring error."""
        if self.gateway_respawn_fn is not None:
            self.gateway_respawn_fn(int(fid))
            return
        if self.supervisor is not None:
            self.supervisor.kick(int(fid))
            return
        raise RuntimeError("no gateway_respawn_fn or supervisor to "
                           "kick a dead gateway frontend with")

    def readmit(self, wid: int) -> None:
        if self.registry is not None:
            self.registry.release(self.breaker_key(wid), close=True)
        # the supervisor needs no undo: a running healthy worker is
        # simply left alone

    # ---------------------------------------------------------- repair
    def _spawn(self, name: str, fn) -> None:
        t = threading.Thread(target=fn, daemon=True, name=name)
        with self._tlock:
            self._threads = [x for x in self._threads if x.is_alive()]
            self._threads.append(t)
        t.start()

    def leave(self, wid: int, live=None) -> None:
        mc = self.membership
        if mc is None:
            raise RuntimeError("no membership controller for leave")

        def run():
            try:
                mc.leave(wid, live=live)
            except Exception as e:  # noqa: BLE001 — a refused/failed
                # leave is journaled by membership itself; the daemon
                # must keep ticking
                log.warning("control: leave of worker %d failed: %s",
                            wid, e)

        self._spawn(f"dos-control-leave-{wid}", run)

    def join(self, host: str) -> None:
        mc = self.membership
        if mc is None:
            raise RuntimeError("no membership controller for join")

        def run():
            try:
                mc.join(host)
            except Exception as e:  # noqa: BLE001
                log.warning("control: join of %s failed: %s", host, e)

        self._spawn("dos-control-join", run)

    def replicate(self, shard: int) -> None:
        if self.replicate_fn is None:
            raise RuntimeError("no replicate_fn for hot-shard repair")
        self.replicate_fn(int(shard))

    # --------------------------------------------------------- warming
    def warm(self) -> bool:
        """Pre-materialize the next diff epoch (the frontend's pump
        does this lazily on its poll cadence; doing it now moves the
        fuse+swap cost off the first post-swap request) and run any
        registered warmers. True when something was actually warmed."""
        did = False
        fe = self.frontend
        if fe is not None and getattr(fe, "traffic", None) is not None:
            did |= bool(fe.poll_traffic())
        for fn in self.warm_fns:
            fn()
            did = True
        return did

    def stop(self, join_s: float = 10.0) -> None:
        with self._tlock:
            threads, self._threads = self._threads, []
        for t in threads:
            t.join(timeout=join_s)
