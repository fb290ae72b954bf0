"""Sense: one degraded-tolerant read of every fleet sensor.

The daemon's providers are all optional — a supervise-side daemon has
no serving frontend, a head-side daemon may run without a telemetry
store — and any of them can throw mid-incident (which is exactly when
the daemon must keep ticking). Each provider is read inside its own
``try``; a failed read leaves that signal ``None``/empty and the policy
arms treat missing data as "no evidence", never as "healthy".

Telemetry lag is itself a failure signal: a worker whose sidecar
stopped publishing is indistinguishable from a hung worker, so
:attr:`ControlSignals.telemetry_lag_s` feeds the quarantine arm
alongside ping failures."""

from __future__ import annotations

import dataclasses
import time

from ..utils.log import get_logger

log = get_logger(__name__)


@dataclasses.dataclass
class ControlSignals:
    """One tick's sensor snapshot (monotonic ``now``)."""

    now: float
    #: max fast-window burn across SLO specs (None: engine absent/no data)
    fast_burn: float | None = None
    #: SLO spec names currently alerting
    alerting: tuple = ()
    #: max queue_depth / queue_bound across serving shards (0.0 idle)
    queue_frac: float = 0.0
    #: per-shard queue depth {wid: depth} from the frontend
    queue_depths: dict = dataclasses.field(default_factory=dict)
    #: per-lane RPC credit-window occupancy {via: frac} from the
    #: frontend's streaming-transport connection table
    credit_occupancy: dict = dataclasses.field(default_factory=dict)
    #: max credit occupancy across lanes (0.0 idle) — full windows are
    #: the streaming lane's starvation signal: queues live in the
    #: WORKER under RPC, so frontend queue depth alone under-reports
    credit_frac: float = 0.0
    #: per-worker process liveness {wid: bool} from the supervisor
    worker_running: dict = dataclasses.field(default_factory=dict)
    #: per-worker consecutive ping failures {wid: int}
    ping_failures: dict = dataclasses.field(default_factory=dict)
    #: per-worker telemetry staleness {wid: seconds since last sample}
    telemetry_lag_s: dict = dataclasses.field(default_factory=dict)
    #: workers whose breaker is currently open {wid}
    breakers_open: set = dataclasses.field(default_factory=set)
    #: shard with the largest queue share, and that share (0.0 idle)
    hot_shard: int | None = None
    hot_frac: float = 0.0
    #: live frontend count from the gateway endpoint registry (None:
    #: no registry sensor wired)
    gateway_live: int | None = None
    #: per-frontend lease staleness {fid: seconds since last renewal}
    gateway_lease_stale_s: dict = dataclasses.field(default_factory=dict)
    #: frontends whose endpoint lease has EXPIRED — crashed or zombie
    #: (a cleanly-drained frontend unregistered and appears nowhere)
    gateway_dead: tuple = ()
    #: per-shard CUMULATIVE audit-divergence counts {wid: count} from
    #: the answer auditor (integrity.audit) — the DivergenceWatch arm
    #: acts on deltas, so cumulative totals survive a missed tick
    audit_divergent: dict = dataclasses.field(default_factory=dict)

    def known_workers(self) -> set:
        out = set(self.worker_running) | set(self.ping_failures)
        out |= set(self.queue_depths) | set(self.telemetry_lag_s)
        return out


class SignalReader:
    """Reads all providers into one :class:`ControlSignals`.

    Worker telemetry lag comes from the ingest's per-source freshness
    map; worker sources follow the ``w<wid>`` naming convention the
    sidecar publishers use, so lag maps back onto supervisor wids."""

    def __init__(self, *, ingest=None, slo=None, frontend=None,
                 supervisor=None, registry=None, breaker_key=None,
                 gateway=None, integrity=None, clock=time.monotonic):
        self.ingest = ingest
        self.slo = slo
        self.frontend = frontend
        self.supervisor = supervisor
        self.registry = registry      # the BREAKER registry
        self.breaker_key = breaker_key
        self.gateway = gateway        # the gateway ENDPOINT registry
        self.integrity = integrity    # the answer auditor (snapshot())
        self.clock = clock

    def read(self, now: float | None = None) -> ControlSignals:
        sig = ControlSignals(now=self.clock() if now is None else now)
        self._read_slo(sig)
        self._read_frontend(sig)
        self._read_supervisor(sig)
        self._read_telemetry(sig)
        self._read_breakers(sig)
        self._read_gateway(sig)
        self._read_integrity(sig)
        return sig

    # ------------------------------------------------------- providers
    def _read_slo(self, sig: ControlSignals) -> None:
        if self.slo is None:
            return
        try:
            ev = self.slo.evaluate()
            burns = [v.get("fast_burn") for v in ev.values()
                     if isinstance(v, dict)
                     and v.get("fast_burn") is not None]
            sig.fast_burn = max(burns) if burns else None
            sig.alerting = tuple(self.slo.alerting())
        except Exception as e:  # noqa: BLE001 — degrade, keep ticking
            log.debug("control sense: slo read failed: %s", e)

    def _read_frontend(self, sig: ControlSignals) -> None:
        if self.frontend is None:
            return
        try:
            st = self.frontend.statusz()
            transport = st.get("transport")
            conns = (transport.get("connections")
                     if isinstance(transport, dict) else None)
            if isinstance(conns, dict):
                for via, c in conns.items():
                    occ = (c.get("occupancy")
                           if isinstance(c, dict) else None)
                    if isinstance(occ, (int, float)):
                        sig.credit_occupancy[int(via)] = float(occ)
                if sig.credit_occupancy:
                    sig.credit_frac = max(
                        sig.credit_occupancy.values())
            shards = st.get("shards")
            if not isinstance(shards, dict):
                return
            total = 0
            for wid, s in shards.items():
                if not isinstance(s, dict):
                    continue
                depth = s.get("queue_depth")
                bound = s.get("queue_bound")
                if isinstance(depth, (int, float)):
                    sig.queue_depths[int(wid)] = int(depth)
                    total += int(depth)
                    if isinstance(bound, (int, float)) and bound > 0:
                        sig.queue_frac = max(sig.queue_frac,
                                             depth / bound)
            if total > 0:
                hot = max(sig.queue_depths.items(), key=lambda kv: kv[1])
                sig.hot_shard = hot[0]
                sig.hot_frac = hot[1] / total
        except Exception as e:  # noqa: BLE001 — degrade, keep ticking
            log.debug("control sense: frontend read failed: %s", e)

    def _read_supervisor(self, sig: ControlSignals) -> None:
        if self.supervisor is None:
            return
        try:
            st = self.supervisor.statusz()
            workers = st.get("workers")
            if not isinstance(workers, dict):
                return
            for wid, w in workers.items():
                if not isinstance(w, dict):
                    continue
                sig.worker_running[int(wid)] = bool(w.get("running"))
                pf = w.get("ping_failures")
                if isinstance(pf, (int, float)):
                    sig.ping_failures[int(wid)] = int(pf)
        except Exception as e:  # noqa: BLE001 — degrade, keep ticking
            log.debug("control sense: supervisor read failed: %s", e)

    def _read_telemetry(self, sig: ControlSignals) -> None:
        if self.ingest is None:
            return
        try:
            sources = self.ingest.statusz().get("sources")
            if not isinstance(sources, dict):
                return
            for src, st in sources.items():
                if not (isinstance(src, str) and src.startswith("w")
                        and src[1:].isdigit()
                        and isinstance(st, dict)):
                    continue
                lag = st.get("lag_s")
                if isinstance(lag, (int, float)):
                    sig.telemetry_lag_s[int(src[1:])] = float(lag)
        except Exception as e:  # noqa: BLE001 — degrade, keep ticking
            log.debug("control sense: telemetry read failed: %s", e)

    def _read_breakers(self, sig: ControlSignals) -> None:
        if self.registry is None or self.breaker_key is None:
            return
        try:
            for wid in sig.known_workers():
                br = self.registry.get(self.breaker_key(wid))
                if br is not None and not br.would_allow():
                    sig.breakers_open.add(wid)
        except Exception as e:  # noqa: BLE001 — degrade, keep ticking
            log.debug("control sense: breaker read failed: %s", e)

    def _read_gateway(self, sig: ControlSignals) -> None:
        """Gateway endpoint leases: live frontend count, per-frontend
        lease staleness, and the set whose lease EXPIRED (crash or
        ``lease-freeze`` zombie) — the kick arm's evidence."""
        if self.gateway is None:
            return
        try:
            snap = self.gateway.snapshot()
            live = snap.get("live") or []
            dead = snap.get("dead") or []
            sig.gateway_live = len(live)
            for row in list(live) + list(dead):
                if isinstance(row, dict) and "fid" in row:
                    stale = row.get("stale_s")
                    if isinstance(stale, (int, float)):
                        sig.gateway_lease_stale_s[int(row["fid"])] = \
                            float(stale)
            sig.gateway_dead = tuple(sorted(
                int(row["fid"]) for row in dead
                if isinstance(row, dict) and "fid" in row))
        except Exception as e:  # noqa: BLE001 — degrade, keep ticking
            log.debug("control sense: gateway registry read failed: %s",
                      e)

    def _read_integrity(self, sig: ControlSignals) -> None:
        """Answer-audit divergences: the auditor's per-shard cumulative
        counts (``AnswerAuditor.snapshot``) — evidence a shard is
        serving WRONG answers, the one failure mode no availability
        sensor above can see."""
        if self.integrity is None:
            return
        try:
            snap = self.integrity.snapshot()
            if isinstance(snap, dict):
                sig.audit_divergent = {int(k): int(v)
                                       for k, v in snap.items()}
        except Exception as e:  # noqa: BLE001 — degrade, keep ticking
            log.debug("control sense: integrity read failed: %s", e)
