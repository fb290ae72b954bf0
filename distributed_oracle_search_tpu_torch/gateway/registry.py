"""The leased gateway endpoint registry (``gateway.json``).

The tier puts N stateless frontends behind one process; this module
makes the tier's MEMBERSHIP durable so replicas can span processes and
hosts, and so death is observable without anyone watching the process.
One artifact — ``gateway.json``, living beside ``membership.json`` in
the index directory, written atomically (``utils.atomicio``) — holds a
lease row per frontend endpoint: who serves where, renewed on a
heartbeat cadence (``DOS_GATEWAY_LEASE_S``). A frontend that dies —
or a zombie that stays alive but stops renewing (the ``lease-freeze``
fault) — simply lets its lease expire: readers mark it dead with no
crash signal required, which is what lets clients discover/fail over
and the control loop kick a respawn.

Schema contract, same as the index manifest and ``membership.json``:
``from_dict`` filters unknown keys (future fields ride along), and only
a file stamped NEWER than :data:`GATEWAY_REGISTRY_VERSION` refuses —
typed, as :class:`GatewayRegistrySchemaError`. A torn or unreadable
file is a plain ``ValueError`` from :func:`load_registry`; the client's
discovery path (:func:`live_endpoints`) catches it and degrades to its
seed endpoints, never a crash.

Concurrency: readers only ever see whole files (atomic rename);
writers — multiple ``dos-gateway --join`` processes sharing one
registry — serialize read-modify-write cycles under an ``fcntl`` lock
on a sidecar lockfile, the same cross-process discipline the fault
harness's state file uses. ``flock`` locks hang off the open file
description, so two threads of ONE process (each ``_mutate`` opens its
own descriptor) serialize exactly like two processes do — no
in-process lock needed.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

from ..obs import metrics as obs_metrics
from ..obs import recorder as obs_recorder
from ..utils.atomicio import atomic_write_json
from ..utils.log import get_logger

log = get_logger(__name__)

#: the durable endpoint artifact, beside ``membership.json``
REGISTRY_FILE = "gateway.json"

#: gateway.json schema version — unknown keys tolerated, only NEWER
#: versions rejected (typed), exactly the membership/manifest contract
GATEWAY_REGISTRY_VERSION = 1

M_RENEWALS = obs_metrics.counter(
    "gateway_lease_renewals_total",
    "endpoint lease heartbeats written to gateway.json")
G_LIVE = obs_metrics.gauge(
    "gateway_live_frontends",
    "frontends with an unexpired lease at the last registry read")


class GatewayRegistrySchemaError(ValueError):
    """``gateway.json`` is stamped NEWER than this build understands."""


@dataclasses.dataclass
class GatewayLease:
    """One frontend's claim on an endpoint. ``renewed`` is a wall-clock
    UNIX timestamp (the file crosses processes and hosts); expiry is
    ``now - renewed > lease_s`` — no crash signal required."""

    fid: int = -1
    endpoint: str = ""
    pid: int = 0
    renewed: float = 0.0
    lease_s: float = 10.0
    started: float = 0.0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "GatewayLease":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    def stale_s(self, now: float | None = None) -> float:
        now = time.time() if now is None else now
        return max(0.0, float(now) - float(self.renewed))

    def live(self, now: float | None = None) -> bool:
        return self.stale_s(now) <= float(self.lease_s)


@dataclasses.dataclass
class RegistryState:
    """The durable content of ``gateway.json``."""

    leases: list = dataclasses.field(default_factory=list)
    version: int = GATEWAY_REGISTRY_VERSION

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "RegistryState":
        version = int(d.get("version", 1))
        if version > GATEWAY_REGISTRY_VERSION:
            raise GatewayRegistrySchemaError(
                f"gateway.json schema v{version} is newer than this "
                f"build's v{GATEWAY_REGISTRY_VERSION} — upgrade the "
                f"serving code before joining this fleet")
        known = {f.name for f in dataclasses.fields(cls)}
        state = cls(**{k: v for k, v in d.items() if k in known})
        if not isinstance(state.leases, list):
            raise ValueError(
                f"gateway.json leases is not a list: {state.leases!r}")
        return state

    def lease_objs(self) -> list:
        """Typed lease rows; garbage rows are skipped, not fatal (one
        bad row must not take discovery down with it)."""
        out = []
        for d in self.leases:
            if isinstance(d, dict) and d.get("endpoint"):
                out.append(GatewayLease.from_dict(d))
        return out


def registry_path(dirname: str) -> str:
    return os.path.join(dirname, REGISTRY_FILE)


def load_registry(dirname: str) -> RegistryState | None:
    """``None`` when no registry exists yet. Raises ``ValueError`` on a
    torn/unreadable file and :class:`GatewayRegistrySchemaError` on a
    NEWER one — discovery callers catch and degrade to seeds."""
    path = registry_path(dirname)
    try:
        with open(path) as f:
            raw = f.read()
    except FileNotFoundError:
        return None
    except OSError as e:
        raise ValueError(f"unreadable gateway registry {path}: {e}")
    try:
        d = json.loads(raw)
    except ValueError as e:
        raise ValueError(f"torn gateway registry {path}: {e}")
    if not isinstance(d, dict):
        raise ValueError(f"gateway registry {path} is not an object")
    return RegistryState.from_dict(d)


def save_registry(dirname: str, state: RegistryState) -> None:
    atomic_write_json(registry_path(dirname), state.to_dict())


def live_endpoints(dirname: str | None, seeds=(),
                   now: float | None = None) -> list:
    """Client discovery: live lease endpoints in ascending-fid order,
    then any seed endpoints not already listed. A torn, stale, NEWER,
    or absent registry degrades to the seeds — never a crash."""
    state = None
    if dirname:
        try:
            state = load_registry(dirname)
        except ValueError as e:
            log.warning("gateway registry unreadable (%s); degrading "
                        "to %d seed endpoint(s)", e, len(tuple(seeds)))
    out = []
    if state is not None:
        for lease in sorted(state.lease_objs(), key=lambda x: x.fid):
            if lease.live(now) and lease.endpoint not in out:
                out.append(lease.endpoint)
    for s in seeds:
        if s and s not in out:
            out.append(s)
    return out


class GatewayRegistry:
    """Writer handle on one registry directory.

    ``register``/``renew``/``unregister`` are read-modify-write cycles
    under a cross-process ``fcntl`` lock (each cycle opens its own
    descriptor, so in-process threads serialize the same way); every
    write lands through ``atomic_write_json`` so readers only ever see
    whole states. A torn existing file is reset with a log line (the
    leases self-heal on the next heartbeat round); a NEWER file is
    never clobbered — :class:`GatewayRegistrySchemaError` propagates.
    """

    def __init__(self, dirname: str, lease_s: float | None = None):
        from .config import GatewayConfig

        self.dir = str(dirname)
        self.lease_s = float(lease_s if lease_s is not None
                             else GatewayConfig.from_env().lease_s)

    # ------------------------------------------------------------ write
    def _mutate(self, fn):
        import fcntl

        os.makedirs(self.dir, exist_ok=True)
        lockpath = registry_path(self.dir) + ".lock"
        with open(lockpath, "a+") as lf:
            fcntl.flock(lf, fcntl.LOCK_EX)
            try:
                state = load_registry(self.dir)
            except GatewayRegistrySchemaError:
                raise              # never clobber a newer fleet's file
            except ValueError as e:
                log.warning("gateway registry reset after torn "
                            "state: %s", e)
                state = None
            state = state or RegistryState()
            out = fn(state)
            save_registry(self.dir, state)
            return out

    def register(self, fid: int, endpoint: str,
                 now: float | None = None) -> None:
        """(Re)claim ``endpoint`` for frontend ``fid`` with a fresh
        lease. Idempotent: an existing row for the endpoint is
        replaced, whatever fid held it before."""
        now = time.time() if now is None else now
        row = GatewayLease(fid=int(fid), endpoint=str(endpoint),
                           pid=os.getpid(), renewed=float(now),
                           lease_s=self.lease_s,
                           started=float(now)).to_dict()

        def add(state: RegistryState) -> None:
            state.leases = [d for d in state.leases
                            if not (isinstance(d, dict)
                                    and d.get("endpoint") == endpoint)]
            state.leases.append(row)

        self._mutate(add)
        obs_recorder.emit("gateway_register", frontend=int(fid),
                          endpoint=str(endpoint), lease_s=self.lease_s)
        log.info("gateway f%d registered %s (lease %.2fs)", fid,
                 endpoint, self.lease_s)

    def renew(self, fid: int, endpoint: str,
              now: float | None = None) -> bool:
        """Heartbeat: refresh the endpoint's lease. False when the row
        vanished (a sweeper or reset) — the caller re-registers."""
        now = time.time() if now is None else now
        found = [False]

        def bump(state: RegistryState) -> None:
            for d in state.leases:
                if isinstance(d, dict) and d.get("endpoint") == endpoint:
                    d["renewed"] = float(now)
                    d["lease_s"] = self.lease_s
                    d["fid"] = int(fid)
                    d["pid"] = os.getpid()
                    found[0] = True

        self._mutate(bump)
        if found[0]:
            M_RENEWALS.inc()
        return found[0]

    def unregister(self, fid: int, endpoint: str) -> None:
        """Clean shutdown: drop the lease row so readers never count
        this frontend dead (an expired row means CRASH, not drain)."""
        def drop(state: RegistryState) -> None:
            state.leases = [d for d in state.leases
                            if not (isinstance(d, dict)
                                    and d.get("endpoint") == endpoint)]

        self._mutate(drop)
        obs_recorder.emit("gateway_unregister", frontend=int(fid),
                          endpoint=str(endpoint))

    def claim(self, n: int, endpoint_of, now: float | None = None) -> int:
        """``dos-gateway --join``: atomically allocate ``n`` fresh
        frontend ids above every id the registry has ever seen (live or
        expired — ids stay unique across respawns) and pre-register
        their endpoints (``endpoint_of(fid)``); the servers re-register
        over the placeholders when they start. Returns the base fid."""
        now = time.time() if now is None else now

        def pick(state: RegistryState) -> int:
            used = [int(d.get("fid", -1)) for d in state.leases
                    if isinstance(d, dict)]
            base = (max(used) + 1) if used else 0
            for i in range(int(n)):
                state.leases.append(GatewayLease(
                    fid=base + i, endpoint=str(endpoint_of(base + i)),
                    pid=os.getpid(), renewed=float(now),
                    lease_s=self.lease_s,
                    started=float(now)).to_dict())
            return base

        base = self._mutate(pick)
        log.info("gateway --join claimed fids %d..%d in %s", base,
                 base + int(n) - 1, self.dir)
        return base

    # ------------------------------------------------------------- read
    def leases(self) -> list:
        """Tolerant read: typed lease rows, ``[]`` on any failure."""
        try:
            state = load_registry(self.dir)
        except ValueError as e:
            log.debug("gateway registry read failed: %s", e)
            return []
        return state.lease_objs() if state is not None else []

    def live(self, now: float | None = None) -> list:
        return [x for x in self.leases() if x.live(now)]

    def dead(self, now: float | None = None) -> list:
        """Registered frontends past their TTL — crashed or zombie
        (``lease-freeze``). A cleanly-drained frontend unregistered and
        is in neither list."""
        return [x for x in self.leases() if not x.live(now)]

    def snapshot(self, now: float | None = None) -> dict:
        """One observable read for ``/statusz`` and the control loop's
        :class:`~..control.signals.SignalReader` sensor."""
        now = time.time() if now is None else now
        live, dead = [], []
        for lease in self.leases():
            row = {"fid": int(lease.fid), "endpoint": lease.endpoint,
                   "pid": int(lease.pid),
                   "stale_s": round(lease.stale_s(now), 3),
                   "lease_s": float(lease.lease_s)}
            (live if lease.live(now) else dead).append(row)
        G_LIVE.set(float(len(live)))
        return {"lease_s": self.lease_s, "live": live, "dead": dead}
