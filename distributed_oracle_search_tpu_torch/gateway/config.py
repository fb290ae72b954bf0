"""Gateway knobs (``DOS_GATEWAY_*`` env family).

One frozen dataclass holds every tunable of the client-facing tier so
the accept loops, the tier runner, and the worker-side L2 agree on a
single source of truth, and ``from_env`` follows the repo-wide env
policy (``utils.env``): a malformed value degrades to the default with
a log line, never a crash.
"""

from __future__ import annotations

import dataclasses

from ..utils.env import env_cast, env_str
from ..utils.log import get_logger

log = get_logger(__name__)


@dataclasses.dataclass(frozen=True)
class GatewayConfig:
    """Client-tier tunables.

    * ``replicas`` — how many stateless frontend replicas the tier
      runner hosts. Env: ``DOS_GATEWAY_REPLICAS``.
    * ``socket_dir`` — directory for the per-replica unix sockets
      (``dos-gateway-f<fid>.sock``). Env: ``DOS_GATEWAY_SOCKET_DIR``.
    * ``credit`` — per-connection in-flight frame window advertised in
      the hello; frames past it answer an explicit ``busy`` instead of
      queueing into a timeout. Env: ``DOS_GATEWAY_CREDIT``.
    * ``deadline_ms`` — default per-frame deadline when a query frame
      carries none of its own. Env: ``DOS_GATEWAY_DEADLINE_MS``.
    * ``l2_bytes`` — byte budget of the shard-owner L2 result cache
      each WORKER keeps in front of its kernel; ``0`` (the default)
      disables it, preserving pre-gateway worker behavior exactly.
      Env: ``DOS_GATEWAY_L2_BYTES`` (read worker-side).
    * ``l2_admit`` — L2 admission policy: ``all`` (the default — every
      miss inserts, byte-identical pre-HA behavior) or ``second-hit``
      (a doorkeeper admits a key only on its second miss, keeping
      one-hit-wonder queries from churning the byte budget).
      Env: ``DOS_GATEWAY_L2_ADMIT`` (read worker-side).
    * ``lease_s`` — TTL of a frontend's endpoint lease in
      ``gateway.json``; the heartbeat renews at a third of it, and a
      lease older than it marks the frontend dead for discovery,
      failover, and the control loop. Env: ``DOS_GATEWAY_LEASE_S``.
    """

    replicas: int = 2
    socket_dir: str = "/tmp"
    credit: int = 32
    deadline_ms: float = 10_000.0
    l2_bytes: int = 0
    l2_admit: str = "all"
    lease_s: float = 10.0

    @classmethod
    def from_env(cls, **overrides) -> "GatewayConfig":
        """Env-derived config; keyword overrides (CLI flags) win when
        not ``None``. Env policy (``utils.env``): a well-typed but
        INVALID env value degrades to the default with a log line like
        an unparseable one — only explicit overrides raise."""
        vals = dict(
            replicas=env_cast("DOS_GATEWAY_REPLICAS", cls.replicas, int),
            socket_dir=env_str("DOS_GATEWAY_SOCKET_DIR", cls.socket_dir),
            credit=env_cast("DOS_GATEWAY_CREDIT", cls.credit, int),
            deadline_ms=env_cast("DOS_GATEWAY_DEADLINE_MS",
                                 cls.deadline_ms, float),
            l2_bytes=env_cast("DOS_GATEWAY_L2_BYTES", cls.l2_bytes, int),
            l2_admit=env_str("DOS_GATEWAY_L2_ADMIT", cls.l2_admit),
            lease_s=env_cast("DOS_GATEWAY_LEASE_S", cls.lease_s, float),
        )
        for field, value in list(vals.items()):
            try:
                cls(**{field: value}).validate()
            except ValueError as e:
                log.warning("ignoring invalid DOS_GATEWAY_%s=%r (%s); "
                            "using %r", field.upper(), value, e,
                            getattr(cls, field))
                vals[field] = getattr(cls, field)
        vals.update({k: v for k, v in overrides.items() if v is not None})
        return cls(**vals).validate()

    def validate(self) -> "GatewayConfig":
        if self.replicas <= 0:
            raise ValueError("replicas must be positive")
        if not self.socket_dir:
            raise ValueError("socket_dir must be non-empty")
        if self.credit <= 0:
            raise ValueError("credit must be positive")
        if self.deadline_ms <= 0:
            raise ValueError("deadline_ms must be positive")
        if self.l2_bytes < 0:
            raise ValueError("l2_bytes must be >= 0")
        if self.l2_admit not in ("all", "second-hit"):
            raise ValueError("l2_admit must be 'all' or 'second-hit'")
        if self.lease_s <= 0:
            raise ValueError("lease_s must be positive")
        return self

    @property
    def deadline_s(self) -> float:
        return self.deadline_ms / 1e3

    def socket_of(self, fid: int) -> str:
        import os

        return os.path.join(self.socket_dir, f"dos-gateway-f{fid}.sock")
