"""Gateway tier: the head scaled horizontally, facing clients.

Three pieces (ROADMAP item 2):

* :mod:`.protocol` — the client-facing binary frame vocabulary over
  the shared :mod:`..transport.frames` container: multiplexed batched
  query frames for every family, credit-window backpressure with an
  explicit ``busy``, hello negotiation under tolerate-older/gate-newer.
* :mod:`.server` — :class:`GatewayServer`, one stateless frontend
  replica's accept loop, and :class:`GatewayTier`, N of them sharing
  nothing but ``membership.json`` and the diff-epoch spool.
* :mod:`.client` — :class:`DosClient`, the library callers link.
* :mod:`.registry` — the leased endpoint registry (``gateway.json``):
  durable tier membership with heartbeat-renewed TTL leases, so
  replicas span processes, clients discover and fail over, and the
  control loop sees death without a crash signal.

The two-level cache plane rides alongside: each replica's
:class:`~..serving.cache.ResultCache` is a small L1, and workers keep
hot ``(s, t, diff-epoch)`` entries as a shard-owner L2
(``DOS_GATEWAY_L2_BYTES``, see :mod:`..worker.server`) answered before
the kernel — capacity scales with the fleet, and scoped invalidation
runs local to the shard that owns the updated edges.
"""

from .client import DosClient, GatewayBusy, GatewayError
from .config import GatewayConfig
from .protocol import (GATEWAY_SCHEMA_VERSION, GatewayProtocolError,
                       GatewaySchemaError)
from .registry import (GATEWAY_REGISTRY_VERSION, GatewayLease,
                       GatewayRegistry, GatewayRegistrySchemaError,
                       RegistryState, live_endpoints, load_registry,
                       save_registry)
from .server import GatewayServer, GatewayTier

__all__ = [
    "DosClient", "GatewayBusy", "GatewayError", "GatewayConfig",
    "GATEWAY_SCHEMA_VERSION", "GatewayProtocolError",
    "GatewaySchemaError", "GatewayServer", "GatewayTier",
    "GATEWAY_REGISTRY_VERSION", "GatewayLease", "GatewayRegistry",
    "GatewayRegistrySchemaError", "RegistryState", "live_endpoints",
    "load_registry", "save_registry",
]
