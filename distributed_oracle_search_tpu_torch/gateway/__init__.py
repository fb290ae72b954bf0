"""Gateway tier, the part the workers need: :class:`GatewayConfig`
(``DOS_GATEWAY_*``), whose ``DOS_GATEWAY_L2_BYTES`` and
``DOS_GATEWAY_L2_ADMIT`` size and admit a worker's shard-owner L2
result cache (``worker.server``). A copy of the JAX package's
``gateway/config.py``.

Not ported (ROADMAP.md A14.5): the client-facing protocol, the replica
accept loop and tier, the client and the leased registry — reaching for
one raises an error naming that item.
"""

from .config import GatewayConfig

#: the JAX package's modules of this package that are not ported yet
_NOT_PORTED = ("client", "protocol", "registry", "server")


def __getattr__(name):
    if name in _NOT_PORTED:
        raise AttributeError(f"gateway.{name} is not ported (ROADMAP.md "
                             "A14.5)")
    raise AttributeError(f"module {__name__!r} has no attribute "
                         f"{name!r}")


__all__ = ["GatewayConfig"]
