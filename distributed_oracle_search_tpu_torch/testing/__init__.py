"""Test-support subsystems shipped with the package (not the test suite).

:mod:`.faults` is the deterministic fault-injection harness (a copy of
the JAX package's): production code calls :func:`faults.inject` at named
injection points, and the ``DOS_FAULTS`` environment variable decides —
deterministically — which calls fire. It is a no-op when ``DOS_FAULTS``
is unset, so the hooks are safe to leave in hot paths.
"""

from . import faults

__all__ = ["faults"]
