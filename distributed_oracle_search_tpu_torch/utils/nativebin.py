"""Locate the native engine's binaries.

The build (``install.sh`` → ``native/Makefile``) drops ``make_cpd_auto``,
``gen_distribute_conf`` and ``fifo_auto`` into ``<repo>/bin`` (entry-point
parity with the reference's install.sh). Search order: ``$DOS_NATIVE_BIN``,
``<repo>/bin``, the Make build trees (fast, then dev).
"""

from __future__ import annotations

import os

from .env import env_str

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

SEARCH_DIRS = (
    env_str("DOS_NATIVE_BIN", ""),
    os.path.join(_REPO_ROOT, "bin"),
    os.path.join(_REPO_ROOT, "native", "build", "fast", "bin"),
    os.path.join(_REPO_ROOT, "native", "build", "dev", "bin"),
)


def find_binary(name: str) -> str | None:
    for d in SEARCH_DIRS:
        if not d:
            continue
        path = os.path.join(d, name)
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    return None


def require_binary(name: str) -> str:
    path = find_binary(name)
    if path is None:
        raise FileNotFoundError(
            f"native binary {name!r} not found (searched "
            f"{[d for d in SEARCH_DIRS if d]}); build it with ./install.sh")
    return path
