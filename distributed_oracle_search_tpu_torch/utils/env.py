"""Env-var parsing for the runtime knobs (``DOS_*``).

One helper, one policy: a missing or malformed value falls back to the
default with a log line — a typo in an ops environment must degrade the
knob, never crash a campaign or silently change semantics per call site.
"""

from __future__ import annotations

import os

from .log import get_logger

log = get_logger(__name__)


def env_cast(name: str, default, cast):
    """``cast(os.environ[name])`` with ``default`` on absence or a value
    ``cast`` rejects (logged)."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        return cast(raw)
    except (TypeError, ValueError):
        log.warning("ignoring malformed %s=%r (using %r)", name, raw,
                    default)
        return default


def env_str(name: str, default: str | None = None) -> str | None:
    """Raw string knob (paths, host names, fault specs)."""
    return os.environ.get(name, default)


#: accepted spellings for boolean knobs; anything else is malformed and
#: degrades to the default (logged), matching the env_cast policy
_TRUE = frozenset(("1", "true", "yes", "on"))
_FALSE = frozenset(("0", "false", "no", "off"))


def env_flag(name: str, default: bool) -> bool:
    """Boolean knob. An EMPTY value counts as absent, not false — the
    ``FLAG=${UNSET_VAR}`` shell-interpolation accident must not
    silently flip a default-on knob off."""
    raw = os.environ.get(name)
    if raw is None or not raw.strip():
        return default
    v = raw.strip().lower()
    if v in _TRUE:
        return True
    if v in _FALSE:
        return False
    log.warning("ignoring malformed %s=%r (using %r)", name, raw, default)
    return default
