"""Project-contract static analysis (``dos-lint``).

Six conventions hold this codebase together: every ``DOS_*`` knob
parses through ``utils.env``, every durable artifact write goes through
``utils.atomicio``, every metric name lives in the ``obs`` metric map,
every wire codec tolerates unknown keys, no blocking call runs under a
lock. None of that survives contact with a refactor unless it is
machine-checked — this package turns the conventions into enforced
invariants:

* :mod:`.core` — the checker framework: per-file AST visitor pipeline,
  inline ``# dos-lint: disable=<rule> -- <justification>`` suppressions
  (justification mandatory — a silenced rule must say why), text/JSON
  reports, and the ``--strict`` gate (exit 0 clean / 1 findings, the
  same convention ``dos-obs bench-diff`` uses so both gates compose in
  one CI pipeline).
* :mod:`.rules` — the project-contract rules themselves (see
  ``dos-lint --list-rules`` or the README's "Static analysis" table).

The runtime companion is :mod:`..utils.locks`: ``dos-lint``'s
``lock-scope`` rule catches blocking-under-lock statically, while
``OrderedLock``'s witness graph (``DOS_LOCK_CHECK=1``) catches
lock-ORDER cycles dynamically under the tier-1 threaded tests.
"""

from .core import (
    BAD_SUPPRESSION, Finding, LintConfig, collect_files, render_json,
    render_text, run_paths,
)
from .rules import ALL_RULES, rule_by_name

__all__ = ["BAD_SUPPRESSION", "Finding", "LintConfig", "ALL_RULES",
           "collect_files", "render_json", "render_text", "run_paths",
           "rule_by_name"]
