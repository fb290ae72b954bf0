"""``dos-lint``: the project-contract static analyzer.

Usage::

    dos-lint                      # lint the installed package
    dos-lint path/ other.py       # lint explicit files/dirs
    dos-lint --strict             # exit 1 on any unsuppressed finding
    dos-lint --json               # machine report (bench-diff gate
                                  # convention: ok/exit_code fields)
    dos-lint --list-rules         # the rule table
    dos-lint --select env-discipline,lock-scope
    dos-lint --disable jit-purity

Exit codes (shared convention with ``dos-obs bench-diff`` so CI can
chain both gates in one pipeline): 0 clean, 1 gate failed (findings,
``--strict`` or ``--json``), 2 usage error. Suppress individual sites
inline — justification mandatory::

    x = os.environ.get("DOS_X")  # dos-lint: disable=env-discipline -- why
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from ..analysis import (
    ALL_RULES, LintConfig, render_json, render_text, run_paths,
)


def default_target() -> str:
    """The installed package directory (self-lint default)."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dos-lint", description=__doc__.splitlines()[0])
    p.add_argument("paths", nargs="*",
                   help="files/dirs to lint (default: the package)")
    p.add_argument("--strict", action="store_true",
                   help="exit 1 when unsuppressed findings remain")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="JSON report on stdout (implies --strict exit "
                        "semantics: ok/exit_code mirror bench-diff)")
    p.add_argument("--select", default="",
                   help="comma-separated rules to run (default: all)")
    p.add_argument("--disable", default="",
                   help="comma-separated rules to skip")
    p.add_argument("--show-suppressed", action="store_true",
                   help="also print suppressed findings (text mode)")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule table and exit")
    return p


def _split(spec: str) -> tuple:
    return tuple(s.strip() for s in spec.split(",") if s.strip())


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.list_rules:
        for r in ALL_RULES:
            print(f"{r.name:16s} {r.description}")
        return 0
    known = {r.name for r in ALL_RULES}
    select, disable = _split(args.select), _split(args.disable)
    for name in (*select, *disable):
        if name not in known:
            print(f"dos-lint: unknown rule {name!r} (see --list-rules)",
                  file=sys.stderr)
            return 2
    config = LintConfig(select=select, disable=disable)
    paths = args.paths or [default_target()]
    for p in paths:
        if not os.path.exists(p):
            print(f"dos-lint: no such path: {p}", file=sys.stderr)
            return 2
    findings, n_files = run_paths(paths, ALL_RULES, config)
    active = [f for f in findings if not f.suppressed]
    if args.as_json:
        print(json.dumps(render_json(findings, n_files), indent=1))
        return 1 if active else 0
    print(render_text(findings, n_files,
                      show_suppressed=args.show_suppressed))
    if args.strict and active:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
