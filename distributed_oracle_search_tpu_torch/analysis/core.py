"""``dos-lint`` framework: contexts, suppressions, runner, reports.

One file at a time: parse once, hand the :class:`FileContext` (source,
lines, AST, package-relative path) to every enabled rule, collect
:class:`Finding` rows, then apply the file's inline suppressions.

Suppression grammar (mandatory justification)::

    risky_call()   # dos-lint: disable=lock-scope -- lane serialization
                   #   is the point; see the lane-lock comment

    # dos-lint: disable=atomic-writes -- scratch file, same-dir tmp
    with open(scratch, "w") as f:
        ...

A trailing comment suppresses its own line; a comment-only line
suppresses the next statement line. ``disable=a,b`` covers several
rules. The ``--`` separator and non-empty justification are REQUIRED —
a bare ``disable=`` is reported as a :data:`BAD_SUPPRESSION` finding
(which cannot itself be suppressed): unwritten folklore is exactly what
this tool exists to replace, so every silenced contract carries its
reason in the diff.

Exit-code convention (shared with ``dos-obs bench-diff`` so the two
gates compose in one pipeline): 0 = clean, 1 = the gate fails
(unsuppressed findings under ``--strict``), 2 = usage/internal error.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import re

#: pseudo-rule booked for malformed suppressions; never suppressible
BAD_SUPPRESSION = "bad-suppression"

_SUPPRESS_RE = re.compile(
    r"#\s*dos-lint:\s*disable=([A-Za-z0-9_,-]+)\s*(?:--\s*(.*))?$")


@dataclasses.dataclass
class Finding:
    """One rule violation at one source location."""

    rule: str
    path: str
    line: int
    col: int
    message: str
    suppressed: bool = False
    justification: str = ""

    def render(self) -> str:
        tag = "suppressed: " if self.suppressed else ""
        return (f"{self.path}:{self.line}:{self.col}: {self.rule}: "
                f"{tag}{self.message}")

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Suppression:
    line: int               # the source line the comment sits on
    rules: tuple
    justification: str
    applies_next: bool      # comment-only line: covers the next stmt


class FileContext:
    """Everything a rule may look at for one file."""

    def __init__(self, path: str, source: str,
                 config: "LintConfig"):
        self.path = path
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        self.config = config
        #: package-relative posix path when the file lives inside the
        #: package (rules scope allowlists on it); otherwise the
        #: basename — fixture corpora stay subject to every rule
        self.relpath = _package_relpath(path)

    def in_package(self) -> bool:
        return "/" in self.relpath


def _package_relpath(path: str) -> str:
    parts = os.path.abspath(path).replace(os.sep, "/").split("/")
    if "distributed_oracle_search_tpu_torch" in parts:
        i = parts.index("distributed_oracle_search_tpu_torch")
        return "/".join(parts[i:])
    return parts[-1]


@dataclasses.dataclass
class LintConfig:
    """Run-wide knobs. ``metric_doc`` is the text the
    ``metric-registry`` rule checks names against (default: the real
    package's ``obs/__init__`` docstring, loaded lazily); tests inject
    their own to exercise the rule against fixture maps."""

    select: tuple = ()          # rule names to run (empty = all)
    disable: tuple = ()         # rule names to skip
    metric_doc: str | None = None

    def enabled(self, name: str) -> bool:
        if self.select and name not in self.select:
            return False
        return name not in self.disable

    def metric_doc_text(self) -> str:
        if self.metric_doc is None:
            init = os.path.join(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))), "obs", "__init__.py")
            try:
                with open(init) as f:
                    self.metric_doc = ast.get_docstring(
                        ast.parse(f.read())) or ""
            except (OSError, SyntaxError):
                self.metric_doc = ""
        return self.metric_doc


# ------------------------------------------------------------ suppressions

def parse_suppressions(lines) -> tuple[list[Suppression], list[Finding]]:
    """Scan source lines for disable comments. Returns the suppressions
    plus BAD_SUPPRESSION findings for any without a justification."""
    sups: list[Suppression] = []
    bad: list[Finding] = []
    for i, raw in enumerate(lines, start=1):
        m = _SUPPRESS_RE.search(raw)
        if not m:
            continue
        rules = tuple(r.strip() for r in m.group(1).split(",")
                      if r.strip())
        just = (m.group(2) or "").strip()
        applies_next = raw.lstrip().startswith("#")
        if not just:
            bad.append(Finding(
                BAD_SUPPRESSION, "", i, raw.find("#") + 1,
                f"suppression of {', '.join(rules)} carries no "
                f"justification (write `# dos-lint: disable=<rule> -- "
                f"<why this site is exempt>`)"))
            continue
        sups.append(Suppression(i, rules, just, applies_next))
    return sups, bad


def _covered_lines(sup: Suppression, lines, spans) -> set[int]:
    if not sup.applies_next:
        # trailing comment: cover the whole statement it trails — a
        # finding anchors to the statement's FIRST line, which for a
        # multi-line call is above the comment
        out = {sup.line}
        out.update(spans.get(sup.line, ()))
        return out
    # comment-only line: cover the next non-blank, non-comment line
    # (continuation comments in between extend the search)
    for j in range(sup.line, len(lines)):
        txt = lines[j].strip()     # lines[j] is 1-based line j+1
        if txt and not txt.startswith("#"):
            return {sup.line, j + 1}
    return {sup.line}


#: compound statements span their whole BODY — a suppression inside the
#: body must not reach the header's findings, so they never contribute
#: spans (their header expressions, e.g. a multi-line ``with open(...)``,
#: are separate expr nodes and still do)
_COMPOUND = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef,
             ast.For, ast.AsyncFor, ast.While, ast.If, ast.With,
             ast.AsyncWith, ast.Try)


def statement_spans(tree) -> dict[int, set[int]]:
    """line -> the start lines of every SIMPLE statement/expression
    spanning it, so a trailing suppression on any physical line of a
    multi-line statement reaches the line its finding anchors to —
    without a disable inside a compound statement's body silencing
    findings anchored at the compound's header."""
    spans: dict[int, set[int]] = {}
    for node in ast.walk(tree):
        if isinstance(node, _COMPOUND):
            continue
        start = getattr(node, "lineno", None)
        end = getattr(node, "end_lineno", None)
        if start is None or end is None or end == start:
            continue
        for ln in range(start, end + 1):
            spans.setdefault(ln, set()).add(start)
    return spans


def apply_suppressions(findings: list[Finding], sups: list[Suppression],
                       lines, spans=None) -> list[Finding]:
    """Mark findings covered by a suppression; BAD_SUPPRESSION rows are
    never suppressible. Several suppressions may cover one line
    (stacked comment-only disables) — each is honored."""
    spans = spans or {}
    cover: dict[int, list[Suppression]] = {}
    for sup in sups:
        for ln in _covered_lines(sup, lines, spans):
            cover.setdefault(ln, []).append(sup)
    for f in findings:
        if f.rule == BAD_SUPPRESSION:
            continue
        for sup in cover.get(f.line, ()):
            if f.rule in sup.rules or "all" in sup.rules:
                f.suppressed = True
                f.justification = sup.justification
                break
    return findings


# ------------------------------------------------------------------ runner

def run_file(path: str, rules, config: LintConfig) -> list[Finding]:
    """Lint one file with every enabled rule. A syntax error is itself
    a finding (a file the checker cannot parse is a file no contract is
    checked in), not a crash."""
    with open(path, encoding="utf-8", errors="replace") as f:
        source = f.read()
    try:
        ctx = FileContext(path, source, config)
    except SyntaxError as e:
        return [Finding("syntax-error", path, e.lineno or 0, 0,
                        f"unparseable: {e.msg}")]
    except ValueError as e:
        # e.g. a null byte — ast.parse raises ValueError, not
        # SyntaxError; one corrupt file must not take down the gate
        return [Finding("syntax-error", path, 0, 0,
                        f"unparseable: {e}")]
    findings: list[Finding] = []
    for rule in rules:
        if not config.enabled(rule.name):
            continue
        for f_ in rule.check(ctx):
            f_.path = path
            findings.append(f_)
    sups, bad = parse_suppressions(ctx.lines)
    for b in bad:
        b.path = path
        findings.append(b)
    apply_suppressions(findings, sups, ctx.lines,
                       statement_spans(ctx.tree))
    findings.sort(key=lambda f: (f.line, f.col, f.rule))
    return findings


def collect_files(paths) -> list[str]:
    """Expand files/dirs into a sorted ``.py`` file list (dirs walked
    recursively, ``__pycache__`` skipped)."""
    out: list[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = [d for d in dirs if d != "__pycache__"]
                out.extend(os.path.join(root, f) for f in files
                           if f.endswith(".py"))
        else:
            out.append(p)
    return sorted(set(out))


def run_paths(paths, rules, config: LintConfig | None = None
              ) -> tuple[list[Finding], int]:
    """Lint every file under ``paths``; returns ``(findings, n_files)``."""
    config = config or LintConfig()
    files = collect_files(paths)
    findings: list[Finding] = []
    for path in files:
        findings.extend(run_file(path, rules, config))
    return findings, len(files)


# ----------------------------------------------------------------- reports

def render_text(findings, n_files: int, show_suppressed: bool = False
                ) -> str:
    lines = []
    active = [f for f in findings if not f.suppressed]
    shown = findings if show_suppressed else active
    for f in shown:
        lines.append(f.render())
    n_sup = sum(1 for f in findings if f.suppressed)
    lines.append(
        f"dos-lint: {len(active)} finding(s) in {n_files} file(s)"
        + (f" ({n_sup} suppressed)" if n_sup else ""))
    return "\n".join(lines)


def render_json(findings, n_files: int) -> dict:
    """Machine report, ``dos-obs bench-diff``-convention gate fields:
    ``ok`` mirrors the exit code (0 clean / 1 findings) so a pipeline
    can treat lint and bench-diff outputs uniformly."""
    active = [f for f in findings if not f.suppressed]
    counts: dict[str, int] = {}
    for f in active:
        counts[f.rule] = counts.get(f.rule, 0) + 1
    return {
        "ok": not active,
        "exit_code": 1 if active else 0,
        "files": n_files,
        "counts": counts,
        "suppressed": sum(1 for f in findings if f.suppressed),
        "findings": [f.as_dict() for f in findings],
    }


def exit_code(findings, strict: bool) -> int:
    active = [f for f in findings if not f.suppressed]
    return 1 if (strict and active) else 0
