"""PyTorch port, ``dos-lint`` (``analysis/``, ``cli/lint.py``) against the
JAX package's.

The JAX package's ``tests/test_lint.py`` cases run over the port
(``torch_port_cases``): every rule fires, suppresses and stays quiet on
the shared ``tests/lint_fixtures`` corpus, and the package gate
(``test_package_is_lint_clean``, ``--strict`` exit 0) is pointed at the
port's own package. Below them, the two linters are held to each other:
the same findings on the corpus, and each package's ``--strict`` clean
on itself."""

import json
import os
import subprocess
import sys

import pytest

from torch_port_cases import load_cases

pytestmark = pytest.mark.lint

globals().update(load_cases("test_lint.py", __name__, drop={}))

from torch_parity import NAMES, both  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(ROOT, "tests", "lint_fixtures")
PACKAGES = {"jax": "distributed_oracle_search_tpu",
            "torch": "distributed_oracle_search_tpu_torch"}


def _lint_json(pkg: str, *paths) -> tuple[int, dict]:
    proc = subprocess.run(
        [sys.executable, "-m", f"{pkg}.cli.lint", "--json", *paths],
        capture_output=True, text=True, cwd=ROOT, timeout=300)
    return proc.returncode, json.loads(proc.stdout)


def test_corpus_findings_equal_jax():
    """``dos-lint --json`` on the fixture corpus: the same exit code and
    the same findings, rule for rule and line for line, from both
    packages."""
    got = {k: _lint_json(p, CORPUS) for k, p in PACKAGES.items()}
    assert got["torch"] == got["jax"]
    rc, doc = got["torch"]
    assert rc == 1 and doc["findings"] and doc["suppressed"] > 0


def test_rules_and_suppressions_equal_jax():
    """The rule tables, and the suppression parse of one line, agree."""
    line = "x = f()  # dos-lint: disable=lock-scope,atomic-writes -- why\n"

    def table(P):
        A = P.analysis
        sups, bad = A.core.parse_suppressions(line.splitlines())
        return ([(r.name, r.description) for r in A.ALL_RULES],
                [s.__dict__ for s in sups], bad,
                A.core._package_relpath(f"/x/{NAMES[P.name]}/ops/a.py"))

    got = both(table)
    assert got["torch"][:3] == got["jax"][:3] and len(got["torch"][0]) == 8
    assert got["torch"][1][0]["rules"] == ("lock-scope", "atomic-writes")
    # each recognises its own package: the port's rules scope on paths
    # inside distributed_oracle_search_tpu_torch (fifo-hygiene's
    # exemption of transport/frames.py, jit-purity's ops/ and models/)
    for name in got:
        assert got[name][3] == f"{NAMES[name]}/ops/a.py"


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_each_package_is_strict_clean_on_itself(pkg):
    """``dos-lint --strict`` with every rule on: 0 on each package, by
    that package's own linter; the port's suppressions each carry their
    reason."""
    rc, doc = _lint_json(PACKAGES[pkg], os.path.join(ROOT, PACKAGES[pkg]))
    assert rc == 0 and doc["ok"] and doc["counts"] == {}, doc["findings"]
    if pkg == "torch":
        sup = [f for f in doc["findings"] if f["suppressed"]]
        assert {f["rule"] for f in sup} >= {"lock-scope"}
        assert all(f["justification"].strip() for f in sup)
