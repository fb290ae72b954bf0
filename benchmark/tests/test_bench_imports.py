"""Nothing the benchmark runs imports JAX or the JAX package, compared
by whole top-level module name (the port's name begins with the JAX
package's), and the plain reference imports nothing of the program."""

import ast
import os
import subprocess
import sys

import pytest

from bench_support import BENCH, ROOT, make_root

FORBIDDEN = {"jax", "jaxlib", "flax", "distributed_oracle_search_tpu"}
PORT = "distributed_oracle_search_tpu_torch"
#: a fresh process's environment: the checkout's own imports, and few
#: threads, so that runs beside other tests' do not crowd the cores
ENV = {**{k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
       "OMP_NUM_THREADS": "2"}


def imported_tops(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def sources(*dirs):
    for d in dirs:
        for dirpath, _, files in os.walk(os.path.join(BENCH, d)):
            for f in files:
                if f.endswith(".py"):
                    yield os.path.join(dirpath, f)


def test_whole_name_comparison():
    from harness.main import forbidden_modules

    assert forbidden_modules([PORT, f"{PORT}.ops.cuda_astar", "numpy"]) == []
    assert forbidden_modules([f"{PORT}.data", "jaxlib.xla_client"]) == [
        "jaxlib"]
    assert forbidden_modules(["distributed_oracle_search_tpu.data.graph",
                              "flax"]) == ["distributed_oracle_search_tpu",
                                           "flax"]


def test_no_source_imports_jax():
    for path in sources("harness", "drivers", "reference", "roofline",
                        "metrics"):
        assert not imported_tops(path) & FORBIDDEN, path
    assert not imported_tops(os.path.join(BENCH, "run.py")) & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    for path in sources("reference", "roofline", "metrics"):
        assert PORT not in imported_tops(path), path
        assert not imported_tops(path) & FORBIDDEN, path


@pytest.mark.parametrize("cell", ["ny-w32.build", "ny-w32.astar"])
def test_a_run_loads_no_jax(tmp_path, cell):
    """A whole CPU run in a fresh process, then its ``sys.modules``."""
    root = make_root(tmp_path)
    code = (
        "import sys, io, contextlib\n"
        f"sys.path[:0] = [{BENCH!r}, {ROOT!r}]\n"
        "from harness.main import main, forbidden_modules\n"
        "with contextlib.redirect_stdout(io.StringIO()):\n"
        f"    rc = main(['--workload', {cell!r}, '--seed', '3', '--seconds',"
        f" '0.1', '--trace', '1'], root={root!r}, device='cpu')\n"
        "tops = {m.split('.')[0] for m in sys.modules}\n"
        f"assert {PORT!r} in tops\n"
        "print(rc, sorted(tops & {'jax', 'jaxlib', 'flax', "
        "'distributed_oracle_search_tpu'}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=ENV)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "0 []"


def test_without_the_program_a_run_fails(tmp_path):
    """A checkout holding only ``BENCHMARK.json`` and ``benchmark/``
    prints no result and exits non-zero."""
    root = make_root(tmp_path)
    code = (
        "import sys\n"
        f"sys.path[:0] = [{os.path.join(root, 'benchmark')!r}]\n"
        "from harness.main import main\n"
        "sys.exit(main(['--workload', 'ny-w32.build', '--seed', '1', "
        f"'--seconds', '0.1'], root={root!r}, device='cpu'))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=root, env=ENV)
    assert out.returncode != 0
    assert PORT in out.stderr and out.stdout.strip() == ""
