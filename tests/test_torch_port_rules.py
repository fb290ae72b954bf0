"""PyTorch port, boundaries: no module of the port, nor ``chip_smoke.py``,
imports JAX or the JAX package; and the port's entry points refuse to run
without a GPU unless the caller asks for the CPU."""

import ast
import glob
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)

from distributed_oracle_search_tpu_torch.data import (  # noqa: E402
    synth_city_graph, write_xy,
)
from distributed_oracle_search_tpu_torch.models import cpd  # noqa: E402
from distributed_oracle_search_tpu_torch.ops import (  # noqa: E402
    DeviceGraph, cuda_walk_batch,
)
from distributed_oracle_search_tpu_torch.parallel import (  # noqa: E402
    DistributionController,
)
from distributed_oracle_search_tpu_torch.transport import RuntimeConfig  # noqa: E402
from distributed_oracle_search_tpu_torch.worker import build as wbuild  # noqa: E402
from distributed_oracle_search_tpu_torch.worker.engine import ShardEngine  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "distributed_oracle_search_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "distributed_oracle_search_tpu")


def _port_sources():
    """The port's modules, ``chip_smoke.py`` and the port-only worker
    scripts the multi-process tests spawn."""
    out = [os.path.join(ROOT, "chip_smoke.py")]
    out += glob.glob(os.path.join(ROOT, "tests", "torch_multihost_*.py"))
    for dirpath, _, files in os.walk(PORT):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def forbidden_imports(source: str) -> list[str]:
    """Top-level module names of every import statement in ``source``
    that names JAX or the JAX package (``..._torch`` is a different
    top-level name and does not match)."""
    bad = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad += [n for n in names if n.split(".")[0] in FORBIDDEN]
    return bad


def test_rule_matches_the_import_itself():
    assert forbidden_imports("import jax.numpy as jnp") == ["jax.numpy"]
    assert forbidden_imports(
        "from distributed_oracle_search_tpu.ops import x") == [
            "distributed_oracle_search_tpu.ops"]
    assert forbidden_imports(
        "from distributed_oracle_search_tpu_torch.ops import x\n"
        "from .jax import y\n'''import jax'''\n") == []


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_port_imports_no_jax(path):
    with open(path) as f:
        assert forbidden_imports(f.read()) == [], path


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    g = synth_city_graph(4, 3, seed=1)
    dc = DistributionController("mod", 2, 2, g.n)
    out = str(tmp_path_factory.mktemp("rules-index"))
    cpd.build_worker_shard(g, dc, 0, out, device="cpu")
    return g, dc, out


def test_entry_points_raise_without_gpu(no_gpu, small, tmp_path):
    g, dc, out = small
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceGraph.from_graph(g)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cpd.build_worker_shard(g, dc, 1, str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ShardEngine(g, dc, 0, out)
    xy = str(tmp_path / "g.xy")
    write_xy(xy, g.xs, g.ys, g.src, g.dst, g.w)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        wbuild.main(["--input", xy, "--partmethod", "mod", "--partkey", "2",
                     "--workerid", "0", "--maxworker", "2"])
    assert not any(f.endswith(".npy") for f in os.listdir(tmp_path))


def test_entry_points_run_on_cpu_when_asked(no_gpu, small):
    g, dc, out = small
    eng = ShardEngine(g, dc, 0, out, device="cpu")
    assert eng.fm.device.type == "cpu" and eng.dg.device.type == "cpu"
    q = np.stack([np.arange(g.n), np.zeros(g.n, np.int64)], 1)
    cost, plen, fin, _ = eng.answer(q, RuntimeConfig())
    assert fin.all() and cost[0] == 0


def test_walk_wrapper_rejects_other_devices(small):
    g, _, _ = small
    dg = DeviceGraph.from_graph(g, device="cpu")
    meta = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no walk"):
        cuda_walk_batch(dg, torch.zeros((1, g.n), dtype=torch.int8),
                        meta, meta, meta, dg.w_pad)


JAX_DIR = os.path.join(ROOT, "distributed_oracle_search_tpu") + os.sep
SERVING_MODULES = ("ops/pointer_doubling.py", "ops/cuda_doubling.py",
                   "ops/cuda_walk.py", "ops/table_search.py",
                   "parallel/sharded.py", "models/cpd.py",
                   "cli/process_query.py")


def _csrc_sources():
    d = os.path.join(PORT, "csrc")
    return sorted(os.path.join(d, f) for f in os.listdir(d)
                  if f.endswith((".cu", ".cuh", ".h")))


def test_serving_modules_are_scanned():
    scanned = {os.path.relpath(p, PORT) for p in _port_sources()}
    assert set(SERVING_MODULES) <= scanned
    names = {os.path.basename(p) for p in _csrc_sources()}
    assert {"table_search_walk.cu", "pointer_doubling.cu"} <= names


@pytest.mark.parametrize("path", _csrc_sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_kernel_sources_include_nothing_of_the_jax_package(path):
    with open(path) as f:
        includes = [ln for ln in f if ln.lstrip().startswith("#include")]
    assert includes and not any("distributed_oracle_search_tpu" in ln
                                for ln in includes), includes


def test_kernels_build_from_the_port_package():
    from distributed_oracle_search_tpu_torch.utils import cuda_build

    assert cuda_build.CSRC_DIR == os.path.join(PORT, "csrc")
    assert not cuda_build.BUILD_DIR.startswith(JAX_DIR)


def test_serving_path_reads_no_file_of_the_jax_package(small, monkeypatch,
                                                       tmp_path):
    """The serving methods, the fused campaign round's oracle calls and
    the doubling tables open no file under the JAX package's
    directory."""
    import builtins
    import io as _io

    opened = []
    real_open = builtins.open

    def spy(file, *a, **kw):
        opened.append(os.path.abspath(os.fspath(file))
                      if isinstance(file, (str, bytes, os.PathLike))
                      else str(file))
        return real_open(file, *a, **kw)

    monkeypatch.setattr(builtins, "open", spy)
    monkeypatch.setattr(_io, "open", spy)
    g, _, _ = small
    dc = DistributionController("tpu", 2, 2, g.n)
    o = cpd.CPDOracle(g, dc, device="cpu").build(store_dists=True)
    q = np.stack([np.arange(g.n), np.full(g.n, 2)], 1)
    ws = [None, g.w * 2]
    o.query_multi(q, ws)
    o.query_mat(1, [0, 2, 5])
    o.query_dist(q)
    o.query_table(o.prepare_weights(ws[1], chunk=2), q)
    o.query_table_multi(o.prepare_weights_multi(ws), q)
    o.save(str(tmp_path))
    assert opened and not any(p.startswith(JAX_DIR) for p in opened)


#: the modules A14.5 ported: every one is scanned by the import rule
PLANE_MODULES = ("obs/timeseries.py", "obs/telemetry.py", "obs/slo.py",
                 "obs/fleet.py", "integrity/scrub.py", "integrity/audit.py",
                 "control/__init__.py", "control/config.py",
                 "control/signals.py", "control/policy.py",
                 "control/actuators.py", "control/daemon.py",
                 "gateway/__init__.py", "gateway/protocol.py",
                 "gateway/registry.py", "gateway/client.py",
                 "gateway/server.py", "cli/gateway.py", "cli/serve.py")
#: of those, the copies: the JAX package's code
PLANE_COPIES = tuple(m for m in PLANE_MODULES
                     if m not in ("integrity/scrub.py", "cli/gateway.py",
                                  "cli/serve.py"))


def code_of(source: str) -> str:
    """``source``'s syntax tree without its docstrings (comments are not
    in the tree): what a module runs."""
    tree = ast.parse(source)
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                              ast.AsyncFunctionDef)) and body
                and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


def test_code_of_ignores_docstrings_and_comments_only():
    assert code_of('"""a"""\nx = 1  # b\n') == code_of("x = 1\n")
    assert code_of("def f():\n    'd'\n    return 1\n") == code_of(
        "def f():\n    return 1\n")
    assert code_of("x = 1\n") != code_of("x = 2\n")
    assert code_of("x = 'a'\n") != code_of("x = 'b'\n")


def test_plane_modules_are_scanned():
    scanned = {os.path.relpath(p, PORT) for p in _port_sources()}
    assert set(PLANE_MODULES) <= scanned


@pytest.mark.parametrize("rel", PLANE_COPIES)
def test_plane_copies_equal_the_jax_package(rel):
    """The planes' host modules are copies: their relative imports name
    the port's own modules, so the code is the JAX package's (the
    docstrings and comments may differ)."""
    with open(os.path.join(PORT, rel)) as f, \
            open(os.path.join(JAX_DIR, rel)) as g:
        assert code_of(f.read()) == code_of(g.read()), rel


#: the modules A15 ported, each a copy of the JAX package's file
TOOL_COPIES = ("analysis/__init__.py", "analysis/core.py",
               "analysis/rules.py", "cli/control.py", "cli/obs.py",
               "cli/lint.py", "data/dimacs.py", "utils/nativebin.py",
               "worker/supervisor.py")
#: the port's code differences from each copy, beyond the package's
#: name: JAX snippet -> port snippet (every snippet must occur). The
#: supervisor spawns its servers on ``device`` and can give each a
#: metrics dump; the rest differ in the package name alone (the lint
#: rules' package-relative paths, the spawned module)
TOOL_DIFFERENCES = {
    "worker/supervisor.py": {
        """                 rpc_dir: str | None = None):""":
        """                 rpc_dir: str | None = None,
                 device: str = "cuda", metrics_dump: str = ""):""",
        """        self.rpc_dir = rpc_dir
""": """        self.rpc_dir = rpc_dir
        self.device = device
        self.metrics_dump = metrics_dump
""",
        """               "--fifo", w.fifo, "--alg", self.alg]
""": """               "--fifo", w.fifo, "--alg", self.alg,
               "--device", self.device]
        if self.metrics_dump:
            cmd += ["--metrics-dump", f"{self.metrics_dump}.w{w.wid}.json"]
""",
        """                      traffic_dir: str | None = None) -> int:""":
        """                      traffic_dir: str | None = None,
                      device: str = "cuda", metrics_dump: str = "") -> int:""",
        """                           traffic_dir=traffic_dir)""":
        """                           traffic_dir=traffic_dir, device=device,
                           metrics_dump=metrics_dump)""",
    },
}
_JAX_NAME = re.compile(r"\bdistributed_oracle_search_tpu\b(?!_torch)")


def test_tool_modules_are_scanned():
    scanned = {os.path.relpath(p, PORT) for p in _port_sources()}
    assert set(TOOL_COPIES) <= scanned


@pytest.mark.parametrize("rel", TOOL_COPIES)
def test_tool_copies_equal_the_jax_package(rel):
    """The A15 tools are copies: their code, docstrings aside, is the
    JAX package's with the package's name replaced and the differences
    :data:`TOOL_DIFFERENCES` names, and nothing else."""
    with open(os.path.join(PORT, rel)) as f, \
            open(os.path.join(JAX_DIR, rel)) as g:
        port, jax_src = f.read(), g.read()
    for old, new in TOOL_DIFFERENCES.get(rel, {}).items():
        assert jax_src.count(old) == 1, (rel, old)
        jax_src = jax_src.replace(old, new)
    assert code_of(port) == code_of(_JAX_NAME.sub(
        "distributed_oracle_search_tpu_torch", jax_src)), rel


#: the other modules the port copied from the JAX package: their code,
#: docstrings aside, is the JAX package's with the package's name
#: replaced, as for TOOL_COPIES
COPIED_MODULES = (
    "__init__.py", "cli/__init__.py", "cli/gen_distribute_conf.py",
    "data/formats.py", "data/graph.py", "data/synth.py",
    "gateway/config.py", "integrity/config.py", "integrity/fingerprint.py",
    "models/__init__.py", "models/astar.py", "models/reference.py",
    "obs/__init__.py", "obs/quantiles.py", "obs/recorder.py",
    "obs/trace.py", "parallel/partition.py",
    "serving/__init__.py", "serving/batcher.py", "serving/cache.py",
    "serving/config.py", "serving/frontend.py", "serving/hedge.py",
    "serving/ingress.py", "serving/queue.py", "serving/request.py",
    "testing/__init__.py", "testing/faults.py",
    "traffic/__init__.py", "traffic/epochs.py", "traffic/families.py",
    "traffic/scenarios.py", "traffic/segments.py", "traffic/stream.py",
    "transport/__init__.py", "transport/frames.py", "transport/rpc.py",
    "utils/env.py", "utils/locks.py", "utils/timer.py")


#: the port's code differences from a copied module, beyond the
#: package's name, as :data:`TOOL_DIFFERENCES`: ``obs/trace.py`` records
#: while a ``torch.profiler`` session does, annotates the profiler's
#: trace with each span, keeps running totals by span name and lets a
#: span take args at its end
COPY_DIFFERENCES = {
    "obs/trace.py": {
        "import os\n": "import os\nimport sys\n",
        "import uuid\n": "import uuid\n\nfrom ..utils.counts import bump\n",
        """    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()
""": """    def __exit__(self, *exc):
        return False

    def set(self, **args) -> None:
        pass


_NULL_SPAN = _NullSpan()


class _Totals:
    def __getattr__(self, name: str):
        if name.startswith("__"):
            raise AttributeError(name)
        return 0


span_seconds = _Totals()
span_count = _Totals()


def _profiler():
    prof = sys.modules.get("torch.autograd.profiler")
    if prof is not None and getattr(prof, "_is_profiler_enabled", False):
        return prof
    return None
""",
        """    return _enabled or getattr(_tls, "capture", None) is not None
""": """    return (_enabled or getattr(_tls, "capture", None) is not None
            or _profiler() is not None)


def _add_total(name: str, seconds: float) -> None:
    bump(span_seconds, name, seconds)
    bump(span_count, name)
""",
        """    __slots__ = ("name", "args", "_t0_wall_us", "_t0_perf")
""": """    __slots__ = ("name", "args", "_t0_wall_us", "_t0_perf", "_annotation")
""",
        """    def __enter__(self):
        self._t0_wall_us = time.time_ns() // 1000
""": """    def set(self, **args) -> None:
        self.args.update(args)

    def __enter__(self):
        prof = _profiler()
        self._annotation = (None if prof is None
                            else prof.record_function(self.name))
        if self._annotation is not None:
            self._annotation.__enter__()
        self._t0_wall_us = time.time_ns() // 1000
""",
        """        dur_us = (time.perf_counter_ns() - self._t0_perf) // 1000
        _emit(_make_event(self.name, self._t0_wall_us, dur_us, self.args))
        return False
""": """        dur_ns = time.perf_counter_ns() - self._t0_perf
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
        _emit(_make_event(self.name, self._t0_wall_us, dur_ns // 1000,
                          self.args))
        _add_total(self.name, dur_ns / 1e9)
        return False
""",
        """    _emit(_make_event(name, time.time_ns() // 1000 - dur_us, dur_us,
                      args))
""": """    _emit(_make_event(name, time.time_ns() // 1000 - dur_us, dur_us,
                      args))
    _add_total(name, duration_s)
""",
    },
}


def _same_code_as_jax(rel: str) -> bool:
    """The port's ``rel`` runs the JAX package's code, the package's name
    replaced and :data:`COPY_DIFFERENCES` applied (docstrings and
    comments may differ)."""
    with open(os.path.join(PORT, rel)) as f, \
            open(os.path.join(JAX_DIR, rel)) as g:
        port, jax_src = f.read(), g.read()
    for old, new in COPY_DIFFERENCES.get(rel, {}).items():
        assert jax_src.count(old) == 1, (rel, old)
        jax_src = jax_src.replace(old, new)
    return code_of(port) == code_of(_JAX_NAME.sub(
        "distributed_oracle_search_tpu_torch", jax_src))


@pytest.mark.parametrize("rel", COPIED_MODULES)
def test_copied_modules_equal_the_jax_package(rel):
    assert _same_code_as_jax(rel), rel


def test_every_copy_is_held_to_the_jax_package():
    """A module whose code equals the JAX package's today is in one of the
    three copy lists, so a drift on a path no parity case drives fails
    here; and no module is in two of them."""
    listed = [*PLANE_COPIES, *TOOL_COPIES, *COPIED_MODULES]
    assert len(listed) == len(set(listed))
    equal = {rel for rel in (os.path.relpath(p, PORT)
                             for p in _port_sources() if p.startswith(PORT))
             if os.path.exists(os.path.join(JAX_DIR, rel))
             and _same_code_as_jax(rel)}
    assert sorted(equal - set(listed)) == []
