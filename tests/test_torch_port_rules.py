"""PyTorch port, boundaries: no module of the port, nor ``chip_smoke.py``,
imports JAX or the JAX package; and the port's entry points refuse to run
without a GPU unless the caller asks for the CPU."""

import ast
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

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
    out = [os.path.join(ROOT, "chip_smoke.py")]
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
