"""PyTorch port, the DIMACS 9th-challenge reader and converter
(``data/dimacs.py``) against the JAX package's.

The JAX package's DIMACS cases of ``tests/test_data.py`` and
``tests/test_drivers.py`` (the ``.gr``/``.co`` pipeline end to end:
convert, reorder, build, answer, costs equal the CPU oracle on the
original ids) run over the port (``torch_port_cases``), on the CPU.
Below them, the two packages are held to each other: the converter
CLI's ``.xy`` byte for byte, the readers' arrays, and the same errors
on malformed files."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)
from torch_port_cases import _port_on_cpu, load_cases  # noqa: E402,F401

# _port_on_cpu (autouse): the driver case calls the entry points with no
# device, as the JAX package's tests do; here they resolve to the CPU

globals().update(load_cases("test_data.py", __name__, drop={}, only=(
    "test_dimacs_roundtrip", "test_dimacs_converter_cli",
    "test_dimacs_without_coordinates")))
globals().update(load_cases("test_drivers.py", __name__, drop={}, replace={
    """from distributed_oracle_search_tpu.worker import (
    FifoServer, ShardEngine, stop_server,
)""": """from distributed_oracle_search_tpu.worker.server import (
    FifoServer, stop_server,
)
from distributed_oracle_search_tpu.worker.engine import ShardEngine"""},
    only=("test_dimacs_gr_co_pipeline_end_to_end",)))

from torch_parity import PKGS, both  # noqa: E402


def write_dimacs(g, gr: str, co: str) -> None:
    """``g`` as DIMACS ``.gr``/``.co`` files, 1-indexed (the layout of
    the JAX package's test helper)."""
    with open(gr, "w") as f:
        f.write(f"c synthetic road, DIMACS format\np sp {g.n} {g.m}\n")
        for u, v, w in zip(g.src, g.dst, g.w):
            f.write(f"a {u + 1} {v + 1} {w}\n")
    with open(co, "w") as f:
        f.write(f"p aux sp co {g.n}\n")
        for i, (x, y) in enumerate(zip(g.xs, g.ys)):
            f.write(f"v {i + 1} {x} {y}\n")


@pytest.mark.parametrize("n,seed", [(400, 0), (2500, 3)])
def test_converter_xy_equal_jax_byte_for_byte(tmp_path, n, seed):
    """``python -m <package>.data.dimacs --gr --co -o x.xy`` writes the
    same bytes from both packages, and the port's ``.xy`` reads back as
    the graph that was written."""
    from distributed_oracle_search_tpu_torch.data import (
        Graph, synth_road_network, write_xy,
    )

    g = synth_road_network(n, seed=seed)
    gr, co = str(tmp_path / "r.gr"), str(tmp_path / "r.co")
    write_dimacs(g, gr, co)

    def convert(P):
        out = str(tmp_path / f"{P.name}.xy")
        assert P.dimacs.main(["--gr", gr, "--co", co, "-o", out]) == 0
        with open(out, "rb") as f:
            return f.read()

    got = both(convert)
    assert got["torch"] == got["jax"]
    direct = str(tmp_path / "direct.xy")
    write_xy(direct, g.xs, g.ys, g.src, g.dst, g.w)
    g2 = Graph.from_xy(str(tmp_path / "torch.xy"))
    for k in ("xs", "ys", "src", "dst", "w"):
        np.testing.assert_array_equal(getattr(g2, k), getattr(g, k))
    with open(direct, "rb") as f:
        assert f.read() == got["torch"]


BAD = {
    "no problem line": ("c x\na 1 2 3\n", None),
    "arc past the header": ("p sp 2 1\na 1 2 3\na 2 1 3\n", None),
    "endpoint out of range": ("p sp 2 1\na 1 3 3\n", None),
    "weight at INF": ("p sp 2 1\na 1 2 1073741823\n", None),
    "short arc count": ("p sp 2 2\na 1 2 3\n", None),
    "co node count": ("p sp 2 1\na 1 2 3\n", "p aux sp co 3\nv 1 0 0\n"),
    "co id 0": ("p sp 2 1\na 1 2 3\n", "p aux sp co 2\nv 0 0 0\n"),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_malformed_files_fail_as_jax(tmp_path, case):
    """A malformed ``.gr``/``.co`` raises the same error, with the same
    message, in both packages (or is read the same, where JAX reads
    it)."""
    text, co_text = BAD[case]
    gr = str(tmp_path / "b.gr")
    with open(gr, "w") as f:
        f.write(text)
    co = None
    if co_text is not None:
        co = str(tmp_path / "b.co")
        with open(co, "w") as f:
            f.write(co_text)

    def read(P):
        try:
            g = P.dimacs.graph_from_dimacs(gr, co)
        except ValueError as e:
            return ("ValueError", str(e))
        return ("ok", g.n, g.m, g.src.tolist(), g.dst.tolist(),
                g.w.tolist())

    got = both(read)
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == "ValueError"


def test_port_data_exports_the_reader():
    """The port's ``data`` package exports the DIMACS entry points as
    the JAX package's does."""
    import importlib

    from distributed_oracle_search_tpu_torch import data

    jdata = importlib.import_module(f"{PKGS['jax'].dimacs.__package__}")
    for name in ("graph_from_dimacs", "read_gr", "read_co"):
        assert name in data.__all__ and callable(getattr(data, name))
    assert set(jdata.__all__) <= set(data.__all__)
