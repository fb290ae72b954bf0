"""PyTorch port, the single-machine driver (``cli/offline.py``) against
the JAX package's: ``make_parts`` gives JAX's parts under every scheme;
``offline.main`` on the same ``.xy``/``.scen``/``.diff`` files (its
in-process one-worker oracle on ``--device cpu``) writes JAX's
``parts.csv`` but for the timers, and JAX's ``metrics.json`` keys; the
``--local`` path through a port ``worker.server`` on its FIFO gives the
in-process counts; ``--cutoff`` keeps a small batch in-process; the entry
point raises without a GPU unless asked for the CPU."""

import csv
import json
import os
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)

from distributed_oracle_search_tpu.cli import offline as j_off  # noqa: E402
from distributed_oracle_search_tpu.cli.args import (  # noqa: E402
    parse_args as j_parse_args,
)
from distributed_oracle_search_tpu_torch.cli import offline as t_off  # noqa: E402
from distributed_oracle_search_tpu_torch.cli.args import parse_args  # noqa: E402
from distributed_oracle_search_tpu_torch.data import (  # noqa: E402
    Graph, read_diff, read_scen, synth_city_graph, synth_diff,
    synth_scenario, write_diff, write_scen, write_xy,
)
from distributed_oracle_search_tpu_torch.models.cpd import CPDOracle  # noqa: E402
from distributed_oracle_search_tpu_torch.parallel import (  # noqa: E402
    DistributionController,
)
from distributed_oracle_search_tpu_torch.utils.config import (  # noqa: E402
    ClusterConfig,
)
from distributed_oracle_search_tpu_torch.worker import server as t_server  # noqa: E402

TIMERS = ("t_receive", "t_astar", "t_search", "t_prepare", "t_partition")


def _reqs(n=200, n_nodes=256, seed=4):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, n_nodes, n),
                     rng.integers(0, n_nodes, n)], axis=1)


def _covers_exactly(parts, reqs):
    got = np.concatenate(parts) if parts else np.zeros((0, 2), np.int64)
    assert sorted(map(tuple, got)) == sorted(map(tuple, reqs))


@pytest.mark.parametrize("argv", [
    [], ["--group", "all"], ["--group", "mod"], ["--group", "div"],
    ["--alloc", "50", "120", "256"], ["--sort"],
    ["--group", "all", "--sort"],
])
def test_make_parts_partitions_exactly(argv):
    reqs = _reqs()
    parts = t_off.make_parts(reqs, parse_args(argv), num_parts=4)
    _covers_exactly(parts, reqs)
    want = j_off.make_parts(reqs, j_parse_args(argv), num_parts=4)
    assert len(parts) == len(want)
    for a, b in zip(parts, want):
        np.testing.assert_array_equal(a, b)


def test_make_parts_all_keeps_target_groups_whole():
    parts = t_off.make_parts(_reqs(80), parse_args(["--group", "all"]),
                             num_parts=5)
    seen = {}
    for i, p in enumerate(parts):
        for t in np.unique(p[:, 1]):
            assert seen.setdefault(int(t), i) == i, \
                "a destination group was split across parts"


def test_make_parts_sort_orders_by_target():
    for p in t_off.make_parts(_reqs(), parse_args(["--sort"]), num_parts=3):
        assert (np.diff(p[:, 1]) >= 0).all()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A 10 x 8 city as ``.xy``, 96 queries and a congestion diff."""
    d = tmp_path_factory.mktemp("offline")
    g = synth_city_graph(10, 8, seed=13)
    xy = str(d / "city.xy")
    write_xy(xy, g.xs, g.ys, g.src, g.dst, g.w)
    g = Graph.from_xy(xy)
    scen = str(d / "city.scen")
    write_scen(scen, synth_scenario(g.n, 96, seed=14))
    diff = str(d / "city.diff")
    write_diff(diff, *synth_diff(g, frac=0.2, seed=15))
    return str(d), xy, scen, diff


def _parts(path):
    with open(path) as f:
        rows = list(csv.reader(f))
    keep = [i for i, h in enumerate(rows[0]) if h not in TIMERS]
    return [[r[i] for i in keep] for r in rows]


def _offline(mod, files, out, *extra):
    _, xy, scen, diff = files
    assert mod.main(["-m", xy, "--scenario", scen, "--diffs", "-", diff,
                     "-o", out, "--device", "cpu", *extra]) == 0
    with open(os.path.join(out, "metrics.json")) as f:
        return _parts(os.path.join(out, "parts.csv")), json.load(f)


@pytest.mark.parametrize("extra", [
    ["-p", "4"], ["-s", "25", "--sort"], ["--group", "all", "-p", "3"],
    ["-k", "3"], ["-D", "-p", "4"],
])
def test_offline_main_equals_jax(files, tmp_path, extra):
    want, jm = _offline(j_off, files, str(tmp_path / "jax"), *extra)
    got, tm = _offline(t_off, files, str(tmp_path / "torch"), *extra)
    assert got == want
    assert sorted(tm) == sorted(jm)
    assert (tm["num_queries"], tm["num_partitions"]) == \
        (jm["num_queries"], jm["num_partitions"])
    col = {h: i for i, h in enumerate(got[0])}
    sizes = [int(r[col["size"]]) for r in got[1:] if r[0] == "0"]
    assert sum(sizes) == tm["num_queries"] == 96
    if "-D" in extra:
        assert tm["num_partitions"] == 1


def test_offline_counts_equal_a_direct_oracle(files, tmp_path):
    """Each part's plen and finished sums are a direct one-worker
    ``CPDOracle.query``'s over the part's queries, in both rounds."""
    d, xy, scen, diff = files
    got, _ = _offline(t_off, files, str(tmp_path / "o"), "-p", "4")
    col = {h: i for i, h in enumerate(got[0])}
    g = Graph.from_xy(xy)
    oracle = CPDOracle(g, DistributionController("tpu", None, 1, g.n),
                       device="cpu").build()
    parts = t_off.make_parts(read_scen(scen), parse_args(["-p", "4"]), 4)
    for expe, w in enumerate((None, g.weights_with_diff(read_diff(diff)))):
        rows = [r for r in got[1:] if r[0] == str(expe)]
        for part, r in zip(parts, rows):
            _, plen, fin = oracle.query(part, w_query=w)
            assert int(r[col["plen"]]) == int(plen.sum())
            assert int(r[col["finished"]]) == int(fin.sum())


def test_offline_local_through_a_fifo_server(files, tmp_path, monkeypatch):
    """``--local``: parts go through a port ``worker.server`` of a
    one-worker conf over its FIFO; the counters equal the in-process
    run's (the server's engine walks the same one-worker table)."""
    d, xy, scen, diff = files
    g = Graph.from_xy(xy)
    dc = DistributionController("tpu", None, 1, g.n)
    index = str(tmp_path / "index")
    CPDOracle(g, dc, device="cpu").build().save(index)
    nfs = tmp_path / "nfs"
    nfs.mkdir()
    conf = ClusterConfig(workers=["localhost"], partmethod="tpu",
                         partkey=None, outdir=index, xy_file=xy,
                         nfs=str(nfs)).validate()
    fifo = str(tmp_path / "offline.fifo")
    server = t_server.FifoServer(conf, 0, command_fifo=fifo, device="cpu")
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    for _ in range(200):
        if os.path.exists(fifo):
            break
        time.sleep(0.02)
    monkeypatch.setattr(t_off, "DEFAULT_ANSWER_FIFO",
                        str(tmp_path / "offline.answer"))
    try:
        local, _ = _offline(t_off, files, str(tmp_path / "local"), "-p", "4",
                            "--local", "--fifo", fifo, "--nfs", str(nfs))
    finally:
        t_server.stop_server(fifo)
        th.join(timeout=10)
    assert not th.is_alive()
    inproc, _ = _offline(t_off, files, str(tmp_path / "inproc"), "-p", "4")
    col = {h: i for i, h in enumerate(inproc[0])}
    assert len(local) == len(inproc) == 9
    for a, b in zip(local[1:], inproc[1:]):
        for key in ("expe", "plen", "finished", "size"):
            assert a[col[key]] == b[col[key]], key


def test_offline_cutoff_keeps_small_batches_in_process(files, tmp_path,
                                                       monkeypatch):
    fifo = str(tmp_path / "nobody.fifo")
    os.mkfifo(fifo)

    def no_wire(*a, **kw):
        raise AssertionError("a batch under --cutoff went over the FIFO")

    monkeypatch.setattr(t_off, "send_fifo", no_wire)
    got, _ = _offline(t_off, files, str(tmp_path / "o"), "-p", "2",
                      "--local", "--fifo", fifo, "--cutoff", "1000")
    assert len(got) == 5


def test_offline_needs_a_gpu_unless_asked(files, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    _, xy, scen, _ = files
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_off.main(["-m", xy, "--scenario", scen,
                    "-o", str(tmp_path / "o")])
