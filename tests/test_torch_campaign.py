"""PyTorch port, campaign CLIs: the port's ``gen_distribute_conf``,
``make_cpds`` and ``process_query`` against the JAX package's, each
package on its own copy of ``data/`` (the repo's ``data/index`` is never
written). Held equal: ``gen_distribute_conf``'s stdout; the index block
digests ``make_cpds -c`` writes; ``process_query -c … -o DIR``'s
``parts.csv`` (every column but the timers) over the conf's free-flow and
diff rounds, with ``-w``, and with ``-k 8 --extract``; ``paths.csv`` byte
for byte; ``metrics.json``'s keys; the ``-t`` modes; the exit codes. The
port's refusals name the ``ROADMAP.md`` item that ports each, and its
entry points raise without a GPU unless asked for the CPU."""

import csv
import json
import logging
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)

from distributed_oracle_search_tpu.cli import gen_distribute_conf as j_gen  # noqa: E402
from distributed_oracle_search_tpu.cli import make_cpds as j_make  # noqa: E402
from distributed_oracle_search_tpu.cli import process_query as j_pq  # noqa: E402
from distributed_oracle_search_tpu_torch.cli import (  # noqa: E402
    gen_distribute_conf as t_gen,
)
from distributed_oracle_search_tpu_torch.cli import make_cpds as t_make  # noqa: E402
from distributed_oracle_search_tpu_torch.cli import process_query as t_pq  # noqa: E402
from distributed_oracle_search_tpu_torch.cli.args import parse_args  # noqa: E402
from distributed_oracle_search_tpu_torch.data import (  # noqa: E402
    Graph, read_diff, read_scen,
)
from distributed_oracle_search_tpu_torch.models.cpd import CPDOracle  # noqa: E402
from distributed_oracle_search_tpu_torch.parallel import (  # noqa: E402
    DistributionController,
)
from distributed_oracle_search_tpu_torch.utils.config import (  # noqa: E402
    ClusterConfig, mesh_layout,
)

DATA = os.path.join(os.path.dirname(os.path.dirname(__file__)), "data")
TIMERS = ("t_receive", "t_astar", "t_search", "t_prepare", "t_partition")
PACKAGES = {"jax": (j_make, j_pq), "torch": (t_make, t_pq)}


@pytest.fixture(autouse=True, scope="module")
def _keep_package_loggers():
    """The CLIs' ``set_verbosity`` gives each package's root logger a
    handler and stops it propagating; later tests in this process read
    those loggers through ``caplog``, so their state is put back."""
    saved = []
    for name in ("dos_tpu", "dos_torch"):
        lg = logging.getLogger(name)
        saved.append((lg, list(lg.handlers), lg.propagate, lg.level))
    yield
    for lg, handlers, propagate, level in saved:
        lg.handlers[:] = handlers
        lg.propagate = propagate
        lg.setLevel(level)


@pytest.mark.parametrize("argv", [
    "--nodenum 100 --maxworker 8 --partmethod mod --partkey 8",
    "--nodenum 100 --maxworker 4 --partmethod div --partkey 30",
    "--nodenum 100 --maxworker 3 --partmethod alloc --partkey 10 50 100",
    "--nodenum 432 --maxworker 8 --partmethod tpu --partkey 8",
    "--nodenum 432 --maxworker 8 --partmethod tpu --partkey 8 "
    "--replication 3",
])
def test_gen_distribute_conf_stdout_equal(argv, capsys):
    assert j_gen.main(argv.split()) == 0
    want = capsys.readouterr().out
    assert t_gen.main(argv.split()) == 0
    got = capsys.readouterr().out
    assert got == want and len(got.splitlines()) > 100


def _copy_data(root) -> str:
    d = os.path.join(root, "data")
    shutil.copytree(DATA, d)
    return d


def _conf(root, data, **extra) -> str:
    conf = {"workers": [f"tpu:{i}" for i in range(8)], "partmethod": "tpu",
            "partkey": 8, "outdir": os.path.join(root, "index"),
            "xy_file": os.path.join(data, "synth-city.xy"),
            "scenfile": os.path.join(data, "synth.scen"),
            "diffs": ["-", os.path.join(data, "synth-city.xy.diff")],
            **extra}
    path = os.path.join(root, "conf.json")
    with open(path, "w") as f:
        json.dump(conf, f)
    return path


def _parts(path) -> tuple[list, list]:
    with open(path) as f:
        rows = list(csv.reader(f))
    head = rows[0]
    keep = [i for i, h in enumerate(head) if h not in TIMERS]
    return [head[i] for i in keep], [[r[i] for i in keep] for r in rows[1:]]


@pytest.fixture(scope="module")
def campaigns(tmp_path_factory):
    """Per package: ``make_cpds -c``, then ``process_query -c`` with the
    conf's two rounds, with ``-w 3``, and with ``-k 8 --extract``."""
    out = {}
    for name, (make, pq) in PACKAGES.items():
        root = str(tmp_path_factory.mktemp(f"campaign-{name}"))
        conf = _conf(root, _copy_data(root))
        dev = ["--device", "cpu"]       # the JAX parser passes it through
        rcs = [make.main(["-c", conf, *dev])]
        for tag, extra in (("rounds", []), ("w3", ["-w", "3"]),
                           ("k8", ["-k", "8", "--extract"])):
            rcs.append(pq.main(["-c", conf, "-o",
                                os.path.join(root, tag), *dev, *extra]))
        out[name] = (root, rcs)
    return out


def test_index_blocks_equal(campaigns):
    (jroot, _), (troot, _) = campaigns["jax"], campaigns["torch"]
    mans = []
    for root in (jroot, troot):
        with open(os.path.join(root, "index", "index.json")) as f:
            mans.append(json.load(f))
    assert mans[1]["files"] == mans[0]["files"]
    assert mans[1]["blocks"] == mans[0]["blocks"]
    for key in ("nodenum", "maxworker", "partmethod", "partkey",
                "block_size", "rows_per_worker", "version"):
        assert mans[1][key] == mans[0][key], key


@pytest.mark.parametrize("tag", ["rounds", "w3", "k8"])
def test_parts_csv_equal_but_timers(campaigns, tag):
    want = _parts(os.path.join(campaigns["jax"][0], tag, "parts.csv"))
    got = _parts(os.path.join(campaigns["torch"][0], tag, "parts.csv"))
    assert got == want
    head, rows = got
    assert head[0] == "expe" and "plen" in head and "size" in head
    assert {r[0] for r in rows} == {"0", "1"}              # two rounds
    assert len(rows) == (2 if tag == "w3" else 16)


@pytest.mark.parametrize("tag", ["rounds", "w3", "k8"])
def test_artifacts_equal(campaigns, tag):
    jdir = os.path.join(campaigns["jax"][0], tag)
    tdir = os.path.join(campaigns["torch"][0], tag)
    metrics = []
    for d in (jdir, tdir):
        with open(os.path.join(d, "metrics.json")) as f:
            metrics.append(json.load(f))
    assert sorted(metrics[1]) == sorted(metrics[0])
    assert metrics[1]["num_queries"] == metrics[0]["num_queries"] == 512
    assert metrics[1]["failed_batches"] == []
    with open(os.path.join(tdir, "data.json")) as f:
        assert json.load(f)["device"] == "cpu"
    # the metrics registry's snapshot beside parts.csv, as in JAX: the
    # same three sections and the head's histograms
    obs = []
    for d in (jdir, tdir):
        with open(os.path.join(d, "obs_metrics.json")) as f:
            obs.append(json.load(f))
    assert sorted(obs[1]) == sorted(obs[0]) == ["counters", "gauges",
                                                "histograms"]
    for name in ("head_partition_seconds", "head_search_seconds"):
        assert name in obs[1]["histograms"] and name in obs[0]["histograms"]
    if tag == "k8":
        with open(os.path.join(jdir, "paths.csv"), "rb") as f:
            want = f.read()
        with open(os.path.join(tdir, "paths.csv"), "rb") as f:
            got = f.read()
        assert got == want
        assert got.splitlines()[0] == b"s,t,moves,n0,n1,n2,n3,n4,n5,n6,n7,n8"
    else:
        assert not os.path.exists(os.path.join(tdir, "paths.csv"))


def test_exit_codes_equal(campaigns):
    assert campaigns["torch"][1] == campaigns["jax"][1] == [0, 0, 0, 0]


def test_parts_equal_a_direct_oracle_query(campaigns):
    """Within each round, ``parts.csv``'s per-worker plen and finished
    sums are those of a direct ``CPDOracle.query`` on the same index."""
    root = campaigns["torch"][0]
    conf = ClusterConfig.load(os.path.join(root, "conf.json"))
    g = Graph.from_xy(conf.xy_file)
    dc = DistributionController("tpu", 8, 8, g.n)
    oracle = CPDOracle(g, dc, device="cpu").load(conf.outdir)
    queries = read_scen(conf.scenfile)
    owner = dc.worker_of(queries[:, 1])
    head, rows = _parts(os.path.join(root, "rounds", "parts.csv"))
    col = {h: i for i, h in enumerate(head)}
    for expe, diff in enumerate(conf.diffs):
        w = None if diff == "-" else g.weights_with_diff(read_diff(diff))
        _, plen, fin = oracle.query(queries, w_query=w)
        mine = [r for r in rows if r[0] == str(expe)]
        for wid, r in enumerate(mine):
            assert int(r[col["plen"]]) == int(plen[owner == wid].sum())
            assert int(r[col["finished"]]) == int(fin[owner == wid].sum())
            assert int(r[col["size"]]) == int((owner == wid).sum())


def test_test_modes_agree(tmp_path, monkeypatch):
    """``-t`` on both packages: each builds the canned 8-worker config
    into its own ``./data/index`` and answers the canned campaign."""
    got = {}
    for name, (make, pq) in PACKAGES.items():
        root = tmp_path / name
        root.mkdir()
        _copy_data(str(root))
        monkeypatch.chdir(root)
        rcs = (make.main(["-t", "--device", "cpu"]),
               pq.main(["-t", "--device", "cpu", "-o", "out"]))
        with open(root / "data" / "index" / "index.json") as f:
            blocks = json.load(f)["blocks"]
        got[name] = (rcs, blocks, _parts(str(root / "out" / "parts.csv")))
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == (0, 0) and len(got["torch"][2][1]) == 8


def test_build_if_missing_and_print_mode(tmp_path, capsys):
    """With no index, ``process_query`` builds and saves one first; with
    no ``-o`` it prints the stats instead of writing artifacts."""
    root = str(tmp_path)
    conf = _conf(root, _copy_data(root))
    assert t_pq.main(["-c", conf, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "'num_queries': 512" in out and "'expe'" in out
    assert os.path.exists(os.path.join(root, "index", "index.json"))
    assert not os.path.exists(os.path.join(root, "metrics.json"))


def _head_spans(path) -> list:
    with open(path) as f:
        doc = json.load(f)
    assert sorted(doc) == ["displayTimeUnit", "traceEvents"]
    evs = doc["traceEvents"]
    for ev in evs:
        assert {"name", "ph", "ts", "dur", "pid", "tid", "args"} <= set(ev)
        assert ev["ph"] == "X"
    return sorted(ev["name"] for ev in evs if ev["name"].startswith("head."))


@pytest.mark.parametrize("argv,item", [
    (["--alg", "ch"], "no device analog"), (["--trace", "t.json"], "A14"),
    (["--metrics-dump", "m.json"], "A14"), (["--profile", "p"], "A14"),
    (["--obs-port", "0"], "A14"),
])
def test_process_query_refusals_name_roadmap(campaigns, tmp_path,
                                             monkeypatch, argv, item):
    """``--alg ch`` is refused in-process with the JAX package's words
    (the hierarchy is a CPU structure served by the native engine, on
    the host backend). The observability flags, refused until A14
    ported them, now
    act as in the JAX package on each package's campaign: ``--trace``
    writes a Chrome trace with the same head spans, ``--metrics-dump``
    the registry's sections with the same head histograms, ``--profile``
    a ``torch.profiler`` Chrome trace in its directory (the JAX package
    writes ``jax.profiler``'s there), and ``--obs-port`` serves
    ``/metrics`` while the campaign runs; the rows stay equal."""
    if argv[0] == "--alg":
        root = str(tmp_path)
        conf = _conf(root, _copy_data(root))
        with pytest.raises(SystemExit, match=item) as t_err:
            t_pq.main(["-c", conf, "--device", "cpu", *argv])
        with pytest.raises(SystemExit, match=item) as j_err:
            j_pq.main(["-c", conf, *argv])
        assert str(t_err.value) == str(j_err.value)
        return
    got = {}
    for name, (_make, pq) in PACKAGES.items():
        if argv[0] == "--profile" and name == "jax":
            continue                 # jax.profiler: not the port's tool
        root = campaigns[name][0]
        out = str(tmp_path / name)
        flag = [argv[0], str(tmp_path / f"{name}-{argv[1]}")
                if argv[0] != "--obs-port" else argv[1]]
        scraped = []
        if argv[0] == "--obs-port":
            # the JAX head imports start_obs_server inside main()
            from distributed_oracle_search_tpu.obs import http as j_http
            owner = pq if hasattr(pq, "start_obs_server") else j_http
            real_start, real_run = owner.start_obs_server, pq.run
            servers = []

            def start(port, *a, _real=real_start, **kw):
                servers.append(_real(port, *a, **kw))
                return servers[-1]

            def run(*a, _real=real_run, **kw):
                import urllib.request
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{servers[0].port}/metrics",
                        timeout=10) as r:
                    scraped.append((r.status, r.read().decode()))
                return _real(*a, **kw)

            monkeypatch.setattr(owner, "start_obs_server", start)
            monkeypatch.setattr(pq, "run", run)
        rc = pq.main(["-c", os.path.join(root, "conf.json"), "-o", out,
                      "--device", "cpu", *flag])
        art = flag[1]
        if argv[0] == "--trace":
            res = _head_spans(art)
        elif argv[0] == "--metrics-dump":
            with open(art) as f:
                snap = json.load(f)
            res = (sorted(snap),
                   {h: snap["histograms"][h]["count"] > 0
                    for h in ("head_partition_seconds",
                              "head_search_seconds")})
        elif argv[0] == "--profile":
            files = os.listdir(art)
            assert len(files) == 1 and files[0].endswith(".pt.trace.json")
            with open(os.path.join(art, files[0])) as f:
                assert json.load(f)["traceEvents"]
            res = None
        else:
            assert len(scraped) == 1 and scraped[0][0] == 200
            res = "# TYPE head_search_seconds histogram" in scraped[0][1]
        got[name] = (rc, res, _parts(os.path.join(out, "parts.csv")))
    if argv[0] == "--profile":
        want = _parts(os.path.join(campaigns["jax"][0], "rounds",
                                   "parts.csv"))
        assert got["torch"] == (0, None, want)
        return
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == 0 and got["torch"][1]


def _counts(stats):
    """The stats rows' counters and size (timers dropped)."""
    return [[r[:7] + r[-1:] for r in rows] for rows in stats]


def test_tpu_streamed_serve_fallback(tmp_path, monkeypatch):
    """The JAX drivers' test against the port's ``run_tpu``: with
    ``DOS_SERVE_STREAMED=1`` the in-process campaign serves from the
    on-disk index through the streamed oracle — the fused rounds, the
    ``-w 1`` filter and ``--extract -k 3`` — with the resident path's
    counts and paths, and the JAX package's."""
    from distributed_oracle_search_tpu.cli.args import (
        parse_args as j_parse_args,
    )
    from distributed_oracle_search_tpu.data import (
        ensure_synth_dataset as j_ensure,
    )
    from distributed_oracle_search_tpu.parallel.partition import (
        DistributionController as JDC,
    )
    from distributed_oracle_search_tpu.utils.config import (
        ClusterConfig as JClusterConfig,
    )

    monkeypatch.delenv("DOS_SERVE_STREAMED", raising=False)
    paths = j_ensure(str(tmp_path / "data"), width=10, height=8,
                     n_queries=96, seed=13)
    fields = dict(workers=[f"tpu:{i}" for i in range(4)], partmethod="tpu",
                  partkey=4, xy_file=paths["xy"], scenfile=paths["scen"],
                  diffs=["-", paths["diff"]])
    jconf = JClusterConfig(outdir=str(tmp_path / "jidx"), **fields)
    tconf = ClusterConfig(outdir=str(tmp_path / "tidx"), **fields)
    g = Graph.from_xy(paths["xy"])
    dc = DistributionController("tpu", None, 4, g.n)
    jdc = JDC("tpu", None, 4, g.n)
    queries = read_scen(paths["scen"])[:40]

    def runs(streamed: bool):
        if streamed:
            monkeypatch.setenv("DOS_SERVE_STREAMED", "1")
        else:
            monkeypatch.delenv("DOS_SERVE_STREAMED", raising=False)
        out = {}
        for argv, diffs in (([], fields["diffs"]), (["-w", "1"],
                                                    fields["diffs"]),
                            (["--extract", "-k", "3"], ["-"])):
            out[" ".join(argv)] = (
                t_pq.run_tpu(tconf, parse_args([*argv, "--device", "cpu"]),
                             queries, dc, diffs),
                j_pq.run_tpu(jconf, j_parse_args(argv), queries, jdc,
                             diffs))
        return out

    resident = runs(False)         # builds and saves both indexes
    streamed = runs(True)
    for key in resident:
        (t_res, j_res), (t_str, j_str) = resident[key], streamed[key]
        assert _counts(t_str[0]) == _counts(t_res[0]) == _counts(j_res[0])
        assert _counts(j_str[0]) == _counts(j_res[0])
        if key.startswith("--extract"):
            assert t_str[1] is not None
            np.testing.assert_array_equal(t_str[1], t_res[1])
            np.testing.assert_array_equal(t_str[1], j_str[1])
        else:
            assert t_str[1] is None


def test_streamed_plan_needs_a_gpu_unless_asked(tmp_path, monkeypatch):
    """Under ``DOS_SERVE_STREAMED=1`` the campaign raises without a GPU
    unless asked for the CPU, with and without an index on disk."""
    root = str(tmp_path)
    conf = _conf(root, _copy_data(root))
    monkeypatch.setenv("DOS_SERVE_STREAMED", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = os.path.join(root, "out")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_pq.main(["-c", conf, "-o", out])
    assert not os.path.exists(os.path.join(root, "index", "index.json"))
    assert t_pq.main(["-c", conf, "-o", out, "--device", "cpu"]) == 0
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_pq.main(["-c", conf, "-o", os.path.join(root, "out2")])


def test_streamed_gate_holds_the_whole_table(tmp_path, monkeypatch,
                                             campaigns):
    """The port's resident oracle puts every worker's rows on one card,
    so ``DOS_FM_BUDGET_GB`` holds ``W * R * N`` bytes: a conf whose one
    shard fits and whose whole table does not is served streamed, with
    the resident campaign's counts."""
    root = str(tmp_path)
    conf = _conf(root, _copy_data(root))
    g = Graph.from_xy(os.path.join(root, "data", "synth-city.xy"))
    dc = DistributionController("tpu", 8, 8, g.n)
    shard = dc.max_owned * g.n
    monkeypatch.delenv("DOS_SERVE_STREAMED", raising=False)
    monkeypatch.setenv("DOS_FM_BUDGET_GB", str(2 * shard / 1e9))
    made = []
    real = t_pq._StreamedServe.__init__

    def spy(self, *a, **kw):
        made.append(a)
        real(self, *a, **kw)

    monkeypatch.setattr(t_pq._StreamedServe, "__init__", spy)
    out = os.path.join(root, "rounds")
    assert t_pq.main(["-c", conf, "-o", out, "--device", "cpu"]) == 0
    assert len(made) == 1 and 8 * shard > 2 * shard
    want = _parts(os.path.join(campaigns["torch"][0], "rounds",
                               "parts.csv"))
    assert _parts(os.path.join(out, "parts.csv")) == want
    assert os.path.exists(os.path.join(root, "index", "index.json"))


@pytest.mark.parametrize("argv,item", [
    (["--delta-from", "old", "--diff", "d"], "A10"),
])
def test_make_cpds_refusals_name_roadmap(tmp_path, argv, item, capsys):
    """``--delta-from`` was refused, naming ``item``, until that ROADMAP
    item was ported: it now runs the delta path, which reports exit 4 in
    one JSON line when the old index has no readable manifest, and builds
    nothing (``tests/test_torch_delta.py`` drives a real delta)."""
    root = str(tmp_path)
    conf = _conf(root, _copy_data(root))
    assert t_make.main(["-c", conf, "--device", "cpu", *argv]) == 4
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["exit_code"] == 4 and out["index"] == "old" and out["fatal"]
    assert not os.path.exists(os.path.join(root, "index"))


def test_make_cpds_host_partmethod_refused(tmp_path, monkeypatch):
    """A host partmethod builds through worker processes; ``--engine
    native`` runs the native builder, and without its binary it fails
    as the JAX package does, naming ``./install.sh``, before any
    process starts."""
    from distributed_oracle_search_tpu_torch.utils import nativebin

    monkeypatch.setattr(nativebin, "SEARCH_DIRS", (str(tmp_path / "nb"),))
    root = str(tmp_path)
    data = _copy_data(root)
    conf = _conf(root, data, partmethod="mod",
                 workers=["localhost"] * 8)
    with pytest.raises(FileNotFoundError, match="install.sh"):
        t_make.main(["-c", conf, "--device", "cpu", "--engine", "native"])
    assert not os.path.exists(os.path.join(root, "index"))


@pytest.mark.parametrize("shape,axes,want", [
    (None, None, {"data": 1, "worker": 8}),
    ([2, 8], ["data", "worker"], {"data": 2, "worker": 8}),
    ([8], None, {"data": 1, "worker": 8}),
    ([8, 2], ["worker", "data"], {"data": 2, "worker": 8}),
])
def test_mesh_layout_parsed(shape, axes, want):
    conf = ClusterConfig(workers=["tpu"] * 8, partmethod="tpu", partkey=8,
                         mesh_shape=shape, mesh_axes=axes).validate()
    assert mesh_layout(conf) == want


@pytest.mark.parametrize("shape,axes,match", [
    ([2, 4], ["data", "worker"], "maxworker"),
    ([2, 8], ["data"], "same length"),
    ([2, 8], ["lane", "worker"], "drawn from"),
])
def test_mesh_layout_refused(tmp_path, shape, axes, match):
    root = str(tmp_path)
    conf = _conf(root, _copy_data(root), mesh_shape=shape, mesh_axes=axes)
    with pytest.raises(ValueError, match=match):
        mesh_layout(ClusterConfig.load(conf))
    with pytest.raises(ValueError, match=match):
        t_make.main(["-c", conf, "--device", "cpu"])


def test_args_parse_like_the_jax_parser():
    from distributed_oracle_search_tpu.cli.args import (
        parse_args as j_parse_args,
    )

    argv = ["-c", "x.json", "-k", "8", "--extract", "--diffs", "-", "a",
            "--ms-lim", "5", "--chunk", "16", "-w", "2", "--unknown", "1"]
    want = vars(j_parse_args(argv))
    got = vars(parse_args(argv))
    assert got.pop("device") == "cuda"
    assert got == want and len(got) == 56


def test_entry_points_raise_without_gpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root = str(tmp_path)
    conf = _conf(root, _copy_data(root))
    g = Graph.from_xy(os.path.join(root, "data", "synth-city.xy"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CPDOracle(g, DistributionController("tpu", 8, 8, g.n))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_make.main(["-c", conf])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_pq.main(["-c", conf, "-o", os.path.join(root, "out")])
    assert not os.path.exists(os.path.join(root, "index"))
    assert not os.path.exists(os.path.join(root, "out"))
    # asked for the CPU, they run
    assert t_make.main(["-c", conf, "--device", "cpu"]) == 0
    assert np.load(os.path.join(root, "index",
                                "cpd-w00000-b00000.npy")).shape[1] == g.n
