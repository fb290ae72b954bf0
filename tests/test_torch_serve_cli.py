"""PyTorch port, ``dos-serve`` (``cli.serve``) on the CPU: a subprocess
over a built index answers stdin lines of every family as the JAX
package's ``cli.serve`` does over the same index, drains to exit 0 on
SIGTERM with every accepted request answered, and dumps its metrics with
the plain walks counted; the knobs of A14.5 are refused, naming it, and
an in-process backend asked for the card raises without one.
"""

import json
import os
import signal
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)

from distributed_oracle_search_tpu_torch.cli import serve as t_serve  # noqa: E402
from distributed_oracle_search_tpu_torch.data import (  # noqa: E402
    Graph, synth_city_graph, synth_scenario, write_scen, write_xy,
)
from distributed_oracle_search_tpu_torch.models.cpd import (  # noqa: E402
    build_worker_shard, write_index_manifest,
)
from distributed_oracle_search_tpu_torch.parallel import (  # noqa: E402
    DistributionController,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A 2-worker ``mod`` conf on a small city grid, its index built on
    the CPU by the port; returns ``(conf path, queries)``."""
    d = tmp_path_factory.mktemp("serve-cli")
    g = synth_city_graph(9, 7, seed=4)
    xy = str(d / "city.xy")
    write_xy(xy, g.xs, g.ys, g.src, g.dst, g.w)
    g = Graph.from_xy(xy)
    queries = synth_scenario(g.n, 24, seed=2)
    scen = str(d / "city.scen")
    write_scen(scen, queries)
    outdir = str(d / "index")
    dc = DistributionController("mod", 2, 2, g.n)
    for wid in range(2):
        build_worker_shard(g, dc, wid, outdir, device="cpu")
    write_index_manifest(outdir, dc)
    conf = str(d / "conf.json")
    with open(conf, "w") as f:
        json.dump({"workers": ["localhost"] * 2, "partmethod": "mod",
                   "partkey": 2, "outdir": outdir, "xy_file": xy,
                   "scenfile": scen, "diffs": ["-"], "nfs": str(d)}, f)
    return conf, queries


def _lines(queries):
    s0, t0 = map(int, queries[0])
    pairs = [f"{int(s)} {int(t)}" for s, t in queries]
    return pairs + [f"mat {s0} {t0} {int(queries[1][1])}", f"rev {s0} {t0}",
                    f"alt {s0} {t0} 2"]


def _serve(pkg, conf, lines, tmp_path, extra=()):
    """Run ``pkg``'s ``cli.serve`` on stdin ``lines`` to EOF; returns its
    exit code, answer lines and metrics dump."""
    dump = str(tmp_path / f"{pkg}-dump.json")
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", f"{pkg}.cli.serve", "-c", conf,
         "--metrics-dump", dump, *extra],
        input="".join(ln + "\n" for ln in lines), text=True,
        capture_output=True, cwd=str(tmp_path), env=env, timeout=TIMEOUT_S)
    with open(dump) as f:
        return proc.returncode, proc.stdout.splitlines(), json.load(f)


def test_stdin_answers_equal_jax_serve(world, tmp_path):
    conf, queries = world
    lines = _lines(queries)
    rc_t, got_t, dump_t = _serve("distributed_oracle_search_tpu_torch",
                                 conf, lines, tmp_path, ["--device", "cpu"])
    rc_j, got_j, _ = _serve("distributed_oracle_search_tpu", conf, lines,
                            tmp_path)
    assert rc_t == rc_j == 0
    assert got_t == got_j and len(got_t) == len(lines)
    assert all(ln.split()[0] in ("OK", "MAT", "REV", "ALT") for ln in got_t)
    c = dump_t["counters"]
    assert dump_t["device"]["type"] == "cpu"
    assert c["cuda_walk_batch.plain"] == (c["worker_batches_total"]
                                          + len(dump_t["device_programs"]))
    assert c["cuda_walk_batch.launches"] == 0
    assert c["serve_requests_ok_total"] >= len(queries)


def test_sigterm_drains_to_exit_0(world, tmp_path):
    """SIGTERM mid-session: the ingress stops, every accepted request is
    answered, the dump is written, exit 0."""
    conf, queries = world
    dump = str(tmp_path / "sig.json")
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributed_oracle_search_tpu_torch.cli."
         "serve", "-c", conf, "--device", "cpu", "--metrics-dump", dump],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
        cwd=str(tmp_path), env=dict(
            os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT + os.pathsep
            + os.environ.get("PYTHONPATH", "")))
    try:
        for s, t in queries[:3]:
            proc.stdin.write(f"{int(s)} {int(t)}\n")
        proc.stdin.flush()
        answers = [proc.stdout.readline().strip()]
        assert answers[0].startswith("OK ")
        proc.send_signal(signal.SIGTERM)
        answers += [ln.strip() for ln in proc.stdout if ln.strip()]
        rc = proc.wait(timeout=TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    assert rc == 0 and len(answers) == 3
    assert all(a.startswith("OK ") for a in answers)
    assert os.path.exists(dump)


@pytest.mark.parametrize("knob,value,argv", [
    ("DOS_SCRUB_INTERVAL_S", "30", []), ("DOS_AUDIT_RATE", "10", []),
    ("DOS_TELEMETRY_INTERVAL_S", "5", []), ("DOS_CONTROL", "1", []),
    (None, None, ["--recorder-dir", "tape"]),
])
def test_unported_planes_refused(world, monkeypatch, knob, value, argv):
    conf, _ = world
    for k in ("DOS_SCRUB_INTERVAL_S", "DOS_AUDIT_RATE",
              "DOS_TELEMETRY_INTERVAL_S", "DOS_CONTROL", "DOS_RECORDER_DIR"):
        monkeypatch.delenv(k, raising=False)
    if knob:
        monkeypatch.setenv(knob, value)
    with pytest.raises(SystemExit, match="A14.5"):
        t_serve.main(["-c", conf, "--device", "cpu", *argv])


def test_inproc_on_cuda_raises_without_gpu(world, monkeypatch):
    conf, _ = world
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = t_serve.build_parser().parse_args(["-c", conf])
    from distributed_oracle_search_tpu_torch.utils.config import (
        ClusterConfig)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_serve.build_frontend(ClusterConfig.load(conf), args)
    assert args.device == "cuda"
