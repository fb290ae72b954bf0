"""PyTorch port, the worker supervisor (``worker/supervisor.py``) and the
fault-tolerant campaign against the JAX package's.

The JAX package's ``tests/test_supervisor.py`` and ``test_chaos.py``
cases run over the port (``torch_port_cases``), on the CPU: the
supervisor's own cases supervise dummy processes through its
``spawn_fn``/``probe_fn`` seams; the chaos drills (``slow``) supervise
real ``worker.server`` subprocesses, which are told ``device="cpu"``
(the supervisor's default is the card). Below them, the port's own
checks: the spawn command names the port's server and ``--device``,
and ``make_fifos --supervise`` passes its flags through."""

import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)
from torch_port_cases import load_cases  # noqa: E402

globals().update(load_cases("test_supervisor.py", __name__, drop={}))
globals().update(load_cases("test_chaos.py", __name__, drop={}, replace={
    "probe_timeout_s=5.0)": 'probe_timeout_s=5.0, device="cpu")',
}))


# ------------------------------------------------------ the port's own

from distributed_oracle_search_tpu_torch.cli import (  # noqa: E402
    make_fifos,
)
from distributed_oracle_search_tpu_torch.utils.config import (  # noqa: E402
    ClusterConfig,
)
from distributed_oracle_search_tpu_torch.worker import (  # noqa: E402
    supervisor as port_sup,
)


def _spawned_cmd(monkeypatch, **kw):
    captured = {}

    def fake_popen(cmd, **pkw):
        captured["cmd"] = cmd
        captured.update(pkw)
        raise RuntimeError("stop before spawning anything")

    monkeypatch.setattr(subprocess, "Popen", fake_popen)
    conf = ClusterConfig(workers=["localhost"] * 2).validate()
    sup = port_sup.WorkerSupervisor(conf, conf_path="conf.json", **kw)
    with pytest.raises(RuntimeError):
        sup._spawn_server(sup.workers[1])
    return captured


@pytest.mark.parametrize("kw,tail", [
    ({}, ["--device", "cuda"]),
    ({"device": "cpu"}, ["--device", "cpu"]),
    ({"device": "cuda", "metrics_dump": "m.json"},
     ["--device", "cuda", "--metrics-dump", "m.json.w1.json"]),
])
def test_spawn_runs_the_port_server_on_its_device(monkeypatch, kw, tail):
    """Every spawn (the first and each respawn go through the same
    ``_spawn_server``) starts the port's ``worker.server`` on the
    supervisor's device, the card unless the caller asks for the CPU."""
    cmd = _spawned_cmd(monkeypatch, **kw)["cmd"]
    assert cmd[:3] == [sys.executable, "-m",
                       "distributed_oracle_search_tpu_torch.worker.server"]
    assert cmd[cmd.index("--workerid") + 1] == "1"
    assert cmd[-len(tail):] == tail


def test_make_fifos_supervise_passes_device_and_dump(monkeypatch, tmp_path):
    """``make_fifos --supervise`` hands its ``--device``, its
    ``--metrics-dump``, ``--obs-port`` and ``--traffic-dir`` to
    :func:`supervise_forever`; remote hosts and the native engine are
    refused as in the JAX package."""
    seen = {}

    def fake_forever(conf, conf_path, **kw):
        seen.update(kw, conf_path=conf_path)
        return 0

    monkeypatch.setattr(port_sup, "supervise_forever", fake_forever)
    conf = ClusterConfig(workers=["localhost"] * 2, partmethod="mod",
                         partkey=2)
    path = str(tmp_path / "conf.json")
    conf.save(path)
    assert make_fifos.main(["-c", path, "--supervise", "--device", "cpu",
                            "--metrics-dump", "d.json", "--obs-port",
                            "0", "--traffic-dir", "tr"]) == 0
    assert seen == {"conf_path": path, "alg": "table-search",
                    "obs_port": 0, "traffic_dir": "tr", "device": "cpu",
                    "metrics_dump": "d.json"}
    assert make_fifos.main(["-c", path, "--supervise"]) == 0
    assert seen["device"] == "cuda"
    with pytest.raises(SystemExit, match="python worker.server"):
        make_fifos.main(["-c", path, "--supervise", "--engine", "native"])
    remote = ClusterConfig(workers=["localhost", "h2"], partmethod="mod",
                           partkey=2)
    rpath = str(tmp_path / "remote.json")
    remote.save(rpath)
    with pytest.raises(SystemExit, match="local-only"):
        make_fifos.main(["-c", rpath, "--supervise"])


def test_supervise_forever_serves_statusz_and_stops_children(
        monkeypatch, tmp_path):
    """The ``--supervise`` entry over dummy children: the fleet's
    ``/statusz`` names the supervisor's section and a SIGINT (here the
    ``KeyboardInterrupt`` it raises) stops every child."""
    import json
    import threading
    import time
    import types
    import urllib.request

    from distributed_oracle_search_tpu_torch.obs import http as obs_http
    from distributed_oracle_search_tpu_torch.transport.wire import (
        HealthStatus,
    )

    children = []
    # a child that exits on the stop token written to its command FIFO
    child = ("import os, sys; p = sys.argv[1]; os.mkfifo(p); "
             "fd = os.open(p, os.O_RDWR); os.read(fd, 64)")

    def spawn(w):
        p = subprocess.Popen([sys.executable, "-c", child, w.fifo],
                             start_new_session=True)
        children.append(p)
        return p

    def probe(w):
        return HealthStatus(ok=True, wid=w.wid)

    real = port_sup.WorkerSupervisor

    def mk(*a, **kw):
        return real(*a, spawn_fn=spawn, probe_fn=probe,
                    ping_interval_s=0.05, fifo_dir=str(tmp_path), **kw)

    monkeypatch.setattr(port_sup, "WorkerSupervisor", mk)
    servers = []
    real_start = obs_http.start_obs_server

    def start(port, **kw):
        srv = real_start(0, **kw)
        servers.append(srv)
        return srv

    monkeypatch.setattr(obs_http, "start_obs_server", start)
    got = {}

    def sleeper(s):
        url = f"http://127.0.0.1:{servers[0].port}/statusz"
        got["statusz"] = json.loads(urllib.request.urlopen(
            url, timeout=10).read())
        raise KeyboardInterrupt

    # the supervisor module's clock only: its ``while True: sleep``
    # loop ends at the first long sleep
    monkeypatch.setattr(port_sup, "time", types.SimpleNamespace(
        monotonic=time.monotonic,
        sleep=lambda s: sleeper(s) if s >= 3600 else time.sleep(s)))
    conf = ClusterConfig(workers=["localhost"] * 3, partmethod="mod",
                         partkey=3, nfs=str(tmp_path))
    assert port_sup.supervise_forever(conf, "c.json", obs_port=0,
                                      device="cpu") == 0
    sup = got["statusz"]["supervisor"]
    assert sup["alive"] == 3 and sup["workers_total"] == 3
    assert len(children) == 3
    assert [p.poll() for p in children] == [0, 0, 0]   # each took the token
    assert not [t for t in threading.enumerate()
                if t.name == "dos-supervisor" and t.is_alive()]
