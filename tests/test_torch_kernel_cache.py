"""PyTorch port, the kernel build cache (``utils.cuda_build``) across
processes, on the CPU with a fake ``nvcc`` first on ``PATH``: two
processes that load the same source on a cold cache run the compiler
once between them (the per-source ``flock``), and both load the one
library it published."""

import json
import os
import subprocess
import sys
import textwrap

import pytest

pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FAKE_NVCC = """\
#!{python}
# stands in for nvcc: books the call, takes a while, and publishes a
# loadable shared object at the -o path
import shutil, sys, time, _ctypes
with open({count!r}, "a") as f:
    f.write("compile\\n")
time.sleep(1.5)
shutil.copyfile(_ctypes.__file__, sys.argv[sys.argv.index("-o") + 1])
"""

CHILD = """\
import json, sys
from distributed_oracle_search_tpu_torch.utils import cuda_build as cb
cb.CSRC_DIR, cb.BUILD_DIR = sys.argv[1], sys.argv[2]
cb.load_library("fake")
print(json.dumps(cb.build_info["fake"]))
"""


def test_two_processes_compile_a_source_once(tmp_path):
    bindir, csrc, build = (tmp_path / n for n in ("bin", "csrc", "build"))
    for d in (bindir, csrc):
        d.mkdir()
    (csrc / "fake.cu").write_text("// a source\n")
    count = str(tmp_path / "calls")
    nvcc = bindir / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable, count=count))
    nvcc.chmod(0o755)
    env = dict(os.environ, PATH=f"{bindir}{os.pathsep}{os.environ['PATH']}",
               PYTHONPATH=ROOT)
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(CHILD), str(csrc),
         str(build)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env, cwd=str(tmp_path)) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [e for _, e in outs]
    infos = [json.loads(o.strip().splitlines()[-1]) for o, _ in outs]
    with open(count) as f:
        assert f.read().splitlines() == ["compile"]
    assert infos[0]["path"] == infos[1]["path"]
    assert os.path.exists(infos[0]["path"])
    assert sorted(i["seconds"] > 0 for i in infos) == [False, True]
    assert not [f for f in os.listdir(build) if ".tmp." in f]
    assert os.path.exists(build / "fake.lock")
