"""PyTorch port, the native (C++) engine's interoperability: the JAX
package's ``tests/test_native.py`` cases run over the port
(``torch_port_cases``), on the CPU.

The native engine is the repo's ``native/`` sources, built by their
Makefile (``make fast``); the port runs them as they are. This module
builds them from a copy of those sources in its own temporary directory,
so it never races another test module's build of ``native/build``.
Skipped, as in the JAX package, only where there is no ``g++``. Below
the cases, the port's own checks: ``make_cpds --engine native`` blocks
byte-equal to the port's ``worker.build`` blocks (both through the
port's CLI), ``utils.nativebin``'s search order, and the port's
``make_fifos`` command for ``fifo_auto``."""

import os
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)
from torch_port_cases import load_cases  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BINS = '''@pytest.fixture(scope="module")
def bins(tmp_path_factory):
    """Build the native engine (fast flavor) via the real Makefile, from
    a copy of the repo's native sources."""
    src = str(tmp_path_factory.mktemp("native") / "native")
    shutil.copytree(os.path.join(REPO, "native"), src,
                    ignore=shutil.ignore_patterns("build"))
    subprocess.run(["make", "-C", src, "fast", "-j4"], check=True,
                   capture_output=True)
    bindir = os.path.join(src, "build", "fast", "bin")
    return {name: os.path.join(bindir, name)
            for name in ("make_cpd_auto", "gen_distribute_conf",
                         "fifo_auto", "ch_check")}
'''

globals().update(load_cases("test_native.py", __name__, drop={}, replace={
    '''@pytest.fixture(scope="module")
def bins():
    """Build the native engine (fast flavor) via the real Makefile."""
    subprocess.run(["make", "-C", os.path.join(REPO, "native"), "fast",
                    "-j4"], check=True, capture_output=True)
    bindir = os.path.join(REPO, "native", "build", "fast", "bin")
    return {name: os.path.join(bindir, name)
            for name in ("make_cpd_auto", "gen_distribute_conf",
                         "fifo_auto", "ch_check")}
''': _BINS,
}))


# ------------------------------------------------------ the port's own

from distributed_oracle_search_tpu_torch.cli import (  # noqa: E402
    make_cpds, make_fifos,
)
from distributed_oracle_search_tpu_torch.data import (  # noqa: E402
    ensure_synth_dataset,
)
from distributed_oracle_search_tpu_torch.models.cpd import (  # noqa: E402
    read_manifest,
)
from distributed_oracle_search_tpu_torch.utils import (  # noqa: E402
    nativebin,
)
from distributed_oracle_search_tpu_torch.utils.config import (  # noqa: E402
    ClusterConfig,
)


def test_nativebin_searches_the_repo_root(monkeypatch, tmp_path):
    """The port's copy resolves the same repo root as the JAX package's:
    ``$DOS_NATIVE_BIN``, ``<repo>/bin``, then the Make build trees."""
    assert nativebin._REPO_ROOT == REPO
    assert nativebin.SEARCH_DIRS[1:] == (
        os.path.join(REPO, "bin"),
        os.path.join(REPO, "native", "build", "fast", "bin"),
        os.path.join(REPO, "native", "build", "dev", "bin"))
    fake = tmp_path / "fifo_auto"
    fake.write_text("#!/bin/sh\n")
    fake.chmod(0o755)
    monkeypatch.setattr(nativebin, "SEARCH_DIRS",
                        (str(tmp_path),) + nativebin.SEARCH_DIRS[1:])
    assert nativebin.require_binary("fifo_auto") == str(fake)
    with pytest.raises(FileNotFoundError, match="install.sh"):
        nativebin.require_binary("no_such_binary")


def test_make_fifos_native_command_and_ch_gate(monkeypatch, tmp_path):
    """``--engine native`` launches ``fifo_auto`` over the conf's files,
    on the command FIFO the head sends to (passed explicitly, as for the
    port's own server); ``--alg ch`` without it gives the JAX package's
    message."""
    monkeypatch.setattr(nativebin, "require_binary",
                        lambda name: f"/b/{name}")
    conf = ClusterConfig(workers=["localhost"] * 2, partmethod="mod",
                         partkey=2, outdir="/i", xy_file="/g.xy",
                         diffs=["-", "/d.diff"])
    cmd = make_fifos.worker_server_cmd(1, "c.json", engine="native",
                                       conf=conf, alg="ch")
    assert cmd == ("/b/fifo_auto --input /g.xy - --partmethod mod "
                   "--partkey 2 --workerid 1 --maxworker 2 --outdir /i "
                   "--alg ch --fifo /tmp/worker1.fifo")
    path = str(tmp_path / "c.json")
    conf.save(path)
    with pytest.raises(SystemExit, match="add --engine native"):
        make_fifos.main(["-c", path, "--alg", "ch"])


def test_make_cpds_native_blocks_equal_port_build(bins, tmp_path,
                                                  monkeypatch):
    """The port's ``make_cpds --engine native`` (one ``make_cpd_auto`` a
    worker) and ``make_cpds --backend host --device cpu`` (one
    ``worker.build`` a worker) write the same block files, byte for
    byte, and the same manifest digests."""
    monkeypatch.setattr(nativebin, "SEARCH_DIRS",
                        (os.path.dirname(bins["make_cpd_auto"]),))
    paths = ensure_synth_dataset(str(tmp_path / "data"), width=9,
                                 height=7, n_queries=16, seed=31)
    blocks = {}
    for engine in ("native", "python"):
        out = str(tmp_path / engine)
        conf = ClusterConfig(workers=["localhost"] * 3, partmethod="mod",
                             partkey=3, outdir=out, xy_file=paths["xy"],
                             scenfile=paths["scen"], nfs=str(tmp_path),
                             projectdir=REPO)
        cpath = str(tmp_path / f"{engine}.json")
        conf.save(cpath)
        assert make_cpds.main(["-c", cpath, "--backend", "host",
                               "--engine", engine, "--device",
                               "cpu"]) == 0
        blocks[engine] = {f: open(os.path.join(out, f), "rb").read()
                          for f in sorted(os.listdir(out))
                          if f.startswith("cpd-") and f.endswith(".npy")}
    assert blocks["native"] and blocks["native"] == blocks["python"]
    for f in blocks["native"]:
        a = np.load(os.path.join(tmp_path / "native", f))
        assert a.dtype == np.int8 and a.ndim == 2, f
    digests = {e: read_manifest(str(tmp_path / e))["blocks"]
               for e in blocks}
    assert digests["native"] == digests["python"]
    assert set(digests["native"]) == set(blocks["native"])
