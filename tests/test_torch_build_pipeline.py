"""PyTorch port, the pipelined shard build (``models.cpd``): the stager
thread, the flush thread and the epoch-keyed ledger, held against the
JAX package's ``build_worker_shard`` and against the port's own serial
loop on the 8 x 6 toy city (8 workers, ``block_size`` 4: two blocks a
worker). Every comparison is exact: block files and ledger lines byte
for byte, at stage depths 1 and 2, every chunk, codecs raw and pack4;
``build_chunk_rows`` equal to JAX's; a resume, an epoch-keyed resume, a
flush or compute error (raised, no temp file left), the stager's order,
bound, error and abort contract, and the compute context a repeat build
reuses."""

import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)

from distributed_oracle_search_tpu.data import Graph as JGraph  # noqa: E402
from distributed_oracle_search_tpu.models import cpd as jcpd  # noqa: E402
from distributed_oracle_search_tpu.parallel.partition import (  # noqa: E402
    DistributionController as JDC,
)
from distributed_oracle_search_tpu.utils import atomicio as jatomicio  # noqa: E402
from distributed_oracle_search_tpu_torch.data import (  # noqa: E402
    Graph, synth_city_graph, synth_road_network,
)
from distributed_oracle_search_tpu_torch.models import cpd  # noqa: E402
from distributed_oracle_search_tpu_torch.parallel import (  # noqa: E402
    DistributionController,
)
from distributed_oracle_search_tpu_torch.utils import atomicio  # noqa: E402

W = 8
BS = 4


@pytest.fixture(scope="module")
def graphs():
    g = synth_city_graph(8, 6, seed=7)
    jg = JGraph(g.xs, g.ys, g.src, g.dst, g.w)
    return g, jg


def _dcs(g, bs=BS):
    return (DistributionController("tpu", W, W, g.n, block_size=bs),
            JDC("tpu", W, W, g.n, block_size=bs))


def _files(d, prefix=("cpd-", "build-")):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d)) if f.startswith(prefix)}


def _build_port(g, dc, d, **kw):
    written = {}
    for wid in range(dc.maxworker):
        written[wid] = cpd.build_worker_shard(g, dc, wid, d, device="cpu",
                                              **kw)
    return written


@pytest.fixture(scope="module")
def jax_index(graphs, tmp_path_factory):
    """The JAX package's blocks and ledgers, raw and pack4."""
    _, jg = graphs
    _, jdc = _dcs(jg)
    out = {}
    for codec in ("raw", "pack4"):
        d = str(tmp_path_factory.mktemp(f"jax-{codec}"))
        for wid in range(W):
            jcpd.build_worker_shard(jg, jdc, wid, d, codec=codec)
        out[codec] = _files(d)
    return out


# ------------------------------------------------------ pipeline parity

@pytest.mark.parametrize("codec", ["raw", "pack4"])
@pytest.mark.parametrize("chunk", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("depth", [1, 2])
def test_pipelined_build_bit_identical_to_serial(tmp_path, graphs, jax_index,
                                                 monkeypatch, depth, chunk,
                                                 codec):
    """Pipelined and serial loops write JAX's blocks and ledger lines,
    byte for byte; the stager counted every row it staged."""
    g, _ = graphs
    dc, _ = _dcs(g)
    monkeypatch.setenv("DOS_BUILD_STAGE_DEPTH", str(depth))
    monkeypatch.setenv("DOS_BUILD_PIPELINE", "1")
    staged0 = cpd.COUNTERS["build_rows_staged_total"]
    pipe = str(tmp_path / "pipe")
    written = _build_port(g, dc, pipe, chunk=chunk, codec=codec)
    assert cpd.COUNTERS["build_rows_staged_total"] - staged0 == g.n
    assert all(v == [cpd.shard_block_name(w, 0), cpd.shard_block_name(w, 1)]
               for w, v in written.items())
    monkeypatch.setenv("DOS_BUILD_PIPELINE", "0")
    serial = str(tmp_path / "serial")
    _build_port(g, dc, serial, chunk=chunk, codec=codec)
    assert _files(pipe) == _files(serial) == jax_index[codec]
    assert not [f for f in os.listdir(pipe) if atomicio.TMP_SUFFIX in f]


def test_pipeline_small_chunk_parity(tmp_path, graphs):
    """Multi-chunk blocks (chunk < block size) keep the bytes of a
    whole-shard batch."""
    g, _ = graphs
    dc, _ = _dcs(g)
    d1, d2 = str(tmp_path / "c2"), str(tmp_path / "whole")
    _build_port(g, dc, d1, chunk=2)
    _build_port(g, dc, d2)
    assert _files(d1, "cpd-") == _files(d2, "cpd-")


def test_pipeline_resume_recomputes_only_missing(tmp_path, graphs):
    g, jg = graphs
    dc, jdc = _dcs(g)
    d, j = str(tmp_path / "t"), str(tmp_path / "j")
    cpd.build_worker_shard(g, dc, 0, d, device="cpu")
    jcpd.build_worker_shard(jg, jdc, 0, j)
    victim = "cpd-w00000-b00001.npy"
    for x in (d, j):
        os.unlink(os.path.join(x, victim))
    r0 = cpd.COUNTERS["build_blocks_resumed_total"]
    assert cpd.build_worker_shard(g, dc, 0, d, device="cpu") == [victim]
    assert jcpd.build_worker_shard(jg, jdc, 0, j) == [victim]
    assert cpd.COUNTERS["build_blocks_resumed_total"] - r0 == 1
    assert _files(d) == _files(j)


@pytest.mark.parametrize("kind", ["ell", "ellsplit", "shift", "frontier"])
@pytest.mark.parametrize("budget_rows", [None, 1, 3, 100, 1e9])
def test_build_chunk_rows_budget(graphs, monkeypatch, kind, budget_rows):
    """``build_chunk_rows`` equals JAX's: the explicit chunk, the whole
    shard without a budget, the budget's power-of-two floor, the clamp
    to the shard and a malformed budget."""
    g, jg = graphs
    k = max(g.max_out_degree, 1)
    per_row = g.n * ((k + 2) * 4 if kind in ("ell", "ellsplit") else 12)
    if budget_rows is None:
        monkeypatch.delenv("DOS_BUILD_HBM_MB", raising=False)
    else:
        monkeypatch.setenv("DOS_BUILD_HBM_MB",
                           str(budget_rows * per_row / 1e6))
    for chunk, n_owned in ((64, 512), (0, 512), (0, 48), (0, 0)):
        assert (cpd.build_chunk_rows(g, chunk, n_owned, kind=kind)
                == jcpd.build_chunk_rows(jg, chunk, n_owned, kind=kind))
    if budget_rows == 100:
        assert cpd.build_chunk_rows(g, 0, 512, kind=kind) == 64
    monkeypatch.setenv("DOS_BUILD_HBM_MB", "not-a-number")
    assert cpd.build_chunk_rows(g, 0, 512, kind=kind) == 512


def test_stage_depth_knob(monkeypatch):
    for raw, want in (("3", 3), ("0", 1), ("-2", 1), ("junk", 2)):
        monkeypatch.setenv("DOS_BUILD_STAGE_DEPTH", raw)
        assert cpd.build_stage_depth() == want == jcpd.build_stage_depth()
    monkeypatch.delenv("DOS_BUILD_STAGE_DEPTH")
    assert cpd.build_stage_depth() == 2
    for raw, want in (("0", False), ("1", True), ("", True)):
        monkeypatch.setenv("DOS_BUILD_PIPELINE", raw)
        assert (cpd.build_pipeline_enabled() == want
                == jcpd.build_pipeline_enabled())


def test_atomic_npy_writer_and_copy(tmp_path):
    """The port's writer and copy give the JAX package's bytes and
    digests; an abort, and a failed copy, leave nothing behind."""
    arr = np.arange(12, dtype=np.int8).reshape(3, 4)
    p, jp = str(tmp_path / "b.npy"), str(tmp_path / "jb.npy")
    digest = atomicio.AtomicNpyWriter(p).commit(arr)
    assert digest == jatomicio.AtomicNpyWriter(jp).commit(arr)
    assert open(p, "rb").read() == open(jp, "rb").read()
    w2 = atomicio.AtomicNpyWriter(str(tmp_path / "c.npy"))
    w2.abort()
    q, jq = str(tmp_path / "copy.npy"), str(tmp_path / "jcopy.npy")
    assert atomicio.atomic_copy_file(p, q) == digest
    assert jatomicio.atomic_copy_file(p, jq) == digest
    assert open(q, "rb").read() == open(p, "rb").read()
    with pytest.raises(OSError):
        atomicio.atomic_copy_file(str(tmp_path / "absent.npy"),
                                  str(tmp_path / "x.npy"))
    assert sorted(os.listdir(tmp_path)) == ["b.npy", "copy.npy", "jb.npy",
                                            "jcopy.npy"]


# ------------------------------------------------- epoch-keyed ledger

def test_epoch_keyed_ledger_invalidation(tmp_path, graphs):
    """A block journaled under ANOTHER epoch (or none) does not satisfy an
    epoch-keyed resume; an un-keyed build keeps the plain rules. Ledger
    bytes equal the JAX package's at every step."""
    g, jg = graphs
    dc, jdc = _dcs(g)
    d, j = str(tmp_path / "t"), str(tmp_path / "j")

    def both(**kw):
        got = cpd.build_worker_shard(g, dc, 0, d, device="cpu", **kw)
        assert got == jcpd.build_worker_shard(jg, jdc, 0, j, **kw)
        assert _files(d) == _files(j)
        return got

    assert len(both(epoch=1)) == 2
    ledger = cpd.BuildLedger(d, 0)
    assert all(e.get("epoch") == 1 for e in ledger.entries().values())
    assert both(epoch=1) == []                 # same epoch: all resume
    assert len(both(epoch=2)) == 2             # another epoch: rebuilt
    assert both() == []                        # un-keyed: plain rules
    # a plain ledger line (no epoch key) never satisfies an epoch build
    d2 = str(tmp_path / "plain")
    cpd.build_worker_shard(g, dc, 0, d2, device="cpu")
    assert len(cpd.build_worker_shard(g, dc, 0, d2, device="cpu",
                                      epoch=3)) == 2


def test_ledger_record_keys(tmp_path):
    """``epoch`` and ``codec`` are written only when given, in the JAX
    package's key order."""
    for kw in ({}, {"epoch": 4}, {"codec": "pack4"},
               {"epoch": 4, "codec": "pack4"}):
        t = tmp_path / f"t{len(kw)}{'epoch' in kw}"
        j = tmp_path / f"j{len(kw)}{'epoch' in kw}"
        t.mkdir()
        j.mkdir()
        cpd.BuildLedger(str(t), 0).record("f.npy", "crc32:0", (2, 3),
                                          "int8", **kw)
        jcpd.BuildLedger(str(j), 0).record("f.npy", "crc32:0", (2, 3),
                                           "int8", **kw)
        assert _files(str(t)) == _files(str(j))


# ------------------------------------------------------- error paths

def _tmp_debris(d):
    return [f for f in os.listdir(d) if atomicio.TMP_SUFFIX in f]


@pytest.mark.parametrize("pipeline", ["1", "0"])
def test_flush_error_raises_and_leaves_no_tmp(tmp_path, graphs,
                                              monkeypatch, pipeline):
    """A write that fails on block 3 raises in the build loop; blocks
    0-2 stand, journaled in block order, and no temp file is left."""
    g, _ = graphs
    dc, _ = _dcs(g, bs=1)                      # 6 blocks a worker
    monkeypatch.setenv("DOS_BUILD_PIPELINE", pipeline)
    real = atomicio.AtomicNpyWriter.commit

    def commit(self, arr):
        if self.path.endswith("-b00003.npy"):
            raise OSError("planted flush fault")
        return real(self, arr)

    monkeypatch.setattr(atomicio.AtomicNpyWriter, "commit", commit)
    d = str(tmp_path / "idx")
    with pytest.raises(OSError, match="planted flush fault"):
        cpd.build_worker_shard(g, dc, 0, d, device="cpu")
    assert _tmp_debris(d) == []
    names = [cpd.shard_block_name(0, b) for b in range(3)]
    assert sorted(f for f in os.listdir(d) if f.endswith(".npy")) == names
    with open(cpd.ledger_path(d, 0)) as f:
        assert [line.split('"')[3] for line in f] == names
    # the rerun resumes the three and writes the rest
    monkeypatch.setattr(atomicio.AtomicNpyWriter, "commit", real)
    assert cpd.build_worker_shard(g, dc, 0, d, device="cpu") == [
        cpd.shard_block_name(0, b) for b in range(3, 6)]


@pytest.mark.parametrize("pipeline", ["1", "0"])
def test_compute_error_raises_and_leaves_no_tmp(tmp_path, graphs,
                                                monkeypatch, pipeline):
    """A kernel call that fails on the third block raises; every writer
    not yet landed is aborted, so what stands is a journaled prefix of
    the blocks (both, serially) and no temp file."""
    g, _ = graphs
    dc, _ = _dcs(g, bs=1)
    monkeypatch.setenv("DOS_BUILD_PIPELINE", pipeline)
    ctx = cpd._compute_ctx(None, g, "auto", 0, torch.device("cpu"))
    real, calls = ctx["compute"], []

    def compute(t, out=None, dist_out=None):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("planted kernel fault")
        return real(t, out=out, dist_out=dist_out)

    ctx["compute"] = compute
    d = str(tmp_path / "idx")
    with pytest.raises(RuntimeError, match="planted kernel fault"):
        cpd.build_worker_shard(g, dc, 0, d, device="cpu", ctx=ctx)
    assert _tmp_debris(d) == []
    on_disk = sorted(f for f in os.listdir(d) if f.endswith(".npy"))
    assert on_disk == [cpd.shard_block_name(0, b)
                       for b in range(len(on_disk))]
    assert len(on_disk) == 2 if pipeline == "0" else len(on_disk) <= 2
    assert sorted(cpd.BuildLedger(d, 0).entries()) == on_disk


def test_compute_context_reused(tmp_path, graphs, monkeypatch):
    """A repeat build with the same ``ctx`` uploads the graph, picks the
    kind and makes the build closure once; another graph starts over."""
    g, _ = graphs
    dc, _ = _dcs(g)
    counts = {"dg": 0, "pick": 0, "compute": 0}
    real_dg, real_pick = cpd.DeviceGraph.from_graph, cpd.pick_build_kernel
    real_cc = cpd.chunk_compute

    def count(key, fn):
        def wrapped(*a, **k):
            counts[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(cpd.DeviceGraph, "from_graph",
                        count("dg", real_dg))
    monkeypatch.setattr(cpd, "pick_build_kernel", count("pick", real_pick))
    monkeypatch.setattr(cpd, "chunk_compute", count("compute", real_cc))
    ctx: dict = {}
    for i, wid in enumerate(range(3)):
        cpd.build_worker_shard(g, dc, wid, str(tmp_path / f"a{i}"),
                               device="cpu", ctx=ctx)
    assert counts == {"dg": 1, "pick": 1, "compute": 1}
    cpd.build_worker_shard(g, dc, 0, str(tmp_path / "m"), device="cpu",
                           ctx=ctx, max_iters=3)
    assert counts == {"dg": 1, "pick": 1, "compute": 2}
    g2 = Graph(g.xs, g.ys, g.src, g.dst, g.w + 1)
    cpd.build_worker_shard(g2, dc, 0, str(tmp_path / "b"), device="cpu",
                           ctx=ctx)
    assert counts == {"dg": 2, "pick": 2, "compute": 3}
    assert ctx["graph"] is g2


def test_build_needs_a_gpu_unless_cpu(tmp_path, graphs):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None runs on it")
    g, _ = graphs
    dc, _ = _dcs(g)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cpd.build_worker_shard(g, dc, 0, str(tmp_path / "x"))


# ------------------------------------------------------------- stager

class _Writer:
    def __init__(self, log, bid):
        self.log, self.bid = log, bid

    def abort(self):
        self.log.append(self.bid)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_stager_order_and_bound(depth):
    """Items come in block order; the stager is never more than
    ``depth`` + 1 blocks ahead of the consumer."""
    staged, consumed, ahead = [], [], []
    lock = threading.Lock()

    def stage(bid):
        with lock:
            staged.append(bid)
            ahead.append(len(staged) - len(consumed))
        return bid, _Writer([], bid)

    st = cpd._BackgroundStager(range(10), stage, depth, 0)
    try:
        for bid, _w in st:
            with lock:
                consumed.append(bid)
            threading.Event().wait(0.01)
    finally:
        st.close()
    assert consumed == list(range(10))
    assert max(ahead) <= depth + 1


def test_stager_error_reraised_in_loop():
    def stage(bid):
        if bid == 2:
            raise ValueError("planted stage fault")
        return bid, _Writer([], bid)

    st = cpd._BackgroundStager(range(5), stage, 2, 0)
    got = []
    with pytest.raises(ValueError, match="planted stage fault"):
        for bid, _w in st:
            got.append(bid)
    st.close()
    assert got == [0, 1]


def test_stager_close_aborts_unconsumed():
    aborted: list = []
    st = cpd._BackgroundStager(range(6), lambda b: (b, _Writer(aborted, b)),
                               2, 0)
    it = iter(st)
    assert next(it)[0] == 0
    threading.Event().wait(0.2)           # let the stager fill its queue
    st.close()
    # every staged item but the consumed one is aborted, none twice (the
    # one the stager held when it stopped first, the queued ones after)
    assert len(set(aborted)) == len(aborted)
    assert sorted(aborted) == list(range(1, len(aborted) + 1))
    assert len(aborted) >= 2


def test_pipeline_on_a_road_graph_with_many_blocks(tmp_path, monkeypatch):
    """A degree-skewed graph, one worker, 10 blocks of 16 rows in chunks
    of 8 at depth 2: the pipelined blocks and ledger equal the serial
    loop's and JAX's."""
    g = synth_road_network(600, seed=2)
    jg = JGraph(g.xs, g.ys, g.src, g.dst, g.w)
    dc = DistributionController("mod", 4, 4, g.n, block_size=16)
    jdc = JDC("mod", 4, 4, g.n, block_size=16)
    assert -(-dc.n_owned(0) // 16) == 10
    outs = {}
    for pipe in ("1", "0"):
        monkeypatch.setenv("DOS_BUILD_PIPELINE", pipe)
        outs[pipe] = str(tmp_path / pipe)
        cpd.build_worker_shard(g, dc, 0, outs[pipe], chunk=8, device="cpu")
    j = str(tmp_path / "j")
    jcpd.build_worker_shard(jg, jdc, 0, j, chunk=8)
    assert _files(outs["1"]) == _files(outs["0"]) == _files(j)
