"""PyTorch port, the build's compressed fetch (``models.cpd.fetch_fm``,
``ops.cuda_fm_rle``) held against the JAX package's ``fetch_fm``,
``_fm_run_count``, ``_fm_rle_encode`` and ``_fetch_rle_eligible`` on the
same numpy inputs. Every comparison is exact: the run total and each
column's count, the first ``n_runs`` lengths and values (JAX pads the
rest), the fetched block, the gate's choice (encoded or plain: the
blocky, noise and tiny cases, ``DOS_FETCH_RLE=0``, C at 1, 2, 65,535
and 65,536, C x N at the gate and a cell either side, the incompressible
rule at ``3 * cap = C * N``) and the host expansion; then serial and
pipelined ``build_worker_shard`` and a ``delta_build_index`` with the
fetch on and off, the gate patched to 0 so the coded path runs: blocks,
ledger lines and ``index.json`` byte-equal to JAX's."""

import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)

import jax.numpy as jnp  # noqa: E402

from distributed_oracle_search_tpu.data import Graph as JGraph  # noqa: E402
from distributed_oracle_search_tpu.models import cpd as jcpd  # noqa: E402
from distributed_oracle_search_tpu.parallel.partition import (  # noqa: E402
    DistributionController as JDC,
)
from distributed_oracle_search_tpu_torch.data import (  # noqa: E402
    synth_city_graph, write_diff,
)
from distributed_oracle_search_tpu_torch.models import cpd  # noqa: E402
from distributed_oracle_search_tpu_torch.ops import (  # noqa: E402
    cuda_fm_rle as rle,
)
from distributed_oracle_search_tpu_torch.parallel import (  # noqa: E402
    DistributionController,
)

GATE = 16 << 20


def _blocky(rng, c, n, run=13, lo=-1, hi=6):
    return np.repeat(rng.integers(lo, hi, (-(-c // run), n)).astype(np.int8),
                     run, axis=0)[:c]


def _cases():
    rng = np.random.default_rng(7)
    return {
        "blocky": _blocky(rng, 60, 40),
        "noise": ((np.arange(64 * 32).reshape(64, 32) % 13) - 1
                  ).astype(np.int8),
        "tiny": np.zeros((1, 5), np.int8),
        "one-value": np.full((9, 7), 3, np.int8),
        "every-entry": ((np.arange(30 * 11).reshape(30, 11) % 2) * 2 - 1
                        ).astype(np.int8),
        "one-column": _blocky(rng, 50, 1, run=7),
        "two-rows": rng.integers(-1, 3, (2, 33)).astype(np.int8),
        "wide-runs": _blocky(rng, 300, 17, run=97),
    }


CASES = _cases()


@pytest.fixture
def low_gate(monkeypatch):
    """Both packages' size gate at 0: the coded path runs on small
    blocks."""
    monkeypatch.setattr(cpd, "FETCH_RLE_MIN_BYTES", 0)
    monkeypatch.setattr(jcpd, "FETCH_RLE_MIN_BYTES", 0)
    monkeypatch.delenv("DOS_FETCH_RLE", raising=False)


def _column_counts(fm: np.ndarray) -> np.ndarray:
    return 1 + (fm[1:] != fm[:-1]).sum(axis=0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_count_and_encode_equal_jax(name):
    fm = CASES[name]
    counts = rle.fm_run_count(torch.from_numpy(fm))
    assert counts.dtype == torch.int32
    np.testing.assert_array_equal(counts.numpy(), _column_counts(fm))
    offsets, total = rle.run_offsets(counts)
    assert total == int(jcpd._fm_run_count(jnp.asarray(fm)))
    np.testing.assert_array_equal(
        offsets.numpy(), np.concatenate([[0], np.cumsum(counts.numpy())[:-1]]))
    cap = 1 << max(total - 1, 0).bit_length()
    j_lens, j_vals = (np.asarray(x) for x in
                      jcpd._fm_rle_encode(jnp.asarray(fm), cap=cap))
    lens, vals = rle.fm_rle_encode_plain(torch.from_numpy(fm))
    assert lens.dtype == torch.uint16 and vals.dtype == torch.int8
    np.testing.assert_array_equal(lens.numpy(), j_lens[:total])
    np.testing.assert_array_equal(vals.numpy(), j_vals[:total])
    np.testing.assert_array_equal(
        rle.expand_runs(lens.numpy(), vals.numpy(), *fm.shape), fm)


@pytest.mark.parametrize("name", sorted(CASES))
def test_encode_wrapper_into_wire_views(name):
    """The wrapper writes the plain version's runs into the two views of
    one wire buffer, and counts a plain call."""
    fm = torch.from_numpy(CASES[name])
    counts = rle.fm_run_count(fm)
    offsets, total = rle.run_offsets(counts)
    wire = torch.full((3 * total + 5,), 7, dtype=torch.uint8)
    p0 = rle.fm_rle_encode.plain
    rle.fm_rle_encode(fm, offsets, *rle.wire_views(wire, total))
    assert rle.fm_rle_encode.plain == p0 + 1
    want_l, want_v = rle.fm_rle_encode_plain(fm)
    got_l, got_v = rle.wire_views(wire, total)
    assert torch.equal(got_l, want_l) and torch.equal(got_v, want_v)
    assert (wire[3 * total:] == 7).all()


def _spy_jax(monkeypatch):
    """Records whether JAX's fetch_fm took the coded path."""
    calls = []
    real = jcpd._fm_rle_encode

    def enc(fm, cap):
        calls.append(cap)
        return real(fm, cap=cap)

    monkeypatch.setattr(jcpd, "_fm_rle_encode", enc)
    return calls


def _fetch_both(monkeypatch, fm: np.ndarray) -> tuple[bool, bool]:
    """Both packages' fetch of ``fm``: byte-equal results; returns
    (JAX coded, port coded)."""
    calls = _spy_jax(monkeypatch)
    e0 = cpd.FETCH_STATS["build_fetch_encoded_total"]
    src = torch.from_numpy(fm.copy())
    got = cpd.fetch_fm(src)
    want = jcpd.fetch_fm(jnp.asarray(fm))
    assert got.dtype == np.int8 and got.shape == fm.shape
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got, fm)
    assert not np.shares_memory(got, src.numpy())
    return bool(calls), cpd.FETCH_STATS["build_fetch_encoded_total"] > e0


@pytest.mark.parametrize("name", sorted(CASES))
def test_fetch_fm_equal_jax(name, monkeypatch, low_gate):
    jax_coded, port_coded = _fetch_both(monkeypatch, CASES[name])
    assert port_coded == jax_coded
    fm = CASES[name]
    n_runs = int(_column_counts(fm).sum())
    cap = 1 << max(n_runs - 1, 0).bit_length()
    assert port_coded == (fm.shape[0] >= 2 and 3 * cap < fm.size)


@pytest.mark.parametrize("name", sorted(CASES))
def test_fetch_fm_off_is_plain(name, monkeypatch, low_gate):
    monkeypatch.setenv("DOS_FETCH_RLE", "0")
    assert _fetch_both(monkeypatch, CASES[name]) == (False, False)


@pytest.mark.parametrize("c", [1, 2, 65535, 65536])
def test_fetch_rows_at_the_uint16_edge(c, monkeypatch, low_gate):
    """One value a column: runs as long as the block (65,535 fits a
    uint16 length; 65,536 rows and 1 row go plain; at 2 rows one run a
    column cannot pay, 3 * cap >= 2 * N)."""
    fm = np.repeat(np.array([[2, -1, 0, 1]], np.int8), c, axis=0)
    coded = _fetch_both(monkeypatch, fm)
    assert coded == ((3 <= c <= 65535),) * 2


@pytest.mark.parametrize("shape", [
    (1, GATE), (2, GATE // 2), (4, GATE // 4), (3, (GATE - 1) // 3),
    (97, (GATE + 1) // 97),
    (65535, 257), (65536, 256), (65537, 256), (2, 1), (0, 5)])
@pytest.mark.parametrize("flag", [None, "1", "0", "", "junk"])
def test_gate_equal_jax(shape, flag, monkeypatch):
    """C x N at the gate, a cell under it (3 x 5,592,405) and a cell over
    it (97 x 172,961), the row bounds, and every spelling of the knob."""
    if flag is None:
        monkeypatch.delenv("DOS_FETCH_RLE", raising=False)
    else:
        monkeypatch.setenv("DOS_FETCH_RLE", flag)
    assert cpd._fetch_rle_eligible(shape) == jcpd._fetch_rle_eligible(shape)


@pytest.mark.parametrize("shape", [(4, GATE // 4), (3, (GATE - 1) // 3)])
def test_fetch_at_the_real_gate(shape, monkeypatch):
    """At the unpatched gate: a block of C x N = 2^24 cells is coded, one
    a cell smaller goes plain, in both packages."""
    monkeypatch.delenv("DOS_FETCH_RLE", raising=False)
    fm = np.zeros(shape, np.int8)
    fm[:, ::4096] = 5
    coded = _fetch_both(monkeypatch, fm)
    assert coded == ((fm.size >= GATE),) * 2


@pytest.mark.parametrize("c, n, runs_per_col", [
    (3, 4, 1),      # n_runs 4, cap 4: 3 * cap = 12 = C * N -> plain
    (13, 1, 4),     # n_runs 4, cap 4: 12 < 13 -> coded
    (4, 6, 2),      # n_runs 12, cap 16: 48 >= 24 -> plain
    (8, 5, 1),      # n_runs 5, cap 8: 24 < 40 -> coded
    (6, 4, 2),      # n_runs 8, cap 8: 24 = 24 -> plain
])
def test_incompressible_rule(c, n, runs_per_col, monkeypatch, low_gate):
    fm = np.zeros((c, n), np.int8)
    for k in range(1, runs_per_col):
        fm[k * c // runs_per_col:] += 1
    fm[:, ::2] *= -1
    n_runs = n * runs_per_col
    assert int(_column_counts(fm).sum()) == n_runs
    cap = 1 << (n_runs - 1).bit_length()
    coded = _fetch_both(monkeypatch, fm)
    assert coded == ((3 * cap < c * n),) * 2


def test_fetch_takes_the_callers_count(monkeypatch, low_gate):
    fm = CASES["blocky"]
    src = torch.from_numpy(fm)
    counts = rle.fm_run_count(src)
    p0 = rle.fm_run_count.plain
    np.testing.assert_array_equal(cpd.fetch_fm(src, count_dev=counts), fm)
    assert rle.fm_run_count.plain == p0


def test_fetch_counters(monkeypatch, low_gate):
    fm = CASES["wide-runs"]
    c0 = dict(cpd.FETCH_STATS)
    cpd.fetch_fm(torch.from_numpy(fm))
    n_runs = int(_column_counts(fm).sum())
    d = {k: cpd.FETCH_STATS[k] - c0[k] for k in cpd.FETCH_STATS}
    assert d["build_fetch_encoded_total"] == 1
    assert d["build_fetch_raw_bytes_total"] == fm.size
    assert d["build_fetch_wire_bytes_total"] == 3 * n_runs
    assert d["build_fetch_expand_seconds"] >= 0


def test_wrappers_refuse_what_they_cannot_take():
    with pytest.raises(ValueError):
        rle.fm_run_count(torch.zeros((3, 4), dtype=torch.int32))
    with pytest.raises(ValueError):
        rle.fm_rle_encode(torch.zeros((65536, 1), dtype=torch.int8),
                          torch.zeros(1, dtype=torch.int64),
                          torch.zeros(1, dtype=torch.uint16),
                          torch.zeros(1, dtype=torch.int8))
    with pytest.raises(ValueError):
        rle.fm_run_count(torch.zeros((3, 4), dtype=torch.int8,
                                     device="meta"))


# ---------------------------------------------------- builds, both packages

W = 2
BS = 32


@pytest.fixture(scope="module")
def world():
    g = synth_city_graph(16, 12, seed=7)
    jg = JGraph(g.xs, g.ys, g.src, g.dst, g.w)
    return {"g": g, "jg": jg,
            "tdc": DistributionController("tpu", W, W, g.n, block_size=BS),
            "jdc": JDC("tpu", W, W, g.n, block_size=BS)}


def _tree(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d))
            if os.path.isfile(os.path.join(d, f))}


def _encodes():
    return rle.fm_rle_encode.plain


@pytest.mark.parametrize("pipeline", ["0", "1"])
@pytest.mark.parametrize("fetch", ["0", "1"])
def test_build_equal_jax(world, tmp_path, monkeypatch, low_gate, pipeline,
                         fetch):
    """Serial and pipelined builds with the fetch coded (every block: 32
    rows of first moves along the target axis compress) and plain write
    JAX's blocks, ledger lines and manifest."""
    monkeypatch.setenv("DOS_BUILD_PIPELINE", pipeline)
    monkeypatch.setenv("DOS_FETCH_RLE", fetch)
    t, j = str(tmp_path / "t"), str(tmp_path / "j")
    e0, c0 = _encodes(), dict(cpd.FETCH_STATS)
    for wid in range(W):
        cpd.build_worker_shard(world["g"], world["tdc"], wid, t, device="cpu")
        jcpd.build_worker_shard(world["jg"], world["jdc"], wid, j)
    cpd.write_index_manifest(t, world["tdc"])
    jcpd.write_index_manifest(j, world["jdc"])
    assert _tree(t) == _tree(j)
    blocks = -(-world["g"].n // BS)
    coded = cpd.FETCH_STATS["build_fetch_encoded_total"] - \
        c0["build_fetch_encoded_total"]
    assert (_encodes() - e0, coded) == ((blocks, blocks) if fetch == "1"
                                        else (0, 0))
    assert cpd.FETCH_STATS["build_fetch_raw_bytes_total"] - \
        c0["build_fetch_raw_bytes_total"] == world["g"].n ** 2


def _diff(path, g, eids, mult):
    eids = np.asarray(eids)
    write_diff(str(path), g.src[eids], g.dst[eids],
               g.w[eids].astype(np.int64) * mult)
    return str(path)


@pytest.mark.parametrize("fetch", ["0", "1"])
def test_delta_equal_jax(world, tmp_path, monkeypatch, low_gate, fetch):
    """A delta whose dirty rows are recomputed in coded batches (on) or
    copied plain (off): the epoch index is JAX's byte for byte, and a
    build from scratch's."""
    monkeypatch.setenv("DOS_FETCH_RLE", fetch)
    g = world["g"]
    base = str(tmp_path / "base")
    for wid in range(W):
        cpd.build_worker_shard(g, world["tdc"], wid, base, device="cpu")
    cpd.write_index_manifest(base, world["tdc"])
    j, t = str(tmp_path / "j"), str(tmp_path / "t")
    shutil.copytree(base, j)
    shutil.copytree(base, t)
    fused = _diff(tmp_path / "fused-e000001.diff", g,
                  np.arange(40, 200, 7), 5)
    e0 = _encodes()
    trep = cpd.delta_build_index(g, world["tdc"], t, fused, device="cpu")
    jrep = jcpd.delta_build_index(world["jg"], world["jdc"], j, fused)
    assert {**trep, "outdir": None} == {**jrep, "outdir": None}
    assert trep["rows_recomputed"] > 0
    assert _tree(trep["outdir"]) == _tree(jrep["outdir"])
    assert (_encodes() > e0) == (fetch == "1")
