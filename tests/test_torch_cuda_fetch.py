"""PyTorch port, the build's compressed fetch on the card
(``csrc/fm_rle.cu``, K7): the run count and the encode equal their plain
torch versions on the same blocks — one row, one column, one value, a
change at every entry, runs as long as 65,535 rows, blocky blocks at
widths no power of two divides and at a road block's 1,024 rows — each
launch counted; the encode's tiles (64 columns x 256 rows) at C = 1,
31, 32, 33, 1,024 and 65,535 rows, N off the tile's multiple (rows of
whole words and not), with an all-equal column, an alternating column
and runs across tile edges; ``fetch_fm`` of a CUDA block is the block, two launches
when it is coded and none when the gate or ``DOS_FETCH_RLE=0`` refuse
it; a pipelined build with the gate patched low writes the blocks of a
build with the fetch off, two launches a block; a kernel that fails to
build raises instead of falling back to a plain copy.

Needs an NVIDIA GPU and ``nvcc``; skips without them. This file imports
the port only (no JAX), so it runs on a machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_fetch.py
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)

from distributed_oracle_search_tpu_torch.data import synth_city_graph  # noqa: E402
from distributed_oracle_search_tpu_torch.models import cpd  # noqa: E402
from distributed_oracle_search_tpu_torch.ops import cuda_fm_rle as rle  # noqa: E402
from distributed_oracle_search_tpu_torch.parallel import (  # noqa: E402
    DistributionController,
)
from distributed_oracle_search_tpu_torch.utils import cuda_build  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _blocky(seed: int, c: int, n: int, run: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.repeat(rng.integers(-1, 8, (-(-c // run), n)).astype(np.int8),
                     run, axis=0)[:c]


BLOCKS = {
    "one-row": np.arange(-1, 40, dtype=np.int8)[None],
    "one-column": _blocky(1, 77, 1, 5),
    "one-value": np.full((200, 33), 4, np.int8),
    "every-entry": ((np.arange(64 * 45).reshape(64, 45) % 2) * 3 - 1
                    ).astype(np.int8),
    "longest-runs": np.repeat(np.array([[1, -1, 0]], np.int8), 65535,
                              axis=0),
    "blocky-odd": _blocky(2, 333, 1001, 17),
    "road-rows": _blocky(3, 1024, 66_001, 23),
}


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_count_and_encode_equal_plain(dev, name):
    fm = torch.from_numpy(BLOCKS[name]).to(dev)
    l0, e0 = rle.fm_run_count.launches, rle.fm_rle_encode.launches
    counts = rle.fm_run_count(fm)
    torch.cuda.synchronize()
    assert torch.equal(counts, rle.fm_run_count_plain(fm))
    offsets, total = rle.run_offsets(counts)
    wire = torch.empty(3 * total, dtype=torch.uint8, device=dev)
    rle.fm_rle_encode(fm, offsets, *rle.wire_views(wire, total))
    torch.cuda.synchronize()
    lens, vals = rle.wire_views(wire, total)
    want_l, want_v = rle.fm_rle_encode_plain(fm)
    assert torch.equal(lens, want_l) and torch.equal(vals, want_v)
    assert (rle.fm_run_count.launches - l0,
            rle.fm_rle_encode.launches - e0) == (1, 1)
    host = rle.wire_views(wire.cpu(), total)
    np.testing.assert_array_equal(
        rle.expand_runs(host[0].numpy(), host[1].numpy(), *fm.shape),
        BLOCKS[name])


def _tiles(c: int, n: int, seed: int) -> np.ndarray:
    """A [c, n] block (three 64-column tiles and a few columns): column
    0 all one value, column 1 alternating, column 64 (a tile's first)
    alternating in pairs, the rest runs of 1 to 600 rows (across the
    256-row tiles)."""
    rng = np.random.default_rng(seed)
    fm = np.empty((c, n), np.int8)
    for j in range(n):
        lens = rng.integers(1, 600, c)
        vals = rng.integers(-1, 8, c).astype(np.int8)
        fm[:, j] = np.repeat(vals, lens)[:c]
    i = np.arange(c)
    fm[:, 0] = 6
    fm[:, 1] = (i % 2) * 7 - 1
    fm[:, 64] = (i // 2 % 2) * 3
    return fm


@pytest.mark.parametrize("n", [196, 197], ids=["words", "bytes"])
@pytest.mark.parametrize("c", [1, 31, 32, 33, 1024, 65535])
def test_encode_tiles_equal_plain(dev, c, n):
    """Rows of whole 32-bit words (N % 4 == 0: the register loads) and
    not (byte loads), N off the tile's 64 columns."""
    fm = torch.from_numpy(_tiles(c, n, c)).to(dev)
    offsets, total = rle.run_offsets(rle.fm_run_count(fm))
    wire = torch.full((3 * total + 3,), 0x5A, dtype=torch.uint8,
                      device=dev)
    e0 = rle.fm_rle_encode.launches
    rle.fm_rle_encode(fm, offsets, *rle.wire_views(wire, total))
    torch.cuda.synchronize()
    assert rle.fm_rle_encode.launches == e0 + 1
    lens, vals = rle.wire_views(wire, total)
    want_l, want_v = rle.fm_rle_encode_plain(fm)
    assert torch.equal(lens, want_l) and torch.equal(vals, want_v)
    # nothing past the runs is written
    assert bool((wire[3 * total:] == 0x5A).all())


@pytest.mark.parametrize("gate, flag, launches", [
    (0, None, 2), (0, "0", 0), (1 << 40, None, 0)])
def test_fetch_fm_on_the_card(dev, monkeypatch, gate, flag, launches):
    monkeypatch.setattr(cpd, "FETCH_RLE_MIN_BYTES", gate)
    if flag is None:
        monkeypatch.delenv("DOS_FETCH_RLE", raising=False)
    else:
        monkeypatch.setenv("DOS_FETCH_RLE", flag)
    block = BLOCKS["road-rows"]
    n0 = rle.fm_run_count.launches + rle.fm_rle_encode.launches
    got = cpd.fetch_fm(torch.from_numpy(block).to(dev))
    np.testing.assert_array_equal(got, block)
    assert (rle.fm_run_count.launches + rle.fm_rle_encode.launches
            - n0) == launches


def test_pipelined_build_fetch_on_equals_off(dev, tmp_path, monkeypatch):
    """Worker 0 of a 64 x 48 city (``tpu`` over 4, blocks of 128 rows):
    the coded fetch's blocks and ledger are the plain fetch's, with two
    K7 launches a block."""
    monkeypatch.setattr(cpd, "FETCH_RLE_MIN_BYTES", 0)
    monkeypatch.setenv("DOS_BUILD_PIPELINE", "1")
    g = synth_city_graph(64, 48, seed=3)
    dc = DistributionController("tpu", 4, 4, g.n, block_size=128)
    out = {}
    for flag in ("1", "0"):
        monkeypatch.setenv("DOS_FETCH_RLE", flag)
        d = str(tmp_path / flag)
        n0 = rle.fm_run_count.launches + rle.fm_rle_encode.launches
        names = cpd.build_worker_shard(g, dc, 0, d, chunk=64, device=dev)
        out[flag] = ({f: open(os.path.join(d, f), "rb").read()
                      for f in sorted(os.listdir(d))},
                     rle.fm_run_count.launches + rle.fm_rle_encode.launches
                     - n0, len(names))
    assert out["1"][0] == out["0"][0]
    assert out["1"][1] == 2 * out["1"][2] and out["0"][1] == 0


def test_a_failed_build_raises(dev, monkeypatch):
    monkeypatch.setattr(cpd, "FETCH_RLE_MIN_BYTES", 0)
    monkeypatch.delenv("DOS_FETCH_RLE", raising=False)
    monkeypatch.setattr(rle, "_fns", {})

    def broken(name):
        raise RuntimeError(f"nvcc failed on {name}")

    monkeypatch.setattr(cuda_build, "load_library", broken)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        cpd.fetch_fm(torch.from_numpy(BLOCKS["blocky-odd"]).to(dev))
