"""PyTorch port, walk kernels on the card: the raw and pack4 CUDA walks
(``csrc/table_search_walk.cu``) answer bit-identically to the plain torch
walk on the same CUDA tensors, each launch is counted under its variant,
and the wrapper refuses a table of the wrong type or width.

Needs an NVIDIA GPU and ``nvcc``; skips without them. This file imports
the port only (no JAX), so it runs on a machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_walk.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from distributed_oracle_search_tpu_torch.data import synth_city_graph  # noqa: E402
from distributed_oracle_search_tpu_torch.models.resident import encode_pack4  # noqa: E402
from distributed_oracle_search_tpu_torch.ops import (  # noqa: E402
    DeviceGraph, build_fm_columns, cuda_walk_batch, table_search_batch,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _case(width: int, height: int, dev, seed: int):
    g = synth_city_graph(width, height, seed=seed)
    fm = build_fm_columns(DeviceGraph.from_graph(g, device="cpu"),
                          np.arange(g.n, dtype=np.int32)).numpy()
    rng = np.random.default_rng(seed)
    q = 512
    s = rng.integers(0, g.n, q).astype(np.int32)
    t = rng.integers(0, g.n, q).astype(np.int32)
    s[:8] = t[:8]                                  # zero-length lanes
    valid = rng.random(q) > 0.1
    w = (g.w * rng.uniform(1.0, 3.0, len(g.w))).astype(np.int32)
    on = {"dg": DeviceGraph.from_graph(g, device=dev),
          "rows": torch.as_tensor(t, device=dev),
          "s": torch.as_tensor(s, device=dev),
          "t": torch.as_tensor(t, device=dev),
          "valid": torch.as_tensor(valid, device=dev),
          "w": torch.as_tensor(g.padded_weights(w), dtype=torch.int32,
                               device=dev)}
    return g, fm, on


@pytest.mark.parametrize("packed4", [False, True])
@pytest.mark.parametrize("shape", [(8, 6), (5, 3), (33, 21)])
@pytest.mark.parametrize("k_moves", [-1, 3])
def test_kernel_equals_plain_walk(dev, packed4, shape, k_moves):
    g, fm, on = _case(*shape, dev, seed=shape[0])
    table = encode_pack4(fm) if packed4 else fm
    table = torch.as_tensor(table, device=dev)
    args = (on["dg"], table, on["rows"], on["s"], on["t"], on["w"])
    kw = {"valid": on["valid"], "k_moves": k_moves, "packed4": packed4}
    before = (cuda_walk_batch.launches, cuda_walk_batch.launches_pack4)
    ker = cuda_walk_batch(*args, **kw)
    torch.cuda.synchronize()
    plain = table_search_batch(*args, **kw)
    for a, b in zip(ker, plain):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert ker[2][on["valid"]].any()
    after = (cuda_walk_batch.launches, cuda_walk_batch.launches_pack4)
    assert after == ((before[0], before[1] + 1) if packed4
                     else (before[0] + 1, before[1]))


def test_wrapper_refuses_wrong_tables(dev):
    g, fm, on = _case(8, 6, dev, seed=1)
    args = (on["rows"], on["s"], on["t"], on["w"])
    with pytest.raises(TypeError, match="dtype"):
        cuda_walk_batch(on["dg"], torch.as_tensor(fm, device=dev).to(
            torch.uint8), *args)
    with pytest.raises(ValueError, match="fm must be"):
        cuda_walk_batch(on["dg"], torch.as_tensor(fm, device=dev), *args,
                        packed4=True)
    with pytest.raises(TypeError, match="dtype"):
        cuda_walk_batch(on["dg"], torch.as_tensor(
            encode_pack4(fm), device=dev).to(torch.int8), *args,
            packed4=True)
