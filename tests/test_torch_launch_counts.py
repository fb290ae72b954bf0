"""PyTorch port, kernel launch counters under threads (``utils.counts``).

The serving frontend runs one batcher thread a shard plus hedge threads,
and a membership catch-up may rebuild blocks beside them, so several
threads of one process call the kernel wrappers at once. Each wrapper
counts on an attribute of its function (``cuda_walk_batch.plain``,
``relax_jacobi.plain``, ...) through ``utils.counts.bump``, under one
lock: eight threads each making N plain calls must leave each counter
exactly 8 N higher. The plain versions run here on the CPU; the card's
launch counts go through the same helper (``tests/
test_torch_cuda_serve.py`` checks them on the card).
"""

import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)

from distributed_oracle_search_tpu_torch.data import (  # noqa: E402
    synth_city_graph,
)
from distributed_oracle_search_tpu_torch.ops import (  # noqa: E402
    cuda_build_kernels as cbk,
)
from distributed_oracle_search_tpu_torch.ops.bellman_ford import (  # noqa: E402
    init_dist,
)
from distributed_oracle_search_tpu_torch.ops.cuda_walk import (  # noqa: E402
    cuda_walk_batch,
)
from distributed_oracle_search_tpu_torch.ops.device_graph import (  # noqa: E402
    DeviceGraph,
)
from distributed_oracle_search_tpu_torch.utils.counts import bump  # noqa: E402

THREADS = 8
N = 60


@pytest.fixture
def tight_switching():
    """Switch threads as often as the interpreter allows, so a counter
    update that is not atomic would lose increments."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    yield
    sys.setswitchinterval(old)


def _in_threads(fn):
    start = threading.Barrier(THREADS)
    errors = []

    def body():
        start.wait()
        try:
            for _ in range(N):
                fn()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)
    threads = [threading.Thread(target=body) for _ in range(THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    assert not any(t.is_alive() for t in threads)


@pytest.fixture(scope="module")
def small():
    g = synth_city_graph(6, 5, seed=2)
    dg = DeviceGraph.from_graph(g, device="cpu")
    return g, dg


def test_bump_is_exact_under_threads(tight_switching):
    def fn():
        pass
    fn.count = 0
    _in_threads(lambda: bump(fn, "count"))
    assert fn.count == THREADS * N


def test_plain_walks_counted_exactly(small, tight_switching):
    g, dg = small
    q = 16
    rng = np.random.default_rng(0)
    fm = torch.zeros((4, g.n), dtype=torch.int8)
    rows = torch.as_tensor(rng.integers(0, 4, q), dtype=torch.int32)
    s = torch.as_tensor(rng.integers(0, g.n, q), dtype=torch.int32)
    t = torch.as_tensor(rng.integers(0, g.n, q), dtype=torch.int32)
    before = (cuda_walk_batch.plain, cuda_walk_batch.launches)
    _in_threads(lambda: cuda_walk_batch(dg, fm, rows, s, t, dg.w_pad,
                                        k_moves=3))
    assert cuda_walk_batch.plain - before[0] == THREADS * N
    assert cuda_walk_batch.launches == before[1]


def test_plain_build_steps_counted_exactly(small, tight_switching):
    """Relax steps (K1's plain version) and first-move extractions (K2's)
    from eight threads at once: each counter rises by exactly 8 N."""
    g, dg = small
    csr = cbk.csr_from_ell(dg)
    targets = torch.arange(4, dtype=torch.int32)
    d0 = init_dist(g.n, targets)
    dist, _steps = cbk.jacobi_dist(csr, targets)

    def relax():
        out = torch.empty_like(d0)
        flag = torch.zeros(1, dtype=torch.int32)
        cbk.relax_jacobi(csr, d0, out, flag)

    before = (cbk.relax_jacobi.plain, cbk.first_moves.plain,
              cbk.relax_jacobi.launches, cbk.first_moves.launches)
    _in_threads(relax)
    _in_threads(lambda: cbk.first_moves(dg, targets, dist, csr=csr))
    assert cbk.relax_jacobi.plain - before[0] == THREADS * N
    assert cbk.first_moves.plain - before[1] == THREADS * N
    assert (cbk.relax_jacobi.launches, cbk.first_moves.launches) == \
        before[2:]


def test_device_capture_launches_once_a_key_under_threads(tight_switching):
    """``obs.device.capture`` from eight threads at one program key (the
    batcher threads' first batches): one timed launch between them, so a
    server's walk launches stay its batches plus its program keys."""
    from distributed_oracle_search_tpu_torch.obs import device as obs_device

    calls = []

    def launch():
        calls.append(1)
    key = "table-search[plain]/threads-test"
    _in_threads(lambda: obs_device.capture(key, launch, cost={}))
    assert len(calls) == 1 and key in obs_device.snapshot()
    with obs_device._lock:
        obs_device._COSTS.pop(key)
