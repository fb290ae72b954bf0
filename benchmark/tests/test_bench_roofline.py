"""The frozen roofline arithmetic against the chip smoke's records: K2's
bounds on the campaign graph and on the road, K6's 22 bytes a cell."""

import pytest

import bench_support  # noqa: F401  (puts benchmark/ on sys.path)
from harness import synth
from roofline.kernels import (
    astar_sweep_bytes, first_moves_bytes, first_moves_ops,
)
from roofline.peaks import bound_seconds


@pytest.mark.parametrize("n,b,nbytes,ms", [
    # the campaign graph, B = 8,192: "bound 0.8020 ms by bytes
    # (2686750244 B)" (chip smoke, [campaign] build-kernel first_moves)
    (65_536, 8_192, 2_686_750_244, 0.8020),
    # the road graph, B = 512: 0.2046 ms (PERF.md, K2's row)
    (264_000, 512, None, 0.2046),
])
def test_first_moves_bound_reproduces_the_smoke(n, b, nbytes, ms):
    m = len(synth.road_network(n, 0)[2])
    got = first_moves_bytes(n, m, b, b)
    if nbytes is not None:
        assert got == nbytes
    assert round(bound_seconds(got, first_moves_ops(m, b)) * 1e3, 4) == ms


def test_astar_sweep_bytes_reproduce_the_smoke():
    # "bound 0.4438 ms by bytes: 1486885888 B" (65,536 x 1,024, K = 20)
    assert astar_sweep_bytes(65_536, 20, 1_024) == 1_486_885_888
    assert round(bound_seconds(1_486_885_888, 0) * 1e3, 4) == 0.4438
