"""K2's share of its roofline over the window: the least time its
launches could take (their bytes over the HBM rate, ``roofline``) over
the device time the trace gives ``first_moves_kernel``. K2's bytes do
not depend on the data, so the share cannot pass 100% honestly."""

from roofline.kernels import first_moves_bytes, first_moves_ops
from roofline.peaks import bound_seconds


def read(run):
    k = run["kernels"].get("first_moves_kernel")
    launches = run["shapes"].get("first_moves", [])
    if not k or not launches or k["seconds"] <= 0:
        return None
    if k["launches"] != len(launches):
        raise RuntimeError(f"the trace holds {k['launches']} first_moves "
                           f"launches, the window made {len(launches)}")
    least = sum(bound_seconds(first_moves_bytes(n, m, b, r),
                              first_moves_ops(m, b))
                for n, m, b, r in launches)
    return 100.0 * least / k["seconds"]
