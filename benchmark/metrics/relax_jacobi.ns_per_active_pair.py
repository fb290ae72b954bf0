"""K1's device time (``relax_jacobi_kernel`` in the trace) a (node,
column group) pair it relaxed in the window (the program's
``relax_jacobi.active_pairs``): the time of K1's unit of work, which
the settled pairs it skips do not dilute.

The counter is named only where the program has it, looked up among the
modules the cell's set-up loaded (nothing is imported here): a program
from before the count reads None, as does a run with no card."""

import sys

_BUILD = sys.modules.get(
    "distributed_oracle_search_tpu_torch.ops.cuda_build_kernels")

COUNTERS = ({
    "relax_jacobi.active_pairs": ("ops.cuda_build_kernels", "relax_jacobi",
                                  "active_pairs"),
} if hasattr(getattr(_BUILD, "relax_jacobi", None), "active_pairs") else {})


def read(run):
    k = run["kernels"].get("relax_jacobi_kernel")
    pairs = run["counters"].get("relax_jacobi.active_pairs", 0)
    if not k or not pairs:
        return None
    return 1e9 * k["seconds"] / pairs
