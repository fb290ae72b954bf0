"""K1's (node, column group) pairs relaxed a K1 step in the window: the
program's ``relax_jacobi.active_pairs`` (added by ``jacobi_dist`` after
each loop) over its K1 steps (``relax_jacobi.launches`` on the card,
``relax_jacobi.plain``, the plain twin's runs, on the CPU). At most N x
the column groups of the build's batch: the settled pairs K1 skipped
are the rest.

The counters are named only where the program has them, looked up among
the modules the cell's set-up loaded (nothing is imported here): a
program from before the count reads None."""

import sys

_BUILD = sys.modules.get(
    "distributed_oracle_search_tpu_torch.ops.cuda_build_kernels")

COUNTERS = ({
    "relax_jacobi.active_pairs": ("ops.cuda_build_kernels", "relax_jacobi",
                                  "active_pairs"),
    "relax_jacobi.launches": ("ops.cuda_build_kernels", "relax_jacobi",
                              "launches"),
    "relax_jacobi.plain": ("ops.cuda_build_kernels", "relax_jacobi",
                           "plain"),
} if hasattr(getattr(_BUILD, "relax_jacobi", None), "active_pairs") else {})


def read(run):
    c = run["counters"]
    pairs = c.get("relax_jacobi.active_pairs", 0)
    steps = c.get("relax_jacobi.launches", 0) + c.get("relax_jacobi.plain", 0)
    if not pairs or not steps:
        return None
    return pairs / steps
