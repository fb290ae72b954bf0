"""K6's device time (``sweep_kernel`` in the trace) a gather in the
window (the program's ``astar_sweep.gathers``): the time of K6's unit of
work that depends on the data; the cells' own bytes are in it too.

The counter is named only where the program has it, looked up among the
modules the cell's set-up loaded (nothing is imported here): a program
from before the count reads None, as does a run with no card."""

import sys

_K6 = sys.modules.get("distributed_oracle_search_tpu_torch.ops.cuda_astar")

COUNTERS = ({
    "astar_sweep.gathers": ("ops.cuda_astar", "astar_sweep", "gathers"),
} if hasattr(getattr(_K6, "astar_sweep", None), "gathers") else {})


def read(run):
    k = run["kernels"].get("sweep_kernel")
    gathers = run["counters"].get("astar_sweep.gathers", 0)
    if not k or not gathers:
        return None
    return 1e12 * k["seconds"] / gathers
