"""K6's gathers a sweep in the window: the in-edge slots whose source's
row K6 read (the program's ``astar_sweep.gathers``, each sweep's count
from the kernel) over the batched search's sweeps (the program's
``astar_batch_np.sweeps``). At most the chunk's cells x the largest
in-degree: the skip leaves the rest. None without K6 (the CPU runs the
plain loop, which has no skip).

The counters are named only where the program has them, looked up among
the modules the cell's set-up loaded (nothing is imported here): a
program from before the counts reads None."""

import sys

_K6 = sys.modules.get("distributed_oracle_search_tpu_torch.ops.cuda_astar")
_LOOP = sys.modules.get(
    "distributed_oracle_search_tpu_torch.ops.batched_astar")

COUNTERS = ({
    "astar_sweep.gathers": ("ops.cuda_astar", "astar_sweep", "gathers"),
    "astar_batch_np.sweeps": ("ops.batched_astar", "astar_batch_np",
                              "sweeps"),
} if hasattr(getattr(_K6, "astar_sweep", None), "gathers")
    and hasattr(getattr(_LOOP, "astar_batch_np", None), "sweeps") else {})


def read(run):
    gathers = run["counters"].get("astar_sweep.gathers", 0)
    sweeps = run["counters"].get("astar_batch_np.sweeps", 0)
    if not gathers or not sweeps:
        return None
    return gathers / sweeps
