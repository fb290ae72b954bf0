"""The host's time a build call spends making the graph's CSR and its
breadth-first visit order (the program's ``build.csr`` span,
``obs.trace``, around ``csr_from_ell``), its seconds in the window over
the window's calls: the other host share of the build's idle device
time, beside ``build.step_host_us``.

The span totals are named only where the program keeps them, looked up
among the modules the cell's set-up loaded (nothing is imported here):
a program from before the spans reads None."""

import sys

_TRACE = sys.modules.get("distributed_oracle_search_tpu_torch.obs.trace")

COUNTERS = ({
    "build.csr.seconds": ("obs.trace", "span_seconds", "build.csr"),
} if hasattr(_TRACE, "span_seconds") else {})


def read(run):
    seconds = run["counters"].get("build.csr.seconds", 0)
    calls = run["work"].get("calls", 0)
    if not seconds or not calls:
        return None
    return 1e3 * seconds / calls
