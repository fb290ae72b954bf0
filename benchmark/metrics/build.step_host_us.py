"""The host's time a K1 step from one flag read to the next launch: the
program's ``build.step_launch`` spans (``obs.trace``, the flag's reset
and ``relax_jacobi``'s checks and launch), their seconds in the window
over its K1 steps (``relax_jacobi.launches`` on the card,
``relax_jacobi.plain`` on the CPU). Times the steps, it is the host's
share of the build's idle device time.

The span totals are named only where the program keeps them, looked up
among the modules the cell's set-up loaded (nothing is imported here):
a program from before the spans reads None."""

import sys

_TRACE = sys.modules.get("distributed_oracle_search_tpu_torch.obs.trace")

COUNTERS = ({
    "build.step_launch.seconds": ("obs.trace", "span_seconds",
                                  "build.step_launch"),
    "relax_jacobi.launches": ("ops.cuda_build_kernels", "relax_jacobi",
                              "launches"),
    "relax_jacobi.plain": ("ops.cuda_build_kernels", "relax_jacobi",
                           "plain"),
} if hasattr(_TRACE, "span_seconds") else {})


def read(run):
    c = run["counters"]
    seconds = c.get("build.step_launch.seconds", 0)
    steps = c.get("relax_jacobi.launches", 0) + c.get("relax_jacobi.plain", 0)
    if not seconds or not steps:
        return None
    return 1e6 * seconds / steps
