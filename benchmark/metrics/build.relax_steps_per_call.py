"""K1 launches (Jacobi steps; the program's ``relax_jacobi.launches``
counter) a build call of the window."""

COUNTERS = {"relax_jacobi.launches":
            ("ops.cuda_build_kernels", "relax_jacobi", "launches")}


def read(run):
    steps = run["counters"].get("relax_jacobi.launches", 0)
    calls = run["work"].get("calls", 0)
    if not steps or not calls:
        return None
    return steps / calls
