"""K1's device time (``relax_jacobi_kernel`` in the trace) a first-move
row built in the window."""


def read(run):
    k = run["kernels"].get("relax_jacobi_kernel")
    rows = run["work"].get("rows", 0)
    if not k or not rows:
        return None
    return 1e6 * k["seconds"] / rows
