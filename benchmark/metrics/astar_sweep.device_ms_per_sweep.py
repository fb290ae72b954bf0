"""K6's device time (``sweep_kernel`` in the trace) a sweep of the
window's batches; the sweep count is the search loop's (``sweeps`` of
``astar_batch_np``'s info), the launches that return at once after the
loop's end are in the time."""


def read(run):
    k = run["kernels"].get("sweep_kernel")
    sweeps = run["work"].get("sweeps", 0)
    if not k or not sweeps:
        return None
    return 1e3 * k["seconds"] / sweeps
