"""Sweeps of the batched A* loop (``astar_batch_np``'s ``sweeps``) a
batch of the window: the batch's deepest search in hops."""


def read(run):
    sweeps = run["work"].get("sweeps", 0)
    batches = run["work"].get("batches", 0)
    if not sweeps or not batches:
        return None
    return sweeps / batches
