"""Device grids and worker lanes.

Port of the JAX package's ``parallel/mesh.py``. There a mesh is a
``jax.sharding.Mesh`` and placement is a ``NamedSharding``; here a mesh
is plain data — a list or a grid of ``torch.device``s — and placement is
an explicit ``.to(device)`` by the code that holds the tensors.

* the campaign grid (:func:`make_mesh`, :func:`mesh_from_config`): a
  ``[D, W]`` numpy array of devices, axes ``(data, worker)``. Worker
  column ``w`` holds worker ``w``'s rows on its devices; data row ``d``
  walks its share of a routed batch (``models.cpd.CPDOracle``);
* the worker-local lane list (:func:`make_worker_mesh`): the devices one
  worker process drives, ``DOS_MESH_DEVICES`` of them. The lanes split
  that worker's walk batches and build chunks (``parallel.sharded``
  ``walk_lanes``, ``build_fm_lanes``; ``worker.engine.ShardEngine``).

A list or a grid may name one device more than once: the CPU is one
torch device, and a machine with one card runs ``[cuda:0] * L``. Lanes or
cells that share a device share one copy of what they read (the graph,
a shard's rows); nothing is copied per lane.

``torch`` is imported by the functions that place devices, not by the
module: a host-backend ``dos-serve`` reads :func:`mesh_devices` for its
``/statusz`` and must not load torch for it.
"""

from __future__ import annotations

import numpy as np

from ..utils.config import DATA_AXIS, WORKER_AXIS, mesh_layout
from ..utils.env import env_cast
from ..utils.log import get_logger

log = get_logger(__name__)

#: the WORKER-LOCAL axis: one worker process driving several devices.
#: Orthogonal to the campaign grid's (data, worker) axes — a lane list
#: never crosses workers, it splits ONE worker's batches and build
#: chunks over the devices that worker owns.
LANE_AXIS = "lane"

#: device slots the CPU stands for when no multi-process run says
#: otherwise (``parallel.multihost.initialize``'s
#: ``cpu_devices_per_process``): as many as the test suite's virtual CPU
#: devices, so a CPU run resolves lane counts the way the JAX package's
#: does there
CPU_DEVICE_SLOTS = 8


def canonical(device) -> torch.device:
    """``device`` as a ``torch.device`` with the index a tensor on it
    reports (``cuda`` → ``cuda:<current>``), so that equal devices
    compare equal."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def local_devices(device=None) -> list[torch.device]:
    """The devices this process may place work on, of ``device``'s type
    (None → ``cuda``; raises without a GPU unless ``device="cpu"``):
    every visible card for ``cuda``, or the CPU once for each of its
    device slots (:data:`CPU_DEVICE_SLOTS`, or what
    ``parallel.multihost.initialize`` set)."""
    import torch

    from ..utils.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    from .multihost import cpu_device_slots

    return [dev] * cpu_device_slots()


def device_pool(n: int, device=None) -> list[torch.device]:
    """``n`` device slots over :func:`local_devices`: the devices dealt
    in contiguous blocks, so one card fills every slot and two cards
    take the first and the second half."""
    devs = local_devices(device)
    return [devs[i * len(devs) // n] for i in range(n)]


def distinct(devices) -> list[torch.device]:
    """The distinct devices of a list or a grid, in first-seen order."""
    out: list[torch.device] = []
    for d in np.asarray(devices, dtype=object).reshape(-1):
        if canonical(d) not in out:
            out.append(canonical(d))
    return out


def make_mesh(n_workers: int | None = None, n_data: int = 1,
              devices=None) -> np.ndarray:
    """A ``(data, worker)`` grid: an object array ``[n_data, n_workers]``
    of ``torch.device``s, the first ``n_data * n_workers`` of ``devices``
    in row-major order (None → :func:`local_devices`). ``n_workers``
    defaults to all devices over ``n_data``. Raises like the JAX
    ``make_mesh`` when there are fewer devices than cells; a caller
    that means to share a device passes it once a cell
    (:func:`device_pool`)."""
    devices = local_devices() if devices is None else list(devices)
    if n_workers is None:
        n_workers = len(devices) // n_data
    need = n_data * n_workers
    if need > len(devices):
        raise ValueError(
            f"mesh ({n_data}x{n_workers}) needs {need} devices, "
            f"have {len(devices)}")
    grid = np.empty(need, dtype=object)
    grid[:] = [canonical(d) for d in devices[:need]]
    return grid.reshape(n_data, n_workers)


def mesh_from_config(conf, devices=None) -> np.ndarray:
    """The campaign grid of a :class:`~..utils.config.ClusterConfig`:
    ``mesh_shape``/``mesh_axes`` validated by ``utils.config.mesh_layout``
    (the JAX rules: axes drawn from ``data``/``worker``, the worker axis
    equal to ``maxworker``), ``(1, maxworker)`` when absent. ``devices``
    (None → :func:`device_pool` over the cards, one slot a cell) fill it
    in row-major order."""
    layout = mesh_layout(conf)
    n_data, n_workers = layout[DATA_AXIS], layout[WORKER_AXIS]
    if devices is None:
        devices = device_pool(n_data * n_workers)
    return make_mesh(n_workers=n_workers, n_data=n_data, devices=devices)


def mesh_devices(avail: int | None = None) -> int:
    """Resolve the ``DOS_MESH_DEVICES`` knob: how many local devices one
    worker drives. 1 (the default — unset, malformed, or non-positive)
    is the single-device engine, byte-identical behavior.

    The resolved count is floored to a power of two (batch pads and
    build chunks are pow2, so only pow2 lane counts split them evenly)
    and clamped to the devices present (``avail``, None → the visible
    cards) — an 8-lane config on a 4-device host degrades with a log
    line, never a crash."""
    n = env_cast("DOS_MESH_DEVICES", 1, int)
    if n <= 1:
        return 1
    if avail is None:
        import torch

        avail = torch.cuda.device_count()
    have = int(avail)
    if n > have:
        log.warning("DOS_MESH_DEVICES=%d but only %d device(s) present; "
                    "clamping", n, have)
        n = have
    floored = 1 << (max(n, 1).bit_length() - 1)
    if floored != n:
        log.warning("DOS_MESH_DEVICES=%d is not a power of two; using "
                    "%d lanes (pow2 splits keep padded batches even)",
                    n, floored)
    return max(floored, 1)


def make_worker_mesh(n_lanes: int | None = None,
                     devices=None) -> list[torch.device] | None:
    """The worker-LOCAL lane list: the first ``n_lanes`` of ``devices``
    (None → :func:`local_devices`). ``n_lanes=None`` resolves
    ``DOS_MESH_DEVICES`` against them; a resolved count of 1 returns
    ``None`` — the single-device path, so callers gate lane execution on
    the return value and an unset knob stays byte-identical."""
    devices = local_devices() if devices is None else list(devices)
    if n_lanes is None:
        n_lanes = mesh_devices(avail=len(devices))
    if n_lanes <= 1:
        return None
    if n_lanes > len(devices):
        raise ValueError(
            f"worker mesh needs {n_lanes} devices, have {len(devices)}")
    return [canonical(d) for d in devices[:n_lanes]]
