"""Multi-process (multi-controller) runs over ``torch.distributed``.

Port of the JAX package's ``parallel/multihost.py``. There every host
runs the same program under ``jax.distributed.initialize`` and the mesh
spans every process's devices; here every process joins one gloo
process group over a TCP rendezvous, holds the workers its block of the
campaign grid names, and the results meet on the host by an all-gather
(:func:`gather_to_host`).

Gloo, not NCCL: every merge the JAX package makes gathers results to the
host (``models/cpd.py`` ``_host``, ``cli/process_query.py`` ``_merge``),
and NCCL refuses two ranks on one card, which is how a machine with one
card runs two controllers.

Cluster-conf integration: a ``multihost`` object in the conf JSON::

    "multihost": {"coordinator": "10.0.0.1:8476",
                  "num_processes": 4}        # process_id from env/flag

Call :func:`initialize_from_conf` before the campaign builds its oracle.
Every process must make the same collective calls in the same order
(the campaign does: its inputs are the same files on every process).
The process group and every barrier carry a timeout (:data:`TIMEOUT`),
so a dead peer fails the run instead of hanging it; the group is
destroyed at exit.
"""

from __future__ import annotations

import atexit
import datetime

import numpy as np
import torch

from ..utils.env import env_str
from ..utils.log import get_logger

log = get_logger(__name__)

#: how long a collective or a barrier waits for its peers: long enough
#: for a peer still building its shards before a barrier
TIMEOUT = datetime.timedelta(seconds=1800)

#: what :func:`initialize` set up in this process: the CPU device slots
#: it stands for (None: ``parallel.mesh.CPU_DEVICE_SLOTS``)
_STATE: dict = {"cpu_slots": None}


def cpu_device_slots() -> int:
    """The device slots the CPU stands for in this process
    (``cpu_devices_per_process`` of :func:`initialize`, else
    ``parallel.mesh.CPU_DEVICE_SLOTS``)."""
    from .mesh import CPU_DEVICE_SLOTS

    slots = _STATE["cpu_slots"]
    return CPU_DEVICE_SLOTS if slots is None else slots


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               cpu_devices_per_process: int | None = None) -> None:
    """Join this process to the run's gloo process group, idempotent.

    ``coordinator``: ``host:port`` of the TCP rendezvous (process 0
    listens there); ``num_processes`` and ``process_id`` the world size
    and this rank. ``cpu_devices_per_process``: on the CPU, the device
    slots this process stands for (``parallel.mesh.local_devices``)."""
    if cpu_devices_per_process is not None:
        _STATE["cpu_slots"] = int(cpu_devices_per_process)
    if _runtime_active():
        return
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError(
            "multihost needs coordinator, num_processes and process_id "
            f"(got {coordinator!r}, {num_processes!r}, {process_id!r}); "
            "process_id may come from $DOS_PROCESS_ID")
    torch.distributed.init_process_group(
        backend="gloo", init_method=f"tcp://{coordinator}",
        world_size=int(num_processes), rank=int(process_id),
        timeout=TIMEOUT)
    atexit.register(shutdown)
    log.info("multihost: process %d/%d up (gloo, rendezvous %s)",
             int(process_id), int(num_processes), coordinator)


def shutdown() -> None:
    """Leave the process group (registered at exit by
    :func:`initialize`); a no-op when none is up."""
    if _runtime_active():
        torch.distributed.destroy_process_group()


def initialize_from_conf(conf) -> bool:
    """Initialize from a ClusterConfig-style object / dict. Returns True
    when multi-process mode was configured. ``process_id`` comes from
    the conf, else ``$DOS_PROCESS_ID``."""
    mh = getattr(conf, "multihost", None)
    if mh is None and isinstance(conf, dict):
        mh = conf.get("multihost")
    if not mh:
        return False
    pid = mh.get("process_id", env_str("DOS_PROCESS_ID"))
    cpus = mh.get("cpu_devices_per_process")
    initialize(coordinator=mh.get("coordinator"),
               num_processes=mh.get("num_processes"),
               process_id=None if pid is None else int(pid),
               cpu_devices_per_process=None if cpus is None else int(cpus))
    return True


def _runtime_active() -> bool:
    return (torch.distributed.is_available()
            and torch.distributed.is_initialized())


def process_info() -> tuple[int, int]:
    """``(process_index, process_count)`` — ``(0, 1)`` on any
    single-controller run."""
    if _runtime_active():
        return (torch.distributed.get_rank(),
                torch.distributed.get_world_size())
    return 0, 1


def barrier(name: str) -> None:
    """Cross-process rendezvous (no-op single-controller): every process
    must reach it before any proceeds — e.g. all block files written
    before one process writes the index manifest. A peer that does not
    arrive within the group's timeout fails it."""
    if _runtime_active():
        log.debug("multihost barrier %s", name)
        torch.distributed.monitored_barrier(timeout=TIMEOUT)


def is_primary() -> bool:
    """True on the process that writes shared artifacts (process 0), and
    on any single-controller run: a run that never configured
    ``multihost`` is always primary (a stray ``$DOS_PROCESS_ID`` in the
    shell must not silently suppress campaign output)."""
    return process_info()[0] == 0


def gather_to_host(x) -> np.ndarray:
    """All-gather a host array over the processes: returns
    ``[process_count, *x.shape]`` numpy on every process (``[1, ...]``
    single-controller). Every process must pass the same shape and
    dtype."""
    a = np.ascontiguousarray(x)
    if not _runtime_active():
        return a[None].copy()
    t = torch.from_numpy(a.view(np.uint8) if a.dtype == np.bool_ else a)
    parts = [torch.empty_like(t)
             for _ in range(torch.distributed.get_world_size())]
    torch.distributed.all_gather(parts, t)
    out = torch.stack(parts).numpy()
    return out.view(np.bool_) if a.dtype == np.bool_ else out
