"""Cluster configuration.

A copy of the JAX package's ``utils/config.py``: the same JSON schema
(reference ``example-cluster-conf.json:1-11``), the same validation and
the same canned ``-t`` config, so one conf file drives both packages.

* ``workers``     list of worker identities (ssh hostnames in host mode;
                  with ``partmethod: "tpu"`` only the length counts — one
                  entry per worker, conventionally ``"tpu:<i>"``).
* ``nfs``         shared scratch directory for query files (host mode only).
* ``projectdir``  working dir used after ssh-ing to a worker (host mode only).
* ``partmethod``  ``div | mod | alloc | tpu`` — how nodes map to workers.
* ``partkey``     integer parameter of the partition method (``alloc`` takes a
                  list of range bounds; ``tpu`` ignores it and derives a
                  contiguous chunking from the node count).
* ``outdir``      directory holding the precomputed CPD index.
* ``xy_file``     input graph path.
* ``scenfile``    query scenario path.
* ``diffs``       list of congestion diff files ("-" = free flow).

``partmethod: "tpu"`` keeps its name, because conf files and index
manifests that both packages read carry it; in this package it means the
in-process device path: every worker's rows resident on one card.
``mesh_shape``/``mesh_axes`` are parsed and validated as the JAX package
validates them (:func:`mesh_layout`); ``parallel.mesh.mesh_from_config``
lays the campaign oracle over that ``[D, W]`` grid of devices.
``multihost`` joins several campaign controllers
(``parallel.multihost.initialize_from_conf``).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Sequence

VALID_PARTMETHODS = ("div", "mod", "alloc", "tpu")
#: the JAX package's mesh axis names, as conf files spell them
DATA_AXIS = "data"
WORKER_AXIS = "worker"


@dataclasses.dataclass
class ClusterConfig:
    workers: list[str]
    partmethod: str = "mod"
    partkey: Any = 1
    outdir: str = "./index"
    xy_file: str = ""
    scenfile: str = ""
    diffs: list[str] = dataclasses.field(default_factory=lambda: ["-"])
    nfs: str = "/tmp"
    projectdir: str = "."
    #: R-way shard replication (host/serving modes): replica rank r of
    #: worker w's rows also lives on worker (w + r) % maxworker. 1 = no
    #: replication. ``DOS_REPLICATION`` overrides.
    replication: int = 1
    # in-process extensions (ignored by host mode)
    mesh_shape: Sequence[int] | None = None
    mesh_axes: Sequence[str] | None = None
    # multi-controller settings (parallel.multihost): coordinator,
    # num_processes, optional process_id and cpu_devices_per_process
    multihost: dict | None = None

    @property
    def maxworker(self) -> int:
        return len(self.workers)

    def validate(self) -> "ClusterConfig":
        if not self.workers:
            raise ValueError("cluster config needs at least one worker")
        if self.partmethod not in VALID_PARTMETHODS:
            raise ValueError(
                f"partmethod {self.partmethod!r} not in {VALID_PARTMETHODS}")
        if self.partmethod == "alloc":
            if not isinstance(self.partkey, (list, tuple)):
                raise ValueError("alloc partitioning needs a list partkey")
            if len(self.partkey) != self.maxworker:
                raise ValueError("alloc partkey must have one bound per worker")
        elif self.partmethod in ("div", "mod"):
            if not isinstance(self.partkey, int) or self.partkey <= 0:
                raise ValueError(f"{self.partmethod} needs a positive int partkey")
        if (not isinstance(self.replication, int)
                or not 1 <= self.replication <= self.maxworker):
            raise ValueError(
                f"replication must be an int in [1, maxworker="
                f"{self.maxworker}], got {self.replication!r}")
        return self

    def effective_replication(self) -> int:
        """The conf's replication with the ``DOS_REPLICATION`` env
        override applied (env policy: a malformed or out-of-range value
        degrades to the conf's, never crashes)."""
        from .env import env_cast
        from .log import get_logger

        r = env_cast("DOS_REPLICATION", None, int)
        if r is None:
            return self.replication
        if not 1 <= r <= self.maxworker:
            get_logger(__name__).warning(
                "ignoring DOS_REPLICATION=%d outside [1, maxworker=%d]; "
                "using %d", r, self.maxworker, self.replication)
            return self.replication
        return r

    @property
    def is_tpu(self) -> bool:
        return self.partmethod == "tpu"

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d = {k: v for k, v in d.items() if v is not None}
        if d.get("replication") == 1:
            del d["replication"]      # R=1 confs stay byte-identical
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "ClusterConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known}).validate()

    @classmethod
    def load(cls, path: str) -> "ClusterConfig":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def save(self, path: str) -> None:
        # tmp+fsync+rename: a conf is a durable artifact every worker
        # and campaign reads — never observable torn
        from .atomicio import atomic_write_json
        atomic_write_json(path, self.to_dict())


def mesh_layout(conf: ClusterConfig) -> dict[str, int]:
    """``{"data": D, "worker": W}`` of the conf's mesh, validated as the
    JAX package's ``parallel.mesh.mesh_from_config`` validates it: the
    axes drawn from ``data``/``worker``, as many as ``mesh_shape`` has
    entries, and the worker axis equal to ``maxworker`` (one shard per
    worker). Absent, ``(1, maxworker)``. No devices are involved: the
    port answers every worker on one device whatever ``D`` says."""
    if conf.mesh_shape is None:
        return {DATA_AXIS: 1, WORKER_AXIS: conf.maxworker}
    axes = (list(conf.mesh_axes) if conf.mesh_axes is not None
            else [DATA_AXIS, WORKER_AXIS][-len(conf.mesh_shape):])
    if len(axes) != len(conf.mesh_shape):
        raise ValueError(
            f"mesh_axes {axes} and mesh_shape {list(conf.mesh_shape)} "
            "must have the same length")
    if sorted(axes) != sorted([DATA_AXIS, WORKER_AXIS])[:len(axes)] and \
            axes != [WORKER_AXIS]:
        raise ValueError(
            f"mesh_axes must be drawn from "
            f"['{DATA_AXIS}', '{WORKER_AXIS}'], got {axes}")
    shape = dict(zip(axes, conf.mesh_shape))
    n_workers = shape.get(WORKER_AXIS, conf.maxworker)
    if n_workers != conf.maxworker:
        raise ValueError(
            f"mesh_shape worker axis {n_workers} != maxworker "
            f"{conf.maxworker}; partmethod=tpu requires one mesh shard "
            "per worker")
    return {DATA_AXIS: int(shape.get(DATA_AXIS, 1)), WORKER_AXIS: n_workers}


def test_config(datadir: str = "./data", n_workers: int = 8,
                partmethod: str = "tpu") -> ClusterConfig:
    """Canned smoke-test config.

    Mirrors the reference's ``-t`` mode (``process_query.py:241-256``: 100×
    localhost, mod/100) with the in-process backend by default; the port
    holds every worker on one card, so the CLIs ask for 8 workers, the
    shape of the checked-in ``data/index``.
    """
    if partmethod == "tpu":
        workers = [f"tpu:{i}" for i in range(n_workers)]
        partkey = n_workers
    else:
        workers = ["localhost"] * n_workers
        partkey = n_workers
    return ClusterConfig(
        workers=workers,
        partmethod=partmethod,
        partkey=partkey,
        outdir=os.path.join(datadir, "index"),
        xy_file=os.path.join(datadir, "synth-city.xy"),
        scenfile=os.path.join(datadir, "synth.scen"),
        diffs=[os.path.join(datadir, "synth-city.xy.diff")],
    ).validate()
