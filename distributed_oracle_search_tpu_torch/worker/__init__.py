"""Worker-resident components: the per-shard engine, the per-worker build
CLI (``python -m distributed_oracle_search_tpu_torch.worker.build``), the
resident FIFO query server (``... .worker.server``) and the supervisor
that launches and respawns the servers (``worker.supervisor``)."""

from .engine import ShardEngine, load_shard_rows

__all__ = ["ShardEngine", "load_shard_rows"]
