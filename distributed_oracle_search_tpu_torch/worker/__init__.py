"""Worker-resident components: the per-shard engine, the per-worker build
CLI (``python -m distributed_oracle_search_tpu_torch.worker.build``) and
the resident FIFO query server (``... .worker.server``)."""

from .engine import ShardEngine, load_shard_rows

__all__ = ["ShardEngine", "load_shard_rows"]
