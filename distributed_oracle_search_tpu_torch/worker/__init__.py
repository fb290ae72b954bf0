"""Worker-resident components: the per-shard engine and the per-worker
build CLI (``python -m distributed_oracle_search_tpu_torch.worker.build``)."""

from .engine import ShardEngine, load_shard_rows

__all__ = ["ShardEngine", "load_shard_rows"]
