"""distributed_oracle_search_tpu_torch — the PyTorch/CUDA port of the
distributed pathfinding oracle.

Same system as ``distributed_oracle_search_tpu`` (which stays the
reference it is held against), written for one NVIDIA H100: a worker
builds its Compressed Path Database (CPD) shard — the int8 first-move
table ``fm[R, N]`` for the R targets it owns — persists it as
digest-checked blocks, loads it back onto the card, and answers s–t
queries routed to it by target with the table-search walk.

Module paths and names follow the JAX package so each counterpart is
found by name. Plain tensor code is PyTorch; the one TPU kernel of the
JAX package (the fused table-search walk) is a hand-written CUDA kernel
(``csrc/table_search_walk.cu``, wrapped by ``ops.cuda_walk``).

Entry points (``DeviceGraph.from_graph``, ``models.cpd.build_worker_shard``,
``worker.ShardEngine``, ``worker.build``) run on ``cuda`` unless the
caller passes ``device="cpu"``; without a GPU they raise.

Package layout:

``data/``      graph + scenario + diff file formats, synthetic road networks
``parallel/``  partitioning (DistributionController)
``ops/``       device graph, Bellman-Ford build, table-search walk + kernel
``models/``    CPD shard build/persist/load, CPU reference oracle
``transport/`` the engine's runtime-config and stats records
``worker/``    per-shard query engine, per-worker build CLI
``utils/``     logging, env knobs, atomic artifact IO, device + kernel build
``csrc/``      CUDA sources, compiled at first use
"""

__version__ = "0.1.0"
