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

The campaign runs in-process: ``cli.make_cpds`` builds every worker's
rows into one ``[W, R, N]`` table on the card (``models.cpd.CPDOracle``)
and saves the index; ``cli.process_query`` loads it, routes each
scenario's queries to the worker owning their target and answers a
round over all workers in one walk.

Entry points (``DeviceGraph.from_graph``, ``models.cpd.build_worker_shard``,
``models.cpd.CPDOracle``, ``worker.ShardEngine``, ``worker.build``,
``cli.make_cpds``, ``cli.process_query``) run on ``cuda`` unless the
caller passes ``device="cpu"`` (``--device cpu``); without a GPU they
raise.

Package layout:

``data/``      graph + scenario + diff file formats, synthetic road networks
``parallel/``  partitioning (DistributionController), the whole index on
               one device (``sharded``), elastic membership
               (``membership``)
``serving/``   the online frontend (queues, micro-batcher, cache, hedging,
               dispatchers, line-protocol ingress) behind ``cli.serve``
``traffic/``   live congestion diffs (segments, epochs) and the query
               families ``mat``/``alt``/``rev``
``integrity/`` answer fingerprints; ``gateway/`` the worker L2's knobs
``ops/``       device graph, Bellman-Ford build, table-search walk + kernel
``models/``    CPD shard build/persist/load, ``CPDOracle``, CPU reference
``transport/`` the engine's runtime-config and stats records
``worker/``    per-shard query engine, per-worker build CLI
``cli/``       campaign CLIs: ``make_cpds``, ``process_query``,
               ``gen_distribute_conf``; ``serve`` (``dos-serve``)
``utils/``     logging, env knobs, atomic artifact IO, cluster config,
               timers, device + kernel build
``csrc/``      CUDA sources, compiled at first use
"""

__version__ = "0.1.0"
