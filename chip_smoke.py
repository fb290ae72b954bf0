#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives one worker's main path end to end on the card, through the entry
points a user calls, then the compressed-residency path:

1. print the card (``nvidia-smi``) and build the CUDA kernels from
   ``distributed_oracle_search_tpu_torch/csrc`` with ``nvcc``, one
   ``nvcc`` a source, started together: the walk (raw, pack4 and fused
   multi-diff entries), the build (``cpd_build.cu``: the Jacobi relax,
   the first-move extraction, the grid sweep cycle), the doubling
   kernels (``pointer_doubling.cu``: on chip, and the wide sweep) and
   the batched A* (``batched_astar.cu``: the sweep, the heuristic);
2. road path, at the size of the USA-road-d.NY stand-in
   (``synth_road_network(264_000, seed=0)``, read through DIMACS: written
   as ``.gr``/``.co``, 1-indexed, converted by ``python -m
   distributed_oracle_search_tpu_torch.data.dimacs``, the ``.xy`` byte-equal
   to ``write_xy``'s of the same graph; ``mod`` over 32 workers;
   worker 0 owns 8,250 targets, a 2.18 GB int8 first-move table): build
   worker 0's shard on the card (``build_worker_shard``, 512-row chunks,
   ``method="auto"``, which must resolve ``ellsplit``: the relax and
   extraction kernels) into 9 blocks of 1,024 rows, so the build runs its
   default pipeline (a stager ahead, a flush thread behind; the seconds
   split into the build loop's compute, the flush thread's busy time,
   the stall and the staging, with the peak device memory), plus an
   ``index.json``; load it into a ``ShardEngine``
   and answer three rounds of 20,000 queries — free flow, one congestion
   diff, ``k_moves=8`` with extraction — with the launch counters zeroed
   before the rounds and read after them, and the engine's pair-table
   builds counted (one per weight set, or the smoke fails); hold the raw
   kernel against its plain torch version on each round's exact inputs
   (equal element by element) and time, by CUDA events, the bare launch
   on the engine's pair table (warm, and after an L2 flush; µs a move of
   the longest lane), the wrapper as the engine calls it, the wrapper
   building its own pairs, the pair build and the plain walk; golden
   checks against reverse-Dijkstra and the CPU reference walk; then
   worker 0's free-flow doubling tables (``[road-tables]`` lines) through
   the sharded layer ``CPDOracle.prepare_weights`` calls
   (``build_tables_sharded``, 2,048 rows a call, the oracle's Z-order),
   the wide path by the shape rule (a 264,000-node row is past the
   largest cluster): doubling counts zeroed just before and read just
   after (no on-chip launch, one sweep launch a sweep), prepare seconds
   and peak memory, the ``query_tables_sharded`` answers equal to the
   engine's free-flow walk, and the wide sweep on the first chunk equal
   to the plain sweep, sweep by sweep, timed beside ``torch.gather`` and
   the plain sweep; then ``[delta]``: three epochs on the shard — epoch
   1 slows one entrance edge (x3) of 3 of worker 0's targets that lie on
   no shortest path between their two neighbours, epoch 2 (chained from
   the epoch-1 index) restores them and slows 3 others (diffs built so
   that the splice runs), epoch 3 (chained from epoch 2) slows every
   edge within a radius of a seeded node (x3), the congestion an
   operator sees — each by ``delta_build_index(..., workers=[0])`` on
   the card (K1's affected pass on the transposed graph, then K1/K2 on
   the dirty rows with clean blocks byte-copied: epochs 1 and 2 must
   splice, copy a block and splice a block; epoch 3 must dirty more than
   ``DOS_BUILD_DELTA_MAX_FRAC`` of the shard, its share logged, and
   degrade to the pipelined full build under its epoch) and its
   manifest, then promoted into the road engine (``promote_index``):
   rounds of 20,000 queries naming the epoch's file before and after,
   costs after equal to scipy's Dijkstra on the retimed graph for every
   query to the dirty (epoch 3: the 4 nearest the hotspot) and 4 seeded
   targets and never above the re-priced ones, free flow and a round
   naming the epoch before the one promoted unchanged, epoch 1 refused
   the second time, B1 launched in the promoted rounds; the epoch-2
   index's copied block, spliced block and 512 seeded rows, and 512
   seeded rows of the epoch-3 index, equal to K1/K2 on the retimed
   graph; each delta's seconds split (affected pass, recompute, copies,
   spliced writes) and against the full build
   (``build_delta_vs_full_ratio``, the degraded epoch's apart);
   then hold the relax kernel's loop (the settled-tile skip, as the build runs it)
   against the plain split relaxation on worker 0's first 512 targets
   (after 4 steps, at a mid cut and at convergence, equal element by
   element, with the plain loop's step count) and the extraction kernel
   against the plain extraction (byte-equal); time by CUDA events one
   all-active relax step at each column group width, the nodes in the
   CSR's visit order and by id, beside the dense byte bound; the relax
   loop as the build runs it and with one lever changed at a time (by
   id, one column a lane, no skip) beside its bound (the active pairs'
   bytes and the changed map over every step), with a per-step profile
   of the build's loop (the kernels' share of its time); and an
   extraction beside its byte bound;
2a. streamed path (``[streamed]`` lines), on the road shard's index
   before its directory goes: ``StreamedCPDOracle`` at ``row_chunk``
   4,096 (3 range chunks of 1.08 GB), the road phase's 20,000 queries: a
   cold free-flow round (RLE encode on the host, a sidecar a chunk
   written), a new oracle's cold round (every chunk read from its
   sidecar), a warm diff round (0 bytes streamed), ``query_multi`` at D =
   2, ``query_paths(k=8)`` and ``k_moves=8``, each equal to the road
   engine's resident answers element by element; the launch counts
   zeroed before and read after: B1 once a chunk of each query round, K4
   once a chunk of the fused one, no plain walk; every chunk the cold
   round decoded equal to its raw rows; B1 against the plain walk on the
   first chunk's exact inputs (timed as in step 2); the RLE decode of a
   chunk's sidecar triple and the pack4 decode of 1,024 rows timed by
   CUDA events beside their bound; a synthetic RLE triple of 264,000 x
   8,192 cells (past 2**31) decoded on the card to the columns it
   encodes. Logged: each round's q/s, bytes streamed over raw, the
   codecs that ran, its seconds split (host read, encode, sidecar read
   and write, staging, H2D, decode, walk, drain) and the peak memory;
2a'. worker lanes (``[lanes]`` lines), on the road shard's index: a
   ``ShardEngine`` over ``[cuda:0] * L`` for L = 2 answers the
   road rounds (free flow, the diff, ``k_moves=8`` with extraction) with
   the one-lane engine's answers and paths, one ``table_search_walk``
   launch a lane a call and a lane an ``obs.device`` capture of a new
   program key (counts zeroed before, read after; no plain walk) and the peak device memory of one copy of the rows; each lane's
   launch of the free-flow round against the plain walk on its inputs,
   timed by CUDA events beside the one-lane launch and the lane's
   distinct-sector bound; block 0 built by ``build_fm_lanes`` over 2
   lanes == the road build's block file; a rank-1 replica engine's table
   on lane ``1 % L``;
2b. pipeline (``[pipeline]`` lines): worker 0 of the campaign graph
   (8,192 rows, 8 blocks of 1,024) built under epoch 1 serially and
   pipelined in turns through one compute context, blocks and ledger
   lines byte-equal every time, each timed with its split and peak
   memory; an epoch-1 build rebuilds only a block journaled under
   another epoch, then resumes all; a block write that fails raises,
   leaves no temp file and the blocks before it journaled; beside these
   builds, a ``worker.build`` process of a small index (a 4,096-node
   road network, 2 ``mod`` workers, blocks of 256) under
   ``DOS_FAULTS=crash-build;wid=0;times=1`` exits 86 after its first
   block, and its rerun resumes that block: the blocks and ledger equal
   an uncrashed build's byte for byte, K2 launched for the lost blocks
   only;
3. compressed path (``[compressed]`` lines), on
   ``synth_city_graph(514, 514, seed=0, shortcut_frac=0.0)`` (264,196
   nodes, max out-degree 4, so every slot fits a nibble), ``mod`` over 64
   workers: build worker 0's 4,129 rows on the card with
   ``codec="pack4"`` (``method="auto"`` must resolve ``sweep``: the sweep
   and extraction kernels; the blocks must be pack4 containers); load three
   engines from that one index with ``DOS_CPD_RESIDENT`` raw, pack4 and
   rle (each must keep its codec; a degrade to raw fails); answer the same
   three rounds on each (pack4 and rle answers must equal raw, paths
   included; the pack4 kernel must launch in the free-flow and diff
   rounds, the extract round inflates rows instead); hold the pack4
   kernel against its plain version on those two rounds' exact inputs;
   time ``decompress_rows`` of a batch's distinct rows under pack4 and
   rle; the resident scrubber (``integrity.scrub.scrub_engine_table``)
   on the pack4 and rle engines: a clean pass each, then a pack4 row
   rotted on the card, found by the next pass and re-bound from disk,
   after which the engine's walk equals the raw engine's;
   free-flow costs must equal reverse-Dijkstra; the build's sweep
   launches must be one a chunk (the lattice has no off-lattice edges,
   so a launch runs its chunk's cycles to convergence); hold the sweep
   kernel against the plain sweep on worker 0's first 512 targets (after
   1 and 2 cycles and at convergence, with the plain loop's cycle count)
   and the extraction kernel against the plain extraction, and time one
   cycle for each count of columns a block may own, beside both bounds,
   and the build's one-launch loop, a cycle each; on a 2,800 x 12 lattice
   (rows past a block's shared memory, swept in pieces) ``auto`` must
   resolve ``sweep`` and the sweep must equal the plain loop at
   convergence with its cycle count;
4. campaign path (``[campaign]`` lines), the system's own pipeline on
   a metro-scale road network whose whole index is resident on the card:
   ``synth_road_network(65_536, seed=0)`` written as an ``.xy`` file, a
   20,000-query ``.scen`` (uniform sources and targets over all nodes,
   duplicates and s == t pairs mixed in) and a congestion ``.diff``; a
   conf JSON with ``partmethod "tpu"`` over 8 workers (the fm is int8
   ``[8, 8192, 65536]``, 4 GiB); ``make_cpds.main(["-c", conf])`` builds
   and saves the index, then ``process_query.main`` answers the conf's
   free-flow and diff rounds — fused: ONE launch of the fused multi-diff
   walk kernel over every worker's rows for both — and again with ``-k
   8 --extract`` — one walk kernel launch a round (a budget runs the
   rounds one by one); launch counters zeroed before the campaign and
   read after it, pair tables counted (the ``-k`` oracle's one per
   weight set, the fused oracle's one edge-id table, or the smoke
   fails); checks: the fused rounds' costs, ``plen`` and ``finished``
   equal a direct ``CPDOracle.query`` of each round query by query,
   free-flow costs equal reverse-Dijkstra and every query finishes,
   ``parts.csv``'s per-worker ``plen``/``finished`` sums equal a direct
   ``CPDOracle.query``, ``paths.csv`` equals ``query_paths``, and the
   kernel equals the plain walk on the oracle's routed inputs of the
   free-flow and diff rounds (timed as in step 2); the build
   (``method="auto"`` must resolve ``ellsplit``) and its relax and
   extraction kernels held against their plain versions (the relax
   loop's plain side on the first 2,048 targets) and timed on worker
   0's 8,192 targets, as in step 2;
5. serving path (``[serving]`` lines), the oracle's serving methods on
   the campaign's oracle at full size, with ``DOS_TABLE_BUDGET_GB`` set
   to 60 for the phase (the default 8 refuses the cell's tables):
   ``query`` (free flow, diff; the walk q/s), ``query_multi`` at D = 2
   (free flow, diff) and D = 5 (three more ``synth_diff(frac=0.1)``
   seeds), ``query_mat`` (8 sources x 4,096 targets), ``build(store_dists
   =True)`` (``auto`` must resolve ``ellsplit``) then ``query_dist``,
   ``prepare_weights`` (free flow, diff) then ``query_table``, and
   ``prepare_weights_multi`` at D = 2 then ``query_table_multi``, each
   table freed before the next, host seconds and peak device memory a
   step; counts zeroed before and read after (two fused walk launches,
   one walk launch a query and a mat row, one on-chip doubling launch a
   chunk plus its logged reruns and no wide sweep, 320 / 320 / 640
   sweeps, or the smoke fails). Checks:
   ``query_multi`` equals D single queries, ``query_mat`` equals
   ``query`` on the same pairs, ``query_dist`` equals the free-flow walk
   where finished and reverse-Dijkstra, ``query_table`` equals ``query``
   and ``query_table_multi`` equals ``query_multi``; the fused walk
   kernel equals the plain multi walk on each recorded call and at D =
   8, 9, 16, 17 on the D = 2 call's lanes (timed: bare launch, the
   padded transposed weights' build, the plain walk, D single walk
   launches on the same lanes, the bound from the distinct sectors the
   walk reads);
   K5's on-chip doubling equals ``double_rows`` at sweep caps 1, 2, 3
   and convergence on worker 0's first 2,048 rows (D = 1) and 512 rows
   (D = 5, 7), the tables ``doubled_tables_multi`` builds equal the JAX
   loop on plain sweeps there and on a corrupted copy with a 2-cycle
   and a 3-cycle (max_len 0 and a cut, on chip and on the wide path),
   and ``ops.doubled_tables_multi`` at D = 14 on those 512 rows (a row
   past the largest cluster: the wide path; a comparison, not a launch
   of the main path); timed on the 2,048 rows, all on the same Z-order
   records the kernel doubles: the whole on-chip doubling, the wide
   path's sweeps, the plain ``double_rows``, ``torch.gather`` of each
   sweep's records, and by node id as a side column (the wide sweep
   equal to the plain sweep, sweep by sweep, on both);
   recorded: prepare seconds and sweeps, lookup q/s beside walk q/s and
   the break-even ``prepare / (1/walk_qps - 1/lookup_qps)``;
5b. streamed campaign (``[streamed-campaign]`` lines): ``process_query
   -c conf`` with ``DOS_SERVE_STREAMED=1`` on the campaign's index (5
   compacted chunks at this density): the conf's fused rounds (K4 once a
   chunk; the chunks RLE-encoded on the host), then ``-k 8 --extract``
   under ``DOS_STREAM_RLE=0`` (chunks uploaded raw; B1 once a chunk a
   round); counts
   zeroed before and read after, no plain walk; ``parts.csv`` (every
   column but the timers) and ``paths.csv`` equal the resident
   campaign's;
5b'. multi-controller campaign (``[multihost]`` lines): two
   ``process_query`` controllers spawned as new interpreters
   (``chip_smoke.py --multihost-worker``) on ``cuda:0``, joined by gloo
   through a free port on 127.0.0.1, on the campaign's conf plus a
   ``multihost`` key, ``-k 8 --extract``: resident (each holds and walks
   4 of the 8 workers) and streamed (each streams its own workers'
   range chunks, uploaded raw), the two pairs at once; process 0 alone writes, its
   ``parts.csv`` and ``paths.csv`` equal ``[campaign]``'s and
   ``[streamed-campaign]``'s; each controller reports the card and its
   B1 launches (no plain walk); the streamed controllers' wire bytes sum
   to one controller's under the same knobs; a controller that outlives
   its timeout is killed and the phase fails;
5c. offline (``[offline]`` lines): ``offline.main`` on the campaign's
   ``.xy``/``.scen``/``.diff`` in 4 parts, two rounds, on the card (a
   one-worker 4 GiB table built by K1/K2, ``auto`` must resolve
   ``ellsplit``): each part's size, plen and finished equal the resident
   campaign's answers, B1 once a part and round, no plain walk; then
   ``--local`` through a ``worker.server`` (in a thread, on the index of
   a one-worker conf of a 16,384-node road network, built and saved by
   ``offline.LocalEngine``) on its FIFO: the counts of the in-process
   run on the same files, B1 launched in the server;
6. host path (``[host]`` lines), the reference's own pipeline on the
   campaign's inputs: a second conf, ``partmethod "mod"`` over 8
   ``localhost`` workers (8,192 targets each, a 512 MiB int8 shard, 4 GiB
   over 8 processes); ``make_cpds.main(["-c", conf, "--backend",
   "host", "--chunk", "512"])`` starts one ``worker.build`` process a
   worker on the card, ``make_fifos.launch_servers`` (``make_fifos``'s
   launch, as tracked subprocesses) one resident ``worker.server``
   process a worker, each on a command FIFO under this run's directory;
   every server must answer a ping (``transport.fifo.probe``) within a
   deadline, from the PID it was started as; ``process_query.main``
   answers the free-flow and diff rounds through the command FIFOs, and
   again with ``-k 8 --extract``; every server is stopped by its stop
   token in a ``finally`` and must exit 0 (one left is killed and fails
   the smoke). Checks: every query finishes; each round's ``size``/``plen``/
   ``finished`` sums over ``parts.csv`` equal the campaign's direct
   answers (and its ``-k 8`` rounds'); ``paths.csv`` put in query order
   equals the campaign's row for row; each build's dump shows this card
   and K1/K2 launches, each server's dump this card, device memory
   allocated, raw walk launches > 0 and no plain walk, and the PID that
   answered the pings (``nvidia-smi`` lists the PIDs where the container
   lets it); worker 0's shard loaded here answers worker 0's batch of
   the free-flow, diff and ``k=8`` rounds as its server did, with kernel
   == plain walk on each; worker 0's first 512 targets built here by the
   relax and extraction kernels equal the plain relax loop (after 4
   steps and at convergence) and the plain extraction, and the rows
   worker 0's build process wrote. Recorded: ``make_cpds`` wall time and
   each build's seconds, server launch-to-ready, each round's q/s on the
   host clock beside the campaign's, ``t_search`` per worker row, the
   card's peak used memory over all processes (``nvidia-smi``);
6a. supervise path (``[supervise]`` lines), on ``[host]``'s index (no
   rebuild): ``make_fifos -c conf --supervise --device cuda --obs-port P
   --metrics-dump D`` as a subprocess (its FIFOs and the servers'
   telemetry sidecars, ``DOS_TELEMETRY_INTERVAL_S=1``, in the run's
   directory), the 8 port servers ready by the supervisor's pings; a
   ``process_query --backend host`` round of the 20,000 campaign queries
   whose rows equal ``[host]``'s; worker 3's server SIGKILLed as the
   second round starts: the round either ends degraded (exit 3,
   ``degraded.json`` naming worker 3 alone) or is served after the
   respawn with the first round's rows (logged which); the supervisor
   respawns worker 3 within its first backoff step,
   ``supervisor_respawns_total`` 1 on ``/metrics``; a third round, with
   ``--trace``, served by all 8 equals the first; ``dos-control --once
   --dry-run`` over the FIFO directory ticks with no decision, and each
   server answers its ``transport.fifo.probe``; ``dos-obs top`` renders
   the supervisor's ``/statusz`` (alive 8, respawns 1); SIGINT: the
   supervisor exits 0 and none of its server processes is left; every
   dump (the respawned server's is its own) names this card, B1
   launches == batches + program keys, no plain walk; ``dos-obs
   merge-metrics`` of the 8 dumps sums their B1 launches and ``dos-obs
   merge-traces`` writes the third round's trace as one Perfetto
   document with the 8 live servers' ``worker.search`` spans;
6b. native path (``[native]`` lines): ``make -C native fast`` builds
   the repo's C++ sources (seconds and the host's cores logged); on a
   16,384-node road network ``mod`` over 8 ``localhost`` workers,
   ``make_cpds --engine native`` (``make_cpd_auto``, OpenMP on the host)
   and ``make_cpds --backend host`` (8 ``worker.build`` processes, K1/K2
   on the card) write byte-equal blocks and manifest digests;
   ``make_fifos --engine native`` and a ``process_query --backend host``
   round of 20,000 queries: each worker's row equals the port's
   ``ShardEngine`` walking the native index on the card (B1 == 8
   batches + program keys, no plain walk); an ``--alg ch`` round on
   ``fifo_auto`` finishes every query, and on the queries to 256 seeded
   targets the hierarchy's costs (``ch_check``) and the walk's (scipy's
   Dijkstra) equal Dijkstra's. A cut of the campaign graph: the host
   builder of all 65,536 targets would take minutes;
7. heal path (``[heal]`` lines), verify, heal and replicas on the host
   cell's index at full size (8 blocks of 512 MiB): ``make_cpds
   --verify`` (exit 0, ok == total == 8); the conf rewritten with
   ``replication: 2`` and ``make_cpds --backend host`` run again (every
   build process's dump: its primary resumed, its hosted replica copied,
   no kernel launched; the manifest's 8 ``replica_files`` carry their
   primaries' digests); four faults planted (worker 3's block torn,
   worker 5's deleted, a byte of worker 6's and of
   ``cpd-w00002-r01-b00000.npy`` flipped) that ``--verify`` lists
   exactly, exit 3, as ``--scrub --scrub-passes 1`` does;
   ``anti_entropy`` heals the flipped replica by copy, then worker 5's
   replica, deleted beside its primary, by a recompute on the card
   (K1/K2); ``ShardEngine`` of worker 3 heals its torn block on the card
   (K1/K2, a ``.quarantined`` file left, the crc32 the manifest's,
   ``index.json`` unchanged) and answers worker 3's free-flow, diff and
   ``-k 8 --extract`` batches as its server did (``parts.csv`` sums, the
   campaign's per-query answers, ``paths.csv``), B1 with no plain walk
   and equal to the plain walk on those inputs; ``worker.build
   --adopt-shard 5`` in a process of its own heals worker 5's block (its
   dump: this card, K1/K2 launches, ``reshard_blocks_adopted_total``
   1); worker 6's engine heals its block; on the campaign index,
   ``CPDOracle.load(heal=True)`` with a block torn restores its crc32
   and rows and the campaign's free-flow answers, ``load(heal=False)``
   on a fresh fault (the first block) raises; at the close every
   manifest digest is as before the faults.
   Recorded, beside the card's name and power limit: the verify and
   scrub seconds, the replicated build's wall time, each heal split into
   quarantine, rebuild and reload, the anti-entropy seconds;
7b. RPC path (``[rpc]`` lines), on ``[heal]``'s healed replicated
   index: 8 port ``worker.server`` processes with RPC listeners on Unix
   sockets under the run's directory (``DOS_TRANSPORT=rpc``), each with
   ``--metrics-dump``, worker 5 with ``--obs-port``, worker 3 under
   ``DOS_FAULTS=kill-mid-batch;wid=3;times=1``, every server publishing
   telemetry (``DOS_TELEMETRY_INTERVAL_S=1``); ``process_query
   --backend host`` over RPC (the rounds with ``--trace`` and
   ``--metrics-dump``, then ``-k 8 --extract``). Worker 3 must exit 86;
   ``failover_total`` must count shard 3's 4 batches, each answered by
   worker 4 from its replica; worker 3's breaker open; ``parts.csv`` and
   ``paths.csv`` equal ``[host]``'s; per-query answers of one RPC batch
   a shard equal the campaign's; each dump B1 launches == batches served
   + its ``obs.device`` captures (one launch a program key), no plain
   walk, an ``obs.device`` entry timed by CUDA events; the
   trace holds the servers' ``worker.search`` spans under the head's
   trace ids; ``/metrics`` answers Prometheus text; the other servers
   exit 0 on their token. Before they stop, the epoch leg: the port's
   ``MembershipController`` commits worker 3's leave (shard 3 to worker
   4, ``membership.json`` epoch 1) and one more ``process_query`` run
   over RPC stamps epoch 1 on every batch: the servers refresh, worker 4
   answers shard 3 as its owner, the rows equal ``[host]``'s and
   ``failover_total`` does not grow; an RPC batch with ``answer_fp``
   carries the fingerprint of its answers on the reply header; then
   ``dos-serve --backend host`` under ``DOS_TRANSPORT=rpc``,
   ``DOS_ANSWER_FP=1`` and ``DOS_HEDGE_BUDGET=0.01`` answers 4,096 lines
   from stdin over the live servers: the campaign's answers, 0
   fingerprint mismatches, a hedge issued, exit 0; each live server's
   FIFO sidecar holds its ticks, an RPC connection receives its
   ``telemetry`` frames, and the ``dos-serve``'s ``/statusz`` shows ticks
   of every live server.
   Recorded: RPC beside FIFO round q/s, the failover's seconds, the
   epoch leg's seconds, the phase's wall time;
7c. serve path (``[serve]`` lines), on the same index with the servers
   gone: ``python -m distributed_oracle_search_tpu_torch.cli.serve
   --backend inproc --ingress socket --traffic-dir <run>/traffic
   --obs-port 0 --metrics-dump`` under ``DOS_ANSWER_FP=1``,
   ``DOS_HEDGE_BUDGET=0.01`` and ``DOS_TRAFFIC_SIG_MOVES=16`` (8
   in-process engines on the card, B1; hedges on, a few). Over its Unix
   socket: the campaign's 20,000 queries (their answers equal the campaign's), a zipf repeat pool of
   2,000 (``traffic.scenarios.zipf_queries``, seed 0; its second half's
   repeats from the cache; equal to 8 ``ShardEngine``s loaded here), 64
   each of ``mat`` (k = 8), ``alt`` (k = 3) and ``rev`` (equal to their
   definition computed from those engines' walks); three epochs of
   ``rush_hour_trace`` written into the traffic directory while 512
   requests are in flight (no shed; after each swap 512 answers equal
   the engines' on the fused ``.diff``); two scoped swaps of 64 corridor
   edges (to the peak and back): 256 pairs a few moves long, cached
   before them, come back from the cache re-keyed, and they and 512
   campaign queries equal the engines' on each fused ``.diff``; a
   membership leave of worker 3
   driven from here (``plan_leave``, ``begin``, shard 3's primary block
   corrupted, ``catch_up`` healing it by K1/K2 on the card, ``commit``)
   with shard 3's answers through the window, and theirs and 512
   others after the commit, equal to the static fleet's and
   ``/statusz`` showing epoch 1; SIGTERM, exit 0; its dump names this
   card, B1 launches == the engines' batches + their ``obs.device``
   program keys, no plain walk, hedges issued, scoped invalidations and
   re-keys counted. Logged, not claimed: q/s and p50/p99 on
   the host clock, the cache hit rate, the mean batch fill, the swap and
   catch-up seconds, the peak device memory;
7d. planes (``[planes]`` lines), on the same index: ``dos-serve
   --backend inproc`` with every plane on (``PLANE_ENV``: the resident
   scrubber each second, the audit on every batch, telemetry, one
   latency objective in ``DOS_SLO_SPECS``, the control daemon, the
   flight recorder under ``--recorder-dir``) and ``corrupt-resident``
   armed on shard 5 (row 0 of the primary engine flips after its
   digests verified); 4,000 pairs aimed at shards 5 and 6 (a tenth at
   the rotted row) held against this process's engines, the wrong ones
   before the quarantine counted, not held to 0; then, on ``/statusz``
   and ``/metrics``: the audit's divergence on shard 5, the daemon's
   quarantine and re-admission, the scrubber's corrupt block and
   re-bind; 2,000 more pairs equal to the engines; ``/statusz`` holds
   ``telemetry``, ``slo``, ``control`` and ``integrity``, ``/slo``
   answers 200; SIGTERM, exit 0; the tape holds ``audit_divergence``,
   ``scrub_corrupt``, ``control_divergence_quarantine`` and
   ``control_readmit``; its dump: B1 launches == serve batches +
   program keys + the audit's batches walked by B1, no plain walk;
7e. gateway (``[gateway]`` lines), on the same index: ``cli.gateway``
   process A (``--replicas 2``; ``lease-freeze`` and ``blackhole-conn``
   armed on its frontend 1) and process B (``--join --replicas 1``),
   leased in ``gateway.json``, driven by the port's ``DosClient``: each
   replica warmed by one frame a shard (the load logged apart); the
   blackholed first connection to f1 gives up and resubmits on f0; f1's
   lease expires while it still serves and discovery stops choosing
   it; 8,000 pairs in frames of 250 across the three replicas, a mat,
   alt and rev frame, a repeat from the cache; two raw connections
   past the credit window (only answers and ``busy``); B SIGKILLed
   with frames in flight, its client failing over to f0; every answer
   equal to this process's engines; SIGTERM to A, exit 0, its leases
   gone; its dump: B1 == batches + program keys, no plain walk;
8. reorder path (``[reorder]`` lines): ``cli.reorder.main`` with
   ``--order rcm`` on the campaign's ``.xy``/``.scen``/``.diff``; the
   scenario must come back relabelled; ``auto`` must resolve
   ``frontier`` on the reordered graph; worker 0's first 512 targets
   built by ``auto`` (the plain torch queue on the card, then the
   extraction kernel) and by ``ellsplit`` must give byte-equal fm,
   equal too to the plain extraction of the queue's distances; records
   the queue's pops and ms a pop;
8b. A* path (``[astar]`` lines), no index: ``process_query --alg
   astar`` as a user calls it (its default: the batched search on the
   card, K6, ``csrc/batched_astar.cu``) on the first 4,096 campaign
   queries, free flow and diff, in chunks of 1,024 (the main run: K6's
   counts zeroed before it, read after it, no plain loop or heuristic,
   ``parts.csv`` sums equal the answers, costs equal K1's exact
   distances to every target); ``make_fifos --alg astar`` with 8
   tracked servers and a free-flow ``process_query --backend host``
   round over them (``[astar-host]``: per-query answers equal the
   in-process round's, each dump names the card with K6 launched and no
   plain run, every server exits 0); the heap route
   (``DOS_ASTAR_DEVICE=0``) on the first 4 queries, free flow, its
   costs equal to K6's; then, while 7 spawned reference processes run
   the heap route on the first 128 queries (free flow) and scipy's
   Dijkstra on every query to 256 seeded targets a round and 128 of the
   road chunk: K6 against the plain versions on the campaign's first
   1,024-query chunk at hscale 1 and at hscale 1.5 / fscale 0.1 (the
   heuristic table; g, hops, improved, the flag and the counts after
   sweeps 1-3; at hscale 1 also at convergence: cost, plen, finished,
   the sweep count and the counters) and on a 1,024-query chunk of the
   264,000-node road network (sweeps 1-3; K6's loop to convergence,
   costs equal K1's exact distances); ms a sweep and of the heuristic
   (CUDA events) beside the bound and the plain version; last the
   references' costs against K6's;
9. print the card's name and power limit again on the ``[done]`` line,
   then the kernel table as one JSON line (the raw and pack4 walks, the
   three build kernels, the fused walk, the on-chip doubling, the
   wide doubling sweep, K6's sweep and heuristic, each with
   its launches in the main runs — the wide sweep's in the road shard's
   tables; the raw walk's ``launches_by_path``
   holds the streamed, streamed-campaign, offline and offline-local
   runs', the host servers' launches read from their dumps and the heal
   phase's, the fused walk's the streamed runs' too, the build kernels'
   the offline table's, the build processes', the heal phase's
   (with the adopt process's) and the reorder build's), then, as the
   last line, ``{"ok": true, "device": {...}}``.

Every kernel's launch count is set to 0 at the start of each path and
read at the end of its main run (build, load, rounds), before any
comparison with a plain version; a path whose build kernels did not
launch fails.

Any failed phase exits non-zero. Without a GPU, or without the package
beside this script, it exits non-zero and prints no result. Everything it
writes goes under ``build/`` beside this script and is removed at exit.
"""

from __future__ import annotations

import contextlib
import csv
import dataclasses
import gc
import hashlib
import io
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import socket
import threading
import time
import traceback
import urllib.request

import numpy as np
import torch

from distributed_oracle_search_tpu_torch.cli import (
    make_cpds, make_fifos, process_query,
)
from distributed_oracle_search_tpu_torch.cli import control as control_cli
from distributed_oracle_search_tpu_torch.cli import obs as obs_cli
from distributed_oracle_search_tpu_torch.cli import offline as offline_cli
from distributed_oracle_search_tpu_torch.cli import reorder as reorder_cli
from distributed_oracle_search_tpu_torch.data import (
    Graph, read_diff, read_scen, synth_city_graph, synth_diff,
    synth_road_network, write_diff, write_scen, write_xy,
)
from distributed_oracle_search_tpu_torch.models import (
    cpd, dist_to_target, min_cost_per_unit, table_search_walk,
)
from distributed_oracle_search_tpu_torch.models import streamed
from distributed_oracle_search_tpu_torch.models.cpd import (
    build_worker_shard, read_manifest, write_index_manifest,
)
from distributed_oracle_search_tpu_torch.obs import device as obs_device
from distributed_oracle_search_tpu_torch.obs import metrics as obs_metrics
from distributed_oracle_search_tpu_torch.obs import recorder as obs_recorder
from distributed_oracle_search_tpu_torch.obs import trace as obs_trace
from distributed_oracle_search_tpu_torch.ops import (
    bellman_ford, cuda_build_kernels as cbk, ell_split, frontier_relax,
    grid_sweep,
)
from distributed_oracle_search_tpu_torch.ops.frontier_relax import (
    locality_fraction,
)
from distributed_oracle_search_tpu_torch.ops import batched_astar as ba
from distributed_oracle_search_tpu_torch.ops import cuda_astar as ca
from distributed_oracle_search_tpu_torch.ops import cuda_doubling as cd
from distributed_oracle_search_tpu_torch.ops import cuda_walk as cw
from distributed_oracle_search_tpu_torch.ops import pointer_doubling as pd
from distributed_oracle_search_tpu_torch.ops.device_graph import DeviceGraph
from distributed_oracle_search_tpu_torch.ops.table_search import (
    fm_slot, table_search_batch, table_search_multi, walk_budget, walk_pairs,
    weights_t, weights_width,
)
from distributed_oracle_search_tpu_torch import gateway as gw
from distributed_oracle_search_tpu_torch.gateway import (
    protocol as gw_protocol, registry as gw_registry,
)
from distributed_oracle_search_tpu_torch.gateway.client import (
    pair_rows as gw_pair_rows,
)
from distributed_oracle_search_tpu_torch.integrity import scrub as scrub_mod
from distributed_oracle_search_tpu_torch.integrity.fingerprint import (
    answer_fingerprint,
)
from distributed_oracle_search_tpu_torch.parallel import (
    DistributionController, membership, sharded,
)
from distributed_oracle_search_tpu_torch.testing.faults import KILL_EXIT_CODE
from distributed_oracle_search_tpu_torch.traffic import (
    scenarios, write_segment,
)
from distributed_oracle_search_tpu_torch.transport import RuntimeConfig
from distributed_oracle_search_tpu_torch.transport import fifo as fifo_transport
from distributed_oracle_search_tpu_torch.transport import frames as frames_mod
from distributed_oracle_search_tpu_torch.transport import resilience, rpc
from distributed_oracle_search_tpu_torch.transport.wire import (
    read_results_file, results_file_for,
)
from distributed_oracle_search_tpu_torch.utils import cuda_build, nativebin
from distributed_oracle_search_tpu_torch.utils.atomicio import digest_file
from distributed_oracle_search_tpu_torch.utils.config import ClusterConfig
from distributed_oracle_search_tpu_torch.worker import engine as eng
from distributed_oracle_search_tpu_torch.worker import server as wserver

ROOT = os.path.dirname(os.path.abspath(__file__))
BUILD_FNS = {"relax_jacobi": cbk.relax_jacobi,
             "first_moves": cbk.first_moves,
             "grid_sweep_cycle": cbk.grid_sweep}
SEED = 0
N_NODES = 264_000
GRID_SIDE = 514
MAXWORKER = 32
#: the grid phase's workers: twice the road's, so worker 0 builds 4,129
#: rows (a depth cut: the shard, its three engines' loads and the rle
#: rounds scale with its rows; the row width stays the grid's 264,196)
GRID_MAXWORKER = 64
WID = 0
CHUNK = 512
N_QUERIES = 20_000
N_DUPS = 200
N_SELF = 50
KERNEL_REPS = 20
PLAIN_REPS = 3
#: spin cycles queued ahead of a timed run of bare launches (~10 ms at the
#: H100's 1.98 GHz boost clock), so the card is still busy while the host
#: queues every launch and the events time the kernels back to back
SLEEP_CYCLES = 20_000_000
#: bytes written between cold launches: twice the 50 MB L2
FLUSH_BYTES = 100 << 20
DECOMPRESS_REPS = 1
#: H100 SXM published device-memory rate and non-tensor 32-bit rate
#: (used for the int32 walk arithmetic); the bound is the larger time
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12
SECTOR = 32
ROUND_NAMES = ("free-flow", "diff", "k8-extract")
#: the campaign: a metro-scale road network, every worker's rows resident
CAMPAIGN_NODES = 65_536
CAMPAIGN_WORKERS = 8
CAMPAIGN_K = 8
#: the host phase: the campaign's index partitioned ``mod`` over 8
#: ``localhost`` workers (8,192 targets, a 512 MiB int8 shard each), one
#: build and one server process a worker; a batch's transport timeout,
#: the wait for every server to answer a ping, and for each to exit
HOST_WORKERS = 8
HOST_SEND_TIMEOUT_S = 60
HOST_READY_S = 300
HOST_STOP_S = 60
#: the supervise phase: the worker SIGKILLed as its second round starts,
#: the seconds its respawn may take to answer a ping, the servers'
#: telemetry cadence, and the head's send timeout (a batch whose write
#: to the killed server's FIFO waits it out retries on the respawn's)
SUP_KILLED = 3
SUP_RESPAWN_S = 180
SUP_TELEMETRY_S = "1"
SUP_SEND_TIMEOUT_S = 8
#: ``make_fifos`` whose command FIFOs are ``<argv[1]>/worker<wid>.fifo``
#: (the supervisor names its servers' FIFOs by
#: ``transport.fifo.command_fifo_path``), so the supervised fleet's
#: FIFOs and telemetry sidecars live in this run's directory, not at the
#: fixed ``/tmp`` paths; the rest of argv is ``cli.make_fifos``'s
SUPERVISE_IN_DIR = (
    "import os, sys\n"
    "from distributed_oracle_search_tpu_torch.cli import make_fifos\n"
    "from distributed_oracle_search_tpu_torch.transport import fifo\n"
    "fifo.command_fifo_path = lambda wid: os.path.join(\n"
    "    sys.argv[1], f'worker{wid}.fifo')\n"
    "sys.exit(make_fifos.main(sys.argv[2:]))\n")
#: the native phase: ``mod`` over 8 workers of an ``OFFLINE_LOCAL_NODES``
#: road network (the campaign graph's 65,536 targets would take the host
#: builder minutes), and the seeded targets whose queries hold the
#: hierarchy's and the walk's costs to Dijkstra
NATIVE_WORKERS = 8
NATIVE_GOLDEN_TARGETS = 256
#: the rpc phase: the worker killed mid-batch (its shard's replica is on
#: the next worker) and the worker serving --obs-port
RPC_KILLED = 3
RPC_OBS_WORKER = 5
#: the rpc phase's epoch leg: the lines of its ``dos-serve --backend
#: host`` burst
RPC_BURST = 4_096
#: the servers' telemetry cadence (``DOS_TELEMETRY_INTERVAL_S``)
RPC_TELEMETRY_S = "1"
#: ``dos-serve`` whose worker FIFOs are ``<argv[1]>/rpc-worker<wid>.fifo``
#: (``[rpc]``'s servers), so its sidecar poller reads their
#: ``.telemetry`` files there; the rest of argv is ``cli.serve``'s
SERVE_WITH_FIFOS = (
    "import os, sys\n"
    "from distributed_oracle_search_tpu_torch.cli import serve\n"
    "serve.command_fifo_path = lambda wid: os.path.join(\n"
    "    sys.argv[1], f'rpc-worker{wid}.fifo')\n"
    "sys.exit(serve.main(sys.argv[2:]))\n")
#: the serve phase: the zipf repeat pool, the requests of each family
#: (``mat`` over k targets, ``alt`` with k alternatives, ``rev``), the
#: rush-hour epochs swapped in live, the queries held to the engines
#: after each swap, the worker drained by the membership leave, the
#: frontend's knobs, and the wait for the service to come up
SERVE_ZIPF = 2_000
SERVE_FAMILIES = 64
SERVE_MAT_K = 8
SERVE_ALT_K = 3
SERVE_EPOCHS = 3
SERVE_CHECK = 512
SERVE_LEAVE = 3
SERVE_KNOBS = ("--max-batch", "1024", "--max-wait-ms", "20",
               "--queue-depth", "65536", "--deadline-ms", "120000")
#: path-signature moves a cached entry keeps (``DOS_TRAFFIC_SIG_MOVES``,
#: default 64): every swap of the serve phase's rush-hour trace (5,251
#: corridor edges, past ``DOS_TRAFFIC_SCOPED_MAX`` 4,096) flushes the
#: whole cache, and the pairs its scoped swaps keep walk a few moves, so
#: longer signatures would buy nothing but the extraction scan a batch
SERVE_SIG_MOVES = "16"
#: the scoped swaps: the corridor edges their two segments change (under
#: ``DOS_TRAFFIC_SCOPED_MAX``) and the pairs a few moves long cached
#: before them, whose entries carry whole path signatures
SERVE_SCOPED_EDGES = 64
SERVE_SHORT = 256
#: the hedge-rate budget of ``[serve]`` and ``[rpc]``'s burst
#: (``DOS_HEDGE_BUDGET``, default 0.1): hedges stay on, but past the
#: tracker's grace of 2 a run of ~200 batches hedges about twice more,
#: so the phase pays for a few replica engines' loads and not all 8
SERVE_HEDGE_BUDGET = "0.01"
SERVE_READY_S = 180
#: ``[planes]`` and ``[gateway]``: the shards their pairs aim at (each
#: replica loads an engine, 512 MiB, for every shard its traffic
#: reaches; ``[serve]`` covers all 8), the shard ``corrupt-resident``
#: rots in ``[planes]`` (its chain, 5 then 6, has a clean replica), the
#: share of pairs aimed at the rotted row's node
PLANE_SHARDS = (5, 6)
PLANE_ROT = 5
PLANE_ROT_SHARE = 0.1
PLANE_PAIRS = (4_000, 2_000)
PLANE_HEAL_S = 90
#: every plane on: the scrubber each second, the audit on every batch
#: (its reference lane for batches of up to 8 queries), telemetry twice
#: a second, the control daemon ticking twice a second; hedges off, so
#: the batches walked beyond the frontend's are the audit's
PLANE_ENV = {"DOS_SCRUB_INTERVAL_S": "1", "DOS_AUDIT_RATE": "1000",
             "DOS_AUDIT_MAX_REFERENCE": "8",
             "DOS_TELEMETRY_INTERVAL_S": "0.5", "DOS_CONTROL": "1",
             "DOS_CONTROL_INTERVAL_S": "0.5", "DOS_HEDGE_DISABLE": "1",
             "DOS_ANSWER_FP": "1"}
#: the one latency objective of ``DOS_SLO_SPECS``
PLANE_SLO = {"name": "serve_latency", "kind": "latency",
             "window": "serve_request_seconds", "threshold_s": 0.5,
             "objective": 0.99}
#: no result cache: a wrong answer served before the quarantine must
#: not come back from it after the heal
PLANE_KNOBS = ("--max-batch", "1024", "--max-wait-ms", "20",
               "--queue-depth", "65536", "--deadline-ms", "120000",
               "--cache-bytes", "0")
GATEWAY_PAIRS = 8_000
GATEWAY_FRAME = 250
GATEWAY_BURST_FRAME = 64
GATEWAY_CREDIT = 8
GATEWAY_LEASE_S = 2.0
#: a client's wait for one reply before it gives up on the connection
#: (fails over and resubmits; on the blackholed connection, the short
#: one), and its give-up on a frame
GATEWAY_WAIT_S = 10.0
GATEWAY_HOLE_WAIT_S = 2.0
GATEWAY_GIVE_UP_S = 60.0
GATEWAY_KNOBS = ("--max-batch", "1024", "--max-wait-ms", "20",
                 "--queue-depth", "65536", "--deadline-ms", "120000")
#: process A's faults: frontend 1 stops renewing its lease at its first
#: heartbeat, and its first connection is blackholed
GATEWAY_FAULTS = ("lease-freeze;wid=1;times=1,"
                  "blackhole-conn;wid=1;times=1")
#: the build kind ``method="auto"`` must resolve to on each path
EXPECTED_KIND = {"road": "ellsplit", "grid": "sweep", "campaign": "ellsplit",
                 "serving": "ellsplit", "offline": "ellsplit"}
#: the serving phase, on the campaign's oracle: three more congestion
#: diffs (seeds) for the D = 5 fused walk, 8 mat rows of 4,096 targets,
#: and the device budget it sets for the prepared tables (the fused D = 2
#: tables of the campaign cell take 51.5 GB; the default 8 GB refuses them)
SERVING_DIFF_SEEDS = (3, 4, 5)
#: twelve more diffs for the kernels' wider shapes, compared with their
#: plain versions on the main path's inputs: K4 at D = 8, 9, 16 and 17
#: (one, two, two and four threads a query), K5 at D = 5 and 7 and its
#: wide path at D = 14
WIDE_DIFF_SEEDS = tuple(range(6, 18))
K4_WIDE_DS = (8, 9, 16, 17)
#: a doubled_tables_multi comparison past the largest cluster (not a
#: launch of the main path): a row of 65,536 nodes x 16 fields (4 MiB)
#: takes the wide path
K5_WIDE_D = 14
#: the road shard's doubling tables, rows a call (prepare_weights'
#: chunk): a row of 264,000 nodes x 16 bytes (4.2 MB) is past the
#: largest cluster (3.7 MB), so every chunk takes the wide path
ROAD_TABLE_CHUNK = 2048
#: the sweeps each prepare of the campaign cell runs: 32 chunks of 2,048
#: rows (8 workers x 8,192 targets) x 10 sweeps, 64 chunks of 1,024 for
#: the fused D = 2 prepare; the successors are free-flow moves, so the
#: count is the same under every weight set
EXPECTED_SWEEPS = {"free-flow": 320, "diff": 320, "multi D=2": 640}
#: the sweep caps at which K5's on-chip doubling is held against the
#: plain version (then at convergence), and the cut (max_len) of the
#: cyclic rows' second comparison
K5_CAPS = (1, 2, 3)
K5_CYCLE_CUT = 5
SERVING_MAT_ROWS = 8
SERVING_MAT_TARGETS = 4_096
SERVING_TABLE_BUDGET_GB = 60
#: the doubling sweep's comparison: worker 0's first rows (the oracle's
#: prepare_weights chunk), and a narrower chunk at D = 5 and D = 7 (two
#: and three 16-byte vectors a record)
SWEEP_ROWS = 2048
SWEEP_ROWS_WIDE = 512
#: the cuts at which each build kernel is held against its plain version
#: (Jacobi steps; sweep cycles), before the check at convergence
RELAX_CUT = 4
#: targets of a chunk the plain relax loop runs on (the campaign's chunk
#: of 8,192 is cut to these; the road's 512 run whole)
RELAX_PLAIN_TARGETS = 2048
SWEEP_CUTS = (1, 2)
#: a lattice (width, height) past the row a sweep block holds in shared
#: memory (2,552 cells at one column a block), so the kernel sweeps each
#: row in pieces (two); ``auto`` builds it by sweep. Its batch of
#: targets.
WIDE_GRID = (2800, 12)
WIDE_BATCH = 64
#: the A* phase: the first campaign queries it answers (4 chunks of
#: 1,024, the engines' chunk); the knobs at which K6 is held to the
#: plain versions on a chunk (sweep by sweep at each, to convergence at
#: the first) and the sweep cuts of that comparison; the heap engine's
#: queries through ``process_query`` (heap A* in Python takes tenths of
#: a second a query on this graph) and in the reference processes; the
#: seeded targets whose queries scipy's Dijkstra checks, each campaign
#: round and the road chunk; the reference processes (heap and
#: Dijkstra), which run while the card works
ASTAR_QUERIES = 4_096
ASTAR_CHUNK = 1_024
ASTAR_KNOBS = ((1.0, 0.0), (1.5, 0.1))
ASTAR_CUTS = (1, 2, 3)
ASTAR_HEAP_CLI = 4
ASTAR_HEAP_QUERIES = 128
ASTAR_DIJKSTRA = 256
ASTAR_ROAD_DIJKSTRA = 128
ASTAR_REF_PROCS = 7
#: the three build kernels' entries in the kernel table
# the pipelined build and the delta rebuilds: the road and [pipeline]
# shards' blocks of 1,024 rows (9 and 8 blocks: the build's default
# pipeline has blocks to overlap; the controller's default of 16,384
# rows makes every shard of the smoke one block)
ROAD_BLOCK = 1024
PIPE_KEYS = ("build_compute_seconds", "build_flush_seconds",
             "build_pipeline_stall_seconds", "build_stage_overlap_seconds",
             "build_rows_staged_total")
PIPE_FAULT_BLOCK = 3
#: the crash-build run in [pipeline]: a small road network over 2 ``mod``
#: workers in blocks of CRASH_BLOCK rows (worker 0: 8 blocks), built by
#: ``worker.build`` processes, the first killed after its first block
CRASH_NODES = 4096
CRASH_BLOCK = 256
# a delta epoch slows one entrance edge (x DELTA_MULT) of this many of
# worker 0's targets, each in a block of its own (``detour_targets``)
DELTA_TARGETS = 3
DELTA_MULT = 3
DELTA_CHECK_ROWS = 512
DELTA_DIJKSTRA_TARGETS = 4
# a congestion epoch as operators see it: every edge with both ends
# within radius r of a seeded node slowed x DELTA_MULT, r the distance to
# the HOTSPOT_NODES-th nearest node; it dirties nearly every target, so
# the delta degrades to the pipelined full build under its epoch
HOTSPOT_NODES = 64
#: the streamed phase: the road index streamed in chunks of this many rows
#: (the JAX package's default: one chunk is 1.08 GB of fm)
STREAM_ROW_CHUNK = 4096
#: the decode past 2**31 cells: N_NODES columns of this many rows
C2_ROWS = 8192
#: rows of the chunk whose pack4 decode is timed, and the decodes timed
PACK4_TIME_ROWS = 1024
DECODE_REPS = 5
#: the offline phase: parts of the campaign's queries, and the nodes of
#: the road network its ``--local`` run serves (the one-worker table a
#: server loads: 268 MB, not the campaign's 4 GiB)
OFFLINE_PARTS = 4
OFFLINE_LOCAL_NODES = 16_384
#: the lanes phase: the road engine over [cuda:0] * L for each L (L = 4
#: cut: on one card L lanes cost ~L launches, PERF.md §6), the lane
#: count of the one-block lane build, the replica rank pinned
LANE_COUNTS = (2,)
LANE_BUILD_LANES = 2
LANE_REPLICA = 1
#: the multihost phase: controllers, and the seconds each may run
MULTIHOST_PROCS = 2
MULTIHOST_TIMEOUT_S = 300
#: the multihost phase's streamed plan: range chunks uploaded raw, so
#: the controllers' chunk sets split one controller's exactly and the
#: wire bytes are the rows' (no host encode, no sidecar)
MULTIHOST_STREAM_KNOBS = {"DOS_SERVE_STREAMED": "1",
                          "DOS_STREAM_RANGE_DENSITY": "0.0",
                          "DOS_STREAM_RLE": "0", "DOS_STREAM_PACK4": "0"}

BUILD_KERNELS = {
    "relax_jacobi": "distributed_oracle_search_tpu/ops/ell_split.py:115 "
                    "(XLA relax; also shift_relax.py:76, bellman_ford.py:39)",
    "first_moves": "distributed_oracle_search_tpu/ops/bellman_ford.py:96 "
                   "(XLA first_move_from_dist)",
    "grid_sweep_cycle": "distributed_oracle_search_tpu/ops/grid_sweep.py:215 "
                        "(XLA cycle, four quadrant scans)",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def time_cuda(fn, reps: int) -> float:
    """Mean ms of ``fn()`` over ``reps`` calls, by CUDA events, after
    one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_bare(launch, reps: int) -> float:
    """Mean ms of ``launch()`` (one kernel launch) over ``reps`` launches
    back to back, by CUDA events, after one warm-up launch: a spin kernel
    queued first keeps the card busy while the host queues the launches,
    so host time per launch is hidden and the events time the kernels."""
    launch()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        launch()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_cold(launch, reps: int) -> float:
    """Mean ms of one ``launch()`` after the L2 was overwritten: each
    launch follows a write of ``FLUSH_BYTES`` (which also keeps the card
    busy while the host queues the launch) and is timed by its own pair
    of CUDA events."""
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    launch()
    torch.cuda.synchronize()
    for start, end in pairs:
        flush.zero_()
        start.record()
        launch()
        end.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


def make_queries(targets: np.ndarray, n: int) -> np.ndarray:
    """Uniform sources, targets uniform over ``targets``, with duplicate
    pairs and s == t pairs mixed in."""
    rng = np.random.default_rng(SEED)
    s = rng.integers(0, n, N_QUERIES)
    t = targets[rng.integers(0, len(targets), N_QUERIES)]
    q = np.stack([s, t], axis=1).astype(np.int64)
    dup_to = rng.choice(N_QUERIES, N_DUPS, replace=False)
    q[dup_to] = q[rng.integers(0, N_QUERIES, N_DUPS)]
    self_at = rng.choice(N_QUERIES, N_SELF, replace=False)
    q[self_at, 0] = q[self_at, 1]
    return q


def zero_launches() -> None:
    """Every kernel's launch count to 0: the three walks (raw, pack4,
    fused multi-diff), the on-chip doubling, the doubling sweep, the
    three build kernels and K6 (with the plain A* runs)."""
    cw.cuda_walk_batch.launches = 0
    cw.cuda_walk_batch.launches_pack4 = 0
    cw.cuda_walk_multi.launches = 0
    cd.doubling_rows.launches = 0
    cd.doubling_sweep.launches = 0
    for fn in BUILD_FNS.values():
        fn.launches = 0
    ca.astar_sweep.launches = ca.astar_heuristic.launches = 0
    ca.astar_sweep.dense = 0
    ca.astar_heuristic.plain = ba.astar_batch.plain = 0


def read_build_launches() -> dict[str, int]:
    """Build kernel launches since the last zero_launches()."""
    return {name: fn.launches for name, fn in BUILD_FNS.items()}


def read_launches() -> tuple[int, int]:
    """(raw, pack4) kernel launches since the last zero_launches()."""
    return cw.cuda_walk_batch.launches, cw.cuda_walk_batch.launches_pack4


def rounds_for(g, outdir: str):
    diff_path = os.path.join(outdir, "congestion.diff")
    write_diff(diff_path, *synth_diff(g, frac=0.1, seed=2))
    return diff_path, [
        ("free-flow", RuntimeConfig(), "-"),
        ("diff", RuntimeConfig(), diff_path),
        ("k8-extract", RuntimeConfig(k_moves=8, extract=True), "-")]


def drive_rounds(engine, queries, rounds, tag: str) -> dict:
    """Answer each round twice (warm, then timed on the host clock)
    through ``engine.answer``, recording the walk calls it makes so
    their exact inputs can be replayed; returns per round ``(cost, plen,
    fin, stats, last_paths, last walk call, launches)``, ``launches``
    being the (raw, pack4) kernel launches of that round's two calls.

    The engine builds its walk pair table once per weight set (one per
    diff file); every call into ``walk_pairs`` is counted, and a round
    that builds more than one, or a weight set built twice, fails."""
    captured: list = []
    built: list[str] = []
    real_walk, real_pairs = eng.cuda_walk_batch, eng.walk_pairs
    current = [""]

    def recording_walk(*a, **kw):
        captured.append((a, kw))
        return real_walk(*a, **kw)

    def counting_pairs(*a, **kw):
        built.append(current[0])
        return real_pairs(*a, **kw)

    eng.cuda_walk_batch = recording_walk
    eng.walk_pairs = counting_pairs
    answers = {}
    try:
        for name, cfg, diff in rounds:
            current[0] = diff
            n_built = len(built)
            before = read_launches()
            engine.answer(queries, cfg, diff)              # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cost, plen, fin, stats = engine.answer(queries, cfg, diff)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            after = read_launches()
            answers[name] = (cost, plen, fin, stats, engine.last_paths,
                             captured[-1],
                             (after[0] - before[0], after[1] - before[1]))
            log(f"{tag} {name}: {len(queries)} queries in {dt:.4f} s "
                f"= {len(queries) / dt:.1f} q/s; finished "
                f"{stats.finished}/{stats.n_touched}, sum plen "
                f"{stats.plen}, max plen {int(plen.max())}; pair tables "
                f"built in its two calls: {len(built) - n_built}")
    finally:
        eng.cuda_walk_batch, eng.walk_pairs = real_walk, real_pairs
    if sorted(built) != sorted(set(built)):
        raise AssertionError(f"{tag}: a weight set's pair table was built "
                             f"more than once: {built}")
    log(f"{tag} pair tables built in all rounds: {len(built)}, one per "
        f"weight set ({len(set(d for _, _, d in rounds))} distinct)")
    return answers


def touched_sectors(call, plen_kernel, d: int = 0):
    """Distinct 32-byte sectors of the fm table and of the ``(next, w)``
    pair table that the walk on one recorded call's inputs must read;
    with ``d`` > 0 (the fused walk) also those of the ``[M+1, d]``
    transposed weights, each move reading its edge's row.

    Replays the walk one move at a time: a live lane reads its fm byte
    (birth and after each move, none after its move budget runs out) and
    each move reads one 8-byte ``(next, w)`` pair, counted in the dense
    interleaved ``[N, K, 2]`` layout whatever layout the kernel reads, so
    the bound is the work's and not the layout's. Offsets are global byte
    offsets within each table, so lanes that share a target row, and moves
    to a neighbouring column, share sectors. The replay's ``plen`` must
    equal the kernel's."""
    (dg, fm, t_rows, s, _t, _w), kw = call
    packed4 = bool(kw.get("packed4", False))
    steps, budget = walk_budget(dg.n, int(kw.get("k_moves", -1)),
                                int(kw.get("max_steps", 0)),
                                int(kw.get("unroll", 8)))
    valid = kw["valid"]
    rows = t_rows.long()
    row_base = rows * fm.shape[1]                # 1-byte elements
    x = s.long()
    plen = torch.zeros_like(x)
    live = valid.clone()
    fm_sec, pair_sec, w_sec = [], [], []
    for _ in range(steps):
        if not bool(live.any()):
            break
        col = x >> 1 if packed4 else x
        fm_sec.append(((row_base + col) // SECTOR)[live])
        slot = fm_slot(fm, rows, x, packed4).long()
        can = live & (slot >= 0)
        if budget is not None:
            can &= plen < budget
        slot = slot.clamp_min(0)
        pair_sec.append(((x * dg.k + slot) * 8 // SECTOR)[can])
        if d:
            row = dg.out_eid[x, slot].long() * (4 * d)
            w_sec.append(torch.cat([(row // SECTOR)[can],
                                    ((row + 4 * d - 1) // SECTOR)[can]]))
        x = torch.where(can, dg.out_nbr[x, slot].long(), x)
        plen += can.long()
        live = can if budget is None else can & (plen < budget)
    if not torch.equal(plen[valid], plen_kernel[valid].long()):
        raise AssertionError("sector replay disagrees with the kernel plen")

    def distinct(parts):
        return int(torch.unique(torch.cat(parts)).numel()) if parts else 0

    if d:
        return distinct(fm_sec), distinct(pair_sec), distinct(w_sec)
    return distinct(fm_sec), distinct(pair_sec)


def bare_launch(call):
    """``(launch, outputs)``: a closure that makes the bare kernel launch
    of one recorded call (``cuda_walk.launch_walk``) on the call's own
    pair table into preallocated outputs."""
    (dg, fm, t_rows, s, t, _w), kw = call
    steps, budget = walk_budget(dg.n, int(kw.get("k_moves", -1)),
                                int(kw.get("max_steps", 0)),
                                int(kw.get("unroll", 8)))
    out = (torch.empty_like(s), torch.empty_like(s),
           torch.empty(s.shape[0], dtype=torch.bool, device=s.device))

    def launch():
        cw.launch_walk(fm, dg.n, t_rows, s, t, kw["valid"], kw["pair"],
                       steps, budget, *out, bool(kw.get("packed4", False)))

    return launch, out


def kernel_vs_plain(name: str, call, tag: str) -> dict:
    """Run the kernel and the plain walk on one recorded call's exact
    inputs: equal element by element or raise; time the bare kernel
    launch (``kernel_ms``, on the engine's pair table, warm and after an
    L2 flush), the wrapper as the engine calls it (``call_ms``), the
    wrapper building its own pair table (``rebuild_call_ms``, the call
    before the engine kept its pairs), the pair-table build and the plain
    walk; the bound from this run's data."""
    a, kw = call
    dg, w_query_pad = a[0], a[5]
    own_kw = {k: v for k, v in kw.items() if k != "pair"}
    if kw.get("pair") is None:
        raise AssertionError(f"{name}: the engine passed no pair table")
    valid = kw["valid"]
    ker = cw.cuda_walk_batch(*a, **kw)
    own = cw.cuda_walk_batch(*a, **own_kw)
    plain = table_search_batch(*a, **own_kw)
    launch, out = bare_launch(call)
    launch()
    torch.cuda.synchronize()
    err = 0
    for x, y, z, b, label in zip(ker, plain, own, out,
                                 ("cost", "plen", "fin")):
        for got, what in ((x, "kernel"), (z, "kernel on its own pairs"),
                          (b, "bare launch")):
            if got.dtype != y.dtype or not torch.equal(got, y):
                bad = int((got != y).sum())
                raise AssertionError(f"{name}: {what} {label} differs from "
                                     f"the plain walk on {bad} lanes")
        err = max(err, int((x.long() - y.long()).abs().max())
                  if x.numel() else 0)
    kernel_ms = time_bare(launch, KERNEL_REPS)
    cold_ms = time_cold(launch, KERNEL_REPS)
    call_ms = time_cuda(lambda: cw.cuda_walk_batch(*a, **kw), KERNEL_REPS)
    rebuild_ms = time_cuda(lambda: cw.cuda_walk_batch(*a, **own_kw),
                           KERNEL_REPS)
    pair_ms = time_cuda(lambda: walk_pairs(dg, w_query_pad), KERNEL_REPS)
    plain_ms = time_cuda(lambda: table_search_batch(*a, **kw), PLAIN_REPS)
    q = int(valid.numel())
    sum_plen = int(ker[1][valid].long().sum())
    max_plen = int(ker[1].max()) if q else 0
    n_valid = int(valid.sum())
    # least bytes: each distinct fm and (next, w) pair sector the walk
    # touches, read once; lane inputs (rows, s, t int32 + valid) read
    # once, outputs (cost, plen int32 + fin) written once
    fm_sec, pair_sec = touched_sectors(call, ker[1])
    nbytes = (fm_sec + pair_sec) * SECTOR + q * 13 + q * 9
    # the earlier, looser count: one fm sector per lane's birth and per
    # move, one pair sector per move, as if no sector were ever shared
    per_move_bytes = ((n_valid + sum_plen) * SECTOR + sum_plen * SECTOR
                      + q * 13 + q * 9)
    ops = 6 * sum_plen + 4 * q       # compare/add/select per move
    bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S) * 1e3
    per_move_ms = max(per_move_bytes / HBM_BYTES_PER_S,
                      ops / INT32_OPS_PER_S) * 1e3
    bound_by = ("bytes" if nbytes / HBM_BYTES_PER_S
                >= ops / INT32_OPS_PER_S else "operations")
    us_per_move = kernel_ms * 1e3 / max(max_plen, 1)
    log(f"{tag} {name}: lanes={q} valid={n_valid} sum_plen={sum_plen} "
        f"max_plen={max_plen} kernel {kernel_ms:.4f} ms "
        f"({us_per_move:.4f} us/move; cold {cold_ms:.4f} ms), call "
        f"{call_ms:.4f} ms, call building its own pairs {rebuild_ms:.4f} "
        f"ms, pair build {pair_ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{bound_ms:.5f} ms by {bound_by} ({nbytes} B: {fm_sec} fm + "
        f"{pair_sec} pair sectors; per-move count {per_move_bytes} B = "
        f"{per_move_ms:.5f} ms) — bit-identical")
    return {"round": name, "lanes": q, "valid": n_valid,
            "sum_plen": sum_plen, "max_plen": max_plen, "ms": kernel_ms,
            "kernel_ms": kernel_ms, "cold_kernel_ms": cold_ms,
            "us_per_move": us_per_move, "call_ms": call_ms,
            "rebuild_call_ms": rebuild_ms, "pair_build_ms": pair_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes": nbytes, "fm_sectors": fm_sec, "pair_sectors": pair_sec,
            "bound_ms_per_move": per_move_ms,
            "bytes_per_move": per_move_bytes, "max_abs_err": err}


def headline(main: dict) -> dict:
    """A kernel entry's timing keys, from its free-flow round."""
    keys = ("ms", "kernel_ms", "cold_kernel_ms", "us_per_move", "call_ms",
            "rebuild_call_ms", "pair_build_ms", "plain_ms", "bound_ms",
            "bound_by")
    return {**{k: main[k] for k in keys}, "library_ms": None}


def golden_dijkstra(g, queries, cost, fin, tag: str) -> None:
    """Free-flow costs equal reverse-Dijkstra distances for 4 seeded
    targets; every query of a strongly connected graph finishes."""
    if not fin.all():
        raise AssertionError("free-flow round left queries unfinished on a "
                             "strongly connected graph")
    rng = np.random.default_rng(SEED + 1)
    for tgt in rng.choice(np.unique(queries[:, 1]), 4, replace=False):
        ref = dist_to_target(g, int(tgt))
        sel = queries[:, 1] == tgt
        got, want = cost[sel], ref[queries[sel, 0]]
        if not np.array_equal(got, want):
            raise AssertionError(f"target {tgt}: costs {got} != Dijkstra "
                                 f"{want}")
        log(f"{tag} target {tgt}: {int(sel.sum())} free-flow costs equal "
            "Dijkstra")


def pipeline_split(c0: dict) -> dict:
    """The build pipeline's running sums since the ``cpd.COUNTERS``
    snapshot ``c0``: the build loop's compute, the flush thread's busy
    time, the loop's stall and the staging seconds, the rows staged."""
    return {k: cpd.COUNTERS[k] - c0[k] for k in PIPE_KEYS}


def split_line(split: dict) -> str:
    return (f"main thread compute {split['build_compute_seconds']:.3f} s, "
            f"flush thread busy {split['build_flush_seconds']:.3f} s, "
            f"stall {split['build_pipeline_stall_seconds']:.3f} s, "
            f"staging {split['build_stage_overlap_seconds']:.3f} s, "
            f"{split['build_rows_staged_total']} rows staged")


def build_index(g, dc, outdir: str, tag: str, codec: str | None = None,
                stats: dict | None = None):
    """Worker 0's shard by ``build_worker_shard`` (the pipeline when it
    has more than one block), its seconds split by the pipeline's sums
    and its peak device memory logged (and kept in ``stats``), then its
    manifest."""
    torch.cuda.reset_peak_memory_stats()
    c0 = dict(cpd.COUNTERS)
    t0 = time.perf_counter()
    written = build_worker_shard(g, dc, WID, outdir, chunk=CHUNK,
                                 device="cuda", codec=codec)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    rows = dc.n_owned(WID)
    split = pipeline_split(c0)
    peak = torch.cuda.max_memory_allocated()
    pipelined = cpd.build_pipeline_enabled() and len(written) > 1
    log(f"{tag} rows={rows} chunk={CHUNK} blocks={len(written)} of "
        f"{dc.block_size} rows ({'pipelined' if pipelined else 'serial'})"
        f" seconds={build_s:.3f} rows/s={rows / build_s:.2f} peak device "
        f"memory {peak / 2**30:.2f} GiB")
    log(f"{tag} split: {split_line(split)}")
    if stats is not None:
        stats.update(seconds=build_s, blocks=len(written),
                     pipelined=pipelined, peak_bytes=peak, **split)
    return write_index_manifest(outdir, dc, workers=[WID])


class KindProbe:
    """Records the build kind every ``pick_build_kernel`` call resolves
    (the builds call it through ``models.cpd``), so a path can check
    that ``method="auto"`` picked the kind expected for its graph."""

    def __init__(self):
        self.kinds: list[tuple[int, str, str]] = []
        self._real = cpd.pick_build_kernel

    def _pick(self, graph, method="auto"):
        out = self._real(graph, method)
        self.kinds.append((graph.n, method, out[0]))
        return out

    def __enter__(self):
        cpd.pick_build_kernel = self._pick
        return self

    def __exit__(self, *exc):
        cpd.pick_build_kernel = self._real

    def check(self, path: str, tag: str) -> str:
        want = EXPECTED_KIND[path]
        got = sorted({k for _, _, k in self.kinds})
        log(f"{tag} build kind resolved by method=auto: "
            + ", ".join(f"n={n} {m} -> {k}" for n, m, k in self.kinds))
        if got != [want]:
            raise AssertionError(f"{tag} auto resolved {got}, expected "
                                 f"{want!r}")
        return want


def time_restored(restore, launch, reps: int) -> float:
    """Mean ms of one ``launch()`` on the state ``restore()`` sets up
    (outside the timed span): each launch timed by its own pair of CUDA
    events, after one warm-up."""
    restore()
    launch()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in pairs:
        restore()
        start.record()
        launch()
        end.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """``(ms, "bytes" | "operations")``: the larger of the bytes over the
    memory rate and the int32 operations over the non-tensor rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / INT32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def same_dist(name: str, got_nb: torch.Tensor, want_bn: torch.Tensor,
              tag: str) -> None:
    """A kernel's ``[N, B]`` distances equal the plain ``[B, N]`` ones
    element by element, or raise."""
    if not torch.equal(got_nb.T, want_bn):
        bad = int((got_nb.T != want_bn).sum())
        raise AssertionError(f"{tag} {name}: {bad} distances differ from "
                             "the plain version")


def plain_relax_loop(st, t, cuts) -> tuple[dict, torch.Tensor, int]:
    """The plain split relaxation's JAX loop (``while changed and i <
    limit``) on one chunk, run once: ``({cut: [N, B] distances after
    ``cut`` steps}, converged [N, B] distances, steps)``."""
    args = [torch.as_tensor(a, device=t.device) for a in (
        st.nbr0, st.w0, st.u_ov, st.v_ov, st.w_ov)]
    for i in (0, 2, 3):
        args[i] = args[i].long()
    d = bellman_ford.init_dist(st.n, t)
    changed = bool((d < bellman_ford.TINF).any())
    at, i = {}, 0
    while changed and i < st.n - 1:
        nd = ell_split._split_step(d, *args)
        changed = bool((nd < d).any())
        d = nd
        i += 1
        if i in cuts:
            at[i] = d
    return at, d, i


def relax_loop_ms(csr, t, skip: bool, vec: int) -> dict:
    """One ``jacobi_dist`` loop to convergence timed by CUDA events (the
    host's read of the flag after every step included), with its steps
    and relaxed (node, group) pairs and the loop's byte bound: over
    every step, the active pairs' row segments read from ``d`` and
    written to ``out`` plus the changed map read and written."""
    stats: dict = {}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    _, steps = cbk.jacobi_dist(csr, t, skip=skip, vec=vec, stats=stats)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end)
    b = int(t.shape[0])
    groups = stats["groups"]
    nbytes = stats["active_pairs"] * 8 * b / groups
    if skip:
        nbytes += steps * 2 * groups * csr.n
    return {"skip": skip, "vec": vec, "visit_order": csr.order is not None,
            "steps": steps, "ms": ms,
            "ms_per_step": ms / steps,
            "active_pairs": stats["active_pairs"],
            "active_share": stats["active_pairs"] / (
                steps * stats["pairs_per_step"]),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}


def relax_loop_profile(csr, t) -> dict:
    """The build's loop once more with a CUDA event pair around every
    launch and the active-pair counters summed after it (both queued on
    the stream, no extra sync): the kernels' share of the loop's time
    (the rest is the host reading the flag and queueing the next launch)
    and, by tenths of the steps, the kernel ms a step and the share of
    the pairs relaxed."""
    real = cbk.relax_jacobi
    marks = []

    def timed(*args, **kw):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = real(*args, **kw)
        e1.record()
        marks.append((e0, e1, args[6][:, 0].sum()))
        return out

    # the wrapper counts its own launches (the name the kernel's wrapper
    # increments now resolves to it), apart from the main runs' counts
    timed.launches = 0
    stats: dict = {}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    cbk.relax_jacobi = timed
    try:
        torch.cuda.synchronize()
        start.record()
        cbk.jacobi_dist(csr, t, stats=stats)
        end.record()
        torch.cuda.synchronize()
    finally:
        cbk.relax_jacobi = real
    kernel = np.array([a.elapsed_time(b) for a, b, _ in marks])
    pairs = np.diff([0] + [int(c) for _, _, c in marks]) / stats[
        "pairs_per_step"]
    tenths = np.array_split(np.arange(len(kernel)), 10)
    return {"loop_ms": start.elapsed_time(end),
            "kernel_ms": float(kernel.sum()),
            "kernel_share": float(kernel.sum()) / start.elapsed_time(end),
            "kernel_ms_by_tenth": [float(kernel[i].mean()) for i in tenths],
            "active_share_by_tenth": [float(pairs[i].mean())
                                      for i in tenths]}


def relax_vs_plain(tag: str, dg, csr, st, t) -> tuple[dict, torch.Tensor]:
    """The relax kernel (``jacobi_dist`` over the full out-edge CSR, the
    skip loop as the build runs it) against the plain split relaxation
    on one chunk's first ``RELAX_PLAIN_TARGETS`` targets: after RELAX_CUT
    steps, at a mid cut (half the steps) and at convergence, equal
    element by element and with the plain loop's step count. Timed on
    the whole chunk: one all-active step (no changed map,
    CUDA events, back to back) at each column group width, the nodes in
    the CSR's visit order and by id, beside the dense bound; the whole
    loop to convergence as the build runs it (the skip, the default
    width, the visit order), beside its bound; the plain split step.
    Returns the entry and the converged ``[N, B]`` distances."""
    n, b, m = dg.n, int(t.shape[0]), int(csr.col.numel())
    t0 = time.perf_counter()
    # the plain loop runs on the chunk's first RELAX_PLAIN_TARGETS targets
    tc = t[:RELAX_PLAIN_TARGETS]
    _, steps_c = cbk.jacobi_dist(csr, tc)
    mid = max(steps_c // 2, RELAX_CUT + 1)
    plain_at, plain_conv, plain_steps = plain_relax_loop(
        st, tc, (RELAX_CUT, mid))
    if steps_c != plain_steps:
        raise AssertionError(f"{tag} relax_jacobi: {steps_c} steps to "
                             f"converge, the plain loop {plain_steps}")
    for cut in (RELAX_CUT, mid):
        d_cut, steps_cut = cbk.jacobi_dist(csr, tc, cut)
        if steps_cut != cut:
            raise AssertionError(f"{tag} relax_jacobi: {steps_cut} steps "
                                 f"at cut {cut}")
        same_dist("relax_jacobi", d_cut, plain_at[cut].T, f"{tag} cut {cut}")
    d_conv, _ = cbk.jacobi_dist(csr, tc)
    same_dist("relax_jacobi", d_conv, plain_conv.T, f"{tag} converged")
    del plain_at, plain_conv, d_conv
    d_conv, steps = cbk.jacobi_dist(csr, t)
    d_cut, _ = cbk.jacobi_dist(csr, t, RELAX_CUT)
    torch.cuda.synchronize()
    log(f"{tag} relax_jacobi: B={b} N={n} M={m}: on the first "
        f"{int(tc.shape[0])} targets equal to the plain split relaxation "
        f"after {RELAX_CUT} and {mid} steps and at convergence, {steps_c} "
        f"steps as the plain loop; all {b} converge in {steps} steps "
        f"({time.perf_counter() - t0:.1f} s)")
    default = cbk.relax_vec(b)
    by_id = csr._replace(order=None, span=None)
    vecs = [v for v in cbk.RELAX_VECS if b % v == 0]
    out = torch.empty_like(d_cut)
    flag = torch.zeros(1, dtype=torch.int32, device=d_cut.device)
    step_ms = {(v, ordered): time_bare(lambda v=v, c=c: cbk.relax_jacobi(
        c, d_cut, out, flag, vec=v), KERNEL_REPS)
        for v in vecs for ordered, c in ((True, csr), (False, by_id))}
    nbytes = 2 * n * b * 4 + (n + 1) * 4 + 2 * m * 4
    bound_ms, bound_by = bound(nbytes, 3 * m * b)
    args = [torch.as_tensor(a, device=d_cut.device) for a in (
        st.nbr0, st.w0, st.u_ov, st.v_ov, st.w_ov)]
    for i in (0, 2, 3):
        args[i] = args[i].long()
    plain_ms = time_cuda(lambda: ell_split._split_step(d_cut, *args),
                         PLAIN_REPS)
    log(f"{tag} relax_jacobi all-active step (columns a lane, visit "
        "order | by id): " + ", ".join(
            f"{v}: {step_ms[v, True]:.4f} | {step_ms[v, False]:.4f} ms"
            + (" [default]" if v == default else "") for v in vecs)
        + f"; dense bound {bound_ms:.4f} ms by {bound_by} ({nbytes} B); "
        f"plain split step {plain_ms:.4f} ms")
    # the loop as the build runs it (the loops with one lever changed at
    # a time are recorded in PERF.md and no longer run)
    loops = [relax_loop_ms(csr, t, True, default)]
    for lp in loops:
        if lp["steps"] != steps:
            raise AssertionError(f"{tag} relax loop {lp}: steps != {steps}")
        log(f"{tag} relax_jacobi loop skip={lp['skip']} vec={lp['vec']} "
            f"{'visit order' if lp['visit_order'] else 'by id'}"
            f"{' [default]' if lp is loops[0] else ''}"
            f": {lp['steps']} steps {lp['ms']:.3f} ms ({lp['ms_per_step']:.4f}"
            f" ms a step), active pairs {lp['active_pairs']} "
            f"({100 * lp['active_share']:.2f}%), loop bound "
            f"{lp['bound_ms']:.3f} ms; steps x dense bound "
            f"{steps * bound_ms:.3f} ms")
    main = loops[0]
    prof = relax_loop_profile(csr, t)
    log(f"{tag} relax_jacobi loop profile: kernels {prof['kernel_ms']:.3f} "
        f"of {prof['loop_ms']:.3f} ms ({100 * prof['kernel_share']:.1f}%); "
        "by tenths of the steps, kernel ms a step / pairs relaxed: "
        + ", ".join(f"{k:.4f}/{100 * a:.1f}%" for k, a in zip(
            prof["kernel_ms_by_tenth"], prof["active_share_by_tenth"])))
    log(f"{tag} comparison done in {time.perf_counter() - t0:.1f} s")
    return {"ms": step_ms[default, True], "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
            "batch": b, "vec": default,
            "ms_by_vec": {f"{v} {'visit order' if o else 'by id'}": ms
                          for (v, o), ms in step_ms.items()},
            "steps_to_convergence": steps, "mid_cut": mid,
            "loop_ms": main["ms"], "loop_steps": steps,
            "loop_ms_per_step": main["ms_per_step"],
            "loop_active_pairs": main["active_pairs"],
            "loop_bound_ms": main["bound_ms"],
            "loop_dense_bound_ms": steps * bound_ms, "loops": loops,
            "loop_profile": prof,
            "max_abs_err": 0}, d_conv


def first_moves_vs_plain(tag: str, dg, csr, t, dist_nb) -> dict:
    """The extraction kernel against the plain extraction on the same
    converged distances: byte-equal; timed beside its bound."""
    n, b, m = dg.n, int(t.shape[0]), int(csr.col.numel())
    got = cbk.first_moves(dg, t, dist_nb, csr=csr)
    want = bellman_ford.first_move_from_dist(dg, t, dist_nb.T)
    if not torch.equal(got, want):
        raise AssertionError(f"{tag} first_moves: {int((got != want).sum())}"
                             " bytes differ from the plain extraction")
    del want
    out = torch.empty_like(got)
    ms = time_bare(lambda: cbk.first_moves(dg, t, dist_nb, csr=csr, out=out),
                   KERNEL_REPS)
    plain_ms = time_cuda(lambda: bellman_ford.first_move_from_dist(
        dg, t, dist_nb.T), PLAIN_REPS)
    nbytes = n * b * 4 + (n + 1) * 4 + 2 * m * 4 + b * 4 + b * n
    bound_ms, bound_by = bound(nbytes, 4 * m * b)
    unreach = int((got == -1).sum())
    log(f"{tag} first_moves: B={b}: byte-equal to the plain extraction "
        f"({unreach} cells -1); {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms by {bound_by} ({nbytes} B)")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "bytes": nbytes, "batch": b,
            "max_abs_err": 0}


def plain_sweep_loop(gd, t, cuts) -> tuple[dict, torch.Tensor, int]:
    """The plain sweep's JAX loop (``while changed and i < limit``: four
    quadrant sweeps, then the off-lattice stage) on one chunk, run once:
    ``({cut: [N, B] distances after cut cycles}, converged, cycles)``."""
    d = bellman_ford.init_dist(gd.n, t)
    changed = bool((d < bellman_ford.TINF).any())
    at, i = {}, 0
    while changed and i < gd.n - 1:
        before = d.clone()
        grid_sweep.sweep_quadrants(gd, d)
        d = grid_sweep.off_lattice(gd, d)
        changed = bool((d < before).any())
        i += 1
        if i in cuts:
            at[i] = d.clone()
    return at, d, i


def wide_sweep_vs_plain(tag: str) -> dict:
    """The sweep kernel on the WIDE_GRID lattice (rows swept in pieces)
    against the plain sweep loop at convergence, with its cycle count;
    one cycle timed."""
    g = synth_city_graph(*WIDE_GRID, seed=SEED, shortcut_frac=0.0)
    kind, gg = cpd.pick_build_kernel(g, "auto")
    if kind != "sweep":
        raise AssertionError(f"{tag} auto picked {kind} for the "
                             f"{WIDE_GRID[0]}x{WIDE_GRID[1]} lattice")
    gd = gg.on("cuda")
    t = torch.as_tensor(np.random.default_rng(SEED).integers(
        0, g.n, WIDE_BATCH).astype(np.int32), device="cuda")
    _, want, want_cycles = plain_sweep_loop(gd, t, ())
    got, cycles = cbk.sweep_dist(gd, t)
    same_dist("grid_sweep_cycle", got, want.T,
              f"{tag} {gg.width}x{gg.height} converged")
    if cycles != want_cycles:
        raise AssertionError(f"{tag} grid_sweep_cycle: {cycles} cycles on "
                             f"the wide lattice, the plain loop "
                             f"{want_cycles}")
    d0 = bellman_ford.init_dist(g.n, t)
    d = torch.empty_like(d0)
    flag = torch.zeros(1, dtype=torch.int32, device=d0.device)
    ms = time_restored(lambda: d.copy_(d0),
                       lambda: cbk.grid_sweep(gd, d, flag), KERNEL_REPS // 4)
    log(f"{tag} grid_sweep_cycle on a {gg.width}x{gg.height} lattice "
        f"(rows swept in pieces), B={WIDE_BATCH}: equal to the plain sweep "
        f"at convergence ({cycles} cycles as the plain loop); a cycle "
        f"{ms:.4f} ms")
    return {"wide_grid": list(WIDE_GRID), "wide_batch": WIDE_BATCH,
            "wide_cycles": cycles, "wide_ms": ms}


def sweep_vs_plain(tag: str, gg, t) -> tuple[dict, torch.Tensor]:
    """The sweep kernel (``sweep_dist``, as the build runs it) against the
    plain sweep loop on one chunk: after each of SWEEP_CUTS cycles and at
    convergence, equal element by element, with the plain loop's cycle
    count. Timed: one cycle from the chunk's start (one launch, the two
    layout copies included) for each count of columns a block owns, the
    default marked, beside the one-read-one-write bound and the
    four-sweep bound; the build's loop (one launch running the chunk's
    cycles), a cycle each; the plain cycle. Returns the entry and the
    converged ``[N, B]`` distances."""
    t0 = time.perf_counter()
    gd = gg.on(t.device)
    n, b = gg.n, int(t.shape[0])
    plain_at, plain_conv, plain_cycles = plain_sweep_loop(gd, t, SWEEP_CUTS)
    for cut in SWEEP_CUTS:
        d_cut, cyc = cbk.sweep_dist(gd, t, cut)
        if cyc != min(cut, plain_cycles):
            raise AssertionError(f"{tag} grid_sweep_cycle: {cyc} cycles at "
                                 f"cut {cut}")
        same_dist("grid_sweep_cycle", d_cut, plain_at[cut].T,
                  f"{tag} {cut} cycle(s)")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    d_conv, cycles = cbk.sweep_dist(gd, t)
    torch.cuda.synchronize()
    kernel_s = time.perf_counter() - t1
    same_dist("grid_sweep_cycle", d_conv, plain_conv.T, f"{tag} converged")
    if cycles != plain_cycles:
        raise AssertionError(f"{tag} grid_sweep_cycle: {cycles} cycles to "
                             f"converge, the plain loop {plain_cycles}")
    del plain_at, plain_conv
    d0 = bellman_ford.init_dist(n, t)
    d = torch.empty_like(d0)
    flag = torch.zeros(1, dtype=torch.int32, device=d0.device)
    default = 1      # grid_sweep's columns a block
    by_cols = {}
    for cols in cbk.SWEEP_COLS:
        by_cols[cols] = time_restored(
            lambda: d.copy_(d0),
            lambda: cbk.grid_sweep(gd, d, flag, cols=cols), KERNEL_REPS // 4)
    log(f"{tag} grid_sweep_cycle ms a cycle by columns a block ("
        + ", ".join(f"{c}: {ms:.4f} ms, {b // c} blocks"
                    + (" [default]" if c == default else "")
                    for c, ms in by_cols.items()) + ")")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    _, cyc = cbk.sweep_dist(gd, t)
    end.record()
    torch.cuda.synchronize()
    loop_ms = start.elapsed_time(end)
    if cyc != cycles:
        raise AssertionError(f"{tag} sweep loop: {cyc} cycles, not "
                             f"{cycles}")
    plain_ms = time_restored(lambda: d.copy_(d0),
                             lambda: grid_sweep.sweep_quadrants(gd, d),
                             PLAIN_REPS)
    nbytes = 2 * n * b * 4 + 4 * n * 4
    bound_ms, bound_by = bound(nbytes, 20 * n * b)
    stream_bytes = 4 * 2 * n * b * 4
    stream_ms, _ = bound(stream_bytes, 0)
    ms = by_cols[default]
    log(f"{tag} grid_sweep_cycle: B={b} {gg.height}x{gg.width}: equal to "
        f"the plain sweep after {', '.join(map(str, SWEEP_CUTS))} cycle(s) "
        f"and at convergence ({cycles} cycles as the plain loop; the build's "
        f"loop {kernel_s:.3f} s on the host clock); a cycle {ms:.4f} ms "
        f"({default} column(s) a block), plain cycle {plain_ms:.4f} ms; "
        f"bound {bound_ms:.4f} ms by {bound_by} (d read and written once, "
        f"{nbytes} B), four sweeps streaming d {stream_ms:.4f} ms "
        f"({stream_bytes} B); the loop to convergence (one launch) "
        f"{loop_ms:.3f} ms ({loop_ms / cycles:.4f} ms a cycle)")
    log(f"{tag} comparison done in {time.perf_counter() - t0:.1f} s")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "bytes": nbytes,
            "bound_ms_four_sweeps": stream_ms, "batch": b,
            "cols": default, "ms_by_cols": by_cols,
            "cycles_to_convergence": cycles, "loop_s": kernel_s,
            "loop_ms": loop_ms, "loop_ms_per_cycle": loop_ms / cycles,
            **wide_sweep_vs_plain(tag), "max_abs_err": 0}, d_conv


def build_kernels_vs_plain(tag: str, g, kind: str, st, targets) -> dict:
    """Each build kernel of ``kind``'s path against its plain version on
    one chunk of worker 0's targets (``targets``, numpy int32)."""
    dg = DeviceGraph.from_graph(g, device="cuda")
    csr = cbk.csr_from_ell(dg)
    t = torch.as_tensor(np.asarray(targets, np.int32), device="cuda")
    out = {}
    if kind == "sweep":
        out["grid_sweep_cycle"], dist = sweep_vs_plain(tag, st, t)
    else:
        out["relax_jacobi"], dist = relax_vs_plain(tag, dg, csr, st, t)
    out["first_moves"] = first_moves_vs_plain(tag, dg, csr, t, dist)
    del dist
    gc.collect()
    torch.cuda.empty_cache()
    return out


def build_kernel_entries(by_path: dict[str, dict],
                         launches: dict[str, dict[str, int]]) -> list[dict]:
    """The three build kernels' entries of the kernel table: launches
    summed over the paths' main runs, the headline numbers from the first
    path that compared each kernel, every path's under ``paths``."""
    entries = []
    for name, replaces in BUILD_KERNELS.items():
        per = {p: r[name] for p, r in by_path.items() if name in r}
        head = next(iter(per.values()))
        entries.append({
            "name": name, "route": "cuda",
            "source": "distributed_oracle_search_tpu_torch/csrc/"
                      "cpd_build.cu",
            "replaces": replaces,
            "launches": sum(c[name] for c in launches.values()),
            "launches_by_path": {p: c[name] for p, c in launches.items()},
            "max_abs_err": max(r["max_abs_err"] for r in per.values()),
            **{k: head[k] for k in ("ms", "plain_ms", "bound_ms",
                                    "bound_by")},
            **{k: v for k, v in head.items() if k.startswith("loop_")},
            "library_ms": None, "parity": "bit-identical", "paths": per})
    return entries


def detour_targets(g, dc, rng, k: int, avoid=()) -> tuple[
        np.ndarray, np.ndarray, list[int]]:
    """``k`` of worker 0's targets ``c``, each in a block of its own and
    none in a block of ``avoid``, with two neighbours ``u1``, ``u2`` such
    that ``c`` lies on no shortest ``u1 → u2`` path (``w(u1,c) + w(c,u2)
    > d(u1 → u2)``, a bounded scipy Dijkstra from ``u1``) and the detour
    by ``u2`` beats the entrance ``u1 → c`` tripled (``d(u1 → u2) +
    w(u2,c) < 3 w(u1,c)``): ``(targets, the ids of the entrances u1 → c,
    blocks)``. Raising that entrance's weight then makes exactly row
    ``c`` dirty (the edge lies on no shortest path into another target),
    and changes its first moves."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import dijkstra

    fwd = sp.csr_matrix((g.w.astype(np.float64), (g.src, g.dst)),
                        shape=(g.n, g.n))
    owned = dc.owned(WID)
    rows = np.nonzero(np.diff(g.out_ptr)[owned] == 2)[0]
    nodes, eids, blocks = [], [], []
    for r in rows[rng.permutation(len(rows))]:
        b = int(r // dc.block_size)
        if b in blocks or b in avoid:
            continue
        c = int(owned[r])
        u1, u2 = (int(v) for v in g.dst[g.out_eid[g.out_ptr[c]:
                                                  g.out_ptr[c + 1]]])
        e1, e12, e2 = g.edge_ids(np.array([u1, c, u2]),
                                 np.array([c, u2, c]))
        through = int(g.w[e1]) + int(g.w[e12])
        d12 = dijkstra(fwd, indices=u1, limit=through)[u2]
        if not (d12 < through and d12 + g.w[e2] < DELTA_MULT * g.w[e1]):
            continue
        nodes.append(c)
        eids.append(int(e1))
        blocks.append(b)
        if len(nodes) == k:
            break
    if len(nodes) < k:
        raise AssertionError(f"only {len(nodes)} detour targets in distinct "
                             f"blocks of worker {WID}")
    return np.asarray(nodes, np.int64), np.asarray(eids, np.int64), blocks


class DeltaProbe:
    """Seconds (host clock) of a delta's stages, by wrapping what
    ``models.cpd`` calls: the affected pass, the rows' recompute, the
    byte copies of clean blocks and the spliced blocks' writes; also the
    pipelined builds (``_BackgroundStager`` made) and the affected pass's
    result (``last``)."""

    STAGES = ("delta_affected_targets", "_compute_rows_batched",
              "atomic_copy_file", "atomic_save_npy")
    NAMES = STAGES + ("_BackgroundStager",)

    def __init__(self):
        self.seconds = dict.fromkeys(self.NAMES, 0.0)
        self.calls = dict.fromkeys(self.NAMES, 0)
        self.last: dict = {}
        self._real: dict = {}

    def _wrap(self, name, real):
        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                self.last[name] = out = real(*a, **kw)
                return out
            finally:
                self.seconds[name] += time.perf_counter() - t0
                self.calls[name] += 1
        return timed

    def __enter__(self):
        for name in self.NAMES:
            self._real[name] = getattr(cpd, name)
            setattr(cpd, name, self._wrap(name, self._real[name]))
        return self

    def __exit__(self, *exc):
        for name, real in self._real.items():
            setattr(cpd, name, real)


def delta_epoch(g, dc, old_dir: str, fused: str, epoch: int,
                tag: str, degrade: bool = False) -> dict:
    """One delta epoch of worker 0's shard as the smoke drives every
    single-worker index (``delta_build_index(..., workers=[0])``, then
    ``write_index_manifest(..., workers=[0], extra=...)``, as
    ``build_index`` does for a build); it must splice, copy at least one
    block and splice at least one, or with ``degrade`` dirty more than
    ``DOS_BUILD_DELTA_MAX_FRAC`` of the shard in the affected pass and
    rebuild every row by the pipelined build, each ledger line keyed to
    ``epoch``. Returns its report, seconds and the shard's dirty share."""
    old_man = cpd.read_manifest(old_dir)
    with DeltaProbe() as probe:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = cpd.delta_build_index(g, dc, old_dir, fused, workers=[WID],
                                    chunk=CHUNK, device="cuda")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    write_index_manifest(rep["outdir"], dc,
                         rows_per_worker=old_man["rows_per_worker"],
                         workers=[WID],
                         extra={"diff_epoch": rep["epoch"],
                                "diff_file": os.path.abspath(fused)})
    n_blocks = -(-dc.n_owned(WID) // dc.block_size)
    spliced = n_blocks - rep["blocks_skipped"] - rep["blocks_resumed"]
    affected = probe.last.get("delta_affected_targets")
    share = (None if affected is None
             else float(np.isin(dc.owned(WID), affected).mean()))
    stages = {k: probe.seconds[k] for k in DeltaProbe.STAGES}
    if degrade:
        max_frac = float(os.environ.get("DOS_BUILD_DELTA_MAX_FRAC", 0.75))
        lines = cpd.BuildLedger(rep["outdir"], WID).entries()
        keyed = sum(e.get("epoch") == epoch for e in lines.values())
        if (rep["epoch"] != epoch or not rep["degraded_full"]
                or share is None or share <= max_frac
                or probe.calls["_BackgroundStager"] != 1
                or rep["rows_recomputed"] != dc.n_owned(WID)
                or keyed != n_blocks):
            raise AssertionError(
                f"{tag} epoch {epoch}: expected the affected pass to dirty "
                f"more than {max_frac} of the shard and a pipelined full "
                f"build keyed to the epoch, got {rep}, dirty share {share}, "
                f"{probe.calls['_BackgroundStager']} pipelined builds, "
                f"{keyed} of {n_blocks} ledger lines of epoch {epoch}")
        log(f"{tag} epoch {epoch}: {rep['changed_edges']} changed edges -> "
            f"{rep['affected_rows']} affected rows of {g.n}, dirty share "
            f"of worker {WID}'s targets {share:.6f} > {max_frac}: degraded "
            f"to the pipelined full build, {n_blocks} blocks journaled "
            f"under epoch {epoch}, in {seconds:.3f} s (affected pass "
            f"{stages['delta_affected_targets']:.3f} s) -> {rep['outdir']}")
        return {**rep, "seconds": seconds, "spliced": 0,
                "dirty_share": share, "stages_s": stages}
    if (rep["epoch"] != epoch or rep["degraded_full"]
            or rep["blocks_skipped"] < 1 or spliced < 1):
        raise AssertionError(f"{tag} epoch {epoch}: expected a splice with "
                             f"copies and spliced blocks, got {rep}")
    log(f"{tag} epoch {epoch}: {rep['changed_edges']} changed edges -> "
        f"{rep['affected_rows']} affected rows, dirty share of worker "
        f"{WID}'s targets {share:.6f}, {rep['rows_recomputed']} "
        f"recomputed, {rep['blocks_skipped']} of {n_blocks} blocks copied, "
        f"{spliced} spliced, in {seconds:.3f} s (affected pass "
        f"{stages['delta_affected_targets']:.3f} s, recompute "
        f"{stages['_compute_rows_batched']:.3f} s, copies "
        f"{stages['atomic_copy_file']:.3f} s, spliced writes "
        f"{stages['atomic_save_npy']:.3f} s) -> {rep['outdir']}")
    return {**rep, "seconds": seconds, "spliced": spliced,
            "dirty_share": share, "stages_s": stages}


def radius_hotspot(g, rng) -> tuple[np.ndarray, int, float]:
    """The edges with both ends within radius r of a seeded node ``c``, r
    the distance from ``c`` to its HOTSPOT_NODES-th nearest node:
    ``(edge ids, c, r)``."""
    c = int(rng.integers(g.n))
    d2 = ((g.xs - g.xs[c]).astype(np.float64) ** 2
          + (g.ys - g.ys[c]).astype(np.float64) ** 2)
    r2 = np.partition(d2, HOTSPOT_NODES)[HOTSPOT_NODES]
    inside = d2 <= r2
    return np.nonzero(inside[g.src] & inside[g.dst])[0], c, float(r2 ** 0.5)


def delta_path(g, dc, outdir: str, engine, queries: np.ndarray,
               free_flow: tuple, full_s: float) -> dict:
    """``[delta]``: three diff epochs absorbed into worker 0's road
    shard by delta rebuilds on the card, each promoted into the road
    phase's engine. Epoch 1 (``fused-e000001.diff``) slows one entrance
    edge of DELTA_TARGETS targets (``detour_targets``, x DELTA_MULT);
    epoch 2 (``fused-e000002.diff``, chained from the epoch-1 index)
    restores them (the decrease branch) and slows as many others: diffs
    built so that the splice runs. Epoch 3 (``fused-e000003.diff``,
    chained from the epoch-2 index) is a congestion epoch as operators
    see it, a radius hotspot (``radius_hotspot``, x DELTA_MULT): its
    affected pass dirties nearly every target, so the delta degrades to
    the pipelined full build under epoch 3. Counts are zeroed just
    before and read just after the main run: the three deltas (K1 in the
    affected pass and, with K2, the recompute or the build) and the
    rounds of 20,000 queries around the promotions (B1). Checks: each
    promoted round's costs equal scipy's Dijkstra on the retimed graph
    for every query to the dirty targets (epoch 3: the DELTA_DIJKSTRA_
    TARGETS targets nearest the hotspot) and to DELTA_DIJKSTRA_TARGETS
    seeded ones, and none is above the same query's cost before
    promotion; free flow, and a round naming the epoch before the one
    promoted, are unchanged; promoting epoch 1 again is refused; on the
    epoch-2 index every row of a copied block, of a spliced block and
    DELTA_CHECK_ROWS seeded rows, and on the epoch-3 index as many seeded
    rows, equal the rows K1/K2 compute on the retimed graph."""
    tag = "[delta]"
    rng = np.random.default_rng(SEED + 5)
    ends1, eids1, blocks1 = detour_targets(g, dc, rng, DELTA_TARGETS)
    ends2, eids2, blocks2 = detour_targets(g, dc, rng, DELTA_TARGETS,
                                           avoid=blocks1)
    w1, w2 = g.w.copy(), g.w.copy()
    w1[eids1] *= DELTA_MULT
    w2[eids2] *= DELTA_MULT
    fused1 = os.path.join(outdir, "fused-e000001.diff")
    write_diff(fused1, g.src[eids1], g.dst[eids1], w1[eids1])
    both = np.concatenate([eids1, eids2])
    fused2 = os.path.join(outdir, "fused-e000002.diff")
    write_diff(fused2, g.src[both], g.dst[both], w2[both])
    hot, centre, radius = radius_hotspot(g, np.random.default_rng(SEED + 6))
    w3 = w2.copy()
    w3[hot] *= DELTA_MULT
    third = np.union1d(eids2, hot)
    fused3 = os.path.join(outdir, "fused-e000003.diff")
    write_diff(fused3, g.src[third], g.dst[third], w3[third])
    owned = dc.owned(WID)
    near = owned[np.argsort((g.xs[owned] - g.xs[centre]).astype(np.float64)
                            ** 2 + (g.ys[owned] - g.ys[centre])
                            .astype(np.float64) ** 2)[:DELTA_DIJKSTRA_TARGETS]]
    log(f"{tag} epoch 1 slows one entrance of targets {ends1.tolist()} "
        f"(blocks {blocks1}) x{DELTA_MULT}; epoch 2 restores them and slows "
        f"one entrance of {ends2.tolist()} (blocks {blocks2}); epoch 3 "
        f"slows the {len(hot)} edges within radius {radius:.1f} of node "
        f"{centre} x{DELTA_MULT}")
    cfg = RuntimeConfig()
    rounds: dict[str, dict] = {}

    def round_(name: str, diff: str):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = engine.answer(queries, cfg, difffile=diff)[:3]
        s = time.perf_counter() - t0
        rounds[name] = {"s": s, "qps": len(queries) / s}
        return out

    zero_launches()
    t0 = time.perf_counter()
    rep1 = delta_epoch(g, dc, outdir, fused1, 1, tag)
    pre1 = round_("epoch 1 re-priced", fused1)
    if not engine.promote_index(rep1["outdir"], 1):
        raise AssertionError(f"{tag} epoch 1 did not promote")
    walk0 = cw.cuda_walk_batch.launches
    post1 = round_("epoch 1 promoted", fused1)
    promoted_walks = cw.cuda_walk_batch.launches - walk0
    ff = round_("free flow", "-")
    rep2 = delta_epoch(g, dc, rep1["outdir"], fused2, 2, tag)
    pre2 = round_("epoch 2 re-priced", fused2)
    if not engine.promote_index(rep2["outdir"], 2):
        raise AssertionError(f"{tag} epoch 2 did not promote")
    walk0 = cw.cuda_walk_batch.launches
    post2 = round_("epoch 2 promoted", fused2)
    promoted_walks += cw.cuda_walk_batch.launches - walk0
    old1 = round_("epoch 1 after epoch 2's promotion", fused1)
    if engine.promote_index(rep1["outdir"], 1):
        raise AssertionError(f"{tag} epoch 1 promoted over epoch 2")
    rep3 = delta_epoch(g, dc, rep2["outdir"], fused3, 3, tag, degrade=True)
    pre3 = round_("epoch 3 re-priced", fused3)
    if not engine.promote_index(rep3["outdir"], 3):
        raise AssertionError(f"{tag} epoch 3 did not promote")
    walk0 = cw.cuda_walk_batch.launches
    post3 = round_("epoch 3 promoted", fused3)
    promoted_walks += cw.cuda_walk_batch.launches - walk0
    old2 = round_("epoch 2 after epoch 3's promotion", fused2)
    main_s = time.perf_counter() - t0
    walks = cw.cuda_walk_batch.launches
    build = read_build_launches()
    log(f"{tag} launches in the phase's run: walk {walks} ({promoted_walks} "
        f"in the promoted rounds), build {build}; engine at epoch "
        f"{engine.index_epoch}; re-promoting epoch 1 refused")
    if promoted_walks <= 0 or build["relax_jacobi"] <= 0 \
            or build["first_moves"] <= 0:
        raise AssertionError(f"{tag} B1 or K1/K2 did not launch")
    for name, r in rounds.items():
        log(f"{tag} round {name}: {len(queries)} queries in {r['s']:.3f} s "
            f"= {r['qps']:.1f} q/s")

    # the answers: unchanged where the gate keeps the base table
    for name, got, want in (("free flow", ff, free_flow),
                            ("epoch 1 after epoch 2", old1, pre1),
                            ("epoch 2 after epoch 3", old2, pre2)):
        if not all(np.array_equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"{tag} the {name} round changed")
    improved = {}
    for epoch, post, pre, w, ends in ((1, post1, pre1, w1, ends1),
                                      (2, post2, pre2, w2,
                                       np.concatenate([ends1, ends2])),
                                      (3, post3, pre3, w3, near)):
        if not post[2].all() or (post[0] > pre[0]).any():
            raise AssertionError(f"{tag} epoch {epoch}: promoted costs "
                                 "above the re-priced ones, or unfinished")
        improved[epoch] = int((post[0] < pre[0]).sum())
        seeded = rng.choice(np.unique(queries[:, 1]),
                            DELTA_DIJKSTRA_TARGETS, replace=False)
        sel = np.nonzero(np.isin(queries[:, 1], np.r_[ends, seeded]))[0]
        want = scipy_dijkstra(g, w, queries[sel])
        if not np.array_equal(post[0][sel], want):
            raise AssertionError(f"{tag} epoch {epoch}: promoted costs "
                                 "differ from scipy's Dijkstra")
        log(f"{tag} epoch {epoch} promoted: {len(sel)} costs (every query "
            f"to {len(ends)} {'dirty' if epoch < 3 else 'nearest'} and "
            f"{len(seeded)} seeded targets) equal "
            f"scipy's Dijkstra on the retimed graph; {improved[epoch]} of "
            f"{len(queries)} costs below the re-priced ones, none above")

    # the epoch-1 rows of the slowed targets are new rows
    bs = dc.block_size
    idx1 = np.searchsorted(owned, ends1)

    def rows_of(d, idx):
        return np.stack([np.load(os.path.join(d, cpd.shard_block_name(
            WID, int(i) // bs)), mmap_mode="r")[int(i) % bs] for i in idx])

    moved = int((rows_of(rep1["outdir"], idx1) != rows_of(outdir, idx1))
                .sum())
    if moved == 0:
        raise AssertionError(f"{tag} epoch 1 changed no first move")
    log(f"{tag} epoch 1's spliced rows differ from the base index's in "
        f"{moved} first moves")

    # the epoch-2 and epoch-3 indexes' rows against K1/K2 on the retimed
    # graphs
    copied = next(b for b in range(-(-len(owned) // bs))
                  if b not in blocks1 + blocks2)
    checks = {2: {"copied block": np.arange(copied * bs,
                                            min((copied + 1) * bs,
                                                len(owned))),
                  "spliced block": np.arange(blocks2[0] * bs,
                                             min((blocks2[0] + 1) * bs,
                                                 len(owned)))}}
    for epoch in (2, 3):
        checks.setdefault(epoch, {})["seeded rows"] = np.sort(
            rng.choice(len(owned), DELTA_CHECK_ROWS, replace=False))
    for epoch, rep, w in ((2, rep2, w2), (3, rep3, w3)):
        gw = Graph(g.xs, g.ys, g.src, g.dst, w)
        compute = sharded.chunk_compute(
            DeviceGraph.from_graph(gw, device="cuda"),
            cpd.pick_build_kernel(gw, "auto"))
        for name, idx in checks[epoch].items():
            for lo in range(0, len(idx), CHUNK):
                part = idx[lo:lo + CHUNK]
                t = torch.as_tensor(owned[part].astype(np.int32),
                                    device="cuda")
                if not np.array_equal(compute(t).cpu().numpy(),
                                      rows_of(rep["outdir"], part)):
                    raise AssertionError(f"{tag} epoch {epoch}'s {name} "
                                         "differs from K1/K2 on the "
                                         "retimed graph")
            log(f"{tag} epoch {epoch}'s {name} ({len(idx)} rows) equal "
                "K1/K2 on the retimed graph byte for byte")
        del compute
    delta_s = rep1["seconds"] + rep2["seconds"]
    ratio = [rep1["seconds"] / full_s, rep2["seconds"] / full_s]
    ratio3 = rep3["seconds"] / full_s
    log(f"{tag} build_delta_vs_full_ratio: epoch 1 {ratio[0]:.4f}, epoch 2 "
        f"{ratio[1]:.4f} (deltas {rep1['seconds']:.3f} / "
        f"{rep2['seconds']:.3f} s against the road phase's full build "
        f"{full_s:.3f} s); the degraded epoch 3 {ratio3:.4f} "
        f"({rep3['seconds']:.3f} s, dirty share {rep3['dirty_share']:.6f});"
        f" phase main run {main_s:.3f} s")
    return {"launches": {"walk": walks, **build},
            "walk_promoted": promoted_walks, "first_moves_changed": moved,
            "epochs": [{k: v for k, v in r.items() if k != "outdir"}
                       for r in (rep1, rep2, rep3)],
            "rounds": rounds, "improved": improved,
            "build_delta_vs_full_ratio": ratio, "delta_s": delta_s,
            "hotspot": {"edges": int(len(hot)), "centre": centre,
                        "radius": radius,
                        "dirty_share": rep3["dirty_share"],
                        "seconds": rep3["seconds"],
                        "degraded_vs_full_ratio": ratio3},
            "full_build_s": full_s}


def crash_build_cmd(xy: str, outdir: str, dump: str = "") -> list[str]:
    """``worker.build`` of worker 0 of the crash-build index."""
    cmd = [sys.executable, "-m",
           "distributed_oracle_search_tpu_torch.worker.build", "--input", xy,
           "--partmethod", "mod", "--partkey", "2", "--workerid", "0",
           "--maxworker", "2", "--outdir", outdir, "--block-size",
           str(CRASH_BLOCK), "--chunk", str(CRASH_BLOCK), "--device", "cuda"]
    return cmd + (["--metrics-dump", dump] if dump else [])


class CrashBuild:
    """The ``crash-build`` run beside ``[pipeline]``'s builds: worker 0 of
    a small index built by a ``worker.build`` process under
    ``DOS_FAULTS=crash-build;wid=0;times=1`` (it must exit 86 after its
    first block), then again with no fault, resuming; the blocks and the
    ledger must be byte-equal to an uncrashed build in this process, and
    the rerun's dump must show one block resumed and K2 launched only for
    the blocks that were lost. The processes run while the phase's own
    builds do."""

    def __init__(self, work: str):
        self.dir = os.path.join(work, "crash")
        os.makedirs(self.dir)
        g = synth_road_network(CRASH_NODES, seed=SEED)
        self.xy = os.path.join(self.dir, "crash.xy")
        write_xy(self.xy, g.xs, g.ys, g.src, g.dst, g.w)
        self.g = Graph.from_xy(self.xy)
        self.out = os.path.join(self.dir, "index")
        self.dump = os.path.join(self.dir, "rerun.json")
        env = {**os.environ, "DOS_FAULTS": "crash-build;wid=0;times=1"}
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(crash_build_cmd(self.xy, self.out),
                                     env=env, cwd=ROOT,
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)

    def rerun(self) -> None:
        """Wait for the crashed build, check what it left, start the
        rerun."""
        out, _ = self.proc.communicate(timeout=300)
        self.crash_s = time.perf_counter() - self.t0
        dc = DistributionController("mod", 2, 2, self.g.n,
                                    block_size=CRASH_BLOCK)
        self.names = [cpd.shard_block_name(0, b) for b in range(
            -(-dc.n_owned(0) // CRASH_BLOCK))]
        left = sorted(f for f in os.listdir(self.out) if f.endswith(".npy"))
        journaled = list(cpd.BuildLedger(self.out, 0).entries())
        if (self.proc.returncode != KILL_EXIT_CODE
                or left != self.names[:1] or journaled != self.names[:1]):
            raise AssertionError(f"[pipeline] crash-build: exit "
                                 f"{self.proc.returncode}, blocks {left}, "
                                 f"journaled {journaled}\n{out[-2000:]}")
        self.t1 = time.perf_counter()
        self.proc = subprocess.Popen(
            crash_build_cmd(self.xy, self.out, self.dump), cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def check(self) -> dict:
        """Wait for the rerun; hold its blocks, ledger and launches to an
        uncrashed build of the same worker in this process."""
        out, _ = self.proc.communicate(timeout=300)
        rerun_s = time.perf_counter() - self.t1
        if self.proc.returncode != 0:
            raise AssertionError(f"[pipeline] crash-build rerun: exit "
                                 f"{self.proc.returncode}\n{out[-2000:]}")
        ref = os.path.join(self.dir, "uncrashed")
        dc = DistributionController("mod", 2, 2, self.g.n,
                                    block_size=CRASH_BLOCK)
        k0 = read_build_launches()
        build_worker_shard(self.g, dc, 0, ref, chunk=CRASH_BLOCK,
                           device="cuda")
        k1 = read_build_launches()
        per_block = (k1["first_moves"] - k0["first_moves"]) / len(self.names)

        def files(d):
            return {f: open(os.path.join(d, f), "rb").read()
                    for f in sorted(os.listdir(d))
                    if f.endswith((".npy", ".ledger"))}

        got, want = files(self.out), files(ref)
        with open(self.dump) as f:
            c = json.load(f)["counters"]
        lost = len(self.names) - 1
        if (got != want or len(want) != len(self.names) + 1
                or c["build_blocks_resumed_total"] != 1
                or c["first_moves.launches"] != per_block * lost
                or c["relax_jacobi.launches"] <= 0):
            raise AssertionError(f"[pipeline] crash-build: blocks/ledger "
                                 f"equal {got == want}, rerun counters {c}")
        log(f"[pipeline] crash-build: worker.build under DOS_FAULTS="
            f"crash-build;wid=0;times=1 exited {KILL_EXIT_CODE} after "
            f"block 0 ({self.crash_s:.2f} s), leaving it journaled; the "
            f"rerun ({rerun_s:.2f} s) resumed 1 block and built {lost} "
            f"(K2 {c['first_moves.launches']} launches = {per_block:g} a "
            f"block, K1 {c['relax_jacobi.launches']}); the {len(self.names)}"
            " blocks and the ledger byte-equal to an uncrashed build")
        return {"crash_s": self.crash_s, "rerun_s": rerun_s,
                "rerun_k2": c["first_moves.launches"],
                "rerun_k1": c["relax_jacobi.launches"]}


def pipeline_path(work: str) -> tuple[dict, dict[str, int]]:
    """``[pipeline]``: worker 0 of the campaign graph
    (``synth_road_network(65_536, seed=0)``, ``tpu`` over 8 workers:
    8,192 rows, 8 blocks of ROAD_BLOCK) built on the card under epoch 1
    through one compute context (set up before the runs), serially
    (``DOS_BUILD_PIPELINE=0``) and pipelined in turns (serial, pipelined,
    pipelined, serial): the blocks and ledger lines of every build
    byte-equal, each timed with the pipeline's split and peak memory.
    Then on a pipelined index: a block journaled under another epoch is
    rebuilt alone by an epoch-1 build, a rerun resumes all; a write that
    fails on block PIPE_FAULT_BLOCK raises, leaves no temp file, and
    blocks 0-2 stand journaled. Counts zeroed before, read after."""
    tag = "[pipeline]"
    g = synth_road_network(CAMPAIGN_NODES, seed=SEED)
    dc = DistributionController("tpu", CAMPAIGN_WORKERS, CAMPAIGN_WORKERS,
                                g.n, block_size=ROAD_BLOCK)
    n_blocks = -(-dc.n_owned(WID) // ROAD_BLOCK)
    names = [cpd.shard_block_name(WID, b) for b in range(n_blocks)]
    ctx: dict = {}
    prior = os.environ.get("DOS_BUILD_PIPELINE")

    def files(d):
        return {f: open(os.path.join(d, f), "rb").read()
                for f in sorted(os.listdir(d))}

    def build(d, pipe: str, **kw):
        os.environ["DOS_BUILD_PIPELINE"] = pipe
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        c0 = dict(cpd.COUNTERS)
        t0 = time.perf_counter()
        written = build_worker_shard(g, dc, WID, d, chunk=CHUNK,
                                     device="cuda", ctx=ctx, **kw)
        torch.cuda.synchronize()
        return written, {"s": time.perf_counter() - t0,
                         "peak_bytes": torch.cuda.max_memory_allocated(),
                         **pipeline_split(c0)}

    # the compute setup (graph upload, kind, CSR) once, outside the runs
    cpd._compute_ctx(ctx, g, "auto", 0, torch.device("cuda"))
    zero_launches()
    crash = CrashBuild(work)
    runs = []
    ref = pipe_dir = None
    try:
        for i, pipe in enumerate(("0", "1", "1", "0")):
            d = os.path.join(work, f"run{i}")
            written, stats = build(d, pipe, epoch=1)
            got = files(d)
            ref = got if ref is None else ref
            if written != names or got != ref:
                raise AssertionError(f"{tag} run {i} (pipeline {pipe}): "
                                     "blocks or ledger differ from run 0's")
            runs.append({"pipelined": pipe == "1", **stats})
            log(f"{tag} run {i} {'pipelined' if pipe == '1' else 'serial'}"
                f": {stats['s']:.3f} s, peak device memory "
                f"{stats['peak_bytes'] / 2**30:.2f} GiB; {split_line(stats)}"
                "; blocks and ledger byte-equal to run 0's")
            if pipe == "1" and pipe_dir is None:
                pipe_dir = d            # kept for the epoch checks
            else:
                shutil.rmtree(d)
            if i == 1:
                crash.rerun()
        # epoch keys on a pipelined index journaled under epoch 1
        ledger = cpd.BuildLedger(pipe_dir, WID)
        ent = dict(ledger.entries()[names[PIPE_FAULT_BLOCK]])
        ledger.record(ent["file"], ent["digest"], ent["shape"], ent["dtype"],
                      epoch=2)
        written, _ = build(pipe_dir, "1", epoch=1)
        if written != [names[PIPE_FAULT_BLOCK]]:
            raise AssertionError(f"{tag} block journaled under epoch 2: an "
                                 f"epoch-1 resume rebuilt {written}")
        r0 = cpd.COUNTERS["build_blocks_resumed_total"]
        written, _ = build(pipe_dir, "1", epoch=1)
        resumed = cpd.COUNTERS["build_blocks_resumed_total"] - r0
        if written or resumed != n_blocks:
            raise AssertionError(f"{tag} an epoch-1 rerun rebuilt {written}, "
                                 f"resumed {resumed}")
        if {f: b for f, b in files(pipe_dir).items() if f in names} != {
                f: b for f, b in ref.items() if f in names}:
            raise AssertionError(f"{tag} the epoch builds changed a block")
        log(f"{tag} epoch keys: an epoch-1 build rebuilt only the block "
            f"journaled under epoch 2 ({names[PIPE_FAULT_BLOCK]}), then "
            "resumed every block; the blocks are run 0's")
        # a write failing on one block
        real = cpd.AtomicNpyWriter.commit
        fault = names[PIPE_FAULT_BLOCK]

        def commit(self, arr):
            if self.path.endswith(fault):
                raise OSError(f"planted write fault on {fault}")
            return real(self, arr)

        fault_dir = os.path.join(work, "fault")
        cpd.AtomicNpyWriter.commit = commit
        try:
            build(fault_dir, "1")
        except OSError as e:
            log(f"{tag} the pipelined build raised: {e}")
        else:
            raise AssertionError(f"{tag} a failed block write did not raise")
        finally:
            cpd.AtomicNpyWriter.commit = real
        left = sorted(os.listdir(fault_dir))
        stand = names[:PIPE_FAULT_BLOCK]
        journaled = list(cpd.BuildLedger(fault_dir, WID).entries())
        if ([f for f in left if f.endswith(".npy")] != stand
                or journaled != stand
                or any(".tmp" in f for f in left)):
            raise AssertionError(f"{tag} after the fault: {left}, "
                                 f"journaled {journaled}")
        log(f"{tag} no temp file left; blocks {stand} stand, journaled in "
            "order")
        crash_run = crash.check()
    finally:
        if prior is None:
            os.environ.pop("DOS_BUILD_PIPELINE", None)
        else:
            os.environ["DOS_BUILD_PIPELINE"] = prior
    launches = read_build_launches()
    mean = {p: float(np.mean([r["s"] for r in runs if r["pipelined"] == p]))
            for p in (False, True)}
    log(f"{tag} build seconds, serial / pipelined (2 runs each, in turns): "
        f"{mean[False]:.3f} / {mean[True]:.3f} = "
        f"{mean[False] / mean[True]:.4f}; build kernel launches in the "
        f"phase: {launches}")
    return {"runs": runs, "serial_s": mean[False],
            "pipelined_s": mean[True], "blocks": n_blocks,
            "crash_build": crash_run}, launches


def lanes_path(g, dc, outdir: str, ref: dict, one_lane_ms: float) -> dict:
    """``[lanes]``: worker 0's road shard served by a ``ShardEngine`` over
    the lanes ``[cuda:0] * L`` for each L of ``LANE_COUNTS`` — the road
    rounds (free flow, the diff, ``k_moves=8`` with extraction) equal the
    one-lane engine's answers and paths; the launch counts, zeroed before
    the rounds and read after, are one ``table_search_walk`` launch a
    lane a call and no plain walk; the peak device memory shows one copy
    of the rows; each lane's launch of the free-flow round is held against
    the plain walk on its inputs and timed by CUDA events beside the
    one-lane launch and the lane's distinct-sector bound. Then one block
    built by ``build_fm_lanes`` over ``LANE_BUILD_LANES`` lanes equals
    the road build's block 0 byte for byte, and a replica engine of rank
    ``LANE_REPLICA`` holds its table on lane ``LANE_REPLICA % L``."""
    tag = "[lanes]"
    dev0 = torch.device("cuda", 0)
    queries = ref["queries"]
    rounds = [("free-flow", RuntimeConfig(), "-"),
              ("diff", RuntimeConfig(), ref["diff_path"]),
              ("k8", RuntimeConfig(k_moves=8, extract=True), "-")]
    out: dict = {"launches": 0, "max_abs_err": 0, "by_lanes": {}}
    for n_lanes in LANE_COUNTS:
        lanes = [dev0] * n_lanes
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        engine = eng.ShardEngine(g, dc, WID, outdir, mesh=lanes)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        fm_bytes = engine.fm.numel() * engine.fm.element_size()
        recorded: list = []
        real_lanes = eng.walk_lanes

        def recording(*a, **kw):
            recorded.append((a, kw))
            return real_lanes(*a, **kw)

        qps = {}
        plain0 = cw.cuda_walk_batch.plain
        programs0 = set(obs_device.snapshot())
        eng.walk_lanes = recording
        zero_launches()
        try:
            for name, cfg, diff in rounds:
                engine.answer(queries, cfg, diff)              # warm
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = engine.answer(queries, cfg, diff)
                torch.cuda.synchronize()
                qps[name] = len(queries) / (time.perf_counter() - t0)
                same_answers(tag, f"L={n_lanes} {name}", got[:3], ref[name])
                if cfg.extract:
                    same_answers(tag, f"L={n_lanes} {name} paths",
                                 engine.last_paths, ref["paths"])
            launches = cw.cuda_walk_batch.launches
            plain = cw.cuda_walk_batch.plain - plain0
        finally:
            eng.walk_lanes = real_lanes
        peak = torch.cuda.max_memory_allocated() - base
        calls = 2 * len(rounds)
        # the engine's obs.device entry of each new program key: one
        # more call over the lanes, after the first batch's timed interval
        captured = len(set(obs_device.snapshot()) - programs0)
        log(f"{tag} L={n_lanes}: engine over {n_lanes} lanes on {dev0} "
            f"loaded in {load_s:.2f} s; rounds "
            + ", ".join(f"{k} {v:.1f} q/s" for k, v in qps.items())
            + f" — answers and paths equal the one-lane engine's; walk "
            f"launches {launches} ({calls} calls + {captured} obs.device "
            f"captures, x {n_lanes} lanes), plain "
            f"walks {plain}; peak device memory above the start "
            f"{peak / 2**30:.3f} GiB for a {fm_bytes / 2**30:.3f} GiB "
            f"table ({n_lanes} copies would be "
            f"{n_lanes * fm_bytes / 2**30:.3f} GiB)")
        if launches != (calls + captured) * n_lanes or plain:
            raise AssertionError(f"{tag} L={n_lanes}: {launches} walk "
                                 f"launches, {plain} plain walks; want "
                                 f"{(calls + captured) * n_lanes} and 0")
        if len(recorded) != calls:
            raise AssertionError(f"{tag} L={n_lanes}: {len(recorded)} "
                                 f"lane walks for {calls} calls")
        if peak >= fm_bytes + (n_lanes - 1) * fm_bytes // 2:
            raise AssertionError(f"{tag} L={n_lanes}: peak device memory "
                                 f"grew by {peak} B: more than one copy of "
                                 f"the {fm_bytes} B table")
        placed = recorded[1][1]["placed"]
        if list(placed) != [dev0] or placed[dev0][1] is not engine.fm:
            raise AssertionError(f"{tag} the lanes do not share the table")
        # each lane's launch of the timed free-flow call, against the plain
        # walk on its inputs (launches here are comparisons, not counted)
        a, kw = recorded[1]
        per_lane = [kernel_vs_plain(f"L={n_lanes} lane {i}", (la, lkw), tag)
                    for i, (_dev, la, lkw) in enumerate(
                        sharded.lane_walk_program(*a, **kw))]
        ms = [x["kernel_ms"] for x in per_lane]
        log(f"{tag} L={n_lanes}: the lanes' launches "
            + ", ".join(f"{x:.4f}" for x in ms) + f" ms (sum "
            f"{sum(ms):.4f} ms) beside the one-lane launch "
            f"{one_lane_ms:.4f} ms on the same round; per-lane bounds "
            + ", ".join(f"{x['bound_ms']:.5f}" for x in per_lane)
            + " ms (distinct sectors); every lane bit-identical to the "
            "plain walk")
        out["launches"] += launches
        out["max_abs_err"] = max([out["max_abs_err"]]
                                 + [x["max_abs_err"] for x in per_lane])
        out["by_lanes"][n_lanes] = {
            "launches": launches, "load_s": load_s, "qps": qps,
            "peak_bytes": peak, "table_bytes": fm_bytes,
            "one_lane_ms": one_lane_ms, "lanes": per_lane}
        del engine, recorded, placed, a, kw
    gc.collect()
    torch.cuda.empty_cache()

    # one road block built over lanes == the road build's block 0
    kind, st = cpd.pick_build_kernel(g, "auto")
    dg = DeviceGraph.from_graph(g, device="cuda")
    owned = dc.owned(WID)[:ROAD_BLOCK]
    pad = np.full(ROAD_BLOCK, -1, np.int32)
    pad[:len(owned)] = owned
    t0 = time.perf_counter()
    block = sharded.build_fm_lanes(dg, pad, [dev0] * LANE_BUILD_LANES, kind,
                                   st).cpu().numpy()
    build_s = time.perf_counter() - t0
    want = np.load(os.path.join(outdir, cpd.shard_block_name(WID, 0)))
    if block[:len(owned)].tobytes() != want.tobytes():
        raise AssertionError(f"{tag} the lane build of block 0 differs from "
                             "the road build's")
    log(f"{tag} block 0 ({len(owned)} rows, {kind}) built over "
        f"{LANE_BUILD_LANES} lanes in {build_s:.2f} s: byte-equal to the "
        "road build's block file")
    del dg, block
    # a replica pins to its lane
    n_lanes = LANE_COUNTS[-1]
    lanes = [dev0] * n_lanes
    rep = eng.ShardEngine(g, dc, WID, outdir, mesh=lanes,
                          replica=LANE_REPLICA)
    want_dev = lanes[LANE_REPLICA % n_lanes]
    if rep.fm.device != want_dev or rep._lane_split:
        raise AssertionError(f"{tag} replica rank {LANE_REPLICA}: table on "
                             f"{rep.fm.device}, want lane "
                             f"{LANE_REPLICA % n_lanes}'s {want_dev}")
    same_answers(tag, f"replica rank {LANE_REPLICA}",
                 rep.answer(queries, RuntimeConfig())[:3], ref["free-flow"])
    log(f"{tag} replica rank {LANE_REPLICA} over {n_lanes} lanes: table "
        f"on lane {LANE_REPLICA % n_lanes}'s {want_dev}, no split; free-flow "
        "answers equal the one-lane engine's")
    del rep
    gc.collect()
    torch.cuda.empty_cache()
    out["lane_build_s"] = build_s
    return out


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def multihost_worker(argv: list[str]) -> int:
    """One controller of ``[multihost]`` (``chip_smoke.py
    --multihost-worker <pid> <conf> <out> [process_query args]``): runs
    ``process_query.main`` on the card with every launch count at 0 and
    prints, as its last line, the card and its launches as JSON."""
    pid, conf, out, *extra = argv
    os.environ["DOS_PROCESS_ID"] = pid
    zero_launches()
    plain0 = (cw.cuda_walk_batch.plain, cw.cuda_walk_multi.plain)
    rc = process_query.main(["-c", conf, "-o", out, "-v", *extra])
    torch.cuda.synchronize()
    from distributed_oracle_search_tpu_torch.parallel import multihost

    pidx, pcount = multihost.process_info()
    print(json.dumps({"multihost_worker": {
        "process": pidx, "processes": pcount, "rc": rc,
        "card": card_line(), "kind": torch.cuda.get_device_name(0),
        "walk_launches": cw.cuda_walk_batch.launches,
        "multi_launches": cw.cuda_walk_multi.launches,
        "plain": (cw.cuda_walk_batch.plain - plain0[0]
                  + cw.cuda_walk_multi.plain - plain0[1])}}), flush=True)
    return rc


def run_controllers(tag: str, conf: str, outdir: str, plan: str,
                    extra: list[str], env_add: dict) -> list[dict]:
    """Two new interpreters of this script as the controllers of one
    campaign, each logging to a file under ``outdir``; each must end
    within ``MULTIHOST_TIMEOUT_S`` (else both are killed and the phase
    fails) with exit code 0. Returns each one's JSON report, with its
    log."""
    # both controllers on this machine: the gloo group on the loopback
    env = dict(os.environ, **env_add)
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    logs = [os.path.join(outdir, f"mh-{plan}-p{pid}.log")
            for pid in range(MULTIHOST_PROCS)]
    procs = []
    for pid in range(MULTIHOST_PROCS):
        with open(logs[pid], "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__),
                 "--multihost-worker", str(pid), conf,
                 os.path.join(outdir, f"out-mh-{plan}-p{pid}"), *extra],
                stdout=f, stderr=subprocess.STDOUT, env=env, cwd=ROOT))
    deadline = time.perf_counter() + MULTIHOST_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.perf_counter(), 1))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.wait()
        raise AssertionError(f"{tag} {plan}: a controller outlived "
                             f"{MULTIHOST_TIMEOUT_S} s; both killed")
    reports = []
    for pid, (p, path) in enumerate(zip(procs, logs)):
        with open(path) as f:
            text = f.read()
        if p.returncode != 0:
            raise AssertionError(f"{tag} {plan}: controller {pid} exited "
                                 f"{p.returncode}:\n{text[-3000:]}")
        line = [ln for ln in text.splitlines()
                if ln.startswith('{"multihost_worker"')]
        if not line:
            raise AssertionError(f"{tag} {plan}: controller {pid} printed "
                                 f"no report:\n{text[-3000:]}")
        rep = json.loads(line[-1])["multihost_worker"]
        rep["log"] = text
        reports.append(rep)
    return reports


def multihost_path(outdir: str, ref: dict) -> dict:
    """``[multihost]``: two ``process_query`` controllers, new
    interpreters on ``cuda:0`` joined by gloo through a free port on
    127.0.0.1, run the campaign's conf plus a ``multihost`` key with ``-k
    8 --extract``: resident (each holds and walks 4 of the 8 workers)
    and streamed (each streams its own workers' rows, range chunks
    uploaded raw), the two pairs at once. Process 0 alone writes the
    artifacts, equal to the
    single controller's of ``[campaign]`` and ``[streamed-campaign]``;
    each controller's log names the card and its B1 launches (one a
    round resident, one a chunk streamed; no plain walk); the streamed
    controllers' wire bytes sum to one controller's under the same
    knobs, run here first."""
    tag = "[multihost]"
    k_args = ["-k", str(CAMPAIGN_K), "--extract"]
    with open(os.path.join(outdir, "conf.json")) as f:
        conf = json.load(f)
    # one controller under the streamed plan's knobs: the wire bytes the
    # two are held to
    single = os.path.join(outdir, "out-mh-single")
    saved = {k: os.environ.get(k) for k in MULTIHOST_STREAM_KNOBS}
    os.environ.update(MULTIHOST_STREAM_KNOBS)
    try:
        with StreamProbe() as probe:
            t0 = time.perf_counter()
            rc = process_query.main(["-c", os.path.join(outdir, "conf.json"),
                                     "-o", single, *k_args])
            single_s = time.perf_counter() - t0
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if rc != 0:
        raise AssertionError(f"{tag} the single controller exited {rc}")
    single_bytes = sum(r["stats"]["bytes_streamed"] for r in probe.runs)
    log(f"{tag} one controller, streamed (range chunks, raw uploads): "
        f"{single_bytes} wire bytes in {single_s:.2f} s")
    want = {"resident": (ref["parts_k"], ref["paths"]),
            "streamed": (os.path.join(outdir, f"out-streamed-k{CAMPAIGN_K}",
                                      "parts.csv"),
                         os.path.join(outdir, f"out-streamed-k{CAMPAIGN_K}",
                                      "paths.csv"))}
    out: dict = {"launches": 0, "single_bytes": single_bytes, "plans": {}}
    # the two plans' controller pairs run at once, each pair its own gloo
    # group on its own port
    plans = (("resident", {}), ("streamed", MULTIHOST_STREAM_KNOBS))
    ran: dict = {}
    ports: list[int] = []
    while len(ports) < len(plans):
        port = _free_port()
        if port not in ports:
            ports.append(port)
    for (plan, _), port in zip(plans, ports):
        with open(os.path.join(outdir, f"conf-mh-{plan}.json"), "w") as f:
            json.dump(dict(conf, multihost={
                "coordinator": f"127.0.0.1:{port}",
                "num_processes": MULTIHOST_PROCS}), f)

    def run_plan(plan, env_add):
        mconf = os.path.join(outdir, f"conf-mh-{plan}.json")
        t0 = time.perf_counter()
        try:
            ran[plan] = (run_controllers(tag, mconf, outdir, plan, k_args,
                                         env_add),
                         time.perf_counter() - t0)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            ran[plan] = e

    threads = [threading.Thread(target=run_plan, args=p) for p in plans]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    for plan, _ in plans:
        if isinstance(ran[plan], BaseException):
            raise ran[plan]
    card = card_line()
    for plan, _ in plans:
        reports, wall = ran[plan]
        for pid, rep in enumerate(reports):
            if (rep["process"], rep["processes"]) != (pid, MULTIHOST_PROCS):
                raise AssertionError(f"{tag} {plan}: controller {pid} "
                                     f"reports {rep['process']}/"
                                     f"{rep['processes']}")
            if rep["card"] != card or rep["walk_launches"] <= 0 \
                    or rep["plain"]:
                raise AssertionError(f"{tag} {plan}: controller {pid} on "
                                     f"{rep['card']!r}: {rep['walk_launches']}"
                                     f" walk launches, {rep['plain']} plain")
            log(f"{tag} {plan} controller {pid}/{MULTIHOST_PROCS} on "
                f"{rep['card']}: B1 launches {rep['walk_launches']}, fused "
                f"{rep['multi_launches']}, plain walks {rep['plain']}")
        if os.path.exists(os.path.join(outdir, f"out-mh-{plan}-p1")):
            raise AssertionError(f"{tag} {plan}: controller 1 wrote "
                                 "artifacts")
        got = os.path.join(outdir, f"out-mh-{plan}-p0")
        parts_want, paths_want = want[plan]
        if read_parts_counts(os.path.join(got, "parts.csv")) != \
                read_parts_counts(parts_want):
            raise AssertionError(f"{tag} {plan}: parts.csv differs from the "
                                 "single controller's")
        with open(os.path.join(got, "paths.csv"), "rb") as a, \
                open(paths_want, "rb") as b:
            if a.read() != b.read():
                raise AssertionError(f"{tag} {plan}: paths.csv differs from "
                                     "the single controller's")
        entry = {"wall_s": wall,
                 "walk_launches": [r["walk_launches"] for r in reports]}
        if plan == "streamed":
            wire = []
            for pid, rep in enumerate(reports):
                hit = re.search(rf"streamed: process {pid}/"
                                rf"{MULTIHOST_PROCS} streamed (\d+) wire",
                                rep["log"])
                if hit is None:
                    raise AssertionError(f"{tag} controller {pid} logged "
                                         "no wire bytes")
                wire.append(int(hit.group(1)))
            log(f"{tag} streamed wire bytes by controller {wire}, sum "
                f"{sum(wire)} == one controller's {single_bytes}")
            if sum(wire) != single_bytes or min(wire) <= 0:
                raise AssertionError(f"{tag} wire bytes {wire} do not split "
                                     f"one controller's {single_bytes}")
            entry["wire_bytes"] = wire
        log(f"{tag} {plan}: two controllers in {wall:.2f} s (both plans' "
            f"pairs at once); process 0's "
            "parts.csv (every column but the timers) and paths.csv equal "
            "the single controller's; process 1 wrote nothing")
        out["launches"] += sum(entry["walk_launches"])
        out["plans"][plan] = entry
    return out


def run() -> list[dict]:
    # ---- 1. card + kernel builds: one nvcc a source, started together;
    # beside them, host work that needs no card: the native engine's
    # build and [road]'s graph read through DIMACS
    log(card_line())
    work = os.path.join(ROOT, "build")
    os.makedirs(work, exist_ok=True)
    native_make = NativeMake().start()
    dimacs: dict = {}

    def read_dimacs():
        try:
            dimacs["g"] = road_graph_via_dimacs(work)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            dimacs["error"] = e

    th_dimacs = threading.Thread(target=read_dimacs)
    th_dimacs.start()
    t0 = time.perf_counter()
    sources = (cw.KERNEL_NAME, cbk.KERNEL_NAME, cd.KERNEL_NAME,
               ca.KERNEL_NAME)
    errors: list[BaseException] = []

    def build_one(name):
        try:
            cuda_build.load_library(name)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=build_one, args=(name,))
               for name in sources]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
    log(f"[build] {len(sources)} sources built in "
        f"{time.perf_counter() - t0:.2f} s")
    for name in sources:
        info = cuda_build.build_info[name]
        log(f"[build] {name}: nvcc {info['seconds']:.2f} s")
        for line in info["ptxas"].splitlines():
            log(f"[build]   {line.strip()}")

    # ---- 2. road path, its graph read through DIMACS
    th_dimacs.join()
    if "error" in dimacs:
        raise dimacs["error"]
    g = dimacs.pop("g")
    t0 = time.perf_counter()
    dc = DistributionController("mod", MAXWORKER, MAXWORKER, g.n,
                                block_size=ROAD_BLOCK)
    log(f"[graph] n={g.n} m={g.m} K={g.max_out_degree} "
        f"({time.perf_counter() - t0:.2f} s); worker {WID} owns "
        f"{dc.n_owned(WID)} targets")
    outdir = tempfile.mkdtemp(prefix="chip-smoke-", dir=work)
    cmps: dict[str, dict] = {}
    build_launches: dict[str, dict[str, int]] = {}
    try:
        raw_kernel, cmps["road"], build_launches["road"], road_k5, delta, \
            road_ref = road_path(g, dc, outdir)
        gc.collect()
        torch.cuda.empty_cache()
        # ---- 2a. the road index streamed
        stream = streamed_path(g, dc, outdir, road_ref)
        log(f"[streamed] done at {time.perf_counter() - T_START:.1f} s")
        # ---- 2b. the road engine over worker lanes
        lanes = lanes_path(g, dc, outdir, road_ref, raw_kernel["kernel_ms"])
        log(f"[lanes] done at {time.perf_counter() - T_START:.1f} s")
        del road_ref
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    build_launches["delta"] = {k: delta["launches"][k] for k in BUILD_FNS}
    # release the road engine's tables before the next phase
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[road] done at {time.perf_counter() - T_START:.1f} s")

    # ---- 2b. the pipelined build against the serial loop
    outdir = tempfile.mkdtemp(prefix="chip-smoke-pipeline-", dir=work)
    try:
        pipeline, build_launches["pipeline"] = pipeline_path(outdir)
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    log(f"[pipeline] done at {time.perf_counter() - T_START:.1f} s")

    # ---- 3. compressed path
    t0 = time.perf_counter()
    g = synth_city_graph(GRID_SIDE, GRID_SIDE, seed=SEED, shortcut_frac=0.0)
    dc = DistributionController("mod", GRID_MAXWORKER, GRID_MAXWORKER, g.n)
    log(f"[compressed] graph n={g.n} m={g.m} K={g.max_out_degree} "
        f"({time.perf_counter() - t0:.2f} s); worker {WID} owns "
        f"{dc.n_owned(WID)} targets")
    outdir = tempfile.mkdtemp(prefix="chip-smoke-grid-", dir=work)
    try:
        pack4_kernel, cmps["grid"], build_launches["grid"] = \
            compressed_path(g, dc, outdir)
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[compressed] done at {time.perf_counter() - T_START:.1f} s")

    # ---- 4. campaign path: make_cpds -> process_query over all workers,
    # then 5. the serving methods on its oracle, 6. the host backend and
    # 7. the reorder tool on its inputs
    outdir = tempfile.mkdtemp(prefix="chip-smoke-campaign-", dir=work)
    try:
        campaign, cmps["campaign"], build_launches["campaign"], ref, \
            oracle = campaign_path(outdir)
        log(f"[campaign] done at {time.perf_counter() - T_START:.1f} s")
        serving, build_launches["serving"] = serving_path(oracle, ref)
        del oracle
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[serving] done at {time.perf_counter() - T_START:.1f} s")
        stream_campaign = streamed_campaign(outdir, ref)
        log(f"[streamed-campaign] done at "
            f"{time.perf_counter() - T_START:.1f} s")
        mh = multihost_path(outdir, ref)
        log(f"[multihost] done at {time.perf_counter() - T_START:.1f} s")
        offline, build_launches["offline"] = offline_path(outdir, ref)
        log(f"[offline] done at {time.perf_counter() - T_START:.1f} s")
        host, build_launches["host"], handoff = host_path(outdir, ref)
        log(f"[host] done at {time.perf_counter() - T_START:.1f} s")
        native_out: dict = {}

        def native_phase():
            native_out["entry"], native_out["counts"] = native_path(
                outdir, native_make)
            log(f"[native] done at {time.perf_counter() - T_START:.1f} s")

        # [native] runs while the supervisor starts its servers
        supervised = supervise_path(ref, handoff, during=native_phase)
        log(f"[supervise] done at {time.perf_counter() - T_START:.1f} s")
        native, build_launches["native"] = (native_out["entry"],
                                            native_out["counts"])
        heal, build_launches["heal"] = heal_path(
            ref, handoff, os.path.join(outdir, "index"))
        log(f"[heal] done at {time.perf_counter() - T_START:.1f} s")
        rpc_run = rpc_path(ref, handoff, host["round_s"])
        log(f"[rpc] done at {time.perf_counter() - T_START:.1f} s")
        serve, build_launches["serve"] = serve_path(ref, handoff)
        log(f"[serve] done at {time.perf_counter() - T_START:.1f} s")
        p_engines, p_dc, p_conf = plane_engines(ref, handoff)
        planes = planes_path(ref, handoff, p_engines, p_dc, p_conf,
                             serve["pairs_qps"])
        log(f"[planes] done at {time.perf_counter() - T_START:.1f} s")
        gateway = gateway_path(ref, handoff, p_engines, p_dc, p_conf)
        del handoff, p_engines
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[gateway] done at {time.perf_counter() - T_START:.1f} s")
        reorder, build_launches["reorder"] = reorder_path(outdir, ref)
        log(f"[reorder] done at {time.perf_counter() - T_START:.1f} s")
        astar = astar_path(outdir, ref)
        log(f"[astar] done at {time.perf_counter() - T_START:.1f} s")
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    raw_kernel["launches_by_path"] = {
        "road": raw_kernel["launches"], "delta": delta["launches"]["walk"],
        "streamed": stream["launches"], "campaign": campaign["launches"],
        "serving": serving["launches"]["walk"],
        "streamed-campaign": stream_campaign["launches"],
        "offline": offline["launches"],
        "offline-local": offline["local_launches"],
        "host": host["launches"], "supervise": supervised["launches"],
        "native": native["launches"], "heal": heal["launches"],
        "rpc": rpc_run["launches"], "serve": serve["launches"],
        "planes": planes["launches"], "gateway": gateway["launches"],
        "lanes": lanes["launches"], "multihost": mh["launches"]}
    raw_kernel["launches"] = sum(raw_kernel["launches_by_path"].values())
    raw_kernel["max_abs_err"] = max(raw_kernel["max_abs_err"],
                                    stream["max_abs_err"],
                                    campaign["max_abs_err"],
                                    host["max_abs_err"],
                                    heal["max_abs_err"],
                                    lanes["max_abs_err"])
    raw_kernel["streamed"] = stream
    raw_kernel["streamed_campaign"] = stream_campaign
    raw_kernel["offline"] = offline
    raw_kernel["campaign"] = campaign
    raw_kernel["host"] = host
    raw_kernel["supervise"] = supervised
    raw_kernel["native"] = native
    raw_kernel["heal"] = heal
    raw_kernel["rpc"] = rpc_run
    raw_kernel["serve"] = serve
    raw_kernel["planes"] = planes
    raw_kernel["gateway"] = gateway
    raw_kernel["lanes"] = lanes
    raw_kernel["multihost"] = mh
    raw_kernel["reorder"] = reorder
    build = build_kernel_entries(cmps, build_launches)
    next(e for e in build if e["name"] == "first_moves")["reorder"] = reorder
    relax = next(e for e in build if e["name"] == "relax_jacobi")
    relax["pipeline"], relax["delta"] = pipeline, delta
    for entry in build:
        if entry["launches"] <= 0:
            raise AssertionError(f"the main path never launched "
                                 f"{entry['name']}")
    served = serving_entries(campaign, serving, road_k5)
    multi = served[0]
    multi["launches_by_path"].update(
        {"streamed": stream["multi_launches"],
         "streamed-campaign": stream_campaign["multi_launches"]})
    multi["launches"] = sum(multi["launches_by_path"].values())
    return [raw_kernel, pack4_kernel, *build, *served, *astar]


def serving_entries(campaign: dict, serving: dict, road: dict
                    ) -> list[dict]:
    """The kernel table's entries of K4 (the fused multi-diff walk) and
    K5 (the on-chip doubling and the wide path's sweep): launches in the
    main runs (the campaign's and the serving phase's; the road shard's
    tables for the wide sweep), the headline numbers from the serving
    phase (K4, the on-chip doubling) and the road shard (the wide
    sweep)."""
    k4 = serving["k4"][0]
    multi = {"name": cw.KERNEL_NAME_MULTI, "route": "cuda",
             "source": "distributed_oracle_search_tpu_torch/csrc/"
                       "table_search_walk.cu",
             "replaces": "distributed_oracle_search_tpu/ops/table_search.py"
                         ":235 (table_search_multi, an XLA stage: no "
                         "pallas_call)",
             "launches": (campaign["multi_launches"]
                          + serving["launches"]["multi"]),
             "launches_by_path": {"campaign": campaign["multi_launches"],
                                  "serving": serving["launches"]["multi"]},
             "max_abs_err": max(x["max_abs_err"] for x in serving["k4"]),
             **{k: k4[k] for k in ("ms", "plain_ms", "bound_ms",
                                   "bound_by", "singles_ms")},
             "library_ms": None, "parity": "bit-identical",
             "calls": serving["k4"]}
    k5 = serving["k5"]
    k5_err = max(x["max_abs_err"]
                 for x in (k5, *serving["k5_wide"], serving["k5_main_wide"],
                           road))
    replaces = ("distributed_oracle_search_tpu/ops/pointer_doubling.py:173 "
                "(doubled_tables_multi's while_loop, an XLA stage: no "
                "pallas_call; also doubled_tables' at :101)")
    source = "distributed_oracle_search_tpu_torch/csrc/pointer_doubling.cu"
    rows = {"name": cd.ENTRY_ROWS, "route": "cuda", "source": source,
            "replaces": replaces, "launches": serving["launches"]["rows"],
            "launches_by_path": {"serving": serving["launches"]["rows"]},
            "reruns": serving["reruns"], "max_abs_err": k5_err,
            **{k: k5[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                  "library_ms", "sweep_loop_ms", "sweeps",
                                  "plan", "ids_ms", "ids_library_ms",
                                  "ids_sweep_loop_ms")},
            "parity": "bit-identical", "chunk": k5,
            "wide": serving["k5_wide"], "sweeps_by_prepare": serving["sweeps"],
            "qps": serving["qps"]}
    sweep = {"name": cd.ENTRY, "route": "cuda", "source": source,
             "replaces": replaces, "launches": road["launches"],
             "launches_by_path": {"road": road["launches"]},
             "max_abs_err": k5_err,
             **{k: road[k] for k in ("ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms",
                                     "ms_by_sweep")},
             "parity": "bit-identical", "road": road,
             "campaign_chunk": k5["sweep"],
             "past_the_largest_cluster": serving["k5_main_wide"]}
    for entry in (multi, rows, sweep):
        if entry["launches"] <= 0:
            raise AssertionError(f"the main path never launched "
                                 f"{entry['name']}")
    return [multi, rows, sweep]


def check_build_launches(path: str, tag: str) -> dict[str, int]:
    """The build kernels' launches of a path's main run (read right
    after it); the kernels of the path's build kind must have run."""
    counts = read_build_launches()
    need = (("grid_sweep_cycle", "first_moves")
            if EXPECTED_KIND[path] == "sweep"
            else ("relax_jacobi", "first_moves"))
    log(f"{tag} build kernel launches in the path's run: {counts}")
    for name in need:
        if counts[name] <= 0:
            raise AssertionError(f"{tag} the build never launched {name}")
    return counts


def write_dimacs(g, gr: str, co: str) -> None:
    """``g`` as DIMACS 9th-challenge ``.gr``/``.co`` files, 1-indexed
    (``p sp n m`` and ``a u v w`` lines; ``p aux sp co n`` and ``v i x
    y`` lines), as the JAX package's test helper writes them."""
    with open(gr, "w") as f:
        f.write(f"c synthetic road, DIMACS format\np sp {g.n} {g.m}\n")
        np.savetxt(f, np.stack([g.src + 1, g.dst + 1, g.w], axis=1),
                   fmt="a %d %d %d")
    with open(co, "w") as f:
        f.write(f"p aux sp co {g.n}\n")
        np.savetxt(f, np.stack([np.arange(1, g.n + 1), g.xs, g.ys],
                               axis=1), fmt="v %d %d %d")


def road_graph_via_dimacs(work: str):
    """``[road]``'s graph, read through DIMACS: the USA-road-d.NY
    stand-in written as ``.gr``/``.co``, converted by the port's
    ``python -m ...data.dimacs``, the ``.xy`` held byte-equal to
    ``write_xy`` of the same graph; the graph read from that ``.xy``
    (array by array the generator's)."""
    t_all = time.perf_counter()
    g0 = synth_road_network(N_NODES, seed=SEED)
    d = tempfile.mkdtemp(prefix="chip-smoke-dimacs-", dir=work)
    try:
        gr, co, xy, direct = (os.path.join(d, f) for f in (
            "road.gr", "road.co", "road.xy", "direct.xy"))
        t0 = time.perf_counter()
        write_dimacs(g0, gr, co)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        conv = subprocess.run(
            [sys.executable, "-m", "distributed_oracle_search_tpu_torch.data."
             "dimacs", "--gr", gr, "--co", co, "-o", xy],
            capture_output=True, text=True, cwd=ROOT, timeout=600)
        conv_s = time.perf_counter() - t0
        if conv.returncode:
            raise AssertionError(f"[road] DIMACS conversion: rc "
                                 f"{conv.returncode}\n{conv.stderr[-2000:]}")
        write_xy(direct, g0.xs, g0.ys, g0.src, g0.dst, g0.w)
        with open(xy, "rb") as f, open(direct, "rb") as h:
            if f.read() != h.read():
                raise AssertionError("[road] the DIMACS .xy differs from "
                                     "write_xy's of the same graph")
        sizes = (os.path.getsize(gr), os.path.getsize(co))
        g = Graph.from_xy(xy)
        for name in ("xs", "ys", "src", "dst", "w"):
            if not np.array_equal(getattr(g, name), getattr(g0, name)):
                raise AssertionError(f"[road] the graph read from the "
                                     f"DIMACS .xy differs in {name}")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    log(f"[road] graph read through DIMACS: .gr/.co of {sizes[0]} + "
        f"{sizes[1]} B written in {write_s:.2f} s, converted by "
        f"data.dimacs in {conv_s:.2f} s ({conv.stdout.strip()}); the .xy "
        "byte-equal to write_xy's, the graph read from it array by array "
        f"the generator's ({time.perf_counter() - t_all:.2f} s in all)")
    return g


def road_path(g, dc, outdir):
    zero_launches()
    full: dict = {}
    with KindProbe() as kinds:
        build_index(g, dc, outdir, "[build-shard]", stats=full)
    kind = kinds.check("road", "[build-shard]")
    if not full["pipelined"] or full["blocks"] != -(-dc.n_owned(WID)
                                                   // dc.block_size):
        raise AssertionError(f"[build-shard] the road shard was not built "
                             f"by the pipeline in blocks: {full}")

    # engine on the card, three rounds through answer()
    t0 = time.perf_counter()
    engine = eng.ShardEngine(g, dc, WID, outdir, device="cuda")
    torch.cuda.synchronize()
    log(f"[engine] loaded {tuple(engine.fm.shape)} {engine.fm.dtype} fm "
        f"({engine.fm.numel() / 1e9:.2f} GB) in "
        f"{time.perf_counter() - t0:.2f} s")
    queries = make_queries(dc.owned(WID), g.n)
    diff_path, rounds = rounds_for(g, outdir)
    answers = drive_rounds(engine, queries, rounds, "[answer]")
    launches = read_launches()[0]
    build_counts = check_build_launches("road", "[build-shard]")
    log(f"[answer] walk kernel launches in the three rounds: {launches}")
    if launches <= 0:
        raise AssertionError("the main path never launched the walk kernel")

    # kernel vs plain torch on each round's kernel inputs
    per_round = [kernel_vs_plain(name, answers[name][5], "[kernel]")
                 for name in ROUND_NAMES]

    # golden checks against the CPU reference oracle
    golden_dijkstra(g, queries, answers["free-flow"][0],
                    answers["free-flow"][2], "[golden]")
    w_diff = g.weights_with_diff(diff_path)
    cost_d, plen_d, fin_d = answers["diff"][:3]
    fm_rows: dict[int, np.ndarray] = {}

    def fm_of(x, tt):
        if tt not in fm_rows:
            r = int(dc.owned_index_of(tt))
            fm_rows[tt] = engine.fm[r].cpu().numpy()
        return fm_rows[tt][x]

    rng = np.random.default_rng(SEED + 2)
    for i in rng.choice(len(queries), 16, replace=False):
        s, t = (int(v) for v in queries[i])
        c, p, f, _ = table_search_walk(g, fm_of, s, t, w_query=w_diff)
        if (int(cost_d[i]), int(plen_d[i]), bool(fin_d[i])) != (c, p, f):
            raise AssertionError(
                f"diff query {s}->{t}: engine "
                f"{(cost_d[i], plen_d[i], fin_d[i])} != reference "
                f"{(c, p, f)}")
    log("[golden] 16 diff-round answers equal the reference walk")
    _, plen_k, _, _, paths, _, _ = answers["k8-extract"]
    nodes, moves = paths
    if (nodes.shape != (len(queries), 9)
            or not np.array_equal(nodes[:, 0], queries[:, 0])
            or not np.array_equal(moves, plen_k) or plen_k.max() > 8):
        raise AssertionError("k_moves=8 extraction disagrees with the walk")
    log("[golden] k_moves=8 extraction: [Q, 9] prefixes, moves == plen")
    road_k5 = road_doubling(g, dc, engine, queries, answers["free-flow"])
    delta = delta_path(g, dc, outdir, engine, queries,
                       answers["free-flow"][:3], full["seconds"])
    delta["full_build"] = full

    main = per_round[0]
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    cmp = build_kernels_vs_plain("[build-kernel road]", g, kind,
                                 cpd.pick_build_kernel(g, "auto")[1],
                                 dc.owned(WID)[:CHUNK])
    # what the streamed phase is held to: the engine's answers
    road_ref = {"queries": queries, "diff_path": diff_path,
                "free-flow": answers["free-flow"][:3],
                "diff": answers["diff"][:3],
                "k8": answers["k8-extract"][:3], "paths": paths}
    return {
        "name": cw.KERNEL_NAME,
        "route": "cuda",
        "source": "distributed_oracle_search_tpu_torch/csrc/"
                  "table_search_walk.cu",
        "replaces": "distributed_oracle_search_tpu/ops/pallas_walk.py:380",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in per_round),
        **headline(main),
        "parity": "bit-identical",
        "rounds": per_round,
    }, cmp, build_counts, road_k5, delta, road_ref


def road_doubling(g, dc, engine, queries, walk) -> dict:
    """The road shard's doubling tables: the wide path on the main path.
    Worker 0's rows are doubled through the sharded layer that
    ``CPDOracle.prepare_weights`` calls (``sharded.build_tables_sharded``,
    ``ROAD_TABLE_CHUNK`` rows a call, the records in the oracle's
    Z-order) and answered by ``sharded.query_tables_sharded``: an oracle
    of this graph would hold every worker's rows (a 69.7 GB fm, 557 GB of
    tables), so one worker's shard (17.4 GB of tables) is what one card
    serves. The doubling counts are zeroed just before and read just
    after: no on-chip launch, one sweep launch a sweep. Checks: the
    answers equal the engine's free-flow walk (``walk``: cost, plen,
    finished); then the wide sweep on the first chunk equals the plain
    sweep, sweep by sweep, each timed beside ``torch.gather`` and the
    plain sweep."""
    tag = "[road-tables]"
    dev = engine.device
    r, n = engine.fm.shape
    plan = cd.rows_plan(n, 1, dev)
    if plan[0] != 0:
        raise AssertionError(f"{tag} a row of {n} nodes fits a cluster "
                             f"{plan}: expected the wide path")
    targets = np.asarray(dc.owned(WID), np.int32)[None]
    order = pd.record_order(g, dev)
    w_pad = engine.dg.w_pad
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cd.doubling_rows.launches = 0
    cd.doubling_sweep.launches = 0
    before = pd.doubled_tables_multi.sweeps
    t0 = time.perf_counter()
    tables = (torch.empty((1, r, n), dtype=torch.int32, device=dev),
              torch.empty((1, r, n), dtype=pd.plen_dtype(n), device=dev))
    for i in range(0, r, ROAD_TABLE_CHUNK):
        c = min(ROAD_TABLE_CHUNK, r - i)
        sharded.build_tables_sharded(
            engine.dg, engine.fm[None, i:i + c], targets[:, i:i + c], w_pad,
            out=tuple(x[:, i:i + c] for x in tables), order=order)
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    shape = (1, 1, len(queries))
    t0 = time.perf_counter()
    got = [x.cpu().numpy().reshape(-1) for x in sharded.query_tables_sharded(
        tables, np.asarray(dc.owned_index_of(queries[:, 1]),
                           np.int32).reshape(shape),
        queries[:, 0].astype(np.int32).reshape(shape), np.ones(shape, bool))]
    look_s = time.perf_counter() - t0
    launches = (cd.doubling_rows.launches, cd.doubling_sweep.launches)
    sweeps = pd.doubled_tables_multi.sweeps - before
    chunks = -(-r // ROAD_TABLE_CHUNK)
    t_bytes = sum(x.numel() * x.element_size() for x in tables)
    log(f"{tag} worker {WID}'s {r} rows x {n} nodes in {chunks} chunks: "
        f"prepare {prep_s:.4f} s, {sweeps} sweeps, launches: on-chip "
        f"{launches[0]}, wide sweep {launches[1]}; tables {t_bytes} B, peak "
        f"device memory {peak / 2**30:.2f} GiB; {len(queries)} lookups "
        f"{look_s:.4f} s")
    if launches[0] != 0 or launches[1] != sweeps or sweeps < chunks:
        raise AssertionError(f"{tag} the road shard's doubling did not take "
                             f"the wide path: {launches[0]} on-chip "
                             f"launches, {launches[1]} sweep launches for "
                             f"{sweeps} sweeps over {chunks} chunks")
    for a, b, what in zip(got, walk[:3], ("cost", "plen", "finished")):
        if not np.array_equal(a.astype(b.dtype), b):
            raise AssertionError(f"{tag} the tables' {what} differs from "
                                 "the engine's free-flow walk")
    log(f"{tag} every table answer equals the engine's free-flow walk")
    del tables
    gc.collect()
    torch.cuda.empty_cache()
    rec = pd.initial_records(engine.dg, engine.fm[:ROAD_TABLE_CHUNK],
                             w_pad[None], order)
    rows = rec.shape[0]
    loop = sweep_loop(rec, pd.n_sweeps(n), tag, f"D=1, {rows} rows", True)
    del rec
    gc.collect()
    torch.cuda.empty_cache()
    k = loop["sweeps"]
    ms, gather_ms = loop["ms_by_sweep"], loop["gather_ms_by_sweep"]
    # a sweep's compact records read once and written once
    nbytes = 2 * rows * n * 3 * 4
    bound_ms, bound_by = bound(nbytes, rows * n * 3)
    res = {"rows": r, "n": n, "chunks": chunks, "prepare_s": prep_s,
           "peak_bytes": peak, "table_bytes": t_bytes, "lookup_s": look_s,
           "sweeps": sweeps, "launches": launches[1],
           "timed_rows": rows, "timed_sweeps": k, "ms": sum(ms) / k,
           "plain_ms": sum(loop["plain_ms_by_sweep"]) / k,
           "library_ms": sum(gather_ms) / k, "bound_ms": bound_ms,
           "bound_by": bound_by, "bytes": nbytes, "ms_by_sweep": ms,
           "gather_ms_by_sweep": gather_ms,
           "max_abs_err": loop["max_abs_err"]}
    log(f"{tag} the wide sweep on the first {rows} rows equals the plain "
        f"sweep, sweep by sweep: {k} sweeps, a sweep {res['ms']:.4f} ms "
        "(" + ", ".join(f"{x:.4f}" for x in ms) + f"), torch.gather "
        f"{res['library_ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, bound "
        f"{bound_ms:.5f} ms by {bound_by} ({nbytes} B)")
    return res


def compressed_path(g, dc, outdir):
    tag = "[compressed]"
    r, n = dc.n_owned(WID), g.n
    zero_launches()
    with KindProbe() as kinds:
        man = build_index(g, dc, outdir, f"{tag} build-shard",
                          codec="pack4")
    kind = kinds.check("grid", tag)
    codecs = [m.get("codec") for m in man["blocks"].values()]
    disk = sum(os.path.getsize(os.path.join(outdir, f))
               for f in man["files"])
    log(f"{tag} index: {len(man['files'])} block(s), {disk} B on disk "
        f"(raw table {r * n} B), manifest codecs {codecs}")
    if not codecs or any(c != "pack4" for c in codecs):
        raise AssertionError(f"blocks are not pack4 containers: {codecs}")

    # three engines from the one index, one per resident codec
    engines = {}
    prior = os.environ.get("DOS_CPD_RESIDENT")
    try:
        for codec in ("raw", "pack4", "rle"):
            os.environ["DOS_CPD_RESIDENT"] = codec
            t0 = time.perf_counter()
            e = eng.ShardEngine(g, dc, WID, outdir, device="cuda")
            torch.cuda.synchronize()
            if e.resident_codec != codec:
                raise AssertionError(f"engine asked for {codec} resides "
                                     f"{e.resident_codec}")
            log(f"{tag} engine {codec}: resident_bytes={e.resident_bytes} "
                f"({e.resident_bytes / (r * n):.4f} of raw), loaded in "
                f"{time.perf_counter() - t0:.2f} s")
            engines[codec] = e
    finally:
        if prior is None:
            os.environ.pop("DOS_CPD_RESIDENT", None)
        else:
            os.environ["DOS_CPD_RESIDENT"] = prior
    if engines["pack4"].resident_bytes != r * ((n + 1) // 2):
        raise AssertionError("pack4 resident bytes are not half a row each")

    # the same three rounds on each engine
    queries = make_queries(dc.owned(WID), g.n)
    _, rounds = rounds_for(g, outdir)
    answers = {codec: drive_rounds(e, queries, rounds, f"{tag} {codec}")
               for codec, e in engines.items()}
    launches_raw, launches_pack4 = read_launches()
    build_counts = check_build_launches("grid", tag)
    if build_counts["grid_sweep_cycle"] != build_counts["first_moves"]:
        raise AssertionError(f"{tag} {build_counts['grid_sweep_cycle']} "
                             "sweep launches for "
                             f"{build_counts['first_moves']} chunks")
    log(f"{tag} grid_sweep_cycle: one launch a chunk "
        f"({build_counts['grid_sweep_cycle']}): the lattice has no "
        "off-lattice edges, so each launch runs its chunk's cycles to "
        "convergence")
    log(f"{tag} kernel launches in the nine rounds: raw {launches_raw}, "
        f"pack4 {launches_pack4}")
    for codec in ("pack4", "rle"):
        for name in ROUND_NAMES:
            want, got = answers["raw"][name], answers[codec][name]
            for x, y, label in zip(want[:3], got[:3],
                                   ("cost", "plen", "fin")):
                if not np.array_equal(x, y):
                    raise AssertionError(f"{codec} {name}: {label} differs "
                                         "from the raw engine")
            if name == "k8-extract":
                for x, y in zip(want[4], got[4]):
                    if not np.array_equal(x, y):
                        raise AssertionError(f"{codec} {name}: paths "
                                             "differ from the raw engine")
            p4 = got[6][1]
            if (p4 > 0) != (codec == "pack4" and name != "k8-extract"):
                raise AssertionError(f"{codec} {name}: {p4} pack4 kernel "
                                     "launches")
        log(f"{tag} {codec} answers equal raw in all three rounds, paths "
            "included")

    # the pack4 kernel against its plain version on its recorded inputs
    per_round = []
    for name in ("free-flow", "diff"):
        call = answers["pack4"][name][5]
        if not call[1].get("packed4"):
            raise AssertionError(f"pack4 {name} did not walk packed rows")
        per_round.append(kernel_vs_plain(name, call, f"{tag} kernel"))
    # the raw kernel on the same lanes over the raw table, for scale
    a, kw = answers["pack4"]["free-flow"][5]
    a = (a[0], engines["raw"].fm, *a[2:])
    kw = {k: v for k, v in kw.items() if k != "packed4"}
    raw_same_ms = time_bare(bare_launch((a, kw))[0], KERNEL_REPS)
    log(f"{tag} raw kernel on the same free-flow lanes: {raw_same_ms:.4f} "
        f"ms (pack4 {per_round[0]['ms']:.4f} ms)")

    # decompress-at-use of one batch's distinct target rows
    urows = np.unique(dc.owned_index_of(queries[:, 1]))
    rows_u = np.zeros(1 << (len(urows) - 1).bit_length(), np.int32)
    rows_u[:len(urows)] = urows
    rows_dev = torch.from_numpy(rows_u).cuda()
    dense_raw = engines["raw"].fm[rows_dev.long()]
    for codec in ("pack4", "rle"):
        fm = engines[codec].fm
        if not torch.equal(fm.decompress_rows(rows_dev), dense_raw):
            raise AssertionError(f"{codec} decompress_rows != raw rows")
        ms = time_cuda(lambda: fm.decompress_rows(rows_dev),
                       DECOMPRESS_REPS)
        log(f"{tag} decompress_rows {codec}: {len(rows_u)} rows "
            f"({len(urows)} distinct) x {n} in {ms:.3f} ms")
    del dense_raw
    scrubbed = compressed_scrub(engines, outdir, queries,
                                answers["raw"]["free-flow"], tag)

    golden_dijkstra(g, queries, answers["raw"]["free-flow"][0],
                    answers["raw"]["free-flow"][2], f"{tag} golden")
    main = per_round[0]
    del engines, answers
    gc.collect()
    torch.cuda.empty_cache()
    cmp = build_kernels_vs_plain("[build-kernel grid]", g, kind,
                                 cpd.pick_build_kernel(g, "auto")[1],
                                 dc.owned(WID)[:CHUNK])
    return {
        "name": cw.KERNEL_NAME_PACK4,
        "route": "cuda",
        "source": "distributed_oracle_search_tpu_torch/csrc/"
                  "table_search_walk.cu",
        "replaces": "distributed_oracle_search_tpu/ops/pallas_walk.py:380 "
                    "(packed4=True)",
        "launches": launches_pack4,
        "max_abs_err": max(x["max_abs_err"] for x in per_round),
        **headline(main),
        "parity": "bit-identical",
        "rounds": per_round,
        "raw_kernel_same_lanes_ms": raw_same_ms,
        "scrub": scrubbed,
    }, cmp, build_counts


def campaign_inputs(outdir: str):
    """The campaign's files: the road network as an ``.xy`` file, the
    scenario, the diff and the conf. Returns ``(graph as the CLIs read
    it, queries, diff path, conf path, index dir)``."""
    g0 = synth_road_network(CAMPAIGN_NODES, seed=SEED)
    xy = os.path.join(outdir, "road.xy")
    write_xy(xy, g0.xs, g0.ys, g0.src, g0.dst, g0.w)
    g = Graph.from_xy(xy)
    queries = make_queries(np.arange(g.n), g.n)
    scen = os.path.join(outdir, "road.scen")
    write_scen(scen, queries)
    diff_path = os.path.join(outdir, "congestion.diff")
    write_diff(diff_path, *synth_diff(g, frac=0.1, seed=2))
    index = os.path.join(outdir, "index")
    conf = os.path.join(outdir, "conf.json")
    with open(conf, "w") as f:
        json.dump({"workers": [f"tpu:{i}" for i in range(CAMPAIGN_WORKERS)],
                   "partmethod": "tpu", "partkey": CAMPAIGN_WORKERS,
                   "outdir": index, "xy_file": xy, "scenfile": scen,
                   "diffs": ["-", diff_path]}, f)
    return g, queries, diff_path, conf, index


class CampaignProbe:
    """Times the oracle's ``build``/``save``/``load``/``query``/
    ``query_multi`` calls the CLIs make (host clock, synchronised), keeps
    the oracles they load and what ``query_multi`` answered, and records
    every pair-table build by (oracle, weight set) and every edge-id
    pair-table build (the fused walk's) by oracle."""

    METHODS = ("build", "save", "load", "query", "query_multi")

    def __init__(self):
        self.seconds: dict[str, list[float]] = {m: [] for m in self.METHODS}
        self.oracles: list = []
        self.multi_out: list = []
        self.pairs: list[tuple[int, str]] = []
        self.eid_pairs: list[int] = []
        self._real = {m: getattr(cpd.CPDOracle, m) for m in self.METHODS}
        self._real_pairs = cpd.walk_pairs
        self._real_eid_pairs = cpd.walk_eid_pairs

    def _timed(self, name):
        fn = self._real[name]

        def wrapper(oracle, *a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(oracle, *a, **kw)
            torch.cuda.synchronize()
            self.seconds[name].append(time.perf_counter() - t0)
            if name == "load":
                self.oracles.append(oracle)
            if name == "query_multi":
                self.multi_out.append(out)
            return out
        return wrapper

    def _counting_pairs(self, dg, w_pad):
        key = hashlib.blake2b(w_pad.cpu().numpy().tobytes()).hexdigest()
        self.pairs.append((id(dg), key))
        return self._real_pairs(dg, w_pad)

    def _counting_eid_pairs(self, dg):
        self.eid_pairs.append(id(dg))
        return self._real_eid_pairs(dg)

    def __enter__(self):
        for m in self.METHODS:
            setattr(cpd.CPDOracle, m, self._timed(m))
        cpd.walk_pairs = self._counting_pairs
        cpd.walk_eid_pairs = self._counting_eid_pairs
        return self

    def __exit__(self, *exc):
        for m, fn in self._real.items():
            setattr(cpd.CPDOracle, m, fn)
        cpd.walk_pairs = self._real_pairs
        cpd.walk_eid_pairs = self._real_eid_pairs


def campaign_path(outdir: str) -> dict:
    tag = "[campaign]"
    t0 = time.perf_counter()
    g, queries, diff_path, conf, index = campaign_inputs(outdir)
    dc = DistributionController("tpu", CAMPAIGN_WORKERS, CAMPAIGN_WORKERS,
                                g.n)
    w, r = CAMPAIGN_WORKERS, dc.max_owned
    log(f"{tag} graph n={g.n} m={g.m} K={g.max_out_degree}; {w} workers x "
        f"{r} rows: fm int8 [{w}, {r}, {g.n}] = {w * r * g.n} B; "
        f"{len(queries)} queries; inputs written in "
        f"{time.perf_counter() - t0:.2f} s")
    out_rounds = os.path.join(outdir, "out-rounds")
    out_k = os.path.join(outdir, f"out-k{CAMPAIGN_K}")
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    with CampaignProbe() as probe:
        with KindProbe() as kinds:
            rcs = [make_cpds.main(["-c", conf])]
        peak = torch.cuda.max_memory_allocated()
        rcs.append(process_query.main(["-c", conf, "-o", out_rounds]))
        rcs.append(process_query.main(["-c", conf, "-o", out_k, "-k",
                                       str(CAMPAIGN_K), "--extract"]))
        launches = read_launches()[0]
        multi_launches = cw.cuda_walk_multi.launches
        build_counts = check_build_launches("campaign", tag)
        n_pairs = len(probe.pairs)
        n_eid_pairs = len(probe.eid_pairs)
        oracle = probe.oracles[0]
        del probe.oracles[1:]
        # a direct query of every round on the first campaign's oracle,
        # recording the walk call it makes
        recorded: list = []
        real_walk = sharded.cuda_walk_batch

        def recording_walk(*a, **kw):
            recorded.append((a, kw))
            return real_walk(*a, **kw)

        sharded.cuda_walk_batch = recording_walk
        try:
            w_diff = g.weights_with_diff(diff_path)
            direct = {"free-flow": oracle.query(queries),
                      "diff": oracle.query(queries, w_query=w_diff)}
            nodes, moves = oracle.query_paths(queries, k=CAMPAIGN_K)
        finally:
            sharded.cuda_walk_batch = real_walk
    gc.collect()
    torch.cuda.empty_cache()
    if rcs != [0, 0, 0]:
        raise AssertionError(f"{tag} CLI exit codes {rcs}")
    kind = kinds.check("campaign", tag)
    disk = sum(os.path.getsize(os.path.join(index, f))
               for f in os.listdir(index))
    rows = w * r
    build_s, save_s = probe.seconds["build"][0], probe.seconds["save"][0]
    log(f"{tag} make_cpds: build {build_s:.3f} s = {rows / build_s:.2f} "
        f"rows/s ({rows} rows), peak device memory {peak / 2**30:.2f} GiB; "
        f"save {save_s:.3f} s, index {disk} B on disk in "
        f"{len(os.listdir(index))} files")
    log(f"{tag} process_query loads: "
        + ", ".join(f"{x:.3f} s" for x in probe.seconds["load"])
        + f"; resident_bytes={oracle.fm.numel() * oracle.fm.element_size()}"
        f" ({tuple(oracle.fm.shape)} {oracle.fm.dtype} on "
        f"{oracle.fm.device})")
    names = ["free-flow", "diff", f"k{CAMPAIGN_K} free-flow",
             f"k{CAMPAIGN_K} diff"]
    # the conf's two rounds are one fused walk: each round's time is an
    # equal share of it, as the CLI books it
    fused_s = probe.seconds["query_multi"][0]
    round_s = [fused_s / 2, fused_s / 2, *probe.seconds["query"][:2]]
    log(f"{tag} rounds free-flow + diff fused into one walk: "
        f"{len(queries)} queries x 2 rounds in {fused_s:.4f} s = "
        f"{2 * len(queries) / fused_s:.1f} answers/s")
    for name, sec in zip(names[2:], round_s[2:]):
        log(f"{tag} round {name}: {len(queries)} queries in {sec:.4f} s = "
            f"{len(queries) / sec:.1f} q/s")
    log(f"{tag} launches in the CLIs' runs: fused walk {multi_launches} "
        f"(the two conf rounds), walk {launches} (the -k {CAMPAIGN_K} "
        f"rounds, one a round); pair tables built: {n_pairs}, one per "
        f"weight set of the -k oracle; edge-id pair tables: {n_eid_pairs}, "
        "the fused oracle's one")
    if multi_launches != 1:
        raise AssertionError(f"{tag} {multi_launches} fused walk launches "
                             "for the two fused rounds, not one")
    if launches != 2:
        raise AssertionError(f"{tag} {launches} walk kernel launches in "
                             f"the two -k {CAMPAIGN_K} rounds, not one a "
                             "round")
    if len(set(probe.pairs)) != len(probe.pairs) or n_pairs != 2:
        raise AssertionError(f"{tag} pair tables built {probe.pairs}")
    if n_eid_pairs != 1:
        raise AssertionError(f"{tag} edge-id pair tables built "
                             f"{probe.eid_pairs}")
    # the direct queries walk the fused oracle, which built no pair table
    # of its own: one each for its two weight sets, none twice
    if (len(probe.pairs) != n_pairs + 2
            or len(set(probe.pairs)) != len(probe.pairs)):
        raise AssertionError(f"{tag} the direct queries built pairs "
                             f"{probe.pairs[n_pairs:]}")
    f_cost, f_plen, f_fin = probe.multi_out[0]
    for i, name in enumerate(("free-flow", "diff")):
        cost, plen, fin = direct[name]
        if not (np.array_equal(f_cost[i], cost)
                and np.array_equal(f_plen, plen)
                and np.array_equal(f_fin, fin)):
            raise AssertionError(f"{tag} fused round {name} differs from "
                                 "a direct CPDOracle.query")
    log(f"{tag} the fused rounds' costs, plen and finished equal a direct "
        "CPDOracle.query of each round, query by query")

    # parts.csv: per-worker plen and finished sums of each round
    owner = dc.worker_of(queries[:, 1])
    with open(os.path.join(out_rounds, "parts.csv")) as f:
        parts = list(csv.DictReader(f))
    for expe, name in enumerate(("free-flow", "diff")):
        _, plen, fin = direct[name]
        mine = [p for p in parts if p["expe"] == str(expe)]
        want = [(wid, int(plen[owner == wid].sum()),
                 int(fin[owner == wid].sum())) for wid in range(w)]
        got = [(wid, int(p["plen"]), int(p["finished"]))
               for wid, p in enumerate(mine)]
        if got != want:
            raise AssertionError(f"{tag} parts.csv round {name}: {got} != "
                                 f"direct query {want}")
    log(f"{tag} parts.csv per-worker plen and finished sums equal a direct "
        "CPDOracle.query in both rounds")
    paths = np.loadtxt(os.path.join(out_k, "paths.csv"), delimiter=",",
                       skiprows=1, dtype=np.int64)
    if not np.array_equal(paths, np.concatenate(
            [queries, moves[:, None], nodes], axis=1)):
        raise AssertionError(f"{tag} paths.csv != query_paths")
    log(f"{tag} paths.csv equals query_paths(k={CAMPAIGN_K}): "
        f"{paths.shape[0]} rows")
    golden_dijkstra(g, queries, direct["free-flow"][0],
                    direct["free-flow"][2], f"{tag} golden")

    per_round = [kernel_vs_plain(name, call, f"{tag} kernel")
                 for name, call in zip(("free-flow", "diff"), recorded)]
    targets0 = oracle.targets_wr[0]
    resident = int(oracle.fm.numel())
    # what the host phase is held to: the direct answers of each round,
    # the -k 8 rounds' parts.csv and paths.csv
    ref = {"g": g, "queries": queries, "diff_path": diff_path,
           "xy": os.path.join(outdir, "road.xy"),
           "scen": os.path.join(outdir, "road.scen"),
           "answers": {name: (np.asarray(plen), np.asarray(fin))
                       for name, (_, plen, fin) in direct.items()},
           "parts_k": os.path.join(out_k, "parts.csv"),
           "paths": os.path.join(out_k, "paths.csv"),
           "round_s": dict(zip(names, round_s)),
           "direct": direct,
           "walk_kernel_ms": {x["round"]: x["kernel_ms"] for x in per_round}}
    probe.oracles.clear()
    del recorded
    gc.collect()
    torch.cuda.empty_cache()
    cmp = build_kernels_vs_plain(f"{tag} build-kernel", g, kind,
                                 cpd.pick_build_kernel(g, "auto")[1],
                                 targets0)
    return {"launches": launches, "multi_launches": multi_launches,
            **headline(per_round[0]),
            "max_abs_err": max(x["max_abs_err"] for x in per_round),
            "build_s": build_s, "save_s": save_s,
            "load_s": probe.seconds["load"], "fused_round_s": fused_s,
            "round_s": round_s, "index_bytes": disk,
            "resident_bytes": resident, "rounds": per_round}, cmp, \
        build_counts, ref, oracle


# -------------------------------------------------------------- serving path

def multi_vs_plain(name: str, call, tag: str) -> dict:
    """K4 on one recorded ``cuda_walk_multi`` call's exact inputs against
    the plain multi walk (equal element by element or raise); time the
    bare launch, the padded transposed weights' build (once a call), the
    plain walk, and D single walk launches on the same lanes (the walks
    the fused one replaces); the bound from this run's data (distinct fm,
    pair and weight-row sectors)."""
    a, kw = call
    dg, fm, t_rows, s, t, w_pads = a
    valid, pair = kw["valid"], kw["pair"]
    d, q = w_pads.shape[0], s.shape[0]
    ker = cw.cuda_walk_multi(*a, **kw)
    plain = table_search_multi(*a, **kw)
    steps, budget = walk_budget(dg.n, -1, int(kw.get("max_steps", 0)), 8)
    w_t = weights_t(w_pads, weights_width(d))
    out = (torch.empty_like(ker[0]), torch.empty_like(ker[1]),
           torch.empty_like(ker[2]))

    def launch():
        cw.launch_walk_multi(fm, dg.n, t_rows, s, t, valid, pair, w_t,
                             steps, budget, *out)

    pairs = [walk_pairs(dg, w_pads[i]) for i in range(d)]
    singles_out = [(torch.empty_like(s), torch.empty_like(s),
                    torch.empty_like(valid)) for _ in range(d)]

    def singles():
        for i in range(d):
            cw.launch_walk(fm, dg.n, t_rows, s, t, valid, pairs[i], steps,
                           budget, *singles_out[i])

    launch()
    singles()
    torch.cuda.synchronize()
    for x, y, b, label in zip(ker, plain, out, ("cost", "plen", "fin")):
        for got, what in ((x, "kernel"), (b, "bare launch")):
            if got.dtype != y.dtype or not torch.equal(got, y):
                raise AssertionError(f"{tag} {name}: {what} {label} differs "
                                     "from the plain multi walk on "
                                     f"{int((got != y).sum())} entries")
    for i, (c1, p1, f1) in enumerate(singles_out):
        if not (torch.equal(c1, ker[0][i]) and torch.equal(p1, ker[1])
                and torch.equal(f1, ker[2])):
            raise AssertionError(f"{tag} {name}: row {i} differs from the "
                                 "single walk on its weights")
    kernel_ms = time_bare(launch, KERNEL_REPS)
    w_t_ms = time_cuda(lambda: weights_t(w_pads, weights_width(d)),
                       KERNEL_REPS)
    singles_ms = time_bare(singles, KERNEL_REPS)
    plain_ms = time_cuda(lambda: table_search_multi(*a, **kw), PLAIN_REPS)
    sum_plen = int(ker[1][valid].long().sum())
    max_plen = int(ker[1].max()) if q else 0
    fm_sec, pair_sec, w_sec = touched_sectors(call, ker[1], d=d)
    # lanes in (rows, s, t int32 + valid) once, out (d costs, plen, fin)
    nbytes = (fm_sec + pair_sec + w_sec) * SECTOR + q * 13 + q * (4 * d + 5)
    ops = (5 + d) * sum_plen + 4 * q
    bound_ms, bound_by = bound(nbytes, ops)
    err = int((ker[0].long() - plain[0].long()).abs().max()) if q else 0
    log(f"{tag} K4 {name}: D={d} lanes={q} valid={int(valid.sum())} "
        f"sum_plen={sum_plen} max_plen={max_plen} kernel {kernel_ms:.4f} "
        f"ms ({w_t.shape[1] // 4} weight vectors an edge; the padded "
        f"transposed weights' build {w_t_ms:.4f} ms), {d} single walk "
        f"launches on the same lanes {singles_ms:.4f} "
        f"ms ({singles_ms / kernel_ms:.2f}x), plain {plain_ms:.4f} ms, "
        f"bound {bound_ms:.5f} ms by {bound_by} ({nbytes} B: {fm_sec} fm + "
        f"{pair_sec} pair + {w_sec} weight sectors) — bit-identical")
    return {"round": name, "d": d, "lanes": q, "sum_plen": sum_plen,
            "max_plen": max_plen, "ms": kernel_ms, "weights_t_ms": w_t_ms,
            "singles_ms": singles_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "bytes": nbytes, "max_abs_err": err}


def plain_chunk(rec: torch.Tensor, limit: int) -> tuple[torch.Tensor, int]:
    """The JAX loop on plain sweeps (``pd.sweep_records``): every row of
    the chunk the same sweeps, while some successor moved, at most
    ``limit``. Returns ``(records, sweeps)``."""
    x = torch.arange(rec.shape[1], dtype=torch.int32, device=rec.device)
    changed, i = bool((rec[..., 0] != x).any()), 0
    while changed and i < limit:
        rec, changed = pd.sweep_records(rec)
        i += 1
    return rec, i


def plant_cycles(g, fm_rows: torch.Tensor, r2: int, r3: int) -> torch.Tensor:
    """A corrupted copy of first-move rows: row ``r2`` with a 2-cycle
    ``a -> b -> a`` and row ``r3`` with a 3-cycle ``a -> b -> c -> a``
    along real edges (every weight positive), at the first such nodes.
    A 2-cycle settles into two fixed points whose cost and plen grow
    every sweep (a live row); a 3-cycle never settles (2^k steps never
    close it), so the chunk runs every sweep of its limit."""
    nbr, eid = g.ell("out")
    out: dict[int, set[int]] = {}
    for a, b in zip(g.src.tolist(), g.dst.tolist()):
        if a != b:
            out.setdefault(a, set()).add(b)
    two = next((a, b) for a in sorted(out) for b in sorted(out[a])
               if a in out.get(b, ()))
    three = next((a, b, c) for a in sorted(out) for b in sorted(out[a])
                 for c in sorted(out.get(b, ())) if c != a
                 and a in out.get(c, ()))
    fm = fm_rows.clone()
    for r, cyc in ((r2, two), (r3, three)):
        for i, a in enumerate(cyc):
            b = cyc[(i + 1) % len(cyc)]
            fm[r, a] = int(np.flatnonzero((nbr[a] == b) & (eid[a] < g.m))[0])
    return fm


class WidePath:
    """Within the block, the shape rule answers "no cluster holds a row":
    ``doubled_tables_multi`` takes the wide path whatever the shape."""

    def __enter__(self):
        self._real = cd.rows_plan
        cd.rows_plan = lambda n, d, device: (0, 0, 0, 0)
        return self

    def __exit__(self, *exc):
        cd.rows_plan = self._real


def tables_vs_plain(dg, fm_rows, targets, w_pads, max_len: int, tag: str,
                    what: str, order: torch.Tensor, wide: bool = False
                    ) -> dict:
    """``pd.doubled_tables_multi`` with the records in ``order`` (the
    wrapper's rule: the on-chip doubling and the rerun of live rows, or
    with ``wide`` the wide path's sweep loop) against the JAX loop on
    plain sweeps, equal or raise; the launches it made."""
    n, d = fm_rows.shape[1], w_pads.shape[0]
    before = (cd.doubling_rows.launches, cd.doubling_sweep.launches,
              pd.doubled_tables_multi.sweeps)
    if wide:
        with WidePath():
            got = pd.doubled_tables_multi(dg, fm_rows, targets, w_pads,
                                          max_len=max_len, order=order)
    else:
        got = pd.doubled_tables_multi(dg, fm_rows, targets, w_pads,
                                      max_len=max_len, order=order)
    torch.cuda.synchronize()
    launched = (cd.doubling_rows.launches - before[0],
                cd.doubling_sweep.launches - before[1])
    sweeps = pd.doubled_tables_multi.sweeps - before[2]
    rec, k = plain_chunk(pd.initial_records(dg, fm_rows, w_pads, order),
                         pd.n_sweeps(n, max_len))
    want = pd._finish(rec, targets, d, order)
    del rec
    for a, b, label in zip(got, want, ("costs", "plen")):
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError(f"{tag} K5 {what}: the tables' {label} "
                                 "differ from the JAX loop on plain sweeps")
    if sweeps != k:
        raise AssertionError(f"{tag} K5 {what}: {sweeps} sweeps, the JAX "
                             f"loop runs {k}")
    err = int((got[0].long() - want[0].long()).abs().max())
    log(f"{tag} K5 {what} (D={d}, {fm_rows.shape[0]} rows, max_len "
        f"{max_len}): tables equal the JAX loop on plain sweeps, {k} sweeps; "
        f"launches: on-chip {launched[0]}, wide sweep {launched[1]}")
    return {"what": what, "d": d, "rows": fm_rows.shape[0],
            "max_len": max_len, "sweeps": k, "rows_launches": launched[0],
            "sweep_launches": launched[1], "max_abs_err": err}


def max_abs_diff(a: torch.Tensor, b: torch.Tensor, rows: int = 256) -> int:
    """The largest |a - b| over int32 tensors, in int64, a slab of
    ``rows`` rows at a time (a whole chunk in int64 would double it)."""
    return max((int((a[i:i + rows].long() - b[i:i + rows].long()).abs()
                    .max()) for i in range(0, len(a), rows)), default=0)


def sweep_loop(rec: torch.Tensor, limit: int, tag: str, what: str,
               plain: bool) -> dict:
    """The wide path's sweep loop on the records ``rec`` (consumed: the
    loop swaps buffers with it), until a sweep moves no successor or
    ``limit`` sweeps: each sweep's launch equal to the plain sweep and
    its flag to the plain one, or raise; each sweep's bare launch timed
    by CUDA events beside ``torch.gather`` of its records (the one
    PyTorch call that computes a sweep's gather) and, with ``plain``,
    the plain sweep."""
    out = torch.empty_like(rec)
    flag = torch.zeros(1, dtype=torch.int32, device=rec.device)
    ms, plain_ms, gather_ms = [], [], []
    changed, i, err = True, 0, 0
    while changed and i < limit:
        want, changed = pd.sweep_records(rec)
        flag.zero_()
        cd.doubling_sweep(rec, out, flag)
        torch.cuda.synchronize()
        if not torch.equal(out, want) or bool(flag.item()) != changed:
            raise AssertionError(f"{tag} K5 wide sweep {i} ({what}) differs "
                                 "from the plain sweep")
        err = max(err, max_abs_diff(out, want))
        del want
        idx = rec[..., 0].long()[..., None].expand_as(rec)
        ms.append(time_bare(lambda: cd.launch_sweep(rec, out, flag),
                            KERNEL_REPS))
        if plain:
            plain_ms.append(time_cuda(lambda: pd.sweep_records(rec),
                                      PLAIN_REPS))
        gather_ms.append(time_cuda(lambda: torch.gather(rec, 1, idx),
                                   KERNEL_REPS))
        del idx
        rec, out = out, rec
        i += 1
    return {"sweeps": i, "ms_by_sweep": ms, "plain_ms_by_sweep": plain_ms,
            "gather_ms_by_sweep": gather_ms, "max_abs_err": err}


def doubling_vs_plain(g, dg, fm_rows: torch.Tensor, targets: torch.Tensor,
                      w_pads: torch.Tensor, order: torch.Tensor, tag: str,
                      timed: bool) -> dict:
    """K5 on one chunk of rows, the records in ``order`` (the oracle's
    Z-order), against its plain versions, equal or raise: the on-chip
    doubling (``doubling_rows``) against ``double_rows`` at sweep caps
    1, 2, 3 and at convergence (on its own count; at cap 3 also on a
    fixed count); the wrapper's tables against the JAX loop on plain
    sweeps at convergence, and on a corrupted copy of the rows (a
    2-cycle, a 3-cycle) at max_len 0 and a cut, on chip and on the wide
    path. A shape the rule sends to the wide path is compared there
    only. ``timed``: the whole on-chip doubling of the chunk (CUDA
    events, the records restored before each launch), beside the wide
    path's sweep loop (each sweep's launch, summed), the plain
    ``double_rows``, and ``torch.gather`` of each sweep's records
    (summed), all on the same records; then the on-chip doubling, the
    sweep loop and the gathers on the records by node id (the layout of
    the first versions) as a side column. The wide sweep also equals the
    plain sweep, sweep by sweep, on both layouts."""
    r, n = fm_rows.shape
    d = w_pads.shape[0]
    limit = pd.n_sweeps(n)
    plan = cd.rows_plan(n, d, fm_rows.device)
    res = {"rows": r, "d": d, "plan": {"blocks": plan[0],
                                       "threads": plan[1],
                                       "nodes": plan[2],
                                       "smem": plan[3]}}
    err = 0
    rec0 = pd.initial_records(dg, fm_rows, w_pads, order)
    if plan[0]:
        caps = []
        for cap, fixed in ([(c, False) for c in K5_CAPS]
                           + [(limit, False), (K5_CAPS[-1], True)]):
            got = rec0.clone()
            settled, live = cd.doubling_rows(got, d, cap, fixed)
            want = rec0.clone()
            s_want, l_want = pd.double_rows(want, d, cap, fixed)
            torch.cuda.synchronize()
            if not (torch.equal(got, want) and torch.equal(settled, s_want)
                    and torch.equal(live, l_want)):
                raise AssertionError(
                    f"{tag} K5 D={d} cap {cap} fixed={fixed}: the on-chip "
                    "doubling differs from the plain double_rows")
            err = max(err, max_abs_diff(got, want))
            caps.append({"cap": cap, "fixed": fixed,
                         "max_settled": int(settled.max()),
                         "live_rows": int(live.sum())})
            del got, want
        res["caps"] = caps
        log(f"{tag} K5 D={d} on {r} rows x {n} nodes, {plan[0]} block(s) a "
            f"row ({plan[1]} threads, {plan[2]} nodes, {plan[3]} shared "
            f"bytes a block): the on-chip doubling equals double_rows at "
            f"caps {[c['cap'] for c in caps]} (fixed at the last)")
    else:
        log(f"{tag} K5 D={d} on {r} rows x {n} nodes: the shape rule takes "
            "the wide path")
    cyc = plant_cycles(g, fm_rows, 1, 2)
    res["tables"] = [tables_vs_plain(dg, fm_rows, targets, w_pads, 0, tag,
                                     "chunk", order)]
    for max_len in (0, K5_CYCLE_CUT):
        res["tables"].append(tables_vs_plain(dg, cyc, targets, w_pads,
                                             max_len, tag, "cycles", order))
    res["tables"].append(tables_vs_plain(dg, cyc, targets, w_pads, 0, tag,
                                         "cycles, wide path", order,
                                         wide=True))
    if plan[0] and res["tables"][1]["rows_launches"] != 2:
        raise AssertionError(f"{tag} K5 D={d}: the live 2-cycle row was "
                             "not doubled again for the chunk's sweeps")
    res["max_abs_err"] = max([err] + [x["max_abs_err"]
                                      for x in res["tables"]])
    if not timed:
        return res
    # the whole doubling of the chunk on chip, the records restored before
    # each launch (outside the timed span)
    work = torch.empty_like(rec0)
    settled = torch.empty(r, dtype=torch.int32, device=rec0.device)
    live = torch.empty(r, dtype=torch.bool, device=rec0.device)
    rows_ms = time_restored(lambda: work.copy_(rec0),
                            lambda: cd.launch_rows(work, d, limit, False,
                                                   settled, live),
                            KERNEL_REPS)
    # the same launch with the records by node id, and with no sweep
    # (the row's load and store alone)
    rec_ids = pd.initial_records(dg, fm_rows, w_pads)
    rows_ids_ms = time_restored(lambda: work.copy_(rec_ids),
                                lambda: cd.launch_rows(work, d, limit, False,
                                                       settled, live),
                                KERNEL_REPS)
    io_ms = time_restored(lambda: work.copy_(rec0),
                          lambda: cd.launch_rows(work, d, 0, True, settled,
                                                 live), KERNEL_REPS)
    plain_ms = time_cuda(lambda: pd.double_rows(rec0.clone(), d, limit),
                         PLAIN_REPS)
    del work
    # the wide path's sweep loop and the gathers on the records the
    # kernel doubles, then on the records by node id
    z = sweep_loop(rec0, limit, tag, f"D={d}, {r} rows", plain=True)
    del rec0
    ids = sweep_loop(rec_ids, limit, tag, f"D={d}, {r} rows by node id",
                     plain=False)
    del rec_ids
    if z["sweeps"] != ids["sweeps"]:
        raise AssertionError(f"{tag} K5 D={d}: {z['sweeps']} sweeps in "
                             f"Z-order, {ids['sweeps']} by node id")
    i, ms, gather_ms = z["sweeps"], z["ms_by_sweep"], z["gather_ms_by_sweep"]
    # the chunk's compact records read once and written once; a compare
    # and 1 + d adds an entry a sweep
    nbytes = 2 * r * n * (2 + d) * 4
    bound_ms, bound_by = bound(nbytes, i * r * n * (2 + d))
    sweep_bound_ms, sweep_bound_by = bound(nbytes, r * n * (2 + d))
    res.update(sweeps=i, ms=rows_ms, ids_ms=rows_ids_ms, io_ms=io_ms,
               plain_ms=plain_ms, library_ms=sum(gather_ms),
               bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
               sweep_loop_ms=sum(ms),
               ids_library_ms=sum(ids["gather_ms_by_sweep"]),
               ids_sweep_loop_ms=sum(ids["ms_by_sweep"]),
               max_abs_err=max(res["max_abs_err"], z["max_abs_err"],
                               ids["max_abs_err"]),
               sweep={"ms": sum(ms) / i,
                      "plain_ms": sum(z["plain_ms_by_sweep"]) / i,
                      "library_ms": sum(gather_ms) / i,
                      "bound_ms": sweep_bound_ms,
                      "bound_by": sweep_bound_by, "bytes": nbytes,
                      "ms_by_sweep": ms, "gather_ms_by_sweep": gather_ms,
                      "ids_ms_by_sweep": ids["ms_by_sweep"],
                      "ids_gather_ms_by_sweep": ids["gather_ms_by_sweep"]})
    log(f"{tag} K5 D={d} on {r} rows x {n} nodes, {i} sweeps, the same "
        f"Z-order records for each: the on-chip doubling {rows_ms:.4f} ms "
        f"(no sweep, the load and store alone {io_ms:.4f} ms), the wide "
        f"sweep loop {sum(ms):.4f} ms (a sweep {sum(ms) / i:.4f} ms: "
        + ", ".join(f"{x:.4f}" for x in ms) + "), torch.gather of each "
        f"sweep's records {sum(gather_ms):.4f} ms in all, plain double_rows "
        f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms by {bound_by} "
        f"({nbytes} B); by node id: the on-chip doubling {rows_ids_ms:.4f} "
        f"ms, the wide sweep loop {res['ids_sweep_loop_ms']:.4f} ms, "
        f"torch.gather {res['ids_library_ms']:.4f} ms; the wide sweep "
        "equals the plain sweep, sweep by sweep, on both")
    return res


def serving_path(oracle, ref: dict) -> tuple[dict, dict[str, int]]:
    """The oracle's serving methods on the campaign cell at full size:
    ``query_multi`` (D = 2 and 5), ``query_mat``, ``build(store_dists=
    True)`` + ``query_dist``, ``prepare_weights`` + ``query_table`` (free
    flow, diff), ``prepare_weights_multi`` + ``query_table_multi`` (D =
    2); every table freed before the next. Counts zeroed before, read
    after (every doubling on chip); then every answer held to the walk's
    and K4/K5 to their plain versions, and ``ops.doubled_tables_multi``
    at D = 14 on worker 0's first rows (a row past the largest cluster:
    the wide path) held to the JAX loop on plain sweeps."""
    tag = "[serving]"
    g, queries, n = ref["g"], ref["queries"], len(ref["queries"])
    w_diff = g.weights_with_diff(ref["diff_path"])
    ws2 = [None, w_diff]
    ws_all = ws2 + [g.weights_with_diff(synth_diff(g, frac=0.1, seed=sd))
                    for sd in SERVING_DIFF_SEEDS + WIDE_DIFF_SEEDS]
    ws5 = ws_all[:5]
    rng = np.random.default_rng(SEED + 3)
    sources = rng.integers(0, g.n, SERVING_MAT_ROWS)
    mat_targets = rng.integers(0, g.n, (SERVING_MAT_ROWS,
                                        SERVING_MAT_TARGETS))
    w, r = oracle.targets_wr.shape
    steps: dict[str, dict] = {}

    def step(name, fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        steps[name] = {"s": dt, "peak_bytes": peak}
        log(f"{tag} {name}: {dt:.4f} s, peak device memory "
            f"{peak / 2**30:.2f} GiB")
        return out

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    def pads(ws):
        return torch.as_tensor(g.padded_weights_multi(ws), dtype=torch.int32,
                               device=oracle.device)

    wide_fm = oracle.fm[0, :SWEEP_ROWS_WIDE]
    wide_targets = torch.as_tensor(oracle.targets_wr[0, :SWEEP_ROWS_WIDE],
                                   dtype=torch.int32, device=oracle.device)
    wide_pads = pads(ws_all[:K5_WIDE_D])
    order = pd.record_order(g, oracle.device)
    recorded: list = []
    real_multi = sharded.cuda_walk_multi

    def recording_multi(*a, **kw):
        recorded.append((a, kw))
        return real_multi(*a, **kw)

    budget_was = os.environ.get("DOS_TABLE_BUDGET_GB")
    os.environ["DOS_TABLE_BUDGET_GB"] = str(SERVING_TABLE_BUDGET_GB)
    log(f"{tag} DOS_TABLE_BUDGET_GB={SERVING_TABLE_BUDGET_GB} for this "
        f"phase (default 8): tables need {oracle.table_memory_bytes()} B "
        f"single, {w * r * g.n * 12} B fused at D=2; fm [{w}, {r}, {g.n}]")
    sweeps: dict[str, int] = {}
    t_bytes: dict[str, int] = {}
    try:
        zero_launches()
        sharded.cuda_walk_multi = recording_multi
        try:
            walk = {"free-flow": step("query free-flow",
                                      lambda: oracle.query(queries)),
                    "diff": step("query diff", lambda: oracle.query(
                        queries, w_query=w_diff))}
            multi2 = step("query_multi D=2",
                          lambda: oracle.query_multi(queries, ws2))
            multi5 = step("query_multi D=5",
                          lambda: oracle.query_multi(queries, ws5))
        finally:
            sharded.cuda_walk_multi = real_multi
        mats = step(f"query_mat x{SERVING_MAT_ROWS}", lambda: [
            oracle.query_mat(int(sv), tg)
            for sv, tg in zip(sources, mat_targets)])
        with KindProbe() as kinds:
            step("build(store_dists=True)",
                 lambda: oracle.build(store_dists=True))
        t_bytes["dists"] = oracle.dists.numel() * oracle.dists.element_size()
        dist = step("query_dist", lambda: oracle.query_dist(queries))
        oracle.dists = None
        free()
        tabled, lookup_ms = {}, {}
        r_arr, s_arr, _, valid, _ = oracle.route(queries)
        for name, wq in (("free-flow", None), ("diff", w_diff)):
            before = pd.doubled_tables_multi.sweeps
            tables = step(f"prepare_weights {name}",
                          lambda wq=wq: oracle.prepare_weights(wq))
            sweeps[name] = pd.doubled_tables_multi.sweeps - before
            t_bytes[name] = sum(x.numel() * x.element_size() for x in tables)
            oracle.query_table(tables, queries)     # warm, as the walk is
            tabled[name] = step(f"query_table {name}",
                                lambda t=tables: oracle.query_table(
                                    t, queries))
            # the lookup's device time on the routed lanes (CUDA events),
            # beside the walk kernel's on the same lanes
            rows_d, s_d, v_d = sharded._flat_lanes(tables[1], r_arr, s_arr,
                                                   valid)[1:]
            flat = [x.view(w * r, g.n) for x in tables]
            lookup_ms[name] = time_cuda(lambda f=flat: pd.lookup_tables(
                *f, rows_d, s_d, v_d), KERNEL_REPS)
            del tables, flat
            free()
        before = pd.doubled_tables_multi.sweeps
        tables = step("prepare_weights_multi D=2",
                      lambda: oracle.prepare_weights_multi(ws2))
        sweeps["multi D=2"] = pd.doubled_tables_multi.sweeps - before
        t_bytes["multi D=2"] = sum(x.numel() * x.element_size()
                                   for x in tables)
        oracle.query_table_multi(tables, queries)   # warm
        tabled_multi = step("query_table_multi D=2",
                            lambda: oracle.query_table_multi(tables,
                                                             queries))
        launches = {"walk": cw.cuda_walk_batch.launches,
                    "multi": cw.cuda_walk_multi.launches,
                    "rows": cd.doubling_rows.launches,
                    "sweep": cd.doubling_sweep.launches}
        build_counts = check_build_launches("serving", tag)
        del tables
        free()
    finally:
        if budget_was is None:
            os.environ.pop("DOS_TABLE_BUDGET_GB", None)
        else:
            os.environ["DOS_TABLE_BUDGET_GB"] = budget_was
    kinds.check("serving", tag)
    # one on-chip launch a chunk of each prepare, plus one a chunk whose
    # live rows ran short of the chunk's sweeps
    chunks = sum(-(-r // c) for c in (2048, 2048, 1024)) * w
    reruns = launches["rows"] - chunks
    log(f"{tag} launches in the phase's run: walk {launches['walk']} (2 "
        f"queries + {SERVING_MAT_ROWS} mat rows), fused walk "
        f"{launches['multi']}, on-chip doubling {launches['rows']} ({chunks} "
        f"chunks + {reruns} reruns of live rows), wide doubling sweep "
        f"{launches['sweep']}; sweeps {sweeps}; table bytes {t_bytes}")
    if launches["multi"] != 2:
        raise AssertionError(f"{tag} {launches['multi']} fused walk "
                             "launches, not one a query_multi call")
    if launches["walk"] != 2 + SERVING_MAT_ROWS:
        raise AssertionError(f"{tag} {launches['walk']} walk launches, not "
                             "one a query and one a mat row")
    if any(sweeps[k] != v for k, v in EXPECTED_SWEEPS.items()):
        raise AssertionError(f"{tag} doubling sweeps {sweeps}, expected "
                             f"{EXPECTED_SWEEPS}")
    if reruns < 0 or reruns > chunks:
        raise AssertionError(f"{tag} {launches['rows']} on-chip doubling "
                             f"launches for {chunks} chunks")
    if launches["sweep"] != 0:
        raise AssertionError(f"{tag} {launches['sweep']} wide sweep launches: "
                             "the cell's rows fit a cluster")

    # every answer against the walk's
    def same(got, want, what):
        for a, b in zip(got, want):
            if not np.array_equal(a, b):
                raise AssertionError(f"{tag} {what} differs from the walk")

    for i, name in enumerate(("free-flow", "diff")):
        same((multi2[0][i], multi2[1], multi2[2]), walk[name],
             f"query_multi D=2 row {name}")
    for i, wq in enumerate(ws5):
        want = (walk["free-flow"] if i == 0 else walk["diff"] if i == 1
                else oracle.query(queries, w_query=wq))
        same((multi5[0][i], multi5[1], multi5[2]), want,
             f"query_multi D=5 row {i}")
    log(f"{tag} query_multi at D=2 and D=5 equals D single queries, query "
        "by query")
    mat_q = np.concatenate([np.stack([np.full(SERVING_MAT_TARGETS, sv), tg],
                                     axis=1)
                            for sv, tg in zip(sources, mat_targets)])
    mc, _, mf = oracle.query(mat_q)
    same((np.concatenate([c for c, _ in mats]),
          np.concatenate([f for _, f in mats])), (mc, mf), "query_mat")
    mat_ms = steps[f"query_mat x{SERVING_MAT_ROWS}"]["s"] * 1e3 \
        / SERVING_MAT_ROWS
    log(f"{tag} query_mat: {SERVING_MAT_ROWS} rows x {SERVING_MAT_TARGETS} "
        f"targets equal query on the same pairs; {mat_ms:.4f} ms a row")
    cost_ff, _, fin_ff = walk["free-flow"]
    if not (np.array_equal(dist[1], fin_ff)
            and np.array_equal(dist[0][fin_ff], cost_ff[fin_ff])):
        raise AssertionError(f"{tag} query_dist differs from the free-flow "
                             "walk")
    golden_dijkstra(g, queries, dist[0], dist[1], f"{tag} query_dist golden")
    for name in ("free-flow", "diff"):
        same(tabled[name], walk[name], f"query_table {name}")
    same(tabled_multi, multi2, "query_table_multi D=2")
    log(f"{tag} query_dist equals the free-flow walk where finished; "
        "query_table (free flow, diff) equals query; query_table_multi "
        "equals query_multi")

    # a shape past the largest cluster: the wide path's tables against
    # the JAX loop on plain sweeps
    k5_main_wide = tables_vs_plain(oracle.dg, wide_fm, wide_targets,
                                   wide_pads, 0, tag,
                                   f"D={K5_WIDE_D} past the largest cluster",
                                   order)
    if not (k5_main_wide["rows_launches"] == 0
            and k5_main_wide["sweep_launches"] == k5_main_wide["sweeps"]
            >= 1):
        raise AssertionError(f"{tag} D={K5_WIDE_D} did not take the wide "
                             f"path: {k5_main_wide}")
    # K4 at D = 8, 9, 16, 17 on the D=2 call's lanes (comparisons, not
    # launches of the main path)
    extra = [(recorded[0][0][:5] + (pads(ws_all[:d]),), recorded[0][1])
             for d in K4_WIDE_DS]
    per_call = [multi_vs_plain(name, call, tag) for name, call in zip(
        ("D=2", "D=5") + tuple(f"D={d}" for d in K4_WIDE_DS),
        recorded + extra)]
    del recorded, extra
    free()
    k5 = doubling_vs_plain(g, oracle.dg, oracle.fm[0, :SWEEP_ROWS],
                           torch.as_tensor(oracle.targets_wr[0, :SWEEP_ROWS],
                                           dtype=torch.int32,
                                           device=oracle.device),
                           oracle.dg.w_pad[None], order, tag, timed=True)
    free()
    k5_wide = [doubling_vs_plain(g, oracle.dg, wide_fm, wide_targets,
                                 pads(ws_all[:d]), order, tag, timed=False)
               for d in (5, 7)]
    free()
    qps = {}
    for name in ("free-flow", "diff"):
        walk_qps = n / steps[f"query {name}"]["s"]
        look_qps = n / steps[f"query_table {name}"]["s"]
        prep = steps[f"prepare_weights {name}"]["s"]
        gap = 1 / walk_qps - 1 / look_qps
        walk_ms = ref["walk_kernel_ms"][name]
        dev_gap = (walk_ms - lookup_ms[name]) * 1e-3 / n
        qps[name] = {"walk_qps": walk_qps, "lookup_qps": look_qps,
                     "prepare_s": prep, "sweeps": sweeps[name],
                     "breakeven_queries": prep / gap if gap > 0 else None,
                     "walk_kernel_ms": walk_ms,
                     "lookup_device_ms": lookup_ms[name],
                     "device_breakeven_queries": (prep / dev_gap
                                                  if dev_gap > 0 else None)}
        log(f"{tag} {name}: prepare {prep:.3f} s ({sweeps[name]} sweeps "
            f"over {w} workers x {-(-r // 2048)} chunks), lookup "
            f"{look_qps:.1f} q/s vs walk {walk_qps:.1f} q/s (host clock, "
            f"{n} queries): break-even "
            f"{qps[name]['breakeven_queries']} queries; on the device the "
            f"lookup takes {lookup_ms[name]:.4f} ms and the walk kernel "
            f"{walk_ms:.4f} ms on the same lanes: break-even "
            f"{qps[name]['device_breakeven_queries']} queries")
    fused_s = steps["query_multi D=2"]["s"]
    seq_s = steps["query free-flow"]["s"] + steps["query diff"]["s"]
    log(f"{tag} query_multi D=2 {fused_s:.4f} s vs two queries "
        f"{seq_s:.4f} s (host clock)")
    return {"launches": launches, "steps": steps, "sweeps": sweeps,
            "reruns": reruns, "table_bytes": t_bytes, "k4": per_call,
            "k5": k5, "k5_wide": k5_wide, "k5_main_wide": k5_main_wide,
            "qps": qps, "mat_ms_per_row": mat_ms,
            "fused_s": fused_s, "two_queries_s": seq_s}, build_counts


# ----------------------------------------------------------------- host path

def nvidia_smi(query: str, what: str = "--query-gpu") -> list[list[str]]:
    """Rows of ``nvidia-smi <what>=<query> --format=csv,noheader,nounits``
    (empty when the tool lists nothing)."""
    out = subprocess.run(
        ["nvidia-smi", f"{what}={query}", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    return [[c.strip() for c in line.split(",")]
            for line in out.stdout.strip().splitlines() if line.strip()]


class MemorySampler:
    """Polls the card's used memory (``nvidia-smi memory.used``, every
    process on it) once a second on a thread; ``peak_mib`` is the most
    seen."""

    def __init__(self, period_s: float = 1.0):
        self.period_s = period_s
        self.peak_mib = 0
        self.samples = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.is_set():
            try:
                used = int(nvidia_smi("memory.used")[0][0])
                self.peak_mib = max(self.peak_mib, used)
                self.samples += 1
            except (subprocess.SubprocessError, OSError, ValueError,
                    IndexError):
                pass
            self._stop.wait(self.period_s)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=120)


class RoundTimer:
    """Times every round the host campaign fans out (``process_query``
    drives a round's batches through ``fan_out`` and waits for them)."""

    def __init__(self):
        self.seconds: list[float] = []
        self._real = process_query.fan_out

    def _timed(self, jobs, fn, *a, **kw):
        t0 = time.perf_counter()
        out = self._real(jobs, fn, *a, **kw)
        self.seconds.append(time.perf_counter() - t0)
        return out

    def __enter__(self):
        process_query.fan_out = self._timed
        return self

    def __exit__(self, *exc):
        process_query.fan_out = self._real


def wait_ready(fifos: dict, procs: dict, nfs: str, t_launch: float,
               deadline_s: float) -> dict:
    """Ping every server until it answers (``transport.fifo.probe``), or
    until one has exited or the deadline passed; returns ``{wid: (pid,
    seconds from launch to its first answer)}``."""
    ready = {}
    deadline = time.perf_counter() + deadline_s
    while (len(ready) < len(fifos) and time.perf_counter() < deadline
           and all(p.poll() is None for p in procs.values())):
        for w, fifo in fifos.items():
            if w in ready or not os.path.exists(fifo):
                continue
            st = fifo_transport.probe("localhost", w, command_fifo=fifo,
                                      nfs=nfs, timeout=5.0)
            if st is not None:
                ready[w] = (st.pid, time.perf_counter() - t_launch)
        time.sleep(0.2)
    return ready


def stop_servers(fifos: dict, procs: dict) -> dict[int, int]:
    """Stop every server: the stop token, then wait for each tracked
    process to exit; one still alive after ``HOST_STOP_S`` is killed.
    Returns ``{wid: exit code}`` (a killed server's is negative)."""
    for fifo in fifos.values():
        wserver.stop_server(fifo)
    deadline = time.perf_counter() + HOST_STOP_S
    for w, proc in procs.items():
        try:
            proc.wait(timeout=max(deadline - time.perf_counter(), 0.1))
        except subprocess.TimeoutExpired:
            log(f"[host] server {w} (pid {proc.pid}) outlived its stop "
                "token; killing it")
            proc.kill()
            proc.wait(timeout=30)
    return {w: proc.returncode for w, proc in procs.items()}


def log_tails(nfs: str) -> None:
    """The end of each worker process's log (tracked launches log to
    ``<nfs>/<session>.log``), for a failed host phase."""
    for name in sorted(os.listdir(nfs)):
        if name.endswith(".log"):
            with open(os.path.join(nfs, name), errors="replace") as f:
                tail = f.read()[-2000:]
            log(f"[host] --- {name} (last 2000 characters) ---\n{tail}")


def read_parts(path: str) -> list[dict]:
    with open(path) as f:
        return list(csv.DictReader(f))


def round_sums(parts: list[dict], expe: int) -> tuple[int, int, int]:
    """(size, plen, finished) summed over one round's worker rows."""
    rows = [p for p in parts if p["expe"] == str(expe)]
    return tuple(sum(int(r[k]) for r in rows)
                 for k in ("size", "plen", "finished"))


def check_build_dump(b: dict, card: str) -> None:
    """A build process's dump: it built on this card and launched the
    relax (K1) and extraction (K2) kernels."""
    c = b["counters"]
    if (b["device"]["name"] != card or b["device"]["type"] != "cuda"
            or c["relax_jacobi.launches"] <= 0
            or c["first_moves.launches"] <= 0):
        raise AssertionError(f"[host] build of worker {b['wid']}: {b}")


def check_serve_dump(sv: dict, card: str, pid: int) -> None:
    """A server's dump: it served from this card with device memory
    allocated, launched the raw walk kernel and walked nothing plain,
    and it is the process that answered the pings."""
    c, d = sv["counters"], sv["device"]
    if (d["name"] != card or d["type"] != "cuda"
            or d["max_memory_allocated"] <= 0
            or c["cuda_walk_batch.launches"] <= 0
            or c["cuda_walk_batch.plain"] != 0 or sv["pid"] != pid):
        raise AssertionError(f"[host] server {sv['wid']}: {sv}")


def compute_apps() -> dict[int, str] | None:
    """``{pid: used MiB}`` of the card's compute processes as
    ``nvidia-smi`` lists them, or None when it cannot be asked."""
    try:
        rows = nvidia_smi("pid,used_memory", "--query-compute-apps")
    except (subprocess.SubprocessError, OSError):
        return None
    return {int(r[0]): r[1] for r in rows if r and r[0].isdigit()}


def build_chunk_vs_plain(tag: str, g, targets, saved) -> dict:
    """One chunk of a build process's targets built again in this
    process, by the build's own chunk function (the relax kernel's loop,
    then the extraction kernel) and by the plain split relaxation and
    the plain extraction: the kernel's distances equal the plain loop's
    after RELAX_CUT steps and at convergence, with its step count, and
    the two tables are byte-equal to each other and to ``saved``, the
    rows the build process wrote for those targets."""
    kind, st = cpd.pick_build_kernel(g, "auto")
    if kind != EXPECTED_KIND["campaign"]:
        raise AssertionError(f"{tag} auto resolved {kind!r}")
    dg = DeviceGraph.from_graph(g, device="cuda")
    csr = cbk.csr_from_ell(dg)
    t = torch.as_tensor(np.asarray(targets, np.int32), device=dg.device)
    t0 = time.perf_counter()
    plain_at, plain_conv, plain_steps = plain_relax_loop(st, t, (RELAX_CUT,))
    d_cut, _ = cbk.jacobi_dist(csr, t, RELAX_CUT)
    same_dist("relax_jacobi", d_cut, plain_at[RELAX_CUT].T,
              f"{tag} cut {RELAX_CUT}")
    d_conv, steps = cbk.jacobi_dist(csr, t)
    if steps != plain_steps:
        raise AssertionError(f"{tag} relax_jacobi: {steps} steps to "
                             f"converge, the plain loop {plain_steps}")
    same_dist("relax_jacobi", d_conv, plain_conv.T, f"{tag} converged")
    fm = sharded.chunk_compute(dg, (kind, st))(t)
    fm_plain = bellman_ford.first_move_from_dist(dg, t, plain_conv.T)
    for name, other in (("the plain build", fm_plain),
                        ("the build process's rows", saved)):
        if not torch.equal(fm, other):
            raise AssertionError(f"{tag} kernel-built fm differs from "
                                 f"{name} on {int((fm != other).sum())} "
                                 "entries")
    log(f"{tag} worker 0's first {len(targets)} targets built here: "
        f"relax_jacobi equal to the plain split relaxation after "
        f"{RELAX_CUT} steps and at convergence ({steps} steps, as the "
        f"plain loop); fm [{len(targets)}, {g.n}] by K1 + K2 byte-equal to "
        "the plain relax loop + plain extraction and to the rows worker "
        f"0's build process wrote ({time.perf_counter() - t0:.1f} s)")
    return {"targets": len(targets), "steps": steps}


def host_path(outdir: str, ref: dict) -> tuple[dict, dict[str, int], dict]:
    """The reference's own pipeline on the card: ``make_cpds --backend
    host`` (one ``worker.build`` process a worker) → ``make_fifos`` (one
    resident ``worker.server`` process a worker) → ``process_query``
    over their FIFOs, on the campaign's inputs partitioned ``mod`` over
    8 workers. Returns the raw walk's host entry, the build kernels'
    launches summed over the build processes' dumps, and what the heal
    phase works on: the conf, its index, the controller, the servers'
    ``parts.csv`` rows and ``paths.csv`` in query order."""
    tag = "[host]"
    g, queries = ref["g"], ref["queries"]
    w = HOST_WORKERS
    dc = DistributionController("mod", w, w, g.n)
    index = os.path.join(outdir, "host-index")
    nfs = os.path.join(outdir, "host-nfs")
    os.makedirs(nfs)
    conf = os.path.join(outdir, "host-conf.json")
    with open(conf, "w") as f:
        json.dump({"workers": ["localhost"] * w, "partmethod": "mod",
                   "partkey": w, "outdir": index, "nfs": nfs,
                   "projectdir": ROOT, "xy_file": ref["xy"],
                   "scenfile": ref["scen"],
                   "diffs": ["-", ref["diff_path"]]}, f)
    rows = [dc.n_owned(x) for x in range(w)]
    log(f"{tag} conf: partmethod mod, partkey {w}, {w} x localhost; rows "
        f"per worker {rows}: int8 shards of {rows[0] * g.n} B each, "
        f"{sum(rows) * g.n} B in all; servers run as tracked "
        "subprocesses, their command FIFOs under this run's directory")
    card = torch.cuda.get_device_name(0)
    old_timeout = os.environ.get("DOS_SEND_TIMEOUT_S")
    os.environ["DOS_SEND_TIMEOUT_S"] = str(HOST_SEND_TIMEOUT_S)
    # the fleet's FIFOs live in this run's directory, not at the fixed
    # /tmp/worker<w>.fifo another checkout on the machine may be using:
    # make_fifos passes each server its path, the head sends to it
    fifos = {x: os.path.join(outdir, f"worker{x}.fifo") for x in range(w)}
    fifo_names = (make_fifos.command_fifo_path,
                  process_query.command_fifo_path)
    make_fifos.command_fifo_path = process_query.command_fifo_path = \
        fifos.__getitem__
    build_dump = os.path.join(outdir, "host-build")
    serve_dump = os.path.join(outdir, "host-serve")
    out_rounds = os.path.join(outdir, "host-rounds")
    out_k = os.path.join(outdir, f"host-k{CAMPAIGN_K}")
    procs: dict = {}
    exits: dict[int, int] = {}
    apps: dict[int, str] | None = None
    try:
        with MemorySampler() as mem:
            t0 = time.perf_counter()
            rcs = [make_cpds.main(["-c", conf, "--backend", "host",
                                   "--chunk", str(CHUNK), "--metrics-dump",
                                   build_dump])]
            make_s = time.perf_counter() - t0
            try:
                t_launch = time.perf_counter()
                # make_fifos.main's launch, tracked even where tmux
                # exists: this process stops each server and reads its
                # exit code
                procs = dict(make_fifos.launch_servers(
                    ClusterConfig.load(conf), conf,
                    metrics_dump=serve_dump, track=True))
                ready = wait_ready(fifos, procs, nfs, t_launch,
                                   HOST_READY_S)
                if len(ready) != w:
                    raise AssertionError(
                        f"{tag} servers {sorted(set(fifos) - set(ready))} "
                        f"did not answer a ping within {HOST_READY_S} s "
                        "(exit codes "
                        f"{ {x: p.poll() for x, p in procs.items()} })")
                pids = {x: p.pid for x, p in procs.items()}
                if {x: pid for x, (pid, _) in ready.items()} != pids:
                    raise AssertionError(f"{tag} the pings were answered by "
                                         f"{ready}, not the servers {pids}")
                with RoundTimer() as rt:
                    rcs.append(process_query.main(["-c", conf, "-o",
                                                   out_rounds]))
                    rcs.append(process_query.main(
                        ["-c", conf, "-o", out_k, "-k", str(CAMPAIGN_K),
                         "--extract"]))
                apps = compute_apps()
            finally:
                exits = stop_servers(fifos, procs)
    except BaseException:
        log_tails(nfs)
        raise
    finally:
        make_fifos.command_fifo_path, process_query.command_fifo_path = \
            fifo_names
        if old_timeout is None:
            os.environ.pop("DOS_SEND_TIMEOUT_S", None)
        else:
            os.environ["DOS_SEND_TIMEOUT_S"] = old_timeout
    if any(exits.values()):
        raise AssertionError(f"{tag} server exit codes {exits} (negative: "
                             "killed after outliving its stop token)")
    after = set(compute_apps() or {}) & set(pids.values())
    if after:
        raise AssertionError(f"{tag} nvidia-smi still lists the servers "
                             f"{sorted(after)} after they exited")
    log(f"{tag} every server stopped on its stop token and exited 0; "
        f"nvidia-smi lists none of their PIDs")
    if rcs != [0, 0, 0]:
        raise AssertionError(f"{tag} CLI exit codes {rcs}")

    # the build processes: each on the card, K1 and K2 launched
    builds = []
    for x in range(w):
        with open(f"{build_dump}.w{x}.json") as f:
            builds.append(json.load(f))
    build_counts = {"relax_jacobi": 0, "first_moves": 0,
                    "grid_sweep_cycle": 0}
    for b in builds:
        check_build_dump(b, card)
        c = b["counters"]
        build_counts["relax_jacobi"] += c["relax_jacobi.launches"]
        build_counts["first_moves"] += c["first_moves.launches"]
        build_counts["grid_sweep_cycle"] += c["grid_sweep.launches"]
    log(f"{tag} make_cpds --backend host: {make_s:.3f} s wall for {w} "
        f"build processes ({sum(rows)} rows = {sum(rows) / make_s:.2f} "
        "rows/s); per worker build_worker_shard seconds "
        + ", ".join(f"w{b['wid']} {b['seconds']:.3f}" for b in builds)
        + "; peak allocated per process "
        + ", ".join(f"{b['device']['max_memory_allocated'] / 2**30:.2f}"
                    for b in builds)
        + f" GiB; build kernel launches {build_counts}")

    # the servers: each on the card, the raw walk kernel and no plain walk
    serves = []
    for x in range(w):
        with open(f"{serve_dump}.w{x}.json") as f:
            serves.append(json.load(f))
    launches = 0
    for sv in serves:
        check_serve_dump(sv, card, pids[sv["wid"]])
        launches += sv["counters"]["cuda_walk_batch.launches"]
    log(f"{tag} servers ready (launch to first ping answer): "
        + ", ".join(f"w{x} {ready[x][1]:.2f} s" for x in sorted(ready)))
    log(f"{tag} server dumps: device {card!r} in all {w}; raw walk "
        "launches "
        + ", ".join(f"w{sv['wid']} {sv['counters']['cuda_walk_batch.launches']}"
                    for sv in serves)
        + f" (total {launches}), plain walks "
        + str(sum(sv["counters"]["cuda_walk_batch.plain"] for sv in serves))
        + "; batches "
        + ", ".join(str(sv["counters"]["worker_batches_total"])
                    for sv in serves)
        + "; peak allocated per server "
        + ", ".join(f"{sv['device']['max_memory_allocated'] / 2**30:.2f}"
                    for sv in serves) + " GiB")
    seen = apps or {}
    if os.getpid() in seen:
        # nvidia-smi sees this container's PIDs: every server must show
        missing = [p for p in pids.values() if p not in seen]
        if missing:
            raise AssertionError(f"{tag} nvidia-smi lists {seen} but not "
                                 f"the servers {missing}")
        log(f"{tag} nvidia-smi compute apps while serving: "
            + ", ".join(f"pid {p} {seen[p]} MiB" for p in pids.values()))
    else:
        log(f"{tag} nvidia-smi cannot see this container's processes (it "
            f"lists {seen or 'none'}, not this process's pid "
            f"{os.getpid()}); the servers' dumps show their device instead")
    log(f"{tag} peak card memory over all processes (nvidia-smi "
        f"memory.used, {mem.samples} samples at 1 s): {mem.peak_mib} MiB")

    # answers: the rounds' sums equal the in-process campaign's
    n = len(queries)
    parts = read_parts(os.path.join(out_rounds, "parts.csv"))
    for expe, name in enumerate(("free-flow", "diff")):
        plen, fin = ref["answers"][name]
        want = (n, int(plen.sum()), int(fin.sum()))
        got = round_sums(parts, expe)
        if got != want or got[2] != n:
            raise AssertionError(f"{tag} round {name}: (size, plen, "
                                 f"finished) {got} != campaign {want}")
    parts_k = read_parts(os.path.join(out_k, "parts.csv"))
    ref_k = read_parts(ref["parts_k"])
    for expe in (0, 1):
        if round_sums(parts_k, expe) != round_sums(ref_k, expe):
            raise AssertionError(f"{tag} -k {CAMPAIGN_K} round {expe}: "
                                 f"{round_sums(parts_k, expe)} != campaign "
                                 f"{round_sums(ref_k, expe)}")
    log(f"{tag} every query finished; each round's size/plen/finished "
        "sums equal the in-process campaign's (free-flow, diff, and both "
        f"-k {CAMPAIGN_K} rounds)")
    # paths.csv, put in query order (the host file lists each worker's
    # batch in turn), equals the in-process paths.csv row for row
    host_paths = np.loadtxt(os.path.join(out_k, "paths.csv"), delimiter=",",
                            skiprows=1, dtype=np.int64)
    owner = dc.worker_of(queries[:, 1])
    order = np.concatenate([np.flatnonzero(owner == x) for x in range(w)])
    in_order = np.empty_like(host_paths)
    in_order[order] = host_paths
    want_paths = np.loadtxt(ref["paths"], delimiter=",", skiprows=1,
                            dtype=np.int64)
    if not np.array_equal(in_order, want_paths):
        raise AssertionError(f"{tag} paths.csv != the campaign's")
    log(f"{tag} paths.csv in query order equals the in-process campaign's "
        f"row for row ({len(want_paths)} rows)")
    names = ["free-flow", "diff", f"k{CAMPAIGN_K} free-flow",
             f"k{CAMPAIGN_K} diff"]
    for name, sec in zip(names, rt.seconds):
        c_s = ref["round_s"][name]
        log(f"{tag} round {name}: {n} queries in {sec:.4f} s = "
            f"{n / sec:.1f} q/s on the host clock (in-process campaign "
            f"{n / c_s:.1f} q/s)")
    for expe, name in enumerate(("free-flow", "diff")):
        log(f"{tag} t_search per worker row, round {name}: "
            + ", ".join(f"w{x} {float(p['t_search']):.4f} s"
                        for x, p in enumerate(
                            q for q in parts if q["expe"] == str(expe))))

    # worker 0's shard in this process: kernel == plain walk on worker
    # 0's batch of each round
    engine = eng.ShardEngine(g, dc, 0, index, device="cuda")
    mine = queries[owner == 0]
    calls = []
    real = eng.cuda_walk_batch

    def recording(*a, **kw):
        calls.append((a, kw))
        return real(*a, **kw)

    w0_rounds = (("free-flow", RuntimeConfig(), "-", parts, 0),
                 ("diff", RuntimeConfig(), ref["diff_path"], parts, 1),
                 (f"k{CAMPAIGN_K}-extract",
                  RuntimeConfig(k_moves=CAMPAIGN_K, extract=True), "-",
                  parts_k, 0))
    eng.cuda_walk_batch = recording
    alone = {}
    try:
        for name, cfg, diff, rows_of, expe in w0_rounds:
            engine.answer(mine, cfg, diff)                 # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, _, _, stats = engine.answer(mine, cfg, diff)
            torch.cuda.synchronize()
            alone[name] = (time.perf_counter() - t0, stats.t_search)
            row = [p for p in rows_of if p["expe"] == str(expe)][0]
            if (stats.plen, stats.finished) != (int(row["plen"]),
                                                int(row["finished"])):
                raise AssertionError(f"{tag} worker 0 in this process "
                                     f"{stats} != its server's row {row} "
                                     f"({name})")
            log(f"{tag} worker 0's {name} batch ({len(mine)} queries) "
                f"answered in this process, its context alone on the "
                f"card: {alone[name][0]:.4f} s (t_search "
                f"{alone[name][1]:.4f} s); its server's row, beside 7 "
                f"other contexts: t_search {float(row['t_search']):.4f} s")
    finally:
        eng.cuda_walk_batch = real
    per_round = [kernel_vs_plain(r[0], call, f"{tag} kernel w0")
                 for r, call in zip(w0_rounds, calls[1::2])]
    del calls
    if not isinstance(engine.fm, torch.Tensor):
        raise AssertionError(f"{tag} worker 0's engine is not raw resident")
    w0_build = build_chunk_vs_plain(f"{tag} build w0", g,
                                    dc.owned(0)[:CHUNK], engine.fm[:CHUNK])
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, **headline(per_round[0]),
            "max_abs_err": max(x["max_abs_err"] for x in per_round),
            "workers": w, "make_cpds_s": make_s,
            "build_s": [b["seconds"] for b in builds],
            "ready_s": [ready[x][1] for x in range(w)],
            "round_s": rt.seconds[:4],
            "peak_card_mib": mem.peak_mib,
            "w0_alone_s": {k: v[0] for k, v in alone.items()},
            "server_peak_bytes": [sv["device"]["max_memory_allocated"]
                                  for sv in serves],
            "w0_build_vs_plain": w0_build,
            "rounds": per_round}, build_counts, {
                "conf": conf, "index": index, "dc": dc,
                "parts": parts, "parts_k": parts_k,
                "paths_in_order": in_order}


# ------------------------------------------------------------ supervise path

def parts_rows(path: str, expe: str = "0") -> list[dict]:
    """One round's ``parts.csv`` rows (a worker's a row, in worker
    order), without the timer columns."""
    return [{k: v for k, v in r.items() if not k.startswith("t_")}
            for r in read_parts(path) if r["expe"] == expe]


def pid_alive(pid: int) -> bool:
    """Whether ``pid`` is a live process (a zombie counts as gone)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def wait_supervisor(port: int, sup, w: int, deadline_s: float) -> dict:
    """The supervisor's ``/statusz`` section once it answers: its obs
    server starts only after every worker answered its ping."""
    deadline = time.perf_counter() + deadline_s
    while time.perf_counter() < deadline:
        if sup.poll() is not None:
            raise AssertionError(f"[supervise] the supervisor exited "
                                 f"{sup.returncode} before its workers "
                                 "were ready")
        try:
            st = statusz(port)["supervisor"]
        except OSError:
            time.sleep(0.2)
            continue
        if st["alive"] == w and all(x["healthy_once"]
                                    for x in st["workers"].values()):
            return st
        time.sleep(0.2)
    raise AssertionError(f"[supervise] no ready fleet on /statusz within "
                         f"{deadline_s} s")


def supervise_path(ref: dict, host: dict, during=None) -> dict:
    """``make_fifos --supervise --device cuda`` as a subprocess over
    ``[host]``'s built index (``mod`` over 8 ``localhost`` workers, no
    rebuild): the supervisor launches the 8 port servers on the card and
    pings them; a ``process_query --backend host`` round equals
    ``[host]``'s; worker 3's server is SIGKILLed as the second round
    starts, and that round either ends degraded naming worker 3 (exit
    ``EXIT_DEGRADED``) or is served after the respawn; the supervisor
    respawns worker 3 (``supervisor_respawns_total`` 1 on ``/metrics``)
    and a third round, traced, equals the first; ``dos-control --once
    --dry-run`` over the fleet's FIFO directory; ``dos-obs top`` renders
    the supervisor's ``/statusz``; SIGINT stops the supervisor and every
    child; the servers' dumps (the respawned one's too) show the card, B1
    launches == batches + program keys and no plain walk, and ``dos-obs
    merge-metrics`` sums them; ``dos-obs merge-traces`` writes the third
    round's trace as one Perfetto document. ``during()``, when given,
    runs while the supervisor starts its servers (a thread reads
    ``/statusz`` meanwhile for the fleet's ready time)."""
    tag = "[supervise]"
    t_phase = time.perf_counter()
    w = HOST_WORKERS
    card = torch.cuda.get_device_name(0)
    run_dir = tempfile.mkdtemp(prefix="supervise-",
                               dir=os.path.dirname(host["index"]))
    nfs = os.path.join(run_dir, "nfs")
    os.makedirs(nfs)
    conf = os.path.join(run_dir, "conf.json")
    with open(conf, "w") as f:
        json.dump({"workers": ["localhost"] * w, "partmethod": "mod",
                   "partkey": w, "outdir": host["index"], "nfs": nfs,
                   "projectdir": ROOT, "xy_file": ref["xy"],
                   "scenfile": ref["scen"], "diffs": ["-"]}, f)
    fifos = {x: os.path.join(run_dir, f"worker{x}.fifo") for x in range(w)}
    dump = os.path.join(run_dir, "serve")
    outs = [os.path.join(run_dir, f"round{i}") for i in (1, 2, 3)]
    trace = os.path.join(run_dir, "round3.trace.json")
    port = free_port()
    env = dict(os.environ, DOS_TELEMETRY_INTERVAL_S=SUP_TELEMETRY_S)
    env.pop("DOS_OBS_PORT", None)
    sup_log = os.path.join(run_dir, "supervisor.log")
    prior_timeout = os.environ.get("DOS_SEND_TIMEOUT_S")
    real = (process_query.command_fifo_path, fifo_transport.command_fifo_path,
            process_query.fan_out)
    pids: set[int] = set()
    sup = None
    try:
        t_launch = time.perf_counter()
        with open(sup_log, "w") as lf:
            sup = subprocess.Popen(
                [sys.executable, "-c", SUPERVISE_IN_DIR, run_dir, "-c", conf,
                 "--supervise", "--device", "cuda", "--obs-port", str(port),
                 "--metrics-dump", dump],
                cwd=ROOT, env=env, stdout=lf, stderr=subprocess.STDOUT)
        up: dict = {}
        if during is not None:
            stop_up = threading.Event()

            def watch_up():
                while not stop_up.wait(0.2):
                    try:
                        statusz(port)
                    except OSError:
                        continue
                    up.setdefault("s", time.perf_counter() - t_launch)
                    return

            th_up = threading.Thread(target=watch_up, daemon=True)
            th_up.start()
            try:
                during()
            finally:
                stop_up.set()
                th_up.join(timeout=30)
        st = wait_supervisor(port, sup, w, HOST_READY_S)
        ready_s = up.get("s", time.perf_counter() - t_launch)
        os.environ["DOS_SEND_TIMEOUT_S"] = str(SUP_SEND_TIMEOUT_S)
        process_query.command_fifo_path = fifos.__getitem__
        fifo_transport.command_fifo_path = fifos.__getitem__
        first = {int(x): v["pid"] for x, v in st["workers"].items()}
        pids |= set(first.values())
        log(f"{tag} make_fifos --supervise --device cuda: {w} servers "
            f"ready by the supervisor's pings {ready_s:.2f} s after its "
            f"launch{' ([native] running meanwhile)' if during else ''} "
            f"(pids {sorted(first.values())}); ping every "
            f"{st['ping_interval_s']} s")

        # round 1: the fleet answers as [host]'s did
        t0 = time.perf_counter()
        rcs = [process_query.main(["-c", conf, "-o", outs[0]])]
        round_s = [time.perf_counter() - t0]
        rows1 = parts_rows(os.path.join(outs[0], "parts.csv"))
        want = [{k: v for k, v in r.items() if not k.startswith("t_")}
                for r in host["parts"] if r["expe"] == "0"]
        if rcs[0] or rows1 != want:
            raise AssertionError(f"{tag} round 1: rc {rcs[0]}, rows "
                                 f"{rows1} != [host]'s {want}")

        # round 2: worker 3's server SIGKILLed as the round's sends start;
        # a thread reads /statusz from then on: when the respawn started
        # (a new pid) and when it first answered the supervisor's ping
        victim = first[SUP_KILLED]
        killed: dict = {}
        seen: dict = {}
        stop_watch = threading.Event()

        def watch():
            while not stop_watch.wait(0.1):
                try:
                    x = statusz(port)["supervisor"]["workers"][
                        str(SUP_KILLED)]
                except OSError:
                    continue
                now = time.perf_counter() - killed["t"]
                if x["pid"] != victim:
                    seen.setdefault("spawned", (now, x["pid"]))
                    if x["healthy_once"]:
                        seen.setdefault("healthy", now)

        def kill_then_fan_out(jobs, fn, *a, **kw):
            if not killed:
                # a reader held on the server's FIFO: the head's write of
                # its batch there then completes (the transfer script
                # goes on to its bounded answer read) instead of blocking
                # for ever in open() once the server is dead and its
                # respawn has replaced the FIFO
                killed["hold"] = os.open(fifos[SUP_KILLED],
                                         os.O_RDONLY | os.O_NONBLOCK)
                os.kill(victim, signal.SIGKILL)
                killed["t"] = time.perf_counter()
                watcher.start()
            return real[2](jobs, fn, *a, **kw)

        watcher = threading.Thread(target=watch, daemon=True)
        process_query.fan_out = kill_then_fan_out
        try:
            t0 = time.perf_counter()
            rcs.append(process_query.main(["-c", conf, "-o", outs[1]]))
            round_s.append(time.perf_counter() - t0)
        finally:
            process_query.fan_out = real[2]
            if "hold" in killed:
                os.close(killed["hold"])
        degraded = os.path.join(outs[1], "degraded.json")
        if rcs[1] == process_query.EXIT_DEGRADED:
            with open(degraded) as f:
                dj = json.load(f)
            if dj["failed_workers"] != [SUP_KILLED] or dj["exit_code"] != 3:
                raise AssertionError(f"{tag} round 2's degraded.json: {dj}")
            how = (f"ended degraded (exit {rcs[1]}, degraded.json names "
                   f"worker {SUP_KILLED} only)")
        elif rcs[1] == 0 and not os.path.exists(degraded):
            rows2 = parts_rows(os.path.join(outs[1], "parts.csv"))
            if rows2 != rows1:
                raise AssertionError(f"{tag} round 2 {rows2} != round 1")
            how = ("was served after the respawn (exit 0, rows equal "
                   "round 1's)")
        else:
            raise AssertionError(f"{tag} round 2 exit {rcs[1]}")

        # the respawn: a new pid, answering the supervisor's pings
        deadline = time.perf_counter() + SUP_RESPAWN_S
        while "healthy" not in seen:
            if sup.poll() is not None or time.perf_counter() > deadline:
                raise AssertionError(f"{tag} worker {SUP_KILLED} not "
                                     f"respawned: {seen}")
            time.sleep(0.1)
        stop_watch.set()
        watcher.join(timeout=30)
        st = statusz(port)["supervisor"]
        s3 = st["workers"][str(SUP_KILLED)]
        spawned_s, new_pid = seen["spawned"]
        respawn_s = seen["healthy"]
        pids.add(new_pid)
        respawns = metric_value(port, "supervisor_respawns_total")
        alive = metric_value(port, "supervisor_workers_alive")
        # the respawn starts within the first backoff step: the monitor
        # tick that sees the death schedules it 0.5 s out, a later tick
        # spawns it (a tick waits the ping interval, then pings each
        # live server in turn)
        late = spawned_s > 4 * st["ping_interval_s"] + 0.5
        if (respawns != 1 or st["alive"] != w or s3["respawns"] != 1
                or s3["pid"] != new_pid or late):
            raise AssertionError(f"{tag} /metrics supervisor_respawns_total "
                                 f"{respawns}, respawn after {spawned_s:.2f}"
                                 f" s, /statusz {st}")
        log(f"{tag} worker {SUP_KILLED} (pid {victim}) SIGKILLed as round "
            f"2 started; round 2 {how} in {round_s[1]:.2f} s; the "
            f"supervisor spawned pid {new_pid} {spawned_s:.2f} s after "
            f"the kill (a ping every {st['ping_interval_s']} s, then the "
            f"0.5 s first backoff step), answering its ping "
            f"{respawn_s:.2f} s after it; /metrics "
            f"supervisor_respawns_total {respawns:g}, "
            f"supervisor_workers_alive {alive:g}")

        # round 3, traced: every worker answers, rows equal round 1's
        t0 = time.perf_counter()
        rcs.append(process_query.main(["-c", conf, "-o", outs[2],
                                       "--trace", trace]))
        round_s.append(time.perf_counter() - t0)
        obs_trace.enable(False)
        obs_trace.set_trace_id(None)
        obs_trace.clear()
        rows3 = parts_rows(os.path.join(outs[2], "parts.csv"))
        if (rcs[2] or rows3 != rows1 or len(rows3) != w
                or any(r["finished"] != r["size"] for r in rows3)):
            raise AssertionError(f"{tag} round 3: rc {rcs[2]}, rows "
                                 f"{rows3} != round 1's {rows1}")
        log(f"{tag} round 3 served by all {w} workers, rows equal round "
            f"1's; rounds {', '.join(f'{x:.3f}' for x in round_s)} s "
            f"({len(ref['queries'])} queries each)")

        # dos-control, standalone over the fleet's FIFO directory
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = control_cli.main(["-c", conf, "--once", "--dry-run",
                                   "--fifo-dir", run_dir])
        ctl_s = time.perf_counter() - t0
        said = buf.getvalue().strip()
        probes = {x: fifo_transport.probe("localhost", x,
                                          command_fifo=fifos[x], nfs=nfs,
                                          timeout=10.0)
                  for x in range(w)}
        if rc or said != "no action" or not all(
                p is not None and p.ok for p in probes.values()):
            raise AssertionError(f"{tag} dos-control: rc {rc}, {said!r}; "
                                 f"probes {probes}")
        log(f"{tag} dos-control --once --dry-run --fifo-dir: rc 0, one "
            f"tick with no decision ({said!r}) in {ctl_s:.2f} s; the 8 "
            "servers each answer its transport.fifo.probe healthy (pids "
            f"{sorted(p.pid for p in probes.values())})")

        # dos-obs top over the supervisor's /statusz
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = obs_cli.main(["top", "--endpoints", f"127.0.0.1:{port}"])
        table = buf.getvalue().strip().splitlines()
        cols = table[0].split()
        row = table[-1].split()
        top = dict(zip(cols, row))
        if rc or top.get("alive") != str(w) or top.get("respawns") != "1":
            raise AssertionError(f"{tag} dos-obs top: rc {rc}, {table}")
        log(f"{tag} dos-obs top --endpoints 127.0.0.1:{port}: "
            + " | ".join(table))
        live = {int(x): v["pid"] for x, v in st["workers"].items()}

        # SIGINT: the supervisor stops every server on its token
        t0 = time.perf_counter()
        sup.send_signal(signal.SIGINT)
        sup_rc = sup.wait(timeout=HOST_STOP_S)
        stop_s = time.perf_counter() - t0
        left = sorted(p for p in pids if pid_alive(p))
        if sup_rc != 0 or left:
            raise AssertionError(f"{tag} SIGINT: supervisor exit {sup_rc}, "
                                 f"processes left {left}")
        log(f"{tag} SIGINT: the supervisor exited 0 in {stop_s:.2f} s; "
            f"none of its {len(pids)} server processes is left")
    except BaseException:
        if os.path.exists(sup_log):
            with open(sup_log, errors="replace") as f:
                log(f"{tag} --- supervisor log (last 3000 characters) "
                    f"---\n{f.read()[-3000:]}")
        raise
    finally:
        (process_query.command_fifo_path, fifo_transport.command_fifo_path,
         process_query.fan_out) = real
        if prior_timeout is None:
            os.environ.pop("DOS_SEND_TIMEOUT_S", None)
        else:
            os.environ["DOS_SEND_TIMEOUT_S"] = prior_timeout
        if sup is not None and sup.poll() is None:
            sup.send_signal(signal.SIGINT)
            try:
                sup.wait(timeout=HOST_STOP_S)
            except subprocess.TimeoutExpired:
                sup.kill()
                sup.wait(timeout=30)
        for p in pids:
            if pid_alive(p):
                os.kill(p, signal.SIGKILL)

    # the dumps: each server on the card, B1 = batches + program keys
    dumps = [f"{dump}.w{x}.json" for x in range(w)]
    launches, batches = 0, []
    for x, path in enumerate(dumps):
        with open(path) as f:
            sv = json.load(f)
        c = sv["counters"]
        if (sv["device"]["type"] != "cuda" or sv["device"]["name"] != card
                or sv["pid"] != live[x]
                or c["cuda_walk_batch.launches"]
                != c["worker_batches_total"] + len(sv["device_programs"])
                or c["cuda_walk_batch.plain"] != 0):
            raise AssertionError(f"{tag} server {x}'s dump: pid "
                                 f"{sv['pid']}, device {sv['device']}, {c}")
        launches += c["cuda_walk_batch.launches"]
        batches.append(c["worker_batches_total"])
    with open(dumps[SUP_KILLED]) as f:
        re3 = json.load(f)
    log(f"{tag} the respawned worker {SUP_KILLED}'s dump (pid "
        f"{re3['pid']}): device {re3['device']['name']!r}, B1 launches "
        f"{re3['counters']['cuda_walk_batch.launches']} == "
        f"{re3['counters']['worker_batches_total']} batches + "
        f"{len(re3['device_programs'])} program key(s), plain walks 0; "
        f"batches a server {batches}, B1 launches over all {launches}")

    # dos-obs: the dumps merged, the trace written as one document
    fleet_doc = os.path.join(run_dir, "fleet.json")
    merged = os.path.join(run_dir, "merged.trace.json")
    with contextlib.redirect_stdout(io.StringIO()):
        rcs_obs = [obs_cli.main(["merge-metrics", *dumps, "-o", fleet_doc]),
                   obs_cli.main(["merge-traces", trace, "-o", merged])]
    with open(fleet_doc) as f:
        doc = json.load(f)
    with open(merged) as f:
        evs = json.load(f)["traceEvents"]
    searches = {ev["pid"] for ev in evs if ev["name"] == "worker.search"}
    summed = doc["fleet"]["counters"]["cuda_walk_batch.launches"]
    if (rcs_obs != [0, 0] or doc["n_workers"] != w or summed != launches
            or searches != set(live.values())):
        raise AssertionError(f"{tag} dos-obs: rc {rcs_obs}, {doc['n_workers']}"
                             f" snapshots, B1 {summed} != {launches}; "
                             f"worker.search pids {sorted(searches)}")
    log(f"{tag} dos-obs merge-metrics of the {w} dumps: B1 launches "
        f"{summed} (their sum); merge-traces: one Perfetto document of "
        f"{len(evs)} events, worker.search spans from the {w} live "
        f"servers' pids; phase {time.perf_counter() - t_phase:.1f} s")
    shutil.rmtree(run_dir, ignore_errors=True)
    return {"launches": launches, "ready_s": ready_s, "round_s": round_s,
            "round2": how, "spawned_s": spawned_s, "respawn_s": respawn_s,
            "stop_s": stop_s, "control_s": ctl_s,
            "phase_s": time.perf_counter() - t_phase}


# ------------------------------------------------------------ native path

def native_servers(conf: str, fifos: dict, alg: str, out: str,
                   tag: str) -> tuple[int, float, float]:
    """``make_fifos --engine native`` (``fifo_auto`` a worker, tracked)
    serving ``alg``, one ``process_query --backend host`` round over
    them into ``out``, then every server stopped on its token. Returns
    (the round's exit code, seconds to every FIFO, the round's
    seconds)."""
    for f in fifos.values():
        if os.path.exists(f):
            os.remove(f)
    t0 = time.perf_counter()
    procs = dict(make_fifos.launch_servers(
        ClusterConfig.load(conf), conf, track=True, alg=alg,
        engine="native"))
    try:
        deadline = time.perf_counter() + HOST_READY_S
        while not all(os.path.exists(f) for f in fifos.values()):
            dead = {x: p.poll() for x, p in procs.items()
                    if p.poll() is not None}
            if dead or time.perf_counter() > deadline:
                raise AssertionError(f"{tag} fifo_auto --alg {alg}: exited "
                                     f"{dead} before its FIFO")
            time.sleep(0.05)
        ready_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        rc = process_query.main(["-c", conf, "-o", out])
        round_s = time.perf_counter() - t0
    finally:
        exits = stop_servers(fifos, procs)
    if any(exits.values()):
        raise AssertionError(f"{tag} fifo_auto --alg {alg} exit codes "
                             f"{exits}")
    return rc, ready_s, round_s


class NativeMake:
    """``make -C native fast`` on a thread of its own, with the
    Makefile's own compiler (``CXX ?= g++``: a CXX the environment sets
    may name a toolchain without OpenMP's runtime): the repo's C++
    sources built into ``native/build/``. :meth:`wait` returns the
    finished process, its seconds and the compiler's version line."""

    def __init__(self):
        self.result: tuple | BaseException | None = None
        # not a daemon: the interpreter waits for make at exit, so a
        # phase that fails before [native] leaves no build running
        self._thread = threading.Thread(target=self._run)

    def _run(self):
        try:
            env = {k: v for k, v in os.environ.items()
                   if k not in ("CXX", "CC")}
            cxx = subprocess.run(["g++", "--version"], capture_output=True,
                                 text=True, env=env,
                                 timeout=60).stdout.split("\n")[0]
            t0 = time.perf_counter()
            mk = subprocess.run(
                ["make", "-C", os.path.join(ROOT, "native"), "fast",
                 f"-j{os.cpu_count()}"], capture_output=True, text=True,
                env=env, timeout=900)
            self.result = (mk, time.perf_counter() - t0, cxx)
        except BaseException as e:  # noqa: BLE001 — re-raised by wait()
            self.result = e

    def start(self) -> "NativeMake":
        self._thread.start()
        return self

    def wait(self) -> tuple:
        self._thread.join()
        if isinstance(self.result, BaseException):
            raise self.result
        return self.result


def native_path(outdir: str, native_make: NativeMake
                ) -> tuple[dict, dict[str, int]]:
    """The native C++ engine beside the card, on a road network of
    ``OFFLINE_LOCAL_NODES`` nodes ``mod`` over 8 ``localhost`` workers:
    ``make -C native fast`` builds the repo's sources; ``make_cpds
    --engine native`` (``make_cpd_auto`` a worker, OpenMP on the host)
    and ``make_cpds --backend host`` (the port's ``worker.build`` a
    worker, K1/K2 on the card) write byte-equal blocks and manifest
    digests; ``make_fifos --engine native`` and a ``process_query
    --backend host`` round over the 20,000 queries give the rows of the
    port's engines walking the native index on the card (B1, launches ==
    8 batches + new program keys, no plain walk); an ``--alg ch`` round
    on ``fifo_auto`` finishes every query, and on the queries to seeded
    targets the hierarchy's costs (``ch_check``) and the walk's
    (scipy's Dijkstra) both equal Dijkstra's. Returns the phase's entry
    and the build kernels' launches of the card's build processes."""
    tag = "[native]"
    t_phase = time.perf_counter()
    card = torch.cuda.get_device_name(0)
    cores = os.cpu_count()
    mk, make_s, cxx = native_make.wait()
    if mk.returncode:
        raise AssertionError(f"{tag} make -C native fast: rc "
                             f"{mk.returncode}\n{mk.stderr[-3000:]}")
    bins = {n: nativebin.require_binary(n)
            for n in ("make_cpd_auto", "fifo_auto", "ch_check")}
    log(f"{tag} make -C native fast (run beside the kernel builds): "
        f"{make_s:.2f} s on {cores} cores with {cxx!r} (the environment's "
        f"CXX {os.environ.get('CXX')!r} left out); binaries "
        f"{sorted(set(os.path.dirname(b) for b in bins.values()))}")

    d = os.path.join(outdir, "native")
    os.makedirs(d)
    g0 = synth_road_network(OFFLINE_LOCAL_NODES, seed=SEED)
    xy = os.path.join(d, "road.xy")
    write_xy(xy, g0.xs, g0.ys, g0.src, g0.dst, g0.w)
    g = Graph.from_xy(xy)
    queries = make_queries(np.arange(g.n), g.n)
    scen = os.path.join(d, "road.scen")
    write_scen(scen, queries)
    w = NATIVE_WORKERS
    dc = DistributionController("mod", w, w, g.n)
    nfs = os.path.join(d, "nfs")
    os.makedirs(nfs)
    confs, index = {}, {}
    for name in ("native", "card"):
        index[name] = os.path.join(d, f"index-{name}")
        confs[name] = os.path.join(d, f"{name}.json")
        with open(confs[name], "w") as f:
            json.dump({"workers": ["localhost"] * w, "partmethod": "mod",
                       "partkey": w, "outdir": index[name], "nfs": nfs,
                       "projectdir": ROOT, "xy_file": xy,
                       "scenfile": scen, "diffs": ["-"]}, f)

    # the two builds: blocks byte-equal, manifests' digests equal
    # the two builds at once: the native one on the host's cores, the
    # card's in its 8 worker.build processes
    build_dump = os.path.join(d, "build")
    built: dict = {}

    def build(name, argv):
        t0 = time.perf_counter()
        try:
            built[name] = (make_cpds.main(argv), time.perf_counter() - t0)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            built[name] = (e, time.perf_counter() - t0)

    th = threading.Thread(target=build, args=("native", [
        "-c", confs["native"], "--backend", "host", "--engine", "native"]))
    th.start()
    build("card", ["-c", confs["card"], "--backend", "host", "--device",
                   "cuda", "--metrics-dump", build_dump])
    th.join()
    for rc, _ in built.values():
        if isinstance(rc, BaseException):
            raise rc
    rcs = [built["native"][0], built["card"][0]]
    native_s, card_s = built["native"][1], built["card"][1]
    if rcs != [0, 0]:
        raise AssertionError(f"{tag} make_cpds exit codes {rcs}")
    blocks = {name: sorted(f for f in os.listdir(index[name])
                           if f.startswith("cpd-") and f.endswith(".npy"))
              for name in index}
    if blocks["native"] != blocks["card"] or len(blocks["card"]) < w:
        raise AssertionError(f"{tag} block files {blocks}")
    for fname in blocks["card"]:
        with open(os.path.join(index["native"], fname), "rb") as a, \
                open(os.path.join(index["card"], fname), "rb") as b:
            if a.read() != b.read():
                raise AssertionError(f"{tag} {fname}: make_cpd_auto's "
                                     "block differs from worker.build's")
    digests = {name: read_manifest(index[name])["blocks"] for name in index}
    if digests["native"] != digests["card"]:
        raise AssertionError(f"{tag} manifest digests differ")
    build_counts = {"relax_jacobi": 0, "first_moves": 0,
                    "grid_sweep_cycle": 0}
    for x in range(w):
        with open(f"{build_dump}.w{x}.json") as f:
            b = json.load(f)
        check_build_dump(b, card)
        build_counts["relax_jacobi"] += b["counters"]["relax_jacobi.launches"]
        build_counts["first_moves"] += b["counters"]["first_moves.launches"]
        build_counts["grid_sweep_cycle"] += \
            b["counters"]["grid_sweep.launches"]
    log(f"{tag} {g.n}-node road network, mod over {w}, the two builds at "
        f"once: make_cpds --engine native (make_cpd_auto, {w} processes) "
        f"{native_s:.2f} s; make_cpds --backend host on the card ({w} "
        f"worker.build processes) {card_s:.2f} s, build kernel launches "
        f"{build_counts}; "
        f"the {len(blocks['card'])} block files byte-equal and the "
        "manifests' digests equal")

    # fifo_auto serving the native index; the port's engines walk it
    fifos = {x: os.path.join(d, f"worker{x}.fifo") for x in range(w)}
    names = (make_fifos.command_fifo_path, process_query.command_fifo_path)
    make_fifos.command_fifo_path = process_query.command_fifo_path = \
        fifos.__getitem__
    outs = {alg: os.path.join(d, f"out-{alg}") for alg in ("walk", "ch")}
    try:
        rc, ready_s, round_s = native_servers(
            confs["native"], fifos, "table-search", outs["walk"], tag)
        rc_ch, ready_ch_s, round_ch_s = native_servers(
            confs["native"], fifos, "ch", outs["ch"], tag)
    except BaseException:
        log_tails(nfs)
        raise
    finally:
        make_fifos.command_fifo_path, process_query.command_fifo_path = \
            names
    if [rc, rc_ch] != [0, 0]:
        raise AssertionError(f"{tag} process_query exit codes {rc}, {rc_ch}")
    rows = {alg: parts_rows(os.path.join(out, "parts.csv"))
            for alg, out in outs.items()}
    owner = dc.worker_of(queries[:, 1])
    cost = np.zeros(len(queries), np.int64)
    plain0 = cw.cuda_walk_batch.plain
    programs0 = set(obs_device.snapshot())
    zero_launches()
    t0 = time.perf_counter()
    for x in range(w):
        e = eng.ShardEngine(g, dc, x, index["native"], device="cuda")
        sel = owner == x
        c, _, _, stats = e.answer(queries[sel], RuntimeConfig(), "-")
        cost[sel] = np.asarray(c)
        row = rows["walk"][x]
        got = (int(row["size"]), int(row["plen"]), int(row["finished"]))
        if got != (int(sel.sum()), stats.plen, stats.finished):
            raise AssertionError(f"{tag} worker {x}: fifo_auto's row {got} "
                                 f"!= the port's engine {stats}")
        del e
    torch.cuda.synchronize()
    engines_s = time.perf_counter() - t0
    launches = read_launches()[0]
    captured = len(set(obs_device.snapshot()) - programs0)
    plain = cw.cuda_walk_batch.plain - plain0
    if launches != w + captured or plain:
        raise AssertionError(f"{tag} B1 launches {launches} (want {w} "
                             f"batches + {captured} keys), plain {plain}")
    log(f"{tag} make_fifos --engine native: {w} fifo_auto servers up in "
        f"{ready_s:.2f} s, a process_query --backend host round of "
        f"{len(queries)} queries in {round_s:.3f} s; each worker's row "
        f"(size, plen, finished) equals the port's ShardEngine on the card "
        f"over the native index ({engines_s:.2f} s for the 8 loads and "
        f"walks; B1 launches {launches} = {w} batches + {captured} program "
        f"keys, plain walks {plain})")

    # --alg ch: every query finished; costs held to Dijkstra, as the walk's
    sizes = [r["size"] for r in rows["walk"]]
    if (any(r["size"] != r["finished"] for r in rows["ch"])
            or [r["size"] for r in rows["ch"]] != sizes):
        raise AssertionError(f"{tag} --alg ch rows {rows['ch']}")
    rng = np.random.default_rng(SEED + 7)
    tgts = rng.choice(np.unique(queries[:, 1]), NATIVE_GOLDEN_TARGETS,
                      replace=False)
    sel = np.isin(queries[:, 1], tgts)
    golden = os.path.join(d, "golden.scen")
    write_scen(golden, queries[sel])
    t0 = time.perf_counter()
    chk = subprocess.run([bins["ch_check"], xy, golden], capture_output=True,
                         text=True, timeout=600)
    check_s = time.perf_counter() - t0
    dij = scipy_dijkstra(g, g.w, queries[sel])
    if chk.returncode or not chk.stdout.startswith("CH_OK"):
        raise AssertionError(f"{tag} ch_check: rc {chk.returncode} "
                             f"{chk.stdout} {chk.stderr[-2000:]}")
    if not np.array_equal(cost[sel], dij):
        raise AssertionError(f"{tag} the walk's costs differ from "
                             f"Dijkstra's on {int((cost[sel] != dij).sum())}"
                             " golden queries")
    hops = sum(int(r["plen"]) for r in rows["ch"])
    log(f"{tag} --alg ch on fifo_auto: servers up in {ready_ch_s:.2f} s "
        f"(the hierarchy built in each), a round in {round_ch_s:.3f} s, "
        f"every query finished (hops {hops} beside the walk's "
        f"{sum(int(r['plen']) for r in rows['walk'])}: equal-cost paths "
        f"may differ in hops); on the {int(sel.sum())} queries to "
        f"{NATIVE_GOLDEN_TARGETS} seeded targets the hierarchy's costs "
        f"equal Dijkstra's (ch_check, {check_s:.2f} s: "
        f"{chk.stdout.strip()}) and so do the walk's (scipy): the "
        f"hierarchy's costs equal the free-flow walk's; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "make_s": make_s, "cores": cores,
            "native_build_s": native_s, "card_build_s": card_s,
            "ready_s": ready_s, "round_s": round_s, "ch_round_s": round_ch_s,
            "phase_s": time.perf_counter() - t_phase}, build_counts


# ----------------------------------------------------------------- heal path

class HealTimer:
    """Splits every ``models.cpd.heal_block`` call (both load paths heal
    through it) into its quarantine, its rebuild (a replica copy and
    ``build_worker_shard``) and the rest (the reload, the digest and the
    manifest check), host clock. Calls of ``quarantine`` and
    ``build_worker_shard`` outside a heal (anti-entropy) are not
    counted."""

    def __init__(self):
        self.heals: list[dict] = []
        self._cur: dict | None = None
        self._real = {name: getattr(cpd, name) for name in (
            "heal_block", "quarantine", "build_worker_shard")}
        self._real_engine_heal = eng.heal_block

    def _part(self, name, key):
        fn = self._real[name]

        def wrapper(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                if self._cur is not None:
                    self._cur[key] += time.perf_counter() - t0
        return wrapper

    def _heal(self, outdir, manifest, fname, *a, **kw):
        self._cur = {"file": fname, "quarantine_s": 0.0, "rebuild_s": 0.0}
        t0 = time.perf_counter()
        try:
            return self._real["heal_block"](outdir, manifest, fname, *a,
                                            **kw)
        finally:
            cur, self._cur = self._cur, None
            cur["total_s"] = time.perf_counter() - t0
            cur["reload_s"] = (cur["total_s"] - cur["quarantine_s"]
                               - cur["rebuild_s"])
            self.heals.append(cur)

    def __enter__(self):
        cpd.quarantine = self._part("quarantine", "quarantine_s")
        cpd.build_worker_shard = self._part("build_worker_shard",
                                            "rebuild_s")
        cpd.heal_block = eng.heal_block = self._heal
        return self

    def __exit__(self, *exc):
        for name, fn in self._real.items():
            setattr(cpd, name, fn)
        eng.heal_block = self._real_engine_heal


def verify_cli(conf: str, flags: list[str]) -> tuple[int, dict, float]:
    """``make_cpds.main(["-c", conf, *flags])`` (``--verify`` or
    ``--scrub``): its exit code, the last JSON report line it printed and
    its seconds on the host clock."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = make_cpds.main(["-c", conf, *flags])
    sec = time.perf_counter() - t0
    return rc, json.loads(buf.getvalue().strip().splitlines()[-1]), sec


def flip_byte(path: str, offset: int) -> None:
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 0xFF]))


def truncate_half(path: str) -> None:
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)


def heal_path(ref: dict, host: dict, campaign_index: str
              ) -> tuple[dict, dict[str, int]]:
    """Verify, heal and replicas on the host phase's index at full size
    (8 ``mod`` workers, one 512 MiB int8 block each), through the entry
    points a user calls: ``make_cpds --verify``; a rerun of ``make_cpds
    --backend host`` with ``replication: 2`` (every primary resumes,
    every hosted replica is copied); four planted faults that
    ``--verify`` and ``--scrub`` report; ``anti_entropy`` healing a
    flipped replica by copy and a replica with no primary by a recompute
    on the card; ``ShardEngine`` healing worker 3's torn block (K1/K2)
    and answering worker 3's batches as its server did (B1, == the plain
    walk); ``worker.build --adopt-shard`` in a process of its own healing
    worker 5's missing block; worker 6's flipped block healed by its
    engine; ``CPDOracle.load(heal=True)`` on the campaign index; the
    manifest's digests at the close. Returns the phase's entry and the build
    kernels' launches in its run (this process's and the adopt
    process's dump)."""
    tag = "[heal]"
    card_txt = card_line()
    card = torch.cuda.get_device_name(0)
    g, queries = ref["g"], ref["queries"]
    index, w = host["index"], HOST_WORKERS
    dc = DistributionController("mod", w, w, g.n, replication=2)
    name = cpd.shard_block_name
    out: dict = {"card": card_txt}

    # 1. the host index as the host phase left it
    rc, rep, out["verify_s"] = verify_cli(host["conf"], ["--verify"])
    if rc != 0 or rep["ok"] != rep["total"] or rep["total"] != w:
        raise AssertionError(f"{tag} --verify of the host index: rc {rc}, "
                             f"{rep}")
    index_bytes = sum(os.path.getsize(os.path.join(index, name(x, 0)))
                      for x in range(w))
    log(f"{tag} make_cpds --verify: exit 0, ok == total == {w}; "
        f"{out['verify_s']:.3f} s for crc32 over {index_bytes} B "
        f"({index_bytes / out['verify_s'] / 2**30:.2f} GiB/s) on "
        f"{card_txt}")

    # the phase's main run: counts set to 0 here, read after step 7
    zero_launches()
    cw.cuda_walk_batch.plain = 0
    # 2. replication 2: primaries resume, hosted replicas copy
    with open(host["conf"]) as f:
        conf_d = json.load(f)
    conf_d["replication"] = 2
    conf = host["conf"][:-len(".json")] + "-r2.json"
    with open(conf, "w") as f:
        json.dump(conf_d, f)
    dump = os.path.join(os.path.dirname(conf), "heal-build")
    t0 = time.perf_counter()
    rc = make_cpds.main(["-c", conf, "--backend", "host", "--chunk",
                         str(CHUNK), "--metrics-dump", dump])
    out["replicated_build_s"] = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"{tag} make_cpds -R2 exit code {rc}")
    for x in range(w):
        with open(f"{dump}.w{x}.json") as f:
            b = json.load(f)
        c = b["counters"]
        # the primary resumes, the replica is copied and its own build
        # pass then finds it complete: 2 resumed blocks, one copied, no
        # kernel launched
        if (b["blocks"] != 0 or c["build_blocks_resumed_total"] != 2
                or c["replica_blocks_copied_total"] != 1
                or c["relax_jacobi.launches"] or c["first_moves.launches"]
                or b["device"]["name"] != card):
            raise AssertionError(f"{tag} replicated build of worker {x}: "
                                 f"{b}")
    manifest = cpd.read_manifest(index)
    orig = {f: m["digest"] for f, m in manifest["blocks"].items()}
    reps = manifest.get("replica_files", [])
    if (manifest.get("replication") != 2 or len(reps) != w
            or any(orig[r] != orig[r.replace("-r01", "")] for r in reps)):
        raise AssertionError(f"{tag} replicated manifest: replication "
                             f"{manifest.get('replication')}, {reps}")
    log(f"{tag} make_cpds --backend host with replication 2: "
        f"{out['replicated_build_s']:.3f} s wall for {w} build processes; "
        "each dump: 0 blocks built, build_blocks_resumed_total 2 (the "
        "primary, and the replica after its copy), "
        "replica_blocks_copied_total 1, 0 K1/K2 launches; the manifest "
        f"lists {len(reps)} replica_files, each with its primary's digest "
        f"({card_txt})")

    # 3. four faults: --verify and --scrub see each
    faults = {name(3, 0): "corrupt", name(5, 0): "missing",
              name(6, 0): "corrupt", name(2, 0, 1): "corrupt"}
    w5_replica_original = orig[name(5, 0, 1)]
    truncate_half(os.path.join(index, name(3, 0)))
    os.remove(os.path.join(index, name(5, 0)))
    mid = os.path.getsize(os.path.join(index, name(6, 0))) // 2
    flip_byte(os.path.join(index, name(6, 0)), mid)
    flip_byte(os.path.join(index, name(2, 0, 1)), mid + 4097)
    rc, rep, out["verify_faulted_s"] = verify_cli(conf, ["--verify"])
    seen = {**{f: "missing" for f in rep["missing"]},
            **{c["file"]: "corrupt" for c in rep["corrupt"]}}
    if rc != 3 or seen != faults or rep["ok"] != 2 * w - 4:
        raise AssertionError(f"{tag} --verify after the faults: rc {rc}, "
                             f"{rep}")
    rc, rep, out["scrub_s"] = verify_cli(
        conf, ["--scrub", "--scrub-passes", "1", "--scrub-interval", "0"])
    if rc != 3:
        raise AssertionError(f"{tag} --scrub: rc {rc}, {rep}")
    log(f"{tag} faults planted: {faults}; --verify exit 3 listing exactly "
        f"those ({out['verify_faulted_s']:.3f} s, crc32 over "
        f"{2 * index_bytes} B with the replicas); --scrub 1 pass exit 3 "
        f"({out['scrub_s']:.3f} s) on {card_txt}")

    # 4. anti-entropy: the flipped replica by copy, then a replica with no
    # primary by a recompute on the card
    k0 = read_build_launches()
    t0 = time.perf_counter()
    ae = cpd.anti_entropy(index, dc, graph=g, device="cuda")
    out["anti_entropy_copy_s"] = time.perf_counter() - t0
    k1 = read_build_launches()
    if (ae["healed"] != [name(2, 0, 1)] or ae["checked"] != w
            or [m["file"] for m in ae["mismatched"]] != [name(2, 0, 1)]
            or k1 != k0
            or digest_file(os.path.join(index, name(2, 0, 1)))
            != orig[name(2, 0)]):
        raise AssertionError(f"{tag} anti-entropy (copy): {ae}, launches "
                             f"{k0} -> {k1}")
    os.remove(os.path.join(index, name(5, 0, 1)))
    t0 = time.perf_counter()
    ae2 = cpd.anti_entropy(index, dc, graph=g, device="cuda")
    out["anti_entropy_recompute_s"] = time.perf_counter() - t0
    k2 = read_build_launches()
    recompute = {k: k2[k] - k1[k] for k in k2}
    if (ae2["healed"] != [name(5, 0, 1)]
            or recompute["relax_jacobi"] <= 0
            or recompute["first_moves"] <= 0
            or digest_file(os.path.join(index, name(5, 0, 1)))
            != w5_replica_original):
        raise AssertionError(f"{tag} anti-entropy (recompute): {ae2}, "
                             f"launches {recompute}")
    log(f"{tag} anti_entropy: the flipped replica {name(2, 0, 1)} healed "
        f"by copy in {out['anti_entropy_copy_s']:.3f} s (0 kernel "
        f"launches); {name(5, 0, 1)}, deleted with its primary, "
        f"recomputed on the card in {out['anti_entropy_recompute_s']:.3f} "
        f"s (K1 {recompute['relax_jacobi']}, K2 {recompute['first_moves']} "
        "launches); each healed replica's crc32 == its primary's original "
        f"digest ({card_txt})")

    # 5. worker 3's engine heals its torn block, then answers worker 3's
    # batches as its server did
    with open(os.path.join(index, "index.json"), "rb") as f:
        manifest_bytes = f.read()
    calls = []
    real_walk = eng.cuda_walk_batch

    def recording(*a, **kw):
        calls.append((a, kw))
        return real_walk(*a, **kw)

    owner = host["dc"].worker_of(queries[:, 1])
    mine = queries[owner == 3]
    w3_rounds = (("free-flow", RuntimeConfig(), "-", host["parts"], 0),
                 ("diff", RuntimeConfig(), ref["diff_path"], host["parts"],
                  1),
                 (f"k{CAMPAIGN_K}-extract",
                  RuntimeConfig(k_moves=CAMPAIGN_K, extract=True), "-",
                  host["parts_k"], 0))
    with HealTimer() as ht:
        k_before = read_build_launches()
        engine = eng.ShardEngine(g, dc, 3, index, device="cuda")
        k_after = read_build_launches()
        eng.cuda_walk_batch = recording
        try:
            answers = [engine.answer(mine, cfg, diff)
                       for _, cfg, diff, _, _ in w3_rounds]
            paths = engine.last_paths
        finally:
            eng.cuda_walk_batch = real_walk
        w3_heal = ht.heals[-1]
        with open(os.path.join(index, "index.json"), "rb") as f:
            same_manifest = f.read() == manifest_bytes
        if (k_after["relax_jacobi"] <= k_before["relax_jacobi"]
                or k_after["first_moves"] <= k_before["first_moves"]
                or not os.path.exists(os.path.join(
                    index, name(3, 0) + ".quarantined"))
                or digest_file(os.path.join(index, name(3, 0)))
                != orig[name(3, 0)] or not same_manifest
                or w3_heal["file"] != name(3, 0)):
            raise AssertionError(f"{tag} worker 3's engine heal: launches "
                                 f"{k_before} -> {k_after}, {w3_heal}, "
                                 f"manifest unchanged {same_manifest}")
        for (rname, _, _, rows_of, expe), (cost, plen, fin, stats) in zip(
                w3_rounds, answers):
            row = [p for p in rows_of if p["expe"] == str(expe)][3]
            if (stats.plen, stats.finished) != (int(row["plen"]),
                                                int(row["finished"])):
                raise AssertionError(f"{tag} worker 3 {rname}: {stats} != "
                                     f"its server's row {row}")
            if rname in ref["direct"]:
                want = ref["direct"][rname]
                for got, exp in zip((cost, plen, fin), want):
                    if not np.array_equal(got, np.asarray(exp)[owner == 3]):
                        raise AssertionError(f"{tag} worker 3 {rname} "
                                             "answers differ from the "
                                             "campaign's")
        got_paths = np.concatenate([mine, paths[1][:, None], paths[0]],
                                   axis=1)
        if not np.array_equal(got_paths,
                              host["paths_in_order"][owner == 3]):
            raise AssertionError(f"{tag} worker 3's k{CAMPAIGN_K} paths != "
                                 "its server's")
        log(f"{tag} ShardEngine(worker 3) healed {name(3, 0)}: quarantined "
            f"{w3_heal['quarantine_s']:.4f} s, rebuilt on the card "
            f"{w3_heal['rebuild_s']:.3f} s (K1 "
            f"{k_after['relax_jacobi'] - k_before['relax_jacobi']}, K2 "
            f"{k_after['first_moves'] - k_before['first_moves']} launches), "
            f"reloaded and checked {w3_heal['reload_s']:.3f} s; crc32 == "
            "the manifest's, index.json unchanged; worker 3's free-flow, "
            f"diff and k{CAMPAIGN_K}-extract batches ({len(mine)} queries) "
            "answered as its server did (plen/finished sums, per-query "
            f"costs == the campaign's, paths == paths.csv) ({card_txt})")
        del engine

        # 6. worker 6's flipped block heals through its engine; then
        # --adopt-shard in a process of its own heals the missing block
        # while step 7 runs here (the campaign index, another directory)
        eng.ShardEngine(g, dc, 6, index, device="cuda")
        w6_heal = ht.heals[-1]
        if (w6_heal["file"] != name(6, 0)
                or digest_file(os.path.join(index, name(6, 0)))
                != orig[name(6, 0)]):
            raise AssertionError(f"{tag} worker 6's engine heal: {w6_heal}")
        log(f"{tag} ShardEngine(worker 6) healed {name(6, 0)}: quarantine "
            f"{w6_heal['quarantine_s']:.4f} s, rebuild "
            f"{w6_heal['rebuild_s']:.3f} s, reload {w6_heal['reload_s']:.3f}"
            f" s; crc32 == the manifest's ({card_txt})")
        gc.collect()
        torch.cuda.empty_cache()
        adopt_dump = os.path.join(os.path.dirname(conf), "heal-adopt.json")
        adopt_log = os.path.join(os.path.dirname(conf), "heal-adopt.log")
        t0 = time.perf_counter()
        with open(adopt_log, "w") as lf:
            adopt_proc = subprocess.Popen(
                [sys.executable, "-m",
                 "distributed_oracle_search_tpu_torch.worker.build",
                 "--input", ref["xy"], "--partmethod", "mod", "--partkey",
                 str(w), "--workerid", "5", "--maxworker", str(w),
                 "--outdir", index, "--adopt-shard", "5", "--device", "cuda",
                 "--metrics-dump", adopt_dump],
                cwd=ROOT, stdout=lf, stderr=subprocess.STDOUT)

        try:
            # 7. the in-process oracle on the campaign index (the adopt
            # process running beside it)
            cdc = DistributionController("tpu", CAMPAIGN_WORKERS,
                                         CAMPAIGN_WORKERS, g.n)
            victim = os.path.join(campaign_index, name(2, 0))
            c_digest = cpd.read_manifest(campaign_index)["blocks"][name(2, 0)][
                "digest"]
            truncate_half(victim)
            t0 = time.perf_counter()
            healed = cpd.CPDOracle(g, cdc, device="cuda").load(campaign_index,
                                                               heal=True)
            out["oracle_load_heal_s"] = time.perf_counter() - t0
            oracle_heal = ht.heals[-1]
            rows = np.load(victim)
            if (digest_file(victim) != c_digest
                    or not np.array_equal(
                        healed.fm[2, :len(rows)].cpu().numpy(), rows)):
                raise AssertionError(f"{tag} CPDOracle.load(heal=True): "
                                     "the healed block differs from the "
                                     "one before the fault")
            del rows
            got = healed.query(queries)
            for x, want in zip(got, ref["direct"]["free-flow"]):
                if not np.array_equal(x, want):
                    raise AssertionError(f"{tag} the healed oracle's "
                                         "free-flow answers differ from the "
                                         "campaign's")
            del healed
            gc.collect()
            torch.cuda.empty_cache()
        except BaseException:
            if adopt_proc.poll() is None:
                adopt_proc.kill()
                adopt_proc.wait(timeout=30)
            raise
        try:
            adopt_rc = adopt_proc.wait(timeout=600)
        except subprocess.TimeoutExpired:
            adopt_proc.kill()
            adopt_proc.wait(timeout=30)
            raise
        out["adopt_s"] = time.perf_counter() - t0
        if adopt_rc != 0:
            with open(adopt_log, errors="replace") as f:
                raise AssertionError(f"{tag} --adopt-shard 5: rc {adopt_rc}"
                                     f"\n{f.read()[-3000:]}")
        with open(adopt_dump) as f:
            adopt = json.load(f)
        ac = adopt["counters"]
        if (ac["reshard_blocks_adopted_total"] != 1
                or ac["cpd_blocks_rebuilt_total"] != 1
                or ac["relax_jacobi.launches"] <= 0
                or ac["first_moves.launches"] <= 0
                or adopt["device"]["name"] != card
                or digest_file(os.path.join(index, name(5, 0)))
                != orig[name(5, 0)]):
            raise AssertionError(f"{tag} --adopt-shard 5 dump: {adopt}")
        log(f"{tag} worker.build --adopt-shard 5 (its own process, beside "
            f"the oracle's load): {out['adopt_s']:.3f} s wall, "
            f"{adopt['seconds']:.3f} s in adopt_shard_blocks; dump: device "
            f"{adopt['device']['name']!r}, K1 {ac['relax_jacobi.launches']}, "
            f"K2 {ac['first_moves.launches']} launches, "
            "reshard_blocks_adopted_total 1, cpd_blocks_rebuilt_total 1; "
            f"crc32 == the manifest's ({card_txt})")
    second = os.path.join(campaign_index, name(0, 0))
    with open(second, "rb") as f:
        second_bytes = f.read()
    truncate_half(second)
    try:
        cpd.CPDOracle(g, cdc, device="cuda").load(campaign_index,
                                                  heal=False)
        raise AssertionError(f"{tag} load(heal=False) served a torn block")
    except ValueError as e:
        if name(0, 0) not in str(e):
            raise
        refusal = str(e)
    finally:
        with open(second, "wb") as f:
            f.write(second_bytes)
        gc.collect()
        torch.cuda.empty_cache()
    log(f"{tag} CPDOracle.load(heal=True) on the campaign index with "
        f"{name(2, 0)} torn: {out['oracle_load_heal_s']:.3f} s (quarantine "
        f"{oracle_heal['quarantine_s']:.4f} s, rebuild "
        f"{oracle_heal['rebuild_s']:.3f} s, reload "
        f"{oracle_heal['reload_s']:.3f} s); the block's crc32 and the "
        f"oracle's rows of it == before the fault, {len(queries)} free-flow "
        f"answers == the campaign's; "
        f"load(heal=False) on a fresh fault raised: {refusal[:120]} "
        f"({card_txt})")

    # the main run's counts, before any comparison with a plain version
    counts = read_build_launches()
    counts["relax_jacobi"] += ac["relax_jacobi.launches"]
    counts["first_moves"] += ac["first_moves.launches"]
    counts["grid_sweep_cycle"] += ac["grid_sweep.launches"]
    launches = cw.cuda_walk_batch.launches
    if cw.cuda_walk_batch.plain:
        raise AssertionError(f"{tag} {cw.cuda_walk_batch.plain} plain walks")
    if launches <= 0 or counts["relax_jacobi"] <= 0 or \
            counts["first_moves"] <= 0:
        raise AssertionError(f"{tag} launches: walk {launches}, build "
                             f"{counts}")
    log(f"{tag} launches in the phase's run: raw walk {launches} (no plain "
        f"walk), build kernels {counts} (this process and the adopt "
        "process's dump)")
    per_round = [kernel_vs_plain(r[0], call, f"{tag} kernel w3")
                 for r, call in zip(w3_rounds, calls)]
    del calls

    # 8. the closing check: every manifest digest as before the faults
    # (each healed block's crc32 was checked against it as it healed)
    now = {f: m["digest"]
           for f, m in cpd.read_manifest(index)["blocks"].items()}
    if len(now) != 2 * w or now != orig:
        raise AssertionError(f"{tag} closing manifest: {now} != {orig}")
    log(f"{tag} closing manifest: all {2 * w} digests equal to their "
        f"values before the faults on {card_txt}")
    heals = {"w3_engine": w3_heal, "w6_engine": w6_heal,
             "oracle": oracle_heal}
    return {"launches": launches, **headline(per_round[0]),
            "max_abs_err": max(x["max_abs_err"] for x in per_round),
            **out, "heals": heals, "anti_entropy_launches": recompute,
            "adopt_launches": {k: ac[f"{k}.launches"] for k in
                               ("relax_jacobi", "first_moves")},
            "rounds": per_round}, counts


# ------------------------------------------------------------------ rpc path

def free_port() -> int:
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def socket_dir(path: str) -> str:
    """``path`` as this process and its servers reach it: absolute while
    a socket name under it fits a Unix socket address (108 bytes), else
    relative to the working directory every process shares."""
    return path if len(path) < 80 else os.path.relpath(path)


def rpc_path(ref: dict, host: dict, host_round_s: list) -> dict:
    """``[rpc]``, on ``[heal]``'s healed replicated index (8 ``mod``
    workers, ``replication: 2``, one 512 MiB block a shard and a
    replica): 8 port ``worker.server`` processes with RPC listeners on
    Unix sockets under the run's directory (``DOS_TRANSPORT=rpc``,
    ``DOS_RPC_SOCKET_DIR``), each with ``--metrics-dump``, one with
    ``--obs-port``; worker 3's environment arms
    ``kill-mid-batch;wid=3;times=1`` (exit 86). ``process_query
    --backend host`` over RPC — the rounds, then ``-k 8 --extract``, with
    ``--trace`` and ``--metrics-dump`` (breaker threshold 1, no retry).
    Checked: worker 3 exits 86 on its first batch; ``failover_total``
    counts every batch of shard 3, each answered by worker 4 (its
    ``server_replica_batches_total``); worker 3's breaker is open at the
    close and in the head's dump; ``parts.csv`` rows and ``paths.csv``
    equal ``[host]``'s FIFO campaign's, every query finished; per-query
    answers of an RPC batch a shard (shard 3's to worker 4) equal the
    campaign's; every dump shows B1 launches equal to its batches plus
    its ``obs.device`` captures (one launch a program key) and no plain
    walk, and an ``obs.device`` ``table-search[cuda]`` entry;
    the trace holds the servers' ``worker.search`` spans under the
    head's batch trace ids; ``obs_metrics.json``; a ``/metrics`` scrape
    in Prometheus text; the other servers stop on their token and exit
    0, and ``nvidia-smi`` lists none of their PIDs. Logged, not claimed:
    RPC round q/s beside ``[host]``'s FIFO q/s, the failover's seconds,
    the phase's wall time."""
    tag = "[rpc]"
    t_phase = time.perf_counter()
    card_txt = card_line()
    card = torch.cuda.get_device_name(0)
    g, queries = ref["g"], ref["queries"]
    w, dead, holder = HOST_WORKERS, RPC_KILLED, (RPC_KILLED + 1) % HOST_WORKERS
    conf = host["conf"][:-len(".json")] + "-r2.json"
    run_dir = os.path.dirname(conf)
    nfs = ClusterConfig.load(conf).nfs
    socks = os.path.join(run_dir, "rpc-socks")
    os.makedirs(socks)
    fifos = {x: os.path.join(run_dir, f"rpc-worker{x}.fifo")
             for x in range(w)}
    dump = os.path.join(run_dir, "rpc-serve")
    head_dump = os.path.join(run_dir, "rpc-head.json")
    trace_path = os.path.join(run_dir, "rpc.trace.json")
    out_rounds = os.path.join(run_dir, "rpc-rounds")
    out_k = os.path.join(run_dir, f"rpc-k{CAMPAIGN_K}")
    obs_port = free_port()
    knobs = {"DOS_TRANSPORT": "rpc", "DOS_RPC_SOCKET_DIR": socket_dir(socks),
             "DOS_CIRCUIT_THRESHOLD": "1", "DOS_RETRY_MAX": "0",
             "DOS_SEND_TIMEOUT_S": str(HOST_SEND_TIMEOUT_S)}
    saved = {k: os.environ.get(k) for k in knobs}
    fifo_names = (make_fifos.command_fifo_path,
                  process_query.command_fifo_path)
    make_fifos.command_fifo_path = process_query.command_fifo_path = \
        fifos.__getitem__
    procs: dict = {}
    exits: dict = {}
    breakers: list = []
    real_shutdown = resilience.BreakerRegistry.shutdown

    def shutdown(self, *a, **kw):
        breakers.append(self.snapshot())
        return real_shutdown(self, *a, **kw)

    try:
        os.environ.update(knobs)
        t_launch = time.perf_counter()
        for x in range(w):
            cmd = make_fifos.worker_server_cmd(x, conf, device="cuda",
                                               metrics_dump=dump)
            if x == RPC_OBS_WORKER:
                cmd += f" --obs-port {obs_port}"
            env = dict(os.environ, DOS_TELEMETRY_INTERVAL_S=RPC_TELEMETRY_S)
            if x == dead:
                env["DOS_FAULTS"] = f"kill-mid-batch;wid={dead};times=1"
            with open(os.path.join(nfs, f"rpc-{x}.log"), "w") as lf:
                procs[x] = subprocess.Popen(cmd.split(), env=env, cwd=ROOT,
                                            stdout=lf,
                                            stderr=subprocess.STDOUT)
        ready = wait_ready(fifos, procs, nfs, t_launch, HOST_READY_S)
        if len(ready) != w:
            raise AssertionError(f"{tag} servers {sorted(set(fifos) - set(ready))}"
                                 f" did not answer a ping within "
                                 f"{HOST_READY_S} s")
        pids = {x: p.pid for x, p in procs.items()}
        ready_s = max(s for _, s in ready.values())
        log(f"{tag} 8 servers (port worker.server, RPC listeners on Unix "
            f"sockets) ready {ready_s:.2f} s after launch")
        c0 = obs_metrics.REGISTRY.snapshot()["counters"]
        resilience.BreakerRegistry.shutdown = shutdown
        with RoundTimer() as rt:
            rcs = [process_query.main(["-c", conf, "-o", out_rounds,
                                       "--trace", trace_path,
                                       "--metrics-dump", head_dump])]
            # --trace turned span collection on for the process: off
            # again, so no later run records spans
            obs_trace.enable(False)
            obs_trace.set_trace_id(None)
            obs_trace.clear()
            rcs.append(process_query.main(
                ["-c", conf, "-o", out_k, "-k", str(CAMPAIGN_K),
                 "--extract"]))
        c1 = obs_metrics.REGISTRY.snapshot()["counters"]
        resilience.BreakerRegistry.shutdown = real_shutdown
        procs[dead].wait(timeout=60)
        if procs[dead].returncode != KILL_EXIT_CODE:
            raise AssertionError(f"{tag} worker {dead} exit code "
                                 f"{procs[dead].returncode}, not "
                                 f"{KILL_EXIT_CODE}")
        # one RPC batch a shard with its per-query answers: shard 3's to
        # worker 4, the holder of its replica
        owner = host["dc"].worker_of(queries[:, 1])
        per_query = {}
        for shard in range(w):
            mine = np.ascontiguousarray(queries[owner == shard], np.int64)
            to = holder if shard == dead else shard
            client = rpc.RpcClient(rpc.endpoint_for(to), timeout_s=120.0)
            try:
                fr = client.call({"kind": "req", "config": {"results": True},
                                  "diff": "-"}, [mine])
            finally:
                client.close()
            per_query[shard] = [np.array(a) for a in fr.arrays]
            want = [np.asarray(a)[owner == shard]
                    for a in ref["direct"]["free-flow"]]
            for got_a, want_a in zip(per_query[shard], want):
                if not np.array_equal(got_a.astype(np.int64),
                                      np.asarray(want_a).astype(np.int64)):
                    raise AssertionError(f"{tag} shard {shard}'s RPC "
                                         "answers differ from the "
                                         "campaign's")
        scrape = urllib.request.urlopen(
            f"http://127.0.0.1:{obs_port}/metrics", timeout=30)
        body, ctype = scrape.read().decode(), scrape.headers["Content-Type"]
        epoch_leg = rpc_epoch_leg(conf, ref, host, obs_port)
        apps = compute_apps()
    except BaseException:
        log_tails(nfs)
        raise
    finally:
        resilience.BreakerRegistry.shutdown = real_shutdown
        live = {x: p for x, p in procs.items() if x != dead}
        exits = stop_servers({x: fifos[x] for x in live}, live)
        if dead in procs and procs[dead].poll() is None:
            procs[dead].kill()
            procs[dead].wait(timeout=30)
        make_fifos.command_fifo_path, process_query.command_fifo_path = \
            fifo_names
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if any(exits.values()):
        raise AssertionError(f"{tag} server exit codes {exits}")
    after = set(compute_apps() or {}) & set(pids.values())
    if after:
        raise AssertionError(f"{tag} nvidia-smi still lists {sorted(after)}")
    if rcs != [0, 0]:
        raise AssertionError(f"{tag} process_query exit codes {rcs}")
    log(f"{tag} worker {dead} exited {KILL_EXIT_CODE} on its first batch "
        f"(kill-mid-batch); the other servers stopped on their token and "
        f"exited 0; nvidia-smi lists none of their PIDs")

    # failover: every batch of shard 3 went to worker 4
    shard_batches = 2 * 2
    delta = {k: c1.get(k, 0) - c0.get(k, 0) for k in (
        "failover_total", "head_circuit_open_total",
        "head_circuit_rejected_total", "head_batches_failed_total")}
    with open(head_dump) as f:
        hd = json.load(f)
    key3 = repr(("localhost", dead))
    if (delta["failover_total"] != shard_batches
            or delta["head_batches_failed_total"] != 0
            or len(breakers) != 2
            or any(b[key3]["state"] != "open" for b in breakers)
            or hd["gauges"]["head_circuits_open"] < 1
            or hd["counters"]["failover_total"] < 2):
        raise AssertionError(f"{tag} failover: {delta}, breakers "
                             f"{breakers}, head dump gauges {hd['gauges']}")
    log(f"{tag} failover_total {delta['failover_total']} == the "
        f"{shard_batches} batches of shard {dead} (2 runs x 2 rounds); "
        f"breaker of worker {dead} open at each run's close "
        f"(head_circuit_open_total +{delta['head_circuit_open_total']}, "
        f"rejected +{delta['head_circuit_rejected_total']}); the head's "
        f"dump: head_circuits_open {hd['gauges']['head_circuits_open']}")

    # answers: parts.csv and paths.csv equal [host]'s FIFO campaign
    def rows(path):
        return [{k: v for k, v in r.items() if not k.startswith("t_")}
                for r in read_parts(path)]
    for got_p, want_p in ((os.path.join(out_rounds, "parts.csv"),
                           host["parts"]),
                          (os.path.join(out_k, "parts.csv"),
                           host["parts_k"])):
        want_rows = [{k: v for k, v in r.items() if not k.startswith("t_")}
                     for r in want_p]
        if rows(got_p) != want_rows:
            raise AssertionError(f"{tag} {got_p} != [host]'s rows")
    rpc_paths = np.loadtxt(os.path.join(out_k, "paths.csv"), delimiter=",",
                           skiprows=1, dtype=np.int64)
    order = np.concatenate([np.flatnonzero(owner == x) for x in range(w)])
    in_order = np.empty_like(rpc_paths)
    in_order[order] = rpc_paths
    if not np.array_equal(in_order, host["paths_in_order"]):
        raise AssertionError(f"{tag} paths.csv != [host]'s")
    if not os.path.exists(os.path.join(out_rounds, "obs_metrics.json")):
        raise AssertionError(f"{tag} no obs_metrics.json")
    n = len(queries)
    log(f"{tag} parts.csv of both runs equals [host]'s FIFO campaign row "
        f"for row (timers aside; {n} queries, every one finished), "
        f"paths.csv in query order equals [host]'s; per-query answers of "
        f"one RPC batch a shard (shard {dead}'s to worker {holder}) equal "
        "the campaign's; obs_metrics.json written")

    # the servers' dumps
    launches, served, programs = 0, {}, {}
    for x in range(w):
        if x == dead:
            continue
        with open(f"{dump}.w{x}.json") as f:
            sv = json.load(f)
        c = sv["counters"]
        progs = {k: v for k, v in sv["device_programs"].items()
                 if k.startswith("table-search[cuda]")}
        if (sv["device"]["name"] != card or sv["pid"] != pids[x]
                or c["cuda_walk_batch.launches"]
                != c["worker_batches_total"] + len(sv["device_programs"])
                or c["cuda_walk_batch.plain"] != 0
                or c["rpc_server_batches_total"] != c["worker_batches_total"]
                or not progs or not all(
                    {"bytes_accessed", "hbm_bytes", "kernel_ms"} <= set(e)
                    and e["timer"] == "cuda-events"
                    for e in progs.values())):
            raise AssertionError(f"{tag} server {x} dump: {c}, {progs}")
        launches += c["cuda_walk_batch.launches"]
        served[x] = (c["worker_batches_total"],
                     c["server_replica_batches_total"])
        programs[x] = progs
    # beyond shard 3's batches and the direct one on worker 4, the
    # replica batches are the epoch leg's hedged duplicates, each on the
    # replica it went to (one still in flight when its burst ended may
    # not have landed)
    extra = sum(r for _, r in served.values()) - (shard_batches + 1)
    if (served[holder][1] < shard_batches + 1
            or not 0 <= extra <= epoch_leg["hedges"]):
        raise AssertionError(f"{tag} worker {holder} replica batches "
                             f"{served[holder]}, {extra} more in all for "
                             f"{epoch_leg['hedges']} hedges")
    first, e = min(programs[0].items())
    log(f"{tag} server dumps: B1 launches == batches served + obs.device "
        f"captures (one launch a program key) in each (total {launches}), "
        f"0 plain walks; batches, replica batches by "
        f"worker {served}; worker {holder} answered shard {dead}'s "
        f"{shard_batches} campaign batches and the direct one as its "
        f"replica, the replicas {extra} of the burst's "
        f"{epoch_leg['hedges']} hedges; obs.device {first}: bytes_accessed "
        f"{e['bytes_accessed']:.4g} (closed-form upper count), hbm_bytes "
        f"{e['hbm_bytes']}, kernel_ms {e['kernel_ms']:.4f} (CUDA events) "
        f"on {card_txt}")

    # the trace: the servers' worker.search spans under the head's ids
    with open(trace_path) as f:
        evs = json.load(f)["traceEvents"]
    head_ids = {ev["args"].get("trace_id") for ev in evs
                if ev["name"] == "head.send"}
    searches = [ev for ev in evs if ev["name"] == "worker.search"]
    if (not searches or any(ev["args"].get("trace_id") not in head_ids
                            for ev in searches)
            or {ev["pid"] for ev in searches} & {os.getpid()}
            or len({ev["pid"] for ev in searches}) != w - 1):
        raise AssertionError(f"{tag} trace: {len(searches)} worker.search "
                             f"spans, pids {sorted({e['pid'] for e in searches})}")
    sends = [ev for ev in evs if ev["name"] == "head.send"
             and ev["args"].get("shard") == dead]
    fail_ms = [ev["dur"] / 1e3 for ev in sends if ev["args"]["wid"] == dead]
    over_ms = [ev["dur"] / 1e3 for ev in sends if ev["args"]["wid"] != dead]
    log(f"{tag} trace: {len(searches)} worker.search spans from {w - 1} "
        f"server pids, each under a head.send trace id of the head "
        f"({len(evs)} events); shard {dead}'s sends: to worker {dead} "
        f"{fail_ms} ms (the batch it died on), to worker {holder} "
        f"{[round(x, 3) for x in over_ms]} ms")
    if not (ctype.startswith("text/plain; version=0.0.4")
            and "# TYPE rpc_server_batches_total counter" in body
            and "device_program_bytes_accessed{" in body):
        raise AssertionError(f"{tag} /metrics answered {ctype}: "
                             f"{body[:300]}")
    log(f"{tag} /metrics of worker {RPC_OBS_WORKER} (--obs-port): "
        f"Prometheus text ({ctype}), {len(body.splitlines())} lines")

    names = ["free-flow", "diff", f"k{CAMPAIGN_K} free-flow",
             f"k{CAMPAIGN_K} diff"]
    for name, sec, fifo_s in zip(names, rt.seconds, host_round_s):
        log(f"{tag} round {name}: {n} queries in {sec:.4f} s = "
            f"{n / sec:.1f} q/s over RPC on the host clock ([host] FIFO "
            f"{n / fifo_s:.1f} q/s)")
    wall = time.perf_counter() - t_phase
    log(f"{tag} failover: round free-flow {rt.seconds[0]:.4f} s with the "
        f"death and the replica's first load, round diff "
        f"{rt.seconds[1]:.4f} s: {rt.seconds[0] - rt.seconds[1]:.4f} s "
        f"added; phase wall time {wall:.1f} s on {card_txt}")
    return {"launches": launches, "round_s": rt.seconds[:4],
            "fifo_round_s": list(host_round_s), "ready_s": ready_s,
            "failover_total": delta["failover_total"],
            "failover_added_s": rt.seconds[0] - rt.seconds[1],
            "failed_send_ms": fail_ms, "failover_send_ms": over_ms,
            "program": {first: e}, "wall_s": wall, "epoch_leg": epoch_leg,
            "served": {str(k): v for k, v in served.items()}}


def parse_pair_lines(lines: list[str], tag: str) -> np.ndarray:
    """``[Q, 3]`` int64 ``(cost, plen, finished)`` of the line protocol's
    ``OK <s> <t> <cost> <plen> <finished> [cached]`` answers; any other
    status fails the phase."""
    out = np.zeros((len(lines), 3), np.int64)
    for i, line in enumerate(lines):
        tok = line.split()
        if len(tok) < 6 or tok[0] != "OK":
            raise AssertionError(f"{tag} answer {i}: {line!r}")
        out[i] = (int(tok[3]), int(tok[4]), int(tok[5]))
    return out


def held_to(got: np.ndarray, want, what: str, tag: str) -> None:
    """``got`` ([Q, 3] from :func:`parse_pair_lines`) equal to ``want``
    (``(cost, plen, finished)`` arrays), else the phase fails."""
    want = np.stack([np.asarray(a).astype(np.int64) for a in want[:3]],
                    axis=1)
    if not np.array_equal(got, want):
        bad = int((got != want).any(axis=1).sum())
        raise AssertionError(f"{tag} {what}: {bad} of {len(got)} answers "
                             "differ")


def rpc_telemetry_lanes(run_dir: str, live: list, holder: int,
                        tag: str) -> dict:
    """Both lanes of the servers' telemetry: each live server's FIFO
    sidecar (``<fifo>.telemetry``) holds ticks of its own source, and an
    RPC connection opened here to ``holder`` receives a ``telemetry``
    frame of ``holder``'s."""
    from distributed_oracle_search_tpu_torch.obs import telemetry

    out = {"sidecar_ticks": {}}
    for x in live:
        side = os.path.join(run_dir, f"rpc-worker{x}.fifo"
                            + telemetry.SIDECAR_SUFFIX)
        ticks = telemetry.read_sidecar(side) if os.path.exists(side) else []
        if not ticks or any(t["source"] != f"w{x}" for t in ticks):
            raise AssertionError(f"{tag} worker {x}'s sidecar: "
                                 f"{[t.get('source') for t in ticks]}")
        out["sidecar_ticks"][x] = len(ticks)
    seen: list = []
    rpc.set_telemetry_sink(seen.append)
    client = rpc.RpcClient(rpc.endpoint_for(holder), timeout_s=120.0)
    try:
        t0 = time.perf_counter()
        client.call({"kind": "ping"})
        while not any(t.get("source") == f"w{holder}" for t in seen):
            if time.perf_counter() - t0 > 10 * float(RPC_TELEMETRY_S):
                raise AssertionError(f"{tag} no telemetry frame from "
                                     f"worker {holder} over RPC")
            time.sleep(0.05)
        out["rpc_frame_s"] = time.perf_counter() - t0
    finally:
        client.close()
        rpc.set_telemetry_sink(None)
    return out


def wait_telemetry_sources(port: int, live: list, tag: str) -> list:
    """``/statusz``'s telemetry sources once every live server's
    (``w<wid>``) is among them."""
    t0 = time.perf_counter()
    want = {f"w{x}" for x in live}
    while True:
        sources = statusz(port).get("telemetry", {}).get("sources", {})
        if want <= set(sources):
            break
        if time.perf_counter() - t0 > 30:
            raise AssertionError(f"{tag} dos-serve's telemetry sources "
                                 f"{sorted(sources)}, want {sorted(want)}")
        time.sleep(0.1)
    return sorted(sources)


def rpc_epoch_leg(conf: str, ref: dict, host: dict, obs_port: int) -> dict:
    """``[rpc]``'s epoch leg, over its live servers: the committed leave
    of worker 3 (dead since its first batch) written by the port's
    ``MembershipController`` (shard 3 to worker 4, epoch 1), one more
    ``process_query`` run over RPC (every batch stamped epoch 1; the
    servers refresh; the rows equal ``[host]``'s; no failover), one RPC
    batch with ``answer_fp`` whose reply header carries its answers'
    fingerprint, and a ``dos-serve --backend host`` burst of
    ``RPC_BURST`` lines under ``DOS_TRANSPORT=rpc``, ``DOS_ANSWER_FP=1``
    and hedges on: exit 0, the campaign's answers, 0 fingerprint
    mismatches, a hedge issued. Leaves the fleet static again
    (``membership.json`` removed) for ``[serve]``."""
    tag = "[rpc]"
    t0 = time.perf_counter()
    g, queries = ref["g"], ref["queries"]
    w, dead = HOST_WORKERS, RPC_KILLED
    holder = (dead + 1) % w
    run_dir = os.path.dirname(conf)
    dc = DistributionController("mod", w, w, g.n, replication=2)
    mc = membership.MembershipController(ClusterConfig.load(conf), dc,
                                         graph=g, device="cuda")
    state = mc.leave(dead, live=[x for x in range(w) if x != dead])
    if state.epoch != 1 or state.owners[dead] != holder:
        raise AssertionError(f"{tag} leave of worker {dead}: "
                             f"{state.to_dict()}")
    t_commit = time.perf_counter() - t0
    c0 = obs_metrics.REGISTRY.snapshot()["counters"]
    out_epoch = os.path.join(run_dir, "rpc-epoch1")
    t1 = time.perf_counter()
    rc = process_query.main(["-c", conf, "-o", out_epoch])
    t_round = time.perf_counter() - t1
    c1 = obs_metrics.REGISTRY.snapshot()["counters"]
    grown = c1.get("failover_total", 0) - c0.get("failover_total", 0)

    def rows(parts):
        return [{k: v for k, v in r.items() if not k.startswith("t_")}
                for r in parts]
    if rc != 0 or grown or rows(read_parts(os.path.join(
            out_epoch, "parts.csv"))) != rows(host["parts"]):
        raise AssertionError(f"{tag} epoch-1 run: exit code {rc}, "
                             f"failover_total +{grown}, or rows differ "
                             "from [host]'s")
    with urllib.request.urlopen(f"http://127.0.0.1:{obs_port}/statusz",
                                timeout=30) as r:
        worker_epoch = json.load(r)["worker"]["epoch"]
    if worker_epoch != 1:
        raise AssertionError(f"{tag} worker {RPC_OBS_WORKER} /statusz "
                             f"epoch {worker_epoch}")
    # the fingerprint on an RPC reply header: shard 3's batch to its
    # owner now, worker 4
    owner = host["dc"].worker_of(queries[:, 1])
    mine = np.ascontiguousarray(queries[owner == dead], np.int64)
    client = rpc.RpcClient(rpc.endpoint_for(holder), timeout_s=120.0)
    try:
        fr = client.call({"kind": "req", "diff": "-", "config": {
            "results": True, "answer_fp": True, "epoch": 1}}, [mine])
    finally:
        client.close()
    fp = fr.header.get("fp")
    if fp is None or int(fp) != answer_fingerprint(*fr.arrays[:3]):
        raise AssertionError(f"{tag} reply header fingerprint {fp!r}")
    # dos-serve --backend host over the live servers, fingerprints on
    burst = queries[:RPC_BURST]
    dump = os.path.join(run_dir, "rpc-serve-burst.json")
    # the head's campaign knobs (breaker threshold 1, no retry) stay
    # with the campaign; the burst runs the service's defaults, with a
    # small hedge budget (a hedge makes a server load a replica engine,
    # 512 MiB)
    env = {k: v for k, v in os.environ.items()
           if k not in ("DOS_CIRCUIT_THRESHOLD", "DOS_RETRY_MAX",
                        "DOS_SEND_TIMEOUT_S")}
    env.update(DOS_TRANSPORT="rpc", DOS_ANSWER_FP="1",
               DOS_HEDGE_BUDGET=SERVE_HEDGE_BUDGET)
    live = [x for x in range(w) if x != dead]
    tele = rpc_telemetry_lanes(run_dir, live, holder, tag)
    out_path = os.path.join(run_dir, "rpc-serve-burst.out")
    err_path = os.path.join(run_dir, "rpc-serve-burst.log")
    t2 = time.perf_counter()
    with open(out_path, "w") as fo, open(err_path, "w") as fe:
        # dos-serve polls the servers' .telemetry sidecars beside their
        # FIFOs, under this run's directory
        proc = subprocess.Popen(
            [sys.executable, "-c", SERVE_WITH_FIFOS, run_dir, "-c", conf,
             "-v", "--backend", "host", "--metrics-dump", dump,
             "--obs-port", "0", *SERVE_KNOBS],
            stdin=subprocess.PIPE, stdout=fo, stderr=fe, text=True,
            cwd=ROOT, env=env)
        try:
            proc.stdin.write("".join(f"{s} {t}\n" for s, t in burst))
            proc.stdin.flush()
            port = wait_obs_port(proc, err_path, (), tag, SERVE_READY_S)
            t_up = time.perf_counter()
            tele["serve"] = wait_telemetry_sources(port, live, tag)
            tele["serve_s"] = time.perf_counter() - t_up
            proc.stdin.close()
            rc = proc.wait(timeout=300)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
    t_burst = time.perf_counter() - t2
    with open(err_path, errors="replace") as f:
        stderr = f.read()
    with open(out_path) as f:
        stdout = f.read()
    split = log_split(stderr, ("ingress closed", "drained and stopped"))
    if rc != 0:
        raise AssertionError(f"{tag} dos-serve --backend host exited "
                             f"{rc}: {stderr[-2000:]}")
    got = parse_pair_lines(stdout.splitlines(), f"{tag} burst")
    held_to(got, [np.asarray(a)[:RPC_BURST]
                  for a in ref["direct"]["free-flow"]],
            "dos-serve --backend host", tag)
    with open(dump) as f:
        c = json.load(f)["counters"]
    if (c.get("answer_fp_mismatch_total", 0) != 0
            or c.get("serve_requests_ok_total") != len(burst)
            or not c.get("hedges_issued_total", 0)):
        raise AssertionError(f"{tag} burst dump: {c}")
    os.remove(membership.state_path(ClusterConfig.load(conf).outdir))
    wall = time.perf_counter() - t0
    log(f"{tag} epoch leg: worker {dead}'s leave committed (shard {dead} "
        f"to worker {holder}, epoch 1) in {t_commit:.3f} s; process_query "
        f"over RPC at epoch 1 in {t_round:.3f} s: rows == [host]'s, "
        f"failover_total +0, worker {RPC_OBS_WORKER} /statusz epoch 1; an "
        f"answer_fp batch to worker {holder}: reply header fp "
        f"{int(fp):08x} == the answers' crc32; dos-serve --backend host "
        f"(DOS_TRANSPORT=rpc, DOS_ANSWER_FP=1, DOS_HEDGE_BUDGET="
        f"{SERVE_HEDGE_BUDGET}) answered {len(burst)} lines in "
        f"{t_burst:.3f} s wall (exit 0, == the campaign's, "
        f"answer_fp_mismatch_total 0, hedges issued "
        f"{c['hedges_issued_total']}, won {c.get('hedges_won_total', 0)}; "
        f"its log from the first line to "
        f"'ingress closed' / 'drained': {split}); leg {wall:.2f} s")
    log(f"{tag} telemetry (DOS_TELEMETRY_INTERVAL_S={RPC_TELEMETRY_S} on "
        f"the servers): a .telemetry sidecar beside each live server's "
        f"FIFO ({tele['sidecar_ticks']} ticks), a telemetry frame from "
        f"worker {holder} on an RPC connection opened here after "
        f"{tele['rpc_frame_s']:.2f} s; dos-serve's /statusz telemetry "
        f"showed ticks from all {len(live)} live servers "
        f"({sorted(tele['serve'])}) {tele['serve_s']:.2f} s after it was "
        "up, ingested from the RPC frames and the polled sidecars")
    return {"commit_s": t_commit, "round_s": t_round, "burst_s": t_burst,
            "telemetry": {k: v for k, v in tele.items() if k != "serve"},
            "burst_log_s": split, "burst_lines": len(burst),
            "hedges": c["hedges_issued_total"], "wall_s": wall}


def log_split(text: str, marks: tuple[str, ...]) -> list[float | None]:
    """Seconds from a ``-v`` log's first timestamped line to the first
    line holding each of ``marks`` (None where a mark is missing)."""
    stamps = []
    for line in text.splitlines():
        hit = re.match(r"(\d{4}-\d\d-\d\d \d\d:\d\d:\d\d),(\d{3}) ", line)
        if hit:
            t = time.mktime(time.strptime(hit.group(1),
                                          "%Y-%m-%d %H:%M:%S"))
            stamps.append((t + int(hit.group(2)) / 1e3, line))
    if not stamps:
        return [None] * len(marks)
    t0 = stamps[0][0]
    return [next((round(t - t0, 3) for t, line in stamps if m in line), None)
            for m in marks]



# ---------------------------------------------------------------- serve path

class ServeClient:
    """One connection to ``dos-serve --ingress socket``: the request
    lines go out on a thread, one answer line comes back per request
    line, in order."""

    def __init__(self, path: str, timeout_s: float = 300.0):
        self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self.sock.settimeout(timeout_s)
        self.sock.connect(path)
        self.rfile = self.sock.makefile("r")

    def ask(self, lines: list[str]) -> list[str]:
        data = "".join(f"{ln}\n" for ln in lines).encode()
        sender = threading.Thread(target=self.sock.sendall, args=(data,),
                                  daemon=True)
        sender.start()
        out = [self.rfile.readline().rstrip("\n") for _ in lines]
        sender.join(timeout=60)
        return out

    def close(self) -> None:
        self.rfile.close()
        self.sock.close()


def engine_answers(engines: dict, dc, q: np.ndarray, difffile: str = "-"):
    """``(cost, plen, finished)`` of ``q`` by the engines of the shards
    its targets lie in."""
    owner = dc.worker_of(q[:, 1])
    cost = np.zeros(len(q), np.int64)
    plen = np.zeros(len(q), np.int64)
    fin = np.zeros(len(q), bool)
    for x, e in engines.items():
        m = owner == x
        if m.any():
            cost[m], plen[m], fin[m], _ = e.answer(
                np.ascontiguousarray(q[m]), RuntimeConfig(), difffile)
    return cost, plen, fin


def family_lines(queries: np.ndarray, rng) -> list[tuple[str, tuple]]:
    """``SERVE_FAMILIES`` requests of each family, from the campaign's
    queries: ``mat`` from a source to ``SERVE_MAT_K`` targets, ``alt``
    with ``SERVE_ALT_K`` alternatives, ``rev``."""
    out = []
    pick = rng.choice(len(queries), 3 * SERVE_FAMILIES, replace=False)
    for i in pick[:SERVE_FAMILIES]:
        s = int(queries[i, 0])
        ts = [int(x) for x in queries[rng.integers(0, len(queries),
                                                   SERVE_MAT_K), 1]]
        out.append(("mat", (s, ts)))
    for i in pick[SERVE_FAMILIES:2 * SERVE_FAMILIES]:
        out.append(("alt", (int(queries[i, 0]), int(queries[i, 1]))))
    for i in pick[2 * SERVE_FAMILIES:]:
        out.append(("rev", (int(queries[i, 0]), int(queries[i, 1]))))
    return out


def family_reference(g, engines: dict, dc, fams) -> list[str]:
    """Each family's answer line by its definition, from the engines'
    walks under free flow: ``mat`` the pair costs (-1 where unfinished),
    ``alt`` the ``SERVE_ALT_K`` cheapest first edge + the walk from its
    head, ``rev`` the walk back."""
    pairs = []
    for kind, (s, arg) in fams:
        if kind == "mat":
            pairs += [(s, t) for t in arg]
        elif kind == "alt":
            nbrs, _eids = g.out_edges(s)
            pairs += [(int(v), arg) for v in nbrs]
        else:
            pairs.append((arg, s))
    q = np.asarray(pairs, np.int64)
    cost, plen, fin = engine_answers(engines, dc, q)
    lines, i = [], 0
    for kind, (s, arg) in fams:
        if kind == "mat":
            k = len(arg)
            costs = [int(c) if f else -1
                     for c, f in zip(cost[i:i + k], fin[i:i + k])]
            lines.append(" ".join(["MAT", str(s), str(k)]
                                  + [str(c) for c in costs]))
            i += k
        elif kind == "alt":
            nbrs, eids = g.out_edges(s)
            alts = sorted((int(g.w[e]) + int(cost[i + j]), int(v))
                          for j, (v, e) in enumerate(zip(nbrs, eids))
                          if fin[i + j])[:SERVE_ALT_K]
            lines.append(" ".join(["ALT", str(s), str(arg), str(len(alts))]
                                  + [str(c) for c, _v in alts]))
            i += len(nbrs)
        else:
            lines.append(f"REV {s} {arg} {cost[i]} {plen[i]} "
                         f"{int(fin[i])}")
            i += 1
    return lines


def family_request(kind: str, args) -> str:
    s, arg = args
    if kind == "mat":
        return "mat " + " ".join(str(x) for x in (s, *arg))
    if kind == "alt":
        return f"alt {s} {arg} {SERVE_ALT_K}"
    return f"rev {s} {arg}"


def statusz(port: int) -> dict:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/statusz",
                                timeout=30) as r:
        return json.load(r)


def window_quantiles(port: int, name: str) -> dict[str, float | None]:
    """``p50``/``p99`` of ``name``'s live window on ``/metrics`` (the
    ``<name>_window{quantile=...}`` gauges)."""
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=30) as r:
        text = r.read().decode()
    out = {}
    for label, q in (("p50", "0.5"), ("p99", "0.99")):
        hit = re.search(rf'^{name}_window{{quantile="{q}"}} (\S+)$', text,
                        re.M)
        out[label] = float(hit.group(1)) if hit else None
    return out


def serve_path(ref: dict, host: dict) -> tuple[dict, dict[str, int]]:
    """``[serve]``: ``dos-serve`` (``cli.serve``, ``--backend inproc`` on
    the card) over ``[rpc]``'s healed replicated index, driven through
    its Unix socket ingress. Returns the phase's entry and the build
    kernels' launches of its catch-up (this process)."""
    tag = "[serve]"
    t_phase = time.perf_counter()
    card_txt = card_line()
    card = torch.cuda.get_device_name(0)
    g, queries = ref["g"], ref["queries"]
    w, leaver = HOST_WORKERS, SERVE_LEAVE
    adopter = (leaver + 1) % w
    conf = host["conf"][:-len(".json")] + "-r2.json"
    cconf = ClusterConfig.load(conf)
    run_dir = os.path.dirname(conf)
    dc = DistributionController("mod", w, w, g.n, replication=2)
    traffic = os.path.join(run_dir, "traffic")
    os.makedirs(traffic)
    sock = socket_dir(os.path.join(run_dir, "serve.sock"))
    dump = os.path.join(run_dir, "serve-dump.json")
    log_path = os.path.join(run_dir, "serve.log")
    cmd = [sys.executable, "-m", "distributed_oracle_search_tpu_torch.cli."
           "serve", "-c", conf, "-v", "--backend", "inproc", "--ingress",
           "socket", "--socket", sock, "--traffic-dir", traffic,
           "--obs-port", "0", "--metrics-dump", dump, *SERVE_KNOBS]
    # hedges on, with a small budget: a hedge makes the in-process
    # dispatcher load a replica engine (512 MiB) under its one lock,
    # stalling every shard's lane
    env = dict(os.environ, DOS_ANSWER_FP="1",
               DOS_HEDGE_BUDGET=SERVE_HEDGE_BUDGET,
               DOS_TRAFFIC_SIG_MOVES=SERVE_SIG_MOVES)
    out: dict = {"card": card_txt}
    with open(log_path, "w") as lf, MemorySampler() as mem:
        t_launch = time.perf_counter()
        proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=lf,
                                stderr=subprocess.STDOUT)
        try:
            # this process's engines, the reference of every answer the
            # service gives (loaded while the service starts)
            engines = {x: eng.ShardEngine(g, dc, x, cconf.outdir,
                                          device="cuda")
                       for x in range(w)}
            out["engines_s"] = time.perf_counter() - t_launch
            log(f"{tag} {w} reference engines loaded here in "
                f"{out['engines_s']:.2f} s (dos-serve starting beside)")
            port = None
            deadline = time.perf_counter() + SERVE_READY_S
            while port is None or not os.path.exists(sock):
                if proc.poll() is not None or time.perf_counter() > deadline:
                    raise AssertionError(f"{tag} dos-serve exited "
                                         f"{proc.returncode} or was not "
                                         "up in time")
                with open(log_path, errors="replace") as f:
                    hit = re.search(r"obs endpoints up on :(\d+)", f.read())
                port = int(hit.group(1)) if hit else None
                time.sleep(0.1)
            out["ready_s"] = time.perf_counter() - t_launch
            client = ServeClient(sock)
            direct = ref["direct"]["free-flow"]
            out.update(serve_traffic(client, port, g, queries, direct,
                                     engines, dc, traffic, tag))
            zero_launches()
            out.update(serve_leave(client, port, cconf, dc, g, queries,
                                   direct, leaver, adopter, tag))
            build_counts = read_build_launches()
            lat = window_quantiles(port, "serve_request_seconds")
            client.close()
            del engines
            gc.collect()
            torch.cuda.empty_cache()
            t_stop = time.perf_counter()
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=120)
            out["drain_s"] = time.perf_counter() - t_stop
        except BaseException:
            with open(log_path, errors="replace") as f:
                log(f"{tag} --- serve.log (last 3000 characters) ---\n"
                    f"{f.read()[-3000:]}")
            raise
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
    if rc != 0:
        raise AssertionError(f"{tag} dos-serve exited {rc} on SIGTERM")
    with open(dump) as f:
        sv = json.load(f)
    c = sv["counters"]
    check_serve_phase_dump(sv, card, tag)
    if not (c.get("hedges_issued_total", 0)
            and c.get("serve_cache_invalidated_scoped_total", 0)
            and c.get("serve_cache_rekeyed_total", 0)):
        raise AssertionError(f"{tag} no hedge, scoped invalidation or "
                             f"re-key in the dump: {c}")
    hits = c.get("serve_cache_hits_total", 0)
    misses = c.get("serve_cache_misses_total", 0)
    fill = sv["histograms"]["serve_batch_fill"]
    swap = sv["histograms"].get("traffic_swap_seconds", {})
    out.update(
        launches=c["cuda_walk_batch.launches"],
        batches=c["worker_batches_total"],
        programs=len(sv["device_programs"]),
        requests=c.get("serve_requests_total", 0),
        cache_hit_rate=hits / max(hits + misses, 1),
        mean_batch_fill=fill["sum"] / max(fill["count"], 1),
        swap_s_mean=swap.get("sum", 0.0) / max(swap.get("count", 0), 1),
        scoped=c.get("serve_cache_invalidated_scoped_total", 0),
        full=c.get("serve_cache_invalidated_full_total", 0),
        rekeyed=c.get("serve_cache_rekeyed_total", 0),
        hedges=c.get("hedges_issued_total", 0),
        hedges_won=c.get("hedges_won_total", 0),
        p50_ms=(lat["p50"] or 0.0) * 1e3, p99_ms=(lat["p99"] or 0.0) * 1e3,
        serve_peak_bytes=sv["device"]["max_memory_allocated"],
        card_peak_mib=mem.peak_mib, build_launches=build_counts,
        wall_s=time.perf_counter() - t_phase)
    log(f"{tag} SIGTERM: exit 0 in {out['drain_s']:.2f} s, every accepted "
        f"request answered; dump on {card}: {out['requests']} requests, "
        f"0 shed, B1 launches {out['launches']} == {out['batches']} "
        f"batches walked + {len(sv['device_programs'])} obs.device program "
        f"keys, 0 plain walks, 0 pack4, answer_fp_mismatch_total 0")
    log(f"{tag} host clock (logged, not claimed): request latency in the "
        f"frontend (serve_request_seconds, its /metrics window) p50 "
        f"{out['p50_ms']:.3f} ms, p99 {out['p99_ms']:.3f} ms; "
        f"cache hit rate {out['cache_hit_rate']:.4f}; mean batch fill "
        f"{out['mean_batch_fill']:.2f}; swap {out['swap_s_mean']:.4f} s "
        f"mean; invalidations scoped {out['scoped']} full {out['full']} "
        f"(re-keyed {out['rekeyed']}); hedges issued {out['hedges']}, won "
        f"{out['hedges_won']}; peak device memory: dos-serve "
        f"{out['serve_peak_bytes'] / 2**30:.2f} GiB allocated, the card "
        f"{out['card_peak_mib']} MiB used (nvidia-smi, every process); "
        f"ready {out['ready_s']:.2f} s after launch; phase wall time "
        f"{out['wall_s']:.1f} s on {card_txt}")
    return out, build_counts


def check_serve_phase_dump(sv: dict, card: str, tag: str) -> None:
    """``dos-serve``'s dump: this card; B1 launches == the batches its
    engines walked + its ``obs.device`` program keys (one launch a key),
    with a ``table-search[cuda]`` key; no plain walk, no pack4; nothing
    shed, timed out or errored; no fingerprint mismatch."""
    c = sv["counters"]
    shed = [c.get(k, 0) for k in (
        "serve_shed_busy_total", "serve_shed_unavailable_total",
        "serve_timeouts_total", "serve_errors_total",
        "answer_fp_mismatch_total")]
    if (sv["device"]["name"] != card
            or c["cuda_walk_batch.launches"]
            != c["worker_batches_total"] + len(sv["device_programs"])
            or c["cuda_walk_batch.plain"] or c["cuda_walk_batch.launches_pack4"]
            or not any(k.startswith("table-search[cuda]")
                       for k in sv["device_programs"]) or any(shed)):
        raise AssertionError(f"{tag} dump: {c}, programs "
                             f"{sorted(sv['device_programs'])}")


def serve_traffic(client: ServeClient, port: int, g, queries, direct,
                  engines, dc, traffic: str, tag: str) -> dict:
    """The static fleet's traffic (the campaign's queries held to the
    campaign's answers ``direct``, the zipf pool and the families to the
    engines), then ``SERVE_EPOCHS`` live swaps."""
    out: dict = {}
    # the campaign's queries with the zipf pool's first half, then its
    # second half (its repeats of the first half's hot pairs from the
    # cache), then the families
    zipf = scenarios.zipf_queries(g.n, SERVE_ZIPF, seed=0)
    lines = [f"{s} {t}" for s, t in queries]
    zl = [f"{s} {t}" for s, t in zipf]
    half = len(zl) // 2
    t0 = time.perf_counter()
    got = client.ask(lines + zl[:half])
    again = client.ask(zl[half:])
    t_pairs = time.perf_counter() - t0
    n_pairs = len(lines) + len(zl)
    held_to(parse_pair_lines(got[:len(lines)], f"{tag} campaign"), direct,
            "the campaign queries", tag)
    out["pairs_qps"] = n_pairs / t_pairs
    zw = parse_pair_lines(got[len(lines):] + again, f"{tag} zipf")
    held_to(zw, engine_answers(engines, dc, zipf), "the zipf pool", tag)
    cached = sum(ln.endswith(" cached") for ln in again)
    rng = np.random.default_rng(SEED)
    fams = family_lines(queries, rng)
    t0 = time.perf_counter()
    fgot = client.ask([family_request(k, a) for k, a in fams])
    out["families_s"] = time.perf_counter() - t0
    fref = family_reference(g, engines, dc, fams)
    if fgot != fref:
        bad = [(a, b) for a, b in zip(fgot, fref) if a != b][:3]
        raise AssertionError(f"{tag} families differ: {bad}")
    log(f"{tag} {len(lines)} campaign queries + the zipf pool of "
        f"{len(zl)}: {n_pairs} answers in {t_pairs:.3f} s = "
        f"{out['pairs_qps']:.1f} q/s on the host clock, equal to the "
        f"campaign's and to {len(engines)} engines loaded here; the "
        f"pool's second half {cached}/{len(zl) - half} from the cache; "
        f"{SERVE_FAMILIES} each of mat (k = {SERVE_MAT_K}), alt (k = "
        f"{SERVE_ALT_K}), rev in {out['families_s']:.3f} s, every line "
        "equal to its definition from the engines' walks")
    # three live swaps, each written while a batch is in flight
    trace = scenarios.rush_hour_trace(g, epochs=SERVE_EPOCHS)
    swaps = []
    for i, seg in enumerate(trace):
        e = seg["epoch"]
        fly = queries[SERVE_CHECK * i:][:SERVE_CHECK]
        box: dict = {}
        th = threading.Thread(target=lambda: box.update(
            got=client.ask([f"{s} {t}" for s, t in fly])))
        th.start()
        t0 = time.perf_counter()
        write_segment(traffic, e, seg["src"], seg["dst"], seg["w"])
        while statusz(port)["serving"]["diff_epoch"] != e:
            if time.perf_counter() - t0 > 30:
                raise AssertionError(f"{tag} epoch {e} never swapped in")
            time.sleep(0.01)
        seen_s = time.perf_counter() - t0
        th.join(timeout=300)
        parse_pair_lines(box["got"], f"{tag} in flight at epoch {e}")
        fused = os.path.join(traffic, "fused", f"fused-e{e:06d}.diff")
        check = queries[-SERVE_CHECK * (i + 1):][:SERVE_CHECK]
        ans = parse_pair_lines(client.ask([f"{s} {t}" for s, t in check]),
                               f"{tag} epoch {e}")
        held_to(ans, engine_answers(engines, dc, check, fused),
                f"epoch {e} vs the engines on {os.path.basename(fused)}",
                tag)
        st = statusz(port)["serving"]
        swaps.append({"epoch": e, "seen_s": seen_s, "edges": len(seg["w"]),
                      "diff": st["diff"]})
        log(f"{tag} epoch {e} ({len(seg['w'])} corridor edges) written "
            f"while {len(fly)} requests were in flight (all answered OK); "
            f"/statusz showed it after {seen_s:.3f} s; {len(check)} "
            f"answers == {len(engines)} engines on "
            f"{os.path.basename(fused)}")
    out["swaps"] = swaps
    out["scoped_swaps"] = serve_scoped(client, port, g, queries, engines,
                                       dc, traffic, trace, tag)
    return out


def short_pairs(g, n: int, seed: int) -> np.ndarray:
    """``n`` pairs ``(s, t)`` with ``t`` two edges from ``s``: walks of a
    few moves, whose cached entries carry whole path signatures."""
    rng = np.random.default_rng(seed)
    out = []
    for s in rng.permutation(g.n):
        nbrs, _ = g.out_edges(int(s))
        far = [int(t) for v in nbrs[:1] for t in g.out_edges(int(v))[0]
               if int(t) != int(s)]
        if far:
            out.append((int(s), far[0]))
            if len(out) == n:
                break
    return np.asarray(out, np.int64)


def serve_scoped(client: ServeClient, port: int, g, queries, engines, dc,
                 traffic: str, trace: list[dict], tag: str) -> list[dict]:
    """Two live segments under ``DOS_TRAFFIC_SCOPED_MAX``: the trace's
    first ``SERVE_SCOPED_EDGES`` corridor edges at its peak, then back at
    free flow. ``SERVE_SHORT`` short pairs are cached before them; after
    each swap those of their entries that the scan kept (re-keyed) come
    back from the cache, and they with ``SERVE_CHECK`` campaign queries
    equal the engines on the fused ``.diff``."""
    short = short_pairs(g, SERVE_SHORT, SEED + 2)
    check = queries[:SERVE_CHECK]
    both = np.concatenate([short, check])
    lines = [f"{s} {t}" for s, t in both]
    epoch = trace[-1]["epoch"]
    fused = os.path.join(traffic, "fused", f"fused-e{epoch:06d}.diff")
    held_to(parse_pair_lines(client.ask(lines[:len(short)]),
                             f"{tag} short pairs"),
            engine_answers(engines, dc, short, fused),
            f"short pairs at epoch {epoch}", tag)
    k = SERVE_SCOPED_EDGES
    src, dst = trace[0]["src"][:k], trace[0]["dst"][:k]
    peak = max(trace, key=lambda seg: int(seg["w"][:k].sum()))["w"][:k]
    swaps = []
    for w in (peak, trace[0]["w"][:k]):
        epoch += 1
        t0 = time.perf_counter()
        write_segment(traffic, epoch, src, dst, w)
        while statusz(port)["serving"]["diff_epoch"] != epoch:
            if time.perf_counter() - t0 > 30:
                raise AssertionError(f"{tag} epoch {epoch} never swapped "
                                     "in")
            time.sleep(0.01)
        seen_s = time.perf_counter() - t0
        got = client.ask(lines)
        cached = sum(ln.endswith(" cached") for ln in got[:len(short)])
        fused = os.path.join(traffic, "fused", f"fused-e{epoch:06d}.diff")
        held_to(parse_pair_lines(got, f"{tag} epoch {epoch}"),
                engine_answers(engines, dc, both, fused),
                f"epoch {epoch} vs the engines on "
                f"{os.path.basename(fused)}", tag)
        if not cached:
            raise AssertionError(f"{tag} epoch {epoch}: no short pair "
                                 "came back from the cache")
        swaps.append({"epoch": epoch, "seen_s": seen_s, "edges": k,
                      "cached": cached})
        log(f"{tag} epoch {epoch} ({k} corridor edges, under "
            f"DOS_TRAFFIC_SCOPED_MAX): /statusz showed it after "
            f"{seen_s:.3f} s; {cached}/{len(short)} short pairs from the "
            f"cache (re-keyed); they and {len(check)} campaign queries == "
            f"{len(engines)} engines on {os.path.basename(fused)}")
    return swaps


def serve_leave(client: ServeClient, port: int, cconf, dc, g, queries,
                direct, leaver: int, adopter: int, tag: str) -> dict:
    """A membership leave of ``leaver`` while serving, driven from here;
    its catch-up heals shard ``leaver``'s corrupted primary block on the
    card (K1/K2). The answers through the window and after the commit
    are held to the static fleet's, ``direct`` (the last swapped epoch
    is back at free flow)."""
    out: dict = {}
    mc = membership.MembershipController(cconf, dc, graph=g,
                                         device="cuda")
    mig = mc.begin(mc.plan_leave(leaver))
    if mig.moves != [[leaver, leaver, adopter]]:
        raise AssertionError(f"{tag} leave plan {mig.moves}")
    block = os.path.join(cconf.outdir, cpd.shard_block_name(leaver, 0))
    with open(block, "r+b") as f:
        f.seek(1 << 20)
        f.write(b"\x55" * 64)
    owner = dc.worker_of(queries[:, 1])
    ref_all = [np.asarray(a) for a in direct]
    window = np.flatnonzero(owner == leaver)
    got = parse_pair_lines(client.ask(
        [f"{s} {t}" for s, t in queries[window]]), f"{tag} window")
    held_to(got, [a[window] for a in ref_all], "the window", tag)
    t0 = time.perf_counter()
    mc.catch_up(mig)
    out["catchup_s"] = time.perf_counter() - t0
    launches = read_build_launches()
    if not (launches["relax_jacobi"] and launches["first_moves"]):
        raise AssertionError(f"{tag} the catch-up healed without K1/K2: "
                             f"{launches}")
    t0 = time.perf_counter()
    state = mc.commit(mig)
    out["commit_s"] = time.perf_counter() - t0
    if state.epoch != 1 or state.owners[leaver] != adopter:
        raise AssertionError(f"{tag} commit: {state.to_dict()}")
    deadline = time.perf_counter() + 30
    while statusz(port)["serving"]["epoch"] != 1:
        if time.perf_counter() > deadline:
            raise AssertionError(f"{tag} /statusz never showed epoch 1")
        client.ask([f"{queries[0][0]} {queries[0][1]}"])
        time.sleep(0.1)
    # after the commit: shard 3's queries (now routed to the adopter)
    # and a few of the others
    post = np.concatenate([window, np.flatnonzero(owner != leaver)[
        :SERVE_CHECK]])
    got = parse_pair_lines(client.ask(
        [f"{s} {t}" for s, t in queries[post]]), f"{tag} epoch 1")
    held_to(got, [a[post] for a in ref_all], "after the commit", tag)
    st = statusz(port)["serving"]
    if st["shards"][str(leaver)]["replicas"][0] != adopter:
        raise AssertionError(f"{tag} shard {leaver}'s chain "
                             f"{st['shards'][str(leaver)]}")
    log(f"{tag} leave of worker {leaver} while serving: begin (window: "
        f"{len(window)} queries of shard {leaver} answered as the static "
        f"fleet), shard {leaver}'s primary block corrupted, catch_up "
        f"healed it on the card in {out['catchup_s']:.3f} s (K1 "
        f"{launches['relax_jacobi']}, K2 {launches['first_moves']} "
        f"launches), commit in {out['commit_s']:.3f} s (epoch 1, shard "
        f"{leaver} to worker {adopter}); /statusz epoch 1, chain "
        f"{st['shards'][str(leaver)]['replicas']}; after the commit "
        f"{len(post)} campaign queries ({len(window)} of shard {leaver}) "
        "== the static fleet's")
    return out


# ------------------------------------------------- planes and gateway paths

def plane_pairs(g, dc, n: int, seed: int) -> np.ndarray:
    """``n`` pairs with uniform sources and targets in ``PLANE_SHARDS``:
    a ``PLANE_ROT_SHARE`` of them at the rotted row's node (shard
    ``PLANE_ROT``'s first owned node), the rest uniform over the
    shards' owned nodes."""
    rng = np.random.default_rng(seed)
    owned = np.concatenate([dc.owned(x) for x in PLANE_SHARDS])
    t = owned[rng.integers(0, len(owned), n)]
    t[rng.random(n) < PLANE_ROT_SHARE] = dc.owned(PLANE_ROT)[0]
    s = rng.integers(0, g.n, n)
    return np.stack([s, t], axis=1).astype(np.int64)


def plane_engines(ref: dict, host: dict) -> tuple[dict, object, str]:
    """``[planes]``' and ``[gateway]``'s reference: this process's
    engines of ``PLANE_SHARDS`` on ``[serve]``'s index (clean: no fault
    is armed here), the replicated controller and the ``-r2`` conf."""
    g, w = ref["g"], HOST_WORKERS
    conf = host["conf"][:-len(".json")] + "-r2.json"
    dc = DistributionController("mod", w, w, g.n, replication=2)
    outdir = ClusterConfig.load(conf).outdir
    return ({x: eng.ShardEngine(g, dc, x, outdir, device="cuda")
             for x in PLANE_SHARDS}, dc, conf)


def wait_obs_port(proc, log_path: str, paths: tuple, tag: str,
                  deadline_s: float) -> int:
    """The ``--obs-port 0`` port a ``-v`` process logged, once every one
    of ``paths`` exists; fails when the process exits first."""
    deadline = time.perf_counter() + deadline_s
    port = None
    while port is None or not all(os.path.exists(p) for p in paths):
        if proc.poll() is not None or time.perf_counter() > deadline:
            raise AssertionError(f"{tag} process exited {proc.returncode} "
                                 "or was not up in time")
        with open(log_path, errors="replace") as f:
            hit = re.search(r"obs endpoints up on :(\d+)", f.read())
        port = int(hit.group(1)) if hit else None
        time.sleep(0.1)
    return port


def metric_value(port: int, name: str) -> float:
    """``name``'s value on ``/metrics`` (0 when it is not there yet)."""
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=30) as r:
        hit = re.search(rf"^{name} (\S+)$", r.read().decode(), re.M)
    return float(hit.group(1)) if hit else 0.0


def planes_path(ref: dict, host: dict, engines: dict, dc, conf: str,
                serve_qps: float) -> dict:
    """``[planes]``: ``dos-serve --backend inproc`` over ``[serve]``'s
    index with every plane on (``PLANE_ENV``: the scrubber each second,
    the audit on every batch, telemetry, one latency objective, the
    control daemon, the flight recorder) and ``corrupt-resident`` armed
    on shard ``PLANE_ROT``: row 0 of the first engine that loads it,
    the primary, flips after its digests verified. The audit's replica
    lane finds the divergence, the daemon quarantines the shard,
    scrubs it and re-admits it after clean probes, the scrubber
    re-binds the table from disk on the card; the pairs after equal
    this process's engines."""
    tag = "[planes]"
    t_phase = time.perf_counter()
    card_txt = card_line()
    card = torch.cuda.get_device_name(0)
    g = ref["g"]
    run_dir = os.path.dirname(conf)
    sock = socket_dir(os.path.join(run_dir, "planes.sock"))
    dump = os.path.join(run_dir, "planes-dump.json")
    tape = os.path.join(run_dir, "planes-tape")
    specs = os.path.join(run_dir, "planes-slo.json")
    log_path = os.path.join(run_dir, "planes.log")
    with open(specs, "w") as f:
        json.dump([PLANE_SLO], f)
    cmd = [sys.executable, "-m", "distributed_oracle_search_tpu_torch.cli."
           "serve", "-c", conf, "-v", "--backend", "inproc", "--ingress",
           "socket", "--socket", sock, "--obs-port", "0", "--metrics-dump",
           dump, "--recorder-dir", tape, *PLANE_KNOBS]
    env = dict(os.environ, **PLANE_ENV, DOS_SLO_SPECS=specs,
               DOS_FAULTS=f"corrupt-resident;wid={PLANE_ROT};times=1")
    q1 = plane_pairs(g, dc, PLANE_PAIRS[0], seed=1)
    q2 = plane_pairs(g, dc, PLANE_PAIRS[1], seed=2)
    truth1, truth2 = (engine_answers(engines, dc, q) for q in (q1, q2))
    out: dict = {"card": card_txt}
    with open(log_path, "w") as lf, MemorySampler() as mem:
        t_launch = time.perf_counter()
        proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=lf,
                                stderr=subprocess.STDOUT)
        try:
            port = wait_obs_port(proc, log_path, (sock,), tag,
                                 SERVE_READY_S)
            out["ready_s"] = time.perf_counter() - t_launch
            client = ServeClient(sock)
            t0 = time.perf_counter()
            got1 = parse_pair_lines(client.ask([f"{s} {t}" for s, t in q1]),
                                    f"{tag} first pairs")
            out["first_s"] = time.perf_counter() - t0
            want1 = np.stack([np.asarray(a).astype(np.int64)
                              for a in truth1], axis=1)
            wrong = (got1 != want1).any(axis=1)
            out["wrong_before"] = int(wrong.sum())
            rot_node = int(dc.owned(PLANE_ROT)[0])
            out["wrong_off_row"] = int((wrong & (q1[:, 1] != rot_node)).sum())
            # detection -> quarantine -> scrub -> re-admission
            t0 = time.perf_counter()
            while True:
                st = statusz(port)
                integ = st.get("integrity", {})
                div = integ.get("audit", {}).get("divergent", {})
                scrub = integ.get("scrub", {})
                quar = metric_value(port,
                                    "control_divergence_quarantines_total")
                readmit = metric_value(port, "control_readmissions_total")
                if (div.get(str(PLANE_ROT), 0) >= 1
                        and scrub.get("corrupt_blocks", 0) >= 1
                        and quar >= 1 and readmit >= 1
                        and not st["control"]["quarantined"]
                        and not integ["audit"]["queued"]):
                    break
                if time.perf_counter() - t0 > PLANE_HEAL_S:
                    raise AssertionError(
                        f"{tag} no detection, quarantine, scrub and "
                        f"re-admission within {PLANE_HEAL_S} s: "
                        f"divergent {div}, scrub {scrub}, quarantines "
                        f"{quar}, readmissions {readmit}, control "
                        f"{st['control']}")
                time.sleep(0.1)
            out["heal_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            got2 = parse_pair_lines(client.ask([f"{s} {t}" for s, t in q2]),
                                    f"{tag} after the heal")
            out["second_s"] = time.perf_counter() - t0
            held_to(got2, truth2, "the pairs after the re-admission", tag)
            st = statusz(port)
            missing = [k for k in ("telemetry", "slo", "control",
                                   "integrity") if k not in st]
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/slo",
                                        timeout=30) as r:
                slo_code, slo = r.status, json.load(r)
            if (missing or slo_code != 200
                    or "head" not in st["telemetry"]["sources"]):
                raise AssertionError(f"{tag} /statusz missing {missing} or "
                                     f"/slo {slo_code} {slo}, telemetry "
                                     f"{st.get('telemetry')}")
            client.close()
            t_stop = time.perf_counter()
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=120)
            out["drain_s"] = time.perf_counter() - t_stop
        except BaseException:
            with open(log_path, errors="replace") as f:
                log(f"{tag} --- planes.log (last 3000 characters) ---\n"
                    f"{f.read()[-3000:]}")
            raise
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
    if rc != 0:
        raise AssertionError(f"{tag} dos-serve exited {rc} on SIGTERM")
    with open(dump) as f:
        sv = json.load(f)
    c, h = sv["counters"], sv["histograms"]
    kinds = [r["kind"] for r in obs_recorder.replay(tape)
             if r.get("rec") == "event"]
    for kind in ("audit_divergence", "scrub_corrupt",
                 "control_divergence_quarantine", "control_readmit"):
        if kind not in kinds:
            raise AssertionError(f"{tag} the tape lacks {kind}: "
                                 f"{sorted(set(kinds))}")
    batches = c["serve_batches_total"]
    audited = c.get("audit_batches_total", 0)
    nonref = c["worker_batches_total"] - batches
    programs = len(sv["device_programs"])
    if (sv["device"]["name"] != card
            or c["cuda_walk_batch.launches"] != batches + programs + nonref
            or c["cuda_walk_batch.plain"]
            or not 0 <= nonref <= audited
            or c.get("scrub_blocks_corrupt_total", 0) < 1
            or c.get("audit_divergence_total", 0) < 1
            or c.get("answer_fp_mismatch_total", 0)
            or c.get("hedges_issued_total", 0)):
        raise AssertionError(f"{tag} dump: {c}, programs "
                             f"{sorted(sv['device_programs'])}")
    scrub_h = h.get("scrub_pass_seconds", {})
    lane_h = h.get("audit_lane_seconds", {})
    shard_bytes = dc.n_owned(PLANE_ROT) * g.n
    checked = c.get("scrub_blocks_checked_total", 0)
    out.update(
        launches=c["cuda_walk_batch.launches"], batches=batches,
        programs=programs, audited=audited, audit_nonref=nonref,
        audit_reference=audited - nonref,
        divergences=c["audit_divergence_total"],
        quarantines=c.get("control_divergence_quarantines_total", 0),
        readmissions=c.get("control_readmissions_total", 0),
        scrub_passes=c.get("scrub_passes_total", 0),
        scrub_checked=checked,
        scrub_corrupt=c["scrub_blocks_corrupt_total"],
        scrub_s=scrub_h.get("sum", 0.0),
        audit_lane_s=lane_h.get("sum", 0.0),
        telemetry_ticks=c.get("telemetry_ticks_published_total", 0),
        qps_first=len(q1) / out["first_s"],
        qps_second=len(q2) / out["second_s"],
        serve_peak_bytes=sv["device"]["max_memory_allocated"],
        card_peak_mib=mem.peak_mib,
        wall_s=time.perf_counter() - t_phase)
    out["scrub_gib_s"] = (checked * shard_bytes / 2**30
                          / max(out["scrub_s"], 1e-9))
    log(f"{tag} dos-serve with every plane on, corrupt-resident on shard "
        f"{PLANE_ROT}: {len(q1)} pairs ({out['wrong_before']} answered "
        f"wrong before the quarantine, {out['wrong_off_row']} of them off "
        f"the rotted row {rot_node}; not held to 0), the audit's replica "
        f"lane flagged shard {PLANE_ROT} ({out['divergences']} "
        f"divergences), the daemon quarantined it "
        f"({out['quarantines']}) and re-admitted it "
        f"({out['readmissions']}) after clean probes, the scrubber found "
        f"{out['scrub_corrupt']} corrupt block(s) and re-bound the table "
        f"from disk on the card, {out['heal_s']:.2f} s from the first "
        f"answers to the re-admission; {len(q2)} pairs after == {len(engines)} "
        f"engines loaded here; /statusz telemetry, slo, control and "
        f"integrity sections, /slo 200; the tape holds audit_divergence, "
        f"scrub_corrupt, control_divergence_quarantine, control_readmit")
    log(f"{tag} SIGTERM: exit 0 in {out['drain_s']:.2f} s; dump on {card}: "
        f"B1 launches {out['launches']} == {batches} serve batches + "
        f"{programs} obs.device program keys + {nonref} audit batches "
        f"walked by B1 (of {audited} audited; {out['audit_reference']} on "
        f"the reference lane), 0 plain walks, no hedge, "
        f"answer_fp_mismatch_total 0")
    log(f"{tag} host clock (logged, not claimed): q/s with the planes on "
        f"{out['qps_first']:.1f} (first {len(q1)}, engines loading), "
        f"{out['qps_second']:.1f} (after the heal) vs [serve] "
        f"{serve_qps:.1f}; scrub {out['scrub_passes']} passes, "
        f"{checked} blocks of {shard_bytes / 2**20:.0f} MiB in "
        f"{out['scrub_s']:.2f} s = {out['scrub_gib_s']:.2f} GiB/s; audit "
        f"lanes {out['audit_lane_s']:.2f} s for {audited} batches (by "
        f"lane: {nonref} replica/recompute, {out['audit_reference']} "
        f"reference); {out['telemetry_ticks']} telemetry ticks; peak "
        f"device memory: dos-serve "
        f"{out['serve_peak_bytes'] / 2**30:.2f} GiB allocated (old and "
        f"re-bound tables together), the card {out['card_peak_mib']} MiB "
        f"used (nvidia-smi); ready {out['ready_s']:.2f} s after launch; "
        f"phase wall time {out['wall_s']:.1f} s on {card_txt}")
    return out


def gateway_frames(g, dc, n: int, seed: int) -> list[np.ndarray]:
    """``n`` pairs aimed at ``PLANE_SHARDS`` in frames of
    ``GATEWAY_FRAME``."""
    q = plane_pairs(g, dc, n, seed)
    return [q[i:i + GATEWAY_FRAME] for i in range(0, n, GATEWAY_FRAME)]


def frame_truth(engines: dict, dc, frames) -> list[list[tuple]]:
    """The ``(status, cost, plen, finished)`` rows a frame must get."""
    q = np.concatenate(frames)
    cost, plen, fin = engine_answers(engines, dc, q)
    rows = [("OK", int(c), int(p), bool(f))
            for c, p, f in zip(cost, plen, fin)]
    out, i = [], 0
    for fr in frames:
        out.append(rows[i:i + len(fr)])
        i += len(fr)
    return out


def collect(client, fids: list, tag: str, what: str,
            wait_s: float = GATEWAY_WAIT_S) -> list[list[tuple]]:
    """Every frame's rows, re-waiting through the client's own
    failovers (a wait past ``wait_s`` fails a client with somewhere else
    to go over and resubmits; the re-wait collects the answer)."""
    out = []
    for fid in fids:
        give_up = time.perf_counter() + GATEWAY_GIVE_UP_S
        while True:
            try:
                rows = gw_pair_rows(client.wait(fid, timeout=wait_s))
                break
            except TimeoutError:
                if time.perf_counter() > give_up:
                    raise AssertionError(f"{tag} {what}: frame {fid} "
                                         "never answered")
        out.append([tuple(r[:4]) for r in rows])
    return out


def gateway_path(ref: dict, host: dict, engines: dict, dc,
                 conf: str) -> dict:
    """``[gateway]``: ``dos-gateway`` (``cli.gateway``) over ``[serve]``'s
    index, process A with ``--replicas 2`` (``lease-freeze`` and
    ``blackhole-conn`` armed on its frontend 1) and process B started
    with ``--join --replicas 1``, driven by the port's ``DosClient``
    through ``gateway.json``. Every answer equals this process's
    engines."""
    tag = "[gateway]"
    t_phase = time.perf_counter()
    card_txt = card_line()
    card = torch.cuda.get_device_name(0)
    g = ref["g"]
    run_dir = os.path.dirname(conf)
    reg_dir = os.path.join(run_dir, "gw-registry")
    socks = os.path.join(run_dir, "gw-socks")
    os.makedirs(reg_dir)
    os.makedirs(socks)
    dump_a = os.path.join(run_dir, "gateway-a.json")
    common = ["-c", conf, "-v", "--device", "cuda", "--registry-dir",
              reg_dir, "--socket-dir", socket_dir(socks), "--credit",
              str(GATEWAY_CREDIT), "--lease-s", str(GATEWAY_LEASE_S),
              "--obs-port", "0", *GATEWAY_KNOBS]
    base = [sys.executable, "-m",
            "distributed_oracle_search_tpu_torch.cli.gateway"]
    # no hedges: a hedge's losing walk may still run when a process
    # dumps, and each dump holds B1 to the batches walked
    env_a = dict(os.environ, DOS_FAULTS=GATEWAY_FAULTS,
                 DOS_HEDGE_DISABLE="1")
    env_b = {k: v for k, v in env_a.items() if k != "DOS_FAULTS"}
    logs = {p: os.path.join(run_dir, f"gateway-{p}.log") for p in "ab"}
    procs: dict = {}
    clients: list = []
    out: dict = {"card": card_txt}
    frames = gateway_frames(g, dc, GATEWAY_PAIRS, seed=3)
    truth = frame_truth(engines, dc, frames)
    warm = [np.asarray([(0, int(dc.owned(x)[1])) for x in PLANE_SHARDS],
                       np.int64)]
    warm_truth = frame_truth(engines, dc, warm)
    t_launch = time.perf_counter()
    with MemorySampler() as mem:
        try:
            with open(logs["a"], "w") as lf:
                procs["a"] = subprocess.Popen(
                    base + common + ["--replicas", "2", "--metrics-dump",
                                     dump_a],
                    cwd=ROOT, env=env_a, stdout=lf, stderr=subprocess.STDOUT)
            port_a = wait_obs_port(procs["a"], logs["a"],
                                   (gw_registry.registry_path(reg_dir),),
                                   tag, SERVE_READY_S)
            eps = registry_endpoints(reg_dir, 2, tag)
            out["a_ready_s"] = time.perf_counter() - t_launch
            # B joins: fresh frontend ids above A's
            with open(logs["b"], "w") as lf:
                procs["b"] = subprocess.Popen(
                    base + common + ["--join", "--replicas", "1"],
                    cwd=ROOT, env=env_b, stdout=lf, stderr=subprocess.STDOUT)
            # warm f0 (its engines load on its first frame) from a client
            # with nowhere else to go, then the first connection to f1:
            # blackhole-conn takes it (the client's hello is f1's first
            # frame), the client gives up after its wait and resubmits
            # on f0
            t0 = time.perf_counter()
            warm0 = gw.DosClient(eps[0])
            clients.append(warm0)
            if collect(warm0, [warm0.submit_pairs(warm[0])], tag,
                       "warm f0") != warm_truth:
                raise AssertionError(f"{tag} f0's warm frame")
            out["load_f0_s"] = time.perf_counter() - t0
            hole = gw.DosClient(endpoints=[eps[1], eps[0]])
            clients.append(hole)
            t0 = time.perf_counter()
            got = collect(hole, [hole.submit_pairs(fr) for fr in frames[:2]],
                          tag, "blackholed client", GATEWAY_HOLE_WAIT_S)
            out["blackhole_s"] = time.perf_counter() - t0
            with open(logs["a"], errors="replace") as f:
                fired = re.findall(r"fault injected: ([\w-]+)", f.read())
            if (got != truth[:2] or hole.failovers != 1
                    or hole.endpoint != eps[0]
                    or "blackhole-conn" not in fired):
                raise AssertionError(f"{tag} blackholed client: failovers "
                                     f"{hole.failovers}, at "
                                     f"{hole.endpoint}, answers equal "
                                     f"{got == truth[:2]}, A's faults "
                                     f"{fired}")
            # lease-freeze: f1's lease stops renewing and expires, while
            # f1 still serves; discovery stops choosing it
            t0 = time.perf_counter()
            reg = gw_registry.GatewayRegistry(reg_dir)
            while any(lease.fid == 1 for lease in reg.live()):
                if time.perf_counter() - t0 > 3 * GATEWAY_LEASE_S:
                    raise AssertionError(f"{tag} f1's lease never expired")
                time.sleep(0.05)
            f1 = next(lease for lease in reg.leases() if lease.fid == 1)
            out["lease_stale_s"] = time.time() - f1.renewed
            out["lease_frozen_s"] = f1.renewed - f1.started
            with open(logs["a"], errors="replace") as f:
                if "fault injected: lease-freeze" not in f.read():
                    raise AssertionError(f"{tag} lease-freeze never fired")
            c1 = gw.DosClient(eps[1])
            clients.append(c1)
            t0 = time.perf_counter()
            if collect(c1, [c1.submit_pairs(warm[0])], tag, "warm f1") \
                    != warm_truth:
                raise AssertionError(f"{tag} f1's warm frame")
            out["load_f1_s"] = time.perf_counter() - t0
            found = gw.DosClient(registry_dir=reg_dir)
            clients.append(found)
            if found.endpoint == eps[1] or eps[1] in \
                    gw_registry.live_endpoints(reg_dir):
                raise AssertionError(f"{tag} discovery still chose the "
                                     f"frozen f1: {found.endpoint}")
            found.close()
            # B up: its lease in gateway.json, its engines warm
            eps = registry_endpoints(reg_dir, 3, tag)
            out["b_ready_s"] = time.perf_counter() - t_launch
            c0 = gw.DosClient(eps[0])
            clients.append(c0)
            c2 = gw.DosClient(endpoints=[eps[2], eps[0]])
            clients.append(c2)
            t0 = time.perf_counter()
            if collect(c2, [c2.submit_pairs(warm[0])], tag, "warm f2") \
                    != warm_truth:
                raise AssertionError(f"{tag} f2's warm frame")
            out["load_f2_s"] = time.perf_counter() - t0
            # 1. the pairs across the three replicas, one thread each
            mine = {0: (c0, frames[2::3]), 1: (c1, frames[3::3]),
                    2: (c2, frames[4::3])}
            box: dict = {}

            def drive(f):
                cl, frs = mine[f]
                t = time.perf_counter()
                box[f] = (collect(cl, [cl.submit_pairs(fr) for fr in frs],
                                  tag, f"f{f}'s pairs"),
                          time.perf_counter() - t)
            ths = [threading.Thread(target=drive, args=(f,)) for f in mine]
            t0 = time.perf_counter()
            for th in ths:
                th.start()
            for th in ths:
                th.join(timeout=300)
            out["pairs_s"] = time.perf_counter() - t0
            for f, (_cl, frs) in mine.items():
                want = truth[2 + f::3]
                if box[f][0] != want:
                    raise AssertionError(f"{tag} f{f}'s answers differ")
            out["qps_by_replica"] = {
                f"f{f}": sum(len(x) for x in mine[f][1]) / box[f][1]
                for f in mine}
            # the families, and repeats from the cache
            fq = plane_pairs(g, dc, SERVE_MAT_K + 2, seed=4)
            # mat and alt walk to targets in the shards; rev walks back
            # to its source, so its source is one of their nodes
            picks = [(int(fq[0, 0]), [int(t) for t in fq[:SERVE_MAT_K, 1]]),
                     (int(fq[-2, 0]), int(fq[-2, 1])),
                     (int(fq[-1, 1]), int(fq[-1, 0]))]
            fref = family_reference(g, engines, dc, [
                ("mat", picks[0]), ("alt", picks[1]), ("rev", picks[2])])
            s, ts = picks[0]
            mat = c0.matrix(s, ts, timeout=GATEWAY_GIVE_UP_S)
            alt = c0.alternatives(*picks[1], SERVE_ALT_K,
                                  timeout=GATEWAY_GIVE_UP_S)
            rev = c0.reverse(*picks[2], timeout=GATEWAY_GIVE_UP_S)
            got_lines = [
                " ".join(["MAT", str(s), str(len(ts))]
                         + [str(x) for x in mat]),
                " ".join(["ALT", *map(str, picks[1]), str(len(alt))]
                         + [str(c) for c, _v in alt]),
                f"REV {picks[2][0]} {picks[2][1]} {rev[1]} {rev[2]} "
                f"{int(rev[3])}"]
            if got_lines != fref:
                raise AssertionError(f"{tag} families: {got_lines} != {fref}")
            again = gw_pair_rows(c0.wait(c0.submit_pairs(frames[2]),
                                         timeout=GATEWAY_GIVE_UP_S))
            if not all(r[4] for r in again) \
                    or [tuple(r[:4]) for r in again] != truth[2]:
                raise AssertionError(f"{tag} a repeated frame did not come "
                                     "back cached")
            # 2. past the credit window from two raw connections, on
            # pairs no replica has cached (a cached frame answers at once)
            busy = credit_burst(eps[0], plane_pairs(
                g, dc, 2 * 3 * GATEWAY_CREDIT * GATEWAY_BURST_FRAME, seed=6),
                tag)
            # 3. B dies mid-burst, on pairs no replica has cached: its
            # client fails over to f0
            killed = gateway_frames(
                g, dc, 2 * GATEWAY_CREDIT * GATEWAY_FRAME, seed=7)
            fids = [c2.submit_pairs(fr) for fr in killed[:GATEWAY_CREDIT]]
            used = int(nvidia_smi("memory.used")[0][0])
            procs["b"].send_signal(signal.SIGKILL)
            procs["b"].wait(timeout=30)
            time.sleep(0.5)
            out["b_freed_mib"] = used - int(nvidia_smi("memory.used")[0][0])
            fids += [c2.submit_pairs(fr, timeout=GATEWAY_GIVE_UP_S)
                     for fr in killed[GATEWAY_CREDIT:]]
            got = collect(c2, fids, tag, "across B's death")
            want = frame_truth(engines, dc, killed)
            if (got != want or c2.failovers < 1
                    or c2.unmatched or hole.unmatched or c0.unmatched):
                raise AssertionError(f"{tag} B's client: failovers "
                                     f"{c2.failovers}, unmatched "
                                     f"{c2.unmatched}, answers equal "
                                     f"{got == want}")
            st = statusz(port_a)["gateway"]
            for cl in clients:
                cl.close()
            clients.clear()
            # 5. SIGTERM A: exit 0, its leases gone from gateway.json
            t0 = time.perf_counter()
            procs["a"].send_signal(signal.SIGTERM)
            rc = procs["a"].wait(timeout=120)
            out["drain_s"] = time.perf_counter() - t0
        except BaseException:
            for p, path in logs.items():
                if os.path.exists(path):
                    with open(path, errors="replace") as f:
                        log(f"{tag} --- gateway-{p}.log (last 3000 "
                            f"characters) ---\n{f.read()[-3000:]}")
            raise
        finally:
            for cl in clients:
                cl.close()
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=30)
    if rc != 0:
        raise AssertionError(f"{tag} process A exited {rc} on SIGTERM")
    left = [lease.fid for lease in
            gw_registry.GatewayRegistry(reg_dir).leases()]
    if 0 in left or 1 in left:
        raise AssertionError(f"{tag} gateway.json still leases {left}")
    with open(dump_a) as f:
        sv = json.load(f)
    c = sv["counters"]
    programs = len(sv["device_programs"])
    if (sv["device"]["name"] != card
            or c["cuda_walk_batch.launches"]
            != c["worker_batches_total"] + programs
            or c["cuda_walk_batch.plain"]
            or c.get("gateway_busy_total", 0) < 1
            or c.get("gateway_failover_frames_total", 0) < 1):
        raise AssertionError(f"{tag} A's dump: {c}, programs "
                             f"{sorted(sv['device_programs'])}")
    out.update(
        launches=c["cuda_walk_batch.launches"],
        batches=c["worker_batches_total"], programs=programs,
        busy=c["gateway_busy_total"], busy_frames=busy,
        failover_frames=c["gateway_failover_frames_total"],
        deduped=c.get("gateway_resubmits_deduped_total", 0),
        client_failovers=c.get("gateway_client_failovers_total", 0),
        a_peak_bytes=sv["device"]["max_memory_allocated"],
        card_peak_mib=mem.peak_mib, replicas=st.get("replicas"),
        wall_s=time.perf_counter() - t_phase)
    log(f"{tag} A (--replicas 2) and B (--join --replicas 1) served "
        f"{GATEWAY_PAIRS} pairs in frames of {GATEWAY_FRAME} across f0, "
        f"f1, f2 == {len(engines)} engines loaded here; one mat, alt and "
        f"rev frame each == their definitions; a repeated frame came back "
        f"cached; {busy} of the burst's frames answered busy "
        f"(gateway_busy_total {out['busy']}), no other error; "
        f"blackhole-conn took f1's first connection and its client "
        f"resubmitted on f0 after {out['blackhole_s']:.2f} s "
        f"(gateway_failover_frames_total {out['failover_frames']}); "
        f"lease-freeze: f1's lease stopped renewing "
        f"{out['lease_frozen_s']:.2f} s after it registered and read "
        f"expired (--lease-s {GATEWAY_LEASE_S}; {out['lease_stale_s']:.2f} "
        f"s since its last renewal at the read) while f1 still served, "
        f"discovery chose f0; B SIGKILLed with "
        f"{GATEWAY_CREDIT} frames in flight: its client failed over to f0, "
        f"every pair answered once (0 unmatched; "
        f"gateway_resubmits_deduped_total {out['deduped']})")
    log(f"{tag} SIGTERM: A exit 0 in {out['drain_s']:.2f} s, f0 and f1 "
        f"gone from gateway.json (left {left}); A's dump on {card}: B1 "
        f"launches {out['launches']} == {out['batches']} batches + "
        f"{programs} obs.device program keys, 0 plain walks")
    log(f"{tag} host clock (logged, not claimed): q/s by replica "
        + ", ".join(f"{k} {v:.1f}" for k, v in out["qps_by_replica"].items())
        + f"; engine loads (one frame a shard): f0 {out['load_f0_s']:.2f} "
        f"s, f1 {out['load_f1_s']:.2f} s, f2 {out['load_f2_s']:.2f} s; "
        f"peak device memory: A {out['a_peak_bytes'] / 2**30:.2f} GiB "
        f"allocated (its dump), B's ~{out['b_freed_mib']} MiB (the card's "
        f"used memory it freed when killed), the card "
        f"{out['card_peak_mib']} MiB (nvidia-smi, every process); A "
        f"ready {out['a_ready_s']:.2f} s, B {out['b_ready_s']:.2f} s after "
        f"A's launch; phase wall time {out['wall_s']:.1f} s on {card_txt}")
    return out


def registry_endpoints(reg_dir: str, n: int, tag: str) -> list[str]:
    """The endpoints of frontends 0..n-1 once ``gateway.json`` holds a
    lease of every one (live or not) and their sockets exist."""
    deadline = time.perf_counter() + SERVE_READY_S
    while True:
        try:
            reg = gw_registry.GatewayRegistry(reg_dir)
            leases = {lease.fid: lease.endpoint for lease in reg.leases()}
        except (OSError, ValueError):
            leases = {}
        if all(f in leases and os.path.exists(leases[f])
               for f in range(n)):
            return [leases[f] for f in range(n)]
        if time.perf_counter() > deadline:
            raise AssertionError(f"{tag} gateway.json never leased "
                                 f"{n} frontends: {leases}")
        time.sleep(0.1)


def credit_burst(endpoint: str, pairs: np.ndarray, tag: str) -> int:
    """Two raw connections each send ``3 * GATEWAY_CREDIT`` query frames
    of ``GATEWAY_BURST_FRAME`` of ``pairs`` without reading; every reply
    is an answer or ``busy`` (nothing else). Returns the busy count."""
    socks = []
    kinds: list[str] = []
    try:
        for _ in range(2):
            sk = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            sk.settimeout(GATEWAY_GIVE_UP_S)
            sk.connect(endpoint)
            reader, writer = frames_mod.FrameReader(sk), \
                frames_mod.FrameWriter(sk)
            if reader.read().kind != "hello":
                raise AssertionError(f"{tag} burst: no hello")
            socks.append((sk, reader, writer))
        chunks = iter(np.split(pairs, 2 * 3 * GATEWAY_CREDIT))
        for i in range(3 * GATEWAY_CREDIT):
            for _sk, _r, writer in socks:
                h, a = gw_protocol.encode_pairs(i, next(chunks))
                writer.send(h, a)
        for _sk, reader, _w in socks:
            for _ in range(3 * GATEWAY_CREDIT):
                kinds.append(reader.read().kind)
    finally:
        for sk, _r, _w in socks:
            sk.close()
    if set(kinds) - {"r", "busy"} or "busy" not in kinds:
        raise AssertionError(f"{tag} burst replies {sorted(set(kinds))}")
    return kinds.count("busy")


def rot_resident_row(fm) -> str:
    """Flip resident row 0 of a pack4 table on the card to valid but
    wrong moves, as ``corrupt-resident`` flips a raw row (0 and the
    target marker to 1, the rest to 0)."""
    p = fm.arrays["packed"][0].to(torch.int32)
    lo, hi = p & 0xF, p >> 4
    lo = torch.where((lo == 0) | (lo == 15), 1, 0)
    hi = torch.where((hi == 0) | (hi == 15), 1, 0)
    fm.arrays["packed"][0] = (lo | (hi << 4)).to(fm.arrays["packed"].dtype)
    return "row 0's nibbles"


def compressed_scrub(engines: dict, outdir: str, queries: np.ndarray,
                     want, tag: str) -> dict:
    """The resident scrubber on ``[compressed]``'s pack4 and rle engines:
    one clean pass each; then, on the pack4 engine, a resident row
    rotted on the card, which the next pass finds and re-binds from
    disk, and the engine's next walk equals the raw engine's (``want``,
    its free-flow answers). The rle engine's re-bind (the host re-encode
    of its load, ~20 s) is not repeated here: the re-bind path is the
    same for both codecs."""
    out = {}
    prior = os.environ.get("DOS_CPD_RESIDENT")
    try:
        for codec in ("pack4", "rle"):
            e = engines[codec]
            t0 = time.perf_counter()
            rep, _ = scrub_mod.scrub_engine_table(e, outdir, e.fm, None)
            clean_s = time.perf_counter() - t0
            if rep["corrupt"] or rep["errors"] or not rep["checked"]:
                raise AssertionError(f"{tag} scrub of {codec}: {rep}")
            if codec == "rle":
                out[codec] = {"clean_s": clean_s, "blocks": rep["checked"]}
                log(f"{tag} scrub {codec}: a clean pass of "
                    f"{rep['checked']} block(s) in {clean_s:.2f} s")
                continue
            what = rot_resident_row(e.fm)
            # the re-bind re-makes the table under the resident policy
            os.environ["DOS_CPD_RESIDENT"] = codec
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            rep, _ = scrub_mod.scrub_engine_table(e, outdir, e.fm, None)
            torch.cuda.synchronize()
            rot_s = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() - base
            if (not rep["corrupt"] or not rep["rebound"]
                    or e.resident_codec != codec):
                raise AssertionError(f"{tag} rotted {codec}: {rep}, "
                                     f"resident {e.resident_codec}")
            cost, plen, fin, _ = e.answer(queries, RuntimeConfig(), "-")
            for x, y, label in zip(want[:3], (cost, plen, fin),
                                   ("cost", "plen", "fin")):
                if not np.array_equal(np.asarray(x), np.asarray(y)):
                    raise AssertionError(f"{tag} {codec} after the "
                                         f"re-bind: {label} differs from "
                                         "the raw engine")
            out[codec] = {"clean_s": clean_s, "rot_s": rot_s,
                          "rebind_peak_bytes": peak,
                          "blocks": rep["checked"]}
            log(f"{tag} scrub {codec}: a clean pass of {rep['checked']} "
                f"block(s) in {clean_s:.2f} s; {what} flipped on the "
                f"card, the next pass found {rep['corrupt']} and re-bound "
                f"from disk in {rot_s:.2f} s (device memory above the "
                f"engines during it: {peak / 2**30:.2f} GiB); the next "
                f"walk == the raw engine's ({len(queries)} queries)")
    finally:
        if prior is None:
            os.environ.pop("DOS_CPD_RESIDENT", None)
        else:
            os.environ["DOS_CPD_RESIDENT"] = prior
    return out


# -------------------------------------------------------------- reorder path

def reorder_path(outdir: str, ref: dict) -> tuple[dict, dict[str, int]]:
    """The port's reorder tool on the campaign's files (RCM), then the
    build ``auto`` picks on the reordered graph (``frontier``: the plain
    torch queue on the card, then the extraction kernel) held byte-equal
    to ``ellsplit`` on worker 0's first 512 targets; the queue's pops
    and ms a pop are recorded. Returns the measurements and the build
    kernels' launches of the ``auto`` build."""
    tag = "[reorder]"
    rxy = os.path.join(outdir, "road-rcm.xy")
    rscen = os.path.join(outdir, "road-rcm.scen")
    rdiff = os.path.join(outdir, "congestion-rcm.diff")
    t0 = time.perf_counter()
    rc = reorder_cli.main(["--input", ref["xy"], "--order", "rcm", "-o", rxy,
                           "--scen", ref["scen"], rscen,
                           "--diff", ref["diff_path"], rdiff])
    tool_s = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"{tag} reorder exit code {rc}")
    g0, g = ref["g"], Graph.from_xy(rxy)
    perm = np.loadtxt(rxy + ".order", dtype=np.int64)
    inv = np.empty(g.n, np.int64)
    inv[perm] = np.arange(g.n)
    if not np.array_equal(read_scen(rscen), inv[ref["queries"]]):
        raise AssertionError(f"{tag} the reordered scenario is not the "
                             "relabelled one")
    loc0, loc = locality_fraction(g0), locality_fraction(g)
    kind, st = cpd.pick_build_kernel(g, "auto")
    log(f"{tag} cli.reorder --order rcm: {tool_s:.3f} s; edge locality "
        f"{loc0:.3f} -> {loc:.3f}; auto resolves {kind!r} (raw ids: "
        f"{cpd.pick_build_kernel(g0, 'auto')[0]!r})")
    if kind != "frontier":
        raise AssertionError(f"{tag} auto resolved {kind!r}, not frontier")
    dc = DistributionController("tpu", CAMPAIGN_WORKERS, CAMPAIGN_WORKERS,
                                g.n)
    dg = DeviceGraph.from_graph(g, device="cuda")
    t = torch.as_tensor(dc.owned(0)[:CHUNK].astype(np.int32),
                        device=dg.device)
    queue = {}
    real = frontier_relax.dist_to_targets_frontier

    def timed_queue(*a, **kw):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = real(*a, stats=queue, **kw)
        torch.cuda.synchronize()
        queue["s"] = time.perf_counter() - t1
        queue["dist"] = out
        return out

    build = sharded.chunk_compute(dg, (kind, st))
    zero_launches()
    frontier_relax.dist_to_targets_frontier = timed_queue
    try:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fm_auto = build(t)
        torch.cuda.synchronize()
        auto_s = time.perf_counter() - t1
    finally:
        frontier_relax.dist_to_targets_frontier = real
    counts = read_build_launches()
    if counts["first_moves"] <= 0:
        raise AssertionError(f"{tag} the frontier build never launched "
                             "first_moves")
    # the extraction kernel against the plain extraction on the queue's
    # own distances
    fm_plain = bellman_ford.first_move_from_dist(dg, t, queue.pop("dist"))
    if not torch.equal(fm_auto, fm_plain):
        raise AssertionError(f"{tag} first_moves differs from the plain "
                             f"extraction on {int((fm_auto != fm_plain).sum())}"
                             " entries of the frontier distances")
    del fm_plain
    kind_e, st_e = cpd.pick_build_kernel(g, "ellsplit")
    build_e = sharded.chunk_compute(dg, (kind_e, st_e))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    fm_e = build_e(t)
    torch.cuda.synchronize()
    ell_s = time.perf_counter() - t1
    if not torch.equal(fm_auto, fm_e):
        bad = int((fm_auto != fm_e).sum())
        raise AssertionError(f"{tag} frontier fm differs from ellsplit on "
                             f"{bad} entries")
    pops, queue_s = queue["pops"], queue["s"]
    ms_pop = queue_s * 1e3 / max(pops, 1)
    log(f"{tag} worker 0's first {CHUNK} targets: auto (frontier queue + "
        f"first_moves) {auto_s:.3f} s, queue {pops} pops in {queue_s:.3f} s "
        f"= {ms_pop:.4f} ms a pop (host syncs as they are), ellsplit "
        f"{ell_s:.3f} s; fm [{CHUNK}, {g.n}] byte-equal to ellsplit's and "
        "to the plain extraction of the queue's distances; build kernel "
        f"launches of the auto build {counts}")
    del fm_auto, fm_e, dg
    gc.collect()
    torch.cuda.empty_cache()
    return {"kind": kind, "locality": [loc0, loc], "tool_s": tool_s,
            "targets": CHUNK, "auto_s": auto_s, "pops": pops,
            "queue_s": queue_s, "ms_per_pop": ms_pop,
            "ellsplit_s": ell_s}, counts


# ------------------------------------------------------------------ A* path

def astar_inputs(outdir: str, ref: dict) -> dict:
    """The A* phase's files beside the campaign's: the first
    ``ASTAR_QUERIES`` campaign queries and their first
    ``ASTAR_HEAP_CLI`` as scenarios, an in-process conf of each
    (partmethod ``tpu``, 8 workers; free flow and diff, the heap's free
    flow only), and a host conf (``mod`` over 8 localhost workers, free
    flow); every conf names an index directory that does not exist (A*
    reads none)."""
    queries = ref["queries"][:ASTAR_QUERIES]
    files = {"queries": queries, "dir": outdir}
    no_index = os.path.join(outdir, "astar-no-index")
    for name, part, diffs in (
            ("main", queries, ["-", ref["diff_path"]]),
            ("heap", queries[:ASTAR_HEAP_CLI], ["-"])):
        scen = os.path.join(outdir, f"astar-{name}.scen")
        write_scen(scen, part)
        conf = os.path.join(outdir, f"astar-{name}.json")
        with open(conf, "w") as f:
            json.dump({"workers": [f"tpu:{i}"
                                   for i in range(CAMPAIGN_WORKERS)],
                       "partmethod": "tpu", "partkey": CAMPAIGN_WORKERS,
                       "outdir": no_index, "xy_file": ref["xy"],
                       "scenfile": scen, "diffs": diffs}, f)
        files[name] = conf
    nfs = os.path.join(outdir, "astar-nfs")
    os.makedirs(nfs)
    files["nfs"] = nfs
    files["host"] = os.path.join(outdir, "astar-host.json")
    with open(files["host"], "w") as f:
        json.dump({"workers": ["localhost"] * HOST_WORKERS,
                   "partmethod": "mod", "partkey": HOST_WORKERS,
                   "outdir": no_index, "nfs": nfs, "projectdir": ROOT,
                   "xy_file": ref["xy"],
                   "scenfile": os.path.join(outdir, "astar-main.scen"),
                   "diffs": ["-"]}, f)
    return files


class AstarProbe:
    """Records each call ``process_query``'s A* rounds make — the batched
    search (``astar_batch_np``, with its per-chunk ``info`` and its
    arguments) or the heap engine — with its answers and its seconds
    (host clock, synchronised)."""

    def __init__(self):
        self.calls: list[dict] = []
        self._real = (process_query.astar_batch_np,
                      process_query._astar_heap_campaign)

    def _device(self, *a, **kw):
        info: dict = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self._real[0](*a, info=info, **kw)
        torch.cuda.synchronize()
        self.calls.append({"engine": "device", "s": time.perf_counter() - t0,
                           "out": out, "info": info})
        return out

    def _heap(self, *a, **kw):
        t0 = time.perf_counter()
        out = self._real[1](*a, **kw)
        self.calls.append({"engine": "heap", "s": time.perf_counter() - t0,
                           "out": out})
        return out

    def __enter__(self):
        process_query.astar_batch_np = self._device
        process_query._astar_heap_campaign = self._heap
        return self

    def __exit__(self, *exc):
        process_query.astar_batch_np, process_query._astar_heap_campaign = \
            self._real


class HostResults:
    """Has the head ask every server for its batch's per-query answers
    (``RuntimeConfig.results``) and reads each worker's results file as
    soon as its round's fan-out returns (a round's query files are
    rewritten by the next)."""

    def __init__(self, nfs: str, queries: np.ndarray, dc):
        self.nfs = nfs
        self.owner = dc.worker_of(queries[:, 1])
        self.n = len(queries)
        self.rounds: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        self.seconds: list[float] = []
        self._real = (process_query.runtime_config, process_query.fan_out)

    def _config(self, args):
        return dataclasses.replace(self._real[0](args), results=True)

    def _fan_out(self, jobs, fn, *a, **kw):
        t0 = time.perf_counter()
        out = self._real[1](jobs, fn, *a, **kw)
        self.seconds.append(time.perf_counter() - t0)
        cost = np.zeros(self.n, np.int64)
        plen = np.zeros(self.n, np.int64)
        fin = np.zeros(self.n, bool)
        for host, wid, _part in jobs:
            c, p, f = read_results_file(results_file_for(
                os.path.join(self.nfs, f"query.{host}{wid}")))
            sel = self.owner == wid
            cost[sel], plen[sel], fin[sel] = c, p, f
        self.rounds.append((cost, plen, fin))
        return out

    def __enter__(self):
        process_query.runtime_config = self._config
        process_query.fan_out = self._fan_out
        return self

    def __exit__(self, *exc):
        process_query.runtime_config, process_query.fan_out = self._real


def read_astar_launches() -> dict[str, int]:
    """K6's launches (the sweep's without the skip apart) and the plain
    A* runs (the batch loop, the heuristic) since the last
    zero_launches()."""
    return {"sweep": ca.astar_sweep.launches,
            "sweep_dense": ca.astar_sweep.dense,
            "batch_plain": ba.astar_batch.plain,
            "heuristic": ca.astar_heuristic.launches,
            "heuristic_plain": ca.astar_heuristic.plain}


def exact_costs(g, queries: np.ndarray, w=None) -> np.ndarray:
    """Shortest-path costs of ``queries`` under weights ``w``: every
    distinct target's distances by the relax kernel's loop (K1, exact
    int32 min-plus to convergence), 2,048 targets a call."""
    dg = DeviceGraph.from_graph(g, weights=w, device="cuda")
    csr = cbk.csr_from_ell(dg)
    targets, inv = np.unique(queries[:, 1], return_inverse=True)
    inv = inv.reshape(-1)
    out = np.zeros(len(queries), np.int64)
    for lo in range(0, len(targets), 2048):
        t = torch.as_tensor(targets[lo:lo + 2048].astype(np.int32),
                            device="cuda")
        d, _ = cbk.jacobi_dist(csr, t)
        sel = np.nonzero((inv >= lo) & (inv < lo + 2048))[0]
        src = torch.as_tensor(queries[sel, 0], device="cuda")
        col = torch.as_tensor(inv[sel] - lo, device="cuda")
        out[sel] = d[src, col].cpu().numpy()
        del d
    return out


def golden_costs(g, queries, cost, fin, w, tag: str) -> None:
    """Costs equal the exact shortest paths (:func:`exact_costs`) query
    by query, and every query of the strongly connected graph
    finishes."""
    if not fin.all():
        raise AssertionError(f"{tag} {int((~fin).sum())} queries left "
                             "unfinished on a strongly connected graph")
    want = exact_costs(g, queries, w)
    if not np.array_equal(cost, want):
        bad = np.nonzero(cost != want)[0]
        raise AssertionError(f"{tag} {len(bad)} costs differ from the "
                             f"shortest paths, first {bad[:5]}: "
                             f"{cost[bad[:5]]} != {want[bad[:5]]}")
    log(f"{tag} {len(queries)} costs equal the shortest paths (K1's "
        f"exact distances to {len(np.unique(queries[:, 1]))} targets)")


# The CPU references of the A* phase run in processes of their own
# (spawned: each imports this file, not the card), while the card works.
_REF_GRAPHS: dict = {}


def reference_graph(spec: tuple, diff_path: str | None):
    """A reference process's graph and weights: ``spec`` ``("xy",
    path)`` or ``("road", nodes, seed)``, ``diff_path`` None for free
    flow; the graph is made once a process."""
    if spec not in _REF_GRAPHS:
        _REF_GRAPHS[spec] = (Graph.from_xy(spec[1]) if spec[0] == "xy"
                             else synth_road_network(spec[1],
                                                     seed=spec[2]))
    g = _REF_GRAPHS[spec]
    return g, (g.w if diff_path is None
               else g.weights_with_diff(read_diff(diff_path)))


def heap_reference(xy: str, queries: np.ndarray):
    """``process_query``'s heap route (``_astar_heap_campaign``, hscale
    1, free flow) on a share of the queries: ``(cost, plen, finished,
    seconds)``."""
    g, _ = reference_graph(("xy", xy), None)
    t0 = time.perf_counter()
    cost, plen, fin, _ = process_query._astar_heap_campaign(
        g, queries, None, 1.0, 0.0, None)
    return cost, plen, fin, time.perf_counter() - t0


def dijkstra_reference(spec: tuple, diff_path: str | None,
                       queries: np.ndarray) -> np.ndarray:
    """:func:`scipy_dijkstra` on a reference process's graph."""
    g, w = reference_graph(spec, diff_path)
    return scipy_dijkstra(g, w, queries)


def scipy_dijkstra(g, w, queries: np.ndarray) -> np.ndarray:
    """scipy's Dijkstra (no code of the port) from each distinct target
    of ``queries`` over the reversed graph under weights ``w``, parallel
    edges reduced to the lightest: each query's shortest-path cost, INF
    where none."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import dijkstra

    w = np.asarray(w, np.int64)
    key = g.dst.astype(np.int64) * g.n + g.src
    order = np.lexsort((w, key))
    first = np.r_[True, key[order][1:] != key[order][:-1]]
    keep = order[first]
    rev = sp.csr_matrix((w[keep].astype(np.float64),
                         (g.dst[keep], g.src[keep])), shape=(g.n, g.n))
    targets, inv = np.unique(queries[:, 1], return_inverse=True)
    d = dijkstra(rev, directed=True, indices=targets)
    out = d[inv.reshape(-1), queries[:, 0]]
    return np.where(np.isinf(out), ba.JINF, out).astype(np.int64)


class AstarReferences:
    """The phase's CPU references in :data:`ASTAR_REF_PROCS` spawned
    processes: the heap route on queries and scipy's Dijkstra on the
    queries of seeded targets, submitted in shares at once and collected
    at the end. Every process is stopped on exit."""

    def __init__(self):
        import multiprocessing

        self.pool = multiprocessing.get_context("spawn").Pool(
            ASTAR_REF_PROCS)
        self.jobs: dict[str, tuple[list, list]] = {}

    def submit(self, name: str, fn, shares: list[np.ndarray], *lead):
        """``fn(*lead, share)`` for each index share; ``name`` collects
        them."""
        self.jobs[name] = (shares, [self.pool.apply_async(fn, (*lead, part))
                                    for part in shares])

    def collect(self, name: str, timeout: float = 600.0) -> list:
        return [r.get(timeout) for r in self.jobs[name][1]]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.pool.terminate()
        self.pool.join()


def check_dijkstra(tag: str, queries: np.ndarray, sel: np.ndarray,
                   cost: np.ndarray, parts: list) -> None:
    """The costs at ``sel`` equal scipy's Dijkstra (``parts``, in share
    order), or raise."""
    want = np.concatenate(parts)
    got = cost[sel]
    if not np.array_equal(got, want):
        bad = np.nonzero(got != want)[0]
        raise AssertionError(f"{tag} {len(bad)} of {len(sel)} costs differ "
                             f"from scipy's Dijkstra, first queries "
                             f"{sel[bad[:5]]}: {got[bad[:5]]} != "
                             f"{want[bad[:5]]}")
    log(f"{tag} {len(sel)} costs (every query to "
        f"{len(np.unique(queries[sel, 1]))} seeded targets) equal scipy's "
        "Dijkstra")


def astar_chunk_tensors(g, queries: np.ndarray) -> tuple[dict, float]:
    """One chunk's inputs on the card, as ``astar_batch_np`` makes them
    (free-flow weights, every lane valid), and ``min_cost_per_unit``."""
    in_nbr, in_eid = g.ell("in")

    def dev(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device="cuda")

    return {"in_nbr": dev(in_nbr, torch.int32),
            "in_eid": dev(in_eid, torch.int32),
            "w_pad": dev(g.padded_weights(), torch.int32),
            "xs": dev(np.asarray(g.xs, np.float32), torch.float32),
            "ys": dev(np.asarray(g.ys, np.float32), torch.float32),
            "s": dev(queries[:, 0], torch.int32),
            "t": dev(queries[:, 1], torch.int32),
            "valid": torch.ones(len(queries), dtype=torch.bool,
                                device="cuda")}, min_cost_per_unit(g)


def sweep_bytes(n: int, k: int, q: int) -> int:
    """The bytes a sweep's function needs: g, h, hops and changed read,
    g, hops and improved written (22 bytes a cell), the in-edge ELL
    (in_nbr, w_in), the targets and the valid lanes."""
    return 22 * n * q + 8 * n * k + 5 * q


def sweep_design_bytes(n: int, q: int) -> int:
    """The bytes K6's design adds to a sweep beyond :func:`sweep_bytes`
    (logged apart, not in the bound): the dirty groups read and written
    (a byte a node and group of 32 queries each way) and the rows'
    in-degrees."""
    return 2 * n * ba.n_groups(q) + 4 * n


def heuristic_bytes(n: int, q: int) -> int:
    """The heuristic's distinct bytes: the coordinates and the targets
    read, h written."""
    return 8 * n + 4 * q + 4 * n * q


def sweep_buffers(n: int, q: int) -> tuple:
    """One set of a sweep's outputs (g, hops, improved, groups)."""
    return (torch.empty((n, q), dtype=torch.int32, device="cuda"),
            torch.empty((n, q), dtype=torch.int32, device="cuda"),
            torch.empty((n, q), dtype=torch.uint8, device="cuda"),
            torch.empty((n, ba.n_groups(q)), dtype=torch.uint8,
                        device="cuda"))


def astar_vs_plain(tag: str, args: dict, cpu: float, hscale: float,
                   fscale: float, converge: bool) -> dict:
    """K6 against the plain versions on one chunk's exact inputs: the
    heuristic entry against ``heuristic_plain``; sweeps 1..3, each
    launched at skip 1 and at skip 0 on the plain iterate, against
    ``sweep_plain`` (g, hops, improved, the dirty groups, the flag and the
    five counts after each); with ``converge``, K6's loop against the
    plain copy of the JAX loop at convergence (cost, plen, finished, the
    sweep count, every sweep's counts and the float32 totals). Times the
    heuristic and a sweep launch at each skip (CUDA events, back to back)
    and the plain sweep. Equal or raise."""
    n, k = args["in_nbr"].shape
    q = args["s"].shape[0]
    xs, ys, t = args["xs"], args["ys"], args["t"]
    h = ca.astar_heuristic(xs, ys, t, cpu, hscale)
    h_plain = ba.heuristic_plain(xs, ys, t, cpu, hscale)
    torch.cuda.synchronize()
    if not torch.equal(h, h_plain):
        raise AssertionError(f"{tag} astar_heuristic differs from the plain "
                             f"table in {int((h != h_plain).sum())} entries")
    del h_plain
    h_ms = time_bare(lambda: ca.astar_heuristic(xs, ys, t, cpu, hscale),
                     KERNEL_REPS)
    h_plain_ms = time_cuda(lambda: ba.heuristic_plain(xs, ys, t, cpu,
                                                      hscale), PLAIN_REPS)
    w_in = args["w_pad"][args["in_eid"].long()]
    deg = ba.in_degree(args["in_eid"], args["w_pad"].shape[0] - 1)
    valid8 = args["valid"].to(torch.uint8)
    pg, phops, pch, pgrp = ba.init_state(n, args["s"], args["valid"])
    out = sweep_buffers(n, q)
    one = torch.ones(1, dtype=torch.int32, device="cuda")
    err = 0
    for j in range(len(ASTAR_CUTS)):
        want = ba.sweep_plain(args["in_nbr"], w_in, h, t, args["valid"], pg,
                              phops, pch, fscale)
        state = (pg, phops, pch.to(torch.uint8), pgrp)
        for skip in (True, False):
            flag = torch.zeros(1, dtype=torch.int32, device="cuda")
            counts = torch.zeros(ca.COUNT_SLOTS, dtype=torch.int64,
                                 device="cuda")
            ca.astar_sweep(args["in_nbr"], w_in, deg, h, t, valid8, *state,
                           *out, fscale, one, flag, counts, skip=skip)
            kg, khops, kimp, kgrp = out
            torch.cuda.synchronize()
            err = max(err, int((kg - want[0]).abs().max()),
                      int((khops - want[1]).abs().max()))
            same = (torch.equal(kg, want[0]) and torch.equal(khops, want[1])
                    and torch.equal(kimp.bool(), want[2])
                    and torch.equal(kgrp, ba.groups_plain(want[2]))
                    and torch.equal(counts[:5], want[3])
                    and bool(flag[0]) == bool(want[2].any()))
            if not same:
                raise AssertionError(
                    f"{tag} astar_sweep (skip {int(skip)}) differs from the "
                    f"plain sweep after sweep {j + 1}: g "
                    f"{int((kg != want[0]).sum())}, hops "
                    f"{int((khops != want[1]).sum())}, improved "
                    f"{int((kimp.bool() != want[2]).sum())} entries; counts "
                    f"{counts[:5].tolist()} vs {want[3].tolist()}")
        pg, phops, pch = want[:3]
        pgrp = ba.groups_plain(pch)
        del want, state
    log(f"{tag} hscale {hscale} fscale {fscale}: astar_heuristic equal to "
        f"the plain table ([{n}, {q}]); g, hops, improved, the dirty "
        f"groups, the flag and the five counts equal the plain sweep after "
        f"sweeps {', '.join(map(str, ASTAR_CUTS))} at skip 1 and skip 0")
    # a sweep launch with its flag set, on the state after the cuts
    state = (pg, phops, pch.to(torch.uint8), pgrp)
    scratch = torch.zeros(ca.COUNT_SLOTS, dtype=torch.int64, device="cuda")
    flag = torch.zeros(1, dtype=torch.int32, device="cuda")
    ms, dense_ms = (time_bare(lambda skip=skip: ca.astar_sweep(
        args["in_nbr"], w_in, deg, h, t, valid8, *state, *out, fscale, one,
        flag, scratch, skip=skip), KERNEL_REPS) for skip in (True, False))
    plain_ms = time_cuda(lambda: ba.sweep_plain(
        args["in_nbr"], w_in, h, t, args["valid"], pg, phops, pch, fscale),
        PLAIN_REPS)
    del out, state
    bound_ms, bound_by = bound(sweep_bytes(n, k, q), 5 * n * k * q)
    h_bound_ms, h_bound_by = bound(heuristic_bytes(n, q), 12 * n * q)
    res = {"n": n, "k": k, "q": q, "hscale": hscale, "fscale": fscale,
           "ms": ms, "dense_ms": dense_ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "design_bytes": sweep_design_bytes(n, q), "h_ms": h_ms,
           "h_plain_ms": h_plain_ms, "h_bound_ms": h_bound_ms,
           "h_bound_by": h_bound_by, "max_abs_err": err}
    log(f"{tag} a sweep [{n} x {q}, K = {k}] after sweep {ASTAR_CUTS[-1]}: "
        f"{ms:.4f} ms with the skip, {dense_ms:.4f} ms without (bound "
        f"{bound_ms:.4f} ms by {bound_by}: {sweep_bytes(n, k, q)} B; the "
        f"design adds {sweep_design_bytes(n, q)} B of groups and degrees, "
        f"not in the bound), plain "
        f"sweep {plain_ms:.4f} ms; heuristic {h_ms:.4f} ms (bound "
        f"{h_bound_ms:.4f} by {h_bound_by}), plain {h_plain_ms:.4f} ms")
    if converge:
        info, pinfo = {}, {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = ca.astar_loop(**args, hscale=hscale, fscale=fscale, cpu=cpu,
                            info=info)
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = ba.astar_batch_plain(**args, hscale=hscale, fscale=fscale,
                                    cpu=cpu, info=pinfo)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        same = (all(torch.equal(a, b) for a, b in zip(got[:3], want[:3]))
                and got[3] == want[3] and info["sweeps"] == pinfo["sweeps"]
                and np.array_equal(info["counts"], pinfo["counts"]))
        if not same:
            raise AssertionError(
                f"{tag} K6's loop differs from the plain loop at "
                f"convergence: sweeps {info['sweeps']} vs "
                f"{pinfo['sweeps']}, counters {got[3]} vs {want[3]}")
        res.update(sweeps=info["sweeps"], launches=info["launches"],
                   loop_s=loop_s, plain_loop_s=plain_s,
                   counters=got[3], exact=info["exact"],
                   counts=info["counts"])
        log(f"{tag} converged: cost, plen, finished, {info['sweeps']} "
            f"sweeps (as the plain loop), every sweep's counts and the "
            f"float32 totals {got[3]} equal the plain loop (exact totals "
            f"{info['exact']}); K6's loop {loop_s:.3f} s ({info['launches']} "
            f"launches, {1e3 * loop_s / max(info['sweeps'], 1):.4f} ms a "
            f"sweep on the host clock), the plain loop {plain_s:.3f} s")
    return res


def dirty_share(in_nbr: torch.Tensor, deg: torch.Tensor,
                groups: torch.Tensor) -> float:
    """The share of (node, query group, real slot) triples, a warp's
    slots in K6's sweep, whose source's group is dirty: the gathers the
    skip leaves (plain torch on the card)."""
    k = in_nbr.shape[1]
    real = (torch.arange(k, device=in_nbr.device)[None, :]
            < deg.long()[:, None])
    dirty = groups.bool()[in_nbr.long()] & real[:, :, None]
    return int(dirty.sum()) / (int(real.sum()) * groups.shape[1])


def k6_sweeps(args: dict, h: torch.Tensor, w_in: torch.Tensor,
              deg: torch.Tensor, fscale: float, sweeps: int, skip: bool,
              keep: tuple = ()) -> tuple[float, np.ndarray, dict]:
    """``sweeps`` K6 sweeps from ``init_state``, launched back to back
    with their flags chained as ``astar_loop`` chains them and timed by
    CUDA events behind a spin kernel: ``(ms, counts, kept)``, ``counts``
    every sweep's five counts, ``kept`` a copy of the state after each
    sweep in ``keep`` (then the time includes the copies)."""
    n = args["in_nbr"].shape[0]
    q = args["s"].shape[0]
    g0, hops0, ch0, grp0 = ba.init_state(n, args["s"], args["valid"])
    bufs = ((g0, hops0, ch0.to(torch.uint8), grp0), sweep_buffers(n, q))
    valid8 = args["valid"].to(torch.uint8)
    flags = torch.zeros(sweeps + 1, dtype=torch.int32, device="cuda")
    flags[0] = 1
    counts = torch.zeros((sweeps, ca.COUNT_SLOTS), dtype=torch.int64,
                         device="cuda")
    kept = {}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for j in range(sweeps):
        ca.astar_sweep(args["in_nbr"], w_in, deg, h, args["t"], valid8,
                       *bufs[j % 2], *bufs[(j + 1) % 2], fscale,
                       flags[j:j + 1], flags[j + 1:j + 2], counts[j],
                       skip=skip)
        if j + 1 in keep:
            kept[j + 1] = tuple(x.clone() for x in bufs[(j + 1) % 2])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), counts[:, :5].cpu().numpy(), kept


def astar_loop_profile(tag: str, args: dict, cpu: float, hscale: float,
                       fscale: float, counts: np.ndarray,
                       snapshots: bool) -> dict:
    """K6's loop on the device clock at both skip values: the S sweeps of
    a converged run (``counts``, its per-sweep counts, which each run
    must reproduce) launched back to back, ms a sweep. With
    ``snapshots``, the states after sweeps 3, S // 2 and S - 5 of a third
    run (skip 1, with copies), on each a sweep timed at skip 1 and skip 0
    (CUDA events) beside the dirty share of its (node, group, real slot)
    triples."""
    n, k = args["in_nbr"].shape
    q = args["s"].shape[0]
    sweeps = len(counts)
    h = ca.astar_heuristic(args["xs"], args["ys"], args["t"], cpu, hscale)
    w_in = args["w_pad"][args["in_eid"].long()]
    deg = ba.in_degree(args["in_eid"], args["w_pad"].shape[0] - 1)
    loop = {}
    for name, skip in (("skip", True), ("dense", False)):
        ms, got, _ = k6_sweeps(args, h, w_in, deg, fscale, sweeps, skip)
        if not np.array_equal(got, counts):
            raise AssertionError(f"{tag} K6's sweeps at skip {int(skip)} "
                                 "differ from the converged loop's counts")
        loop[name] = {"ms": ms, "ms_a_sweep": ms / max(sweeps, 1)}
    out = {"sweeps": sweeps, "loop": loop}
    log(f"{tag} K6's loop on the device clock, {sweeps} sweeps back to back "
        f"(every sweep's counts == the loop's): {loop['skip']['ms']:.3f} ms "
        f"= {loop['skip']['ms_a_sweep']:.4f} ms a sweep with the skip, "
        f"{loop['dense']['ms']:.3f} ms = {loop['dense']['ms_a_sweep']:.4f} "
        "ms a sweep without")
    if snapshots and sweeps > 8:
        at = (3, sweeps // 2, sweeps - 5)
        _, _, kept = k6_sweeps(args, h, w_in, deg, fscale, sweeps, True,
                               keep=at)
        one = torch.ones(1, dtype=torch.int32, device="cuda")
        flag = torch.zeros(1, dtype=torch.int32, device="cuda")
        scratch = torch.zeros(ca.COUNT_SLOTS, dtype=torch.int64,
                              device="cuda")
        dst = sweep_buffers(n, q)
        valid8 = args["valid"].to(torch.uint8)
        snaps = []
        for j in at:
            state = kept.pop(j)
            share = dirty_share(args["in_nbr"], deg, state[3])
            ms, dense_ms = (time_bare(lambda skip=skip: ca.astar_sweep(
                args["in_nbr"], w_in, deg, h, args["t"], valid8, *state,
                *dst, fscale, one, flag, scratch, skip=skip), KERNEL_REPS)
                for skip in (True, False))
            snaps.append({"after_sweep": j, "dirty_share": share, "ms": ms,
                          "dense_ms": dense_ms,
                          "changed": int(state[2].sum())})
            log(f"{tag} snapshot after sweep {j} of {sweeps}: dirty share "
                f"{share:.4f} of the (node, group, real slot) triples, "
                f"{snaps[-1]['changed']} changed cells; a sweep {ms:.4f} ms "
                f"with the skip, {dense_ms:.4f} ms without")
            del state
        out["snapshots"] = snaps
    return out


def check_astar_dump(sv: dict, card: str, pid: int) -> None:
    """An A* server's dump: it served from this card, launched K6 (sweep,
    every launch with the skip, and heuristic) and ran no plain version,
    and it answered the pings."""
    c, d = sv["counters"], sv["device"]
    if (d["name"] != card or d["type"] != "cuda" or sv["alg"] != "astar"
            or c["astar_sweep.launches"] <= 0
            or c["astar_sweep.dense"] != 0
            or c["astar_heuristic.launches"] <= 0
            or c["astar_batch.plain"] != 0
            or c["astar_heuristic.plain"] != 0 or sv["pid"] != pid):
        raise AssertionError(f"[astar] server {sv['wid']}: {sv}")


def astar_host_round(files: dict, g, inproc: list) -> dict:
    """``make_fifos --alg astar``: 8 tracked servers (no index) on the
    card, then ``process_query --backend host`` over them on the phase's
    queries, one free-flow round, every server asked for its per-query
    answers; those equal the in-process free-flow round's query by
    query, and the round's ``parts.csv`` sums equal its. Returns the
    servers' K6 launches and the round's seconds."""
    tag = "[astar-host]"
    conf, nfs, queries = files["host"], files["nfs"], files["queries"]
    w = HOST_WORKERS
    dc = DistributionController("mod", w, w, g.n)
    card = torch.cuda.get_device_name(0)
    fifos = {x: os.path.join(files["dir"], f"astar-worker{x}.fifo")
             for x in range(w)}
    fifo_names = (make_fifos.command_fifo_path,
                  process_query.command_fifo_path)
    make_fifos.command_fifo_path = process_query.command_fifo_path = \
        fifos.__getitem__
    old_timeout = os.environ.get("DOS_SEND_TIMEOUT_S")
    os.environ["DOS_SEND_TIMEOUT_S"] = str(HOST_SEND_TIMEOUT_S)
    dump = os.path.join(files["dir"], "astar-serve")
    out = os.path.join(files["dir"], "astar-host-rounds")
    procs: dict = {}
    exits: dict[int, int] = {}
    try:
        try:
            t_launch = time.perf_counter()
            procs = dict(make_fifos.launch_servers(
                ClusterConfig.load(conf), conf, metrics_dump=dump,
                track=True, alg="astar"))
            ready = wait_ready(fifos, procs, nfs, t_launch, HOST_READY_S)
            if len(ready) != w:
                raise AssertionError(
                    f"{tag} servers {sorted(set(fifos) - set(ready))} did "
                    f"not answer a ping within {HOST_READY_S} s")
            pids = {x: p.pid for x, p in procs.items()}
            with HostResults(nfs, queries, dc) as hr:
                rc = process_query.main(["-c", conf, "-o", out])
        finally:
            exits = stop_servers(fifos, procs)
    except BaseException:
        log_tails(nfs)
        raise
    finally:
        make_fifos.command_fifo_path, process_query.command_fifo_path = \
            fifo_names
        if old_timeout is None:
            os.environ.pop("DOS_SEND_TIMEOUT_S", None)
        else:
            os.environ["DOS_SEND_TIMEOUT_S"] = old_timeout
    if rc != 0 or any(exits.values()):
        raise AssertionError(f"{tag} process_query rc {rc}, server exit "
                             f"codes {exits}")
    launches = {"sweep": 0, "heuristic": 0}
    for x in range(w):
        with open(f"{dump}.w{x}.json") as f:
            sv = json.load(f)
        check_astar_dump(sv, card, pids[x])
        launches["sweep"] += sv["counters"]["astar_sweep.launches"]
        launches["heuristic"] += sv["counters"]["astar_heuristic.launches"]
    log(f"{tag} {w} servers ready in "
        + ", ".join(f"{ready[x][1]:.2f}" for x in sorted(ready))
        + f" s; every dump names {card!r}, K6 launched (sweep "
        f"{launches['sweep']}, heuristic {launches['heuristic']} in all), "
        "every sweep with the skip (astar_sweep.dense 0), no plain sweep "
        "or heuristic; every server exited 0")
    parts = read_parts(os.path.join(out, "parts.csv"))
    if len(hr.rounds) != 1:
        raise AssertionError(f"{tag} {len(hr.rounds)} rounds, not 1")
    for expe, name in enumerate(("free-flow",)):
        cost, plen, fin = hr.rounds[expe]
        want = inproc[expe]
        if not (np.array_equal(cost, want[0])
                and np.array_equal(plen, want[1])
                and np.array_equal(fin, want[2])):
            raise AssertionError(f"{tag} round {name}: the servers' "
                                 "answers differ from the in-process run")
        sums = (len(queries), int(want[1].sum()), int(want[2].sum()))
        if round_sums(parts, expe) != sums:
            raise AssertionError(f"{tag} parts.csv round {name}: "
                                 f"{round_sums(parts, expe)} != {sums}")
        log(f"{tag} round {name}: {len(queries)} queries in "
            f"{hr.seconds[expe]:.3f} s = "
            f"{len(queries) / hr.seconds[expe]:.1f} q/s; cost, plen and "
            "finished equal the in-process run query by query, parts.csv "
            "sums too")
    return {"launches": launches, "round_s": hr.seconds,
            "ready_s": [ready[x][1] for x in sorted(ready)]}


def target_shares(queries: np.ndarray, n_targets: int, seed: int,
                  n_shares: int) -> list[np.ndarray]:
    """The indices of the queries whose target is one of ``n_targets``
    distinct targets drawn with ``seed``, in ``n_shares`` groups of
    whole targets (one Dijkstra a target)."""
    rng = np.random.default_rng(seed)
    pick = rng.choice(np.unique(queries[:, 1]), n_targets, replace=False)
    return [np.nonzero(np.isin(queries[:, 1], part))[0]
            for part in np.array_split(np.sort(pick), n_shares)]


def astar_path(outdir: str, ref: dict) -> tuple[dict, dict]:
    """A* on the card (no index): ``process_query --alg astar`` as a user
    calls it (its default: the batched search on the card, K6) on the
    first campaign queries, free flow and diff (the phase's main run,
    counts zeroed before it and read after it; then the servers' main
    run); ``make_fifos --alg astar`` and a host free-flow round held to
    it; the heap route (``DOS_ASTAR_DEVICE=0``) on the first queries held
    to K6. Then, while reference processes run the heap route on the
    first ``ASTAR_HEAP_QUERIES`` queries and scipy's Dijkstra on the
    queries of seeded targets: the rounds' costs against K1's exact
    distances; K6 against the plain versions on one chunk of the
    campaign graph (hscale 1 and 1.5 / fscale 0.1, sweeps 1-3 at both
    skips; at convergence at hscale 1) and of the road graph at full
    width (sweeps 1-3 at both skips; K6's loop, costs against K1's); on
    both, K6's loop on the device clock at both skips, and on the
    campaign chunk three snapshots with their dirty shares. Every round
    and server sweeps with the skip (``astar_sweep.dense`` 0). Last, the
    references' answers against K6's. Returns the kernel table's two
    entries."""
    tag = "[astar]"
    t_phase = time.perf_counter()
    g = ref["g"]
    files = astar_inputs(outdir, ref)
    queries = files["queries"]
    w_diff = g.weights_with_diff(read_diff(ref["diff_path"]))

    # 1. the main run: the in-process rounds, by default on K6
    out = os.path.join(outdir, "astar-rounds")
    old = os.environ.pop("DOS_ASTAR_DEVICE", None)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    try:
        with AstarProbe() as probe:
            rc = process_query.main(["-c", files["main"], "--alg", "astar",
                                     "-o", out])
        launches = read_astar_launches()
        peak = torch.cuda.max_memory_allocated()
        if rc != 0:
            raise AssertionError(f"{tag} process_query exit code {rc}")
        if (launches["sweep"] <= 0 or launches["heuristic"] <= 0
                or launches["sweep_dense"] or launches["batch_plain"]
                or launches["heuristic_plain"]):
            raise AssertionError(f"{tag} the rounds' launches {launches}: "
                                 "K6 never launched, a sweep ran without "
                                 "the skip, or a plain version ran")
        if ([c["engine"] for c in probe.calls] != ["device", "device"]
                or os.path.exists(os.path.join(outdir, "astar-no-index"))):
            raise AssertionError(f"{tag} the rounds took {probe.calls}, or "
                                 "an index directory appeared")
        inproc, rounds = [], []
        parts = read_parts(os.path.join(out, "parts.csv"))
        for expe, (name, call) in enumerate(zip(("free-flow", "diff"),
                                                probe.calls)):
            cost, plen, fin, counters = call["out"]
            inproc.append((cost, plen, fin))
            info = call["info"]
            sums = (len(queries), int(plen.sum()), int(fin.sum()))
            if round_sums(parts, expe) != sums:
                raise AssertionError(f"{tag} parts.csv round {name}: "
                                     f"{round_sums(parts, expe)} != {sums}")
            rounds.append({"round": name, "s": call["s"],
                           "qps": len(queries) / call["s"],
                           "sweeps": info["sweeps"],
                           "launches": info["launches"],
                           "counters": counters, "exact": info["exact"]})
            log(f"{tag} round {name}: {len(queries)} queries in "
                f"{call['s']:.3f} s = {len(queries) / call['s']:.1f} q/s; "
                f"{len(info['sweeps'])} chunks of {ASTAR_CHUNK}, sweeps "
                f"{info['sweeps']}, launches {info['launches']}; counters "
                f"(float32 totals, as JAX) {counters}; exact "
                f"{info['exact']}")
        log(f"{tag} launches in the rounds' run (process_query's default "
            f"route): astar_sweep {launches['sweep']} (every one with the "
            f"skip: astar_sweep.dense 0), astar_heuristic "
            f"{launches['heuristic']}, no plain loop or heuristic; no index "
            f"read or written; peak device memory {peak / 2**30:.2f} GiB; "
            "parts.csv sums equal the rounds' answers")

        # 2. the host backend over A* servers, held to the in-process
        # free-flow round
        host = astar_host_round(files, g, inproc)

        # 3. the heap route through process_query on the first queries
        os.environ["DOS_ASTAR_DEVICE"] = "0"
        with AstarProbe() as heap_probe:
            rc = process_query.main(["-c", files["heap"], "--alg", "astar",
                                     "-o", os.path.join(outdir,
                                                        "astar-heap")])
    finally:
        if old is None:
            os.environ.pop("DOS_ASTAR_DEVICE", None)
        else:
            os.environ["DOS_ASTAR_DEVICE"] = old
    if rc != 0 or [c["engine"] for c in heap_probe.calls] != ["heap"]:
        raise AssertionError(f"{tag} DOS_ASTAR_DEVICE=0: rc {rc}, calls "
                             f"{[c['engine'] for c in heap_probe.calls]}")
    nh = ASTAR_HEAP_CLI
    h_cost, h_plen, h_fin, _ = heap_probe.calls[0]["out"]
    heap_s = heap_probe.calls[0]["s"]
    if not (h_fin.all() and np.array_equal(h_cost, inproc[0][0][:nh])):
        raise AssertionError(f"{tag} the heap route's costs differ from "
                             "K6's")
    log(f"{tag} heap route (DOS_ASTAR_DEVICE=0), free flow: {nh} queries "
        f"in {heap_s:.3f} s ({heap_s / nh:.4f} s a query on the host); "
        "costs equal K6's")

    road_g = synth_road_network(N_NODES, seed=SEED)
    road_q = make_queries(np.arange(road_g.n), road_g.n)[:ASTAR_CHUNK]
    camp = ("xy", ref["xy"])
    shares = {"free-flow": target_shares(queries, ASTAR_DIJKSTRA, SEED + 2,
                                         8),
              "diff": target_shares(queries, ASTAR_DIJKSTRA, SEED + 3, 8),
              "road": target_shares(road_q, ASTAR_ROAD_DIJKSTRA, SEED + 4,
                                    8)}
    heap_shares = [queries[lo:lo + 16]
                   for lo in range(0, ASTAR_HEAP_QUERIES, 16)]
    with AstarReferences() as refs:
        # 4. the CPU references start; they run while the card works
        refs.submit("heap", heap_reference, heap_shares, ref["xy"])
        refs.submit("free-flow", dijkstra_reference,
                    [queries[ix] for ix in shares["free-flow"]], camp, None)
        refs.submit("diff", dijkstra_reference,
                    [queries[ix] for ix in shares["diff"]], camp,
                    ref["diff_path"])
        refs.submit("road", dijkstra_reference,
                    [road_q[ix] for ix in shares["road"]],
                    ("road", N_NODES, SEED), None)

        # 5. the rounds' costs against K1's exact distances
        for (name, w), (cost, _, fin) in zip(
                (("free-flow", None), ("diff", w_diff)), inproc):
            golden_costs(g, queries, cost, fin, w, f"{tag} round {name}")

        # 6. K6 against the plain versions on the campaign's first chunk;
        # its loop on the device clock at both skips, and snapshots
        args, cpu = astar_chunk_tensors(g, queries[:ASTAR_CHUNK])
        chunk = [astar_vs_plain(f"{tag} campaign chunk", args, cpu, hs, fs,
                                converge=x == 0)
                 for x, (hs, fs) in enumerate(ASTAR_KNOBS)]
        hs, fs = ASTAR_KNOBS[0]
        chunk[0].update(astar_loop_profile(
            f"{tag} campaign chunk", args, cpu, hs, fs,
            chunk[0].pop("counts"), snapshots=True))
        del args
        gc.collect()
        torch.cuda.empty_cache()

        # 7. the road network at full width: one chunk, sweeps 1-3
        # against the plain sweep, K6's loop, costs against the shortest
        # paths
        args, cpu = astar_chunk_tensors(road_g, road_q)
        road = astar_vs_plain(f"{tag} road chunk", args, cpu, 1.0, 0.0,
                              converge=False)
        gc.collect()
        torch.cuda.empty_cache()
        info: dict = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cost, plen, fin, counters = ca.astar_loop(
            **args, hscale=1.0, fscale=0.0, cpu=cpu, info=info)
        torch.cuda.synchronize()
        road.update(sweeps=info["sweeps"], loop_s=time.perf_counter() - t0,
                    launches=info["launches"], exact=info["exact"])
        log(f"{tag} road chunk: K6's loop {road['loop_s']:.3f} s, "
            f"{info['sweeps']} sweeps ({info['launches']} launches), "
            f"{ASTAR_CHUNK / road['loop_s']:.1f} q/s; exact counts "
            f"{info['exact']}")
        road.update(astar_loop_profile(f"{tag} road chunk", args, cpu, 1.0,
                                       0.0, info["counts"],
                                       snapshots=False))
        del args
        gc.collect()
        torch.cuda.empty_cache()
        road_cost = cost.cpu().numpy().astype(np.int64)
        golden_costs(road_g, road_q, road_cost, fin.cpu().numpy(), None,
                     f"{tag} road chunk")
        del road_g

        # 8. the references' answers against K6's
        t0 = time.perf_counter()
        heap_parts = refs.collect("heap")
        dijkstra = {name: refs.collect(name) for name in shares}
        wait_s = time.perf_counter() - t0
    nh = ASTAR_HEAP_QUERIES
    h_cost = np.concatenate([p[0] for p in heap_parts])
    h_plen = np.concatenate([p[1] for p in heap_parts])
    h_fin = np.concatenate([p[2] for p in heap_parts])
    ref_heap_s = sum(p[3] for p in heap_parts)
    cost, plen, _ = inproc[0]
    if not (h_fin.all() and np.array_equal(h_cost, cost[:nh])):
        bad = np.nonzero(h_cost != cost[:nh])[0]
        raise AssertionError(f"{tag} the heap route's free-flow costs differ "
                             f"from K6's on {len(bad)} of {nh} queries, "
                             f"first {bad[:5]}")
    log(f"{tag} heap route in {ASTAR_REF_PROCS} reference processes, free "
        f"flow: {nh} queries, {ref_heap_s:.1f} s of process time "
        f"({ref_heap_s / nh:.4f} s a query, the processes sharing the "
        f"host); costs equal K6's; plen differs on "
        f"{int((h_plen != plen[:nh]).sum())} of {nh} (ties between optimal "
        f"paths); the phase waited {wait_s:.1f} s for the references")
    for name, (cost, _, _) in zip(("free-flow", "diff"), inproc):
        check_dijkstra(f"{tag} round {name}", queries,
                       np.concatenate(shares[name]), cost, dijkstra[name])
    check_dijkstra(f"{tag} road chunk", road_q,
                   np.concatenate(shares["road"]), road_cost,
                   dijkstra["road"])
    log(f"{tag} phase {time.perf_counter() - t_phase:.1f} s")

    source = "distributed_oracle_search_tpu_torch/csrc/batched_astar.cu"
    replaces = ("distributed_oracle_search_tpu/ops/batched_astar.py:{} "
                "({}, an XLA stage: no pallas_call)")
    head = chunk[0]
    common = {"route": "cuda", "source": source, "library_ms": None,
              "parity": "bit-identical",
              "max_abs_err": max(x["max_abs_err"] for x in (*chunk, road))}
    sweep = {"name": ca.ENTRY_SWEEP, **common,
             "replaces": replaces.format(125, "astar_batch's while_loop "
                                              "body"),
             "launches": launches["sweep"] + host["launches"]["sweep"],
             "launches_by_path": {"astar": launches["sweep"],
                                  "astar-host": host["launches"]["sweep"]},
             # a sweep's time depends on the state: the loop's mean on
             # the device clock, and one launch after the cuts beside it
             "ms": head["loop"]["skip"]["ms_a_sweep"],
             "cut_ms": head["ms"], "cut_dense_ms": head["dense_ms"],
             **{k: head[k] for k in ("plain_ms", "bound_ms", "bound_by",
                                     "loop", "snapshots")},
             "rounds": rounds,
             "peak_bytes": peak, "chunk": chunk,
             "road": road, "host": host, "heap_s": heap_s,
             "heap_reference_s": ref_heap_s, "reference_wait_s": wait_s}
    heur = {"name": ca.ENTRY_H, **common,
            "replaces": replaces.format(101, "astar_batch's heuristic "
                                             "table"),
            "launches": launches["heuristic"] + host["launches"]["heuristic"],
            "launches_by_path": {"astar": launches["heuristic"],
                                 "astar-host": host["launches"]["heuristic"]},
            "ms": head["h_ms"], "plain_ms": head["h_plain_ms"],
            "bound_ms": head["h_bound_ms"], "bound_by": head["h_bound_by"],
            "road_ms": road["h_ms"]}
    return sweep, heur


# ------------------------------------------------------------ streamed path

def round_line(tag: str, run: dict) -> str:
    """One streamed round: q/s, bytes, codecs and the seconds split."""
    st, sp = run["stats"], run["split"]
    h2d_gbs = (st["bytes_streamed"] / sp["h2d"] / 1e9
               if sp.get("h2d") else 0.0)
    split = ", ".join(f"{k} {v:.4f}" for k, v in sorted(sp.items()))
    return (f"{tag} {run['round']}: {st['n_queries']} queries in "
            f"{run['seconds']:.4f} s = {run['qps']:.1f} q/s; "
            f"{st['mode']} mode, {st['row_chunks']} chunks "
            f"({st['distinct_targets']} distinct targets), "
            f"bytes_streamed/bytes_raw "
            f"{st['bytes_streamed']}/{st['bytes_raw']} = "
            f"{st['bytes_streamed'] / max(st['bytes_raw'], 1):.4f}, "
            f"chunks_rle {st['chunks_rle']}, chunks_packed "
            f"{st['chunks_packed']}, sidecar_hits {st['sidecar_hits']}, "
            f"cache hits/misses {st['cache_hits']}/{st['cache_misses']}; "
            f"seconds: {split}; H2D {h2d_gbs:.2f} GB/s")


class StreamProbe:
    """Times every ``StreamedCPDOracle`` campaign (host clock,
    synchronised) and keeps its ``last_stats`` and ``last_seconds``; the
    first ``cuda_walk_batch`` call of the streamed oracle is recorded so
    its exact inputs can be replayed."""

    METHODS = ("query", "query_multi", "query_paths")

    def __init__(self):
        self.runs: list[dict] = []
        self.first_walk = None
        self._real = {m: getattr(streamed.StreamedCPDOracle, m)
                      for m in self.METHODS}
        self._real_walk = streamed.cuda_walk_batch
        self.name = ""

    def _timed(self, method):
        fn = self._real[method]

        def wrapper(oracle, *a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(oracle, *a, **kw)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            self.runs.append({"round": self.name or method, "method": method,
                              "seconds": dt, "qps": len(a[0]) / dt,
                              "stats": dict(oracle.last_stats),
                              "split": dict(oracle.last_seconds)})
            return out
        return wrapper

    def _walk(self, *a, **kw):
        if self.first_walk is None:
            self.first_walk = (a, kw)
        return self._real_walk(*a, **kw)

    def __enter__(self):
        for m in self.METHODS:
            setattr(streamed.StreamedCPDOracle, m, self._timed(m))
        streamed.cuda_walk_batch = self._walk
        return self

    def __exit__(self, *exc):
        for m, fn in self._real.items():
            setattr(streamed.StreamedCPDOracle, m, fn)
        streamed.cuda_walk_batch = self._real_walk


def same_answers(tag: str, what: str, got, want) -> None:
    for x, y, label in zip(got, want, ("0", "1", "2")):
        if not np.array_equal(np.asarray(x), np.asarray(y)):
            bad = int((np.asarray(x) != np.asarray(y)).sum())
            raise AssertionError(f"{tag} {what}: output {label} differs "
                                 f"from the resident engine's on {bad} "
                                 "entries")


def rle_triple_past_2_31(n: int, c: int, seed: int):
    """A transposed-RLE wire triple of an ``[c, n]`` int8 chunk with three
    runs a column (two seeded boundaries, seeded values), built on the
    host from the run lengths alone (``_pack_rle``'s layout: runs past
    255 split, the triple padded to a power of two). Returns the triple
    and the boundaries and values it encodes."""
    rng = np.random.default_rng(seed)
    b0 = rng.integers(1, c - 1, n)
    b1 = b0 + 1 + (rng.integers(0, 2**31, n) % (c - 1 - b0))
    vals = rng.integers(-1, 20, (n, 3)).astype(np.int8)
    lengths = np.stack([b0, b1 - b0, c - b1], axis=1).reshape(-1)
    pieces = -(-lengths // 255)
    tot = int(pieces.sum())
    cap = 1 << max(tot - 1, 0).bit_length()
    last = np.cumsum(pieces) - 1
    pl = np.full(tot, 255, np.uint8)
    pl[last] = (lengths - 255 * (pieces - 1)).astype(np.uint8)
    plen = np.zeros(cap, np.uint8)
    plen[:tot] = pl
    pval = np.full(cap, vals[-1, -1], np.int8)
    pval[:tot] = np.repeat(vals.reshape(-1), pieces)
    counts = pieces.reshape(n, 3).sum(axis=1).astype(np.int32)
    return (plen, pval, counts), (b0, b1, vals)


def decode_past_2_31(tag: str) -> dict:
    """C2: a chunk of ``N_NODES x C2_ROWS`` cells (past 2**31) decodes on
    the card to the columns its triple encodes, checked on the card in
    row slabs."""
    n, c = N_NODES, C2_ROWS
    t0 = time.perf_counter()
    wire, (b0, b1, vals) = rle_triple_past_2_31(n, c, SEED + 7)
    host_s = time.perf_counter() - t0
    dev = [torch.from_numpy(a).cuda() for a in wire]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fm = streamed._unpack_rle(*dev, c=c)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end)
    peak = torch.cuda.max_memory_allocated()
    b0d, b1d = (torch.from_numpy(x).cuda()[None, :] for x in (b0, b1))
    v = torch.from_numpy(vals).cuda().T
    bad = 0
    for r0 in range(0, c, 1024):
        r = torch.arange(r0, min(r0 + 1024, c), device="cuda")[:, None]
        want = torch.where(r < b0d, v[0], torch.where(r < b1d, v[1], v[2]))
        bad += int((fm[r0:r0 + len(r)] != want).sum())
    wire_bytes = sum(a.nbytes for a in wire)
    bound_ms, by = bound(wire_bytes + n * c, 0)
    log(f"{tag} decode past 2**31: [{c}, {n}] = {n * c} cells "
        f"({n * c / 2**31:.3f} x 2**31) from {len(wire[0])} runs "
        f"({wire_bytes} wire bytes, built on the host in {host_s:.2f} s): "
        f"{'equal' if not bad else f'{bad} cells differ'}; "
        f"{ms:.3f} ms on the card, bound {bound_ms:.4f} ms by {by}, peak "
        f"device memory {peak / 2**30:.2f} GiB")
    if bad or tuple(fm.shape) != (c, n):
        raise AssertionError(f"{tag} the decode past 2**31 cells is wrong "
                             f"on {bad} cells")
    del fm, dev
    gc.collect()
    torch.cuda.empty_cache()
    return {"cells": n * c, "ms": ms, "bound_ms": bound_ms,
            "wire_bytes": wire_bytes, "peak_bytes": peak}


def decoder_times(tag: str, st, wid: int, r0: int) -> dict:
    """Each decoder on one chunk of the phase, by CUDA events, beside its
    bound (the wire bytes read and the ``C x N`` int8 written once): the
    RLE decode of the chunk's sidecar triple, and the pack4 decode of
    the first ``PACK4_TIME_ROWS`` rows' nibbles (the host encode of a
    whole chunk takes seconds). Each must give the raw rows."""
    out = {}
    c = st.row_chunk
    raw = np.array(st._row_range(wid, r0, c))
    path = os.path.join(st.outdir, f"rle-w{wid:05d}-r{r0:09d}-c{c}.npz")
    with np.load(path) as z:
        rle = (None if "fallback" in z
               else (z["lens"], z["vals"], z["counts"]))
    rows = np.ascontiguousarray(raw[:PACK4_TIME_ROWS])
    p4 = streamed._pack4(rows)
    for name, wire, want_np, fn in (
            ("rle", rle, raw, lambda d: streamed._unpack_rle(*d, c=c)),
            ("pack4", p4, rows,
             lambda d: streamed._unpack4(d[0], st.graph.n, *d[1:]))):
        if wire is None:
            log(f"{tag} decoder {name}: the chunk does not encode")
            continue
        dev = [torch.from_numpy(a.view(np.int16) if a.dtype == np.uint16
                                else a).cuda() for a in wire]
        want = torch.from_numpy(want_np).cuda()
        if not torch.equal(fn(dev), want):
            raise AssertionError(f"{tag} decoder {name} differs from the "
                                 "raw rows")
        ms = time_cuda(lambda: fn(dev), DECODE_REPS)
        wire_bytes = sum(a.nbytes for a in wire)
        bound_ms, by = bound(wire_bytes + want_np.size, 0)
        out[name] = {"ms": ms, "bound_ms": bound_ms, "bound_by": by,
                     "wire_bytes": wire_bytes, "cells": int(want_np.size)}
        log(f"{tag} decoder {name}: {list(want_np.shape)} = "
            f"{want_np.size} cells from {wire_bytes} wire bytes in "
            f"{ms:.4f} ms, bound {bound_ms:.4f} ms by {by} "
            f"({bound_ms / ms:.1%} of it)")
        del dev, want
    gc.collect()
    torch.cuda.empty_cache()
    return out


def streamed_path(g, dc, outdir: str, ref: dict) -> dict:
    """The road shard's index served by ``StreamedCPDOracle`` at
    ``row_chunk=STREAM_ROW_CHUNK`` (the JAX default): a cold free-flow
    round (writes the sidecars), a new oracle's cold round (every chunk
    from its sidecar), a warm diff round (0 bytes), ``query_multi`` at
    D = 2, ``query_paths(k=8)`` and ``k_moves=8``, each equal to the road
    engine's resident answers; every chunk the cold round decoded equal
    to its raw rows; the decode past 2**31 cells; B1/K4 launches one a
    chunk and no plain walk."""
    tag = "[streamed]"
    t_phase = time.perf_counter()
    queries = ref["queries"]
    w_diff = g.weights_with_diff(ref["diff_path"])
    plain0 = (cw.cuda_walk_batch.plain, cw.cuda_walk_multi.plain)
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    with StreamProbe() as probe:
        st1 = streamed.StreamedCPDOracle(g, dc, outdir,
                                         row_chunk=STREAM_ROW_CHUNK)
        probe.name = "cold free-flow"
        cold = st1.query(queries)
        sidecars = sorted(f for f in os.listdir(outdir)
                          if f.startswith("rle-"))
        st2 = streamed.StreamedCPDOracle(g, dc, outdir,
                                         row_chunk=STREAM_ROW_CHUNK)
        got = {}
        for name, fn, a, kw in (
                ("sidecar free-flow", st2.query, (queries,), {}),
                ("warm diff", st2.query, (queries,), {"w_query": w_diff}),
                ("multi D=2", st2.query_multi, (queries, [None, w_diff]),
                 {}),
                ("paths k=8", st2.query_paths, (queries,), {"k": 8}),
                ("k_moves=8", st2.query, (queries,), {"k_moves": 8})):
            probe.name = name
            got[name] = fn(*a, **kw)
        launches = read_launches()[0]
        multi_launches = cw.cuda_walk_multi.launches
    peak = torch.cuda.max_memory_allocated()
    plain = (cw.cuda_walk_batch.plain - plain0[0],
             cw.cuda_walk_multi.plain - plain0[1])
    runs = {r["round"]: r for r in probe.runs}
    for run in probe.runs:
        log(round_line(tag, run))
    log(f"{tag} peak device memory over the rounds {peak / 2**30:.2f} GiB "
        f"(cache_bytes {st1.cache_bytes} B a oracle)")
    chunks = {name: r["stats"]["row_chunks"] for name, r in runs.items()}
    want_b1 = sum(chunks[k] for k in ("cold free-flow", "sidecar free-flow",
                                      "warm diff", "k_moves=8"))
    log(f"{tag} launches in the phase's run: walk {launches} (one a chunk "
        f"of each query round: {want_b1}), fused walk {multi_launches} "
        f"(one a chunk: {chunks['multi D=2']}), plain walks {plain}")
    if (launches != want_b1 or multi_launches != chunks["multi D=2"]
            or plain != (0, 0)):
        raise AssertionError(f"{tag} launches walk {launches} (want "
                             f"{want_b1}), fused {multi_launches} (want "
                             f"{chunks['multi D=2']}), plain {plain}")
    c0 = runs["cold free-flow"]["stats"]
    n_chunks = -(-dc.n_owned(WID) // STREAM_ROW_CHUNK)
    if (c0["mode"] != "range" or c0["row_chunks"] != n_chunks
            or c0["cache_misses"] != n_chunks or c0["sidecar_hits"]
            or len(sidecars) != n_chunks):
        raise AssertionError(f"{tag} cold round {c0}, sidecars {sidecars}")
    s0 = runs["sidecar free-flow"]["stats"]
    if (s0["sidecar_hits"] != n_chunks or s0["cache_misses"] != n_chunks
            or s0["bytes_streamed"] != c0["bytes_streamed"]):
        raise AssertionError(f"{tag} the new oracle's cold round did not "
                             f"read every chunk from its sidecar: {s0}")
    for name in ("warm diff", "multi D=2", "paths k=8", "k_moves=8"):
        st = runs[name]["stats"]
        if st["bytes_streamed"] or st["cache_hits"] != st["row_chunks"]:
            raise AssertionError(f"{tag} {name} streamed bytes: {st}")
    log(f"{tag} {len(sidecars)} sidecars written by the cold round, every "
        "one read by the new oracle's; the warm rounds streamed 0 bytes")
    ff, diff = ref["free-flow"], ref["diff"]
    same_answers(tag, "cold free-flow", cold, ff)
    same_answers(tag, "sidecar free-flow", got["sidecar free-flow"], ff)
    same_answers(tag, "warm diff", got["warm diff"], diff)
    m_cost, m_plen, m_fin = got["multi D=2"]
    same_answers(tag, "multi D=2 free flow", (m_cost[0], m_plen, m_fin), ff)
    same_answers(tag, "multi D=2 diff", (m_cost[1], m_plen, m_fin), diff)
    same_answers(tag, "paths k=8", got["paths k=8"], ref["paths"])
    same_answers(tag, "k_moves=8", got["k_moves=8"], ref["k8"])
    log(f"{tag} every round equals the road engine's resident answers "
        f"({len(queries)} queries each, paths included)")
    # each chunk the cold round decoded against its raw rows
    for key, fm_dev in st1._chunk_cache.items():
        raw = torch.from_numpy(np.array(st1._row_range(*key))).cuda()
        if not torch.equal(fm_dev, raw):
            raise AssertionError(f"{tag} decoded chunk {key} differs from "
                                 "its raw rows")
        del raw
    log(f"{tag} the cold round's {len(st1._chunk_cache)} decoded chunks "
        "equal their raw rows byte for byte")
    del st1, st2
    gc.collect()
    torch.cuda.empty_cache()
    call = probe.first_walk
    q = call[0][2].shape[0]
    call = (call[0], {**call[1], "valid": torch.ones(q, dtype=torch.bool,
                                                     device="cuda")})
    kernel = kernel_vs_plain("streamed chunk 0", call, f"{tag} kernel")
    st = streamed.StreamedCPDOracle(g, dc, outdir, row_chunk=STREAM_ROW_CHUNK,
                                    cache_bytes=0)
    decoders = decoder_times(tag, st, WID, 0)
    del st
    c2 = decode_past_2_31(tag)
    log(f"{tag} phase {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "multi_launches": multi_launches,
            "max_abs_err": kernel["max_abs_err"], "kernel": kernel,
            "rounds": probe.runs, "peak_bytes": peak, "decoders": decoders,
            "past_2_31": c2, "sidecars": len(sidecars)}


def read_parts_counts(path: str) -> list[dict]:
    """``parts.csv`` rows without the timers."""
    timers = ("t_receive", "t_astar", "t_search", "t_prepare", "t_partition")
    return [{k: v for k, v in row.items() if k not in timers}
            for row in read_parts(path)]


def streamed_campaign(outdir: str, ref: dict) -> dict:
    """``process_query -c conf`` under ``DOS_SERVE_STREAMED=1`` on the
    campaign's index: the conf's fused rounds (the default codecs: RLE
    encoded on the host), then ``-k 8 --extract`` with
    ``DOS_STREAM_RLE=0`` (chunks uploaded raw: the host RLE encode, ~47 s
    a cold run on the card's host, is paid once); ``parts.csv`` and
    ``paths.csv`` equal the resident campaign's."""
    tag = "[streamed-campaign]"
    conf = os.path.join(outdir, "conf.json")
    outs = (os.path.join(outdir, "out-streamed-rounds"),
            os.path.join(outdir, f"out-streamed-k{CAMPAIGN_K}"))
    plain0 = (cw.cuda_walk_batch.plain, cw.cuda_walk_multi.plain)
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    os.environ["DOS_SERVE_STREAMED"] = "1"
    try:
        with StreamProbe() as probe:
            t0 = time.perf_counter()
            rcs = [process_query.main(["-c", conf, "-o", outs[0]])]
            t1 = time.perf_counter()
            os.environ["DOS_STREAM_RLE"] = "0"
            try:
                rcs.append(process_query.main(
                    ["-c", conf, "-o", outs[1], "-k", str(CAMPAIGN_K),
                     "--extract"]))
            finally:
                del os.environ["DOS_STREAM_RLE"]
            t2 = time.perf_counter()
            launches = read_launches()[0]
            multi_launches = cw.cuda_walk_multi.launches
    finally:
        del os.environ["DOS_SERVE_STREAMED"]
    peak = torch.cuda.max_memory_allocated()
    plain = (cw.cuda_walk_batch.plain - plain0[0],
             cw.cuda_walk_multi.plain - plain0[1])
    for run in probe.runs:
        log(round_line(tag, run))
    log(f"{tag} process_query wall: rounds {t1 - t0:.3f} s, -k "
        f"{CAMPAIGN_K} --extract {t2 - t1:.3f} s; peak device memory "
        f"{peak / 2**30:.2f} GiB")
    if rcs != [0, 0]:
        raise AssertionError(f"{tag} exit codes {rcs}")
    want_b1 = sum(r["stats"]["row_chunks"] for r in probe.runs
                  if r["method"] == "query")
    want_k4 = sum(r["stats"]["row_chunks"] for r in probe.runs
                  if r["method"] == "query_multi")
    log(f"{tag} launches in the CLIs' runs: fused walk {multi_launches} "
        f"(one a chunk: {want_k4}), walk {launches} (one a chunk: "
        f"{want_b1}), plain walks {plain}; modes "
        f"{sorted({r['stats']['mode'] for r in probe.runs})}")
    if (launches, multi_launches, plain) != (want_b1, want_k4, (0, 0)) \
            or not want_b1 or not want_k4:
        raise AssertionError(f"{tag} launches walk {launches}, fused "
                             f"{multi_launches}, plain {plain}")
    for mine, theirs in ((outs[0], os.path.join(outdir, "out-rounds")),
                         (outs[1], os.path.dirname(ref["parts_k"]))):
        got = read_parts_counts(os.path.join(mine, "parts.csv"))
        want = read_parts_counts(os.path.join(theirs, "parts.csv"))
        if got != want:
            raise AssertionError(f"{tag} {mine}/parts.csv differs from the "
                                 "resident campaign's")
    with open(os.path.join(outs[1], "paths.csv"), "rb") as f:
        got = f.read()
    with open(ref["paths"], "rb") as f:
        if got != f.read():
            raise AssertionError(f"{tag} paths.csv differs from the "
                                 "resident campaign's")
    log(f"{tag} parts.csv of both runs (every column but the timers) and "
        "paths.csv equal the resident campaign's")
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "multi_launches": multi_launches,
            "rounds": probe.runs, "rounds_s": t1 - t0, "k_s": t2 - t1,
            "peak_bytes": peak}


# ------------------------------------------------------------- offline path

def part_counts(path: str) -> list[tuple[str, int, int, int]]:
    """``(expe, size, plen, finished)`` of each ``parts.csv`` row."""
    return [(r["expe"], int(r["size"]), int(r["plen"]), int(r["finished"]))
            for r in read_parts(path)]


def offline_path(outdir: str, ref: dict) -> tuple[dict, dict[str, int]]:
    """``offline.main`` on the campaign's ``.xy``/``.scen``/``.diff`` in
    ``OFFLINE_PARTS`` parts, on the card (a one-worker table over the
    whole graph built by K1/K2, never saved): each part's size, plen and
    finished equal the resident campaign's answers, one B1 launch a part
    and round. Then :func:`offline_local`. Returns the phase's entry and
    the build kernels' launches of its main run."""
    tag = "[offline]"
    t_phase = time.perf_counter()
    queries = ref["queries"]
    diffs = ["-", ref["diff_path"]]
    argv = ["-m", ref["xy"], "--scenario", ref["scen"], "-p",
            str(OFFLINE_PARTS), "--diffs", *diffs]
    out = os.path.join(outdir, "out-offline")
    plain0 = cw.cuda_walk_batch.plain
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    with KindProbe() as kinds:
        rc = offline_cli.main([*argv, "-o", out])
    torch.cuda.synchronize()
    launches = read_launches()[0]
    build_counts = check_build_launches("offline", tag)
    plain = cw.cuda_walk_batch.plain - plain0
    peak = torch.cuda.max_memory_allocated()
    kinds.check("offline", tag)
    with open(os.path.join(out, "metrics.json")) as f:
        metrics = json.load(f)
    log(f"{tag} offline.main: rc {rc}, {metrics['num_queries']} queries in "
        f"{metrics['num_partitions']} parts x {len(diffs)} rounds, "
        f"t_process {metrics['t_process']:.3f} s (the table built on the "
        f"card, then the rounds), peak device memory {peak / 2**30:.2f} "
        f"GiB; walk launches {launches}, plain walks {plain}")
    if rc or launches != OFFLINE_PARTS * len(diffs) or plain:
        raise AssertionError(f"{tag} rc {rc}, walk launches {launches}, "
                             f"plain {plain}")
    # each part's counts against the resident campaign's answers
    split = np.array_split(np.arange(len(queries)), OFFLINE_PARTS)
    want = []
    for expe, name in enumerate(("free-flow", "diff")):
        plen, fin = ref["answers"][name]
        want += [(str(expe), len(ix), int(plen[ix].sum()),
                  int(fin[ix].sum())) for ix in split]
    got = part_counts(os.path.join(out, "parts.csv"))
    if got != want:
        raise AssertionError(f"{tag} parts.csv {got} != the resident "
                             f"campaign's {want}")
    log(f"{tag} each part's size, plen and finished equal the resident "
        "campaign's answers in both rounds")
    gc.collect()
    torch.cuda.empty_cache()
    local = offline_local(outdir, tag)
    log(f"{tag} phase {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "local_launches": local["launches"],
            "t_process": metrics["t_process"], "peak_bytes": peak,
            "local": local}, build_counts


def offline_local(outdir: str, tag: str) -> dict:
    """``offline.main --local`` through a ``worker.server`` over its FIFO
    (the server in a thread of this process, on the card), on a road
    network of ``OFFLINE_LOCAL_NODES`` nodes written as files beside the
    campaign's: the server's one-worker index is built and saved by
    ``offline.LocalEngine``, and the ``--local`` run's counts must equal
    the in-process run's on the same files, one B1 launch a part and
    round in the server, and one an ``obs.device`` capture of a new
    program key."""
    d = os.path.join(outdir, "offline-local")
    os.makedirs(d, exist_ok=True)
    g0 = synth_road_network(OFFLINE_LOCAL_NODES, seed=SEED)
    xy, scen, diff = (os.path.join(d, f) for f in
                      ("road.xy", "road.scen", "road.diff"))
    write_xy(xy, g0.xs, g0.ys, g0.src, g0.dst, g0.w)
    g = Graph.from_xy(xy)
    write_scen(scen, make_queries(np.arange(g.n), g.n))
    write_diff(diff, *synth_diff(g, frac=0.1, seed=2))
    argv = ["-m", xy, "--scenario", scen, "-p", str(OFFLINE_PARTS),
            "--diffs", "-", diff]
    inproc = os.path.join(d, "out-inproc")
    if offline_cli.main([*argv, "-o", inproc]):
        raise AssertionError(f"{tag} the in-process run on the --local "
                             "files failed")
    index, nfs = os.path.join(d, "index"), os.path.join(d, "nfs")
    os.makedirs(nfs, exist_ok=True)
    t0 = time.perf_counter()
    offline_cli.LocalEngine(xy, outdir=index)
    build_s = time.perf_counter() - t0
    conf = ClusterConfig(workers=["localhost"], partmethod="tpu",
                         partkey=None, outdir=index, xy_file=xy,
                         nfs=nfs).validate()
    fifo = os.path.join(d, "offline.fifo")
    t0 = time.perf_counter()
    server = wserver.FifoServer(conf, 0, command_fifo=fifo, device="cuda")
    load_s = time.perf_counter() - t0
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    for _ in range(500):
        if os.path.exists(fifo):
            break
        time.sleep(0.02)
    real_answer = offline_cli.DEFAULT_ANSWER_FIFO
    offline_cli.DEFAULT_ANSWER_FIFO = os.path.join(d, "offline.answer")
    out = os.path.join(d, "out-local")
    plain0 = cw.cuda_walk_batch.plain
    programs0 = set(obs_device.snapshot())
    zero_launches()
    try:
        t0 = time.perf_counter()
        rc = offline_cli.main([*argv, "-o", out, "--local", "--fifo", fifo,
                               "--nfs", nfs])
        local_s = time.perf_counter() - t0
        launches = read_launches()[0]
        plain = cw.cuda_walk_batch.plain - plain0
        # the server engine's obs.device entry of each new program key:
        # one more launch, after the key's first batch
        captured = len(set(obs_device.snapshot()) - programs0)
    finally:
        offline_cli.DEFAULT_ANSWER_FIFO = real_answer
        stopped = wserver.stop_server(fifo)
        th.join(timeout=HOST_STOP_S)
    if th.is_alive() or not stopped:
        raise AssertionError(f"{tag} the FIFO server did not stop")
    got, want = (part_counts(os.path.join(x, "parts.csv"))
                 for x in (out, inproc))
    log(f"{tag} --local through a worker.server over its FIFO, on a "
        f"{g.n}-node road network: its one-worker index built and saved by "
        f"LocalEngine in {build_s:.3f} s, loaded by the server in "
        f"{load_s:.3f} s; rc {rc}, {len(got)} rows in {local_s:.3f} s; "
        f"walk launches in the server {launches} ({2 * OFFLINE_PARTS} "
        f"batches + {captured} obs.device captures), plain {plain}")
    if (rc or got != want or launches != 2 * OFFLINE_PARTS + captured
            or plain
            or sum(x[1] for x in got) != 2 * N_QUERIES):
        raise AssertionError(f"{tag} --local: rc {rc}, counts {got} != "
                             f"the in-process run's {want}, launches "
                             f"{launches}, plain {plain}")
    log(f"{tag} --local counts (size, plen, finished a part and round) "
        "equal the in-process run's on the same files")
    del server
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "build_s": build_s,
            "server_load_s": load_s, "local_s": local_s,
            "nodes": int(g.n)}


T_START = time.perf_counter()


def main() -> int:
    if sys.argv[1:2] == ["--multihost-worker"]:
        return multihost_worker(sys.argv[2:])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    try:
        kernels = run()
    except Exception:  # noqa: BLE001 — any failed phase fails the smoke
        traceback.print_exc()
        return 1
    log(f"[done] {time.perf_counter() - T_START:.1f} s on {card_line()}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
