"""Node→worker partitioning: the ``DistributionController``.

Role parity: the reference keeps its partition policy in a C++ header
(``src/util/distribution_controller.h``, reference ``README.md:31-34,75-80``)
exposed to Python only through the ``gen_distribute_conf`` binary, whose
stdout — a header line plus one ``node,wid,bid,bidx`` CSV row per node — is
parsed by the head (reference ``process_query.py:46-53``). Passing the same
``(partmethod, partkey, workerid, maxworker)`` quadruple to the CPD build,
the query servers, and the router is how build-time sharding and query-time
routing stay consistent.

Here the controller is a pure, vectorized Python function of
``(nodenum, maxworker, partmethod, partkey)`` — no subprocess hop. It is a
copy of the JAX package's controller, ``partmethod="tpu"`` included (the
contiguous node chunks the checked-in ``data/index`` was built with), so
both packages route every node to the same shard and row.

Partition semantics (executable spec: reference ``offline.py:50-63``;
README.md:31-33):

* ``div``:   ``wid = node // partkey``
* ``mod``:   ``wid = node %  partkey``
* ``alloc``: ``wid = first i such that partkey[i] > node`` (partkey is a list
             of ascending exclusive upper bounds, one per worker)
* ``tpu``:   ``wid = node // ceil(nodenum / maxworker)`` — contiguous chunks
             sized to the mesh (partkey ignored)

Block structure: each worker's owned nodes, in ascending order, are split
into blocks of ``block_size``; ``bid`` is the block id and ``bidx`` the index
within the block (the reference's CPD build emits one file per block:
``README.md:92``, and ``bid``/``bidx`` appear in ``gen_distribute_conf``
output). ``bid * block_size + bidx`` is the node's dense **owned index** —
its row in the worker's CPD shard.

Replication (``replication`` / ``DOS_REPLICATION``, default 1): replica
rank ``r`` of every node owned by worker ``w`` lives on worker
``(w + r) % maxworker`` — chained declustering, a pure function of the
primary partition table, so every head and worker derives the identical
replica map from the same quadruple with no extra coordination. Rank 0
is the primary; :meth:`DistributionController.replica_workers` is the
failover order the head walks when a primary is dead, and
:meth:`DistributionController.replica_shards` is the set of shards a
worker must hold rows for. ``replication=1`` is byte-for-byte today's
behavior everywhere (placement, wire format, artifacts).

Elastic membership (``epoch`` / ``owners``): the node→**shard** map
above is fixed at build time (shard count = ``maxworker``), but the
shard→**worker** assignment is versioned. ``owners[s]`` names the
worker currently hosting shard ``s`` (identity by default — shard s on
worker s, today's behavior byte-for-byte), and ``epoch`` is the
monotonically increasing version of that assignment, bumped atomically
by the reconfiguration controller (``parallel.membership``) whenever a
worker joins or leaves. Every routing surface (``replica_workers``,
``group_queries``'s dead-remap, the serving frontend's candidate sets)
maps shard ids through ``owners``, so a committed epoch bump flips
traffic without touching the partition quadruple or the on-disk block
files. ``format_conf`` appends ``epoch``/``owner`` columns only for
non-default assignments — legacy epoch-0 identity tables stay
byte-identical on the wire, and ``parse_conf`` reads the columns by
header name under the same unknown-column-tolerant compat contract as
the ``rep<r>`` columns.
"""

from __future__ import annotations

import numpy as np

DEFAULT_BLOCK_SIZE = 1 << 14

#: the replica bucket :meth:`DistributionController.group_queries`
#: returns queries under when EVERY replica of their target shard is in
#: the caller's dead set — the caller must shed these UNAVAILABLE
#: immediately instead of routing (or hanging on) a dead worker
UNROUTABLE = -1


class DistributionController:
    def __init__(self, partmethod: str, partkey, maxworker: int,
                 nodenum: int, block_size: int = DEFAULT_BLOCK_SIZE,
                 replication: int = 1, epoch: int = 0, owners=None):
        self.partmethod = partmethod
        self.partkey = partkey
        self.maxworker = int(maxworker)
        self.nodenum = int(nodenum)
        self.block_size = int(block_size)
        self.replication = int(replication)
        self.epoch = int(epoch)
        if self.maxworker <= 0:
            raise ValueError("maxworker must be positive")
        if not 1 <= self.replication <= self.maxworker:
            raise ValueError(
                f"replication {self.replication} not in [1, "
                f"maxworker={self.maxworker}]: every replica rank must "
                "land on a distinct worker")
        if self.epoch < 0:
            raise ValueError(f"epoch must be >= 0, got {self.epoch}")
        if owners is None:
            self.owners = np.arange(self.maxworker, dtype=np.int64)
        else:
            self.owners = np.asarray(owners, np.int64)
            if self.owners.shape != (self.maxworker,):
                raise ValueError(
                    f"owners must name one worker per shard "
                    f"(maxworker={self.maxworker}), got shape "
                    f"{self.owners.shape}")
            if self.nodenum and self.owners.min() < 0:
                raise ValueError("owners must be non-negative worker ids")
        #: identity assignment = the pre-elastic fleet, byte-for-byte
        self._identity_owners = bool(
            (self.owners == np.arange(self.maxworker)).all())
        self._wid = self._assign_all()
        # dense owned index per node: position within its owner's ascending
        # owned-node list. Vectorized: stable argsort by (wid, node).
        order = np.argsort(self._wid, kind="stable")
        owned_idx = np.empty(self.nodenum, np.int64)
        counts = np.bincount(self._wid, minlength=self.maxworker)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        owned_idx[order] = np.arange(self.nodenum) - np.repeat(starts, counts)
        self._owned_idx = owned_idx
        self._counts = counts

    # ------------------------------------------------------------ policy
    def _assign_all(self) -> np.ndarray:
        nodes = np.arange(self.nodenum, dtype=np.int64)
        m = self.partmethod
        if m == "div":
            wid = nodes // int(self.partkey)
        elif m == "mod":
            wid = nodes % int(self.partkey)
        elif m == "alloc":
            bounds = np.asarray(self.partkey, np.int64)
            if np.any(np.diff(bounds) <= 0):
                raise ValueError("alloc bounds must be strictly ascending")
            wid = np.searchsorted(bounds, nodes, side="right")
        elif m == "tpu":
            chunk = -(-self.nodenum // self.maxworker)  # ceil div
            wid = nodes // chunk
        else:
            raise ValueError(f"unknown partmethod {m!r}")
        if self.nodenum and (wid.min() < 0 or wid.max() >= self.maxworker):
            raise ValueError(
                f"partmethod={m} partkey={self.partkey} maps some node to "
                f"worker {int(wid.max())} but maxworker={self.maxworker}")
        return wid.astype(np.int64)

    # ------------------------------------------------------------ queries
    def worker_of(self, nodes) -> np.ndarray:
        """wid for each node (vectorized)."""
        return self._wid[np.asarray(nodes, np.int64)]

    def owned_index_of(self, nodes) -> np.ndarray:
        """Dense row index of each node within its owner's CPD shard."""
        return self._owned_idx[np.asarray(nodes, np.int64)]

    def owned(self, wid: int) -> np.ndarray:
        """Ascending node ids owned by ``wid``."""
        return np.nonzero(self._wid == wid)[0].astype(np.int64)

    def n_owned(self, wid: int) -> int:
        return int(self._counts[wid])

    @property
    def max_owned(self) -> int:
        """Largest shard size — the padded per-device row count in TPU mode."""
        return int(self._counts.max()) if self.nodenum else 0

    # ---------------------------------------------------------- replicas
    def owner_of(self, shard: int) -> int:
        """The worker currently hosting shard ``shard``'s primary rows
        (identity — shard s on worker s — unless a membership epoch
        reassigned it)."""
        return int(self.owners[int(shard)])

    def _chain_shards(self, wid: int) -> list[int]:
        """Shard ids in shard ``wid``'s replica chain, rank order."""
        return [(int(wid) + r) % self.maxworker
                for r in range(self.replication)]

    def replica_workers(self, wid: int) -> list[int]:
        """Workers hosting shard ``wid``'s rows, in failover order:
        rank 0 the shard's owner (worker ``wid`` itself under the
        identity assignment), rank r the owner of chain slot
        ``(wid + r) % maxworker``. Length == ``replication``."""
        if self._identity_owners:
            return self._chain_shards(wid)
        return [self.owner_of(s) for s in self._chain_shards(wid)]

    def replica_shards(self, wid: int) -> list[int]:
        """Shards worker ``wid`` hosts rows for: the shard(s) it owns
        (rank 0) plus the shard whose rank-r chain slot it owns. The
        inverse of :meth:`replica_workers` (identity assignment: its
        own shard plus ``(wid - r) % maxworker``)."""
        if self._identity_owners and int(wid) < self.maxworker:
            # the fast path only holds for in-range ids: a fresh
            # joiner (wid >= maxworker) hosts nothing under identity —
            # the modulo would wrongly claim another worker's shard
            return [(int(wid) - r) % self.maxworker
                    for r in range(self.replication)]
        out = []
        for shard in range(self.maxworker):
            if int(wid) in self.replica_workers(shard):
                out.append(shard)
        return out

    def replica_rank(self, shard: int, host: int) -> int:
        """The replica rank with which worker ``host`` holds ``shard``'s
        rows (0 = primary/owner). Raises ``ValueError`` when ``host`` is
        not in the shard's replica set."""
        if self._identity_owners and int(host) < self.maxworker:
            r = (int(host) - int(shard)) % self.maxworker
            if r >= self.replication:
                raise ValueError(
                    f"worker {host} holds no replica of shard {shard} "
                    f"(replication={self.replication})")
            return r
        hosts = self.replica_workers(shard)
        if int(host) not in hosts:
            raise ValueError(
                f"worker {host} holds no replica of shard {shard} "
                f"(hosts: {hosts})")
        return hosts.index(int(host))

    def table(self) -> np.ndarray:
        """int64 [N, 4] rows of (node, wid, bid, bidx) — the
        ``gen_distribute_conf`` payload."""
        nodes = np.arange(self.nodenum, dtype=np.int64)
        bid = self._owned_idx // self.block_size
        bidx = self._owned_idx % self.block_size
        return np.stack([nodes, self._wid, bid, bidx], axis=1)

    def replica_table(self) -> np.ndarray:
        """int64 [N, replication-1]: column r-1 is the worker hosting
        replica rank r of each node. Empty (0 columns) at R=1."""
        cols = [self.owners[(self._wid + r) % self.maxworker]
                for r in range(1, self.replication)]
        if not cols:
            return np.zeros((self.nodenum, 0), np.int64)
        return np.stack(cols, axis=1)

    def format_conf(self) -> str:
        """The wire format the reference head parses: one header line,
        then ``node,wid,bid,bidx`` per node (reference
        ``process_query.py:50-53``). With replication, ``rep<r>`` columns
        (the rank-r replica's worker) append on the right; an elastic
        table (``epoch > 0`` or a non-identity assignment) additionally
        appends ``epoch`` (the table's version, constant per row) and
        ``owner`` (the worker hosting the node's shard) columns — same
        compat contract as the wire codecs: readers take columns by
        header name and tolerate unknown ones, so an R=1 consumer
        reading the first four columns of an elastic table still routes
        on the primary shard, and epoch-0 identity R=1 output is
        byte-identical to the legacy format."""
        rows = self.table()
        rep = self.replica_table()
        elastic = self.epoch > 0 or not self._identity_owners
        header = "node,wid,bid,bidx" + "".join(
            f",rep{r}" for r in range(1, self.replication))
        if elastic:
            header += ",epoch,owner"
        lines = [header]
        if elastic:
            own = self.owners[self._wid]
            lines += [",".join(map(str, [*row, *reps, self.epoch, o]))
                      for row, reps, o in zip(rows, rep, own)]
        else:
            lines += [",".join(map(str, [*row, *reps]))
                      for row, reps in zip(rows, rep)]
        return "\n".join(lines)

    # ------------------------------------------------------------ routing
    def group_queries(self, queries: np.ndarray, active_worker: int = -1,
                      dead=()):
        """Group (s, t) queries by the worker owning the **target** node — the
        system invariant (reference ``process_query.py:56-57``).

        Returns ``{wid: int64 [q, 2] array}`` with empty groups omitted, like
        the reference's parts list skips empty workers
        (``process_query.py:62``). ``active_worker`` restricts to one worker
        (the ``-w`` flag), -1 = all.

        ``dead``: worker ids known down. Each query routes to the FIRST
        live worker in its target shard's replica chain
        (:meth:`replica_workers`); queries whose every replica is dead
        come back under the :data:`UNROUTABLE` key so the caller can
        shed them immediately instead of hanging on a dead worker. With
        ``dead`` empty (the default) routing is identical to the
        pre-replication behavior regardless of ``replication``.
        """
        queries = np.asarray(queries, np.int64)
        wids = self.worker_of(queries[:, 1])
        dead = set(int(d) for d in dead)
        if dead:
            # remap each primary wid to its first live replica host
            # (UNROUTABLE when the whole chain is dead) — one pass over
            # the W shard ids, then a vectorized gather
            remap = np.empty(self.maxworker, np.int64)
            for shard in range(self.maxworker):
                remap[shard] = next(
                    (h for h in self.replica_workers(shard)
                     if h not in dead), UNROUTABLE)
            wids = remap[wids]
        groups = {}
        # bucket over the ids actually PRESENT (ascending, UNROUTABLE
        # first — np.unique sorts, so iteration order matches the old
        # range(maxworker) walk exactly): a dead-remap through an
        # elastic owner table can name a joined worker past maxworker,
        # and a fixed range would silently drop its queries
        for wid in (int(w) for w in np.unique(wids)):
            if active_worker != -1 and wid != active_worker \
                    and wid != UNROUTABLE:
                continue
            groups[wid] = queries[wids == wid]
        return groups


def parse_conf(text: str) -> dict:
    """Parse :meth:`DistributionController.format_conf` output back into
    arrays — the consumer half of the ``gen_distribute_conf`` wire.

    Columns are taken BY HEADER NAME with unknown columns tolerated
    (the wire codecs' compat contract): a legacy R=1 table (no ``rep*``
    columns) parses with ``replication == 1``, an R>1 table parsed by
    old code that only reads the first four columns still routes on the
    primary, and future columns cannot break this parser. Elastic
    tables add ``epoch`` (constant table version; an epoch-less legacy
    conf parses as epoch 0) and ``owner`` (the worker hosting each
    node's shard; absent = the shard id itself) columns.

    Returns ``{"node", "wid", "bid", "bidx", "owner": int64 [N];
    "replicas": int64 [N, R-1]; "replication": R; "epoch": int}``.
    """
    lines = [ln for ln in text.strip().split("\n") if ln.strip()]
    if not lines:
        raise ValueError("empty distribute conf")
    header = [h.strip() for h in lines[0].split(",")]
    for required in ("node", "wid", "bid", "bidx"):
        if required not in header:
            raise ValueError(
                f"distribute conf header is missing {required!r}: "
                f"{lines[0]!r}")
    rep_cols = sorted(
        (h for h in header if h.startswith("rep") and h[3:].isdigit()),
        key=lambda h: int(h[3:]))
    ranks = [int(h[3:]) for h in rep_cols]
    if ranks != list(range(1, len(ranks) + 1)):
        raise ValueError(f"replica columns are not ranks 1..R-1: "
                         f"{rep_cols}")
    idx = {h: i for i, h in enumerate(header)}
    parsed = []
    for ln in lines[1:]:
        vals = ln.split(",")
        if len(vals) < len(header):
            raise ValueError(f"row has {len(vals)} columns, header "
                             f"names {len(header)}: {ln!r}")
        parsed.append([int(v) for v in vals[:len(header)]])
    rows = np.asarray(parsed, np.int64).reshape(len(lines) - 1,
                                                len(header))
    out = {k: rows[:, idx[k]] for k in ("node", "wid", "bid", "bidx")}
    out["replicas"] = (rows[:, [idx[c] for c in rep_cols]]
                       if rep_cols
                       else np.zeros((len(rows), 0), np.int64))
    out["replication"] = len(rep_cols) + 1
    if "epoch" in idx:
        epochs = np.unique(rows[:, idx["epoch"]])
        if len(epochs) > 1:
            raise ValueError(
                f"distribute conf mixes epochs {epochs.tolist()} — a "
                "table is one atomic assignment version")
        out["epoch"] = int(epochs[0]) if len(epochs) else 0
    else:
        out["epoch"] = 0          # legacy epoch-less conf
    out["owner"] = (rows[:, idx["owner"]] if "owner" in idx
                    else out["wid"].copy())
    return out
