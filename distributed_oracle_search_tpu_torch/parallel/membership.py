"""Elastic fleet membership: the reconfiguration controller.

A copy of the JAX package's ``parallel/membership.py``: the same
``membership.json`` bytes, plans, journal and fault point
(``kill-during-reshard``), so either package's heads, workers and
frontends read the other's state. The one difference is where a
catch-up heals: :class:`MembershipController` takes a ``device``
(None → ``cuda``, raising without a GPU unless ``"cpu"``), and a
missing or corrupt block of an adopted shard is rebuilt there through
``models.cpd.heal_block`` — on the card by the build kernels (K1/K2).

The partition quadruple fixes the node→**shard** map at build time
(``parallel.partition``); this module makes the shard→**worker**
assignment a first-class, versioned, observable state machine instead
of a frozen conf file. One durable artifact — ``membership.json`` in
the index directory, written atomically (``utils.atomicio``) — holds
the fleet's current **epoch** (monotonically increasing assignment
version), the worker roster, the shard→owner table, and (while a
reconfiguration is in flight) the migration record. Every head, worker,
and serving frontend derives its routing from the same file, and the
epoch rides the wire (``RuntimeConfig.epoch``) so a worker can refuse a
request routed under a NEWER table than it has seen — the codecs'
version-gate contract (tolerate older, gate only on newer) applied to
routing state.

A reconfiguration is a three-step state machine, crash-resumable at
every step because each step is one atomic ``membership.json`` write:

1. **begin** — the migration record (which shards move where, target
   epoch) lands in the state file. Routing does not change yet: the
   migration opens the **dual-read window**, during which the campaign
   head and the serving frontend route a moving shard's reads to BOTH
   candidate owners via the replica failover chain — the OLD owner
   first (authoritative), the adopter next — so no query is shed while
   ownership is in flight.
2. **catch_up** — the adopter materializes each moving shard's rows by
   digest-verifying the on-disk block set and healing anything bad
   through the shared copy/heal path (``models.cpd.adopt_shard_blocks``
   → ``heal_block``: copy from a digest-valid replica set, recompute
   from the graph as a last resort). Progress is journaled per shard
   into the migration record (and the underlying heal path journals
   per block into the build ledgers), so a controller killed mid
   catch-up resumes exactly where it died — the ``kill-during-reshard``
   fault point lives between shard moves.
3. **commit** — one atomic write updates the owner table, bumps the
   epoch, and clears the migration record. Routing flips the instant
   the rename lands; a worker that has not re-read the file yet simply
   keeps serving (older epochs are always served) until a newer-epoch
   request prompts it to refresh.

**Join** moves a balanced slice of shards onto the new worker; **leave**
is the inverse — every shard the leaver owns transfers to the next live
host in its replica chain first (a worker that already holds the rows),
falling back to round-robin over the remaining roster, after which the
leaver drains and exits 0 (``WorkerSupervisor.remove_worker``).

Env knobs (``utils.env`` policy): ``DOS_MEMBERSHIP_VERIFY`` (default
on — re-verify every moved shard's block digests immediately before
commit; off trusts the catch-up journal), ``DOS_MEMBERSHIP_MAX_MOVES``
(cap shards moved by one join rebalance; 0 = balanced share).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np

from ..obs import metrics as obs_metrics
from ..testing import faults
from ..utils.atomicio import atomic_write_json
from ..utils.env import env_cast, env_flag
from ..utils.log import get_logger
from ..utils.timer import Timer
from .partition import DistributionController

log = get_logger(__name__)

#: the durable assignment artifact, next to ``index.json``
STATE_FILE = "membership.json"

#: membership.json schema version — same compat contract as the index
#: manifest: unknown keys tolerated, only NEWER versions rejected
MEMBERSHIP_VERSION = 1

G_EPOCH = obs_metrics.gauge(
    "reshard_epoch",
    "committed partition-table epoch (0 = the static pre-elastic fleet)")
M_MIGRATIONS = obs_metrics.counter(
    "reshard_migrations_total",
    "reconfigurations begun (join + leave; commits and aborts both "
    "start here)")
M_SHARDS_MOVED = obs_metrics.counter(
    "reshard_shards_moved_total",
    "shard ownership transfers committed by epoch bumps")
M_ABORTED = obs_metrics.counter(
    "reshard_aborted_total",
    "migration windows explicitly aborted (owner table unchanged)")
M_LEAVE_REFUSED = obs_metrics.counter(
    "reshard_leave_refused_total",
    "leave plans refused because a shard had no live replica-chain "
    "adopter (R=1 sole owner) — refusing beats stranding it mid-window")
H_CATCHUP = obs_metrics.histogram(
    "reshard_catchup_seconds",
    "per-shard adopter catch-up: digest-verify + heal/copy of one "
    "moving shard's block set")


@dataclasses.dataclass
class Migration:
    """One in-flight reconfiguration (the dual-read window record)."""

    epoch: int                       # epoch this migration commits
    kind: str                        # "join" | "leave"
    worker: int                      # joining/leaving worker id
    #: ownership transfers: ``[shard, from_worker, to_worker]`` rows
    moves: list = dataclasses.field(default_factory=list)
    #: shards whose adopter catch-up is journaled complete
    done: list = dataclasses.field(default_factory=list)
    #: join only: the joiner's ssh host, recorded by the plan so
    #: ``begin`` rosters the host the plan was made for (an explicit
    #: ``begin(host=...)`` still wins)
    host: str | None = None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Migration":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    def target_of(self, shard: int) -> int | None:
        for s, _frm, to in self.moves:
            if s == shard:
                return int(to)
        return None


@dataclasses.dataclass
class MembershipState:
    """The durable content of ``membership.json``.

    Same compat contract as the wire codecs and the index manifest:
    ``from_dict`` filters unknown keys (future fields cannot break this
    reader), and only a file whose ``version`` is NEWER than this code
    rejects — it may have changed the meaning of keys we would silently
    misread into wrong routing."""

    epoch: int = 0
    workers: list = dataclasses.field(default_factory=list)
    owners: list = dataclasses.field(default_factory=list)
    migration: dict | None = None
    version: int = MEMBERSHIP_VERSION

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        if d["migration"] is None:
            del d["migration"]
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "MembershipState":
        version = int(d.get("version", 1))
        if version > MEMBERSHIP_VERSION:
            raise ValueError(
                f"membership state has schema v{version}; this build "
                f"reads up to v{MEMBERSHIP_VERSION} — upgrade the "
                "serving code (unknown keys are tolerated, newer major "
                "versions are not)")
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    @property
    def live_migration(self) -> Migration | None:
        return (Migration.from_dict(self.migration)
                if self.migration else None)


def state_path(outdir: str) -> str:
    return os.path.join(outdir, STATE_FILE)


def load_state(outdir: str) -> MembershipState | None:
    """The on-disk assignment, or None for a static (pre-elastic)
    fleet. The file is only ever written atomically, so a readable file
    is a complete one; an unparsable file raises — serving under a
    routing table we cannot read is worse than failing loudly."""
    path = state_path(outdir)
    try:
        with open(path) as f:
            raw = json.load(f)
    except FileNotFoundError:
        return None
    except (OSError, ValueError) as e:
        raise ValueError(f"unreadable membership state {path}: {e}")
    return MembershipState.from_dict(raw)


def save_state(outdir: str, state: MembershipState) -> None:
    atomic_write_json(state_path(outdir), state.to_dict())


def current_epoch(outdir: str) -> int:
    """The committed epoch (0 when no membership state exists)."""
    state = load_state(outdir)
    return state.epoch if state is not None else 0


def apply_state(dc: DistributionController,
                state: MembershipState | None) -> DistributionController:
    """A controller carrying ``state``'s epoch + owner assignment (the
    same partition quadruple — node→shard routing never changes)."""
    if state is None:
        return dc
    owners = (np.asarray(state.owners, np.int64) if state.owners
              else None)
    return DistributionController(
        dc.partmethod, dc.partkey, dc.maxworker, dc.nodenum,
        block_size=dc.block_size, replication=dc.replication,
        epoch=state.epoch, owners=owners)


def route_candidates(state: MembershipState | None,
                     dc: DistributionController, shard: int) -> list[int]:
    """The worker ids to try for ``shard``'s batch, failover order.

    Steady state: the shard's replica chain (owner first). During a
    migration window that moves this shard: the OLD owner stays
    authoritative (first), the adopter rides second — the dual-read
    rule — and the replica chain follows, deduped. No query is shed
    during handoff: the chain is walked by ``send_failover`` exactly
    like a replica chain, because it is one."""
    chain = list(dc.replica_workers(shard))
    mig = state.live_migration if state is not None else None
    if mig is not None:
        target = mig.target_of(int(shard))
        if target is not None and target not in chain[:1]:
            chain = [chain[0], target] + chain[1:]
    out: list[int] = []
    for c in chain:
        if c not in out:
            out.append(int(c))
    return out


def hosted_shards(state: MembershipState | None,
                  dc: DistributionController, wid: int) -> set[int]:
    """Every shard worker ``wid`` may legitimately answer batches for:
    its owned/replica chain slots, plus any shard it is mid-adopting
    (the dual-read window routes reads there before the epoch
    commits)."""
    out = {int(s) for s in dc.replica_shards(wid)}
    mig = state.live_migration if state is not None else None
    if mig is not None:
        out |= {int(s) for s, _frm, to in mig.moves if int(to) == wid}
    return out


class MembershipController:
    """Drives join/leave reconfigurations over one index directory.

    The controller is head-side tooling: it plans the ownership
    transfers, opens the dual-read window, runs (or resumes) the
    adopter catch-up, and commits the epoch bump. Workers and serving
    frontends only ever READ the state file."""

    def __init__(self, conf, dc: DistributionController,
                 outdir: str | None = None, graph=None, device=None):
        self.conf = conf
        #: where a catch-up heals a block (``models.cpd.heal_block``)
        self.device = device
        self.outdir = outdir if outdir is not None else conf.outdir
        self._graph = graph
        state = load_state(self.outdir)
        if state is None:
            state = MembershipState(
                epoch=dc.epoch, workers=list(conf.workers),
                owners=[dc.owner_of(s) for s in range(dc.maxworker)])
        self.base_dc = dc
        self.state = state
        #: bumped at every state mutation point; dc_view snapshots it
        #: so a concurrent reader can never pin a stale controller past
        #: the next call (a plain None sentinel could be re-populated
        #: from pre-mutation state AFTER the mutator cleared it)
        self._state_gen = 0
        self._dc_cache: tuple | None = None     # (gen, controller)
        self._last_refresh = time.monotonic()
        G_EPOCH.set(state.epoch)

    #: how stale a SERVING process's view of membership.json may get —
    #: the dual-read window makes a commit visible lag harmless (old
    #: routing keeps working), so a coarse re-read bound suffices
    REFRESH_INTERVAL_S = 1.0

    # ----------------------------------------------------------- views
    @property
    def epoch(self) -> int:
        return self.state.epoch

    def dc_view(self) -> DistributionController:
        """A controller reflecting the current committed assignment.
        Cached per state generation (every mutation point bumps
        ``_state_gen``) — the serving admission hot path asks for this
        per request, and rebuilding a controller re-runs the O(N)
        node-assignment over the whole graph. The generation is read
        BEFORE the state: a racing mutator at worst leaves one stale
        entry that the next call's generation mismatch recomputes."""
        gen = self._state_gen
        cache = self._dc_cache
        if cache is None or cache[0] != gen:
            cache = (gen, apply_state(self.base_dc, self.state))
            self._dc_cache = cache
        return cache[1]

    def _invalidate_dc(self) -> None:
        """Every state mutation point comes through here: the bumped
        generation is what makes the dc_view cache safe against the
        reader-preempted-across-a-mutation race the ctor describes."""
        self._state_gen += 1
        self._dc_cache = None

    def refresh(self) -> MembershipState:
        """Re-read the durable state (another controller process may
        have committed since). An OLDER epoch never applies — epochs
        are monotone, so a lagging read (NFS attribute cache, an
        operator restoring a stale file) must not roll routing back to
        a drained owner; same-epoch content still applies (``begin``
        opens the window without a bump). The worker side
        (``FifoServer._refresh_membership``) enforces the same rule."""
        self._last_refresh = time.monotonic()
        state = load_state(self.outdir)
        if state is not None:
            if state.epoch < self.state.epoch:
                log.warning(
                    "membership refresh read epoch %d behind the "
                    "current %d; ignoring the stale state",
                    state.epoch, self.state.epoch)
                return self.state
            if state.to_dict() == self.state.to_dict():
                # unchanged (steady state, once per refresh interval):
                # keep the dc_view cache — invalidating would re-run
                # the O(N) node assignment on the admission hot path
                return self.state
            self.state = state
            self._invalidate_dc()
            G_EPOCH.set(state.epoch)
        return self.state

    def _maybe_refresh(self) -> None:
        """Throttled :meth:`refresh` for read paths: a serving frontend
        holding this controller must observe commits made by OTHER
        processes (the campaign-style re-read, amortized), without
        paying a file read per batch."""
        if time.monotonic() - self._last_refresh >= \
                self.REFRESH_INTERVAL_S:
            try:
                self.refresh()
            except ValueError as e:
                log.error("membership refresh failed: %s (keeping "
                          "the current table)", e)

    def candidates_for(self, shard: int) -> list[int]:
        self._maybe_refresh()
        return route_candidates(self.state, self.dc_view(), shard)

    def host_of(self, via: int) -> str:
        """ssh host of worker ``via`` from the LIVE roster — a joined
        worker's id is past the static conf's list, and a FIFO
        dispatcher must still be able to name its host."""
        ws = self.state.workers or list(self.conf.workers)
        return ws[via] if via < len(ws) else ws[via % len(ws)]

    def statusz(self) -> dict:
        """The ``/statusz`` section: epoch, roster, owner table, and —
        during a window — the migration record."""
        out = {
            "epoch": self.state.epoch,
            "workers": list(self.state.workers),
            "owners": [int(o) for o in self.state.owners],
        }
        mig = self.state.live_migration
        if mig is not None:
            out["migration"] = mig.to_dict()
        return out

    def graph(self):
        if self._graph is None:
            from ..data.graph import Graph

            self._graph = Graph.from_xy(self.conf.xy_file)
        return self._graph

    # -------------------------------------------------------- planning
    def _owners(self) -> list[int]:
        dc = self.base_dc
        return ([int(o) for o in self.state.owners] if self.state.owners
                else [dc.owner_of(s) for s in range(dc.maxworker)])

    def plan_join(self, host: str) -> Migration:
        """Rebalance onto a new worker: it receives its balanced share
        of shards (``W // (live_owners + 1)``, at least 1), taken from
        the most-loaded current owners first (deterministic: stable by
        shard id). The divisor counts workers that OWN shards, not
        roster slots — roster entries are positional and never pruned
        on leave, so a departed worker must not dilute the share.
        ``DOS_MEMBERSHIP_MAX_MOVES`` caps the transfer."""
        owners = self._owners()
        w = len(owners)
        new_wid = len(self.state.workers)
        share = max(1, w // (len(set(owners)) + 1))
        cap = env_cast("DOS_MEMBERSHIP_MAX_MOVES", 0, int)
        if cap > 0:
            share = min(share, cap)
        load: dict[int, list[int]] = {}
        for shard, owner in enumerate(owners):
            load.setdefault(owner, []).append(shard)
        moves: list[list[int]] = []
        while len(moves) < share:
            donor = max(load, key=lambda o: (len(load[o]), -o))
            if len(load[donor]) <= 1 and len(moves):
                break           # never strip a worker bare mid-join
            shard = load[donor].pop(0)
            moves.append([shard, donor, new_wid])
        return Migration(epoch=self.state.epoch + 1, kind="join",
                         worker=new_wid, moves=moves, host=host)

    def plan_leave(self, wid: int, live=None) -> Migration:
        """Transfer every shard ``wid`` owns before it drains:
        ownership goes to the next host in the shard's replica chain
        that is not the leaver (a worker already holding the rows — the
        cheapest adopter), falling back to round-robin over the workers
        that still OWN shards when the whole chain is the leaver. The
        fallback pool is ownership-derived, not the roster: roster
        entries are never pruned on leave (worker ids are positional),
        so a previously-departed worker still has a roster slot — and
        committing a shard onto a drained host would make it
        permanently unroutable.

        ``live`` (optional set of worker ids known to be serving)
        restricts adopters: the control daemon removing a dead worker
        must not move its shards onto another sick one. When filtering
        leaves a shard with NO adopter at all (R=1 sole owner and no
        live peer owns anything), the plan **refuses** — a per-shard
        diagnostic plus ``reshard_leave_refused_total`` — instead of
        opening a dual-read window that could never drain. ``live=None``
        preserves the pre-control behavior bit-for-bit."""
        owners = self._owners()
        dc = self.dc_view()
        remaining = sorted(set(owners) - {int(wid)})
        if live is not None:
            live = {int(w) for w in live}
            remaining = [w for w in remaining if w in live]
        if not remaining:
            if live is not None:
                M_LEAVE_REFUSED.inc()
            raise ValueError("cannot remove the last shard-owning "
                             "worker")
        moves: list[list[int]] = []
        stranded: list[str] = []
        rr = 0
        for shard, owner in enumerate(owners):
            if owner != int(wid):
                continue
            chain = [h for h in dc.replica_workers(shard)
                     if h != int(wid)]
            if live is not None:
                # the leaver is presumed dead: the adopter must ALREADY
                # hold the rows (be a live replica-chain host) because
                # catch-up cannot copy from a corpse. Round-robin onto
                # a non-replica is only safe on the legacy live=None
                # path, where the leaver itself serves the catch-up.
                alive_chain = [h for h in chain if h in live]
                if not alive_chain:
                    stranded.append(
                        f"shard {shard}: replica chain {chain or '[]'} "
                        f"has no live host (sole owner at R="
                        f"{int(dc.replication)})")
                    continue
                moves.append([shard, owner, int(alive_chain[0])])
                continue
            target = next(iter(chain), None)
            if target is None:
                target = remaining[rr % len(remaining)]
                rr += 1
            moves.append([shard, owner, int(target)])
        if stranded:
            M_LEAVE_REFUSED.inc()
            raise ValueError(
                f"refusing leave of worker {int(wid)}: "
                + "; ".join(stranded))
        return Migration(epoch=self.state.epoch + 1, kind="leave",
                         worker=int(wid), moves=moves)

    # --------------------------------------------------- state machine
    def begin(self, migration: Migration, host: str | None = None
              ) -> Migration:
        """Open the dual-read window: persist the migration record (one
        atomic write). A join also extends the roster so routing can
        name the new worker; ownership does NOT change yet."""
        if self.state.migration is not None:
            raise ValueError(
                "a migration is already in flight "
                f"(target epoch {self.state.live_migration.epoch}); "
                "resume or abort it first")
        if migration.epoch != self.state.epoch + 1:
            raise ValueError(
                f"migration targets epoch {migration.epoch}, current "
                f"is {self.state.epoch} — plans do not skip epochs")
        if migration.kind == "join":
            if host is None:
                host = migration.host
            self.state.workers = list(self.state.workers) + [
                host if host is not None else f"worker:{migration.worker}"]
        self.state.owners = self._owners()
        self.state.migration = migration.to_dict()
        self._invalidate_dc()
        save_state(self.outdir, self.state)
        M_MIGRATIONS.inc()
        log.info("membership: %s of worker %d begun (epoch %d -> %d, "
                 "%d shard move(s))", migration.kind, migration.worker,
                 self.state.epoch, migration.epoch, len(migration.moves))
        return migration

    def catch_up(self, migration: Migration | None = None) -> Migration:
        """Adopter catch-up, resumable: every move not yet journaled
        ``done`` digest-verifies (and heals) the shard's block set,
        then the journal line lands in one atomic state write. The
        ``kill-during-reshard`` fault point fires between shard moves —
        a controller killed here resumes with the journal intact."""
        from ..models.cpd import adopt_shard_blocks

        mig = (migration if migration is not None
               else self.state.live_migration)
        if mig is None:
            raise ValueError("no migration in flight to catch up")
        dc = self.dc_view()
        for shard, _frm, to in mig.moves:
            if shard in mig.done:
                continue
            with Timer() as t:
                report = adopt_shard_blocks(self.graph(), dc, int(shard),
                                            self.outdir,
                                            device=self.device)
            H_CATCHUP.observe(t.interval)
            log.info("membership: worker %d caught up shard %d "
                     "(%d block(s), %d healed, %.3fs)", to, shard,
                     report["blocks"], len(report["healed"]), t.interval)
            mig.done.append(int(shard))
            self.state.migration = mig.to_dict()
            save_state(self.outdir, self.state)
            rule = faults.inject("kill-during-reshard")
            if rule is not None:
                log.error("fault: dying between reshard catch-up moves")
                if rule.mode == "exit":
                    os._exit(faults.KILL_EXIT_CODE)
                raise RuntimeError("kill-during-reshard fault injected")
        return mig

    def commit(self, migration: Migration | None = None
               ) -> MembershipState:
        """The epoch bump: one atomic ``membership.json`` write flips
        ownership and closes the window. Refuses while any move's
        catch-up is unjournaled; ``DOS_MEMBERSHIP_VERIFY=1`` (default)
        additionally re-checks every moved shard's block digests right
        before the flip — an adopter that rotted between catch-up and
        commit must not take ownership of rows it cannot serve."""
        mig = (migration if migration is not None
               else self.state.live_migration)
        if mig is None:
            raise ValueError("no migration in flight to commit")
        pending = [s for s, _f, _t in mig.moves if s not in mig.done]
        if pending:
            raise ValueError(
                f"cannot commit epoch {mig.epoch}: shards {pending} "
                "have not finished adopter catch-up")
        if env_flag("DOS_MEMBERSHIP_VERIFY", True):
            self._verify_moves(mig)
        owners = self._owners()
        for shard, _frm, to in mig.moves:
            owners[int(shard)] = int(to)
        self.state.owners = owners
        self.state.epoch = mig.epoch
        self.state.migration = None
        self._invalidate_dc()
        save_state(self.outdir, self.state)
        M_SHARDS_MOVED.inc(len(mig.moves))
        G_EPOCH.set(self.state.epoch)
        log.info("membership: epoch %d committed (%s of worker %d, %d "
                 "shard move(s))", self.state.epoch, mig.kind,
                 mig.worker, len(mig.moves))
        return self.state

    def _verify_moves(self, mig: Migration) -> None:
        from ..models.cpd import (
            check_block, read_manifest, shard_block_name,
        )

        try:
            manifest = read_manifest(self.outdir)
        except (OSError, ValueError):
            manifest = None
        blocks_meta = (manifest or {}).get("blocks", {})
        dc = self.base_dc
        bad = []
        for shard, _frm, _to in mig.moves:
            n_blocks = (dc.n_owned(int(shard)) + dc.block_size - 1
                        ) // dc.block_size
            for bid in range(n_blocks):
                fname = shard_block_name(int(shard), bid)
                status, reason = check_block(
                    os.path.join(self.outdir, fname),
                    blocks_meta.get(fname))
                if status not in ("ok", "unverified"):
                    bad.append((fname, status, reason))
        if bad:
            raise ValueError(
                f"pre-commit verify failed for epoch {mig.epoch}: "
                + "; ".join(f"{f} is {s} ({r})" for f, s, r in bad))

    def abort(self, migration: Migration | None = None
              ) -> MembershipState:
        """Close the window without the bump: ownership unchanged, the
        migration record cleared (and, for a join, the provisional
        roster entry dropped). Adopted blocks stay on disk — they are
        digest-valid copies of rows the fleet already serves, and the
        next begin/catch-up reuses them for free."""
        mig = (migration if migration is not None
               else self.state.live_migration)
        if mig is None:
            raise ValueError("no migration in flight to abort")
        if (mig.kind == "join"
                and mig.worker == len(self.state.workers) - 1):
            self.state.workers = list(self.state.workers)[:-1]
        self.state.migration = None
        self._invalidate_dc()
        save_state(self.outdir, self.state)
        M_ABORTED.inc()
        log.warning("membership: %s of worker %d aborted (epoch stays "
                    "%d)", mig.kind, mig.worker, self.state.epoch)
        return self.state

    # ----------------------------------------------------- convenience
    def join(self, host: str) -> MembershipState:
        """Plan + begin + catch up + commit one worker join."""
        mig = self.begin(self.plan_join(host))
        self.catch_up(mig)
        return self.commit(mig)

    def leave(self, wid: int, live=None) -> MembershipState:
        """Plan + begin + catch up + commit one worker leave. The
        caller drains the worker AFTER the commit (its shards have new
        owners by then; in-flight batches it already read are answered
        before the stop token wins — drain-free by construction).
        ``live`` restricts adopters to known-serving workers (see
        :meth:`plan_leave`)."""
        mig = self.begin(self.plan_leave(wid, live=live))
        self.catch_up(mig)
        return self.commit(mig)

    def resume(self) -> MembershipState | None:
        """Finish a migration a crashed controller left in flight
        (catch-up journal intact → only the missing tail re-runs).
        Returns the committed state, or None when nothing was in
        flight."""
        mig = self.state.live_migration
        if mig is None:
            return None
        log.info("membership: resuming %s of worker %d toward epoch %d "
                 "(%d/%d shard(s) already caught up)", mig.kind,
                 mig.worker, mig.epoch, len(mig.done), len(mig.moves))
        self.catch_up(mig)
        return self.commit(mig)
