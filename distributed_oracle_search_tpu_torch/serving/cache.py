"""Bounded LRU result cache for skewed online traffic.

Keyed on ``(s, t, diff, knob fingerprint, membership epoch, diff
epoch)`` — everything that can change an answer OR who computed it. The
membership epoch is in the key because a post-reshard hit could
otherwise serve a result computed by a worker that no longer owns the
shard; the diff epoch is in the key because the live-traffic plane
swaps the active fusion under a long-lived service. The diff *path* is
still part of the key too: a static diff file can be rewritten in place
(the engine's own weight cache has the same ``no_cache`` hatch), which
is why the frontend still calls :meth:`ResultCache.invalidate`
wholesale on a manual diff change.

**Scoped invalidation** (the live-traffic path): a diff epoch swap does
NOT have to flush everything. Each entry can carry a *path signature* —
the node set of the cached walk (``RuntimeConfig.sig_k`` extraction).
An entry whose signature provably avoids every edge the swap updated is
still correct under the new fusion (the walk follows the free-flow
first-move table, so neither its trajectory nor its cost changed) and
is **re-keyed** to the new epoch instead of dropped. Entries without a
signature (old servers, paths longer than ``sig_k``) invalidate
conservatively, and a swap touching more than the configured edge
bound falls back to the wholesale flush — the scan would cost more
than the misses.

Capacity is a byte budget, not an entry count: a signature-less entry
costs a measured flat estimate, and a signature-carrying entry is
additionally charged per signature node — a 64-node frozenset is ~16x
the flat entry, so live-traffic workloads (where most entries carry
signatures) would blow a flat-estimate budget several-fold while the
bytes gauge claimed otherwise. Thread-safe — the frontend reads on the
submit path while shard batcher threads fill on the completion path.
"""

from __future__ import annotations

from collections import OrderedDict

from ..integrity.fingerprint import value_fingerprint
from ..utils.locks import OrderedLock

from ..obs import metrics as obs_metrics

#: signature-less per-entry budget: key tuple (6 elements + a short
#: diff string) + 3-int value tuple + OrderedDict node overhead,
#: measured ~230 bytes on CPython 3.10; rounded up so the budget errs
#: small
ENTRY_BYTES = 256

#: additional budget per path-signature node: one frozenset slot plus
#: its int object (~56 bytes measured, rounded up) — entries are
#: charged for the signature they actually hold, never a flat guess
SIG_NODE_BYTES = 64

M_HITS = obs_metrics.counter(
    "serve_cache_hits_total", "requests short-circuited by the cache")
M_MISSES = obs_metrics.counter(
    "serve_cache_misses_total", "cache lookups that fell through")
M_EVICT = obs_metrics.counter(
    "serve_cache_evictions_total", "LRU entries evicted at the budget")
G_ENTRIES = obs_metrics.gauge(
    "serve_cache_entries", "entries resident in the result cache")
G_BYTES = obs_metrics.gauge(
    "serve_cache_bytes", "estimated bytes resident in the result cache")
M_INV_SCOPED = obs_metrics.counter(
    "serve_cache_invalidated_scoped_total",
    "entries dropped by SCOPED invalidation (path touches an updated "
    "edge, or no signature to prove it does not)")
M_INV_FULL = obs_metrics.counter(
    "serve_cache_invalidated_full_total",
    "entries dropped by FULL flushes (manual diff change, or a swap "
    "past the scoped-edge bound)")
M_REKEYED = obs_metrics.counter(
    "serve_cache_rekeyed_total",
    "scoped-invalidation survivors re-keyed to the new diff epoch "
    "(their path provably avoids every updated edge)")
M_FP_BAD = obs_metrics.counter(
    "cache_fingerprint_mismatch_total",
    "cache hits whose stored crc32 answer fingerprint no longer "
    "matched the entry (DOS_ANSWER_FP) — the entry is dropped and the "
    "query recomputed, never served")


def knob_fingerprint(config) -> tuple:
    """The answer-affecting subset of :class:`~..transport.wire.
    RuntimeConfig`: two frontends sharing a cache (or one frontend
    reconfigured) must never serve an answer computed under different
    knobs. ``threads``/``thread_alloc``/``verbose`` are presentation or
    no-op knobs and stay out; ``itrs`` repeats the same computation
    (last result wins) so it stays out too; ``sig_k`` only adds the
    signature extraction, never changes an answer."""
    return (config.hscale, config.fscale, config.time, config.k_moves,
            config.debug, config.no_cache)


class ResultCache:
    """LRU over ``key -> (cost, plen, finished)`` with optional
    per-entry path signatures (see module docstring)."""

    #: index of the diff path / diff epoch inside the frontend's key
    #: tuple — :meth:`invalidate_scoped` re-keys survivors through them
    KEY_DIFF = 2
    KEY_DEPOCH = 5

    def __init__(self, max_bytes: int, fingerprint: bool = False):
        self.max_bytes = int(max_bytes)
        #: DOS_ANSWER_FP: entries store a crc32 over their answer tuple
        #: at put time and re-check it on EVERY hit — a rotted entry is
        #: dropped (``cache_fingerprint_mismatch_total``) and the miss
        #: path recomputes; a corrupt answer is never served from cache
        self.fingerprint = bool(fingerprint)
        self._od: OrderedDict[tuple, tuple] = OrderedDict()
        self._sigs: dict[tuple, frozenset] = {}
        self._fps: dict[tuple, int] = {}
        self.fp_mismatches = 0
        self._bytes = 0
        #: per-INSTANCE hit/miss tallies beside the process-global
        #: counters: a gateway process hosts N replica L1s (and a test
        #: process may host L1s and a worker L2 together), and the
        #: per-replica hit rate in /statusz must not read a shared
        #: registry counter that conflates them
        self.hits = 0
        self.misses = 0
        self._lock = OrderedLock("serving.ResultCache")

    @property
    def enabled(self) -> bool:
        return self.max_bytes >= ENTRY_BYTES

    @staticmethod
    def _cost(sig: frozenset | None) -> int:
        return ENTRY_BYTES + (len(sig) * SIG_NODE_BYTES if sig else 0)

    def __len__(self) -> int:
        with self._lock:
            return len(self._od)

    def _fp_ok_locked(self, key: tuple, entry: tuple) -> bool:
        """Re-check the entry's stored fingerprint (no-op without one).
        A mismatch drops the entry on the spot — the caller books a
        miss and the query recomputes through the normal path."""
        want = self._fps.get(key)
        if want is None or value_fingerprint(entry) == want:
            return True
        M_FP_BAD.inc()
        self.fp_mismatches += 1
        del self._od[key]
        self._fps.pop(key, None)
        self._bytes -= self._cost(self._sigs.pop(key, None))
        self._set_gauges_locked()
        return False

    def get(self, key: tuple):
        """``(cost, plen, finished)`` or None; books hit/miss."""
        if not self.enabled:
            return None
        with self._lock:
            entry = self._od.get(key)
            if entry is None or not self._fp_ok_locked(key, entry):
                M_MISSES.inc()
                self.misses += 1
                return None
            self._od.move_to_end(key)
            M_HITS.inc()
            self.hits += 1
            return entry

    def get_with_sig(self, key: tuple):
        """``((cost, plen, finished), sig_or_None)`` or None; books
        hit/miss. The shard-owner L2 path uses this: a sig-requesting
        frontend needs the cached walk's node set back so the worker
        can fabricate the paths payload a fresh kernel answer would
        have carried."""
        if not self.enabled:
            return None
        with self._lock:
            entry = self._od.get(key)
            if entry is None or not self._fp_ok_locked(key, entry):
                M_MISSES.inc()
                self.misses += 1
                return None
            self._od.move_to_end(key)
            M_HITS.inc()
            self.hits += 1
            return entry, self._sigs.get(key)

    def hit_rate(self) -> float:
        """This instance's lifetime hit rate (0.0 before any lookup)."""
        n = self.hits + self.misses
        return self.hits / n if n else 0.0

    def put(self, key: tuple, value: tuple,
            sig: frozenset | None = None) -> None:
        """Insert/refresh. ``sig`` is the walk's node set when the
        dispatch captured a COMPLETE path signature (None = unknown —
        the entry then invalidates conservatively on epoch swaps)."""
        if not self.enabled:
            return
        with self._lock:
            if key in self._od:
                self._od.move_to_end(key)
                self._od[key] = value
                if sig is not None:
                    self._bytes += (self._cost(sig)
                                    - self._cost(self._sigs.get(key)))
                    self._sigs[key] = sig
            else:
                self._od[key] = value
                if sig is not None:
                    self._sigs[key] = sig
                self._bytes += self._cost(sig)
            if self.fingerprint:
                self._fps[key] = value_fingerprint(value)
            # evict on BOTH paths: a refresh that attaches a signature
            # to a previously signature-less entry grows the footprint
            # too — a stable hot pool re-answering with signatures
            # would otherwise pin far past the budget with no new key
            # ever triggering eviction
            while self._bytes > self.max_bytes and self._od:
                old_key, _ = self._od.popitem(last=False)
                self._bytes -= self._cost(self._sigs.pop(old_key, None))
                self._fps.pop(old_key, None)
                M_EVICT.inc()
            self._set_gauges_locked()

    def invalidate(self, diff: str | None = None) -> int:
        """Drop every entry (``diff=None``) or only one diff's entries;
        returns how many were dropped. Called on a manual diff change —
        see the module docstring for why keys alone are not enough."""
        with self._lock:
            if diff is None:
                n = len(self._od)
                self._od.clear()
                self._sigs.clear()
                self._fps.clear()
                self._bytes = 0
            else:
                doomed = [k for k in self._od
                          if k[self.KEY_DIFF] == diff]
                for k in doomed:
                    del self._od[k]
                    self._bytes -= self._cost(self._sigs.pop(k, None))
                    self._fps.pop(k, None)
                n = len(doomed)
            M_INV_FULL.inc(n)
            self._set_gauges_locked()
        return n

    def invalidate_scoped(self, pairs, new_diff: str, new_depoch: int,
                          max_edges: int, old_diff: str,
                          old_depoch: int) -> tuple[int, int, str]:
        """Epoch-swap invalidation: drop entries whose cached path
        touches an updated edge (or that cannot prove it does not),
        re-key the provably-safe survivors to ``(new_diff,
        new_depoch)`` so post-swap traffic keeps hitting them.

        ``pairs`` is the swap's affected-edge set (``(u, v)`` node
        tuples) — the DELTA from ``(old_diff, old_depoch)``, the active
        fusion the swap replaced. Only entries keyed at exactly that
        fusion are eligible to survive: an entry under any OTHER epoch
        (e.g. a late put from a batch that was in flight across the
        previous swap) was never tested against the intermediate
        deltas, so re-keying it could resurrect a stale cost — it
        drops unconditionally. Survivorship is therefore inductive:
        every resident entry at epoch E was verified against every
        delta between its compute epoch and E.

        Above ``max_edges`` the per-entry scan is not worth it and the
        whole cache flushes. Returns ``(dropped, kept, reason)`` with
        reason ``"scoped"`` or ``"full"``."""
        pairs = list(pairs)
        with self._lock:
            n = len(self._od)
            if n == 0:
                return 0, 0, "scoped"
            if max_edges >= 0 and len(pairs) > max_edges:
                self._od.clear()
                self._sigs.clear()
                self._fps.clear()
                self._bytes = 0
                M_INV_FULL.inc(n)
                self._set_gauges_locked()
                return n, 0, "full"
            touched = {u for u, _v in pairs} | {v for _u, v in pairs}
            # index the delta by source node: the per-entry check walks
            # the signature's own nodes (O(|sig| x deg)) instead of the
            # whole pair list — a flat scan would be O(entries x pairs)
            # inside this lock, stalling every submit for the swap's
            # duration on hub-heavy deltas
            adj: dict[int, set] = {}
            for u, v in pairs:
                adj.setdefault(u, set()).add(v)
            new_od: OrderedDict[tuple, tuple] = OrderedDict()
            new_sigs: dict[tuple, frozenset] = {}
            new_fps: dict[tuple, int] = {}
            dropped = 0
            new_bytes = 0
            for key, value in self._od.items():
                sig = self._sigs.get(key)
                safe = (sig is not None
                        and len(key) > self.KEY_DEPOCH
                        and key[self.KEY_DIFF] == old_diff
                        and key[self.KEY_DEPOCH] == int(old_depoch)
                        and (sig.isdisjoint(touched)
                             or not any(v in sig
                                        for u in sig if u in adj
                                        for v in adj[u])))
                if not safe:
                    dropped += 1
                    continue
                new_key = (key[:self.KEY_DIFF] + (new_diff,)
                           + key[self.KEY_DIFF + 1:self.KEY_DEPOCH]
                           + (int(new_depoch),))
                new_od[new_key] = value
                new_sigs[new_key] = sig
                fp = self._fps.get(key)
                if fp is not None:
                    new_fps[new_key] = fp
                new_bytes += self._cost(sig)
            self._od = new_od
            self._sigs = new_sigs
            self._fps = new_fps
            self._bytes = new_bytes
            M_INV_SCOPED.inc(dropped)
            M_REKEYED.inc(len(new_od))
            self._set_gauges_locked()
            return dropped, len(new_od), "scoped"

    def _set_gauges_locked(self) -> None:
        G_ENTRIES.set(len(self._od))
        G_BYTES.set(self._bytes)
