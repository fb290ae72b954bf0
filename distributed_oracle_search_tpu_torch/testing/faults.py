"""Deterministic fault-injection harness (``DOS_FAULTS``).

Every recovery path in the fault-tolerance layer — head retries, dropped
replies, circuit breaking, supervisor respawns — is exercised by tests
through this module instead of hoping a real fault shows up. Production
code marks its injection points with :func:`inject`; the ``DOS_FAULTS``
environment variable arms them.

Spec grammar (comma-separated rules, each ``point[;key=value...]``)::

    DOS_FAULTS="drop-reply;wid=2;times=1,delay;wid=0;delay=0.5;times=2"

Points (enacted by the call sites, see the table in the README's
"Fault tolerance" section):

* ``drop-reply``     server handles the batch but never writes the answer
* ``delay``          server sleeps ``delay`` seconds before replying
* ``crash-engine``   the engine raises mid-batch (answered with ``FAIL``)
* ``corrupt-frame``  the head garbles the request frame on the wire
* ``kill-mid-batch`` the worker dies after reading a request, before
                     replying (``mode=exit`` → ``os._exit(86)``, the
                     real-crash default; ``mode=raise`` → the serve loop
                     returns, for in-thread test servers)
* ``crash-build``    the CPD builder dies between block flushes — after
                     a block's atomic write + ledger line, before the
                     next block starts (``mode=exit`` → ``os._exit(86)``
                     default; ``mode=raise`` → RuntimeError). The
                     kill-mid-build resume test's trigger.
* ``kill-during-reshard``  the membership reconfiguration controller
                     dies between shard catch-up moves — after a move's
                     journal line landed, before the next shard starts
                     (``mode=exit`` / ``mode=raise`` like
                     ``crash-build``). The reshard crash-resume
                     trigger: the dual-read window stays open, the
                     journal resumes the tail.
* ``stale-epoch-reply``  the worker refuses the batch with the
                     ``STALE_EPOCH`` wire sentinel even though its
                     table may be current — the analog of a worker
                     whose membership state is wedged behind the
                     fleet, forcing the head's failover path.
* ``blackhole-conn`` a gateway client connection goes half-open: from
                     the fired frame on, the frontend keeps ACCEPTING
                     (reading) the connection's frames but never
                     replies — the client-visible signature of an
                     asymmetric network partition, forcing the
                     discovery/failover/resubmission path. ``wid``
                     filters by frontend id.
* ``lease-freeze``   a gateway frontend stays alive and serving but
                     stops renewing its ``gateway.json`` endpoint
                     lease (the zombie case): readers watch the lease
                     expire while the process runs on. ``wid`` filters
                     by frontend id; freezing is sticky once fired.
* ``corrupt-resident``  bits flip in a loaded shard's RESIDENT rows
                     after the disk digests verified clean — the
                     in-memory corruption no manifest check can see
                     and the resident-table scrubber's target. ``wid``
                     filters by shard.
* ``corrupt-answer`` bits flip in a reply's answer payload after the
                     answer fingerprint was computed — wire/cache
                     corruption the fingerprint verifier must catch
                     before the value reaches a client. ``wid``
                     filters by shard.

Rule keys: ``wid`` restricts to one worker id, ``after`` skips the first
N eligible events, ``times`` caps fires (``inf`` = always), ``delay`` and
``mode`` parameterize their points.

Determinism across processes: rules fire on the Nth eligible event, and
counts normally live in process memory. When a campaign spans processes
(supervised worker subprocesses) set ``DOS_FAULTS_STATE=<path>``: the
seen/fired counts move to a JSON file updated under an ``fcntl`` lock, so
"kill worker 1 exactly once for the whole campaign" stays true across
respawns.

A copy of the JAX package's ``testing/faults.py``: the grammar, the
points, ``DOS_FAULTS_STATE`` and the exit code are the same. The port
arms ``crash-build`` (``models.cpd``), ``corrupt-resident``
(``worker.engine``), and ``drop-reply``, ``delay``, ``crash-engine``,
``kill-mid-batch`` and ``corrupt-frame`` (``transport.fifo``,
``transport.rpc`` and both serve loops of ``worker.server``),
``stale-epoch-reply`` (both serve loops' epoch gate),
``kill-during-reshard`` (``parallel.membership``'s catch-up),
``corrupt-answer`` (the FIFO results file, the RPC reply and the
in-process dispatcher), and ``lease-freeze`` and ``blackhole-conn``
(``gateway.server``). Every point of the grammar has its call site.
"""

from __future__ import annotations

import dataclasses
import json
import threading

from ..obs import metrics as obs_metrics
from ..utils.env import env_str
from ..utils.log import get_logger

log = get_logger(__name__)

#: exit status of a ``kill-mid-batch`` hard exit — distinct from engine
#: failures (rc 1) and the transfer script's no-worker guard (rc 3)
KILL_EXIT_CODE = 86

POINTS = ("drop-reply", "delay", "crash-engine", "corrupt-frame",
          "kill-mid-batch", "crash-build", "kill-during-reshard",
          "stale-epoch-reply", "blackhole-conn", "lease-freeze",
          "corrupt-resident", "corrupt-answer")

M_INJECTED = obs_metrics.counter(
    "faults_injected_total", "fault-harness rules fired (DOS_FAULTS)")


@dataclasses.dataclass
class FaultRule:
    """One armed injection rule (see module docstring for the grammar)."""

    point: str
    wid: int | None = None
    times: float = 1          # fires allowed; float("inf") = always
    after: int = 0            # eligible events skipped before firing
    delay: float = 0.0        # seconds (``delay`` point)
    mode: str = "exit"        # kill-mid-batch: exit | raise
    index: int = 0            # position in the spec = cross-process id

    def matches(self, point: str, wid: int | None) -> bool:
        if self.point != point:
            return False
        return self.wid is None or wid is None or self.wid == wid


def parse_faults(spec: str) -> list[FaultRule]:
    """Parse a ``DOS_FAULTS`` value; malformed rules raise ``ValueError``
    (a typo silently disarming a chaos test would be worse)."""
    rules = []
    for idx, raw in enumerate(t for t in spec.split(",") if t.strip()):
        parts = [p.strip() for p in raw.split(";")]
        point = parts[0]
        if point not in POINTS:
            raise ValueError(f"unknown fault point {point!r} "
                             f"(known: {', '.join(POINTS)})")
        rule = FaultRule(point=point, index=idx)
        for kv in parts[1:]:
            if "=" not in kv:
                raise ValueError(f"fault rule key needs '=': {kv!r}")
            k, v = kv.split("=", 1)
            if k == "wid":
                rule.wid = int(v)
            elif k == "times":
                rule.times = float("inf") if v == "inf" else int(v)
            elif k == "after":
                rule.after = int(v)
            elif k == "delay":
                rule.delay = float(v)
            elif k == "mode":
                if v not in ("exit", "raise"):
                    raise ValueError(f"kill mode {v!r} not in exit|raise")
                rule.mode = v
            else:
                raise ValueError(f"unknown fault rule key {k!r}")
        rules.append(rule)
    return rules


class FaultInjector:
    """Holds the armed rules plus their seen/fired counts.

    ``state_path`` (from ``DOS_FAULTS_STATE``) moves the counts to a
    locked JSON file shared across processes; otherwise they live here.
    """

    def __init__(self, rules: list[FaultRule],
                 state_path: str | None = None):
        self.rules = rules
        self.state_path = state_path
        self._lock = threading.Lock()
        self._seen = [0] * len(rules)
        self._fired = [0] * len(rules)

    # ------------------------------------------------------ shared state
    def _with_file_counts(self, fn):
        """Run ``fn(counts)`` with the state file locked; ``counts`` maps
        rule index -> {"seen": n, "fired": n} and mutations persist."""
        import fcntl

        with open(self.state_path, "a+") as f:
            fcntl.flock(f, fcntl.LOCK_EX)
            f.seek(0)
            raw = f.read().strip()
            counts = json.loads(raw) if raw else {}
            out = fn(counts)
            f.seek(0)
            f.truncate()
            json.dump(counts, f)
            f.flush()
            return out

    def fire(self, point: str, wid: int | None = None) -> FaultRule | None:
        """First matching rule that is due to fire, consuming one count;
        None when nothing fires (the overwhelmingly common case)."""
        for i, rule in enumerate(self.rules):
            if not rule.matches(point, wid):
                continue
            if self.state_path:
                def bump(counts, i=i, rule=rule):
                    c = counts.setdefault(str(i), {"seen": 0, "fired": 0})
                    c["seen"] += 1
                    if (c["seen"] > rule.after
                            and c["fired"] < rule.times):
                        c["fired"] += 1
                        return True
                    return False
                fired = self._with_file_counts(bump)
            else:
                with self._lock:
                    self._seen[i] += 1
                    fired = (self._seen[i] > rule.after
                             and self._fired[i] < rule.times)
                    if fired:
                        self._fired[i] += 1
            if fired:
                M_INJECTED.inc()
                log.warning("fault injected: %s (rule %d, wid=%s)",
                            point, rule.index, wid)
                # the black box gets every injection: a chaos drill's
                # timeline starts at this record (import here — the
                # fault layer must stay importable before obs wiring)
                from ..obs import recorder as obs_recorder
                obs_recorder.emit("fault", point=point, wid=wid)
                return rule
        return None


# ------------------------------------------------------------ module API

_cache_lock = threading.Lock()
_cache: tuple[tuple[str, str | None], FaultInjector] | None = None


def active() -> FaultInjector | None:
    """The injector armed by the current environment (cached per value:
    in-process counts survive across calls, and an env change — tests
    monkeypatching ``DOS_FAULTS`` — rebuilds)."""
    global _cache
    spec = env_str("DOS_FAULTS", "")
    if not spec:
        return None
    key = (spec, env_str("DOS_FAULTS_STATE") or None)
    with _cache_lock:
        if _cache is None or _cache[0] != key:
            _cache = (key, FaultInjector(parse_faults(spec),
                                         state_path=key[1]))
        return _cache[1]


def inject(point: str, wid: int | None = None) -> FaultRule | None:
    """The production hook: returns the fired rule, or None. Zero-cost
    (one dict lookup) when ``DOS_FAULTS`` is unset."""
    if not env_str("DOS_FAULTS"):
        return None
    inj = active()
    return inj.fire(point, wid=wid) if inj is not None else None


def reset() -> None:
    """Drop the cached injector (tests: fresh counts for a reused spec)."""
    global _cache
    with _cache_lock:
        _cache = None
