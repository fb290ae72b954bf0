"""Head-side transport: push a request to a worker, read its answer.

Mechanism parity with the reference (``process_query.py:66-111``,
``offline.py:70-125``): the head generates a small bash script —

    mkfifo <answer>
    cat > /tmp/worker<wid>.fifo <<EOF
    <2-line request>
    EOF
    cat <answer>
    rm <answer>

— and pipes it through ``ssh <host> 'bash -s'``. The blocking FIFO opens are
the rendezvous: the script blocks until the resident worker reads the
command, and ``cat <answer>`` blocks until the worker writes its one CSV
stats line.

Improvements over the reference (SURVEY.md §2.1 quirks):

* **real local path everywhere** — ``localhost``/``127.0.0.1`` runs the same
  script via a local ``bash -s`` subprocess, no ssh round-trip (the reference
  only had this in the legacy ``offline.py`` driver);
* **explicit failure** — a dead worker yields ``StatsRow.failed()`` (and an
  optional retry), not a garbage row silently entering the CSV
  (reference ``process_query.py:107-109``);
* timeouts on every blocking step;
* **per-attempt answer FIFOs** — each retry attempt reads a uniquely named
  FIFO (``<answer>.a<attempt>``), so a late reply from a timed-out attempt
  can never satisfy (or corrupt) the retry — the worker replies to the
  FIFO named in the request it actually read;
* **liveness probes** — :func:`probe` pushes a ``__DOS_PING__`` control
  frame and returns the server's :class:`~.wire.HealthStatus` line.

A copy of the JAX package's ``transport/fifo.py``: the scripts it runs
are byte-equal, so either package's head drives either package's
servers.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import random
import subprocess
import time
import zlib
from multiprocessing.dummy import Pool

from .launch import LOCAL_HOSTS
from .wire import HealthStatus, PING_TOKEN, Request, StatsRow
from ..obs import metrics as obs_metrics
from ..testing import faults
from ..utils.env import env_cast
from ..utils.log import get_logger

log = get_logger(__name__)

#: default transport timeout: generous enough for a cold-compile first
#: batch over a slow link, finite so a dead worker cannot hang the campaign
DEFAULT_TIMEOUT = 600.0

M_RETRIES = obs_metrics.counter(
    "head_retries_total", "batch send attempts beyond the first")
M_STALE_CLEANED = obs_metrics.counter(
    "head_stale_fifos_cleaned_total",
    "leftover answer FIFOs removed at campaign start")
M_PROBES = obs_metrics.counter(
    "head_probes_total", "liveness pings sent to workers")
M_PROBE_FAILURES = obs_metrics.counter(
    "head_probe_failures_total", "liveness pings that got no health line")


def command_fifo_path(wid: int) -> str:
    """Per-worker command FIFO (reference ``make_fifos.py`` convention)."""
    return f"/tmp/worker{wid}.fifo"


def answer_fifo_path(nfs: str, host: str, wid: int) -> str:
    return f"{nfs.rstrip('/')}/answer.{host}{wid}"


def clean_stale_answer_fifos(nfs: str) -> int:
    """Remove leftover ``answer.*`` FIFOs in the shared dir.

    A killed transfer script never reaches its ``rm -f``, so crashed runs
    accumulate stale answer FIFOs; campaigns call this once at start.
    Only FIFOs are touched — regular files matching the glob are not
    ours, and ``answer.ping.*`` probe FIFOs are skipped: a supervisor
    pinging through the same nfs dir may have one in flight right now.
    """
    import glob as _glob
    import stat as _stat

    n = 0
    for p in _glob.glob(os.path.join(nfs, "answer.*")):
        if os.path.basename(p).startswith("answer.ping."):
            continue
        try:
            if _stat.S_ISFIFO(os.stat(p).st_mode):
                os.remove(p)
                n += 1
        except OSError:
            continue
    if n:
        log.info("cleaned %d stale answer FIFO(s) in %s", n, nfs)
        M_STALE_CLEANED.inc(n)
    return n


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Retry with capped exponential backoff + deterministic jitter.

    Env knobs (``from_env``): ``DOS_RETRY_MAX`` (attempts beyond the
    first, default 1), ``DOS_RETRY_BASE_S`` (first backoff, default 0.2),
    ``DOS_RETRY_CAP_S`` (backoff ceiling, default 5), ``DOS_RETRY_JITTER``
    (fractional spread, default 0.5). Jitter is seeded from the answer
    FIFO path (crc32, not ``hash`` — ``PYTHONHASHSEED`` randomizes that),
    so a rerun backs off identically: campaigns stay reproducible."""

    retries: int = 1
    base_s: float = 0.2
    cap_s: float = 5.0
    jitter: float = 0.5

    @classmethod
    def from_env(cls) -> "RetryPolicy":
        return cls(
            retries=env_cast("DOS_RETRY_MAX", cls.retries, int),
            base_s=env_cast("DOS_RETRY_BASE_S", cls.base_s, float),
            cap_s=env_cast("DOS_RETRY_CAP_S", cls.cap_s, float),
            jitter=env_cast("DOS_RETRY_JITTER", cls.jitter, float),
        )

    def backoff_s(self, attempt: int, seed: str = "") -> float:
        """Delay before retry ``attempt`` (0-based: the first retry)."""
        raw = min(self.cap_s, self.base_s * (2 ** attempt))
        if not self.jitter or raw <= 0:
            return max(raw, 0.0)
        rnd = random.Random(zlib.crc32(f"{seed}:{attempt}".encode()))
        return raw * (1.0 + self.jitter * (2 * rnd.random() - 1.0))


def clean_stale_epoch_files(nfs: str,
                            min_age_s: float | None = None) -> int:
    """Remove epoch-suffixed ``query.*``/``answer.*`` wire files
    (names carrying ``.e<epoch>`` — the dual-read migration window's
    re-routed batch names) left behind by an aborted or crashed
    reconfiguration: unlike a normal batch, a window torn down
    mid-dispatch has no surviving owner to sweep its files on the next
    round. Age-gated like the artifact sweep — a young file may be a
    LIVE dual-read batch of a concurrent campaign — and counted by
    ``artifacts_swept_total`` (these are artifact debris, not FIFOs in
    rendezvous; stale epoch-suffixed answer FIFOs are removed too)."""
    import glob as _glob
    import re as _re

    from ..utils.atomicio import M_SWEPT, SWEEP_MIN_AGE_S

    if min_age_s is None:
        min_age_s = SWEEP_MIN_AGE_S
    pat = _re.compile(r"\.e\d+(\.|$)")
    now = time.time()
    n = 0
    for stem in ("query.*", "answer.*"):
        for p in _glob.glob(os.path.join(nfs, stem)):
            if not pat.search(os.path.basename(p)):
                continue
            try:
                if now - os.path.getmtime(p) >= min_age_s:
                    os.remove(p)
                    n += 1
            except OSError:
                continue
    if n:
        log.info("swept %d stale epoch-suffixed wire file(s) in %s",
                 n, nfs)
        M_SWEPT.inc(n)
    return n


def make_script(request: Request, command_fifo: str,
                corrupt: bool = False,
                answer_wait_s: float | None = None) -> str:
    """The transfer script run on the worker host (local or over ssh).

    Guards the command FIFO with ``[ -p ... ]``: if no server is resident,
    the reference's script shape would create a regular file and then block
    forever on the answer; we fail fast with a distinct exit code instead.

    ``answer_wait_s`` bounds the ``cat <answer>`` read itself: when the
    head's ssh/bash wrapper is killed on timeout, the orphaned ``cat``
    would otherwise hold the answer FIFO open forever on a dead worker.
    ``corrupt`` garbles the frame (the ``corrupt-frame`` fault point).
    """
    payload = request.encode()
    if corrupt:
        # breaks line 1's JSON shape: the server must count the frame
        # malformed and FAIL the answer FIFO instead of wedging the head
        payload = "CORRUPT " + payload
    fifo = request.answerfifo
    # never render `timeout 0` — GNU timeout treats 0 as "no timeout",
    # which would silently disarm the orphan-cat bound for sub-second
    # deadlines
    catcmd = (f"timeout {max(1, int(round(answer_wait_s)))} cat {fifo}"
              if answer_wait_s else f"cat {fifo}")
    return (
        f"[ -p {command_fifo} ] || "
        f"{{ echo 'no resident worker on {command_fifo}' >&2; exit 3; }}\n"
        f"mkfifo {fifo} 2>/dev/null || true\n"
        f"cat > {command_fifo} <<'__DOS_EOF__'\n"
        f"{payload}"
        f"__DOS_EOF__\n"
        f"{catcmd}\n"
        f"rm -f {fifo}\n"
    )


def _run_script(host: str, script: str,
                timeout: float | None) -> subprocess.CompletedProcess:
    if host in LOCAL_HOSTS:
        argv = ["bash", "-s"]
    else:
        argv = ["ssh", host, "bash -s"]
    return subprocess.run(argv, input=script, capture_output=True,
                          text=True, timeout=timeout)


def send(host: str, request: Request, command_fifo: str,
         timeout: float | None = DEFAULT_TIMEOUT,
         wid: int | None = None) -> StatsRow:
    """Run the transfer script on ``host`` and parse the stats line."""
    corrupt = faults.inject("corrupt-frame", wid=wid) is not None
    script = make_script(request, command_fifo, corrupt=corrupt,
                         answer_wait_s=timeout)
    proc = _run_script(host, script, timeout)
    if proc.returncode != 0:
        log.error("worker transfer on %s failed (rc=%d): %s",
                  host, proc.returncode, proc.stderr.strip())
        return StatsRow.failed()
    line = proc.stdout.strip().splitlines()
    if not line:
        log.error("worker on %s returned no stats line", host)
        return StatsRow.failed()
    try:
        return StatsRow.decode(line[-1])
    except ValueError as e:
        log.error("bad stats line from %s: %s", host, e)
        return StatsRow.failed()


def send_with_retry(host: str, request: Request, command_fifo: str,
                    timeout: float | None = DEFAULT_TIMEOUT,
                    retries: int | None = None,
                    policy: RetryPolicy | None = None,
                    wid: int | None = None) -> StatsRow:
    """``send`` with capped-exponential-backoff retries.

    Each attempt reads its own answer FIFO (``<base>.a<attempt>``): the
    worker replies to the FIFO named in the request it actually read, so
    a late reply from a timed-out attempt lands in that attempt's FIFO
    (draining into the orphaned, dying ``cat``) and can never satisfy or
    corrupt a newer attempt — the stale-reply race of a shared FIFO name.
    """
    policy = policy or RetryPolicy.from_env()
    if retries is not None:
        policy = dataclasses.replace(policy, retries=retries)
    base_fifo = request.answerfifo
    row = StatsRow.failed()
    for attempt in range(policy.retries + 1):
        if attempt:
            M_RETRIES.inc()
            delay = policy.backoff_s(attempt - 1, seed=base_fifo)
            log.warning("retrying worker on %s (attempt %d) in %.2fs",
                        host, attempt, delay)
            time.sleep(delay)
        req = dataclasses.replace(request,
                                  answerfifo=f"{base_fifo}.a{attempt}")
        try:
            row = send(host, req, command_fifo, timeout=timeout, wid=wid)
        except subprocess.TimeoutExpired:
            log.error("worker on %s timed out (attempt %d)", host, attempt)
            row = StatsRow.failed()
        if row.ok:
            return row
    return row


# ------------------------------------------------------------------ probing

_PROBE_SEQ = itertools.count()


def ping_script(command_fifo: str, answerfifo: str,
                wait_s: float) -> str:
    """Transfer script for one liveness probe: push the ping control
    frame, read one health line. Both blocking FIFO opens are bounded by
    ``timeout`` — a hard-crashed server leaves its command FIFO behind
    with no reader, and an unbounded ``> fifo`` open would wedge the
    probe exactly like the failure it is trying to detect."""
    w = max(1, int(wait_s))
    return (
        f"[ -p {command_fifo} ] || "
        f"{{ echo 'no resident worker on {command_fifo}' >&2; exit 3; }}\n"
        f"mkfifo {answerfifo} 2>/dev/null || true\n"
        f"timeout {w} bash -c 'printf \"%s\\n\" "
        f"\"{PING_TOKEN} {answerfifo}\" > {command_fifo}' || "
        f"{{ rm -f {answerfifo}; exit 4; }}\n"
        f"timeout {w} cat {answerfifo}\n"
        f"rc=$?\n"
        f"rm -f {answerfifo}\n"
        f"exit $rc\n"
    )


def probe(host: str, wid: int, command_fifo: str | None = None,
          nfs: str = "/tmp",
          timeout: float = 10.0) -> HealthStatus | None:
    """Ping the resident server for worker ``wid`` on ``host``.

    Returns its :class:`~.wire.HealthStatus`, or None when the worker is
    dead/unreachable (no FIFO, no reader, no reply within ``timeout``, or
    an undecodable health line). The answer FIFO name is unique per probe
    (pid + sequence), so concurrent probes never cross replies.
    """
    command_fifo = command_fifo or command_fifo_path(wid)
    answer = (f"{nfs.rstrip('/')}/answer.ping.{host}{wid}"
              f".{os.getpid()}.{next(_PROBE_SEQ)}")
    M_PROBES.inc()
    script = ping_script(command_fifo, answer, timeout)
    try:
        proc = _run_script(host, script, timeout + 5.0)
    except (subprocess.TimeoutExpired, OSError) as e:
        log.warning("probe of worker %d on %s errored: %s", wid, host, e)
        M_PROBE_FAILURES.inc()
        return None
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        log.warning("probe of worker %d on %s failed (rc=%d): %s", wid,
                    host, proc.returncode, proc.stderr.strip())
        M_PROBE_FAILURES.inc()
        return None
    try:
        return HealthStatus.from_json(lines[-1])
    except (ValueError, TypeError) as e:
        log.warning("bad health line from worker %d on %s: %s", wid,
                    host, e)
        M_PROBE_FAILURES.inc()
        return None


def fan_out(jobs, fn, pool_size: int | None = None) -> list:
    """Drive all workers concurrently, one thread per worker (parity with the
    reference's ``multiprocessing.dummy.Pool``, ``process_query.py:180-185``).
    """
    if not jobs:
        return []
    with Pool(pool_size or len(jobs)) as pool:
        return pool.map(fn, jobs)
