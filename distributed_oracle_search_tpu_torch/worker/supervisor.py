"""Worker supervisor: launch resident servers, monitor, respawn.

The reference leaves crashed servers dead until a human re-runs
``make_fifos`` (its tmux sessions are forensics, not recovery). The
supervisor closes that loop for local workers:

* **launch** — one ``worker.server`` subprocess per worker id on
  ``device`` (default ``cuda``: each server loads its shard onto the card
  and walks its batches there; ``cpu`` only when asked; its own
  process group, stdout/stderr to a per-worker logfile), readiness
  confirmed by a liveness probe, not FIFO existence (a hard crash leaves
  a stale FIFO behind that would fool an existence check);
* **monitor** — a named ``dos-supervisor`` daemon thread polls each
  subprocess and pings it through the command FIFO
  (``transport.fifo.probe``) every ``ping_interval_s``;
* **respawn** — a dead process is relaunched with capped exponential
  backoff (``base * 2^k`` up to ``cap``); the backoff step resets once
  the respawned worker answers a ping. Hung-worker recovery (process
  alive, pings failing) is opt-in via ``unhealthy_pings`` because a
  single-threaded server legitimately goes quiet for the length of a
  batch (a cold start builds its kernels with ``nvcc``) — enable it
  only with a ping interval comfortably above your worst batch.

Env knobs: ``DOS_SUPERVISOR_PING_S`` (default 2), ``DOS_SUPERVISOR_BACKOFF_BASE_S``
(default 0.5), ``DOS_SUPERVISOR_BACKOFF_CAP_S`` (default 30),
``DOS_SUPERVISOR_UNHEALTHY_PINGS`` (default 0 = ping-based respawn off).

Remote hosts keep the reference's ssh+tmux launch path
(``cli.make_fifos``); supervision there means running this module on the
worker host itself (``python -m ...cli.make_fifos --supervise`` with a
conf whose workers are local).

A copy of the JAX package's ``worker/supervisor.py`` with two additions:
``device`` (passed to every server it spawns or respawns as
``--device``) and ``metrics_dump`` (each server's ``--metrics-dump
<metrics_dump>.w<wid>.json``, written when it stops; a respawned server
writes the same path, so the file after a kill is the respawn's).
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
import time

from ..obs import metrics as obs_metrics
from ..obs import recorder as obs_recorder
from ..transport import fifo as fifo_transport
from ..utils.config import ClusterConfig
from ..utils.env import env_cast
from ..utils.locks import OrderedLock
from ..utils.log import get_logger

log = get_logger(__name__)

M_RESPAWNS = obs_metrics.counter(
    "supervisor_respawns_total", "worker subprocesses relaunched")
M_SUP_PINGS = obs_metrics.counter(
    "supervisor_pings_total", "liveness pings sent by the supervisor")
M_SUP_PING_FAIL = obs_metrics.counter(
    "supervisor_ping_failures_total",
    "supervisor pings that got no healthy reply")
G_ALIVE = obs_metrics.gauge(
    "supervisor_workers_alive", "supervised worker processes running")


class SupervisedWorker:
    """Book-keeping for one supervised worker process."""

    __slots__ = ("wid", "fifo", "proc", "respawns", "backoff_k",
                 "next_spawn_at", "ping_failures", "healthy_once")

    def __init__(self, wid: int, fifo: str):
        self.wid = wid
        self.fifo = fifo
        self.proc: subprocess.Popen | None = None
        self.respawns = 0
        self.backoff_k = 0
        self.next_spawn_at = 0.0
        self.ping_failures = 0
        self.healthy_once = False


class WorkerSupervisor:
    """Launch + monitor + respawn local resident query servers.

    ``spawn_fn(worker) -> subprocess.Popen`` and
    ``probe_fn(worker) -> HealthStatus | None`` are injectable so tests
    can supervise cheap dummy processes; the defaults launch the real
    ``worker.server`` module and ping it over its command FIFO.
    """

    def __init__(self, conf: ClusterConfig, conf_path: str | None = None,
                 wids=None, alg: str = "table-search",
                 fifo_dir: str | None = None,
                 logdir: str | None = None,
                 ping_interval_s: float | None = None,
                 backoff_base_s: float | None = None,
                 backoff_cap_s: float | None = None,
                 unhealthy_pings: int | None = None,
                 probe_timeout_s: float = 10.0,
                 spawn_fn=None, probe_fn=None,
                 traffic_dir: str | None = None,
                 rpc_dir: str | None = None,
                 device: str = "cuda", metrics_dump: str = ""):
        #: where spawned servers bind their streaming-RPC unix sockets
        #: (DOS_TRANSPORT=rpc/auto): overrides DOS_RPC_SOCKET_DIR so a
        #: test fleet's sockets land beside its FIFOs, not in /tmp
        self.rpc_dir = rpc_dir
        #: the device every spawned server loads its shard onto
        self.device = device
        #: path prefix of the servers' metrics dumps ("" = none)
        self.metrics_dump = metrics_dump
        self.conf = conf
        self.conf_path = conf_path
        self.alg = alg
        self.fifo_dir = fifo_dir
        self.logdir = logdir
        #: diff segment stream for the spawned servers' STALE_DIFF
        #: gate (None = workers never gate on diff epochs)
        self.traffic_dir = traffic_dir
        self.ping_interval_s = (
            ping_interval_s if ping_interval_s is not None
            else env_cast("DOS_SUPERVISOR_PING_S", 2.0, float))
        self.backoff_base_s = (
            backoff_base_s if backoff_base_s is not None
            else env_cast("DOS_SUPERVISOR_BACKOFF_BASE_S", 0.5, float))
        self.backoff_cap_s = (
            backoff_cap_s if backoff_cap_s is not None
            else env_cast("DOS_SUPERVISOR_BACKOFF_CAP_S", 30.0, float))
        self.unhealthy_pings = (
            unhealthy_pings if unhealthy_pings is not None
            else env_cast("DOS_SUPERVISOR_UNHEALTHY_PINGS", 0, int))
        self.probe_timeout_s = probe_timeout_s
        self.spawn_fn = spawn_fn or self._spawn_server
        self.probe_fn = probe_fn or self._probe_server
        wids = list(wids) if wids is not None else list(
            range(conf.maxworker))
        self.workers = {wid: SupervisedWorker(wid, self._fifo_for(wid))
                        for wid in wids}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._lock = OrderedLock("supervisor.WorkerSupervisor")

    # --------------------------------------------------------- defaults
    def _fifo_for(self, wid: int) -> str:
        if self.fifo_dir:
            return os.path.join(self.fifo_dir, f"worker{wid}.fifo")
        return fifo_transport.command_fifo_path(wid)

    def _rpc_socket_for(self, wid: int) -> str:
        from ..transport import rpc as rpc_transport

        if self.rpc_dir:
            return os.path.join(self.rpc_dir,
                                f"dos-rpc-worker{wid}.sock")
        return rpc_transport.rpc_socket_path(wid)

    def _spawn_server(self, w: SupervisedWorker) -> subprocess.Popen:
        if not self.conf_path:
            raise ValueError("supervising real servers needs conf_path")
        cmd = [sys.executable, "-m",
               "distributed_oracle_search_tpu_torch.worker.server",
               "-c", self.conf_path, "--workerid", str(w.wid),
               "--fifo", w.fifo, "--alg", self.alg,
               "--device", self.device]
        if self.metrics_dump:
            cmd += ["--metrics-dump", f"{self.metrics_dump}.w{w.wid}.json"]
        if self.traffic_dir:
            cmd += ["--traffic-dir", self.traffic_dir]
        # streaming data plane: when the fleet runs DOS_TRANSPORT=rpc/
        # auto (or the caller pinned a socket dir), spawned servers get
        # an explicit per-worker socket so respawns land on the SAME
        # endpoint the head's persistent clients reconnect to
        from ..transport import rpc as rpc_transport
        if self.rpc_dir or rpc_transport.resolve_transport() != "fifo":
            cmd += ["--rpc-socket", self._rpc_socket_for(w.wid)]
        out = subprocess.DEVNULL
        if self.logdir:
            os.makedirs(self.logdir, exist_ok=True)
            out = open(os.path.join(self.logdir, f"worker{w.wid}.log"),
                       "ab")
        # DOS_OBS_PORT names ONE port: the supervisor's own obs server
        # binds it; letting N children inherit it would put every
        # worker in contention for the same socket (give workers their
        # own ports via per-worker --obs-port wiring when needed)
        env = {k: v for k, v in os.environ.items()
               if k != "DOS_OBS_PORT"}
        return subprocess.Popen(cmd, cwd=self.conf.projectdir,
                                stdout=out, stderr=subprocess.STDOUT,
                                start_new_session=True, env=env)

    def _probe_server(self, w: SupervisedWorker):
        return fifo_transport.probe(
            "localhost", w.wid, command_fifo=w.fifo, nfs=self.conf.nfs,
            timeout=self.probe_timeout_s)

    # ---------------------------------------------------------- control
    def start(self, wait_ready_s: float = 120.0) -> None:
        """Spawn every worker, wait until each answers a ping, then
        start the monitor thread. A startup failure stops the workers
        already spawned before re-raising — they were launched in their
        own sessions and would otherwise outlive the failed supervisor,
        squatting on the command FIFOs of the operator's retry run."""
        try:
            self._start_inner(wait_ready_s)
        except BaseException:
            self.stop(join_s=5.0)
            raise

    def _start_inner(self, wait_ready_s: float) -> None:
        for w in self.workers.values():
            w.proc = self.spawn_fn(w)
            log.info("supervisor: spawned worker %d (pid %d)", w.wid,
                     w.proc.pid)
        deadline = time.monotonic() + wait_ready_s
        pending = set(self.workers)
        while pending and time.monotonic() < deadline:
            for wid in sorted(pending):
                w = self.workers[wid]
                if w.proc.poll() is not None:
                    raise RuntimeError(
                        f"worker {wid} died during startup "
                        f"(rc={w.proc.returncode})")
                st = self.probe_fn(w)
                if st is not None and getattr(st, "ok", False):
                    w.healthy_once = True
                    pending.discard(wid)
            if pending:
                time.sleep(0.2)
        if pending:
            raise RuntimeError(
                f"workers {sorted(pending)} not ready within "
                f"{wait_ready_s:.0f}s")
        G_ALIVE.set(len(self.workers))
        self._thread = threading.Thread(target=self._monitor,
                                        daemon=True,
                                        name="dos-supervisor")
        self._thread.start()
        log.info("supervisor: %d worker(s) ready", len(self.workers))

    def stop(self, join_s: float = 10.0) -> None:
        """Stop monitoring, then stop the servers (graceful token first,
        SIGTERM/SIGKILL escalation after)."""
        from .server import stop_server

        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=join_s)
            self._thread = None
        workers = self._snapshot()
        for w in workers:
            if w.proc is None or w.proc.poll() is not None:
                continue
            stop_server(w.fifo, deadline_s=1.0)
        for w in workers:
            if w.proc is None:
                continue
            try:
                w.proc.wait(timeout=join_s)
            except subprocess.TimeoutExpired:
                w.proc.terminate()
                try:
                    w.proc.wait(timeout=5.0)
                except subprocess.TimeoutExpired:
                    w.proc.kill()
                    w.proc.wait(timeout=5.0)
        G_ALIVE.set(0)

    def __enter__(self) -> "WorkerSupervisor":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------ elastic membership
    def _snapshot(self) -> list[SupervisedWorker]:
        """Consistent view of the supervised set: join/leave mutate the
        dict from other threads while the monitor iterates."""
        with self._lock:
            return list(self.workers.values())

    def add_worker(self, wid: int, fifo: str | None = None,
                   wait_ready_s: float = 120.0) -> SupervisedWorker:
        """Drain-free JOIN support: spawn and supervise one more worker
        without touching the running fleet. Readiness is confirmed by a
        liveness ping (same rule as :meth:`start`); the reconfiguration
        controller flips routing only after the adopter is serving."""
        with self._lock:
            if wid in self.workers:
                raise ValueError(f"worker {wid} is already supervised")
        w = SupervisedWorker(wid, fifo or self._fifo_for(wid))
        # spawn BEFORE publishing: the monitor thread iterates the
        # supervised set concurrently, and an entry with proc=None
        # would read as a dead worker — scheduling a respawn that races
        # this spawn for the same command FIFO
        w.proc = self.spawn_fn(w)
        with self._lock:
            if wid in self.workers:
                w.proc.terminate()
                raise ValueError(f"worker {wid} is already supervised")
            self.workers[wid] = w
        log.info("supervisor: joined worker %d (pid %d)", wid,
                 w.proc.pid)
        deadline = time.monotonic() + wait_ready_s
        try:
            while time.monotonic() < deadline:
                if w.proc.poll() is not None:
                    raise RuntimeError(
                        f"joining worker {wid} died during startup "
                        f"(rc={w.proc.returncode})")
                st = self.probe_fn(w)
                if st is not None and getattr(st, "ok", False):
                    w.healthy_once = True
                    return w
                time.sleep(0.2)
            raise RuntimeError(
                f"joining worker {wid} not ready within "
                f"{wait_ready_s:.0f}s")
        except BaseException:
            # a raising probe (monitor wraps the same call) must not
            # strand a half-joined worker supervised: the caller sees
            # the failure, so the joiner must be fully unwound
            self._abandon_join(w)
            raise

    def _abandon_join(self, w: SupervisedWorker) -> None:
        """Failed join cleanup: unsupervise, then stop whatever process
        is CURRENTLY attached — the monitor may have respawned the
        worker while add_worker was still polling readiness, and that
        respawn must not outlive supervision as an orphan."""
        with self._lock:
            self.workers.pop(w.wid, None)
        if w.proc is not None and w.proc.poll() is None:
            w.proc.terminate()

    def remove_worker(self, wid: int, join_s: float = 10.0) -> bool:
        """Drain-free LEAVE support: unsupervise the worker (so the
        monitor cannot respawn it), push the graceful stop token — the
        server finishes the frame it already read, answers it, and
        exits 0 — then escalate to SIGTERM/SIGKILL only if the drain
        stalls. Call AFTER the membership commit moved its shards.
        Returns True when the worker exited 0 (a clean drain)."""
        from .server import stop_server

        with self._lock:
            w = self.workers.pop(wid, None)
        if w is None:
            log.warning("supervisor: worker %d is not supervised", wid)
            return False
        if w.proc is not None and w.proc.poll() is None:
            stop_server(w.fifo, deadline_s=2.0)
            try:
                w.proc.wait(timeout=join_s)
            except subprocess.TimeoutExpired:
                log.warning("supervisor: worker %d drain stalled; "
                            "escalating", wid)
                w.proc.terminate()
                try:
                    w.proc.wait(timeout=5.0)
                except subprocess.TimeoutExpired:
                    w.proc.kill()
                    w.proc.wait(timeout=5.0)
        rc = w.proc.returncode if w.proc is not None else None
        log.info("supervisor: worker %d left the fleet (rc=%s)", wid, rc)
        return rc == 0

    # ---------------------------------------------------- obs endpoints
    def health(self) -> dict:
        """``/healthz``: ok iff every supervised worker process is
        currently running (a worker mid-backoff reports unhealthy —
        exactly when an orchestrator should hold traffic)."""
        workers = self._snapshot()
        running = sum(
            1 for w in workers
            if w.proc is not None and w.proc.poll() is None)
        return {"ok": running == len(workers),
                "alive": running, "workers": len(workers)}

    def statusz(self) -> dict:
        """``/statusz`` section: per-worker process/respawn/ping state."""
        workers = {}
        for w in self._snapshot():
            workers[str(w.wid)] = {
                "pid": w.proc.pid if w.proc is not None else None,
                "running": (w.proc is not None
                            and w.proc.poll() is None),
                "respawns": w.respawns,
                "backoff_step": w.backoff_k,
                "ping_failures": w.ping_failures,
                "healthy_once": w.healthy_once,
                "fifo": w.fifo,
            }
        h = self.health()
        return {"alive": h["alive"], "workers_total": h["workers"],
                "respawns": sum(w.respawns
                                for w in self._snapshot()),
                "ping_interval_s": self.ping_interval_s,
                "workers": workers}

    def kick(self, wid: int) -> bool:
        """Control-plane respawn accelerator: clear ``wid``'s backoff
        schedule so the monitor's next tick respawns a dead worker
        immediately instead of waiting out the exponential backoff.
        The control daemon calls this when it has *decided* the worker
        is sick — evidence the backoff's "maybe it is flapping" caution
        no longer applies to. Returns True when an immediate respawn
        was scheduled (the worker is currently dead)."""
        with self._lock:
            w = self.workers.get(wid)
        if w is None:
            return False
        w.backoff_k = 0
        dead = w.proc is None or w.proc.poll() is not None
        if dead:
            # overwrite any already-scheduled backoff wait; 0.0 is the
            # "death not yet observed" sentinel so schedule explicitly
            w.next_spawn_at = time.monotonic()
        obs_recorder.emit("supervisor_kick", wid=w.wid,
                          respawn_scheduled=dead)
        return dead

    # --------------------------------------------------------- monitor
    def _backoff_s(self, w: SupervisedWorker) -> float:
        return min(self.backoff_cap_s,
                   self.backoff_base_s * (2 ** w.backoff_k))

    def _monitor(self) -> None:
        while not self._stop.wait(self.ping_interval_s):
            alive = 0
            for w in self._snapshot():
                if self._stop.is_set():
                    return
                try:
                    alive += self._monitor_one(w)
                except Exception:  # noqa: BLE001 — a spawn/probe bug
                    # must not kill the only thread doing recovery; the
                    # next tick retries (respawns under backoff)
                    log.exception("supervisor: monitoring worker %d "
                                  "failed; will retry", w.wid)
            G_ALIVE.set(alive)

    def _monitor_one(self, w: SupervisedWorker) -> int:
        """Returns 1 if the worker process is running, else 0."""
        if w.proc is None or w.proc.poll() is not None:
            self._maybe_respawn(w, "process died")
            return 0
        M_SUP_PINGS.inc()
        st = self.probe_fn(w)
        healthy = st is not None and getattr(st, "ok", False)
        if healthy:
            w.ping_failures = 0
            if not w.healthy_once:
                w.healthy_once = True
                w.backoff_k = 0   # respawn confirmed good
            return 1
        M_SUP_PING_FAIL.inc()
        w.ping_failures += 1
        if (self.unhealthy_pings
                and w.ping_failures >= self.unhealthy_pings):
            log.error("supervisor: worker %d unresponsive after "
                      "%d pings; killing for respawn", w.wid,
                      w.ping_failures)
            w.proc.kill()
            try:
                w.proc.wait(timeout=5.0)
            except subprocess.TimeoutExpired:
                pass
            self._maybe_respawn(w, "hung (ping failures)")
            return 0
        return 1

    def _maybe_respawn(self, w: SupervisedWorker, why: str) -> None:
        now = time.monotonic()
        if w.next_spawn_at == 0.0:
            # first observation of this death: schedule the respawn
            delay = self._backoff_s(w)
            w.next_spawn_at = now + delay
            rc = w.proc.returncode if w.proc is not None else None
            log.error("supervisor: worker %d down (%s, rc=%s); respawn "
                      "in %.2fs (backoff step %d)", w.wid, why, rc,
                      delay, w.backoff_k)
            return
        if now < w.next_spawn_at:
            return
        with self._lock:
            if self.workers.get(w.wid) is not w:
                # unsupervised between ticks (remove_worker / a failed
                # add_worker): respawning now would orphan a process
                # nothing manages
                return
        w.next_spawn_at = 0.0
        w.backoff_k += 1
        w.ping_failures = 0
        w.healthy_once = False      # reset backoff only after a good ping
        proc = self.spawn_fn(w)     # outside the lock: spawning blocks
        with self._lock:
            # re-check after the spawn: remove_worker can win the race
            # between the pre-spawn identity check and spawn_fn — the
            # process must not be published into an unsupervised entry
            adopted = self.workers.get(w.wid) is w
            if adopted:
                w.proc = proc
                w.respawns += 1
        if not adopted:
            log.warning("supervisor: worker %d unsupervised during "
                        "respawn; terminating orphan pid %d", w.wid,
                        proc.pid)
            proc.terminate()
            return
        M_RESPAWNS.inc()
        obs_recorder.emit("respawn", wid=w.wid, pid=proc.pid,
                          respawn=w.respawns, why=why)
        log.warning("supervisor: respawned worker %d (pid %d, "
                    "respawn #%d)", w.wid, proc.pid, w.respawns)


def supervise_forever(conf: ClusterConfig, conf_path: str,
                      alg: str = "table-search",
                      logdir: str | None = None,
                      obs_port: int | None = None,
                      traffic_dir: str | None = None,
                      device: str = "cuda", metrics_dump: str = "") -> int:
    """``make_fifos --supervise`` entry: run until interrupted.
    ``obs_port`` (or ``DOS_OBS_PORT``) additionally serves live
    ``/metrics`` ``/healthz`` ``/statusz`` for the whole supervised
    fleet — healthz goes 503 the moment any worker is down."""
    from ..obs.http import start_obs_server

    from ..obs import telemetry as obs_telemetry

    from ..control import maybe_daemon

    sup = WorkerSupervisor(conf, conf_path, alg=alg, logdir=logdir,
                           traffic_dir=traffic_dir, device=device,
                           metrics_dump=metrics_dump)
    obs_srv = None
    publisher = None
    daemon = None
    try:
        sup.start()
        # closed-loop control (DOS_CONTROL=1): supervise-side the
        # daemon senses the supervisor only — it accelerates respawns
        # of workers it has decided are sick and journals the incident
        daemon = maybe_daemon(supervisor=sup)
        providers = {"supervisor": sup.statusz}
        if daemon is not None:
            providers["control"] = daemon.statusz
        # inside the try: a bind failure (port taken) must tear the
        # just-spawned workers down, not orphan them unsupervised
        obs_srv = start_obs_server(
            obs_port, health_fn=sup.health,
            status_providers=providers)
        # fleet telemetry: the supervisor's own counters (respawns,
        # ping failures) ride the sidecar lane beside the workers' —
        # its file lands in the FIFO directory the head already polls
        if sup.workers and obs_telemetry.interval_s() > 0:
            fifo_dir = os.path.dirname(
                next(iter(sup.workers.values())).fifo) or "."
            publisher = obs_telemetry.TelemetryPublisher(
                source="supervisor",
                sinks=[obs_telemetry.sidecar_sink(os.path.join(
                    fifo_dir,
                    "supervisor" + obs_telemetry.SIDECAR_SUFFIX))],
            ).start()
        print(f"supervising {len(sup.workers)} worker(s); "
              "Ctrl-C to stop")
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        log.info("supervisor: interrupted; stopping workers")
    finally:
        if daemon is not None:
            daemon.stop()
        if publisher is not None:
            publisher.stop()
        if obs_srv is not None:
            obs_srv.close()
        sup.stop()
    return 0
