"""Job launch: start a worker process on a host, detached.

A copy of the JAX package's ``transport/launch.py``. Mechanism parity
with the reference launchers (``make_cpds.py:10-25``,
``make_fifos.py:9-26``): ``ssh <host> "cd <projectdir>; tmux new -As <name>
-d '<cmd>'"`` — the detached tmux session survives the ssh exit and doubles
as crash forensics (reference ``README.md:23``).

Improvements:

* local hosts skip ssh (and, when tmux is absent, fall back to a plain
  detached subprocess with a logfile — same survive-the-parent semantics;
  the port's launchers log to ``<nfs>/<session>.log``,
  :func:`worker_logfile`);
* ``prefer_track`` turns fire-and-forget into tracked completion for
  local builds (the reference has no completion signal, SURVEY.md §3.1).
"""

from __future__ import annotations

import os
import shutil
import subprocess

from ..utils.log import get_logger

log = get_logger(__name__)

LOCAL_HOSTS = ("localhost", "127.0.0.1", "::1")


def session_name(kind: str, wid: int) -> str:
    """``worker-<wid>`` / ``fifo-<wid>`` (reference session naming)."""
    return f"{kind}-{wid}"


def worker_logfile(conf, session: str) -> str | None:
    """Where a tracked local job of ``conf`` logs: ``<nfs>/<session>.log``
    when the shared dir exists, else nowhere (tmux and ssh jobs keep
    their own panes)."""
    return (os.path.join(conf.nfs, f"{session}.log")
            if os.path.isdir(conf.nfs) else None)


def launch(host: str, session: str, cmd: str, projectdir: str = ".",
           logfile: str | None = None,
           prefer_track: bool = False) -> subprocess.Popen | None:
    """Start ``cmd`` detached on ``host``. Returns the Popen handle for
    tracked local subprocesses (so callers can wait), else None.

    ``prefer_track=True`` makes local launches use a tracked subprocess even
    when tmux is available — finite jobs (CPD builds) want completion
    signals; resident servers want tmux's survive-the-parent + forensics.
    """
    if host in LOCAL_HOSTS:
        if shutil.which("tmux") and not prefer_track:
            full = f"cd {projectdir}; tmux new -As {session} -d '{cmd}'"
            subprocess.run(["bash", "-c", full], check=True)
            return None
        out = open(logfile, "ab") if logfile else subprocess.DEVNULL
        return subprocess.Popen(["bash", "-c", cmd], cwd=projectdir,
                                stdout=out, stderr=subprocess.STDOUT,
                                start_new_session=True)
    remote = f"cd {projectdir}; tmux new -As {session} -d '{cmd}'"
    status = subprocess.run(["ssh", host, remote], capture_output=True,
                            text=True)
    if status.returncode != 0:
        raise RuntimeError(
            f"launch on {host} failed: {status.stderr.strip()}")
    return None


def kill_session(host: str, session: str) -> None:
    cmd = f"tmux kill-session -t {session}"
    argv = (["bash", "-c", cmd] if host in LOCAL_HOSTS
            else ["ssh", host, cmd])
    subprocess.run(argv, capture_output=True)
