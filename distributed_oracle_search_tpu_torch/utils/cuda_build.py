"""Build-at-first-use for the package's CUDA sources.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``. The
library's file name carries a hash of the source and the flags, so an
edited source rebuilds and an unchanged one loads the cached ``.so``.
The build directory is ``build/kernels`` beside the package (listed in
``.gitignore``); a build compiles to a private temp name and publishes
with an atomic rename. Each source has its own lock, a thread lock
beside an ``fcntl.flock`` on ``build/kernels/<name>.lock``: threads and
processes (a fleet of worker processes on a cold cache) compile a source
once and all load that one library, while different sources build at
once (one ``nvcc`` each).

Nothing here runs at import: the CPU test suite imports every module on
a host with no ``nvcc``.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time

from .log import get_logger

log = get_logger(__name__)

#: Hopper target; the ``a`` keeps wgmma/setmaxnreg available to later kernels
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PACKAGE_DIR), "build", "kernels")

_locks_guard = threading.Lock()
_locks: dict[str, threading.Lock] = {}
_loaded: dict[str, ctypes.CDLL] = {}
#: per-source build record: seconds spent in nvcc (0.0 on a cache hit)
#: and the compiler's ptxas report (registers, shared memory, spills)
build_info: dict[str, dict] = {}


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                       "build the package's kernels")


@contextlib.contextmanager
def _process_lock(name: str):
    """Exclusive ``flock`` on ``build/kernels/<name>.lock`` for the
    block: one process at a time checks the cache and runs ``nvcc`` for
    a source; the kernel releases the lock if the holder dies."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd = os.open(os.path.join(BUILD_DIR, f"{name}.lock"),
                 os.O_RDWR | os.O_CREAT, 0o644)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        yield
    finally:
        os.close(fd)


def load_library(name: str) -> ctypes.CDLL:
    """Compile (once per source hash) and load ``csrc/<name>.cu``."""
    with _locks_guard:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        if name in _loaded:
            return _loaded[name]
        src = os.path.join(CSRC_DIR, f"{name}.cu")
        with open(src, "rb") as f:
            code = f.read()
        tag = hashlib.sha256(code + " ".join(NVCC_FLAGS).encode()
                             ).hexdigest()[:16]
        so = os.path.join(BUILD_DIR, f"{name}-{tag}.so")
        info = {"seconds": 0.0, "ptxas": "", "path": so}
        with _process_lock(name):
            if not os.path.exists(so):
                tmp = f"{so}.tmp.{os.getpid()}"
                t0 = time.perf_counter()
                proc = subprocess.run(
                    [find_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                    capture_output=True, text=True)
                info["seconds"] = time.perf_counter() - t0
                info["ptxas"] = proc.stderr.strip()
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed on {src} "
                                       f"(rc {proc.returncode}):\n"
                                       f"{proc.stdout}\n{proc.stderr}")
                os.rename(tmp, so)
                log.info("built %s in %.1f s", so, info["seconds"])
        lib = ctypes.CDLL(so)
        build_info[name] = info
        _loaded[name] = lib
        return lib
