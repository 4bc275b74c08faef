"""Build the port's CUDA C++ sources into shared libraries and load them.

Each library is a set of ``csrc/*.cu`` files with a plain C interface,
compiled by ``nvcc`` for Hopper (``sm_90a``) and bound with ``ctypes``:
no PyTorch headers, so a build takes seconds. Libraries are built at first
use into ``airfoil_tpu_torch/_build/`` (git-ignored), rebuilt when a
source in ``csrc/`` is newer than the library or its nvcc flags changed
(they are kept beside it as ``lib<name>.flags``), and never at import
time.

A failed build raises with nvcc's output; there is no fallback. The
compiler's stderr (including ``-Xptxas -v`` register and spill counts) is
kept beside the library as ``lib<name>.log``.
"""

from __future__ import annotations

import ctypes
import fcntl
import glob
import os
import shutil
import subprocess
import threading

__all__ = ["BUILD_DIR", "CSRC_DIR", "NVCC_FLAGS", "load_library", "nvcc_path"]

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
# No --use_fast_math: divisions and square roots stay IEEE.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOCK = threading.Lock()
_NAME_LOCKS: dict[str, threading.Lock] = {}
_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``nvcc`` from PATH, else from ``$CUDA_HOME`` or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (looked on PATH and in "
                       f"{home}/bin); the CUDA toolkit is needed to build "
                       "the port's kernels")


def _is_fresh(lib_path: str, sources: list[str], flags: str) -> bool:
    if not os.path.exists(lib_path):
        return False
    try:
        with open(f"{lib_path[:-3]}.flags") as fh:
            if fh.read() != flags:
                return False
    except FileNotFoundError:
        return False
    # Every header counts for every library (a new header rebuilds them all).
    deps = sources + glob.glob(os.path.join(CSRC_DIR, "*.cuh"))
    return os.path.getmtime(lib_path) >= max(map(os.path.getmtime, deps))


def _build(name: str, sources: list[str], flags: list[str]) -> str:
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(BUILD_DIR, f"lib{name}.so")
    # The file lock serialises builds across processes; the library is
    # written to a temporary name and renamed into place, so a reader
    # never sees a half-written file.
    with open(os.path.join(BUILD_DIR, f"{name}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        stamp = " ".join([*NVCC_FLAGS, *flags])
        if _is_fresh(lib_path, sources, stamp):
            return lib_path
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, *flags, "-o", tmp, *sources]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        with open(os.path.join(BUILD_DIR, f"lib{name}.log"), "w") as log:
            log.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise RuntimeError(
                f"nvcc failed (exit {proc.returncode}) building {name}:\n"
                f"{proc.stderr[-4000:]}")
        os.replace(tmp, lib_path)
        with open(f"{lib_path[:-3]}.flags", "w") as fh:
            fh.write(stamp)
    return lib_path


def load_library(name: str, sources: list[str],
                 flags: tuple[str, ...] = ()) -> ctypes.CDLL:
    """Build (if needed) and load ``lib<name>.so`` from ``sources``, file
    names relative to ``csrc/``, with ``flags`` after ``NVCC_FLAGS``.
    Cached per process; different libraries build concurrently from
    different threads."""
    with _LOCK:
        name_lock = _NAME_LOCKS.setdefault(name, threading.Lock())
    with name_lock:
        lib = _LIBS.get(name)
        if lib is None:
            paths = [os.path.join(CSRC_DIR, s) for s in sources]
            lib = ctypes.CDLL(_build(name, paths, list(flags)))
            _LIBS[name] = lib
        return lib
