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
kept beside the library as ``lib<name>.log``. ``build_library`` is the
same rule for any compiler: the native geometry library
(``airfoil_tpu_torch/native``) builds through it with ``g++``.

``LIBRARIES`` is every kernel library of the port, each with its sources
and the nvcc flags it adds: the one place a library is declared. Each
wrapper binds its library's C signatures (``bind``) and launches through
``launch``, the one path of every CUDA launch: one rule for the device's
index, the current stream, the library's error text for a failed launch
and the count of launches, kept as ``int`` attributes of the wrapper's
module (``lbm.kernel.launches``, ``viscous.kernel.march_launches``, ...).
A launch made while its thread captures a CUDA graph is tallied instead
(``tallied``) and counted at each replay (``add_launches``).
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import glob
import os
import shutil
import subprocess
import sys
import threading

import torch

__all__ = ["BUILD_DIR", "CSRC_DIR", "LIBRARIES", "NVCC_FLAGS",
           "add_launches", "bind", "build_library", "check", "device_index",
           "launch", "load_library", "nvcc_path", "tallied"]

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
# No --use_fast_math: divisions and square roots stay IEEE.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# Library name -> (its sources in csrc/, the flags it adds to NVCC_FLAGS).
LIBRARIES = {
    "lbm_steps": (("lbm_steps.cu",), ()),
    "lbm_steps_tiled": (("lbm_steps_tiled.cu",), ()),
    # Rounding as torch's one-operation-per-kernel arithmetic: no
    # contraction of multiply-adds into FMAs.
    "bl_march": (("bl_march.cu",), ("-fmad=false",)),
    "field_b64": (("field_b64.cu",), ()),
}

_LOCK = threading.Lock()
_NAME_LOCKS: dict[str, threading.Lock] = {}
_LIBS: dict[str, ctypes.CDLL] = {}
_COUNT_LOCK = threading.Lock()  # guards every wrapper's launch counters


class _Capture(threading.local):
    counts: dict | None = None   # this thread's tally while it captures


_CAPTURE = _Capture()


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


def _is_fresh(lib_path: str, sources: list[str], flags: str,
              headers: list[str] | None = None) -> bool:
    if not os.path.exists(lib_path):
        return False
    try:
        with open(f"{lib_path[:-3]}.flags") as fh:
            if fh.read() != flags:
                return False
    except FileNotFoundError:
        return False
    # Every header counts for every library (a new header rebuilds them all).
    if headers is None:
        headers = glob.glob(os.path.join(CSRC_DIR, "*.cuh"))
    deps = sources + headers
    return os.path.getmtime(lib_path) >= max(map(os.path.getmtime, deps))


def build_library(name: str, compiler, flags: list[str],
                  sources: list[str], headers: list[str] | None = None
                  ) -> str:
    """Build ``lib<name>.so`` in ``BUILD_DIR`` from ``sources`` (paths)
    with ``compiler()`` (called only when a build is due) and ``flags``,
    unless it is fresh (newer than ``sources`` and ``headers``, default
    the ``csrc/*.cuh`` headers, and built with ``flags``). Returns its
    path; a failed build raises with the compiler's output."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(BUILD_DIR, f"lib{name}.so")
    # The file lock serialises builds across processes; the library is
    # written to a temporary name and renamed into place, so a reader
    # never sees a half-written file.
    with open(os.path.join(BUILD_DIR, f"{name}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        stamp = " ".join(flags)
        if _is_fresh(lib_path, sources, stamp, headers):
            return lib_path
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        exe = compiler()
        cmd = [exe, *flags, "-o", tmp, *sources]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        with open(os.path.join(BUILD_DIR, f"lib{name}.log"), "w") as log:
            log.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise RuntimeError(
                f"{os.path.basename(exe)} failed (exit {proc.returncode}) "
                f"building {name}:\n{proc.stderr[-4000:]}")
        os.replace(tmp, lib_path)
        with open(f"{lib_path[:-3]}.flags", "w") as fh:
            fh.write(stamp)
    return lib_path


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load the library ``name`` of ``LIBRARIES``.
    Cached per process; different libraries build concurrently from
    different threads."""
    sources, flags = LIBRARIES[name]
    with _LOCK:
        name_lock = _NAME_LOCKS.setdefault(name, threading.Lock())
    with name_lock:
        lib = _LIBS.get(name)
        if lib is None:
            paths = [os.path.join(CSRC_DIR, s) for s in sources]
            lib = ctypes.CDLL(build_library(
                name, nvcc_path, [*NVCC_FLAGS, *flags], paths))
            _LIBS[name] = lib
        return lib


def bind(lib: ctypes.CDLL, error: str, signatures: dict) -> ctypes.CDLL:
    """``lib`` with each C function of ``signatures`` ({name: argtypes})
    bound to return an ``int``, 0 for success, and ``error`` (``const char
    *(int)``, the text of such an int) bound as ``lib.error_string``, which
    ``check`` reads."""
    for fn, argtypes in signatures.items():
        c_fn = getattr(lib, fn)
        c_fn.argtypes, c_fn.restype = argtypes, ctypes.c_int
    c_error = getattr(lib, error)
    c_error.argtypes, c_error.restype = [ctypes.c_int], ctypes.c_char_p
    lib.error_string = c_error
    return lib


def device_index(device) -> int:
    """The CUDA index that a kernel of ``device`` runs on: the device's own,
    else the calling thread's current device."""
    if not isinstance(device, torch.device):
        device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the port's kernels run on cuda, not {device}")
    return (torch.cuda.current_device() if device.index is None
            else device.index)


def check(lib: ctypes.CDLL, fn: str, err: int) -> None:
    """Raise ``RuntimeError`` with ``lib``'s text of ``err``, the return of
    its C function ``fn``, unless it is 0."""
    if err != 0:
        raise RuntimeError(f"{fn} failed: {lib.error_string(err).decode()}")


def launch(lib: ctypes.CDLL, fn: str, args, device,
           counter: tuple[str, str]) -> None:
    """Call ``lib``'s C function ``fn`` with ``args``, ``device``'s index
    (``device_index``) and the handle of its current stream; raise on a
    non-zero return (``check``); count one launch in ``counter``, a
    (module name, int attribute) pair, or tally it while this thread
    captures a graph (``tallied``)."""
    check(lib, fn, getattr(lib, fn)(
        *args, device_index(device),
        torch.cuda.current_stream(device).cuda_stream))
    tally = _CAPTURE.counts
    if tally is not None:
        tally[counter] = tally.get(counter, 0) + 1
        return
    module, attr = counter
    owner = sys.modules[module]
    with _COUNT_LOCK:
        setattr(owner, attr, getattr(owner, attr) + 1)


@contextlib.contextmanager
def tallied():
    """Inside, this thread's launches go to the dict it yields ({counter:
    launches}) instead of the counters: a graph's capture, whose launches
    run at its replays."""
    outer = _CAPTURE.counts
    _CAPTURE.counts = {}
    try:
        yield _CAPTURE.counts
    finally:
        _CAPTURE.counts = outer


def add_launches(tally: dict, times: int = 1) -> None:
    """Count ``times`` the launches of ``tally`` (a replayed graph's)."""
    with _COUNT_LOCK:
        for (module, attr), n in tally.items():
            owner = sys.modules[module]
            setattr(owner, attr, getattr(owner, attr) + n * times)
