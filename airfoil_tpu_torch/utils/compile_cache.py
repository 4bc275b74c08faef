"""Build the port's compiled artefacts ahead of the first request.

Port of ``airfoil_tpu/utils/compile_cache.py``. The reference turns on
JAX's persistent compile cache, so that a restarted server (or the bench
and parity CLIs) does not recompile its solver programs. The port's
persistent compiled artefacts are its CUDA kernel libraries,
``cuda_build.LIBRARIES`` (each bound by the layer that owns its kernels:
``lbm.kernel``, ``viscous.kernel``, ``api.field_b64``), which
``cuda_build`` keeps in ``airfoil_tpu_torch/_build/`` (git-ignored) and
rebuilds only when a source or the nvcc flags change: this module builds
them all now, in parallel, not at their first use. The Newton solve's
other compiled programs, its CUDA graphs (``viscous.graphs``), live in
the process; ``polar.sweep.warm_polar_kernels`` captures them.

The reference needs a per-host cache for XLA:CPU, whose artefacts are
specialised to the build host's CPU features. The port needs no such
split: its libraries hold ``sm_90a`` device code, which runs on any
Hopper card, and host code that nvcc's host compiler builds without
host-specific tuning (no ``-march=native``), and they sit in the checkout
that built them, so ``per_host`` changes nothing.

Best-effort, as the reference's: a failed build logs a warning (without a
CUDA toolkit, on a CPU machine, every build fails), and the kernel's own
first call then raises with the compiler's output.
"""

from __future__ import annotations

import hashlib
import logging
import platform
from concurrent.futures import ThreadPoolExecutor

from airfoil_tpu_torch import cuda_build

logger = logging.getLogger(__name__)

__all__ = ["enable_persistent_compile_cache", "host_fingerprint"]


def host_fingerprint() -> str:
    """Short stable id of this host's CPU feature set (for cache keying)."""
    feats = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    feats = " ".join(sorted(line.split(":", 1)[1].split()))
                    break
    except OSError:
        feats = platform.machine() + platform.processor()
    return hashlib.sha256(feats.encode()).hexdigest()[:12]


def _build_libraries() -> None:
    """Build (where stale) and load every library of
    ``cuda_build.LIBRARIES``, one nvcc each, started together; raises the
    first failure."""
    names = list(cuda_build.LIBRARIES)
    with ThreadPoolExecutor(len(names)) as pool:
        for fut in [pool.submit(cuda_build.load_library, n) for n in names]:
            fut.result()


def enable_persistent_compile_cache(per_host: bool = False) -> None:
    """Build every kernel library into ``cuda_build.BUILD_DIR`` now.

    Best-effort: a failure is logged, not raised. ``per_host`` is the
    reference's argument and changes nothing here (see the module
    docstring)."""
    try:
        _build_libraries()
    except Exception as e:           # noqa: BLE001 - best-effort, as the reference
        logger.warning("kernel libraries not built ahead: %s", e)
