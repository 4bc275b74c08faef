"""Per-stage timing utilities: port of ``airfoil_tpu/utils/profiling.py``.

A stage timer that waits for the device before and after the block it
times (``torch.cuda.synchronize``, where the reference blocks on a JAX
array), a forced fetch that waits for a tensor's device, and a
``torch.profiler`` trace around any block, written as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from dataclasses import dataclass, field

import torch
from torch.utils._pytree import tree_leaves

__all__ = ["Timings", "stage_timer", "profile_trace", "device_sync"]


def _sync(device=None):
    """Wait for every queued kernel of ``device`` (the current CUDA device
    when ``None``); nothing to wait for without a CUDA device."""
    if torch.cuda.is_available():
        torch.cuda.synchronize(device)


def device_sync(x=None) -> float:
    """Force completion of the device work behind ``x`` and return the
    float of its first leaf's first element (0.0 without leaves), as the
    reference does. A CUDA leaf's device is synchronised before the read;
    with ``x`` ``None`` the current CUDA device is, where there is one. A
    CPU tensor is only read."""
    if x is None:
        _sync()
        return 0.0
    leaves = tree_leaves(x)
    if not leaves:
        return 0.0
    first = torch.as_tensor(leaves[0])
    if first.is_cuda:
        _sync(first.device)
    return float(first.reshape(-1)[:1].sum())


@dataclass
class Timings:
    stages: dict = field(default_factory=dict)

    def record(self, name: str, seconds: float):
        self.stages[name] = self.stages.get(name, 0.0) + seconds

    def as_dict(self, ndigits: int = 4) -> dict:
        return {k: round(v, ndigits) for k, v in self.stages.items()}


@contextlib.contextmanager
def stage_timer(timings: Timings, name: str, sync: bool = True):
    """Time a block on the host clock; with ``sync`` wait for the card's
    queued work before the clock starts and before it stops."""
    if sync:
        _sync()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync:
            _sync()
        timings.record(name, time.perf_counter() - t0)


@contextlib.contextmanager
def profile_trace(log_dir: str | None = None):
    """``torch.profiler`` trace of a block (the CPU, and the card where there
    is one), exported as a Chrome trace ``trace_<pid>_<ns>.json`` into
    ``log_dir`` (default: ``airfoil_tpu_torch_trace`` in the temporary
    directory). Yields ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "airfoil_tpu_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield log_dir
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
