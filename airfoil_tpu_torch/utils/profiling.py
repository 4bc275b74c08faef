"""Per-stage timing utilities: port of ``airfoil_tpu/utils/profiling.py``.

A stage timer that waits for the device before and after the block it
times (``torch.cuda.synchronize``, where the reference blocks on a JAX
array), a forced fetch that waits for a tensor's device, a
``torch.profiler`` trace around any block, written as a Chrome trace, and
``span``, a named range on that trace that costs one flag read while no
profiler runs.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from dataclasses import dataclass, field

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.utils._pytree import tree_leaves

__all__ = ["Timings", "stage_timer", "profile_trace", "device_sync", "span"]


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


class span:
    """``with span(name):`` marks a block as a range named ``name`` on a
    running ``torch.profiler`` trace, on the profiler's host timeline and
    so in the clock of its CUDA device records. The profiler is the one
    sink: ``profile_trace`` and any other ``torch.profiler`` run record
    the spans, of every thread where the profiler records all threads.

    The range is a function-scope record
    (``torch._C._profiler._RecordFunctionFast``), a host record alone.
    ``record_function`` opens a user annotation instead, which the
    profiler also draws on the device's timeline over the kernels it
    launched, where it would read as device work.

    With no profiler running, entering and leaving read one module flag,
    ``torch.autograd.profiler._is_profiler_enabled``, and do nothing
    else: no torch operation, clock reading or record. That flag is set
    and cleared by every profiler's start and stop and reads the same in
    every thread (``torch.autograd._profiler_enabled()`` is thread-local:
    it reads False in a request thread while an all-threads profiler
    runs). A span entered while no profiler ran stays unrecorded though
    one starts before it ends.
    """

    __slots__ = ("name", "_range")

    def __init__(self, name: str):
        self.name = name
        self._range = None

    def __enter__(self):
        if _autograd_profiler._is_profiler_enabled:
            self._range = torch._C._profiler._RecordFunctionFast(self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc):
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        return False


def _profile(activities):
    """A ``torch.profiler.profile`` of every thread of the process, threads
    started before it included, where this torch can; else of the threads
    the profiler sees by itself."""
    from torch.profiler import profile

    try:
        from torch._C._profiler import _ExperimentalConfig
        return profile(activities=activities, experimental_config=(
            _ExperimentalConfig(profile_all_threads=True)))
    except (ImportError, TypeError):
        return profile(activities=activities)


@contextlib.contextmanager
def profile_trace(log_dir: str | None = None):
    """``torch.profiler`` trace of a block (the CPU, and the card where there
    is one), exported as a Chrome trace ``trace_<pid>_<ns>.json`` into
    ``log_dir`` (default: ``airfoil_tpu_torch_trace`` in the temporary
    directory). Every thread is traced, those started before the block too
    (a running server's request threads and their ``span``s). Yields
    ``log_dir``."""
    from torch.profiler import ProfilerActivity

    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "airfoil_tpu_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = _profile(activities)
    prof.start()
    try:
        yield log_dir
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
