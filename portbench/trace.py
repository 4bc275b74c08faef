"""The traced slice of a window: a ``torch.profiler`` trace of the card and
the host, reduced to device intervals, busy time, the device operations
that took longest and the longest idle gaps by what the host was doing.

The profiler runs from ``start`` to ``stop``; the slice it is read over is
the ``portbench.slice`` annotation opened ``pad`` seconds after the start
and closed ``pad`` seconds before the stop, so that records the profiler
places near its own edges fall outside it.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

# The harness's own annotations start so; the profiler also places them on
# the device's timeline, where they are not device work.
MARK = "portbench: "
SLICE = MARK + "slice"


@dataclass
class Trace:
    begin_us: float
    end_us: float
    device: list = field(default_factory=list)   # (start us, end us, name)
    host: list = field(default_factory=list)     # (start us, end us, name)

    @property
    def window_s(self) -> float:
        return (self.end_us - self.begin_us) / 1e6

    def clipped(self):
        """Device intervals cut to the slice."""
        for s, e, name in self.device:
            s, e = max(s, self.begin_us), min(e, self.end_us)
            if e > s:
                yield s, e, name

    def busy_intervals(self) -> list:
        """The union of the device intervals in the slice, in order."""
        merged = []
        for s, e, _ in sorted(self.clipped()):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def device_ops(self, top: int = 10) -> list:
        """[name, seconds] of the device operations that took most time."""
        total: dict[str, float] = {}
        for s, e, name in self.clipped():
            total[name] = total.get(name, 0.0) + (e - s) / 1e6
        return [[n, t] for n, t in
                sorted(total.items(), key=lambda kv: -kv[1])[:top]]

    def kernel_us(self, part: str) -> list:
        """Durations of the device operations whose name holds ``part``."""
        return [e - s for s, e, name in self.device if part in name]

    def idle_gaps(self, top: int = 10) -> list:
        """[what the host was doing, seconds] of the longest gaps with no
        device operation: the innermost host operation that spans the
        gap's middle."""
        edges = [self.begin_us]
        for s, e in self.busy_intervals():
            edges += [s, e]
        edges.append(self.end_us)
        gaps = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1])
                       for i in range(0, len(edges), 2)),
                      key=lambda g: (-g[0], g[1]))[:top]
        out = []
        for length, s, e in gaps:
            mid = 0.5 * (s + e)
            spans = [(he - hs, name) for hs, he, name in self.host
                     if hs <= mid <= he and name != SLICE]
            label = (min(spans)[1].removeprefix(MARK) if spans
                     else "host outside any traced operation")
            out.append([label, length / 1e6])
        return out


def reduce(prof) -> Trace | None:
    """The ``Trace`` of a stopped profiler, None when the slice's
    annotation is missing. Device records of the harness's annotations
    are left out."""
    from torch.autograd import DeviceType

    device, host, bounds = [], [], None
    for ev in prof.events():
        span = (ev.time_range.start, ev.time_range.end, ev.name)
        if ev.device_type == DeviceType.CUDA:
            if not ev.name.startswith(MARK):
                device.append(span)
        elif ev.name == SLICE:
            bounds = span[:2]
        else:
            host.append(span)
    if bounds is None:
        return None
    return Trace(bounds[0], bounds[1], device, host)


def _profile():
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    try:        # the server's thread too, where the profiler can see it
        from torch._C._profiler import _ExperimentalConfig
        return profile(activities=activities, experimental_config=(
            _ExperimentalConfig(profile_all_threads=True)))
    except (ImportError, TypeError):
        return profile(activities=activities)


def warm():
    """Start and stop a profile once, so that a run's first start (which
    loads the tracer) falls into set-up and not into the window."""
    prof = _profile()
    prof.start()
    prof.stop()


class Profiler:
    """Start, mark and stop a profile at times of a window's clock: call
    ``tick(t)`` between requests. The slice's moments are counted from the
    moment the profile has started."""

    def __init__(self, start: float, seconds: float, pad: float):
        self.start, self.seconds, self.pad = start, seconds, pad
        self.moments = (start,)
        self.phase = 0
        self.prof = self.mark = None
        self.trace = None

    def tick(self, t: float):
        import torch

        while self.phase < 4 and t >= self.moments[self.phase]:
            if self.phase == 0:
                clock = time.perf_counter()
                self.prof = _profile()
                self.prof.start()
                begun = t + time.perf_counter() - clock
                self.moments = (self.start, begun + self.pad,
                                begun + self.seconds - self.pad,
                                begun + self.seconds)
            elif self.phase == 1:
                self.mark = torch.autograd.profiler.record_function(SLICE)
                self.mark.__enter__()
            elif self.phase == 2:
                self.mark.__exit__(None, None, None)
            else:
                self.finish()
                break
            self.phase += 1

    def finish(self):
        """Stop the profile and reduce it (a window that ends before the
        slice closes ends the slice with it)."""
        if self.prof is None:
            return
        if self.phase == 2:
            self.mark.__exit__(None, None, None)
        self.prof.stop()
        self.trace = reduce(self.prof)
        self.prof = None
        self.phase = 4
