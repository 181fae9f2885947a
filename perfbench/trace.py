"""A torch.profiler trace of a short traced window, read into device time.

The arithmetic follows ``chip_smoke.device_kernel_times``: every device
event (kernel, copy, memset) counts, except the device-side ranges of
record_function annotations, which carry the name of a host event and
overlap the kernels they hold. Busy time is the union of the device
events' intervals; an idle gap is a stretch of the window with no device
event, named by the innermost host event running at its middle.

The profiler's own host work (it records every operator and launch)
stretches the profiled window: on a step of some 4,400 launches by a
fifth or more. So the window that rates and the idle share are taken over is an
untraced pass of the same amount of work, run just before the profiled
one, after a third pass that warms everything up (the allocator's pool
grows over the first steps after set-up); the busy time is the profiled
pass's.
"""

import bisect
import re
import time
from collections import defaultdict
from typing import Callable, List, Optional, Tuple

import torch

TOP = 10           # entries of each breakdown list
GAPS_NAMED = 1000  # the longest gaps are named by their host event
SCAN = 4000        # host events looked back over to name one gap


class Trace:
    """Device and host events of one traced window, times in seconds from
    the profiler's start."""

    def __init__(self, prof, window_s: float, traced_s: float):
        cuda = torch.autograd.DeviceType.CUDA
        events = prof.events()
        host = [e for e in events if e.device_type != cuda]
        host_names = {e.name for e in host}
        self.device = sorted(
            (e.time_range.start * 1e-6, e.time_range.end * 1e-6, e.name)
            for e in events
            if e.device_type == cuda and e.name not in host_names)
        self.host = sorted((e.time_range.start * 1e-6,
                            e.time_range.end * 1e-6, e.name) for e in host)
        # the untraced pass's length, and the profiled pass's
        self.window_s, self.traced_s = window_s, traced_s

    def busy_intervals(self) -> List[Tuple[float, float]]:
        merged: List[List[float]] = []
        for start, end, _ in self.device:
            if merged and start <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], end)
            else:
                merged.append([start, end])
        return [(a, b) for a, b in merged]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def launches(self) -> int:
        return len(self.device)

    def kernel_seconds(self, pattern: str) -> Tuple[int, float]:
        """(launches, device seconds) of the device events whose name
        matches the regular expression ``pattern``."""
        rx = re.compile(pattern)
        times = [end - start for start, end, name in self.device
                 if rx.search(name)]
        return len(times), sum(times)

    def device_ops(self) -> List[list]:
        """The device operations that took the most time, summed by name."""
        total: dict = defaultdict(float)
        for start, end, name in self.device:
            total[name[:160]] += end - start
        return [[k, v] for k, v in
                sorted(total.items(), key=lambda kv: -kv[1])[:TOP]]

    def idle_gaps(self) -> List[list]:
        """Idle time summed by what the host was doing, over the longest
        gaps of the window (before the first device event, between
        events, after the last)."""
        busy = self.busy_intervals()
        if not busy or not self.host:
            return []
        lo = min(self.host[0][0], busy[0][0])
        hi = max(max(end for _, end, _ in self.host), busy[-1][1])
        edges = [lo] + [x for pair in busy for x in pair] + [hi]
        gaps = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1])
                       for i in range(0, len(edges), 2)
                       if edges[i + 1] > edges[i]), reverse=True)
        starts = [start for start, _, _ in self.host]
        named: dict = defaultdict(float)
        for length, a, b in gaps[:GAPS_NAMED]:
            named[self._host_at((a + b) / 2, starts)] += length
        return [[k, v] for k, v in
                sorted(named.items(), key=lambda kv: -kv[1])[:TOP]]

    def _host_at(self, t: float, starts: List[float]) -> str:
        """The innermost host event running at ``t``: of those that cover
        it, the one that started last."""
        i = bisect.bisect_right(starts, t)
        for j in range(i - 1, max(i - 1 - SCAN, -1), -1):
            start, end, name = self.host[j]
            if end >= t:
                return name
        return "host code outside any traced event"


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Phases:
    """Seconds of each named phase of a set-up on the host clock, each
    ended by a synchronisation, for the record on standard error."""

    def __init__(self, device: torch.device):
        self.device, self.t, self.done = device, time.perf_counter(), []

    def __call__(self, name: str) -> None:
        sync(self.device)
        now = time.perf_counter()
        self.done.append((name, now - self.t))
        self.t = now

    def text(self) -> str:
        return ", ".join(f"{name} {s:.3f} s" for name, s in self.done)


def reset_peak(device: torch.device) -> None:
    """Start the peak-memory reading here: what the benchmark allocated to
    make its inputs is not the program's."""
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def timed(fn: Callable[[], object], device: torch.device) -> float:
    """Seconds of ``fn`` on the host clock between two synchronisations."""
    sync(device)
    t0 = time.perf_counter()
    fn()
    sync(device)
    return time.perf_counter() - t0


def traced(fn: Callable[[], object], device: torch.device) -> Trace:
    """Run ``fn`` three times, each pass between two synchronisations: to
    warm up, on the host clock alone, then under torch.profiler (host
    and, on the card, device activity). ``fn`` does the same amount of
    work in each pass. The trace's window is the second pass's length,
    its events the third's."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    timed(fn, device)
    window_s = timed(fn, device)
    with profile(activities=acts) as prof:
        traced_s = timed(fn, device)
    return Trace(prof, window_s, traced_s)


def share(part: float, whole: float) -> Optional[float]:
    """``part`` as a percentage of ``whole``, or None without a whole."""
    return 100.0 * part / whole if whole > 0 else None
