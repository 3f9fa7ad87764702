"""A traced segment: a few requests or steps under ``torch.profiler``,
reduced to the summary that the per-layer metrics read.

The reduction reads the profiler's raw (kineto) events, as the port's
``utils/profiling.trace_events`` does (PyTorch's own reading takes ten times
as long): device activities (kernels, copies and fills), the runtime calls
that launched them (a device activity's correlation id equals its
launch's) and the ``record_function`` ranges on the host (the benchmark's
spans and the port's own). A device activity belongs to every range that
was open on the host when it was launched: the autograd engine launches the
backward's kernels from its own thread while the main thread sits inside
the ``backward`` range, so ranges are matched by time, not by thread.

The summary holds, over the segment: its host-clock length (``window_s``),
the union of device activity (``busy_s``, the ``_union`` of the port's
``summarize_trace``), the kernel launches, the device seconds of the
kernels launched inside each range and their count, the host seconds of each range, the
device seconds of each kernel by name, and the ``breakdown`` the result
line carries (device operations and idle gaps, each named by the innermost
range open on the host).
"""

from __future__ import annotations

import bisect
import collections
import time
from typing import Callable, Dict, List, Tuple

import torch

TOP = 10
_COPIES = ("Memcpy", "Memset")


def _union(intervals) -> Tuple[float, List[Tuple[float, float]]]:
    """(length of the union of (start, stop) intervals, the merged intervals)."""
    merged: List[List[float]] = []
    for start, stop in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], stop)
        else:
            merged.append([start, stop])
    return sum(b - a for a, b in merged), [(a, b) for a, b in merged]


class _Ranges:
    """The host ranges of a trace, for asking which were open at a time."""

    def __init__(self, ranges: List[Tuple[str, float, float]]):
        self.ranges = sorted(ranges, key=lambda r: (r[1], -r[2]))
        self.starts = [r[1] for r in self.ranges]
        by_name = collections.defaultdict(list)
        for name, start, end in self.ranges:
            by_name[name].append((start, end))
        self.by_name = {n: ([s for s, _ in v], [e for _, e in v]) for n, v in by_name.items()}

    def open_at(self, name: str, t: float) -> bool:
        starts, ends = self.by_name.get(name, ((), ()))
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and ends[i] >= t      # ranges of one name follow one another

    def innermost(self, t: float) -> str:
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0:
            name, start, end = self.ranges[i]
            if end >= t:
                return name
            i -= 1
        return "outside spans"


def _events(prof):
    """(device activities [(name, start_us, end_us, launch_us, is_kernel)],
    host ranges [(name, start_us, end_us)]) of a finished profile."""
    from torch.autograd import DeviceType
    device, launches, ranges = [], {}, []
    for r in prof.profiler.kineto_results.events():
        if r.is_async() or r.start_thread_id() != r.end_thread_id():
            continue
        start, end = r.start_ns() / 1e3, r.end_ns() / 1e3
        if r.device_type() != DeviceType.CPU:
            if not r.is_user_annotation():
                device.append((r.name(), start, end, r.correlation_id()))
        elif r.is_user_annotation():
            ranges.append((r.name(), start, end))
        elif r.name().startswith("cu"):
            launches[r.correlation_id()] = start
    acts = [(name, start, end, launches.get(corr, start), not name.startswith(_COPIES))
            for name, start, end, corr in device]
    return acts, ranges


def summarize(prof, window_s: float, units: int) -> Dict:
    """The summary of a finished profile over a segment of ``units``
    requests or steps that took ``window_s`` on the host clock."""
    acts, ranges = _events(prof)
    spans = _Ranges(ranges)
    names = sorted(spans.by_name)
    span_device_s = dict.fromkeys(names, 0.0)
    span_kernels = dict.fromkeys(names, 0)
    kernel_s = collections.defaultdict(float)
    ops = collections.defaultdict(float)
    for name, start, end, launch, is_kernel in acts:
        dur = (end - start) / 1e6
        if is_kernel:
            kernel_s[name] += dur
            for span in names:
                if spans.open_at(span, launch):
                    span_device_s[span] += dur
                    span_kernels[span] += 1
        ops[f"{spans.innermost(launch)}: {name[:120]}"] += dur
    busy_us, merged = _union((a[1], a[2]) for a in acts)
    gaps = collections.defaultdict(float)
    for (_, stop), (nxt, _) in zip(merged, merged[1:]):
        gaps[spans.innermost(stop)] += (nxt - stop) / 1e6
    span_host_s = {n: sum(e - s for s, e in zip(*spans.by_name[n])) / 1e6 for n in names}
    span_count = {n: len(spans.by_name[n][0]) for n in names}
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {"units": units, "window_s": window_s, "busy_s": busy_us / 1e6,
            "launches": sum(a[4] for a in acts), "span_device_s": span_device_s,
            "span_kernels": span_kernels, "span_host_s": span_host_s,
            "span_count": span_count, "kernel_s": dict(kernel_s),
            "breakdown": {"device_ops": top(ops), "idle_gaps": top(gaps)}}


def traced_segment(run: Callable[[], int], device: torch.device) -> Dict:
    """``run()`` (which returns the requests or steps it made) under
    ``torch.profiler``, the device synchronised before and after, reduced
    by ``summarize``."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    _sync(device)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        units = run()
        _sync(device)
        window_s = time.perf_counter() - t0
    return summarize(prof, window_s, units)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
