"""Profiling hooks.

Counterpart of ``instance_segmentation_tpu/utils/profiling.py``: a trace
context for device timelines and a host step timer. ``device_trace``
records a ``torch.profiler`` trace of CPU activity, and of CUDA activity
where CUDA is available, into ``logdir`` as a Chrome trace
(``trace.json``, viewable in Perfetto or ``chrome://tracing``), or does
nothing when ``logdir`` is empty. ``StepTimer.summary()`` has the JAX
timer's keys and percentiles.

The rest serves the port's profilers (``tools/profile_*.py``,
``tools/bench_train_data.py``): the device a ``--device`` flag names (the
card, or the CPU only when asked), synchronised host times and their
spread, and a traced window summarized by device kernel (what the JAX
package's ``tools/parse_trace.py`` does with a JAX trace).
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import time
from typing import Iterator, Optional

import numpy as np
import torch


@contextlib.contextmanager
def device_trace(logdir: Optional[str]) -> Iterator[None]:
    """Record a profile of the enclosed code into ``logdir`` when set."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class StepTimer:
    """Accumulates host-side step latencies with a percentile summary."""

    def __init__(self):
        self._times = []
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self):
        if self._t0 is not None:
            self._times.append(time.perf_counter() - self._t0)
            self._t0 = None

    def summary(self) -> dict:
        if not self._times:
            return {}
        a = np.asarray(self._times)
        return {"mean_s": float(a.mean()), "p50_s": float(np.percentile(a, 50)),
                "p95_s": float(np.percentile(a, 95)), "n": len(a)}


# ---------------------------------------------------------------------------
# The profilers' common parts (``instance_segmentation_torch/tools/profile_*``)
# ---------------------------------------------------------------------------

# device activity in a chrome trace: kernels, copies and fills
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def resolve_device(name: str) -> torch.device:
    """A tool's ``--device``: "cuda" is the card or a RuntimeError (no
    fallback), "cpu" the CPU."""
    if name == "cpu":
        return torch.device("cpu")
    from instance_segmentation_torch.device import require_cuda
    return require_cuda()


def device_label(device: torch.device) -> str:
    """What a measurement ran on: nvidia-smi's name and power limit of the
    card, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    from instance_segmentation_torch.device import nvidia_smi_name_power
    return nvidia_smi_name_power()


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def synced_ms(fn, iters: int, device: torch.device) -> list:
    """Host ms of each of ``iters`` calls of ``fn`` after one warm-up call,
    the device synchronised before and after each."""
    fn()
    times = []
    for _ in range(iters):
        sync(device)
        t0 = time.perf_counter()
        fn()
        sync(device)
        times.append(1e3 * (time.perf_counter() - t0))
    return times


def top_percentile(n: int) -> int:
    """The highest of the 99th, 95th, 90th and 75th percentiles that ``n``
    samples support (n >= 100 / (100 - p)); 50 below four samples."""
    for p in (99, 95, 90, 75):
        if n * (100 - p) >= 100:
            return p
    return 50


def spread(ms) -> dict:
    """{"median", "p<N>" (``top_percentile``), "n", "ms"} of a sample."""
    p = top_percentile(len(ms))
    return {"median": float(np.median(ms)), f"p{p}": float(np.percentile(ms, p)),
            "n": len(ms), "ms": [float(t) for t in ms]}


def spread_text(s: dict) -> str:
    p = next(k for k in s if k.startswith("p"))
    return f"{s['median']:.3f} ms ({p} {s[p]:.3f}, n {s['n']})"


def summarize_trace(path: str, window_ms: float, top: int = 10) -> dict:
    """A ``torch.profiler`` chrome trace aggregated by device kernel: the
    ``top`` kernels by total device time (ms, launches, share of the
    window), all kernel launches, the device's busy time (the union of its
    kernel, copy and fill intervals) and its idle share of the ``window_ms``
    that the trace covers. With no device activity (a CPU run) the launches
    and shares are None."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    device = [e for e in events if e.get("ph") == "X" and e.get("cat") in _DEVICE_CATS]
    if not device:
        return {"window_ms": window_ms, "launches": None, "kernels": None, "busy_ms": None,
                "idle_share": None, "top": []}
    by_name = {}
    for e in device:
        if e["cat"] == "kernel":
            total, count = by_name.get(e["name"], (0.0, 0))
            by_name[e["name"]] = (total + e["dur"] / 1e3, count + 1)
    busy, end = 0.0, -math.inf
    for start, stop in sorted((e["ts"], e["ts"] + e["dur"]) for e in device):
        if start > end:
            busy, end = busy + stop - start, stop
        elif stop > end:
            busy, end = busy + stop - end, stop
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {"window_ms": window_ms, "launches": sum(c for _, c in by_name.values()),
            "kernels": len(by_name), "busy_ms": busy / 1e3,
            "idle_share": max(0.0, 1.0 - busy / 1e3 / window_ms),
            "top": [{"name": name, "ms": ms, "launches": count, "share": ms / window_ms}
                    for name, (ms, count) in ranked]}


def traced(fn, device: torch.device, path: str, top: int = 10) -> dict:
    """One call of ``fn`` under ``torch.profiler`` (CPU activity, and CUDA
    activity on a card), the device synchronised before and after it; the
    chrome trace is written to ``path`` and summarized
    (``summarize_trace``) over the synchronised window."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    sync(device)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        sync(device)
        window_ms = 1e3 * (time.perf_counter() - t0)
    prof.export_chrome_trace(path)
    return summarize_trace(path, window_ms, top)


def trace_lines(summary: dict, label: str) -> list:
    """The printed form of a ``summarize_trace`` summary: its idle share and
    one line per top kernel."""
    if summary["launches"] is None:
        return [f"trace {label}: no device activity in the window ({summary['window_ms']:.3f} "
                f"ms; a CPU run)"]
    lines = [f"trace {label}: window {summary['window_ms']:.3f} ms (the tracer slows the "
             f"host), device busy {summary['busy_ms']:.3f} ms, idle share "
             f"{summary['idle_share']:.3f}, {summary['launches']} kernel launches of "
             f"{summary['kernels']} kernels"]
    lines += [f"  {k['ms']:9.3f} ms {k['launches']:6d} launches {k['share']:7.2%}  "
              f"{k['name'][:110]}" for k in summary["top"]]
    return lines
