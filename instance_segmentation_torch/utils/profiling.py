"""Profiling hooks.

Counterpart of ``instance_segmentation_tpu/utils/profiling.py``: a trace
context for device timelines and a host step timer. ``device_trace``
records a ``torch.profiler`` trace of CPU activity, and of CUDA activity
where CUDA is available, into ``logdir`` as a Chrome trace
(``trace.json``, viewable in Perfetto or ``chrome://tracing``), or does
nothing when ``logdir`` is empty. ``StepTimer.summary()`` has the JAX
timer's keys and percentiles.
"""

from __future__ import annotations

import contextlib
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
