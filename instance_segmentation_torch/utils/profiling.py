"""Profiling hooks.

``span(name)`` is the port's one way to open a ``torch.profiler`` range:
the train step's stages, the serving path's stages and host waits
(``serve.py``, ``ops/decode.py``) and the roofline's block ranges go
through it. A range is recorded on the profiler's clock beside the device
activity it launches, and while no profiler records ``span`` hands out one
shared no-op context, so that an unrecorded range costs the read of a flag.

The rest serves the port's profilers (``tools/profile_*.py``,
``tools/bench_train_data.py``, ``tools/roofline.py``): the device a
``--device`` flag names (the card, or the CPU only when asked),
synchronised host times and their spread, and a traced window summarized
by device kernel (what the JAX package's ``tools/parse_trace.py`` does with
a JAX trace).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import math
import os
import re
import time
from typing import Iterator, Optional

import numpy as np
import torch

# what ``span`` returns while no profiler records: one context, shared
NO_SPAN = contextlib.nullcontext()


def tracing() -> bool:
    """Whether a ``torch.profiler`` records (PyTorch's own module flag)."""
    return torch.autograd.profiler._is_profiler_enabled


def span(name: str):
    """A ``record_function`` range named ``name`` while a profiler records,
    else a shared no-op context. A ``record_function`` entered and left with
    no profiler still costs ~14 us of host time; the flag's read, well under
    one."""
    if torch.autograd.profiler._is_profiler_enabled:
        return torch.autograd.profiler.record_function(name)
    return NO_SPAN


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


def _union(intervals) -> float:
    """The length of the union of (start, stop) intervals."""
    busy, end = 0.0, -math.inf
    for start, stop in sorted(intervals):
        if start > end:
            busy, end = busy + stop - start, stop
        elif stop > end:
            busy, end = busy + stop - end, stop
    return busy


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
    busy = _union((e["ts"], e["ts"] + e["dur"]) for e in device)
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


# ---------------------------------------------------------------------------
# The roofline (``tools/roofline.py``): a trace's device kernels joined to the
# counted bytes and FLOPs of the operations that launched them
# ---------------------------------------------------------------------------

# the model's blocks (attribute of ``EfficientSeg``) and the stage spans
# (``training/train_step.py``'s; "decode" is ``ops/decode.decode_output``'s)
# that a kernel's block is read from; "input" is the model outside its blocks
MODEL_BLOCKS = {"backbone": "backbone_net.model", "bifpn": "bifpn", "regressor": "regressor",
                "classifier": "classifier", "unet": "kp_header"}
STAGES = ("targets", "loss", "optimizer", "decode")
_BLOCK = "block:"
_BACKWARD_FUNCTION = 1          # RecordScope::BACKWARD_FUNCTION: an autograd node's range
_NODE = "autograd::engine::evaluate_function"   # the engine's range around a node, beside it
_DISPATCHED = "PythonDispatchMode"     # PyTorch's range around a dispatch mode's handler


@contextlib.contextmanager
def block_ranges(model: torch.nn.Module) -> Iterator[None]:
    """A ``span`` "block:<name>" around every call of each of ``model``'s
    blocks and "block:input" around the model's own (forward hooks, removed
    on exit). A block's recompute under remat, which stops early by an
    exception, closes its range too."""
    handles = []

    def add(module: torch.nn.Module, name: str) -> None:
        open_ranges = []

        def enter(mod, args):
            rf = span(_BLOCK + name)
            rf.__enter__()
            open_ranges.append(rf)

        def leave(mod, args, out):
            open_ranges.pop().__exit__(None, None, None)

        handles.append(module.register_forward_pre_hook(enter))
        handles.append(module.register_forward_hook(leave, always_call=True))

    add(model, "input")
    for name, path in MODEL_BLOCKS.items():
        add(model.get_submodule(path), name)
    try:
        yield
    finally:
        for h in handles:
            h.remove()


@dataclasses.dataclass(eq=False)
class TraceEvent:
    """One event of a ``torch.profiler`` trace: a host range (an operation,
    a ``record_function`` range, an autograd node, a runtime call) or a
    device activity; times in us; ``id`` is the correlation id (a device
    activity's equals its launch's); ``parent`` is the innermost host event
    of its thread around it."""
    name: str
    start: float
    end: float
    device: bool = False
    thread: int = 0
    id: int = 0
    annotation: bool = False            # a record_function range, or its device span
    scope: int = 0
    sequence_nr: int = -1
    fwd_thread: int = 0
    parent: Optional["TraceEvent"] = None


def trace_events(prof) -> list:
    """The ``TraceEvent``s of a finished ``torch.profiler.profile``, read from
    its raw (kineto) events: PyTorch's own reading (``prof.events()``) takes
    ten times as long. Runtime calls (``cu*``: launches, copies, fills) carry
    the operating system's thread id; each takes the profiler's id of the
    thread that the operations its thread launched carry, as PyTorch's
    reading does, so that it nests in the ranges around it."""
    from torch.autograd import DeviceType
    events, ops, runtime = [], {}, []
    for r in prof.profiler.kineto_results.events():
        if r.is_async() or r.start_thread_id() != r.end_thread_id():
            continue
        e = TraceEvent(r.name(), r.start_ns() / 1e3, r.end_ns() / 1e3,
                       r.device_type() != DeviceType.CPU, r.start_thread_id(), r.correlation_id(),
                       r.is_user_annotation(), r.scope(), r.sequence_nr(), r.fwd_thread_id())
        events.append(e)
        if e.device:
            continue
        if e.name.startswith("cu"):
            runtime.append((e, r.linked_correlation_id()))
        else:
            ops[e.id] = e
    threads = {e.thread: ops[linked].thread for e, linked in runtime if linked in ops}
    for e, _ in runtime:
        e.thread = threads.get(e.thread, e.thread)
    by_thread = collections.defaultdict(list)
    for e in events:
        if not e.device:
            by_thread[e.thread].append(e)
    for host in by_thread.values():
        host.sort(key=lambda e: (e.start, -e.end))
        stack = []
        for e in host:
            while stack and (e.start >= stack[-1].end or e.end > stack[-1].end):
                stack.pop()
            e.parent = stack[-1] if stack else None
            stack.append(e)
    return events


def _block(event, forward_blocks: dict) -> str:
    """The block of a trace event: its innermost block range or stage range;
    inside an autograd node's range, the block of the forward operation that
    made the node (by sequence number and thread); else "backward" inside a
    node, "other" outside any."""
    e = event
    while e is not None:
        if e.name.startswith(_BLOCK):
            return e.name[len(_BLOCK):]
        if e.scope == _BACKWARD_FUNCTION or e.name.startswith(_NODE):
            return forward_blocks.get((e.sequence_nr, e.fwd_thread), "backward")
        if e.name in STAGES:
            return e.name
        e = e.parent
    return "other"


def _port_kernel(name: str) -> Optional[str]:
    """The wrapper (``kernels/bounds.py`` name) of a port's device kernel."""
    from instance_segmentation_torch.kernels.bounds import DEVICE_KERNELS
    found = re.search(r"(\w+_kernel)\b", name)
    return DEVICE_KERNELS.get(found.group(1)) if found else None


class _Row:
    """A roofline row's sums over the traced window."""

    def __init__(self):
        self.us = 0.0
        self.launches = 0
        self.execs = 0
        self.bytes = 0
        self.flops = 0
        self.bytes_ms = 0.0          # bytes over the memory rate
        self.flops_ms = 0.0          # FLOPs over their dtype's rate
        self.bound_ms = 0.0

    def add_work(self, n_bytes: int, n_flops: int, dtype: str, peaks) -> None:
        from instance_segmentation_torch.kernels.bounds import least_ms
        self.execs += 1
        self.bytes += n_bytes
        self.flops += n_flops
        self.bytes_ms += n_bytes / (peaks.bytes_per_s / 1e3)
        self.flops_ms += n_flops / (peaks.ops_per_s[dtype] / 1e3)
        self.bound_ms += least_ms(n_bytes, n_flops, dtype, peaks)[0]

    def record(self, name: str, iters: int, kernel_us: float) -> dict:
        ms = self.us / 1e3
        joined = self.execs > 0
        return {"name": name, "ms": ms / iters, "share": self.us / kernel_us if kernel_us else None,
                "launches": self.launches / iters, "execs": self.execs / iters,
                "mb_per_exec": self.bytes / self.execs / 1e6 if joined else None,
                "gbps": self.bytes / ms / 1e6 if joined and ms else None,
                "pct_hbm": 100 * self.bytes_ms / ms if joined and ms else None,
                "tflops": self.flops / ms / 1e9 if joined and ms else None,
                "pct_flops": 100 * self.flops_ms / ms if joined and ms else None,
                "bound_ms": self.bound_ms / iters if joined else None}


def roofline(events, ops, work: dict, iters: int, peaks) -> dict:
    """The roofline of ``iters`` traced calls of a step: ``events`` are the
    ``trace_events`` of the window, ``ops`` the ``utils/flops``
    counts of the same calls' operations in order (an ``OpCounter`` inside
    the profiler: a dispatch mode changes what the autograd engine runs, so
    the count and the trace must see one run), ``work`` the
    ``kernels/bounds.py`` work of each port kernel's calls in one call
    ({wrapper: [Work, ...]}), ``peaks`` the card's (``kernels/bounds.py``).

    Each device activity is joined to the runtime call that launched it (by
    correlation id), that call to the innermost operation around it that the
    count saw (the parent of a "PythonDispatchMode" range: the counter's
    dispatch mode handling it), and that one to its count by name and call order, the
    k-th such call of a name taking the k-th count of that name. A name
    called another number of times than it was counted is left unjoined. A
    port's kernel (K1-K6) is joined by its name to its wrapper's work.
    Returns per call: the device kernel time (``kernel_ms``), the device's
    busy time (the union of its activities), the joined time and its share
    of the kernel time, the sum of the joined executions' least times
    (``bound_ms``), and rows by operation (name and operand shapes; unjoined
    kernels by kernel name) and by block (``_block``), each with ms, share,
    launches, MB per execution, GB/s and its share of the memory rate,
    TFLOP/s and its share of the rate of its dtype, and the least time; the
    port's kernels by wrapper. A CPU run has no device activity: its times
    and shares are None, and only the joins of the operations are
    counted."""
    from instance_segmentation_torch.kernels.bounds import TAGS
    cpu = [e for e in events if not e.device]
    # the device's spans of the ranges (record_function) are no device work
    spans = {e.name for e in events if e.annotation}
    device = [e for e in events if e.device and e.name not in spans]
    index = {}
    for i, o in enumerate(ops):
        index.setdefault(o.name, []).append(i)
    calls = {}
    for e in sorted(cpu, key=lambda e: e.start):
        if e.name == _DISPATCHED and e.parent is not None and e.parent.name in index:
            calls.setdefault(e.parent.name, []).append(e.parent)
    joined, unjoined = {}, []
    for name in index:
        seen = calls.get(name, [])
        if len(seen) != len(index[name]):
            unjoined.append(name)
            continue
        for e, i in zip(seen, index[name]):
            joined[id(e)] = ops[i]

    def counted(e):
        """The innermost counted operation around ``e`` (or ``e``), or None."""
        while e is not None and id(e) not in joined:
            e = e.parent
        return e

    # an autograd node's sequence number is the one its forward operation
    # records last (the operations after it record the next number)
    forward_blocks = {}
    for e in sorted(cpu, key=lambda e: e.start):
        if e.sequence_nr >= 0:
            block = _block(e, {})
            if block != "backward":
                forward_blocks[(e.sequence_nr, e.thread)] = block

    by_op, by_block, by_kernel = {}, {}, {}
    matched_us = 0.0
    executed = {}                       # id(operation) -> (its count, its rows)
    kernel_blocks = {}                  # wrapper -> the block of its first launch
    # a device activity's launch: the runtime call with its correlation id
    # (``cudaLaunchKernel``, ``cuLaunchKernel``, ``cudaMemcpyAsync``, ...)
    launches = {e.id: e for e in cpu if e.name.startswith("cu")}
    for k in device:
        launch = launches.get(k.id)
        block = by_block.setdefault("(no launch)" if launch is None
                                    else _block(launch, forward_blocks), _Row())
        top = None if launch is None else counted(launch)
        count = None if top is None else joined[id(top)]
        wrapper = _port_kernel(k.name)
        if wrapper is not None:
            row = by_kernel.setdefault(wrapper, _Row())
            kernel_blocks.setdefault(wrapper, block)
        elif count is not None:
            row = by_op.setdefault(f"{count.name} {count.shapes}", _Row())
            executed[id(top)] = (count, (row, block))
        else:
            row = by_op.setdefault(f"(unjoined) {k.name}", _Row())
        us = k.end - k.start
        for r in (row, block):
            r.us += us
            r.launches += 1
        if wrapper is not None or count is not None:
            matched_us += us
    for count, rows in executed.values():
        for r in rows:
            r.add_work(count.bytes, count.flops, count.dtype or "f32", peaks)
    for wrapper, row in by_kernel.items():
        for w in work.get(wrapper, []) * iters:
            for r in (row, kernel_blocks[wrapper]):
                r.add_work(w.bytes, w.ops, "f32", peaks)

    kernel_us = sum(e.end - e.start for e in device)
    busy = _union((e.start, e.end) for e in device)
    on_device = bool(device)

    def rows(table: dict) -> list:
        return sorted((row.record(name, iters, kernel_us) for name, row in table.items()),
                      key=lambda r: -r["ms"])

    kernels = {}
    for wrapper, row in by_kernel.items():
        per_call = work.get(wrapper, [])
        kernels[wrapper] = dict(row.record(wrapper, iters, kernel_us), tag=TAGS[wrapper],
                                calls=len(per_call), bytes=[w.bytes for w in per_call],
                                ops=[w.ops for w in per_call])
    return {"kernel_ms": kernel_us / 1e3 / iters if on_device else None,
            "busy_ms": busy / 1e3 / iters if on_device else None,
            "matched_ms": matched_us / 1e3 / iters if on_device else None,
            "matched_share": matched_us / kernel_us if on_device and kernel_us else None,
            "bound_ms": (sum(r.bound_ms for r in by_op.values())
                         + sum(r.bound_ms for r in by_kernel.values())) / iters
            if on_device else None,
            "ops_counted": len(ops), "calls_joined": len(joined), "unjoined": sorted(unjoined),
            "by_op": rows({**by_op, **{f"{TAGS[w]} {w}": r for w, r in by_kernel.items()}}),
            "by_block": rows(by_block), "kernels": kernels}


def roofline_lines(summary: dict, by: str = "op", top: int = 30) -> list:
    """The printed rows of a ``roofline`` summary (``by`` "op" or "block"),
    the ``top`` first by device time, under a line saying how much of the
    device's kernel time was joined."""
    if summary["kernel_ms"] is None:
        return [f"roofline: no device activity (a CPU run); {summary['calls_joined']} of the "
                f"{summary['ops_counted']} counted operation calls joined to the trace"]

    def num(x, fmt):
        return "-" if x is None else format(x, fmt)
    lines = [f"roofline: joined {summary['matched_ms']:.3f} ms ({summary['matched_share']:.1%}) of "
             f"{summary['kernel_ms']:.3f} ms of device kernels a call; busy "
             f"{summary['busy_ms']:.3f} ms; bound {summary['bound_ms']:.3f} ms",
             f"{'ms/call':>9} {'%':>5} {'launch':>7} {'MB/exec':>9} {'GB/s':>8} {'%HBM':>6} "
             f"{'TFLOP/s':>8} {'%OPpk':>6} {'bound ms':>9}  {by}"]
    rows = summary["by_block"] if by == "block" else summary["by_op"]
    for r in rows[:top]:
        lines.append(f"{r['ms']:9.3f} {100 * (r['share'] or 0):5.1f} {r['launches']:7.1f} "
                     f"{num(r['mb_per_exec'], '9.3f')} {num(r['gbps'], '8.1f')} "
                     f"{num(r['pct_hbm'], '6.1f')} {num(r['tflops'], '8.2f')} "
                     f"{num(r['pct_flops'], '6.1f')} {num(r['bound_ms'], '9.4f')}  "
                     f"{r['name'][:120]}")
    return lines
