#!/usr/bin/env python3
"""Device time of the port's own kernels, apart from their Python wrappers.

Every kernel of ``instance_segmentation_torch`` is launched by a C entry
point of a library that ``kernels/build.py``'s ``load`` returns. ``hook``
makes ``load`` hand out entry points that can repeat themselves: inside
``own_ms(fn)`` each launch that ``fn`` makes (an entry-point call that
returns 0) is made ``ITERS`` times more on the same inputs, queued behind a
device wait and timed between two CUDA events (``queued_ms``). The wrapper
prepares the inputs once, outside the timing. ``kernels_per_call`` counts
the device kernels one call launches, PyTorch's included. ``chip_smoke.py``
times its kernels with these.

    python3 kernel_timing.py [--split] DIR

runs the kernel phases (3, 7 and 10) of another checkout's ``chip_smoke.py``
(a parent commit unpacked with ``git archive``, say) on its own package and
its own ``kernel_timing.py``, on one CUDA device.

    python3 kernel_timing.py [--split] --k1-from DIR [DIR ...]

runs this checkout's serving slice (phase 5) once, keeping the inputs K1
gets in its first b8 call, then, for each DIR in turn, this checkout's K1
phase 3 and those serving inputs with kernel K1 built from DIR's
``instance_segmentation_torch/csrc/affinity.cu``: other versions of the
kernel (its C entry point unchanged) on this checkout's inputs and wrapper,
in one process. Differences from the twin are printed, not raised.
``--k1-floor`` adds, last, this checkout's K1 cut down to reading its
keypoint inputs and writing its outputs (``k1_floor_source``, built under
``build/k1_floor``): what the card takes for K1's bytes alone, at its grid.
``--split`` adds, before each kernel line, a ``[split]`` line: each device
kernel's time per call from one profiler window (``device_split``).
"""

from __future__ import annotations

import importlib.util
import re
import sys
from pathlib import Path

import torch

ITERS = 20
# the port's kernels, by name, for telling them from PyTorch's in a profile
PORT_KERNELS = ("affinity_kernel", "nms_kernel", "cnt_r2_kernel", "minr2_kernel",
                "nmap_bin_kernel", "nmap_band_kernel", "ae_fwd_kernel", "ae_sum_kernel",
                "ae_bwd_kernel")
_replays = None                  # inside own_ms: the device ms of each launch


def queued_ms(fn, iters: int = ITERS) -> float:
    """Device time per call of everything ``fn`` launches, with no host gap:
    the ``iters`` calls are queued behind a 20 ms device wait and timed
    between two CUDA events recorded after the wait and after the calls."""
    fn()
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(40_000_000)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


class _Entry:
    """A C entry point (a ctypes function) that, inside ``own_ms``, repeats
    each of its launches that succeeded and records their device time."""

    def __init__(self, fn):
        object.__setattr__(self, "_fn", fn)

    def __getattr__(self, name):
        return getattr(self._fn, name)

    def __setattr__(self, name, value):          # argtypes, restype
        setattr(self._fn, name, value)

    def __call__(self, *args):
        err = self._fn(*args)
        if _replays is not None and err == 0:
            def again():
                if self._fn(*args) != 0:
                    raise RuntimeError("a repeated kernel launch failed")
            _replays.append(queued_ms(again))
        return err


class _Library:
    def __init__(self, lib):
        self._lib = lib

    def __getattr__(self, name):
        return _Entry(getattr(self._lib, name))


def hook(build) -> None:
    """Make ``build.load`` (of a port's ``kernels/build.py``) return
    libraries whose entry points ``own_ms`` can time; call it before any
    kernel wrapper runs (the wrappers keep the entry points they get)."""
    load = build.load
    build.load = lambda name: _Library(load(name))


def own_ms(fn):
    """(device ms of the port's launches in one call of ``fn``, how many
    launches it made): each launch repeated ``ITERS`` times, queued."""
    global _replays
    _replays = []
    try:
        fn()
    finally:
        times, _replays = _replays, None
    return sum(times), len(times)


def _device_events(fn, calls: int):
    """The device activities of ``calls`` calls of ``fn`` (after a warm-up)
    in one ``torch.profiler`` window."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def kernels_per_call(fn, calls: int = 10):
    """(device activities per call of ``fn``, of which the port's kernels):
    one ``torch.profiler`` window over ``calls`` calls after a warm-up.
    Every kernel counts, PyTorch's included, and every memset and copy."""
    device = _device_events(fn, calls)
    own = sum(any(k in e.name for k in PORT_KERNELS) for e in device)
    return round(len(device) / calls), round(own / calls)


def launches_per_call(fn, name: str, calls: int = 10) -> float:
    """Device launches of the kernels whose name holds ``name`` per call of
    ``fn``: one ``torch.profiler`` window over ``calls`` calls after a
    warm-up (a CUDA graph's kernels count, one by one)."""
    return sum(name in e.name for e in _device_events(fn, calls)) / calls


def device_split(fn, calls: int = 10) -> dict:
    """{device kernel (its ``*_kernel`` name where it has one): device ms per
    call} from one profiler window over ``calls`` calls: what each of a
    wrapper's kernels takes, which the entry point's own time sums."""
    split = {}
    for e in _device_events(fn, calls):
        found = re.search(r"(\w+_kernel)\b", e.name)
        name = found.group(1) if found else e.name[:40]
        split[name] = split.get(name, 0.0) + e.time_range.elapsed_us() / 1e3 / calls
    return split


K1_STAGING = "  for (int d0 = 0; d0 < D; d0 += kThreads) {"


def k1_floor_source(src: str) -> str:
    """K1's source (``csrc/affinity.cu``) with the kernel returning right
    after its keypoint loads, having written assign 0 and, as best, a sum of
    the six loaded values (so that no load is dropped)."""
    head, sep, tail = src.partition(K1_STAGING)
    if not sep:
        raise ValueError("K1's table staging loop not found")
    return (head + "  if (active) {\n    assign[p] = 0;\n"
            "    best[p] = rc.x + rc.y + e.x + e.y + s.x + s.y;\n  }\n  return;\n" + sep + tail)


def _split_text(split: dict) -> str:
    return ", ".join(f"{k} {v:.4f} ms" for k, v in split.items())


def main() -> None:
    args = sys.argv[1:]
    split = "--split" in args
    k1_from = "--k1-from" in args
    trees = [Path(a).resolve() for a in args if a not in ("--split", "--k1-from", "--k1-floor")]
    if k1_from:
        import chip_smoke as smoke
        if "--k1-floor" in args:
            floor = smoke.build.BUILD_DIR.parent / "k1_floor"
            (floor / "instance_segmentation_torch" / "csrc").mkdir(parents=True, exist_ok=True)
            (floor / "instance_segmentation_torch" / "csrc" / "affinity.cu").write_text(
                k1_floor_source((smoke.build.CSRC / "affinity.cu").read_text()))
            trees.append(floor)
    else:
        (tree,) = trees
        sys.path.insert(0, str(tree))
        spec = importlib.util.spec_from_file_location("tree_chip_smoke", tree / "chip_smoke.py")
        smoke = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(smoke)
    load = smoke.build.load
    if not k1_from:
        smoke.kernel_timing.hook(smoke.build)
    if split:
        own_time = smoke.own_time

        def split_own_time(fn):
            print(f"[split] {_split_text(device_split(fn))}", flush=True)
            return own_time(fn)
        smoke.own_time = split_own_time
    dev = smoke.require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smoke.nvidia_smi_name_power()
    print(f"[1] {' '.join(map(str, trees))}: device {torch.cuda.get_device_name(0)}; "
          f"nvidia-smi: {smi}", flush=True)
    if not k1_from:
        smoke.build.build_all(smoke.KERNELS)
        for kernel in smoke.KERNELS:
            smoke.build.load(kernel)
        smoke.phase_affinity(dev)
        smoke.phase_train_kernels(dev)
        smoke.phase_minr2(dev)
        return
    served = None
    for tree in trees:
        smoke.build.CSRC = tree / "instance_segmentation_torch" / "csrc"
        load.cache_clear()                   # K1 from this tree's source, hooked once
        smoke.build.load = load
        smoke.kernel_timing.hook(smoke.build)
        smoke.affinity._kernel.cache_clear()
        lib = smoke.build.build("affinity")
        print(f"[2] K1 from {smoke.build.CSRC / 'affinity.cu'}: {lib.name}; ptxas: "
              f"{'; '.join(smoke.build.ptxas_usage('affinity'))}", flush=True)
        if served is None:
            _, served, _ = smoke.phase_slice(dev, smi)
        smoke.phase_affinity(dev, strict=False)
        smoke.hold_affinity(5, "the serving slice's first b8 call", served, strict=False)


if __name__ == "__main__":
    main()
