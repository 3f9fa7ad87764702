"""Roofline of the train step or of serving: each kernel's GB/s and TFLOP/s against the peaks.

Counterpart of the JAX package's ``tools/roofline_train.py`` and
``tools/parse_trace.py --roofline``, on seeded untrained weights in bf16:

* train (the default): the step trainer (float32 master weights, Adam
  2e-5) on ``training/synthetic.bench_train_batch`` (the JAX tool's batch:
  ``--n-real`` octagons an image, M = ``--max-instances``, P =
  ``--max-points``), 512x1024 by default;
* ``--eval``: ``forward_and_decode`` with ``DecodeConfig()`` on seeded
  uint8 frames (the frames of a 2x larger image at scale 2);
* ``--fullres [--remat]``: ``tools/fullres_demo``'s trainer and batch at
  1024x2048.

One warm-up call outside the trace; one call counted (``utils/flops``:
every operation's FLOPs and bytes, and ``kernels/bounds.py``'s work of each
of the port's kernels it launches); the call timed untraced, ``--iters``
times between two synchronisations of the device (``step_ms``: the
median); then ``--iters`` calls traced with ``torch.profiler`` and joined
to the counts (``utils/profiling.roofline``). Prints the rows (``--by op``:
by operation and operand shapes, the port's kernels by name; ``--by
block``: by model block and stage), then one JSON line: mode, batch, hw,
compound, step_ms, model_flops (the call's convolution and product FLOPs),
achieved_tflops and mfu (model_flops over step_ms, and over step_ms at the
dense bf16 peak), bound_ms (the sum of every joined kernel's least time at
the peaks), busy_ms (device busy time of a traced call), idle_share (1 -
busy_ms / step_ms), matched_share (the share of the device's kernel time
joined to a count), kernel_ms, the port's kernels and the blocks, and
nvidia-smi's name and power limit.

    python -m instance_segmentation_torch.tools.roofline [--batch 4] [--compound 3] \\
        [--hw 512 1024] [--iters 20] [--max-instances 96] [--max-points 1024] \\
        [--n-real 16] [--eval | --fullres [--remat]] [--by op|block] [--top 40] \\
        [--out DIR] [--peak-gbps G --peak-tflops T] [--device cpu]

The card unless ``--device cpu``, where the kernels' plain twins run, the
counts are printed and every time and share is null. The peaks are those of
``kernels/bounds.py`` for the card's name; another card needs
``--peak-gbps`` and ``--peak-tflops``. ``--out DIR`` keeps the chrome trace
and the record there.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import time
from typing import Callable, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from instance_segmentation_torch.kernels import ae_terms, bn_act, bounds, minr2, rasterize
from instance_segmentation_torch.models import EfficientSeg, EfficientSegConfig, generate_anchors
from instance_segmentation_torch.ops import decode
from instance_segmentation_torch.ops.decode import DecodeConfig, forward_and_decode
from instance_segmentation_torch.tools import fullres_demo
from instance_segmentation_torch.training.synthetic import bench_train_batch
from instance_segmentation_torch.training.train_step import Trainer
from instance_segmentation_torch.utils import flops, profiling
from instance_segmentation_torch.weights import init_random

# the kernel wrappers, where the step calls them
_WRAPPERS = ((rasterize, "rasterize_cnt_r2"), (rasterize, "rasterize_nmap"),
             (minr2, "minr2_from_cnt"), (ae_terms, "ae_terms_fwd"), (ae_terms, "ae_terms_bwd"),
             (decode, "affinity_assign"), (decode, "nms_keep"), (bn_act, "bn_act"))


@contextlib.contextmanager
def kernel_work(counter: flops.OpCounter) -> Iterator[dict]:
    """{wrapper: [``bounds.Work`` of each call]} of the port's kernel
    wrappers called inside, each work counted outside ``counter``."""
    work = collections.defaultdict(list)
    saved = []
    for module, name in _WRAPPERS:
        fn = getattr(module, name)

        def wrapped(*args, _fn=fn, _name=name, **kwargs):
            out = _fn(*args, **kwargs)
            with counter.paused():
                work[_name].append(bounds.WORK[_name](*args, **kwargs))
            return out
        saved.append((module, name, fn))
        setattr(module, name, wrapped)
    try:
        yield work
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)


def build(args: argparse.Namespace, dev: torch.device) -> Tuple[torch.nn.Module, Callable]:
    """(the model, one call of the step ``args`` describe)."""
    h, w = args.hw
    b, m, p = args.batch, args.max_instances, args.max_points
    if args.eval:
        cfg = EfficientSegConfig(num_classes=8, compound_coef=args.compound,
                                 compute_dtype=torch.bfloat16)
        model = EfficientSeg(cfg)
        init_random(model, torch.Generator().manual_seed(0))
        model = model.to(dev).eval()
        anchors = torch.tensor(generate_anchors(h, w, pyramid_levels=cfg.pyramid_levels,
                                                anchor_scale=cfg.anchor_scale, scales=cfg.scales,
                                                ratios=cfg.ratios), device=dev)
        images = torch.from_numpy(np.random.default_rng(0).integers(
            0, 255, (b, h, w, 3), dtype=np.uint8)).to(dev)

        def call():
            with torch.inference_mode():
                return forward_and_decode(model, images, anchors, 2 * h, 2 * w, 2.0,
                                          DecodeConfig())
        return model, call
    if args.fullres:
        trainer, batch = fullres_demo.build(argparse.Namespace(
            device=str(dev), hw=(h, w), compound=args.compound, remat=args.remat,
            ae_window=None, max_points=p, batch=b, max_instances=m, n_real=args.n_real))
    else:
        cfg = EfficientSegConfig(num_classes=8, compound_coef=args.compound,
                                 compute_dtype=torch.bfloat16)
        trainer = Trainer(cfg, torch.Generator().manual_seed(0), (h, w), max_points=p, lr=2e-5,
                          device=dev)
        frames, labels = bench_train_batch(b, m, h, w, n_real=args.n_real)
        batch = (frames, *labels)
    batch = [torch.from_numpy(a).to(dev) for a in batch]
    return trainer.model, lambda: trainer.step(*batch)


def run(args: argparse.Namespace, log=print) -> dict:
    """Counts, times and traces the step; returns the record the CLI
    prints last."""
    dev = profiling.resolve_device(args.device)
    on_card = dev.type == "cuda"
    peaks = (bounds.peaks_for(torch.cuda.get_device_name(dev), args.peak_gbps, args.peak_tflops)
             if on_card else bounds.H100_SXM)
    label = profiling.device_label(dev)
    h, w = args.hw
    mode = "eval" if args.eval else ("fullres" if args.fullres else "train")
    seconds = {}
    t0 = time.perf_counter()

    def lap(name: str) -> None:
        nonlocal t0
        t1 = time.perf_counter()
        seconds[name] = t1 - t0
        t0 = t1
    model, call = build(args, dev)
    with profiling.block_ranges(model):
        call()                                          # warm-up, outside the trace
        profiling.sync(dev)
        with flops.OpCounter() as counter, kernel_work(counter) as work:
            call()
        ops = counter.ops
        lap("build, warm-up and count")
        step_ms = float(np.median(profiling.synced_ms(call, args.iters, dev)))
        lap("timed")
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        profiling.sync(dev)
        with profile(activities=activities) as prof, flops.OpCounter() as traced:
            for _ in range(args.iters):
                call()
            profiling.sync(dev)
        window_ms = 1e3 * (time.perf_counter() - t0)
        lap("traced")
    events = profiling.trace_events(prof)
    lap("trace read")
    summary = profiling.roofline(events, traced.ops, work, args.iters, peaks)
    lap("joined")
    for line in profiling.roofline_lines(summary, args.by, args.top):
        log(line, flush=True)
    log(f"roofline {mode}: seconds " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()),
        flush=True)
    model_flops = flops.total_flops(ops)
    busy = summary["busy_ms"]
    record = {"tool": "roofline", "mode": mode, "batch": args.batch, "hw": [h, w],
              "compound": args.compound, "remat": bool(args.remat), "iters": args.iters,
              "step_ms": step_ms, "model_flops": model_flops,
              "achieved_tflops": model_flops / step_ms / 1e9 if on_card else None,
              "mfu": model_flops / (step_ms / 1e3 * peaks.ops_per_s["bf16"]) if on_card else None,
              "bound_ms": summary["bound_ms"], "busy_ms": busy,
              "idle_share": max(0.0, 1.0 - busy / step_ms) if on_card else None,
              "matched_share": summary["matched_share"], "kernel_ms": summary["kernel_ms"],
              "traced_window_ms": window_ms, "ops_counted": summary["ops_counted"],
              "calls_joined": summary["calls_joined"], "unjoined": summary["unjoined"],
              "kernels": summary["kernels"],
              "kernel_work": {k: [list(x) for x in v] for k, v in work.items()},
              "blocks": summary["by_block"], "seconds": seconds, "peaks": peaks.card,
              "device": label}
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.out, f"roofline_{mode}.json"))
        with open(os.path.join(args.out, f"roofline_{mode}_record.json"), "w") as f:
            json.dump(dict(record, by_op=summary["by_op"]), f)
    return record


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--compound", type=int, default=3)
    ap.add_argument("--hw", type=int, nargs=2, default=None,
                    help="input height and width (default 512 1024; 1024 2048 with --fullres)")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--max-instances", type=int, default=96)
    ap.add_argument("--max-points", type=int, default=1024)
    ap.add_argument("--n-real", type=int, default=16)
    ap.add_argument("--out", default=None, help="directory for the chrome trace and the record")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--eval", action="store_true", help="forward + decode instead of a step")
    mode.add_argument("--fullres", action="store_true", help="the full-resolution train step")
    ap.add_argument("--remat", action="store_true", help="with --fullres: remat")
    ap.add_argument("--by", default="op", choices=("op", "block"))
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--peak-gbps", type=float, default=None)
    ap.add_argument("--peak-tflops", type=float, default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.remat and not args.fullres:
        ap.error("--remat goes with --fullres")
    if args.iters < 1:
        ap.error("--iters must be at least 1")
    if args.hw is None:
        args.hw = (1024, 2048) if args.fullres else (512, 1024)
    args.hw = tuple(args.hw)
    return args


def main(argv: Optional[Sequence[str]] = None) -> None:
    print(json.dumps(run(parse_args(argv))), flush=True)


if __name__ == "__main__":
    main()
