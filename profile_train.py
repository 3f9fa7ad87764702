#!/usr/bin/env python3
"""Where the time of the port's training step goes, on one CUDA card.

    python3 profile_train.py [--batch 8] [--steps 5] [--out build/profile_train.json]
                             [--fullres [FULLRES_DEMO_FLAGS ...]]

The train cell of ``chip_smoke.py`` phase 8: EfficientSeg-B3, bf16 compute
with float32 master weights, 512x1024, M=96, P=1024, Adam 2e-5, seeded
untrained weights, bench.py's synthetic batch. ``--fullres`` takes instead
the trainer and batch of ``instance_segmentation_torch.tools.fullres_demo``
(the full-resolution step of ``chip_smoke.py`` phase 11), built from the
flags that follow it, e.g. ``--fullres --batch 4 --remat``. After two warm-up steps it
times ``--steps`` steps stage by stage (targets, forward, loss, backward,
optimizer; host clock, the card synchronised after each stage), then traces
two steps with ``torch.profiler``: kernel time and launches per step, the
device's busy share (kernel time per step over the untraced step time; the
tracer itself slows the host) and the kernels that take the most device
time. Prints one summary line per part and writes the whole record as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from instance_segmentation_torch.device import nvidia_smi_name_power, require_cuda
from instance_segmentation_torch.losses import compose_loss
from instance_segmentation_torch.models import EfficientSegConfig
from instance_segmentation_torch.ops.targets import generate_targets
from instance_segmentation_torch.tools import fullres_demo
from instance_segmentation_torch.training.synthetic import bench_train_batch
from instance_segmentation_torch.training.train_step import Trainer

M, P = 96, 1024
RANGES = ("targets", "forward", "loss", "backward", "optimizer")


def is_span(event) -> bool:
    return (getattr(event, "is_user_annotation", False) or event.key in RANGES
            or event.key.startswith(("Optimizer.", "ProfilerStep")))


def staged_step(trainer: Trainer, batch) -> dict:
    """One step of ``Trainer.step``, stage by stage, with the card
    synchronised after each: {stage: ms}."""
    times = {}
    t = time.perf_counter()

    def mark(stage):
        nonlocal t
        torch.cuda.synchronize()
        now = time.perf_counter()
        times[stage] = 1e3 * (now - t)
        t = now

    images, polys, n_verts, cls_ids = trainer._as_batch(*batch)
    mark("upload")
    h, w = trainer.input_hw
    targets = generate_targets(polys, n_verts, cls_ids, h, w, max_points=trainer.max_points,
                               dense_kp=False)
    mark("targets")
    trainer.optimizer.zero_grad(set_to_none=True)
    outputs = trainer.model(images)
    mark("forward")
    total, _ = compose_loss(outputs, targets, trainer.anchors, trainer.loss_cfg)
    mark("loss")
    total.backward()
    mark("backward")
    trainer.optimizer.step()
    mark("optimizer")
    return times


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--out", default="build/profile_train.json")
    ap.add_argument("--fullres", nargs=argparse.REMAINDER, default=None,
                    help="the full-resolution demo's trainer and batch, from the flags after it")
    args = ap.parse_args()
    dev = require_cuda()
    smi = nvidia_smi_name_power()
    if args.fullres is not None:
        trainer, batch = fullres_demo.build(fullres_demo.parse_args(args.fullres))
    else:
        h, w = 512, 1024
        cfg = EfficientSegConfig(num_classes=8, compound_coef=3, compute_dtype=torch.bfloat16)
        trainer = Trainer(cfg, torch.Generator().manual_seed(0), (h, w), max_points=P,
                          device=dev)
        frames, labels = bench_train_batch(args.batch, M, h, w)
        batch = (frames, *labels)
    h, w = trainer.input_hw
    n, remat = len(batch[0]), trainer.cfg.remat
    for _ in range(2):
        trainer.step(*batch)
    torch.cuda.synchronize()

    staged = [staged_step(trainer, batch) for _ in range(args.steps)]
    stages = {k: float(np.median([s[k] for s in staged])) for k in staged[0]}
    step_ms = float(np.median([sum(s.values()) for s in staged]))
    print(f"B{trainer.cfg.compound_coef} {h}x{w} b{n} remat {remat} ae_window "
          f"{trainer.loss_cfg.ae_window}: stages (median ms of {args.steps}, synchronised): "
          + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
          + f"; step {step_ms:.3f} ms; [{smi}]", flush=True)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            trainer.step(*batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    device_events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    # the record_function ranges (the step's and the optimizer's own) show on
    # the device timeline too: they are spans, not kernels
    spans = {e.key: e.device_time_total / 2e3 for e in device_events if is_span(e)}
    kernels = [e for e in device_events if not is_span(e)]
    kernel_ms = sum(e.self_device_time_total for e in kernels) / 2e3
    launches = sum(e.count for e in kernels) / 2
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]
    print(f"traced 2 steps: wall {wall_ms / 2:.3f} ms/step (the tracer slows the host), kernel "
          f"time {kernel_ms:.3f} ms/step, {launches:.0f} launches/step; kernel time over the "
          f"untraced step: busy share {kernel_ms / step_ms:.3f}; device spans of the stage "
          f"ranges (ms/step): {', '.join(f'{k} {v:.3f}' for k, v in spans.items())}; [{smi}]",
          flush=True)
    for e in top:
        print(f"  {e.self_device_time_total / 2e3:9.3f} ms/step  {e.count / 2:7.1f} launches/step  "
              f"{e.key[:100]}", flush=True)

    record = {"device": smi, "batch": n, "hw": [h, w], "remat": remat,
              "ae_window": trainer.loss_cfg.ae_window,
              "stages_ms": stages, "step_ms": step_ms,
              "traced_wall_ms_per_step": wall_ms / 2, "kernel_ms_per_step": kernel_ms,
              "busy_share": kernel_ms / step_ms, "stage_spans_ms": spans,
              "launches_per_step": launches,
              "top_kernels": [{"name": e.key, "ms_per_step": e.self_device_time_total / 2e3,
                               "launches_per_step": e.count / 2} for e in top]}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)


if __name__ == "__main__":
    main()
