"""Train-mode forward + backward by block: backbone | BiFPN | regressor | classifier | U-Net.

Counterpart of the JAX package's ``tools/profile_blocks.py`` (the standard
layout; its ``--no-s2d`` / ``--backbone-s2d`` TPU layouts are not carried).
The training model of the step trainer (bf16 compute over float32 master
weights, batch statistics, drop-connect), on seeded untrained weights:
each block runs forward and backward alone, in train mode, on the
materialised outputs of the blocks before it (computed once from seeded
uint8 frames), its loss the sum of its outputs in float32, the gradients
reset before each call, each call between two synchronisations of the
device.

    python -m instance_segmentation_torch.tools.profile_blocks [--batch 4] \\
        [--compound 3] [--hw 512 1024] [--iters 20] [--only backbone,unet] \\
        [--trace DIR [--top 10]] [--device cpu]

``--trace DIR`` writes one chrome trace of each block's forward + backward
to DIR and prints its top kernels by device time and the device's idle
share. The card unless ``--device cpu``; one line per block, then one JSON
record.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

import numpy as np
import torch

from instance_segmentation_torch.models import EfficientSeg, EfficientSegConfig
from instance_segmentation_torch.utils import profiling
from instance_segmentation_torch.weights import init_random

BLOCKS = ("backbone", "bifpn", "regressor", "classifier", "unet")


def summed(out) -> torch.Tensor:
    """The float32 sum of every tensor in a block's (nested) outputs."""
    if isinstance(out, torch.Tensor):
        return out.float().sum()
    return sum(summed(o) for o in out)


def run(batch: int = 4, compound: int = 3, hw=(512, 1024), iters: int = 20,
        only: Optional[Sequence[str]] = None, device: str = "cuda",
        trace: Optional[str] = None, top: int = 10, log=print) -> dict:
    """Times each block of ``only`` (every block without it); returns the
    record the CLI prints."""
    names = tuple(only) if only else BLOCKS
    unknown = set(names) - set(BLOCKS)
    if unknown:
        raise ValueError(f"unknown blocks {sorted(unknown)}: choose from {BLOCKS}")
    dev = profiling.resolve_device(device)
    label = profiling.device_label(dev)
    H, W = hw
    model = EfficientSeg(EfficientSegConfig(num_classes=8, compound_coef=compound,
                                            compute_dtype=torch.bfloat16),
                         param_dtype=torch.float32)
    init_random(model, torch.Generator().manual_seed(0))
    model = model.to(dev).train()
    backbone = model.backbone_net["model"]
    backbone.generator = torch.Generator(device=dev).manual_seed(0)    # drop-connect
    images = torch.from_numpy(np.random.default_rng(0).integers(
        0, 255, (batch, H, W, 3), dtype=np.uint8)).to(dev)
    with torch.no_grad():
        x = model.input_tensor(images)
        blocks = backbone(x)
        feats = model.bifpn(blocks[2:5])
    calls = {"backbone": lambda: backbone(x),
             "bifpn": lambda: model.bifpn(blocks[2:5]),
             "regressor": lambda: model.regressor(feats),
             "classifier": lambda: model.classifier(feats),
             "unet": lambda: model.kp_header(x, blocks)}

    def fwd_bwd(name):
        def step():
            model.zero_grad(set_to_none=True)
            summed(calls[name]()).backward()
        return step

    record = {"tool": "profile_blocks", "device": label, "compound": compound, "hw": [H, W],
              "batch": batch, "blocks": {}}
    for name in names:
        s = profiling.spread(profiling.synced_ms(fwd_bwd(name), iters, dev))
        log(f"{name:10s} fwd+bwd {profiling.spread_text(s)}; [{label}]", flush=True)
        record["blocks"][name] = s
        if trace:
            window = profiling.traced(fwd_bwd(name), dev,
                                      os.path.join(trace, f"profile_blocks_{name}.json"), top)
            for line in profiling.trace_lines(window, f"{name} fwd+bwd"):
                log(line, flush=True)
            record["blocks"][name]["trace"] = window
    return record


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--compound", type=int, default=3)
    ap.add_argument("--hw", type=int, nargs=2, default=(512, 1024))
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--only", default=None, help="comma list of " + ",".join(BLOCKS))
    ap.add_argument("--trace", default=None, help="directory for the chrome traces")
    ap.add_argument("--top", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> None:
    a = parse_args(argv)
    only = a.only.split(",") if a.only else None
    print(json.dumps(run(a.batch, a.compound, tuple(a.hw), a.iters, only, a.device, a.trace,
                         a.top)), flush=True)


if __name__ == "__main__":
    main()
