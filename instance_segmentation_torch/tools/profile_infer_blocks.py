"""Eval forward by block: backbone | BiFPN | regressor | classifier | U-Net.

Counterpart of the JAX package's ``tools/profile_infer_blocks.py``, in the
standard layout (the JAX tool's ``--s2d`` is a TPU layout the port does not
carry). On seeded untrained weights and seeded uint8 frames, each block of
``EfficientSeg.forward`` runs alone in eval mode on the materialised
outputs of the blocks before it (the normalised bf16 input for the
backbone and the U-Net), each call between two synchronisations of the
device; the whole forward is timed beside them.

    python -m instance_segmentation_torch.tools.profile_infer_blocks [--batch 8] \\
        [--compound 3] [--hw 512 1024] [--iters 30] [--device cpu]

The card unless ``--device cpu``; one line per block, then one JSON record.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import numpy as np
import torch

from instance_segmentation_torch.models import EfficientSeg, EfficientSegConfig
from instance_segmentation_torch.utils import profiling
from instance_segmentation_torch.weights import init_random


def run(batch: int = 8, compound: int = 3, hw=(512, 1024), iters: int = 30,
        device: str = "cuda", log=print) -> dict:
    """Times each block; returns the record the CLI prints."""
    dev = profiling.resolve_device(device)
    label = profiling.device_label(dev)
    H, W = hw
    model = EfficientSeg(EfficientSegConfig(num_classes=8, compound_coef=compound,
                                            compute_dtype=torch.bfloat16))
    init_random(model, torch.Generator().manual_seed(0))
    model = model.to(dev).eval()
    images = torch.from_numpy(np.random.default_rng(0).integers(
        0, 255, (batch, H, W, 3), dtype=np.uint8)).to(dev)
    with torch.inference_mode():
        # EfficientSeg.forward, block by block
        x = model.input_tensor(images)
        backbone = model.backbone_net["model"]
        blocks = backbone(x)
        feats = model.bifpn(blocks[2:5])
        stages = {"backbone": lambda: backbone(x),
                  "bifpn": lambda: model.bifpn(blocks[2:5]),
                  "regressor": lambda: model.regressor(feats),
                  "classifier": lambda: model.classifier(feats),
                  "unet": lambda: model.kp_header(x, blocks),
                  "forward": lambda: model(images)}
        times = {name: profiling.spread(profiling.synced_ms(fn, iters, dev))
                 for name, fn in stages.items()}
    total = sum(s["median"] for name, s in times.items() if name != "forward")
    for name, s in times.items():
        log(f"{name:10s} {profiling.spread_text(s)}; [{label}]", flush=True)
    log(f"B={batch} B{compound} {H}x{W} bf16: sum of the blocks' medians {total:.3f} ms, the "
        f"forward's {times['forward']['median']:.3f} ms; [{label}]", flush=True)
    return {"tool": "profile_infer_blocks", "device": label, "compound": compound,
            "hw": [H, W], "batch": batch, "blocks": times, "sum_ms": total}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--compound", type=int, default=3)
    ap.add_argument("--hw", type=int, nargs=2, default=(512, 1024))
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> None:
    a = parse_args(argv)
    print(json.dumps(run(a.batch, a.compound, tuple(a.hw), a.iters, a.device)), flush=True)


if __name__ == "__main__":
    main()
