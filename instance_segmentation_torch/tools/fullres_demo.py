"""One full-resolution (1024x2048) EfficientSeg training step on one card.

Counterpart of the JAX package's ``tools/fullres_demo.py``, with its flags
and its synthetic batch (``training.synthetic.fullres_batch``): EfficientSeg
(B3 by default) in bf16 with float32 master weights and seeded untrained
weights, Adam 2e-5, M=96 instance slots and P=1024 samples each. At
1024x2048 the loss takes the count-map route (count map, then kernel K6;
see ``losses/losses.py``); ``--remat`` recomputes the backbone and decoder
activations in the backward; ``--ae-window H W`` takes the windowed AE loss.

    python3 -m instance_segmentation_torch.tools.fullres_demo --batch 1 --remat

One untimed step, then ``--iters`` timed steps, the card synchronised after
them. Prints one JSON line: hw, batch, compound, remat, ae_window, total_loss
(of the last step), step_ms, img_per_s, peak_hbm_gb (the most memory the run
allocated on the card), hbm_limit_gb (the card's memory), device and
nvidia-smi's name and power limit. Runs on the CUDA card unless ``--device``
names another.
"""

from __future__ import annotations

import argparse
import json
import math
import time
from typing import Optional, Sequence, Tuple

import torch

from instance_segmentation_torch.device import nvidia_smi_name_power, require_cuda
from instance_segmentation_torch.losses import LossConfig
from instance_segmentation_torch.models import EfficientSegConfig
from instance_segmentation_torch.training.synthetic import fullres_batch
from instance_segmentation_torch.training.train_step import Trainer


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--compound", type=int, default=3)
    ap.add_argument("--hw", type=int, nargs=2, default=(1024, 2048))
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--max-instances", type=int, default=96)
    ap.add_argument("--max-points", type=int, default=1024)
    ap.add_argument("--n-real", type=int, default=16)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--ae-window", type=int, nargs=2, default=None)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.iters < 1:
        ap.error("--iters must be at least 1")
    return args


def build(args: argparse.Namespace) -> Tuple[Trainer, tuple]:
    """The trainer and the synthetic batch (frames, polys, n_verts, cls_ids)
    that ``args`` describe."""
    dev = torch.device(args.device) if args.device else require_cuda()
    h, w = args.hw
    cfg = EfficientSegConfig(num_classes=8, compound_coef=args.compound,
                             compute_dtype=torch.bfloat16, remat=args.remat)
    loss_cfg = LossConfig(ae_window=tuple(args.ae_window) if args.ae_window else None)
    trainer = Trainer(cfg, torch.Generator().manual_seed(0), (h, w), loss_cfg,
                      max_points=args.max_points, lr=2e-5, device=dev)
    frames, labels = fullres_batch(args.batch, args.max_instances, h, w, n_real=args.n_real)
    return trainer, (frames, *labels)


def run(args: argparse.Namespace) -> dict:
    """Build the trainer, take the steps and return the result record.
    Raises if a loss of any step is not finite."""
    dev = torch.device(args.device) if args.device else require_cuda()
    cuda = dev.type == "cuda"
    h, w = args.hw
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    trainer, batch = build(args)

    def checked(stats) -> dict:
        values = {k: float(v) for k, v in stats.items()}
        if not all(math.isfinite(v) for v in values.values()):
            raise FloatingPointError(f"a full-resolution loss is not finite: {values}")
        return values

    checked(trainer.step(*batch))
    if cuda:
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    steps = [trainer.step(*batch) for _ in range(args.iters)]
    if cuda:
        torch.cuda.synchronize(dev)
    step_ms = (time.perf_counter() - t0) / args.iters * 1e3
    return {
        "hw": [h, w], "batch": args.batch, "compound": args.compound,
        "remat": args.remat, "ae_window": args.ae_window,
        "total_loss": [checked(s) for s in steps][-1]["total_loss"], "step_ms": step_ms,
        "img_per_s": args.batch / (step_ms / 1e3),
        "peak_hbm_gb": torch.cuda.max_memory_allocated(dev) / 2**30 if cuda else None,
        "hbm_limit_gb": torch.cuda.mem_get_info(dev)[1] / 2**30 if cuda else None,
        "device": torch.cuda.get_device_name(dev) if cuda else str(dev),
        "nvidia_smi": nvidia_smi_name_power() if cuda else None,
    }


def main(argv: Optional[Sequence[str]] = None) -> None:
    print(json.dumps(run(parse_args(argv))))


if __name__ == "__main__":
    main()
