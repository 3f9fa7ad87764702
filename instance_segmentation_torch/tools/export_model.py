"""AOT export for serving: the forward pass and the full decode as one
``torch.export`` program with the weights baked in, saved as ``.pt2``.

Counterpart of the JAX package's ``tools/export_model.py``. The program
takes a uint8 batch [B, H, W, 3] and returns the flat tuple
``(classes, scores, centers, polygons, poly_len, obj_valid)`` of
``decode_output(DecodeConfig(exact_topk=...))`` (``--topk approx``: the
value-ordered top-k); K1 appears in it as the custom op
``iseg::affinity_assign``, which importing ``kernels/affinity.py`` registers
(``load`` does, before it reads the file), and, in a program exported on
the card, each batch norm and gate as ``iseg::bn_act``, which the models'
import of ``kernels/bn_act.py`` registers. The JAX tool cross-lowers for
another platform (``--platform``); ``torch.export`` records the program for
the device it traced on, so this tool exports on ``--device`` (the card
unless ``cpu`` is given) and the program runs there.

    python -m instance_segmentation_torch.tools.export_model --out model.pt2 \\
        [--weights CKPT_DIR] [--compound 3] [--hw 512 1024] [--batch 1] \\
        [--num_classes 8] [--quant none|int8] [--topk exact|approx] [--verify] \\
        [--device cpu]

``--weights`` is a directory of the port's checkpoints (the latest is
baked in; seeded weights of ``weights.init_random(0)`` without it).
``--verify`` loads the file back and checks that the program's outputs
equal the live model's exactly on the seeded random batch of the JAX tool.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from instance_segmentation_torch.device import require_cuda
from instance_segmentation_torch.kernels import affinity  # noqa: F401  registers iseg::affinity_assign
from instance_segmentation_torch.models import EfficientSeg, EfficientSegConfig, generate_anchors
from instance_segmentation_torch.ops.decode import DecodeConfig, forward_and_decode
from instance_segmentation_torch.utils.checkpoint import CheckpointManager
from instance_segmentation_torch.weights import init_random


class ServeProgram(nn.Module):
    """The exported function: uint8 frames -> the flat detection tuple."""

    def __init__(self, model: EfficientSeg, anchors: torch.Tensor, orig_hw: Tuple[int, int],
                 scale: float, decode_cfg: DecodeConfig = DecodeConfig()):
        super().__init__()
        self.model = model
        self.register_buffer("anchors", anchors)
        self.orig_hw, self.scale, self.decode_cfg = tuple(orig_hw), scale, decode_cfg

    def forward(self, images: torch.Tensor):
        dets = forward_and_decode(self.model, images, self.anchors, self.orig_hw[0],
                                  self.orig_hw[1], self.scale, self.decode_cfg)
        return (dets.classes, dets.scores, dets.centers, dets.polygons, dets.poly_len,
                dets.obj_valid)


def build_export(compound: int, hw, batch: int, num_classes: int, quant: str = "none",
                 weights: Optional[str] = None, device: torch.device = torch.device("cpu"),
                 orig_hw=None, decode_cfg: DecodeConfig = DecodeConfig()):
    """Returns (torch.export.ExportedProgram, the live ``ServeProgram``, the
    example batch on ``device``)."""
    H, W = hw
    orig_hw = orig_hw or (2 * H, 2 * W)              # the shipped config: x1/2 resize
    cfg = EfficientSegConfig(num_classes=num_classes, compound_coef=compound,
                             compute_dtype=torch.bfloat16, quant=quant)
    model = EfficientSeg(cfg)
    init_random(model, torch.Generator().manual_seed(0))
    if weights:
        CheckpointManager(weights).restore_latest(model)
    model = model.to(device).eval()
    anchors = torch.tensor(generate_anchors(
        H, W, pyramid_levels=cfg.pyramid_levels, anchor_scale=cfg.anchor_scale,
        scales=cfg.scales, ratios=cfg.ratios), device=device)
    live = ServeProgram(model, anchors, orig_hw, float(orig_hw[0] / H), decode_cfg)
    example = torch.from_numpy(np.random.default_rng(0).integers(
        0, 255, (batch, H, W, 3), dtype=np.uint8)).to(device)
    with torch.no_grad():
        program = torch.export.export(live, (example,), strict=False)
    return program, live, example


def load(path: str) -> torch.export.ExportedProgram:
    """An exported program read back (the ops it calls are registered by
    this module's imports of ``kernels/affinity.py`` and of the models)."""
    return torch.export.load(path)


def verify(program: torch.export.ExportedProgram, live: nn.Module,
           example: torch.Tensor) -> tuple:
    """A loaded program's outputs equal ``live``'s on ``example`` exactly;
    returns them."""
    with torch.no_grad():
        got = program.module()(example)
        want = live(example)
    for name, g, w in zip(("classes", "scores", "centers", "polygons", "poly_len",
                           "obj_valid"), got, want):
        if g.dtype != w.dtype or g.shape != w.shape or not torch.equal(g, w):
            raise AssertionError(f"exported program's {name} differs from the live model's")
    return got


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--weights", default=None,
                    help="directory of the port's checkpoints (the latest is baked in)")
    ap.add_argument("--compound", type=int, default=3)
    ap.add_argument("--hw", type=int, nargs=2, default=(512, 1024))
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--num_classes", type=int, default=8)
    ap.add_argument("--quant", default="none", choices=("none", "int8"))
    ap.add_argument("--topk", default="exact", choices=("exact", "approx"),
                    help="the decode's keypoint top-k: exact (the bisection, the default) or "
                         "approx (value-ordered, DecodeConfig(exact_topk=False))")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the device the program is traced and runs on (the JAX tool's "
                         "--platform cross-lowering has no torch counterpart): cuda "
                         "(default: the card, or fail) or cpu")
    ap.add_argument("--verify", action="store_true")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    device = torch.device("cpu") if args.device == "cpu" else require_cuda()
    program, live, example = build_export(
        args.compound, tuple(args.hw), args.batch, args.num_classes, quant=args.quant,
        weights=args.weights, device=device,
        decode_cfg=DecodeConfig(exact_topk=args.topk == "exact"))
    torch.export.save(program, args.out)
    print(f"wrote {args.out}: {os.path.getsize(args.out) / 1e6:.1f} MB, device={device.type}")
    if args.verify:
        verify(load(args.out), live, example)
        print("verify: the loaded program matches the live model exactly")


if __name__ == "__main__":
    main()
