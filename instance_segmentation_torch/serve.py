"""Serving entry point: a model held on one device that answers batches of
uint8 frames with decoded instances.

Counterpart of the closed-over ``infer`` of the JAX package's ``bench.py``
and ``test.py``: EfficientSeg eval forward, then the full decode, with the
weights and anchors fixed at construction.
"""

from __future__ import annotations

from typing import Mapping, Tuple, Union

import numpy as np
import torch

from instance_segmentation_torch.models import EfficientSeg, EfficientSegConfig, generate_anchors
from instance_segmentation_torch.ops.decode import DecodeConfig, Detections, forward_and_decode
from instance_segmentation_torch.weights import init_random, load_flax_variables


class Predictor:
    """``weights`` is the JAX package's ``{"params", "batch_stats"}`` tree
    (numpy leaves), or a CPU ``torch.Generator`` for seeded untrained
    weights. Frames are [B, H, W, 3] uint8 at the model input size
    ``orig_hw / scale``; detections come back at ``orig_hw``. ``cfg.quant``
    "int8" serves through the int8 path."""

    def __init__(self, cfg: EfficientSegConfig, decode_cfg: DecodeConfig,
                 weights: Union[Mapping, torch.Generator], device: torch.device,
                 orig_hw: Tuple[int, int], scale: float):
        self.cfg, self.decode_cfg = cfg, decode_cfg
        self.device = torch.device(device)
        self.orig_hw, self.scale = tuple(orig_hw), float(scale)
        self.input_hw = tuple(int(round(s / self.scale)) for s in self.orig_hw)
        model = EfficientSeg(cfg)
        if isinstance(weights, torch.Generator):
            init_random(model, weights)
        else:
            load_flax_variables(model, weights)
        self.model = model.to(self.device).eval()
        anchors = generate_anchors(*self.input_hw, pyramid_levels=cfg.pyramid_levels,
                                   anchor_scale=cfg.anchor_scale, scales=cfg.scales,
                                   ratios=cfg.ratios)
        self.anchors = torch.tensor(anchors, device=self.device)

    @torch.inference_mode()
    def predict(self, frames: Union[np.ndarray, torch.Tensor]) -> Detections:
        """[B, H, W, 3] uint8 frames -> Detections on the predictor's device."""
        images = torch.as_tensor(frames)
        if images.dtype != torch.uint8 or tuple(images.shape[1:]) != (*self.input_hw, 3):
            raise ValueError(f"want uint8 [B, {self.input_hw[0]}, {self.input_hw[1]}, 3] "
                             f"frames, got {images.dtype} {tuple(images.shape)}")
        images = images.to(self.device, non_blocking=True)
        return forward_and_decode(self.model, images, self.anchors, self.orig_hw[0],
                                  self.orig_hw[1], self.scale, self.decode_cfg)
