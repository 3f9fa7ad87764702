"""EfficientSeg: EfficientNet backbone -> BiFPN (P3..P7; P3..P8 at
compound_coef 8) -> anchor box/class heads, plus the U-Net kp/ae/tan decoder
over [input, P1..P5]. Frozen from the port's ``models/efficientseg.py``
without its remat, int8 and spatial paths.

Input: NHWC uint8 images; normalization happens inside the model. Outputs in
eval mode, in the reference layouts:

    kp:  (B, H, W, 1) float32 logits
    ae:  (B, H, W, 4) float32 (2 offsets + 2 log-sigmas)
    tan: (B, H, W, 2) float32
    regression:     (B, A, 4) float32 (dy, dx, dh, dw)
    classification: (B, A, C) float32 sigmoid scores

In training mode the dense heads come out as planes: kp one [B, H, W]
float32 plane, ae a tuple of four and tan a tuple of two. Inside, tensors
are NCHW in ``compute_dtype``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
from torch import nn

from benchmark.reference.bifpn import BiFPN
from benchmark.reference.efficientnet import EfficientNetFeatures, feature_channels
from benchmark.reference.heads import Classifier, Regressor
from benchmark.reference.layers import cast_convs
from benchmark.reference.unet_decoder import UNetDecoder

# Per-compound-coefficient scaling tables (same as the reference).
BACKBONE_COEF = [0, 1, 2, 3, 4, 5, 6, 6, 7]
FPN_FILTERS = [64, 88, 112, 160, 224, 288, 384, 384, 384]
FPN_REPEATS = [3, 4, 5, 6, 7, 7, 8, 8, 8]
BOX_CLASS_REPEATS = [3, 3, 3, 4, 4, 4, 5, 5, 5]
PYRAMID_LEVELS = [5, 5, 5, 5, 5, 5, 5, 5, 6]
ANCHOR_SCALE = [4.0, 4.0, 4.0, 4.0, 4.0, 4.0, 4.0, 5.0, 4.0]
INPUT_SIZES = [512, 640, 768, 896, 1024, 1280, 1280, 1536, 1536]

DEFAULT_MEAN = (0.485, 0.456, 0.406)
DEFAULT_STD = (0.229, 0.224, 0.225)


@dataclass(frozen=True)
class EfficientSegConfig:
    num_classes: int = 8
    compound_coef: int = 0
    scales: Tuple[float, ...] = (2 ** 0, 2 ** (1.0 / 3.0), 2 ** (2.0 / 3.0))
    ratios: Tuple[Tuple[float, float], ...] = ((1.0, 1.0), (1.4, 0.7), (0.7, 1.4))
    compute_dtype: torch.dtype = torch.float32
    mean: Tuple[float, ...] = DEFAULT_MEAN
    std: Tuple[float, ...] = DEFAULT_STD
    drop_connect_rate: float = 0.2      # backbone stochastic depth, training only

    @property
    def num_anchors(self) -> int:
        return len(self.scales) * len(self.ratios)

    @property
    def pyramid_levels(self) -> Tuple[int, ...]:
        return tuple(range(3, 3 + PYRAMID_LEVELS[self.compound_coef]))

    @property
    def anchor_scale(self) -> float:
        return ANCHOR_SCALE[self.compound_coef]


class EfficientSeg(nn.Module):
    """Built on the CPU in float32; conv weights are then held in
    ``param_dtype`` (default ``cfg.compute_dtype``) and cast to
    ``cfg.compute_dtype`` per call. It starts in eval mode."""

    def __init__(self, cfg: EfficientSegConfig, param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cfg = cfg
        coef = cfg.compound_coef
        variant = BACKBONE_COEF[coef]
        chans = feature_channels(variant)
        fpn_ch = FPN_FILTERS[coef]
        levels = PYRAMID_LEVELS[coef]
        self.backbone_net = nn.ModuleDict(
            {"model": EfficientNetFeatures(variant, cfg.drop_connect_rate)})
        self.bifpn = BiFPN(fpn_ch, chans[2:5], FPN_REPEATS[coef], attention=coef < 6,
                           use_p8=coef > 7)
        self.regressor = Regressor(fpn_ch, cfg.num_anchors, BOX_CLASS_REPEATS[coef],
                                   levels)
        self.classifier = Classifier(fpn_ch, cfg.num_anchors, cfg.num_classes,
                                     BOX_CLASS_REPEATS[coef], levels)
        self.kp_header = UNetDecoder(chans)
        self.register_buffer("pixel_mean", torch.tensor(cfg.mean) * 255.0,
                             persistent=False)
        self.register_buffer("pixel_std", torch.tensor(cfg.std) * 255.0,
                             persistent=False)
        cast_convs(self, param_dtype or cfg.compute_dtype)
        self.eval()

    def forward(self, images: torch.Tensor):
        x = (images.float() - self.pixel_mean) / self.pixel_std
        x = x.to(self.cfg.compute_dtype).permute(0, 3, 1, 2)
        blocks = self.backbone_net["model"](x)
        feats = self.bifpn(blocks[2:5])
        regression = self.regressor(feats).float()
        classification = self.classifier(feats)
        heads = self.kp_header(x, blocks)
        if self.training:
            kp, ae, tan = (tuple(t.unbind(1)) for t in heads)
            return kp[0], ae, tan, regression, classification
        kp, ae, tan = (t.permute(0, 2, 3, 1) for t in heads)
        return kp, ae, tan, regression, classification
