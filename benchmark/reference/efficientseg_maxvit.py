"""EfficientSeg on a MaxViT backbone: the plain backbone of ``maxvit.py``
composed with the frozen reference BiFPN, box and class heads and U-Net
decoder, which keep the tables of ``compound_coef``, as
``efficientseg_backbone.py`` composes them with EfficientNetV2. The BiFPN
takes the backbone's P3..P5 and the U-Net all five snapshots. Forward,
layouts and dtype policy are those of ``efficientseg.py``; the forward runs
with TF32 off, so that float32 products are float32.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Iterator, Optional

import torch
from torch import nn

from benchmark.reference import efficientseg as base
from benchmark.reference.bifpn import BiFPN
from benchmark.reference.heads import Classifier, Regressor
from benchmark.reference.layers import cast_convs
from benchmark.reference.maxvit import MaxViTFeatures, feature_channels
from benchmark.reference.unet_decoder import UNetDecoder


@contextlib.contextmanager
def no_tf32() -> Iterator[None]:
    """TF32 off for matmuls and cuDNN, restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@dataclass(frozen=True)
class EfficientSegConfig(base.EfficientSegConfig):
    backbone: str = "maxvit-b"


class EfficientSeg(nn.Module):
    """As ``efficientseg.EfficientSeg``, its backbone MaxViT ``cfg.backbone``."""

    def __init__(self, cfg: EfficientSegConfig, param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cfg = cfg
        coef = cfg.compound_coef
        chans = feature_channels(cfg.backbone)
        fpn_ch = base.FPN_FILTERS[coef]
        levels = base.PYRAMID_LEVELS[coef]
        self.backbone_net = nn.ModuleDict(
            {"model": MaxViTFeatures(cfg.backbone, cfg.drop_connect_rate)})
        self.bifpn = BiFPN(fpn_ch, chans[2:5], base.FPN_REPEATS[coef], attention=coef < 6,
                           use_p8=coef > 7)
        self.regressor = Regressor(fpn_ch, cfg.num_anchors, base.BOX_CLASS_REPEATS[coef],
                                   levels)
        self.classifier = Classifier(fpn_ch, cfg.num_anchors, cfg.num_classes,
                                     base.BOX_CLASS_REPEATS[coef], levels)
        self.kp_header = UNetDecoder(chans)
        self.register_buffer("pixel_mean", torch.tensor(cfg.mean) * 255.0,
                             persistent=False)
        self.register_buffer("pixel_std", torch.tensor(cfg.std) * 255.0,
                             persistent=False)
        cast_convs(self, param_dtype or cfg.compute_dtype)
        self.eval()

    def forward(self, images: torch.Tensor):
        with no_tf32():
            return base.EfficientSeg.forward(self, images)
