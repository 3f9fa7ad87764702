"""EfficientSeg on a backbone named apart from its compound coefficient: the
plain EfficientNetV2 backbone of ``efficientnetv2.py`` composed with the
frozen reference BiFPN, box and class heads and U-Net decoder, which keep
the tables of ``compound_coef``. The BiFPN takes the backbone's P3..P5 and
the U-Net all five snapshots. Forward, layouts and dtype policy are those
of ``efficientseg.py`` (its ``forward`` is reused as it stands).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from benchmark.reference import efficientseg as base
from benchmark.reference.bifpn import BiFPN
from benchmark.reference.efficientnetv2 import EfficientNetV2Features, feature_channels
from benchmark.reference.heads import Classifier, Regressor
from benchmark.reference.layers import cast_convs
from benchmark.reference.unet_decoder import UNetDecoder


@dataclass(frozen=True)
class EfficientSegConfig(base.EfficientSegConfig):
    backbone: str = "efficientnetv2-l"


class EfficientSeg(nn.Module):
    """As ``efficientseg.EfficientSeg``, its backbone ``cfg.backbone``."""

    forward = base.EfficientSeg.forward

    def __init__(self, cfg: EfficientSegConfig, param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cfg = cfg
        coef = cfg.compound_coef
        chans = feature_channels(cfg.backbone)
        fpn_ch = base.FPN_FILTERS[coef]
        levels = base.PYRAMID_LEVELS[coef]
        self.backbone_net = nn.ModuleDict(
            {"model": EfficientNetV2Features(cfg.backbone, cfg.drop_connect_rate)})
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
