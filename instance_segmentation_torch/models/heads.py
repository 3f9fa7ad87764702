"""Anchor box regression / classification heads.

Counterpart of ``instance_segmentation_tpu/models/heads.py``: one shared
separable-conv tower applied at every pyramid level, with its own batch-norm
set per level. Each level's NCHW output is permuted to NHWC before the
``reshape(B, -1, 4|C)``, so anchors come level-major, then row-major cell,
then anchor index, as ``models/anchors.generate_anchors`` lays them out.

Attribute names follow the reference torch state dict (``conv_list.i``,
``bn_list.level.i``, ``header``).
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn

from instance_segmentation_torch.models.layers import BatchNorm, SeparableConv


class _Tower(nn.Module):
    def __init__(self, channels: int, num_layers: int, pyramid_levels: int,
                 out_channels: int, per_anchor: int):
        super().__init__()
        self.per_anchor = per_anchor
        self.conv_list = nn.ModuleList(
            SeparableConv(channels, channels, norm=False) for _ in range(num_layers))
        self.bn_list = nn.ModuleList(
            nn.ModuleList(BatchNorm(channels) for _ in range(num_layers))
            for _ in range(pyramid_levels))
        self.header = SeparableConv(channels, out_channels, norm=False)

    def forward(self, feats: List[torch.Tensor]) -> torch.Tensor:
        outs = []
        for x, bns in zip(feats, self.bn_list):
            for conv, bn in zip(self.conv_list, bns):
                x = bn(conv(x), act="silu")
            x = self.header(x).permute(0, 2, 3, 1)
            outs.append(x.reshape(x.shape[0], -1, self.per_anchor))
        return torch.cat(outs, dim=1)


class Regressor(_Tower):
    """(B, sum_A, 4) box deltas (dy, dx, dh, dw), in the compute dtype."""

    def __init__(self, channels: int, num_anchors: int, num_layers: int,
                 pyramid_levels: int = 5):
        super().__init__(channels, num_layers, pyramid_levels, num_anchors * 4, 4)


class Classifier(_Tower):
    """(B, sum_A, C) sigmoid scores, float32."""

    def __init__(self, channels: int, num_anchors: int, num_classes: int,
                 num_layers: int, pyramid_levels: int = 5):
        super().__init__(channels, num_layers, pyramid_levels,
                         num_anchors * num_classes, num_classes)

    def forward(self, feats: List[torch.Tensor]) -> torch.Tensor:
        return torch.sigmoid(super().forward(feats).float())
