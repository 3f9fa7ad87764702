"""BiFPN feature pyramid over P3..P7 (P3..P8 with ``use_p8``), NCHW.

Counterpart of ``instance_segmentation_tpu/models/bifpn.py``: top-down then
bottom-up passes with fast-attention fusion ``relu(w) / (sum + 1e-4)`` or,
for ``attention=False``, plain sums. The first cell down-channels the raw
backbone maps, builds P6/P7 (and P8) from P5 by zero-padded SAME max pools,
and takes a second pair of down-channeled P4/P5 maps for the bottom-up skip.
With ``use_p8`` (compound_coef 8) the top-down pass starts at P8
(``conv7_up`` over P7 and upsampled P8, fusion ``p7_w1``), P7's bottom-up
fusion ``p7_w2`` takes P7's top-down map too, and ``conv8_down`` fuses P8
with the pooled P7 output (``p8_w2``).

Attribute names follow the reference torch state dict (``conv6_up``,
``p5_to_p6.0``, ``p6_w1`` ...).
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.layers import (
    BatchNorm, Conv2dSame, SeparableConv, max_pool_same, swish,
    upsample_nearest_2x,
)

# fusion name -> number of fused inputs
_FUSIONS = {"p6_w1": 2, "p5_w1": 2, "p4_w1": 2, "p3_w1": 2,
            "p4_w2": 3, "p5_w2": 3, "p6_w2": 3, "p7_w2": 2}
_FUSIONS_P8 = {**_FUSIONS, "p7_w1": 2, "p7_w2": 3, "p8_w2": 2}


def _down_channel(in_channels: int, channels: int) -> nn.Sequential:
    """1x1 conv + BN (state-dict keys ``<name>.0.conv`` / ``<name>.1``)."""
    return nn.Sequential(Conv2dSame(in_channels, channels, 1), BatchNorm(channels))


class BiFPNCell(nn.Module):
    def __init__(self, channels: int, conv_channels: Sequence[int],
                 first_time: bool = False, attention: bool = True,
                 use_p8: bool = False, epsilon: float = 1e-4):
        super().__init__()
        self.first_time = first_time
        self.attention = attention
        self.use_p8 = use_p8
        self.epsilon = epsilon
        convs = ("conv6_up", "conv5_up", "conv4_up", "conv3_up",
                 "conv4_down", "conv5_down", "conv6_down", "conv7_down")
        for name in convs + (("conv7_up", "conv8_down") if use_p8 else ()):
            setattr(self, name, SeparableConv(channels, channels))
        if first_time:
            p3, p4, p5 = conv_channels
            self.p5_to_p6 = _down_channel(p5, channels)
            self.p3_down_channel = _down_channel(p3, channels)
            self.p4_down_channel = _down_channel(p4, channels)
            self.p5_down_channel = _down_channel(p5, channels)
            self.p4_down_channel_2 = _down_channel(p4, channels)
            self.p5_down_channel_2 = _down_channel(p5, channels)
        if attention:
            for name, n in (_FUSIONS_P8 if use_p8 else _FUSIONS).items():
                setattr(self, name, nn.Parameter(torch.ones(n)))

    def _fuse(self, name: str, inputs: List[torch.Tensor]) -> torch.Tensor:
        if not self.attention:
            return swish(sum(inputs[1:], inputs[0]))
        w = F.relu(getattr(self, name))
        w = (w / (w.sum() + self.epsilon)).to(inputs[0].dtype)
        out = w[0] * inputs[0]
        for i, t in enumerate(inputs[1:], start=1):
            out = out + w[i] * t
        return swish(out)

    def forward(self, feats: List[torch.Tensor]) -> List[torch.Tensor]:
        if self.first_time:
            p3, p4, p5 = feats
            p6_in = max_pool_same(self.p5_to_p6(p5))
            p7_in = max_pool_same(p6_in)
            p8_in = max_pool_same(p7_in) if self.use_p8 else None
            p3_in = self.p3_down_channel(p3)
            p4_in = self.p4_down_channel(p4)
            p5_in = self.p5_down_channel(p5)
        elif self.use_p8:
            p3_in, p4_in, p5_in, p6_in, p7_in, p8_in = feats
        else:
            p3_in, p4_in, p5_in, p6_in, p7_in = feats

        up = upsample_nearest_2x
        if self.use_p8:
            p7_up = self.conv7_up(self._fuse("p7_w1", [p7_in, up(p8_in)]))
            p6_up = self.conv6_up(self._fuse("p6_w1", [p6_in, up(p7_up)]))
        else:
            p6_up = self.conv6_up(self._fuse("p6_w1", [p6_in, up(p7_in)]))
        p5_up = self.conv5_up(self._fuse("p5_w1", [p5_in, up(p6_up)]))
        p4_up = self.conv4_up(self._fuse("p4_w1", [p4_in, up(p5_up)]))
        p3_out = self.conv3_up(self._fuse("p3_w1", [p3_in, up(p4_up)]))

        if self.first_time:
            p4_in = self.p4_down_channel_2(feats[1])
            p5_in = self.p5_down_channel_2(feats[2])

        p4_out = self.conv4_down(
            self._fuse("p4_w2", [p4_in, p4_up, max_pool_same(p3_out)]))
        p5_out = self.conv5_down(
            self._fuse("p5_w2", [p5_in, p5_up, max_pool_same(p4_out)]))
        p6_out = self.conv6_down(
            self._fuse("p6_w2", [p6_in, p6_up, max_pool_same(p5_out)]))
        if self.use_p8:
            p7_out = self.conv7_down(
                self._fuse("p7_w2", [p7_in, p7_up, max_pool_same(p6_out)]))
            p8_out = self.conv8_down(self._fuse("p8_w2", [p8_in, max_pool_same(p7_out)]))
            return [p3_out, p4_out, p5_out, p6_out, p7_out, p8_out]
        p7_out = self.conv7_down(
            self._fuse("p7_w2", [p7_in, max_pool_same(p6_out)]))
        return [p3_out, p4_out, p5_out, p6_out, p7_out]


class BiFPN(nn.ModuleList):
    """A stack of ``repeats`` cells (state-dict keys ``bifpn.<i>.*``)."""

    def __init__(self, channels: int, conv_channels: Sequence[int], repeats: int,
                 attention: bool = True, use_p8: bool = False):
        super().__init__(BiFPNCell(channels, conv_channels, first_time=(i == 0),
                                   attention=attention, use_p8=use_p8)
                         for i in range(repeats))

    def forward(self, feats: List[torch.Tensor]) -> List[torch.Tensor]:
        for cell in self:
            feats = cell(feats)
        return feats
