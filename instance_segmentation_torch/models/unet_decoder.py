"""U-Net dense decoder producing the kp / ae / tan heads at input resolution.

Counterpart of the standard path of
``instance_segmentation_tpu/models/unet_decoder.py``: from P5, four stages of
(2x2 stride-2 transposed conv -> skip concat -> two 3x3 conv+BN+ReLU) up
through P4..P1, then the input stage that concatenates the normalized image,
then 1x1 heads cast to float32:

    kp: 1 channel, ae: 4 channels, tan: 2 channels.

Batch norm here uses the torch-default eps 1e-5 and flax momentum 0.9.
With ``quant`` the 3x3 convs of every double conv take the int8 path
outside training (reference ``quant``); transposed convs and heads do not.
Attribute names follow the reference torch state dict (``up_conv1``,
``double_conv1.0`` ...). Under a spatial mesh it runs on W slabs of the
image and of P1..P5: each 3x3 conv takes halos of one column
(``layers.Conv2d``); the 2x2 stride-2 transposed convs and the
concatenations need none.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
from torch import nn

from instance_segmentation_torch.models.layers import (
    BN_EPS_UNET, BN_MOMENTUM_UNET, BatchNorm, Conv2d, ConvTranspose2d,
)

HEADS: Tuple[Tuple[str, int], ...] = (("kp", 1), ("ae", 4), ("tan", 2))


class _DoubleConv(nn.Sequential):
    """Two (3x3 conv, BN, ReLU); keys ``.0/.3`` conv and ``.1/.4`` BN. Each
    BN applies the ReLU after it (``BatchNorm(act="relu")``); the
    ``nn.ReLU`` entries keep the reference's indices."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv0, bn0, _, conv1, bn1, _ = self
        return bn1(conv1(bn0(conv0(x), act="relu")), act="relu")


def _double_conv(in_channels: int, channels: int, quant: bool = False) -> _DoubleConv:
    return _DoubleConv(
        Conv2d(in_channels, channels, 3, padding=1, quant=quant),
        BatchNorm(channels, eps=BN_EPS_UNET, momentum=BN_MOMENTUM_UNET), nn.ReLU(),
        Conv2d(channels, channels, 3, padding=1, quant=quant),
        BatchNorm(channels, eps=BN_EPS_UNET, momentum=BN_MOMENTUM_UNET), nn.ReLU())


class UNetDecoder(nn.Module):
    def __init__(self, block_channels: List[int], image_channels: int = 3,
                 stage_channels: Tuple[int, ...] = (256, 128, 64, 32),
                 input_stage_channels: int = 16, quant: bool = False):
        super().__init__()
        prev = block_channels[-1]
        for i, ch in enumerate(stage_channels, start=1):
            skip = block_channels[-(i + 1)]
            setattr(self, f"up_conv{i}", ConvTranspose2d(prev, ch, 2, stride=2))
            setattr(self, f"double_conv{i}", _double_conv(ch + skip, ch, quant))
            prev = ch
        ic = input_stage_channels
        self.up_conv_input = ConvTranspose2d(prev, ic, 2, stride=2)
        self.double_conv_input = _double_conv(ic + image_channels, ic, quant)
        for name, ch in HEADS:
            setattr(self, name, Conv2d(ic, ch, 1))
        self.num_stages = len(stage_channels)

    def forward(self, image: torch.Tensor, blocks: List[torch.Tensor]
                ) -> Tuple[torch.Tensor, ...]:
        """image: the normalized model input; blocks: [P1..P5]. Returns
        (kp, ae, tan) as NCHW float32."""
        x = blocks[-1]
        for i in range(1, self.num_stages + 1):
            x = getattr(self, f"up_conv{i}")(x)
            x = torch.cat([x, blocks[-(i + 1)]], dim=1)
            x = getattr(self, f"double_conv{i}")(x)
        x = self.up_conv_input(x)
        x = torch.cat([x, image.to(x.dtype)], dim=1)
        x = self.double_conv_input(x)
        return tuple(getattr(self, name)(x).float() for name, _ in HEADS)
