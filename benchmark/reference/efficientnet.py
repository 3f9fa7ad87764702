"""EfficientNet-B0..B8 backbone (feature-pyramid variant), NCHW.

Counterpart of ``instance_segmentation_tpu/models/efficientnet.py``, standard
layout only. Attribute names follow the reference torch state dict
(``_conv_stem``, ``_bn0``, ``_blocks.N._expand_conv`` ...), so
``tools/convert_torch_weights.convert_state_dict`` maps this module's
``state_dict()`` onto the flax tree.

Returns the five snapshots [P1..P5]: the activation just before each
stride-2 block, and the final block output. In training, block ``idx`` of
``total`` applies drop-connect at rate ``drop_connect_rate * idx / total`` on
its identity skip, drawn from the backbone's ``generator`` (torch's default
generator when None). Frozen from the port's ``models/efficientnet.py``
without its int8 and spatial paths.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
from torch import nn

from benchmark.reference.layers import (
    BatchNorm, Conv2dSame, depthwise_conv, drop_connect, swish,
)


@dataclass(frozen=True)
class BlockArgs:
    kernel_size: int
    num_repeat: int
    input_filters: int
    output_filters: int
    expand_ratio: int
    stride: int
    se_ratio: float
    id_skip: bool = True


# The canonical 7-stage B0 architecture.
BASE_BLOCKS: Tuple[BlockArgs, ...] = (
    BlockArgs(3, 1, 32, 16, 1, 1, 0.25),
    BlockArgs(3, 2, 16, 24, 6, 2, 0.25),
    BlockArgs(5, 2, 24, 40, 6, 2, 0.25),
    BlockArgs(3, 3, 40, 80, 6, 2, 0.25),
    BlockArgs(5, 3, 80, 112, 6, 1, 0.25),
    BlockArgs(5, 4, 112, 192, 6, 2, 0.25),
    BlockArgs(3, 1, 192, 320, 6, 1, 0.25),
)

# width, depth coefficients per variant.
SCALING = {
    0: (1.0, 1.0), 1: (1.0, 1.1), 2: (1.1, 1.2), 3: (1.2, 1.4), 4: (1.4, 1.8),
    5: (1.6, 2.2), 6: (1.8, 2.6), 7: (2.0, 3.1), 8: (2.2, 3.6),
}


def round_filters(filters: int, width_coefficient: float, divisor: int = 8) -> int:
    """Width scaling with divisor rounding."""
    filters *= width_coefficient
    new_filters = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new_filters < 0.9 * filters:
        new_filters += divisor
    return int(new_filters)


def round_repeats(repeats: int, depth_coefficient: float) -> int:
    return int(math.ceil(depth_coefficient * repeats))


def scaled_blocks(variant: int) -> List[BlockArgs]:
    w, d = SCALING[variant]
    return [BlockArgs(kernel_size=b.kernel_size,
                      num_repeat=round_repeats(b.num_repeat, d),
                      input_filters=round_filters(b.input_filters, w),
                      output_filters=round_filters(b.output_filters, w),
                      expand_ratio=b.expand_ratio, stride=b.stride,
                      se_ratio=b.se_ratio)
            for b in BASE_BLOCKS]


def stem_filters(variant: int) -> int:
    return round_filters(32, SCALING[variant][0])


def feature_channels(variant: int) -> List[int]:
    """Channels of [P1..P5]."""
    blocks = scaled_blocks(variant)
    chans = [blocks[i - 1].output_filters
             for i, b in enumerate(blocks) if b.stride == 2 and i > 0]
    chans.append(blocks[-1].output_filters)
    return chans


def flat_blocks(variant: int) -> List[BlockArgs]:
    """The per-block list: each stage's first block, then its repeats."""
    flat = []
    for b in scaled_blocks(variant):
        flat.append(b)
        flat.extend(BlockArgs(b.kernel_size, 1, b.output_filters, b.output_filters,
                              b.expand_ratio, 1, b.se_ratio)
                    for _ in range(b.num_repeat - 1))
    return flat


class MBConv(nn.Module):
    """Mobile inverted bottleneck: expand -> depthwise -> SE -> project, with
    the identity skip on same-shape blocks (drop-connect on it in training)."""

    def __init__(self, a: BlockArgs, drop_rate: float = 0.0):
        super().__init__()
        self.args = a
        self.drop_rate = drop_rate
        expanded = a.input_filters * a.expand_ratio
        if a.expand_ratio != 1:
            self._expand_conv = Conv2dSame(a.input_filters, expanded, 1, bias=False)
            self._bn0 = BatchNorm(expanded)
        self._depthwise_conv = depthwise_conv(expanded, a.kernel_size, a.stride)
        self._bn1 = BatchNorm(expanded)
        self.has_se = bool(a.se_ratio) and 0 < a.se_ratio <= 1
        if self.has_se:
            squeezed = max(1, int(a.input_filters * a.se_ratio))
            self._se_reduce = Conv2dSame(expanded, squeezed, 1)
            self._se_expand = Conv2dSame(squeezed, expanded, 1)
        self._project_conv = Conv2dSame(expanded, a.output_filters, 1, bias=False)
        self._bn2 = BatchNorm(a.output_filters)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        a = self.args
        inputs = x
        if a.expand_ratio != 1:
            x = swish(self._bn0(self._expand_conv(x)))
        x = swish(self._bn1(self._depthwise_conv(x)))
        if self.has_se:
            s = x.mean(dim=(2, 3), keepdim=True)
            s = self._se_expand(swish(self._se_reduce(s)))
            x = torch.sigmoid(s) * x
        x = self._bn2(self._project_conv(x))
        if a.id_skip and a.stride == 1 and a.input_filters == a.output_filters:
            if self.training and self.drop_rate > 0.0:
                x = drop_connect(x, self.drop_rate, generator)
            x = x + inputs
        return x


class EfficientNetFeatures(nn.Module):
    """Backbone producing the five pyramid snapshots [P1..P5]."""

    def __init__(self, variant: int = 0, drop_connect_rate: float = 0.2):
        super().__init__()
        stem = stem_filters(variant)
        self._conv_stem = Conv2dSame(3, stem, 3, stride=2, bias=False)
        self._bn0 = BatchNorm(stem)
        flat = flat_blocks(variant)
        self._blocks = nn.ModuleList(MBConv(b, drop_connect_rate * idx / len(flat))
                                     for idx, b in enumerate(flat))
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = swish(self._bn0(self._conv_stem(x)))
        features = []
        for block in self._blocks:
            if block.args.stride == 2:
                features.append(x)
            x = block(x, self.generator)
        features.append(x)
        return features
