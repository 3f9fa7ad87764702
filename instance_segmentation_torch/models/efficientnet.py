"""EfficientNet-B0..B8 and EfficientNetV2-S/M/L backbones (feature-pyramid
variant), NCHW.

Counterpart of ``instance_segmentation_tpu/models/efficientnet.py``, standard
layout only. Attribute names follow the reference torch state dict
(``_conv_stem``, ``_bn0``, ``_blocks.N._expand_conv`` ...), so
``tools/convert_torch_weights.convert_state_dict`` maps this module's
``state_dict()`` onto the flax tree.

A backbone is named ``efficientnet-b0`` .. ``efficientnet-b8`` (the B0 stage
table scaled by ``round_filters`` / ``round_repeats``) or
``efficientnetv2-s`` / ``-m`` / ``-l`` (Tan & Le, arXiv:2104.00298: the stage
tables ``v2_s_block``, ``v2_m_block``, ``v2_l_block`` of google/automl's
``efficientnetv2/effnetv2_configs.py``, widths as written). A V2 backbone
starts with Fused-MBConv stages (``FusedMBConv``: one full k x k conv
carrying the block's stride into the expanded width, BN + SiLU, then a 1x1
project + BN; with expand ratio 1 the k x k conv alone, BN + SiLU; no
squeeze-and-excitation) and goes on with MBConv stages. Its fused blocks'
convs are named as an MBConv's (``_expand_conv``, ``_bn0``,
``_project_conv``, ``_bn2``), so the weight mapping needs no rule of its
own. The forward opens a ``utils/profiling.span`` around each run of
blocks of one kind: ``backbone.fused`` and ``backbone.mbconv``.

Returns the five snapshots [P1..P5]: the activation just before each
stride-2 block, and the final block output. In training, block ``idx`` of
``total`` applies drop-connect at rate ``drop_connect_rate * idx / total`` on
its identity skip, drawn from the backbone's ``generator`` (torch's default
generator when None). With ``quant`` the MBConv expand and project convs
and the fused blocks' 1x1 project convs take the int8 path outside training
(reference ``quant``; SE, depthwise, fused k x k and stem convs stay in the
compute dtype). Under a spatial mesh
(``parallel/spatial.sharded``) the blocks take W slabs: the stem, depthwise
and fused k x k convs exchange halos (``models/layers.py``) and each
squeeze-and-excitation mean is the float32 sum of the slabs over the
spatial group, divided by the global H * W.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import List, Optional, Tuple, Union

import torch
from torch import nn

from instance_segmentation_torch.kernels import bn_act
from instance_segmentation_torch.models.layers import (
    BatchNorm, Conv2dSame, depthwise_conv, drop_connect, frozen, swish,
)
from instance_segmentation_torch.parallel import spatial
from instance_segmentation_torch.utils.profiling import span


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


FUSED, MBCONV = "fused", "mbconv"     # the two kinds of block

# EfficientNetV2: (stem width, stages as (kind, BlockArgs)), the automl tables
V2_TABLES = {
    "efficientnetv2-s": (24, (
        (FUSED, BlockArgs(3, 2, 24, 24, 1, 1, 0.0)),
        (FUSED, BlockArgs(3, 4, 24, 48, 4, 2, 0.0)),
        (FUSED, BlockArgs(3, 4, 48, 64, 4, 2, 0.0)),
        (MBCONV, BlockArgs(3, 6, 64, 128, 4, 2, 0.25)),
        (MBCONV, BlockArgs(3, 9, 128, 160, 6, 1, 0.25)),
        (MBCONV, BlockArgs(3, 15, 160, 256, 6, 2, 0.25)))),
    "efficientnetv2-m": (24, (
        (FUSED, BlockArgs(3, 3, 24, 24, 1, 1, 0.0)),
        (FUSED, BlockArgs(3, 5, 24, 48, 4, 2, 0.0)),
        (FUSED, BlockArgs(3, 5, 48, 80, 4, 2, 0.0)),
        (MBCONV, BlockArgs(3, 7, 80, 160, 4, 2, 0.25)),
        (MBCONV, BlockArgs(3, 14, 160, 176, 6, 1, 0.25)),
        (MBCONV, BlockArgs(3, 18, 176, 304, 6, 2, 0.25)),
        (MBCONV, BlockArgs(3, 5, 304, 512, 6, 1, 0.25)))),
    "efficientnetv2-l": (32, (
        (FUSED, BlockArgs(3, 4, 32, 32, 1, 1, 0.0)),
        (FUSED, BlockArgs(3, 7, 32, 64, 4, 2, 0.0)),
        (FUSED, BlockArgs(3, 7, 64, 96, 4, 2, 0.0)),
        (MBCONV, BlockArgs(3, 10, 96, 192, 4, 2, 0.25)),
        (MBCONV, BlockArgs(3, 19, 192, 224, 6, 1, 0.25)),
        (MBCONV, BlockArgs(3, 25, 224, 384, 6, 2, 0.25)),
        (MBCONV, BlockArgs(3, 7, 384, 640, 6, 1, 0.25)))),
}
BACKBONES = tuple(f"efficientnet-b{v}" for v in SCALING) + tuple(V2_TABLES)
SPANS = {FUSED: "backbone.fused", MBCONV: "backbone.mbconv"}


def backbone_name(backbone: Union[int, str]) -> str:
    """The name of a backbone given by name or by B-series variant number;
    raises on a name this module does not build."""
    name = f"efficientnet-b{backbone}" if isinstance(backbone, int) else backbone
    if name not in BACKBONES:
        raise ValueError(f"unknown backbone {backbone!r}: one of {', '.join(BACKBONES)}")
    return name


def _table(backbone: Union[int, str]) -> Tuple[int, List[Tuple[str, BlockArgs]]]:
    """(stem width, stages as (kind, BlockArgs)) of the backbone."""
    name = backbone_name(backbone)
    if name in V2_TABLES:
        stem, table = V2_TABLES[name]
        return stem, list(table)
    variant = int(name.rpartition("-b")[2])
    return (round_filters(32, SCALING[variant][0]),
            [(MBCONV, b) for b in scaled_blocks(variant)])


def stages(backbone: Union[int, str]) -> List[Tuple[str, BlockArgs]]:
    """The backbone's stages as (kind, BlockArgs)."""
    return _table(backbone)[1]


def stem_filters(backbone: Union[int, str]) -> int:
    return _table(backbone)[0]


def feature_channels(backbone: Union[int, str]) -> List[int]:
    """Channels of [P1..P5]."""
    blocks = [b for _, b in stages(backbone)]
    chans = [blocks[i - 1].output_filters
             for i, b in enumerate(blocks) if b.stride == 2 and i > 0]
    chans.append(blocks[-1].output_filters)
    return chans


def flat_blocks(backbone: Union[int, str]) -> List[Tuple[str, BlockArgs]]:
    """The per-block list of (kind, BlockArgs): each stage's first block,
    then its repeats."""
    flat = []
    for kind, b in stages(backbone):
        flat.append((kind, b))
        flat.extend((kind, BlockArgs(b.kernel_size, 1, b.output_filters, b.output_filters,
                                     b.expand_ratio, 1, b.se_ratio))
                    for _ in range(b.num_repeat - 1))
    return flat


def _residual(block: nn.Module, x: torch.Tensor, inputs: torch.Tensor,
              generator: Optional[torch.Generator]) -> torch.Tensor:
    """The identity skip of a same-shape block, drop-connect on it in
    training."""
    a = block.args
    if a.id_skip and a.stride == 1 and a.input_filters == a.output_filters:
        if block.training and block.drop_rate > 0.0:
            x = drop_connect(x, block.drop_rate, generator)
        x = x + inputs
    return x


class MBConv(nn.Module):
    """Mobile inverted bottleneck: expand -> depthwise -> SE -> project, with
    the identity skip on same-shape blocks (drop-connect on it in training)."""

    def __init__(self, a: BlockArgs, drop_rate: float = 0.0, quant: bool = False):
        super().__init__()
        self.args = a
        self.drop_rate = drop_rate
        expanded = a.input_filters * a.expand_ratio
        if a.expand_ratio != 1:
            self._expand_conv = Conv2dSame(a.input_filters, expanded, 1, bias=False,
                                           quant=quant)
            self._bn0 = BatchNorm(expanded)
        self._depthwise_conv = depthwise_conv(expanded, a.kernel_size, a.stride)
        self._bn1 = BatchNorm(expanded)
        self.has_se = bool(a.se_ratio) and 0 < a.se_ratio <= 1
        if self.has_se:
            squeezed = max(1, int(a.input_filters * a.se_ratio))
            self._se_reduce = Conv2dSame(expanded, squeezed, 1)
            self._se_expand = Conv2dSame(squeezed, expanded, 1)
        self._project_conv = Conv2dSame(expanded, a.output_filters, 1, bias=False,
                                        quant=quant)
        self._bn2 = BatchNorm(a.output_filters)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        a = self.args
        inputs = x
        if a.expand_ratio != 1:
            x = self._bn0(self._expand_conv(x), act="silu")
        x = self._bn1(self._depthwise_conv(x), act="silu")
        if self.has_se:
            mesh = spatial.active()
            s = (x.mean(dim=(2, 3), keepdim=True) if mesh is None
                 else spatial.spatial_mean(x, mesh))
            gate = torch.sigmoid(self._se_expand(swish(self._se_reduce(s))))
            x = (bn_act.bn_act(x, gate.reshape(gate.shape[:2]).contiguous()) if frozen(self)
                 else gate * x)
        x = self._bn2(self._project_conv(x))
        return _residual(self, x, inputs, generator)


class FusedMBConv(nn.Module):
    """Fused-MBConv (EfficientNetV2): a full k x k conv with the block's
    stride into the expanded width, BN + SiLU, then a 1x1 project + BN; with
    expand ratio 1 the k x k conv is the project conv, followed by BN +
    SiLU. No squeeze-and-excitation; the identity skip as MBConv's."""

    def __init__(self, a: BlockArgs, drop_rate: float = 0.0, quant: bool = False):
        super().__init__()
        self.args = a
        self.drop_rate = drop_rate
        if a.expand_ratio != 1:
            expanded = a.input_filters * a.expand_ratio
            self._expand_conv = Conv2dSame(a.input_filters, expanded, a.kernel_size,
                                           stride=a.stride, bias=False)
            self._bn0 = BatchNorm(expanded)
            self._project_conv = Conv2dSame(expanded, a.output_filters, 1, bias=False,
                                            quant=quant)
        else:
            self._project_conv = Conv2dSame(a.input_filters, a.output_filters, a.kernel_size,
                                            stride=a.stride, bias=False)
        self._bn2 = BatchNorm(a.output_filters)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        inputs = x
        if self.args.expand_ratio != 1:
            x = self._bn2(self._project_conv(self._bn0(self._expand_conv(x), act="silu")))
        else:
            x = self._bn2(self._project_conv(x), act="silu")
        return _residual(self, x, inputs, generator)


BLOCKS = {FUSED: FusedMBConv, MBCONV: MBConv}


class EfficientNetFeatures(nn.Module):
    """Backbone producing the five pyramid snapshots [P1..P5]; ``backbone``
    is a name of ``BACKBONES`` or a B-series variant number."""

    def __init__(self, backbone: Union[int, str] = 0, drop_connect_rate: float = 0.2,
                 quant: bool = False):
        super().__init__()
        stem = stem_filters(backbone)
        self._conv_stem = Conv2dSame(3, stem, 3, stride=2, bias=False)
        self._bn0 = BatchNorm(stem)
        flat = flat_blocks(backbone)
        self._blocks = nn.ModuleList(
            BLOCKS[kind](b, drop_connect_rate * idx / len(flat), quant)
            for idx, (kind, b) in enumerate(flat))
        blocks = iter(self._blocks)            # runs of blocks of one kind, by span name
        self._runs = [(SPANS[kind], [next(blocks) for _ in run])
                      for kind, run in itertools.groupby(kind for kind, _ in flat)]
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self._bn0(self._conv_stem(x), act="silu")
        features = []
        for name, blocks in self._runs:
            with span(name):
                for block in blocks:
                    if block.args.stride == 2:
                        features.append(x)
                    x = block(x, self.generator)
        features.append(x)
        return features
