"""EfficientNetV2-S/M/L backbone (feature-pyramid variant), NCHW, written from
the stage tables in plain torch on the frozen primitives of ``layers.py``
(TF-SAME padding, the detector's batch norm, SiLU, drop-connect), so that
padding and batch-norm eps match the B-series reference.

Source: Tan & Le, "EfficientNetV2: Smaller Models and Faster Training",
arXiv:2104.00298 (Table 4: V2-S); the tables ``v2_s_block``, ``v2_m_block``
and ``v2_l_block`` of google/automl ``efficientnetv2/effnetv2_configs.py``.
A stage is ``(kind, kernel, stride, expand, in, out, repeats, se)``:

* ``fused`` (Fused-MBConv): a full k x k conv with the block's stride into
  ``in * expand`` channels, BN, SiLU, then a 1x1 project conv and BN; with
  expand 1 the k x k conv is the project conv, then BN and SiLU. No SE.
* ``mbconv``: 1x1 expand, BN, SiLU, depthwise k x k with the stride, BN,
  SiLU, squeeze-and-excitation (``max(1, int(in * se))`` channels, SiLU,
  sigmoid), 1x1 project, BN.

A block whose stride is 1 and whose in equals out adds its input, with
drop-connect at ``rate * idx / total`` on the skip in training, as the V2
code's ``survival_prob`` rule gives it. The stem is a 3x3 stride-2 conv,
BN, SiLU. The snapshots [P1..P5] are the activation just before each
stride-2 block and the last block's output; the V2 head (1x1 conv to 1280,
pooling, classifier) is not part of the feature backbone.

Departures from the V2 code, each as the port and the B-series reference
have it: batch norm keeps the detector's momentum (0.99, flax convention)
where V2 trains with 0.9 (it matters in training only), and its eps is
1e-3 as V2's. Conv and batch-norm attributes carry the names of an MBConv
(``_expand_conv``, ``_bn0``, ``_project_conv``, ``_bn2``) so that
``weights.py``'s rules map them.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from benchmark.reference.layers import (
    BatchNorm, Conv2dSame, depthwise_conv, drop_connect, swish,
)

FUSED, MBCONV = "fused", "mbconv"

# name -> (stem width, stages (kind, kernel, stride, expand, in, out, repeats, se))
TABLES = {
    "efficientnetv2-s": (24, (
        (FUSED, 3, 1, 1, 24, 24, 2, 0.0),
        (FUSED, 3, 2, 4, 24, 48, 4, 0.0),
        (FUSED, 3, 2, 4, 48, 64, 4, 0.0),
        (MBCONV, 3, 2, 4, 64, 128, 6, 0.25),
        (MBCONV, 3, 1, 6, 128, 160, 9, 0.25),
        (MBCONV, 3, 2, 6, 160, 256, 15, 0.25))),
    "efficientnetv2-m": (24, (
        (FUSED, 3, 1, 1, 24, 24, 3, 0.0),
        (FUSED, 3, 2, 4, 24, 48, 5, 0.0),
        (FUSED, 3, 2, 4, 48, 80, 5, 0.0),
        (MBCONV, 3, 2, 4, 80, 160, 7, 0.25),
        (MBCONV, 3, 1, 6, 160, 176, 14, 0.25),
        (MBCONV, 3, 2, 6, 176, 304, 18, 0.25),
        (MBCONV, 3, 1, 6, 304, 512, 5, 0.25))),
    "efficientnetv2-l": (32, (
        (FUSED, 3, 1, 1, 32, 32, 4, 0.0),
        (FUSED, 3, 2, 4, 32, 64, 7, 0.0),
        (FUSED, 3, 2, 4, 64, 96, 7, 0.0),
        (MBCONV, 3, 2, 4, 96, 192, 10, 0.25),
        (MBCONV, 3, 1, 6, 192, 224, 19, 0.25),
        (MBCONV, 3, 2, 6, 224, 384, 25, 0.25),
        (MBCONV, 3, 1, 6, 384, 640, 7, 0.25))),
}


def blocks(name: str) -> List[Tuple]:
    """One (kind, kernel, stride, expand, in, out, se) a block: each stage's
    first block, then its repeats at stride 1 from ``out`` to ``out``."""
    out = []
    for kind, k, s, e, cin, cout, r, se in TABLES[name][1]:
        out.append((kind, k, s, e, cin, cout, se))
        out.extend((kind, k, 1, e, cout, cout, se) for _ in range(r - 1))
    return out


def feature_channels(name: str) -> List[int]:
    """Channels of [P1..P5]."""
    flat = blocks(name)
    chans = [flat[i - 1][5] for i, b in enumerate(flat) if b[2] == 2 and i > 0]
    return chans + [flat[-1][5]]


class Block(nn.Module):
    """One Fused-MBConv or MBConv block (see the module docstring)."""

    def __init__(self, kind: str, k: int, stride: int, expand: int, cin: int, cout: int,
                 se: float, drop_rate: float):
        super().__init__()
        self.kind, self.stride, self.drop_rate = kind, stride, drop_rate
        self.residual = stride == 1 and cin == cout
        mid = cin * expand
        if kind == FUSED:
            if expand != 1:
                self._expand_conv = Conv2dSame(cin, mid, k, stride=stride, bias=False)
                self._bn0 = BatchNorm(mid)
                self._project_conv = Conv2dSame(mid, cout, 1, bias=False)
            else:
                self._project_conv = Conv2dSame(cin, cout, k, stride=stride, bias=False)
            self._bn2 = BatchNorm(cout)
            return
        self._expand_conv = Conv2dSame(cin, mid, 1, bias=False)
        self._bn0 = BatchNorm(mid)
        self._depthwise_conv = depthwise_conv(mid, k, stride)
        self._bn1 = BatchNorm(mid)
        squeezed = max(1, int(cin * se))
        self._se_reduce = Conv2dSame(mid, squeezed, 1)
        self._se_expand = Conv2dSame(squeezed, mid, 1)
        self._project_conv = Conv2dSame(mid, cout, 1, bias=False)
        self._bn2 = BatchNorm(cout)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        y = x
        if self.kind == FUSED:
            if hasattr(self, "_expand_conv"):
                y = swish(self._bn0(self._expand_conv(y)))
                y = self._bn2(self._project_conv(y))
            else:
                y = swish(self._bn2(self._project_conv(y)))
        else:
            y = swish(self._bn0(self._expand_conv(y)))
            y = swish(self._bn1(self._depthwise_conv(y)))
            s = y.mean(dim=(2, 3), keepdim=True)
            y = torch.sigmoid(self._se_expand(swish(self._se_reduce(s)))) * y
            y = self._bn2(self._project_conv(y))
        if not self.residual:
            return y
        if self.training and self.drop_rate > 0.0:
            y = drop_connect(y, self.drop_rate, generator)
        return y + x


class EfficientNetV2Features(nn.Module):
    """The backbone ``name`` of ``TABLES``, returning [P1..P5]."""

    def __init__(self, name: str, drop_connect_rate: float = 0.2):
        super().__init__()
        stem = TABLES[name][0]
        self._conv_stem = Conv2dSame(3, stem, 3, stride=2, bias=False)
        self._bn0 = BatchNorm(stem)
        flat = blocks(name)
        self._blocks = nn.ModuleList(Block(*b, drop_connect_rate * i / len(flat))
                                     for i, b in enumerate(flat))
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = swish(self._bn0(self._conv_stem(x)))
        features = []
        for block in self._blocks:
            if block.stride == 2:
                features.append(x)
            x = block(x, self.generator)
        return features + [x]

