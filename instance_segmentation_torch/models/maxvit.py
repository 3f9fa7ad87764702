"""MaxViT backbone (feature-pyramid variant): convolution, windowed and
dilated-global attention in every block.

Source: Tu et al., "MaxViT: Multi-Axis Vision Transformer", ECCV 2022,
arXiv:2204.01697, and its reference code (google-research/maxvit). MaxViT-B:
stem 64, stages of (2, 6, 14, 2) blocks at (96, 192, 384, 768) channels,
head dim 32, MBConv expansion 4, squeeze-and-excitation 0.25, MLP ratio 4.

Maps are [B, C, H, W] between blocks (the port's convs' layout; channels-last
in memory when the frames came in NHWC) and are viewed as tokens [B, H, W, C]
inside a block's transformer parts. The equations, for a block from C_in to C
channels with stride s (2 in each stage's first block, stage 1's included):

* Stem: conv3x3 stride 2 (no bias), BN + GELU, conv3x3 (bias, no norm); the
  first block's pre-norm follows it.
* MBConv (pre-norm): y = BN(x); y = GELU(BN(conv1x1_{C_in->4C}(y)));
  y = GELU(BN(dwconv3x3_s(y))); y = y * sigmoid(conv1x1_{C/4->4C}(SiLU(
  conv1x1_{4C->C/4}(mean_HW(y))))); y = conv1x1_{4C->C}(y) + bias;
  x = shortcut(x) + y, where the shortcut is the identity, or where the stage
  starts a 2x2 average pool with stride s and a conv1x1_{C_in->C} with bias.
* Block attention: x = x + Attn(LN(x)) over the block partition, then
  x = x + MLP(LN(x)) with MLP = Linear_{4C->C}(GELU(Linear_{C->4C})).
* Grid attention: the same over the grid partition, then the MLP again.
* Partitions of a [B, H, W, C] map, P dividing H and W: the block partition
  groups each P x P window, [B * (H/P) * (W/P), P * P, C]; the grid partition
  puts token (i * H/P + a, j * W/P + b) in group (a, b) at position (i, j),
  P x P tokens spread over the whole map at stride (H/P, W/P).
* Attention over a group of N = P * P tokens t, h = C / 32 heads of d = 32:
  [q | k | v] = Linear_{C->3C}(t), each head's d channels consecutive;
  A = softmax(q k^T / sqrt(d) + B) with B[h, (y1, x1), (y2, x2)] =
  T[h, y1 - y2 + P - 1, x1 - x2 + P - 1], T a learned [h, 2P - 1, 2P - 1]
  table (positions within the group); out = Linear_{C->C}(concat_h(A v)).

GELU is the erf form; layer norm's eps is 1e-5, batch norm's the detector's
(1e-3, momentum 0.99). Departures from the reference code, each one the
benchmark's configuration states under ``assumed``: GELU in the erf form
(the code's tanh approximation), the squeeze-and-excitation width C/4 with
SiLU inside, biases on the QKV, projection and MLP layers and on the MBConv's
project conv, and stochastic depth at ``drop_connect_rate * idx / total`` on
all five residual branches of block ``idx``, drawn in order from the
backbone's ``generator``.

The attention's products and softmax run in the activation dtype as written
(``attention``: two batched matmuls and a softmax), so that they are the
reference's operations bit for bit. Frozen (eval, grad off) batch norms and
the gate run through ``kernels/bn_act`` as EfficientNet's do, GELU included.
Spans (``utils/profiling.span``): ``backbone.mbconv`` around each MBConv,
``backbone.block_attn`` and ``backbone.grid_attn`` around each attention
sub-block (norm, partition, QKV, attention, projection, inverse partition
and residual) and ``backbone.mlp`` around each MLP sub-block.

Returns the five snapshots [P1..P5] = [stem, S1, S2, S3, S4] at strides
2..32. Grid attention needs the whole map, so the spatial mesh (W slabs)
raises, and there is no int8 path (``EfficientSegConfig`` raises).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from instance_segmentation_torch.kernels import bn_act
from instance_segmentation_torch.models.layers import (
    BatchNorm, Conv2dSame, LayerNorm, Linear, depthwise_conv, drop_connect, frozen, swish,
)
from instance_segmentation_torch.parallel import spatial
from instance_segmentation_torch.utils.profiling import span

LN_EPS = 1e-5


@dataclass(frozen=True)
class MaxViTArgs:
    stem: int
    depths: Tuple[int, ...]
    channels: Tuple[int, ...]
    head_dim: int = 32
    partition: int = 16          # P: window size = grid size
    expand: int = 4
    se_ratio: float = 0.25
    mlp_ratio: int = 4


TABLES = {"maxvit-b": MaxViTArgs(64, (2, 6, 14, 2), (96, 192, 384, 768))}
BACKBONES = tuple(TABLES)


def feature_channels(name: str) -> List[int]:
    """Channels of [P1..P5]."""
    args = TABLES[name]
    return [args.stem, *args.channels]


def block_partition(x: torch.Tensor, p: int) -> torch.Tensor:
    """[B, H, W, C] -> [B * (H/p) * (W/p), p * p, C]: each p x p window."""
    b, h, w, c = x.shape
    return x.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5).reshape(-1, p * p, c)


def block_merge(t: torch.Tensor, b: int, h: int, w: int, p: int) -> torch.Tensor:
    """The inverse of ``block_partition``."""
    c = t.shape[-1]
    return t.reshape(b, h // p, w // p, p, p, c).permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


def grid_partition(x: torch.Tensor, p: int) -> torch.Tensor:
    """[B, H, W, C] -> [B * (H/p) * (W/p), p * p, C]: group (a, b) holds the
    tokens (i * H/p + a, j * W/p + b) at position (i, j)."""
    b, h, w, c = x.shape
    return x.reshape(b, p, h // p, p, w // p, c).permute(0, 2, 4, 1, 3, 5).reshape(-1, p * p, c)


def grid_merge(t: torch.Tensor, b: int, h: int, w: int, p: int) -> torch.Tensor:
    """The inverse of ``grid_partition``."""
    c = t.shape[-1]
    return t.reshape(b, h // p, w // p, p, p, c).permute(0, 3, 1, 4, 2, 5).reshape(b, h, w, c)


PARTITIONS = {"block": (block_partition, block_merge), "grid": (grid_partition, grid_merge)}


def relative_index(p: int) -> torch.Tensor:
    """[p * p, p * p] int64: the flat index into a [2p - 1, 2p - 1] table of
    the offset (y1 - y2 + p - 1, x1 - x2 + p - 1) between positions
    (y1, x1) and (y2, x2) of a p x p group."""
    y, x = (a.flatten() for a in torch.meshgrid(torch.arange(p), torch.arange(p), indexing="ij"))
    return (y[:, None] - y[None, :] + p - 1) * (2 * p - 1) + (x[:, None] - x[None, :] + p - 1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              bias: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(d) + bias) v over [G, heads, N, d], in q's dtype
    (q scaled first; the logits and the softmax rounded to it)."""
    logits = torch.matmul(q * q.shape[-1] ** -0.5, k.transpose(-2, -1)) + bias
    return torch.matmul(logits.softmax(dim=-1), v)


class RelativeAttention(nn.Module):
    """Layer norm, then multi-head self-attention with a relative-position
    bias inside the groups of the ``kind`` partition ("block" or "grid"),
    merged back: the branch of a [B, H, W, C] map (the residual is the
    block's)."""

    def __init__(self, channels: int, head_dim: int, partition: int, kind: str):
        super().__init__()
        self.heads, self.partition, self.kind = channels // head_dim, partition, kind
        self.norm = LayerNorm(channels, eps=LN_EPS)
        self.qkv = Linear(channels, 3 * channels)
        self.proj = Linear(channels, channels)
        self.rel_bias = nn.Parameter(torch.zeros(self.heads, 2 * partition - 1,
                                                 2 * partition - 1))
        self.register_buffer("rel_index", relative_index(partition), persistent=False)

    def bias(self, dtype: torch.dtype) -> torch.Tensor:
        """B [heads, N, N] gathered from the table, in ``dtype``."""
        return self.rel_bias.reshape(self.heads, -1)[:, self.rel_index].to(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        p = self.partition
        split, merge = PARTITIONS[self.kind]
        t = split(self.norm(x), p)
        g, n, _ = t.shape
        q, k, v = self.qkv(t).reshape(g, n, 3, self.heads, c // self.heads).permute(
            2, 0, 3, 1, 4).unbind(0)
        out = attention(q, k, v, self.bias(x.dtype)).transpose(1, 2).reshape(g, n, c)
        return merge(self.proj(out), b, h, w, p)


class MLP(nn.Module):
    """Layer norm, then Linear_{C->rC}, GELU, Linear_{rC->C}: the branch of a
    [B, H, W, C] map."""

    def __init__(self, channels: int, ratio: int):
        super().__init__()
        self.norm = LayerNorm(channels, eps=LN_EPS)
        self.fc1 = Linear(channels, ratio * channels)
        self.fc2 = Linear(ratio * channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(self.norm(x))))


class MaxViTBlock(nn.Module):
    """MBConv, block attention, MLP, grid attention, MLP (the module
    docstring's equations), [B, C_in, H, W] -> [B, C, H/s, W/s]."""

    def __init__(self, a: MaxViTArgs, cin: int, cout: int, stride: int, drop_rate: float):
        super().__init__()
        self.stride, self.drop_rate = stride, drop_rate
        mid = cout * a.expand
        self._pre_norm = BatchNorm(cin)
        self._expand_conv = Conv2dSame(cin, mid, 1, bias=False)
        self._bn0 = BatchNorm(mid)
        self._depthwise_conv = depthwise_conv(mid, 3, stride)
        self._bn1 = BatchNorm(mid)
        squeezed = max(1, int(cout * a.se_ratio))
        self._se_reduce = Conv2dSame(mid, squeezed, 1)
        self._se_expand = Conv2dSame(squeezed, mid, 1)
        self._project_conv = Conv2dSame(mid, cout, 1)
        if cin != cout:
            self._shortcut_conv = Conv2dSame(cin, cout, 1)
        self.block_attn = RelativeAttention(cout, a.head_dim, a.partition, "block")
        self.block_mlp = MLP(cout, a.mlp_ratio)
        self.grid_attn = RelativeAttention(cout, a.head_dim, a.partition, "grid")
        self.grid_mlp = MLP(cout, a.mlp_ratio)

    def _residual(self, x: torch.Tensor, branch: torch.Tensor,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
        if self.training and self.drop_rate > 0.0:
            branch = drop_connect(branch, self.drop_rate, generator)
        return x + branch

    def _mbconv(self, x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        shortcut = F.avg_pool2d(x, self.stride) if self.stride > 1 else x
        if hasattr(self, "_shortcut_conv"):
            shortcut = self._shortcut_conv(shortcut)
        y = self._bn0(self._expand_conv(self._pre_norm(x)), act="gelu")
        y = self._bn1(self._depthwise_conv(y), act="gelu")
        gate = torch.sigmoid(self._se_expand(swish(self._se_reduce(
            y.mean(dim=(2, 3), keepdim=True)))))
        y = (bn_act.bn_act(y, gate.reshape(gate.shape[:2]).contiguous()) if frozen(self)
             else gate * y)
        return self._residual(shortcut, self._project_conv(y), generator)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        with span("backbone.mbconv"):
            x = self._mbconv(x, generator)
        t = x.permute(0, 2, 3, 1)
        for name, attn, mlp in (("backbone.block_attn", self.block_attn, self.block_mlp),
                                ("backbone.grid_attn", self.grid_attn, self.grid_mlp)):
            with span(name):
                t = self._residual(t, attn(t), generator)
            with span("backbone.mlp"):
                t = self._residual(t, mlp(t), generator)
        return t.permute(0, 3, 1, 2)


class MaxViTFeatures(nn.Module):
    """The backbone ``name`` of ``TABLES``, returning [P1..P5]. Its input's H
    and W must be multiples of 32 x P."""

    def __init__(self, name: str, drop_connect_rate: float = 0.2):
        super().__init__()
        a = self.args = TABLES[name]
        self._conv_stem = Conv2dSame(3, a.stem, 3, stride=2, bias=False)
        self._bn0 = BatchNorm(a.stem)
        self._conv_stem2 = Conv2dSame(a.stem, a.stem, 3)
        shapes, cin = [], a.stem
        for depth, cout in zip(a.depths, a.channels):
            shapes += [(cin, cout, 2)] + [(cout, cout, 1)] * (depth - 1)
            cin = cout
        self._blocks = nn.ModuleList(
            MaxViTBlock(a, cin, cout, stride, drop_connect_rate * idx / len(shapes))
            for idx, (cin, cout, stride) in enumerate(shapes))
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        if spatial.active() is not None:
            raise ValueError("MaxViT's grid attention spans the whole map: it takes no "
                             "spatial mesh (W slabs)")
        step = 32 * self.args.partition
        if x.shape[-2] % step or x.shape[-1] % step:
            raise ValueError(f"MaxViT with partition {self.args.partition} takes H and W that "
                             f"are multiples of {step}, got {tuple(x.shape[-2:])}")
        x = self._conv_stem2(self._bn0(self._conv_stem(x), act="gelu"))
        features = []
        for block in self._blocks:
            if block.stride == 2:
                features.append(x)
            x = block(x, self.generator)
        return features + [x]
