"""MaxViT backbone (feature-pyramid variant), written from the paper in plain
torch on the frozen primitives of ``layers.py`` (TF-SAME convs, the
detector's batch norm, drop-connect): NCHW maps between blocks, [B, H, W, C]
tokens inside the transformer parts, attention as explicit products and a
softmax (no fused attention kernel). Used in float32 as the reference, and in
the configuration's compute dtype as the floor of ``correct``.

Source: Tu et al., "MaxViT: Multi-Axis Vision Transformer", ECCV 2022,
arXiv:2204.01697; google-research/maxvit. ``TABLES`` holds MaxViT-B: stem 64,
stages of (2, 6, 14, 2) blocks at (96, 192, 384, 768) channels, head dim 32,
MBConv expansion 4, squeeze-and-excitation 0.25, MLP ratio 4, partition
P = 16 (the reference code's window and grid size for 512-pixel inputs).

A block from C_in to C channels with stride s (2 in each stage's first
block, stage 1's included), in order:

* MBConv (pre-norm): y = BN(x); y = GELU(BN(conv1x1_{C_in->4C}(y)));
  y = GELU(BN(dwconv3x3_s(y))); y = y * sigmoid(conv1x1_{C/4->4C}(SiLU(
  conv1x1_{4C->C/4}(mean_HW(y))))); y = conv1x1_{4C->C}(y) + bias;
  x = shortcut(x) + y, the shortcut the identity, or where the stage starts a
  2x2 average pool with stride s and a conv1x1_{C_in->C} with bias.
* Block attention over each P x P window of the [B, H, W, C] map, then an
  MLP; grid attention over the P x P grid whose group (a, b) holds the
  tokens (i * H/P + a, j * W/P + b) at position (i, j), then an MLP. Each
  sub-block is pre-norm: x = x + f(LN(x)).
* Attention, h = C / 32 heads of d = 32 over the N = P * P tokens of a
  group: [q | k | v] = Linear_{C->3C}(t) (each head's d channels
  consecutive), A = softmax(q k^T / sqrt(d) + B), B[h, (y1, x1), (y2, x2)] =
  T[h, y1 - y2 + P - 1, x1 - x2 + P - 1], out = Linear_{C->C}(concat_h(A v)).
* MLP: Linear_{4C->C}(GELU(Linear_{C->4C}(t))).

The stem is conv3x3 stride 2, BN + GELU, conv3x3 with bias and no norm.
GELU is the erf form; layer norm's eps 1e-5; batch norm the detector's (eps
1e-3, momentum 0.99). Departures from the reference code (the configuration
lists them under ``assumed``): erf GELU where the code takes the tanh
approximation; squeeze-and-excitation C/4 wide with SiLU inside; biases on
the QKV, projection and MLP layers and the project conv; stochastic depth at
``rate * idx / total`` on all five residual branches of block ``idx``, drawn
in order from the backbone's ``generator``.

Dtype policy, the convs' of ``layers.py``: linear weights and biases cast to
the activation dtype per call; layer-norm parameters and the bias tables
float32, cast per call; the logits and the softmax in the activation dtype.
Module and parameter names follow the port's, so that the tree of
``weights_maxvit.py`` maps onto both. The snapshots [P1..P5] are the stem's
output and each stage's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.layers import BatchNorm, Conv2dSame, depthwise_conv, drop_connect


@dataclass(frozen=True)
class MaxViTArgs:
    stem: int
    depths: Tuple[int, ...]
    channels: Tuple[int, ...]
    head_dim: int = 32
    partition: int = 16
    expand: int = 4
    se_ratio: float = 0.25
    mlp_ratio: int = 4


TABLES = {"maxvit-b": MaxViTArgs(64, (2, 6, 14, 2), (96, 192, 384, 768))}


def feature_channels(name: str) -> List[int]:
    """Channels of [P1..P5]."""
    a = TABLES[name]
    return [a.stem, *a.channels]


def group_tokens(x: torch.Tensor, p: int, kind: str) -> torch.Tensor:
    """[B, H, W, C] -> [groups, p * p, C]: the windows ("block") or the
    dilated grid ("grid"), group by group, position (row, column) inside."""
    b, h, w, c = x.shape
    if kind == "block":       # [b, H/p (wy), p (i), W/p (wx), p (j), c]
        return x.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5).reshape(
            -1, p * p, c)
    # [b, p (i), H/p (a), p (j), W/p (bx), c]: row i * H/p + a
    return x.reshape(b, p, h // p, p, w // p, c).permute(0, 2, 4, 1, 3, 5).reshape(-1, p * p, c)


def ungroup_tokens(t: torch.Tensor, shape: torch.Size, p: int, kind: str) -> torch.Tensor:
    """The inverse of ``group_tokens`` back to ``shape`` [B, H, W, C]."""
    b, h, w, c = shape
    t = t.reshape(b, h // p, w // p, p, p, c)
    order = (0, 1, 3, 2, 4, 5) if kind == "block" else (0, 3, 1, 4, 2, 5)
    return t.permute(*order).reshape(b, h, w, c)


def relative_bias(table: torch.Tensor) -> torch.Tensor:
    """B [heads, N, N] from the table [heads, 2P - 1, 2P - 1], by its
    definition: B[h, (y1, x1), (y2, x2)] = T[h, y1 - y2 + P - 1, x1 - x2 + P - 1]."""
    p = (table.shape[-1] + 1) // 2
    pos = torch.arange(p, device=table.device)
    dy = pos[:, None, None, None] - pos[None, None, :, None] + p - 1     # [y1, 1, y2, 1]
    dx = pos[None, :, None, None] - pos[None, None, None, :] + p - 1     # [1, x1, 1, x2]
    return table[:, dy, dx].reshape(table.shape[0], p * p, p * p)


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class LayerNorm(nn.LayerNorm):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self.normalized_shape, self.weight.to(x.dtype),
                            self.bias.to(x.dtype), self.eps)


class RelativeAttention(nn.Module):
    """The attention branch of a pre-norm sub-block over ``kind``'s groups."""

    def __init__(self, channels: int, head_dim: int, partition: int, kind: str):
        super().__init__()
        self.heads, self.partition, self.kind = channels // head_dim, partition, kind
        self.norm = LayerNorm(channels, eps=1e-5)
        self.qkv = Linear(channels, 3 * channels)
        self.proj = Linear(channels, channels)
        self.rel_bias = nn.Parameter(torch.zeros(self.heads, 2 * partition - 1,
                                                 2 * partition - 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c, p = x.shape[-1], self.partition
        t = group_tokens(self.norm(x), p, self.kind)
        g, n, _ = t.shape
        qkv = self.qkv(t).reshape(g, n, 3, self.heads, c // self.heads).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]                     # [G, heads, N, d]
        logits = torch.matmul(q * q.shape[-1] ** -0.5, k.transpose(-2, -1))
        logits = logits + relative_bias(self.rel_bias).to(x.dtype)
        out = torch.matmul(torch.softmax(logits, dim=-1), v)
        out = out.transpose(1, 2).reshape(g, n, c)
        return ungroup_tokens(self.proj(out), x.shape, p, self.kind)


class MLP(nn.Module):
    def __init__(self, channels: int, ratio: int):
        super().__init__()
        self.norm = LayerNorm(channels, eps=1e-5)
        self.fc1 = Linear(channels, ratio * channels)
        self.fc2 = Linear(ratio * channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(self.norm(x))))


class Block(nn.Module):
    """One MaxViT block (see the module docstring)."""

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
        self._shortcut_conv = Conv2dSame(cin, cout, 1) if cin != cout else None
        self.block_attn = RelativeAttention(cout, a.head_dim, a.partition, "block")
        self.block_mlp = MLP(cout, a.mlp_ratio)
        self.grid_attn = RelativeAttention(cout, a.head_dim, a.partition, "grid")
        self.grid_mlp = MLP(cout, a.mlp_ratio)

    def _add(self, x, branch, generator):
        if self.training and self.drop_rate > 0.0:
            branch = drop_connect(branch, self.drop_rate, generator)
        return x + branch

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        shortcut = x
        if self.stride > 1:
            shortcut = F.avg_pool2d(shortcut, self.stride)
        if self._shortcut_conv is not None:
            shortcut = self._shortcut_conv(shortcut)
        y = F.gelu(self._bn0(self._expand_conv(self._pre_norm(x))))
        y = F.gelu(self._bn1(self._depthwise_conv(y)))
        s = y.mean(dim=(2, 3), keepdim=True)
        y = torch.sigmoid(self._se_expand(F.silu(self._se_reduce(s)))) * y
        x = self._add(shortcut, self._project_conv(y), generator)
        t = x.permute(0, 2, 3, 1)
        for attn, mlp in ((self.block_attn, self.block_mlp), (self.grid_attn, self.grid_mlp)):
            t = self._add(t, attn(t), generator)
            t = self._add(t, mlp(t), generator)
        return t.permute(0, 3, 1, 2)


class MaxViTFeatures(nn.Module):
    """The backbone ``name`` of ``TABLES``, returning [P1..P5]."""

    def __init__(self, name: str, drop_connect_rate: float = 0.2):
        super().__init__()
        a = TABLES[name]
        self._conv_stem = Conv2dSame(3, a.stem, 3, stride=2, bias=False)
        self._bn0 = BatchNorm(a.stem)
        self._conv_stem2 = Conv2dSame(a.stem, a.stem, 3)
        shapes, cin = [], a.stem
        for depth, cout in zip(a.depths, a.channels):
            shapes += [(cin, cout, 2)] + [(cout, cout, 1)] * (depth - 1)
            cin = cout
        self._blocks = nn.ModuleList(Block(a, ci, co, s, drop_connect_rate * i / len(shapes))
                                     for i, (ci, co, s) in enumerate(shapes))
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self._conv_stem2(F.gelu(self._bn0(self._conv_stem(x))))
        features = []
        for block in self._blocks:
            if block.stride == 2:
                features.append(x)
            x = block(x, self.generator)
        return features + [x]
