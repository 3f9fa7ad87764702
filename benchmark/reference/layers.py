"""Shared layers: TF-SAME convs, batch norm, separable conv, drop-connect
(NCHW), frozen from the port's ``models/layers.py`` without its int8 path,
its spatial (W-slab) path and its cross-rank batch statistics.

TF-SAME padding is asymmetric (the extra pixel goes bottom/right). Every
conv casts its weight and bias to the activation dtype per call; batch-norm
parameters and statistics stay float32, the per-channel ``scale``/``shift``
formed in float32 and cast to the activation dtype. Batch norm follows
``nn.Module.train()``/``.eval()``: batch statistics (the biased variance)
and a flax-style running-average update in training, the running
statistics in eval.

``set_fp8`` makes every conv take its products in float8, as an fp8
training recipe does: its input and weight rounded to e4m3 and the
gradient of its output to e5m2, each under a per-tensor scale (``fp8_round``,
``Fp8Grad``); the lower-precision control of a bfloat16 configuration.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# Detector-side BN constants and U-Net BN constants (reference layers.py
# BN_MOMENTUM_DET/BN_EPS_DET and BN_MOMENTUM_UNET/BN_EPS_UNET). Momentum is
# the flax convention: running = m * running + (1 - m) * batch.
BN_MOMENTUM_DET = 0.99
BN_EPS_DET = 1e-3
BN_MOMENTUM_UNET = 0.9
BN_EPS_UNET = 1e-5
E4M3_MAX, E5M2_MAX = 448.0, 57344.0    # the largest float8 numbers


def same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """(before, after) TF-SAME padding of an axis of length n."""
    total = max((math.ceil(n / s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _cast(t, dtype: torch.dtype):
    return None if t is None else t.to(dtype)


def _rounded(t: torch.Tensor, dtype: torch.dtype, largest: float) -> torch.Tensor:
    """``t`` rounded to the float8 ``dtype`` under a per-tensor scale (its max
    magnitude to ``largest``) and back, in ``t``'s dtype."""
    scale = torch.clamp_min(t.abs().amax().float(), 1e-12) / largest
    return ((t.float() / scale).to(dtype).float() * scale).to(t.dtype)


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to e4m3; the gradient passes straight through."""
    return t + (_rounded(t.detach(), torch.float8_e4m3fn, E4M3_MAX) - t).detach()


class Fp8Grad(torch.autograd.Function):
    """The identity, whose gradient is rounded to e5m2."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return _rounded(g, torch.float8_e5m2, E5M2_MAX)


def _conv(conv, x: torch.Tensor, call):
    """``call(input, weight, bias)`` of a conv in ``x``'s dtype, its products
    in float8 when the conv's ``fp8`` is set."""
    w, b = conv.weight.to(x.dtype), _cast(conv.bias, x.dtype)
    if not conv.fp8:
        return call(x, w, b)
    return Fp8Grad.apply(call(fp8_round(x), fp8_round(w), b))


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` whose weight and bias are cast to the input dtype."""

    fp8 = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _conv(self, x, self._conv_forward)


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` whose weight and bias are cast to the input
    dtype."""

    fp8 = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _conv(self, x, lambda x, w, b: F.conv_transpose2d(
            x, w, b, self.stride, self.padding, self.output_padding, self.groups, self.dilation))


class Conv2dSame(nn.Module):
    """2D conv with TF-SAME padding. The inner ``conv`` carries the reference
    torch state-dict names (``<name>.conv.weight``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, groups: int = 1, bias: bool = True):
        super().__init__()
        self.conv = Conv2d(in_channels, out_channels, kernel_size, stride,
                           padding=0, groups=groups, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv = self.conv
        k, s = conv.kernel_size[0], conv.stride[0]
        top, bottom = same_pads(x.shape[-2], k, s)
        left, right = same_pads(x.shape[-1], k, s)
        if top != bottom or left != right:
            x = F.pad(x, (left, right, top, bottom))
            top = left = 0
        return _conv(conv, x, lambda x, w, b: F.conv2d(x, w, b, s, (top, left), 1, conv.groups))


def depthwise_conv(channels: int, kernel_size: int, stride: int = 1) -> Conv2dSame:
    """Depthwise TF-SAME conv without bias (one filter per channel)."""
    return Conv2dSame(channels, channels, kernel_size, stride,
                      groups=channels, bias=False)


def max_pool_same(x: torch.Tensor, window: int = 3, stride: int = 2) -> torch.Tensor:
    """SAME max pool with ZERO padding, as the reference (not -inf: the
    reference model pads the pool input with zeros, which changes border
    values where a window is all negative)."""
    h, w = x.shape[-2], x.shape[-1]
    extra_v = (math.ceil(h / stride) - 1) * stride - h + window
    extra_h = (math.ceil(w / stride) - 1) * stride - w + window
    top, left = extra_v // 2, extra_h // 2
    x = F.pad(x, (left, extra_h - left, top, extra_v - top))
    return F.max_pool2d(x, window, stride)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample."""
    return F.interpolate(x, scale_factor=2.0, mode="nearest")


def swish(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


class BatchNorm(nn.Module):
    """Batch norm as ``x * scale_eff + shift``, the per-channel coefficients
    formed in float32 and cast to the activation dtype.

    Training (reference ``_bn_train_math`` and ``_FastBN``): mean and
    ``E[x^2]`` over N, H, W accumulated in float32, the biased variance
    ``max(E[x^2] - mean^2, 0)``, and the running statistics updated in place
    as ``m * running + (1 - m) * batch``. ``torch.nn.BatchNorm2d`` keeps the
    unbiased variance and the other momentum convention, so it is not used.
    Autograd gives the backward. Like ``EfficientSeg``, it starts in eval
    mode: training is asked for with ``.train()``."""

    def __init__(self, channels: int, eps: float = BN_EPS_DET,
                 momentum: float = BN_MOMENTUM_DET):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            xf = x.float()
            mean, mean_sq = xf.mean(dim=(0, 2, 3)), xf.square().mean(dim=(0, 2, 3))
            var = torch.clamp_min(mean_sq - mean.square(), 0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        scale = self.weight * torch.rsqrt(var + self.eps)
        shift = self.bias - mean * scale
        return (x * scale.to(x.dtype)[:, None, None]
                + shift.to(x.dtype)[:, None, None])


class SeparableConv(nn.Module):
    """Depthwise 3x3 (no bias) + pointwise 1x1 (bias) [+ BN] [+ swish]."""

    def __init__(self, in_channels: int, out_channels: int, norm: bool = True,
                 activation: bool = False):
        super().__init__()
        self.depthwise_conv = depthwise_conv(in_channels, 3)
        self.pointwise_conv = Conv2dSame(in_channels, out_channels, 1)
        self.bn = BatchNorm(out_channels) if norm else None
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.pointwise_conv(self.depthwise_conv(x))
        if self.bn is not None:
            x = self.bn(x)
        if self.activation:
            x = swish(x)
        return x


def drop_connect(x: torch.Tensor, rate: float,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Per-sample stochastic depth (reference ``layers.drop_connect``): a mask
    ``floor(keep + U)`` per sample, U uniform from ``generator`` (drawn on
    the generator's device; torch's default generator of ``x``'s device when
    None), then ``x / keep * mask``."""
    if rate == 0.0:
        return x
    keep = 1.0 - rate
    device = x.device if generator is None else generator.device
    u = torch.rand((x.shape[0], 1, 1, 1), generator=generator, device=device)
    mask = torch.floor(keep + u).to(device=x.device, dtype=x.dtype)
    return (x / keep) * mask


def cast_convs(module: nn.Module, dtype: torch.dtype) -> None:
    """Hold every conv / transposed-conv weight and bias in ``dtype``."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            m.to(dtype)


def set_fp8(module: nn.Module, on: bool = True) -> None:
    """Every conv of ``module`` takes its products in float8 (see the module
    docstring)."""
    for m in module.modules():
        if isinstance(m, (Conv2d, ConvTranspose2d)):
            m.fp8 = on
