"""Shared layers: TF-SAME convs, batch norm, separable conv, drop-connect (NCHW),
and the transformer's linear layer and layer norm (over the last axis).

Counterpart of ``instance_segmentation_tpu/models/layers.py``. The reference
gets TF-SAME padding from XLA's ``padding="SAME"``; torch's ``padding="same"``
refuses stride 2, so the pads are computed here, asymmetric (the extra pixel
goes bottom/right) exactly as XLA does.

Dtype policy, as in the reference: every conv casts its weight and bias to
the activation (compute) dtype per call. Serving holds them in the compute
dtype already (``cast_convs``), so the cast is free; training holds float32
master weights, as flax does (``param_dtype=f32``, ``dtype=bf16``), and the
gradient flows back through the cast. Batch-norm parameters and statistics
stay float32, and the per-channel ``scale``/``shift`` are formed in float32
and cast to the activation dtype before they are applied. ``Linear`` follows
the convs' policy (``cast_convs`` holds it in the compute dtype too);
``LayerNorm`` keeps its weight and bias in float32, as batch norm does, and
casts them to the activation dtype per call. A frozen module
(``frozen``: eval with grad disabled) applies them, with the activation that
follows and the squeeze-and-excitation gate, through the op
``kernels/bn_act.bn_act``: one kernel on a CUDA tensor, the same
composition on a CPU tensor.

Batch norm follows ``nn.Module.train()``/``.eval()``: batch statistics (the
biased variance) and a flax-style running-average update in training, the
running statistics in eval. Given a process group (``set_batchnorm_group``),
its training statistics are those of the global batch over the group's ranks,
as the reference's batch statistics are global reductions over a batch
sharded across devices.

The int8 inference path (reference ``_Int8Conv``): a dense conv made with
``quant=True`` computes, outside training, an int8 x int8 -> int32 conv
from float32 weights quantized per output channel and the input quantized
per tensor, then dequantizes (``int8_conv2d``). Its parameters are those
of the float conv, held in float32 (``cast_convs`` leaves them), so a float
checkpoint or JAX tree loads unchanged.

Under a spatial mesh (``parallel/spatial.sharded``) the convs with a W
extent take their rank's W slab: TF-SAME pads come from the global width,
the slab is padded with its neighbours' columns (``halo_exchange``), and
the conv runs with no W padding of its own. 1x1 convs need nothing.
``pin_data_sharding`` gathers a W-split map onto every rank of the spatial
group, where the JAX package pins it to batch-only sharding.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from instance_segmentation_torch.kernels import bn_act
from instance_segmentation_torch.parallel import spatial
from instance_segmentation_torch.utils.profiling import span

# Detector-side BN constants and U-Net BN constants (reference layers.py
# BN_MOMENTUM_DET/BN_EPS_DET and BN_MOMENTUM_UNET/BN_EPS_UNET). Momentum is
# the flax convention: running = m * running + (1 - m) * batch.
BN_MOMENTUM_DET = 0.99
BN_EPS_DET = 1e-3
BN_MOMENTUM_UNET = 0.9
BN_EPS_UNET = 1e-5


def same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """(before, after) TF-SAME padding of an axis of length n."""
    total = max((math.ceil(n / s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _cast(t, dtype: torch.dtype):
    return None if t is None else t.to(dtype)


def quantize_int8(x: torch.Tensor, weight: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reference ``_Int8Conv``'s quantization, op for op: (x_q int8,
    s_x [] float32, w_q int8 [O, I, kh, kw], s_w [O] float32) with
    ``s_w = max(max|W| over (I, kh, kw), 1e-8) / 127``, ``w_q = round(W /
    s_w)``, ``s_x = max(max|x|, 1e-8) / 127`` and ``x_q = clip(round(x /
    s_x), -127, 127)``; rounding half to even, as ``jnp.round``."""
    w = weight.float()
    s_w = torch.clamp_min(w.abs().amax(dim=(1, 2, 3)), 1e-8) / 127.0
    w_q = torch.round(w / s_w[:, None, None, None]).to(torch.int8)
    xf = x.float()
    s_x = torch.clamp_min(xf.abs().amax(), 1e-8) / 127.0
    x_q = torch.clamp(torch.round(xf / s_x), -127, 127).to(torch.int8)
    return x_q, s_x, w_q, s_w


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def int8_accumulate(x_q: torch.Tensor, w_q: torch.Tensor, padding: int) -> torch.Tensor:
    """The exact int32 stride-1 conv of int8 x_q [B, C, H, W] and w_q [O, C,
    k, k] with ``padding`` zeros on every side -> int32 [B, O, H', W']: an
    im2col of shifted slices of the NHWC input (none for a 1x1) and one
    ``torch._int_mm`` (cuBLASLt on the card, an exact int32 product on the
    CPU). Its shape rules (more than 16 rows, K and N multiples of 8) are
    met by zero padding, which keeps the sums exact."""
    if x_q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"int8 conv runs on cuda or cpu tensors, not {x_q.device}")
    B, C, H, W = x_q.shape
    O, _, kh, kw = w_q.shape
    ho, wo = H + 2 * padding - kh + 1, W + 2 * padding - kw + 1
    K, N = kh * kw * C, O
    Kp, Np, M = _round_up(K, 8), _round_up(N, 8), B * ho * wo
    xh = x_q.permute(0, 2, 3, 1)
    if padding:
        xh = F.pad(xh, (0, 0, padding, padding, padding, padding))
    cols = [xh[:, i:i + ho, j:j + wo, :] for i in range(kh) for j in range(kw)]
    if Kp > K:
        cols.append(xh.new_zeros((B, ho, wo, Kp - K)))
    a = torch.cat(cols, dim=-1).reshape(M, Kp)
    if M <= 16:
        a = torch.cat([a, a.new_zeros((17 - M, Kp))])
    wm = F.pad(w_q.permute(0, 2, 3, 1).reshape(O, K), (0, Kp - K, 0, Np - N))
    acc = torch._int_mm(a, wm.t())                                    # [M', Np] int32
    return acc[:M, :N].reshape(B, ho, wo, N).permute(0, 3, 1, 2)


def int8_conv2d(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                padding: int) -> torch.Tensor:
    """The reference ``_Int8Conv`` (stride 1): ``quantize_int8``, the exact
    int32 conv, then ``acc * (s_x * s_w) + bias`` in float32, cast to x's
    dtype."""
    x_q, s_x, w_q, s_w = quantize_int8(x, weight)
    y = int8_accumulate(x_q, w_q, padding).float() * (s_x * s_w)[:, None, None]
    if bias is not None:
        y = y + bias.float()[:, None, None]
    return y.to(x.dtype)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` whose weight and bias are cast to the input dtype. With
    ``quant=True`` (a dense stride-1 conv) it runs ``int8_conv2d`` outside
    training. Under a spatial mesh a (stride-1, SAME-padded: the U-Net's)
    conv takes halos from its neighbours in place of its W padding."""

    layer_name = "Conv2d"           # set to the module's path by EfficientSeg

    def __init__(self, *args, quant: bool = False, **kwargs):
        super().__init__(*args, **kwargs)
        if quant and (self.groups != 1 or self.stride != (1, 1)):
            raise ValueError("the int8 path takes dense stride-1 convs only")
        self.quant = quant

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.quant and not self.training:
            return int8_conv2d(x, self.weight, self.bias, self.padding[0])
        mesh = spatial.active()
        if mesh is not None and self.kernel_size[1] > 1:
            left, right = spatial.conv_halo(x.shape[-1], self.kernel_size[1], 1,
                                            self.padding[1], self.layer_name)
            return F.conv2d(spatial.halo_exchange(x, left, right, mesh), self.weight.to(x.dtype),
                            _cast(self.bias, x.dtype), 1, (self.padding[0], 0), 1, self.groups)
        return self._conv_forward(x, self.weight.to(x.dtype), _cast(self.bias, x.dtype))


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` whose weight and bias are cast to the input
    dtype. The U-Net's (kernel = stride, no padding) need no halo on a W
    slab: each output column reads one input column."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(x, self.weight.to(x.dtype), _cast(self.bias, x.dtype),
                                  self.stride, self.padding, self.output_padding,
                                  self.groups, self.dilation)


class Conv2dSame(nn.Module):
    """2D conv with TF-SAME padding. The inner ``conv`` carries the reference
    torch state-dict names (``<name>.conv.weight``)."""

    layer_name = "Conv2dSame"       # set to the module's path by EfficientSeg

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, groups: int = 1, bias: bool = True, quant: bool = False):
        super().__init__()
        self.conv = Conv2d(in_channels, out_channels, kernel_size, stride,
                           padding=0, groups=groups, bias=bias, quant=quant)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv = self.conv
        k, s = conv.kernel_size[0], conv.stride[0]
        mesh = spatial.active()
        if mesh is not None and (k, s) != (1, 1):
            return self._forward_slab(x, mesh)
        top, bottom = same_pads(x.shape[-2], k, s)
        left, right = same_pads(x.shape[-1], k, s)
        if top != bottom or left != right:
            x = F.pad(x, (left, right, top, bottom))
            top = left = 0
        if conv.quant and not conv.training:
            return int8_conv2d(x, conv.weight, conv.bias, top)
        return F.conv2d(x, conv.weight.to(x.dtype), _cast(conv.bias, x.dtype), s,
                        (top, left), 1, conv.groups)

    def _forward_slab(self, x: torch.Tensor, mesh) -> torch.Tensor:
        """The conv of the whole image, cut at this rank's output columns,
        from its W slab: pads from the global width, halos from the
        neighbours (``spatial.conv_halo``)."""
        conv = self.conv
        k, s = conv.kernel_size[0], conv.stride[0]
        width = x.shape[-1]
        pad_left, _ = same_pads(width * mesh.spatial, k, s)
        left, right = spatial.conv_halo(width, k, s, pad_left, self.layer_name)
        if left or right:
            x = spatial.halo_exchange(x, left, right, mesh)
        top, bottom = same_pads(x.shape[-2], k, s)
        if top != bottom:
            x = F.pad(x, (0, 0, top, bottom))
            top = 0
        return F.conv2d(x, conv.weight.to(x.dtype), _cast(conv.bias, x.dtype), s,
                        (top, 0), 1, conv.groups)


def pin_data_sharding(x: torch.Tensor) -> torch.Tensor:
    """``x`` whole on every rank of the spatial group when a spatial mesh is
    active (its W slabs gathered), else ``x`` (reference
    ``pin_data_sharding``)."""
    mesh = spatial.active()
    return x if mesh is None else spatial.gather_w(x, mesh)


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


def frozen(module: nn.Module) -> bool:
    """Whether ``module`` runs its eval forward with grad disabled: then its
    batch norms keep their coefficients and apply them, with the activation
    after them and the gate, through ``bn_act.bn_act``."""
    return not module.training and not torch.is_grad_enabled()


class _AllReduceSum(torch.autograd.Function):
    """The sum of ``x`` over the ranks of ``group``. Every rank's loss depends
    on the sum, so the backward sums the cotangent over the ranks too. Each
    all-reduce opens an "allreduce:bn" span."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        out = x.clone()
        with span("allreduce:bn"):
            dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.contiguous().clone()
        with span("allreduce:bn"):
            dist.all_reduce(grad, group=ctx.group)
        return grad, None


class BatchNorm(nn.Module):
    """Batch norm as ``x * scale_eff + shift``, the per-channel coefficients
    formed in float32 and cast to the activation dtype.

    Training (reference ``_bn_train_math`` and ``_FastBN``): mean and
    ``E[x^2]`` over N, H, W accumulated in float32, the biased variance
    ``max(E[x^2] - mean^2, 0)``, and the running statistics updated in place
    as ``m * running + (1 - m) * batch``. ``torch.nn.BatchNorm2d`` keeps the
    unbiased variance and the other momentum convention, so it is not used.
    Autograd gives the backward. Like ``EfficientSeg``, it starts in eval
    mode: training is asked for with ``.train()``.

    With ``process_group`` set (``set_batchnorm_group``), the float32
    per-channel sums of x and x^2 and the element count are summed over the
    group's ranks (differentiably) before the mean and variance are formed:
    every rank gets the statistics of the global batch, and so the same
    running statistics. ``torch.nn.SyncBatchNorm`` keeps the conventions of
    ``BatchNorm2d`` and is not used either.

    ``act`` ("none", "silu", "relu", "gelu") is the activation applied after the
    norm. Frozen (``frozen``: eval with grad disabled), the module applies
    it with ``bn_act.bn_act`` and keeps its coefficients, one pair for each
    activation dtype and device. It forms them again only when the storage
    or version (``_version``) of the weight, bias or a running statistic
    changes, as after an in-place load or a training step, and writes them
    into the tensors it keeps. So a CUDA graph captured after the first
    frozen call reads the coefficients of the newest frozen call: after a
    change to the weights, one eager call brings every graph up to date
    (``serve.ServingModel``). Where the sources have no storage or version
    to key on (fake tensors under ``torch.export`` or ``torch.compile``,
    the meta device, inference tensors), they are formed on every call."""

    def __init__(self, channels: int, eps: float = BN_EPS_DET,
                 momentum: float = BN_MOMENTUM_DET):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.process_group = None
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self._kept = {}     # (dtype, device) -> [key, scale, shift] of the frozen coefficients
        self.eval()

    def _batch_moments(self, xf: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mean, E[x^2]) per channel of float32 ``xf``, over the global batch
        when a process group is set."""
        if self.process_group is None:
            return xf.mean(dim=(0, 2, 3)), xf.square().mean(dim=(0, 2, 3))
        c = xf.shape[1]
        sums = torch.cat([xf.sum(dim=(0, 2, 3)), xf.square().sum(dim=(0, 2, 3)),
                          xf.new_full((1,), xf.numel() // c)])
        sums = _AllReduceSum.apply(sums, self.process_group)
        return sums[:c] / sums[2 * c], sums[c:2 * c] / sums[2 * c]

    def _coefficients(self, mean: torch.Tensor, var: torch.Tensor,
                      dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
        """(scale, shift) [C], formed in float32 and cast to ``dtype``."""
        scale = self.weight * torch.rsqrt(var + self.eps)
        shift = self.bias - mean * scale
        return scale.to(dtype), shift.to(dtype)

    def _frozen_coefficients(self, dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
        """The eval coefficients in ``dtype``, kept while their sources are
        unchanged and rewritten in place when they change (see the class)."""
        sources = (self.weight, self.bias, self.running_mean, self.running_var)
        if (torch.compiler.is_compiling() or self.weight.device.type == "meta"
                or any(t.is_inference() for t in sources)):
            return self._coefficients(self.running_mean, self.running_var, dtype)
        key = tuple((t.data_ptr(), t._version) for t in sources)
        kept = self._kept.get((dtype, self.weight.device))
        if kept is not None and kept[0] == key:
            return kept[1:]
        # outside inference mode, so that a later call outside it can write them
        with torch.inference_mode(False), torch.no_grad():
            coefficients = self._coefficients(self.running_mean, self.running_var, dtype)
            if kept is None:
                kept = self._kept[(dtype, self.weight.device)] = [key, *coefficients]
            else:
                for held, new in zip(kept[1:], coefficients):
                    held.copy_(new)
                kept[0] = key
        return kept[1:]

    def forward(self, x: torch.Tensor, act: str = "none") -> torch.Tensor:
        if frozen(self):
            return bn_act.bn_act(x, *self._frozen_coefficients(x.dtype), act)
        if self.training:
            mean, mean_sq = self._batch_moments(x.float())
            var = torch.clamp_min(mean_sq - mean.square(), 0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        return bn_act.bn_act_plain(x, *self._coefficients(mean, var, x.dtype), act)


def set_batchnorm_group(module: nn.Module, group) -> int:
    """Give every ``BatchNorm`` in ``module`` the process group whose ranks'
    batches its training statistics cover (None: this rank's batch alone).
    Returns the number of batch norms set."""
    norms = [m for m in module.modules() if isinstance(m, BatchNorm)]
    for m in norms:
        m.process_group = group
    return len(norms)


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
            return self.bn(x, act="silu" if self.activation else "none")
        return swish(x) if self.activation else x


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


class Linear(nn.Linear):
    """``nn.Linear`` whose weight and bias are cast to the input dtype per
    call, as a conv's are."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), _cast(self.bias, x.dtype))


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` over the last axis (eps 1e-5) whose float32 weight and
    bias are cast to the input dtype per call; ``F.layer_norm`` forms the
    statistics in float32 and rounds its output to the input dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self.normalized_shape, self.weight.to(x.dtype),
                            self.bias.to(x.dtype), self.eps)


def cast_convs(module: nn.Module, dtype: torch.dtype) -> None:
    """Hold every conv / transposed-conv / linear weight and bias in
    ``dtype``; batch and layer norm, fusion weights, relative-position bias
    tables and the int8 path's convs (quantized from float32, as the
    reference's) stay float32."""
    for m in module.modules():
        if (isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear))
                and not getattr(m, "quant", False)):
            m.to(dtype)
