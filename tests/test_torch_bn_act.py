"""The eval batch-norm kernel (``kernels/bn_act.py``, ``csrc/bn_act.cu``).

On the CPU: the shapes the serving forwards hand the kernel (``torch_cases.
bn_calls``: every batch norm and squeeze-and-excitation gate of the eval
forward, counted against the model's modules at B0), the op's input
checks and ``torch.library.opcheck`` of the op.

On a CUDA card only (marked ``cuda``): the kernel equal bit for bit to the
composition it replaces (``bn_act_plain``: ``x * scale + shift``, then
``F.silu``, ``F.relu`` or ``F.gelu``; the gate ``sigmoid(s) * x``), compared as integers
so that NaN, infinities and signed zeros count, at every batch-norm and gate
shape of the D3, V2-L and D7x serving forwards at b1, contiguous and
channels-last, in bfloat16 and float32, each batch norm with no activation,
SiLU, ReLU and GELU (MaxViT-B's serving forward too); and at ragged and
unaligned shapes in every dtype:

    python -m pytest --noconftest -m cuda tests/test_torch_bn_act.py
"""

import math

import pytest
import torch
import torch.nn.functional as F

from instance_segmentation_torch.kernels import bn_act
from instance_segmentation_torch.models import EfficientSeg, EfficientSegConfig
from instance_segmentation_torch.models.efficientnet import MBConv
from instance_segmentation_torch.models.layers import BatchNorm

import torch_cases
from torch_cases import cuda_device  # noqa: F401 (a fixture)

torch.set_num_threads(2)
INT_VIEW = {torch.bfloat16: torch.int16, torch.float16: torch.int16, torch.float32: torch.int32}
# the values a pass must carry through as the composition does
ACTS = ("none", "silu", "relu", "gelu")
SPECIAL = (float("nan"), float("inf"), float("-inf"), -0.0, 0.0, 1e-40, -1e-40, 3e38, -3e38,
           -88.5, 88.5, -20.0, 1e-3)


def _identical(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.contiguous().view(INT_VIEW[a.dtype]),
                            b.contiguous().view(INT_VIEW[b.dtype])))


def _inputs(shape, dtype, device, channels_last, per_image, with_shift, seed):
    """(x, scale, shift) with normal values and the ``SPECIAL`` ones at the
    start of x and at the end of the tables."""
    g = torch.Generator(device=device).manual_seed(seed)
    b, c = shape[:2]
    x = torch.randn(shape, generator=g, device=device) * 4
    scale = (torch.sigmoid(torch.randn((b, c), generator=g, device=device) * 4) if per_image
             else torch.randn(c, generator=g, device=device))
    shift = torch.randn(c, generator=g, device=device) if with_shift else None
    for t, at_end in ((x, False), (scale, True), (shift, True)):
        if t is not None:
            flat = t.view(-1)
            k = min(len(SPECIAL), flat.numel())
            (flat[flat.numel() - k:] if at_end else flat[:k]).copy_(
                torch.tensor(SPECIAL[:k], device=device))
    x = x.to(dtype)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    return x, scale.to(dtype), None if shift is None else shift.to(dtype)


def _compare(x, scale, shift, act) -> None:
    before = bn_act.launches
    got = bn_act.bn_act(x, scale, shift, act)
    assert bn_act.launches == before + 1
    want = bn_act.bn_act_plain(x, scale, shift, act)
    if shift is None:       # the gate as MBConv wrote it
        assert _identical(scale[:, :, None, None] * x, want)
    assert _identical(got, want), (tuple(x.shape), x.dtype, x.stride(), act)


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------

def test_bn_calls_are_every_batch_norm_and_gate_of_the_forward():
    cfg = EfficientSegConfig(num_classes=8, compound_coef=0)
    calls = torch_cases.bn_calls(cfg, (128, 256), batch=2)
    model = EfficientSeg(cfg)
    norms = sum(isinstance(m, BatchNorm) for m in model.modules())
    gates = sum(isinstance(m, MBConv) and m.has_se for m in model.modules())
    assert sum(shift for _, _, shift, _ in calls) == norms
    assert sum(per_image for _, per_image, _, _ in calls) == gates > 0
    assert {act for *_, act in calls} == {"none", "silu", "relu"}
    assert all(shape[0] == 2 for shape, *_ in calls)


@pytest.mark.parametrize("case", ["scale-dtype", "scale-shape", "shift-shape", "act",
                                  "gate-act", "x-rank"])
def test_bn_act_checks_its_inputs(case):
    x = torch.zeros(2, 8, 3, 4)
    scale, shift, act = torch.ones(8), torch.zeros(8), "none"
    if case == "scale-dtype":
        scale = scale.double()
    elif case == "scale-shape":
        scale = torch.ones(3, 8)
    elif case == "shift-shape":
        shift = torch.zeros(2, 8)
    elif case == "act":
        act = "tanh"
    elif case == "gate-act":
        scale, shift, act = torch.ones(2, 8), None, "silu"
    else:
        x = torch.zeros(8, 3, 4)
    with pytest.raises(ValueError):
        bn_act.bn_act(x, scale, shift, act)


@pytest.mark.parametrize("case", ["bn-silu-nchw", "bn-relu-nhwc", "bn-gelu-nhwc", "gate-nhwc"])
def test_bn_act_custom_op_passes_opcheck(case):
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 8, 3, 4, generator=g).to(torch.bfloat16)
    if case.endswith("nhwc"):
        x = x.contiguous(memory_format=torch.channels_last)
    if case.startswith("gate"):
        args = (x, torch.rand(2, 8, generator=g).to(torch.bfloat16), None, "none")
    else:
        scale, shift = (torch.randn(8, generator=g).to(torch.bfloat16) for _ in range(2))
        args = (x, scale, shift, case.split("-")[1])
    torch.library.opcheck(torch.ops.iseg.bn_act.default, args)


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("config", list(torch_cases.SERVING_CONFIGS))
def test_kernel_equals_the_composition_at_every_serving_shape(cuda_device, config):
    cfg, hw = torch_cases.SERVING_CONFIGS[config]
    calls = sorted(set(torch_cases.bn_calls(cfg, hw)))
    for seed, (shape, per_image, with_shift, _) in enumerate(calls):
        for dtype in (torch.bfloat16, torch.float32):
            for channels_last in (False, True):
                x, scale, shift = _inputs(shape, dtype, cuda_device, channels_last, per_image,
                                          with_shift, seed)
                for act in (ACTS if with_shift else ("none",)):
                    _compare(x, scale, shift, act)
        torch.cuda.synchronize()


RAGGED = [  # (shape, channels-last): C or H x W not a multiple of 8, tiny, one pixel
    ((1, 13, 7, 9), False), ((1, 13, 7, 9), True), ((2, 24, 5, 7), False),
    ((2, 36, 4, 4), True), ((3, 5, 1, 1), False), ((1, 1, 3, 3), True), ((2, 640, 6, 6), False),
    ((2, 640, 6, 6), True), ((1, 8, 1, 17), True)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32],
                         ids=["bf16", "f16", "f32"])
@pytest.mark.parametrize("shape, channels_last", RAGGED)
def test_kernel_equals_the_composition_at_ragged_shapes(cuda_device, shape, channels_last,
                                                        dtype):
    for per_image, with_shift in ((False, True), (True, False)):
        x, scale, shift = _inputs(shape, dtype, cuda_device, channels_last, per_image,
                                  with_shift, math.prod(shape))
        for act in (ACTS if with_shift else ("none",)):
            _compare(x, scale, shift, act)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_kernel_reads_unaligned_and_offset_tensors(cuda_device, dtype):
    """x and the tables one element past a 16-byte boundary: the kernel
    takes one element at a time, and still equals the composition."""
    for channels_last in (False, True):
        x, scale, shift = _inputs((2, 16, 8, 8), dtype, cuda_device, channels_last, False,
                                  True, 5)
        base = torch.empty(x.numel() + 1, dtype=dtype, device=cuda_device)
        shifted = base[1:].as_strided(x.shape, x.stride())
        shifted.copy_(x)
        tables = torch.empty(2 * 16 + 2, dtype=dtype, device=cuda_device)
        s, t = tables[1:17], tables[18:34]
        s.copy_(scale)
        t.copy_(shift)
        for act in ACTS:
            _compare(shifted, s, t, act)


@pytest.mark.cuda
def test_silu_of_the_kernel_is_pytorchs_on_every_bfloat16(cuda_device):
    """Scale 1 and shift -0 leave x as it is (-0 too), so SiLU and ReLU meet
    every one of the 65,536 bfloat16 bit patterns."""
    x = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32, device=cuda_device)
    x = x.to(torch.int16).view(torch.bfloat16).reshape(1, 8, 64, 128)
    one = torch.ones(8, dtype=torch.bfloat16, device=cuda_device)
    zero = torch.full((8,), -0.0, dtype=torch.bfloat16, device=cuda_device)
    assert _identical(bn_act.bn_act(x, one, zero, "silu"), F.silu(x * one[:, None, None]
                                                                   + zero[:, None, None]))
    assert _identical(bn_act.bn_act(x, one, zero, "relu"), F.relu(x * one[:, None, None]
                                                                   + zero[:, None, None]))


@pytest.mark.cuda
def test_gelu_of_the_kernel_is_pytorchs_on_every_bfloat16(cuda_device):
    """Scale 1 and shift -0 leave x as it is, so GELU meets every one of the
    65,536 bfloat16 bit patterns, channels-last and contiguous."""
    x = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32, device=cuda_device)
    x = x.to(torch.int16).view(torch.bfloat16).reshape(1, 8, 64, 128)
    one = torch.ones(8, dtype=torch.bfloat16, device=cuda_device)
    zero = torch.full((8,), -0.0, dtype=torch.bfloat16, device=cuda_device)
    for layout in (x, x.contiguous(memory_format=torch.channels_last)):
        assert _identical(bn_act.bn_act(layout, one, zero, "gelu"),
                          F.gelu(layout * one[:, None, None] + zero[:, None, None]))
