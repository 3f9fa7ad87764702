"""Eval batch norm and the squeeze-and-excitation gate as one pass
(``csrc/bn_act.cu``): ``y = act(x * scale + shift)`` over an activation,
rounded after each step as PyTorch's composition rounds it.

Replaces no TPU kernel: XLA fuses the JAX package's batch norm and
activation. ``x`` is [B, C, H, W] (float32, bfloat16 or float16); ``scale``
is [C] (batch norm) or [B, C] (the gate: a scale per image and channel),
``shift`` [C] or None (the gate), both in ``x``'s dtype and contiguous;
``act`` is "none", "silu", "relu" or "gelu" (the erf form; the gate takes
"none").

``bn_act`` runs the op ``iseg::bn_act``: on CUDA tensors the kernel, on the
current stream (no host read, so a CUDA graph holds it), which takes ``x``
contiguous or channels-last with fewer than 2**31 elements and raises on
any other; on CPU tensors its twin ``bn_act_plain``, the composition
``x * scale + shift`` followed by ``F.silu``, ``F.relu`` or ``F.gelu``; on the meta
device and under ``torch.export`` its fake, an output shaped as ``x``.
``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from instance_segmentation_torch.kernels import build

launches = 0
ACTS = {"none": 0, "silu": 1, "relu": 2, "gelu": 3}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_ACTIVATIONS = {"none": lambda y: y, "silu": F.silu, "relu": F.relu, "gelu": F.gelu}


def bn_act_plain(x: torch.Tensor, scale: torch.Tensor, shift: Optional[torch.Tensor] = None,
                 act: str = "none") -> torch.Tensor:
    """The twin: ``x * scale + shift`` broadcast over [B, C, H, W], then
    ``act``, as PyTorch runs it op by op."""
    s = scale[:, None, None] if scale.dim() == 1 else scale[:, :, None, None]
    y = x * s
    if shift is not None:
        y = y + shift[:, None, None]
    return _ACTIVATIONS[act](y)


def layout(x: torch.Tensor) -> Optional[str]:
    """"nchw" (contiguous), "nhwc" (channels-last) or None: the memory
    layouts the kernel reads. A tensor that is both (C or H x W of 1) is
    "nchw": the two orders then coincide."""
    if x.dim() != 4:
        return None
    if x.is_contiguous():
        return "nchw"
    if x.is_contiguous(memory_format=torch.channels_last):
        return "nhwc"
    return None


def _check(x: torch.Tensor, scale: torch.Tensor, shift: Optional[torch.Tensor],
           act: str) -> None:
    if x.dim() != 4 or x.dtype not in _DTYPES:
        raise ValueError(f"x: want float32, bfloat16 or float16 [B, C, H, W], got "
                         f"{x.dtype} {tuple(x.shape)}")
    b, c = x.shape[:2]
    if tuple(scale.shape) not in ((c,), (b, c)) or scale.dtype != x.dtype:
        raise ValueError(f"scale: want {x.dtype} [{c}] or [{b}, {c}], got "
                         f"{scale.dtype} {tuple(scale.shape)}")
    if shift is not None and (tuple(shift.shape) != (c,) or shift.dtype != x.dtype):
        raise ValueError(f"shift: want {x.dtype} [{c}] or None, got "
                         f"{shift.dtype} {tuple(shift.shape)}")
    if act not in ACTS or (shift is None and act != "none"):
        raise ValueError(f"act {act!r}: one of {sorted(ACTS)}, 'none' without a shift")
    if any(t.device != x.device for t in (scale, shift) if t is not None):
        raise ValueError("bn_act inputs lie on different devices")


@functools.cache
def _kernel():
    fn = build.load("bn_act").iseg_bn_act
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong]
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(x: torch.Tensor, scale: torch.Tensor, shift: Optional[torch.Tensor],
            act: str) -> torch.Tensor:
    global launches
    if layout(x) is None or x.numel() >= 2 ** 31:
        raise ValueError(f"the bn_act kernel takes contiguous or channels-last x with fewer "
                         f"than 2**31 elements, got strides {x.stride()}, {x.numel()} elements")
    if not (scale.is_contiguous() and (shift is None or shift.is_contiguous())):
        raise ValueError("bn_act's scale and shift must be contiguous")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    b, c, h, w = x.shape
    order = layout(x)
    vec = 16 // x.element_size()
    packed = (all(t.data_ptr() % 16 == 0 for t in (x, y, scale, shift) if t is not None)
              and (c if order == "nhwc" else h * w) % vec == 0)
    err = build.launch(_kernel(), x.device, x.data_ptr(), scale.data_ptr(),
                       None if shift is None else shift.data_ptr(), y.data_ptr(), x.numel(), c,
                       h * w, int(scale.dim() == 2), int(order == "nhwc"), int(packed), ACTS[act],
                       _DTYPES[x.dtype])
    if err != 0:
        raise RuntimeError(f"bn_act kernel launch failed: CUDA error {err}")
    launches += 1
    return y


@torch.library.custom_op("iseg::bn_act", mutates_args=(), device_types="cpu")
def _bn_act_op(x: torch.Tensor, scale: torch.Tensor, shift: Optional[torch.Tensor],
               act: str) -> torch.Tensor:
    return bn_act_plain(x, scale, shift, act)


@_bn_act_op.register_kernel("cuda")
def _bn_act_op_cuda(x, scale, shift, act):
    return _launch(x, scale, shift, act)


@_bn_act_op.register_fake
def _bn_act_op_fake(x, scale, shift, act):
    return torch.empty_like(x)


def bn_act(x: torch.Tensor, scale: torch.Tensor, shift: Optional[torch.Tensor] = None,
           act: str = "none") -> torch.Tensor:
    """``act(x * scale + shift)`` by the op ``iseg::bn_act``: the kernel on
    CUDA tensors, ``bn_act_plain`` on CPU tensors, the fake on meta ones."""
    if x.device.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"bn_act runs on cuda, cpu or meta tensors, not {x.device}")
    _check(x, scale, shift, act)
    return torch.ops.iseg.bn_act(x, scale, shift, act)
