"""Kernel K6: the min-r2 map from the count map (``csrc/rasterize.cu``).

``minr2_from_cnt`` replaces
``instance_segmentation_tpu/losses/minr2_pallas.py:minr2_from_cnt``: from the
per-instance u16 sample-count map [B, M, H, W] it makes the u8 min-r2 map
(min dy^2 + dx^2 to a pixel with cnt != 0 within max-norm radius 3, else
200; out-of-image neighbours never win), and sets every slab whose instance
has no valid sample (``has`` 0) to 200 whatever its counts hold. Equal bit
for bit to the reference's ``where(has, _shift_min_r2(cnt > 0), 200)``.

It is the count-map route's second step, where the rasterizer K2 does not
take the shape (``losses.rasterizer_supported``): ``losses.ae_sample_count``
makes the count map, K6 its min-r2 map. The wrapper runs the CUDA kernel on
CUDA tensors and its plain twin on CPU tensors; any other device raises.
``launches`` counts kernel launches.

The kernel walks bands of ``BAND_H`` x ``BAND_W`` pixels of the live slabs
and fills the padding slabs (``has`` 0) with 200s, ``FILL_BYTES`` an item,
from one persistent grid (``csrc/rasterize.cu``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from instance_segmentation_torch.kernels import build
from instance_segmentation_torch.kernels.rasterize import R2_BIG, shift_min_r2

BAND_H, BAND_W = 64, 128         # a live item; csrc/rasterize.cu kBandH, kBandW
FILL_BYTES = 16384               # a fill item; csrc/rasterize.cu kFillBytes
MAX_ITEMS = 2 ** 31 - 1          # B * M times a slab's items: the kernel's int index
launches = {"minr2_from_cnt": 0}


def _check(cnt: torch.Tensor, has: torch.Tensor) -> None:
    if cnt.dim() != 4 or cnt.dtype != torch.uint16:
        raise ValueError(f"cnt: want uint16 [B, M, H, W], got {cnt.dtype} {tuple(cnt.shape)}")
    if tuple(has.shape) != tuple(cnt.shape[:2]) or has.dtype not in (torch.bool, torch.uint8):
        raise ValueError(f"has: want bool or uint8 {tuple(cnt.shape[:2])}, got "
                         f"{has.dtype} {tuple(has.shape)}")
    if has.device != cnt.device:
        raise ValueError("cnt and has lie on different devices")
    h, w = cnt.shape[2:]
    if h < 1 or w < 4 or w % 4:
        raise ValueError(f"minr2_from_cnt takes W a multiple of 4, got {h}x{w}")


def minr2_from_cnt_plain(cnt: torch.Tensor, has: torch.Tensor, radius: int = 3) -> torch.Tensor:
    """``where(has, shift_min_r2(cnt != 0), 200)`` as u8 [B, M, H, W]; cnt is
    read through its int16 view (torch has no uint16 comparisons on the CPU)."""
    r2 = shift_min_r2(cnt.view(torch.int16) != 0, radius)
    return torch.where(has.bool()[..., None, None], r2, torch.full_like(r2, R2_BIG))


@functools.cache
def _kernel():
    fn = build.load("rasterize").iseg_minr2_from_cnt
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    return fn


def minr2_from_cnt(cnt: torch.Tensor, has: torch.Tensor, radius: int = 3) -> torch.Tensor:
    """cnt u16 [B, M, H, W]; has bool or u8 [B, M] -> r2 u8 [B, M, H, W].
    CUDA tensors run kernel K6 (radius 3 only); CPU tensors run
    ``minr2_from_cnt_plain``."""
    _check(cnt, has)
    if cnt.device.type == "cpu":
        return minr2_from_cnt_plain(cnt, has, radius)
    if cnt.device.type != "cuda":
        raise ValueError(f"minr2_from_cnt runs on cuda or cpu tensors, not {cnt.device}")
    if radius != 3:
        raise ValueError(f"the K6 kernel is built for radius 3, got {radius}")
    B, M, h, w = cnt.shape
    items = B * M * max(-(-h // BAND_H) * -(-w // BAND_W), -(-h * w // FILL_BYTES))
    if items > MAX_ITEMS:
        raise ValueError(f"the K6 kernel takes at most {MAX_ITEMS} items, got {items}")
    cnt = cnt.view(torch.int16).contiguous().view(torch.uint16)
    if cnt.data_ptr() % 8:
        raise ValueError("minr2_from_cnt takes cnt aligned to 8 bytes")
    has = (has.view(torch.uint8) if has.dtype == torch.bool else has).contiguous()
    r2 = torch.empty((B, M, h, w), dtype=torch.uint8, device=cnt.device)
    if B * M == 0:
        return r2
    err = build.launch(_kernel(), cnt.device, cnt.data_ptr(), has.data_ptr(), B * M, h, w,
                       r2.data_ptr())
    if err != 0:
        raise RuntimeError(f"minr2_from_cnt kernel launch failed: CUDA error {err}")
    launches["minr2_from_cnt"] += 1
    return r2
