"""Kernels K2 and K5: the boundary-point rasterizers (``csrc/rasterize.cu``).

K2 ``rasterize_cnt_r2`` replaces
``instance_segmentation_tpu/losses/rasterize_pallas.py:rasterize_cnt_r2``:
from the packed point list [B, M, P, 2] it makes the per-instance u16
sample-count map, the u8 min-r2 map (min dy^2 + dx^2 to a sample pixel
within max-norm radius 3, else 200) and the u8 union over instances, equal
bit for bit to the reference's ``ae_sample_count``, ``_shift_min_r2`` and
``any(cnt > 0)``.

K5 ``rasterize_nmap`` replaces ``rasterize_pallas.py:rasterize_nmap``: the two
f32 planes summing each valid sample's inward normal at its (clipped)
pixel, the tangent loss's target field. Kernel and twin both sum each pixel
in (image, instance, sample) order, so they agree bit for bit.

Each wrapper runs its CUDA kernel on CUDA tensors and its plain PyTorch twin
on CPU tensors; any other device raises. ``launches`` counts kernel
launches by name. The twins index with int64: the reference's int32 flat
index overflows past B*M*H*W = 2^31.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from instance_segmentation_torch.kernels import build

R2_BIG = 200                     # "no sample within radius 3" sentinel
launches = {"rasterize_cnt_r2": 0, "rasterize_nmap": 0}


def u16_to_i32(t: torch.Tensor) -> torch.Tensor:
    """uint16 -> int32 by way of an int16 view (torch has few uint16 ops)."""
    return t.view(torch.int16).to(torch.int32) & 0xFFFF


def i32_to_u16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int16).view(torch.uint16)


def _encode(points: torch.Tensor, pt_valid: torch.Tensor, h: int, w: int):
    """Valid samples clipped into the image, invalid ones out of range
    (y = h, x = w), as int32 [B, M, P] planes."""
    ys = torch.where(pt_valid, points[..., 0].clamp(0, h - 1), h).to(torch.int32)
    xs = torch.where(pt_valid, points[..., 1].clamp(0, w - 1), w).to(torch.int32)
    return ys.contiguous(), xs.contiguous()


def _check(points: torch.Tensor, pt_valid: torch.Tensor, h: int, w: int):
    if points.dim() != 4 or points.shape[-1] != 2 or points.dtype != torch.int32:
        raise ValueError(f"points: want int32 [B, M, P, 2], got {points.dtype} "
                         f"{tuple(points.shape)}")
    if tuple(pt_valid.shape) != tuple(points.shape[:3]) or pt_valid.dtype != torch.bool:
        raise ValueError(f"pt_valid: want bool {tuple(points.shape[:3])}, got "
                         f"{pt_valid.dtype} {tuple(pt_valid.shape)}")
    if pt_valid.device != points.device:
        raise ValueError("points and pt_valid lie on different devices")
    if h < 1 or w < 4 or w % 4:
        raise ValueError(f"the rasterizers take W a multiple of 4, got {h}x{w}")


def _device_kind(t: torch.Tensor, name: str) -> str:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on cuda or cpu tensors, not {t.device}")
    return t.device.type


# ---- K2 ----------------------------------------------------------------------

def shift_min_r2(imp: torch.Tensor, radius: int = 3) -> torch.Tensor:
    """The reference's ``_shift_min_r2``: bool [..., H, W] sample pixels ->
    u8 min dy^2 + dx^2 to a sample within the radius-``radius`` max-norm
    window, else 200; neighbours outside the image are padded with 200 (a
    column pass, then a row pass, each a min over 2r+1 shifted slices)."""
    r2 = torch.where(imp, 0, R2_BIG).to(torch.uint8)
    *lead, h, w = r2.shape
    pad = r2.new_full((*lead, h, w + 2 * radius), R2_BIG)
    pad[..., radius:radius + w] = r2
    col = r2.clone()
    for i in range(2 * radius + 1):
        col = torch.minimum(col, pad[..., i:i + w] + (i - radius) ** 2)
    pad = r2.new_full((*lead, h + 2 * radius, w), R2_BIG)
    pad[..., radius:radius + h, :] = col
    out = col.clone()
    for i in range(2 * radius + 1):
        out = torch.minimum(out, pad[..., i:i + h, :] + (i - radius) ** 2)
    return out


def sample_count(points: torch.Tensor, pt_valid: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The reference's ``ae_sample_count`` as int32 [B, M, H, W]: an index_add_
    of one per valid sample at its clipped pixel."""
    B, M, P, _ = points.shape
    ys = points[..., 0].clamp(0, h - 1).long()
    xs = points[..., 1].clamp(0, w - 1).long()
    slab = torch.arange(B * M, device=points.device).view(B, M, 1) * (h * w)
    idx = (slab + ys * w + xs)[pt_valid]
    cnt = torch.zeros(B * M * h * w, dtype=torch.int32, device=points.device)
    cnt.index_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))
    return cnt.view(B, M, h, w)


def rasterize_cnt_r2_plain(points: torch.Tensor, pt_valid: torch.Tensor, h: int, w: int,
                           radius: int = 3) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(cnt u16 [B,M,H,W], r2 u8 [B,M,H,W], union u8 [B,H,W])."""
    cnt = sample_count(points, pt_valid, h, w)
    imp = cnt > 0
    return i32_to_u16(cnt), shift_min_r2(imp, radius), imp.any(dim=1).to(torch.uint8)


@functools.cache
def _cnt_r2_kernel():
    fn = build.load("rasterize").iseg_rasterize_cnt_r2
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    return fn


def rasterize_cnt_r2(points: torch.Tensor, pt_valid: torch.Tensor, h: int, w: int,
                     radius: int = 3) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """points [B, M, P, 2] int32 (row, col); pt_valid [B, M, P] bool ->
    (cnt u16 [B,M,H,W], r2 u8 [B,M,H,W], union u8 [B,H,W]). CUDA tensors run
    kernel K2 (radius 3 only); CPU tensors run ``rasterize_cnt_r2_plain``."""
    _check(points, pt_valid, h, w)
    if _device_kind(points, "rasterize_cnt_r2") == "cpu":
        return rasterize_cnt_r2_plain(points, pt_valid, h, w, radius)
    if radius != 3:
        raise ValueError(f"the K2 kernel is built for radius 3, got {radius}")
    B, M, P, _ = points.shape
    ys, xs = _encode(points, pt_valid, h, w)
    has = pt_valid.any(dim=2).to(torch.uint8)
    dev = points.device
    cnt = torch.empty((B, M, h, w), dtype=torch.uint16, device=dev)
    r2 = torch.empty((B, M, h, w), dtype=torch.uint8, device=dev)
    uni = torch.empty((B, h, w), dtype=torch.uint8, device=dev)
    if B * M == 0:
        return cnt, r2, uni.zero_()
    err = build.launch(_cnt_r2_kernel(), dev, ys.data_ptr(), xs.data_ptr(), has.data_ptr(),
                       B, M, P, h, w, cnt.data_ptr(), r2.data_ptr(), uni.data_ptr())
    if err != 0:
        raise RuntimeError(f"rasterize_cnt_r2 kernel launch failed: CUDA error {err}")
    launches["rasterize_cnt_r2"] += 1
    return cnt, r2, uni


# ---- K5 ----------------------------------------------------------------------

def rasterize_nmap_plain(points: torch.Tensor, pt_valid: torch.Tensor,
                         normals: torch.Tensor, h: int, w: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Summed-normal planes (nmap0, nmap1) f32 [B, H, W]: index_add_ of each
    valid sample's normal at its clipped pixel, in (instance, sample) order."""
    B = points.shape[0]
    ys = points[..., 0].clamp(0, h - 1).long()
    xs = points[..., 1].clamp(0, w - 1).long()
    img = torch.arange(B, device=points.device).view(B, 1, 1) * (h * w)
    idx = (img + ys * w + xs)[pt_valid]
    nrm = normals[pt_valid].float()
    out = []
    for c in range(2):
        plane = torch.zeros(B * h * w, dtype=torch.float32, device=points.device)
        out.append(plane.index_add_(0, idx, nrm[:, c]).view(B, h, w))
    return out[0], out[1]


@functools.cache
def _nmap_kernel():
    lib = build.load("rasterize")
    fn = lib.iseg_rasterize_nmap
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    lib.iseg_nmap_scratch_bytes.argtypes = [ctypes.c_int] * 4
    lib.iseg_nmap_scratch_bytes.restype = ctypes.c_size_t
    return fn, functools.cache(lib.iseg_nmap_scratch_bytes)


def rasterize_nmap(points: torch.Tensor, pt_valid: torch.Tensor, normals: torch.Tensor,
                   h: int, w: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """points [B, M, P, 2] int32; pt_valid [B, M, P] bool; normals [B, M, P, 2]
    f32 -> (nmap0, nmap1) f32 [B, H, W]. CUDA tensors run kernel K5 (two
    launches from one C call, no tensor op besides the outputs' and the
    scratch's allocation); CPU tensors run ``rasterize_nmap_plain``. Both sum
    each pixel in (image, instance, sample) order: the results are equal bit
    for bit."""
    _check(points, pt_valid, h, w)
    if tuple(normals.shape) != tuple(points.shape) or normals.dtype != torch.float32:
        raise ValueError(f"normals: want float32 {tuple(points.shape)}, got "
                         f"{normals.dtype} {tuple(normals.shape)}")
    if _device_kind(points, "rasterize_nmap") == "cpu":
        return rasterize_nmap_plain(points, pt_valid, normals, h, w)
    dev = points.device
    if normals.device != dev:
        raise ValueError("points and normals lie on different devices")
    if not (points.is_contiguous() and pt_valid.is_contiguous() and normals.is_contiguous()
            ) or (points.data_ptr() | normals.data_ptr()) % 8:
        raise ValueError("rasterize_nmap takes contiguous inputs, points and normals 8-byte "
                         "aligned")
    B, M, P, _ = points.shape
    out = torch.empty((2, B, h, w), dtype=torch.float32, device=dev)
    if B * M * P == 0:
        return out.zero_().unbind(0)
    kernel, scratch_bytes = _nmap_kernel()
    scratch = torch.empty(scratch_bytes(B, M, P, h), dtype=torch.uint8, device=dev)
    err = build.launch(kernel, dev, points.data_ptr(), pt_valid.data_ptr(), normals.data_ptr(),
                       B, M, P, h, w, out.data_ptr(), scratch.data_ptr())
    if err != 0:
        raise RuntimeError(f"rasterize_nmap kernel launch failed: CUDA error {err}")
    launches["rasterize_nmap"] += 1
    return out.unbind(0)
