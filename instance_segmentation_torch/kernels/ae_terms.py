"""Kernels K3 and K4: the AE-loss terms and their gradient (``csrc/ae_terms.cu``).

K3 replaces the forward of
``instance_segmentation_tpu/losses/ae_pallas.py:ae_terms`` (``_fwd_impl``)
and K4 its hand-written VJP (``_bwd_impl``); ``ae_terms`` joins them in a
``torch.autograd.Function``. Per image and instance it returns the AE focal
sums inside the instance window (pos, neg, with the (1 - g)^4 weight looked
up from the u8 min-r2 map), the positive count npos, and the pull term
``sum cnt * |d - dmax|`` with dmax over all valid centers. The gradient
flows to (ey, ex, sy, sx) only; npos's cotangent is dropped and each
pixel's dmax cotangent goes to its first-max center.

Inputs: ey, ex, sy, sx f32 [B, H, W]; r2 u8 and cnt u16 [B, M, H, W] (K2);
``tab`` f32 [B, M, 8] (``pack_table``); ``lut`` f32 [256] (``neg4_lut``);
``cntp`` u8 [B, M, ntiles] (``tile_presence``), which must mark every tile
where an instance has samples. Samples belong to valid instances only.

``ae_terms`` runs the kernels on CUDA tensors and the plain PyTorch twin
``ae_terms_plain`` (whose autograd gives the gradient) on CPU tensors; any
other device raises. ``launches`` counts kernel launches by name.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Mapping, Tuple

import torch

from instance_segmentation_torch.kernels import build
from instance_segmentation_torch.kernels.rasterize import u16_to_i32

EPS = 1e-4
TILE_H, TILE_W = 16, 64          # the kernels' tile; csrc/ae_terms.cu kTileH/kTileW
MAX_M = 128
CY, CX, LT0, LT1, RB0, RB1, VALID = range(7)
launches = {"ae_terms_fwd": 0, "ae_terms_bwd": 0}


def neg4_lut(table: Mapping[int, float], device=None) -> torch.Tensor:
    """f32 [256]: (1 - g)^4 at each attainable u8 r2, 1.0 elsewhere (the
    reference's select chain over ``_NEG4_TABLE``)."""
    lut = torch.ones(256, dtype=torch.float32)
    for r2, t4 in table.items():
        lut[r2] = t4
    return lut.to(device)


def pack_table(c_emb: torch.Tensor, lt: torch.Tensor, rb: torch.Tensor,
               valid: torch.Tensor) -> torch.Tensor:
    """[B, M, 8] f32: center embedding (y, x), window lt/rb (row, col), valid."""
    cols = [c_emb[..., 0], c_emb[..., 1], lt[..., 0], lt[..., 1], rb[..., 0], rb[..., 1],
            valid, torch.zeros_like(c_emb[..., 0])]
    return torch.stack([c.to(torch.float32) for c in cols], dim=-1).contiguous()


def num_tiles(h: int, w: int) -> Tuple[int, int]:
    return -(-h // TILE_H), -(-w // TILE_W)


def tile_presence(points: torch.Tensor, pt_valid: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """u8 [B, M, ntiles]: 1 where instance m has a valid sample (clipped as the
    rasterizer clips it) in the tile, the reference's
    ``_any_points_from_points`` at this kernel's tile shape."""
    B, M, _, _ = points.shape
    nh, nw = num_tiles(h, w)
    ty = points[..., 0].clamp(0, h - 1).long() // TILE_H
    tx = points[..., 1].clamp(0, w - 1).long() // TILE_W
    slot = torch.arange(B * M, device=points.device).view(B, M, 1) * (nh * nw)
    out = torch.zeros(B * M * nh * nw, dtype=torch.uint8, device=points.device)
    out[(slot + ty * nw + tx)[pt_valid]] = 1
    return out.view(B, M, nh * nw)


def _affinity(ey, ex, sy, sx, cy, cx):
    dy = ey - cy
    dx = ex - cx
    return torch.exp(-(dy * dy * sy + dx * dx * sx))


def ae_terms_plain(ey: torch.Tensor, ex: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor,
                   r2: torch.Tensor, cnt: torch.Tensor, tab: torch.Tensor, lut: torch.Tensor,
                   cntp: torch.Tensor = None) -> Tuple[torch.Tensor, ...]:
    """Dense per-instance twin of K3 (``cntp`` is not needed): returns (pos,
    neg, npos, pull) f32 [B, M]. Differentiable in (ey, ex, sy, sx); dmax is
    built by a first-max select chain, so autograd routes its cotangent to
    the first maximum, as K4 does."""
    B, H, W = ey.shape
    M = tab.shape[1]
    rows = torch.arange(H, device=ey.device, dtype=torch.float32).view(1, H, 1)
    cols = torch.arange(W, device=ey.device, dtype=torch.float32).view(1, 1, W)
    t = tab[..., :, None, None]                                   # [B, M, 8, 1, 1]
    dmax = torch.zeros_like(ey)
    for m in range(M):
        d = _affinity(ey, ex, sy, sx, t[:, m, CY], t[:, m, CX])
        dmax = torch.where((d > dmax) & (t[:, m, VALID] > 0), d, dmax)
    out = []
    for m in range(M):
        tm = t[:, m]
        d = _affinity(ey, ex, sy, sx, tm[:, CY], tm[:, CX])
        pred = d.clamp(EPS, 1.0 - EPS)
        win = ((tm[:, VALID] > 0) & (rows >= tm[:, LT0]) & (rows < tm[:, RB0])
               & (cols >= tm[:, LT1]) & (cols < tm[:, RB1]))
        c = u16_to_i32(cnt[:, m]).to(torch.float32)
        posm = (c > 0) & win
        negw = lut[r2[:, m].long()]
        neg = (torch.log(1.0 - pred) * pred * pred * negw * win.float()).sum((1, 2))
        pos = torch.where(posm, torch.log(pred) * (1.0 - pred) ** 2,
                          torch.zeros_like(pred)).sum((1, 2))
        npos = posm.float().sum((1, 2))
        pull = (c * (d - dmax).abs()).sum((1, 2))
        out.append(torch.stack([pos, neg, npos, pull], dim=-1))
    terms = torch.stack(out, dim=1)                               # [B, M, 4]
    return tuple(terms[..., k] for k in range(4))


def _check(ey, ex, sy, sx, r2, cnt, tab, lut, cntp) -> Tuple[int, int, int, int]:
    B, H, W = ey.shape if ey.dim() == 3 else (-1, -1, -1)
    M = tab.shape[1] if tab.dim() == 3 else -1
    for name, t in (("ey", ey), ("ex", ex), ("sy", sy), ("sx", sx)):
        if tuple(t.shape) != (B, H, W) or t.dtype != torch.float32:
            raise ValueError(f"{name}: want float32 [B, H, W], got {t.dtype} {tuple(t.shape)}")
    want = {"r2": (r2, torch.uint8, (B, M, H, W)), "cnt": (cnt, torch.uint16, (B, M, H, W)),
            "tab": (tab, torch.float32, (B, M, 8)), "lut": (lut, torch.float32, (256,)),
            "cntp": (cntp, torch.uint8, (B, M, num_tiles(H, W)[0] * num_tiles(H, W)[1]))}
    for name, (t, dtype, shape) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: want {dtype} {shape}, got {t.dtype} {tuple(t.shape)}")
    tensors = (ey, ex, sy, sx, r2, cnt, tab, lut, cntp)
    if any(t.device != ey.device for t in tensors):
        raise ValueError("ae_terms inputs lie on different devices")
    if W % 4:
        raise ValueError(f"ae_terms takes W a multiple of 4, got {W}")
    return B, M, H, W


def _cuda_checks(tensors, M: int) -> None:
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ae_terms inputs must be contiguous")
    if M > MAX_M:
        raise ValueError(f"the ae_terms kernels take at most {MAX_M} instances, got {M}")


@functools.cache
def _kernels():
    lib = build.load("ae_terms")
    lib.iseg_ae_tiles.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.iseg_ae_tiles.restype = ctypes.c_int
    fwd = lib.iseg_ae_terms_fwd
    fwd.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
    fwd.restype = ctypes.c_int
    bwd = lib.iseg_ae_terms_bwd
    bwd.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 5
    bwd.restype = ctypes.c_int
    return lib.iseg_ae_tiles, fwd, bwd


def _ptrs(*tensors):
    return [t.data_ptr() for t in tensors]


def ae_terms_fwd(ey, ex, sy, sx, r2, cnt, tab, lut, cntp) -> Tuple[torch.Tensor, ...]:
    """Kernel K3 on CUDA tensors: (pos, neg, npos, pull) f32 [B, M]."""
    B, M, H, W = _check(ey, ex, sy, sx, r2, cnt, tab, lut, cntp)
    inputs = (ey, ex, sy, sx, r2, cnt, tab, lut, cntp)
    _cuda_checks(inputs, M)
    tiles, fwd, _ = _kernels()
    nt = tiles(H, W)
    if nt != cntp.shape[2]:
        raise RuntimeError(f"tile count {nt} of the kernel differs from {cntp.shape[2]}")
    out = torch.empty((4, B, M), dtype=torch.float32, device=ey.device)
    if B * M * H * W == 0:
        return tuple(out.zero_().unbind(0))
    partial = torch.empty((B, nt, M, 4), dtype=torch.float32, device=ey.device)
    with torch.cuda.device(ey.device):
        err = fwd(*_ptrs(*inputs), B, M, H, W, partial.data_ptr(), out.data_ptr(),
                  torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ae_terms forward kernel launch failed: CUDA error {err}")
    launches["ae_terms_fwd"] += 1
    return tuple(o.clone() for o in out.unbind(0))


def ae_terms_bwd(ey, ex, sy, sx, r2, cnt, tab, lut, cntp, g_pos: torch.Tensor,
                 g_neg: torch.Tensor, g_pull: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Kernel K4 on CUDA tensors: d(ey, ex, sy, sx) f32 [B, H, W] from the
    cotangents [B, M] of pos, neg and pull."""
    B, M, H, W = _check(ey, ex, sy, sx, r2, cnt, tab, lut, cntp)
    inputs = (ey, ex, sy, sx, r2, cnt, tab, lut, cntp)
    _cuda_checks(inputs, M)
    _, _, bwd = _kernels()
    g = torch.stack([g_pos, g_neg, torch.zeros_like(g_pos), g_pull], dim=-1)
    g = g.to(torch.float32).contiguous()
    grads = [torch.empty_like(ey) for _ in range(4)]
    if B * M * H * W == 0:
        return tuple(t.zero_() for t in grads)
    with torch.cuda.device(ey.device):
        err = bwd(*_ptrs(*inputs, g), B, M, H, W, *_ptrs(*grads),
                  torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ae_terms backward kernel launch failed: CUDA error {err}")
    launches["ae_terms_bwd"] += 1
    return tuple(grads)


class _AeTerms(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ey, ex, sy, sx, r2, cnt, tab, lut, cntp):
        pos, neg, npos, pull = ae_terms_fwd(ey, ex, sy, sx, r2, cnt, tab, lut, cntp)
        ctx.save_for_backward(ey, ex, sy, sx, r2, cnt, tab, lut, cntp)
        ctx.mark_non_differentiable(npos)
        return pos, neg, npos, pull

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_pos, g_neg, _g_npos, g_pull):
        saved = ctx.saved_tensors
        zero = torch.zeros(saved[6].shape[:2], dtype=torch.float32, device=saved[0].device)
        grads = ae_terms_bwd(*saved, *(zero if g is None else g
                                       for g in (g_pos, g_neg, g_pull)))
        return (*grads, None, None, None, None, None)


def ae_terms(ey: torch.Tensor, ex: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor,
             r2: torch.Tensor, cnt: torch.Tensor, tab: torch.Tensor, lut: torch.Tensor,
             cntp: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """(pos, neg, npos, pull) f32 [B, M], differentiable in ey, ex, sy, sx.
    CUDA tensors run K3 forward and K4 backward; CPU tensors run
    ``ae_terms_plain``."""
    _check(ey, ex, sy, sx, r2, cnt, tab, lut, cntp)
    if ey.device.type == "cuda":
        return _AeTerms.apply(ey, ex, sy, sx, r2, cnt, tab, lut, cntp)
    if ey.device.type == "cpu":
        return ae_terms_plain(ey, ex, sy, sx, r2, cnt, tab, lut)
    raise ValueError(f"ae_terms runs on cuda or cpu tensors, not {ey.device}")
