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
``cntp`` int32 [B, ntiles, 4] (``tile_presence``): per tile a bitmask of the
instances with samples there (bit m % 32 of word m // 32), which must mark
every such (tile, instance). An instance whose valid flag is 0 has no
window: its focal terms are 0, but where it has samples (the loss never
builds such input) its pull is summed and differentiated, dmax still over
the valid centers, in the kernels as in the twin.

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
PRESENCE_WORDS = MAX_M // 32     # a tile's presence: one 16-byte load in the kernels
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
    """int32 [B, ntiles, PRESENCE_WORDS]: bit m % 32 of word m // 32 set
    where instance m has a valid sample (clipped as the rasterizer clips it)
    in the tile, the reference's ``_any_points_from_points`` at this kernel's
    tile shape as a bitmask; M <= MAX_M. No host sync: invalid samples go to
    a spare slot."""
    B, M, _, _ = points.shape
    if M > MAX_M:
        raise ValueError(f"the tile presence holds at most {MAX_M} instances, got {M}")
    nh, nw = num_tiles(h, w)
    nbits = PRESENCE_WORDS * 32
    dev = points.device
    ty = points[..., 0].clamp(0, h - 1).long() // TILE_H
    tx = points[..., 1].clamp(0, w - 1).long() // TILE_W
    tile = torch.arange(B, device=dev).view(B, 1, 1) * (nh * nw) + ty * nw + tx
    size = B * nh * nw * nbits
    flat = torch.where(pt_valid, tile * nbits + torch.arange(M, device=dev).view(1, M, 1), size)
    bits = torch.zeros(size + 1, dtype=torch.uint8, device=dev)
    bits[flat.view(-1)] = 1
    bits = bits[:size].view(B, nh * nw, nbits // 32, 32).to(torch.int64)
    words = (bits << torch.arange(32, device=dev)).sum(-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def presence_dense(cntp: torch.Tensor, m: int) -> torch.Tensor:
    """bool [B, M, ntiles]: the bitmask of ``tile_presence`` unpacked."""
    shifts = torch.arange(32, device=cntp.device)
    bits = (cntp.to(torch.int64)[..., None] >> shifts) & 1
    return bits.flatten(2)[..., :m].transpose(1, 2).bool()


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
    nh, nw = num_tiles(H, W)
    f32, bhw, bmhw = torch.float32, (B, H, W), (B, M, H, W)
    for name, t, dtype, shape in (("ey", ey, f32, bhw), ("ex", ex, f32, bhw), ("sy", sy, f32, bhw),
                                  ("sx", sx, f32, bhw), ("r2", r2, torch.uint8, bmhw),
                                  ("cnt", cnt, torch.uint16, bmhw), ("tab", tab, f32, (B, M, 8)),
                                  ("lut", lut, f32, (256,)),
                                  ("cntp", cntp, torch.int32, (B, nh * nw, PRESENCE_WORDS))):
        if t.dtype != dtype or t.shape != shape:
            raise ValueError(f"{name}: want {dtype} {shape}, got {t.dtype} {tuple(t.shape)}")
    dev = ey.device
    if not (ex.device == sy.device == sx.device == r2.device == cnt.device == tab.device
            == lut.device == cntp.device == dev):
        raise ValueError("ae_terms inputs lie on different devices")
    if W % 4:
        raise ValueError(f"ae_terms takes W a multiple of 4, got {W}")
    return B, M, H, W


def _cuda_checks(tensors, M: int) -> None:
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ae_terms inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("ae_terms inputs must be 16-byte aligned (the kernels' vector loads)")
    if M > MAX_M:
        raise ValueError(f"the ae_terms kernels take at most {MAX_M} instances, got {M}")


@functools.cache
def _kernels():
    lib = build.load("ae_terms")
    lib.iseg_ae_tiles.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.iseg_ae_tiles.restype = ctypes.c_int
    lib.iseg_ae_partial_floats.argtypes = [ctypes.c_int] * 4
    lib.iseg_ae_partial_floats.restype = ctypes.c_longlong
    fwd = lib.iseg_ae_terms_fwd
    fwd.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 6
    fwd.restype = ctypes.c_int
    bwd = lib.iseg_ae_terms_bwd
    bwd.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 5
    bwd.restype = ctypes.c_int
    return lib.iseg_ae_tiles, lib.iseg_ae_partial_floats, fwd, bwd


def _ptrs(*tensors):
    return [t.data_ptr() for t in tensors]


def ae_terms_fwd(ey, ex, sy, sx, r2, cnt, tab, lut, cntp) -> Tuple[torch.Tensor, ...]:
    """Kernel K3 on CUDA tensors: (pos, neg, npos, pull) f32 [B, M], each an
    output the kernel writes; no other tensor op than their allocation and
    the scratch's."""
    B, M, H, W = _check(ey, ex, sy, sx, r2, cnt, tab, lut, cntp)
    inputs = (ey, ex, sy, sx, r2, cnt, tab, lut, cntp)
    _cuda_checks(inputs, M)
    tiles, partial_floats, fwd, _ = _kernels()
    nt = tiles(H, W)
    if nt != cntp.shape[1]:
        raise RuntimeError(f"tile count {nt} of the kernel differs from {cntp.shape[1]}")
    outs = tuple(torch.empty((B, M), dtype=torch.float32, device=ey.device) for _ in range(4))
    if B * M * H * W == 0:
        return tuple(o.zero_() for o in outs)
    partial = torch.empty(partial_floats(B, M, H, W), dtype=torch.float32, device=ey.device)
    err = build.launch(fwd, ey.device, *_ptrs(*inputs), B, M, H, W, partial.data_ptr(),
                       *_ptrs(*outs))
    if err != 0:
        raise RuntimeError(f"ae_terms forward kernel launch failed: CUDA error {err}")
    launches["ae_terms_fwd"] += 1
    return outs


def ae_terms_bwd(ey, ex, sy, sx, r2, cnt, tab, lut, cntp, g_pos: torch.Tensor,
                 g_neg: torch.Tensor, g_pull: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Kernel K4 on CUDA tensors: d(ey, ex, sy, sx) f32 [B, H, W] from the
    cotangents [B, M] of pos, neg and pull: one launch, no other tensor op
    than the gradients' allocation (a cotangent that is not a contiguous
    float32 tensor is made one first)."""
    B, M, H, W = _check(ey, ex, sy, sx, r2, cnt, tab, lut, cntp)
    gs = tuple(g if g.dtype == torch.float32 and g.is_contiguous() else
               g.to(torch.float32).contiguous() for g in (g_pos, g_neg, g_pull))
    if any(tuple(g.shape) != (B, M) or g.device != ey.device for g in gs):
        raise ValueError(f"the cotangents: want [B, M] = {(B, M)} on {ey.device}")
    inputs = (ey, ex, sy, sx, r2, cnt, tab, lut, cntp)
    _cuda_checks(inputs, M)
    *_, bwd = _kernels()
    grads = torch.empty((4, B, H, W), dtype=torch.float32, device=ey.device)
    if B * M * H * W == 0:
        return grads.zero_().unbind(0)
    ptr = grads.data_ptr()
    plane = B * H * W * 4
    err = build.launch(bwd, ey.device, *_ptrs(*inputs, *gs), B, M, H, W, ptr, ptr + plane,
                       ptr + 2 * plane, ptr + 3 * plane)
    if err != 0:
        raise RuntimeError(f"ae_terms backward kernel launch failed: CUDA error {err}")
    launches["ae_terms_bwd"] += 1
    return grads.unbind(0)


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
