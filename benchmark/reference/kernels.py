"""The plain PyTorch twins of the port's kernels K1-K6, frozen: the
reference's grouping (K1), rasterizers (K2, K5), AE-loss terms (K3, K4 by
autograd) and min-r2 map (K6). Each public name is the twin itself; the
reference's decode and losses call these where the port launches a kernel."""

from __future__ import annotations

from typing import Mapping, Tuple

import torch

R2_BIG = 200                     # "no sample within radius 3" sentinel
EPS = 1e-4
TILE_H, TILE_W = 16, 64          # the AE kernels' tile (the presence bitmask's)
MAX_M = 128
PRESENCE_WORDS = MAX_M // 32
CY, CX, LT0, LT1, RB0, RB1, VALID = range(7)


# ---- K1 ----------------------------------------------------------------------

def contained_plain(kp_rc: torch.Tensor, boxes: torch.Tensor,
                    det_valid: torch.Tensor) -> torch.Tensor:
    """[B,K,D] bool: keypoint k lies in the box of valid detection d."""
    row, col = kp_rc[..., 0:1], kp_rc[..., 1:2]                        # [B,K,1]
    return ((row >= boxes[:, None, :, 1]) & (row <= boxes[:, None, :, 3]) &
            (col >= boxes[:, None, :, 0]) & (col <= boxes[:, None, :, 2]) &
            det_valid[:, None, :])


def affinity_scores_plain(kp_rc: torch.Tensor, emb: torch.Tensor, sig: torch.Tensor,
                          c_emb: torch.Tensor, boxes: torch.Tensor,
                          det_valid: torch.Tensor) -> torch.Tensor:
    """The reference's dense scores (``ops/decode.py`` grouping), [B,K,D]:
    ``exp(-sum((emb - c_emb)^2 * sig)) * contained``. A NaN stays NaN outside
    the box too (NaN * 0)."""
    dists = torch.exp(-(((emb[:, :, None, :] - c_emb[:, None, :, :]) ** 2)
                        * sig[:, :, None, :]).sum(dim=-1))              # [B,K,D]
    return dists * contained_plain(kp_rc, boxes, det_valid).float()


def affinity_assign_plain(kp_rc: torch.Tensor, emb: torch.Tensor, sig: torch.Tensor,
                          c_emb: torch.Tensor, boxes: torch.Tensor,
                          det_valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's grouping, batched: kp_rc/emb/sig [B,K,2], c_emb
    [B,D,2], boxes [B,D,4] (x1,y1,x2,y2), det_valid [B,D] -> (assign [B,K]
    int32, best [B,K] float32). ``max(dim)`` takes the first maximum and,
    as ``jnp.argmax``, the first NaN over any number (on the CPU)."""
    best, assign = affinity_scores_plain(kp_rc, emb, sig, c_emb, boxes, det_valid).max(dim=-1)
    return assign.int(), best


# ---- K2, K5 ------------------------------------------------------------------

def u16_to_i32(t: torch.Tensor) -> torch.Tensor:
    """uint16 -> int32 by way of an int16 view (torch has few uint16 ops)."""
    return t.view(torch.int16).to(torch.int32) & 0xFFFF


def i32_to_u16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int16).view(torch.uint16)


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


# ---- K3, K4 ------------------------------------------------------------------

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


# ---- K6 ----------------------------------------------------------------------

def minr2_from_cnt_plain(cnt: torch.Tensor, has: torch.Tensor, radius: int = 3) -> torch.Tensor:
    """``where(has, shift_min_r2(cnt != 0), 200)`` as u8 [B, M, H, W]; cnt is
    read through its int16 view (torch has no uint16 comparisons on the CPU)."""
    r2 = shift_min_r2(cnt.view(torch.int16) != 0, radius)
    return torch.where(has.bool()[..., None, None], r2, torch.full_like(r2, R2_BIG))


affinity_assign = affinity_assign_plain
rasterize_cnt_r2 = rasterize_cnt_r2_plain
rasterize_nmap = rasterize_nmap_plain
ae_terms = ae_terms_plain
minr2_from_cnt = minr2_from_cnt_plain
