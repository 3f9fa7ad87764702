"""The training objective, fully on the device.

Counterpart of ``instance_segmentation_tpu/losses/losses.py`` on its default,
exact path (``LossConfig()``, no ``ae_window``), with the model's planar
train heads:

    total = cls + wh (box regression * 50) + kp + ae + tan

The rasterizer (kernel K2) makes the per-instance sample-count map, the
min-r2 map and their union once; the kp focal loss reads the union, the AE
loss the count and r2 maps through kernels K3/K4, and the tangent loss the
summed-normal field of kernel K5. On CPU tensors the kernels' plain twins
run instead.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from instance_segmentation_torch.kernels import ae_terms as ae_kernels
from instance_segmentation_torch.kernels import rasterize
from instance_segmentation_torch.ops.targets import Targets

_EPS = 1e-4


@dataclass(frozen=True)
class LossConfig:
    alpha: float = 0.25           # det focal alpha
    gamma: float = 2.0            # det focal gamma
    pos_iou: float = 0.5          # anchor-positive IoU
    neg_iou: float = 0.4          # anchor-negative IoU
    reg_weight: float = 50.0      # box-regression scaling
    ae_weight: float = 1.0
    tan_weight: float = 1.0


def coordinate_grid(h: int, w: int, device=None) -> torch.Tensor:
    """The fixed global embedding frame sliced to (h, w): [h, w, 2] with
    channels (y, x) = (i / 1023, 2 j / 2047)."""
    if h > 1024 or w > 2048:
        raise ValueError(f"coordinate grid is fixed at 1024x2048 (got {h}x{w})")
    ys = torch.arange(h, dtype=torch.float32, device=device) / 1023.0
    xs = torch.arange(w, dtype=torch.float32, device=device) * (2.0 / 2047.0)
    return torch.stack([ys[:, None].expand(h, w), xs[None, :].expand(h, w)], dim=-1)


# ---- detection focal + box regression ------------------------------------------

def _iou_anchors_gt(anchors: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """IoU [B, A, M] of anchors [A, 4] (y1, x1, y2, x2) against gt [B, M, 4]
    (x1, y1, x2, y2), the reference's mixed layouts."""
    area_g = (gt[..., 2] - gt[..., 0]) * (gt[..., 3] - gt[..., 1])            # [B, M]
    iw = (torch.minimum(anchors[:, 3:4], gt[:, None, :, 2])
          - torch.maximum(anchors[:, 1:2], gt[:, None, :, 0])).clamp_min(0)
    ih = (torch.minimum(anchors[:, 2:3], gt[:, None, :, 3])
          - torch.maximum(anchors[:, 0:1], gt[:, None, :, 1])).clamp_min(0)
    area_a = (anchors[:, 2] - anchors[:, 0]) * (anchors[:, 3] - anchors[:, 1])
    union = (area_a[:, None] + area_g[:, None, :] - iw * ih).clamp_min(1e-8)
    return iw * ih / union


def det_focal_loss(classification: torch.Tensor, regression: torch.Tensor,
                   anchors: torch.Tensor, det_ann: torch.Tensor,
                   cfg: LossConfig = LossConfig()) -> Tuple[torch.Tensor, torch.Tensor]:
    """classification [B,A,C], regression [B,A,4], anchors [A,4], det_ann
    [B,M,5] -> (cls loss, regression loss * reg_weight), means over images.
    The reference's one-hot matmul gather is a plain gather here; argmax
    keeps the first maximum."""
    aw = anchors[:, 3] - anchors[:, 1]
    ah = anchors[:, 2] - anchors[:, 0]
    acx = anchors[:, 1] + 0.5 * aw
    acy = anchors[:, 0] + 0.5 * ah

    gt_valid = det_ann[..., 4] >= 0                                             # [B, M]
    cls_prob = classification.clamp(_EPS, 1.0 - _EPS)
    iou = _iou_anchors_gt(anchors, det_ann[..., :4])
    iou = torch.where(gt_valid[:, None, :], iou, torch.full_like(iou, -1.0))
    iou_max = iou.amax(dim=2)                                                   # [B, A]
    iou_arg = iou.argmax(dim=2)
    assigned = torch.gather(det_ann, 1, iou_arg[..., None].expand(-1, -1, 5))   # [B, A, 5]

    pos = iou_max >= cfg.pos_iou
    neg = iou_max < cfg.neg_iou
    num_pos = pos.sum(dim=1).to(torch.float32)                                  # [B]

    one_hot = torch.nn.functional.one_hot(assigned[..., 4].long().clamp_min(0),
                                          cls_prob.shape[-1]).to(torch.float32)
    one_hot = torch.where(assigned[..., 4:5] >= 0, one_hot, torch.zeros_like(one_hot))
    targets = torch.where(pos[..., None], one_hot, torch.zeros_like(one_hot))
    known = (pos | neg)[..., None]
    is_pos = targets == 1.0
    alpha_f = torch.where(is_pos, cfg.alpha, 1.0 - cfg.alpha)
    focal_w = torch.where(is_pos, 1.0 - cls_prob, cls_prob)
    focal_w = alpha_f * focal_w ** cfg.gamma
    bce = -(targets * torch.log(cls_prob) + (1.0 - targets) * torch.log(1.0 - cls_prob))
    cls_loss = torch.where(known, focal_w * bce, torch.zeros_like(bce)).sum(dim=(1, 2))
    cls_loss = cls_loss / num_pos.clamp_min(1.0)

    gw = (assigned[..., 2] - assigned[..., 0]).clamp_min(1.0)
    gh = (assigned[..., 3] - assigned[..., 1]).clamp_min(1.0)
    gcx = assigned[..., 0] + 0.5 * (assigned[..., 2] - assigned[..., 0])
    gcy = assigned[..., 1] + 0.5 * (assigned[..., 3] - assigned[..., 1])
    t = torch.stack([(gcy - acy) / ah, (gcx - acx) / aw,
                     torch.log(gh / ah), torch.log(gw / aw)], dim=-1)            # [B, A, 4]
    diff = (t - regression).abs()
    smooth = torch.where(diff <= 1.0 / 9.0, 0.5 * 9.0 * diff ** 2, diff - 0.5 / 9.0)
    reg_loss = torch.where(pos[..., None], smooth, torch.zeros_like(smooth)).sum(dim=(1, 2))
    reg_loss = torch.where(num_pos > 0, reg_loss / (num_pos * 4.0).clamp_min(1.0),
                           torch.zeros_like(reg_loss))
    return cls_loss.mean(), reg_loss.mean() * cfg.reg_weight


# ---- kp focal ------------------------------------------------------------------

def kp_focal_loss_from_union(kp_logits: torch.Tensor, union: torch.Tensor) -> torch.Tensor:
    """CornerNet-style focal over the whole batch, the binary target being the
    rasterizer's union map [B, H, W]. kp_logits [B, H, W] (or [B, H, W, 1])."""
    kp = kp_logits if kp_logits.dim() == 3 else kp_logits[..., 0]
    pred = torch.sigmoid(kp).clamp(_EPS, 1.0 - _EPS)
    u = union.to(torch.float32)
    pos = (torch.log(pred) * (1.0 - pred) ** 2 * u).sum()
    neg = (torch.log(1.0 - pred) * pred ** 2 * (1.0 - u)).sum()
    num_pos = u.sum()
    return torch.where(num_pos == 0, -neg, -(pos + neg) / num_pos.clamp_min(1.0))


# ---- AE (spatial-embedding) loss ---------------------------------------------------

def _gauss_neg_tables() -> Dict[int, float]:
    """(1 - g)^4 for every attainable r2 = dy^2 + dx^2 (|dy|, |dx| <= 3) of
    the radius-3 gaussian stamp (sigma 7/6), rounded in float32 as the
    reference's separable max-splat and pow-by-squaring round it."""
    sigma = 7.0 / 6.0
    vals = {}
    for a in range(4):
        for b in range(4):
            ga = np.float32(math.exp(-(a * a) / (2.0 * sigma * sigma)))
            gb = np.float32(math.exp(-(b * b) / (2.0 * sigma * sigma)))
            vals[a * a + b * b] = np.float32(ga * gb)
    neg4 = {}
    for r2, g in vals.items():
        t = np.float32(1.0) - g
        t2 = np.float32(t * t)
        neg4[r2] = float(np.float32(t2 * t2))
    return neg4


_NEG4_TABLE = _gauss_neg_tables()        # {r2: (1 - g)^4}, r2 in 0..18


def ae_table(targets: Targets, xym: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The per-instance table [B, M, 8] of K3/K4: center embedding (the grid
    at the truncated, clipped center), focal window lt/rb (the reference's
    2x sample extent around the center, ``lt`` clipped to [0, 2048], ``rb``
    to the image) and the valid flag."""
    centers_int = targets.centers.to(torch.int32)                      # [B, M, 2]
    ci = centers_int[..., 0].clamp(0, h - 1).long()
    cj = centers_int[..., 1].clamp(0, w - 1).long()
    c_emb = xym[ci, cj]                                                # [B, M, 2]
    val = targets.pt_valid[..., None]
    big = 1 << 20
    kmin = torch.where(val, targets.points, big).amin(dim=2)
    kmax = torch.where(val, targets.points, -big).amax(dim=2)
    half = kmax - kmin                          # mask_size // 2, mask_size = 2 * extent
    lt = (centers_int - half).clamp(0, 2048)
    rb = centers_int + half
    rb = torch.stack([rb[..., 0].clamp(0, h), rb[..., 1].clamp(0, w)], dim=-1)
    return ae_kernels.pack_table(c_emb, lt, rb, targets.inst_valid)


def ae_loss(ae: Tuple[torch.Tensor, ...], targets: Targets, xym: torch.Tensor,
            cnt: torch.Tensor, r2: torch.Tensor, cfg: LossConfig = LossConfig()) -> torch.Tensor:
    """ae: the four planar [B, H, W] heads (2 offsets, 2 log-sigmas); cnt/r2
    from K2. Per instance: focal loss of the embedding affinity against the
    gaussian target inside the instance window, plus the pull term; summed
    over instances, divided by the valid count, averaged over images."""
    a0, a1, a2, a3 = ae
    B, H, W = a0.shape
    ey = torch.tanh(a0) + xym[..., 0]
    ex = torch.tanh(a1) + xym[..., 1]
    sy = torch.exp(a2)
    sx = torch.exp(a3)
    tab = ae_table(targets, xym, H, W)
    lut = ae_kernels.neg4_lut(_NEG4_TABLE, a0.device)
    cntp = ae_kernels.tile_presence(targets.points, targets.pt_valid, H, W)
    pos, neg, npos, pull = ae_kernels.ae_terms(ey, ex, sy, sx, r2, cnt, tab, lut, cntp)
    i_loss = torch.where(npos == 0, -neg, -(pos + neg) / npos.clamp_min(1.0))
    v_loss = pull * targets.inst_valid.to(torch.float32)
    n = targets.inst_valid.sum(dim=1).to(torch.float32)
    per = torch.where(n > 0, (i_loss.sum(dim=1) + v_loss.sum(dim=1)) / n.clamp_min(1.0),
                      torch.zeros_like(n))
    return cfg.ae_weight * per.sum() / B


# ---- tangent loss -----------------------------------------------------------------

def tangent_loss(tan: Tuple[torch.Tensor, torch.Tensor], targets: Targets,
                 cfg: LossConfig = LossConfig()) -> torch.Tensor:
    """1 - cos(pred, inward normal) at boundary samples, in its dense form:
    sum_s (1 - cos_s) = n_valid - sum_pix <t_hat, summed normals at pix>, the
    summed-normal field (K5) carrying no gradient."""
    t0, t1 = tan
    B, H, W = t0.shape
    nmap0, nmap1 = rasterize.rasterize_nmap(targets.points, targets.pt_valid,
                                            targets.normals, H, W)
    # sqrt(max(n2, eps^2)): the value of clip(sqrt(n2), eps) with a zero
    # gradient, not NaN, where n2 == 0
    n2 = t0 * t0 + t1 * t1
    inv = 1.0 / torch.sqrt(torch.clamp_min(n2, _EPS * _EPS))
    dot = ((t0 * nmap0 + t1 * nmap1) * inv).sum(dim=(1, 2))
    n_val = targets.pt_valid.reshape(B, -1).sum(dim=1).to(torch.float32)
    per = torch.where(n_val > 0, (n_val - dot) / n_val.clamp_min(1.0), torch.zeros_like(n_val))
    return cfg.tan_weight * per.mean()


# ---- composition -------------------------------------------------------------------

def compose_loss(outputs, targets: Targets, anchors: torch.Tensor,
                 cfg: LossConfig = LossConfig()) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """outputs = (kp, ae, tan, regression, classification) from EfficientSeg in
    training mode (planar heads). Returns (total, the six stats)."""
    kp, ae, tan, regression, classification = outputs
    H, W = kp.shape[1], kp.shape[2]
    xym = coordinate_grid(H, W, kp.device)
    cls_l, reg_l = det_focal_loss(classification, regression, anchors, targets.det_ann, cfg)
    cnt, r2, union = rasterize.rasterize_cnt_r2(targets.points, targets.pt_valid, H, W)
    kp_l = kp_focal_loss_from_union(kp, union)
    ae_l = ae_loss(ae, targets, xym, cnt, r2, cfg)
    tan_l = tangent_loss(tan, targets, cfg)
    total = cls_l + reg_l + kp_l + ae_l + tan_l
    stats = {"cls_loss": cls_l, "wh_loss": reg_l, "kp_loss": kp_l,
             "ae_loss": ae_l, "tan_loss": tan_l, "total_loss": total}
    return total, stats
