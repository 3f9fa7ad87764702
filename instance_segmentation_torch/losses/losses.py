"""The training objective, fully on the device.

Counterpart of ``instance_segmentation_tpu/losses/losses.py`` with the
model's planar train heads:

    total = cls + wh (box regression * 50) + kp + ae + tan

The AE loss is exact by default (``LossConfig()``) and takes one of two
routes to its per-instance sample-count and min-r2 maps, the routes the JAX
package takes (``compose_loss`` there):

* where the rasterizer takes the shape (``rasterizer_supported``, a copy of
  ``rasterize_pallas.supported``: up to 512x1024, P % 8 == 0), kernel K2
  makes the count map, the min-r2 map and their union at once from the
  point list, and the kp focal loss reads the union;
* elsewhere, as at the full 1024x2048 frame, ``ae_sample_count`` makes the
  u16 count map with a scatter-add, kernel K6 its min-r2 map, and the kp
  focal loss reads the count map's union over instances.

The port follows the reference's route so that a full-resolution step does
on the card the work the reference's full-resolution step does; whether K2
should take over there on this card is a measurement, not a choice made
here (``tests/test_torch_minr2.py`` holds both routes' maps equal there).
Both routes feed kernels K3/K4 (the AE focal and pull terms). The tangent
loss reads the summed-normal field of kernel K5 at every size (the
reference's full-resolution step scatters it with XLA instead: the same
function up to summation order).

With ``LossConfig(ae_window=(h, w))`` the AE loss is the reference's
approximate windowed form (``ae_loss_windowed``): each instance's focal term
over a fixed crop, plus the pull term, in plain PyTorch; kp comes from the
deduplicated point list, and no rasterizer runs.

Targets that carry the dense kp map (``generate_targets(dense_kp=True)``,
its default) give the kp focal loss from that map (``kp_focal_loss``,
JAX :781-782) on every route; the train step asks for ``dense_kp=False``.

On CPU tensors the kernels' plain twins run instead.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from instance_segmentation_torch.kernels import ae_terms as ae_kernels
from instance_segmentation_torch.kernels import minr2, rasterize
from instance_segmentation_torch.ops.targets import Targets, gaussian_window_target

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
    ae_window: Optional[Tuple[int, int]] = None
    # fixed (rows, cols) crop per instance for the AE focal term; None (the
    # default) is the exact loss over the whole image


def rasterizer_supported(h: int, w: int, p: int) -> bool:
    """The reference's rule for taking the rasterizer K2
    (``rasterize_pallas.supported``); elsewhere the count-map route runs."""
    return (h % 8 == 0 and w % 128 == 0 and p % 8 == 0
            and (w <= 512 or w % 512 == 0) and h * w <= 512 * 1024)


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

def kp_focal_from_sums(pos: torch.Tensor, neg: torch.Tensor,
                       num_pos: torch.Tensor) -> torch.Tensor:
    """The kp focal loss from its three batch sums: the positive and negative
    terms and the positive count."""
    return torch.where(num_pos == 0, -neg, -(pos + neg) / num_pos.clamp_min(1.0))


def kp_focal_sums(kp_logits: torch.Tensor, kp_tgt: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(pos, neg, num_pos) of the CornerNet-style focal loss over the whole
    batch against a dense target kp_tgt [B, H, W] in [0, 1] (1 at
    keypoints; ``generate_targets(dense_kp=True)``'s): the JAX
    ``kp_focal_loss`` = ``focal_heatmap_loss`` without a window."""
    kp = kp_logits if kp_logits.dim() == 3 else kp_logits[..., 0]
    pred = torch.sigmoid(kp).clamp(_EPS, 1.0 - _EPS)
    pos = (kp_tgt == 1.0).to(torch.float32)
    neg = (kp_tgt < 1.0).to(torch.float32)
    t2 = (1.0 - kp_tgt) * (1.0 - kp_tgt)
    pos_sum = (torch.log(pred) * (1.0 - pred) ** 2 * pos).sum()
    neg_sum = (torch.log(1.0 - pred) * pred ** 2 * (t2 * t2) * neg).sum()
    return pos_sum, neg_sum, pos.sum()


def kp_focal_loss(kp_logits: torch.Tensor, kp_tgt: torch.Tensor) -> torch.Tensor:
    """kp_logits [B,H,W,1] (or [B,H,W]), kp_tgt [B,H,W] (ref KPFocalLoss
    :205-213): one focal over the whole batch, num_pos summed across it."""
    return kp_focal_from_sums(*kp_focal_sums(kp_logits, kp_tgt))


def kp_focal_sums_from_union(kp_logits: torch.Tensor, union: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(pos, neg, num_pos) of the CornerNet-style focal loss over the whole
    batch, the binary target being the rasterizer's union map [B, H, W].
    kp_logits [B, H, W] (or [B, H, W, 1])."""
    kp = kp_logits if kp_logits.dim() == 3 else kp_logits[..., 0]
    pred = torch.sigmoid(kp).clamp(_EPS, 1.0 - _EPS)
    u = union.to(torch.float32)
    pos = (torch.log(pred) * (1.0 - pred) ** 2 * u).sum()
    neg = (torch.log(1.0 - pred) * pred ** 2 * (1.0 - u)).sum()
    return pos, neg, u.sum()


def kp_focal_sums_from_cnt(kp_logits: torch.Tensor, cnt: torch.Tensor):
    """The kp focal sums on the count-map route: the target is the union over
    instances of cnt != 0 (cnt u16 [B, M, H, W], read through its int16
    view)."""
    return kp_focal_sums_from_union(kp_logits, (cnt.view(torch.int16) != 0).any(dim=1))


def kp_focal_sums_from_points(kp_logits: torch.Tensor, targets: Targets):
    """The kp focal sums from the point list, as the reference computes them
    when no count map exists (the windowed AE route): the binary target is 1
    at the deduplicated sample pixels, so pos is taken at those pixels, neg
    everywhere less at those pixels, and num_pos counts them. One sort per
    image deduplicates the pixels."""
    kp = kp_logits if kp_logits.dim() == 3 else kp_logits[..., 0]
    B, H, W = kp.shape
    hw = H * W
    pred = torch.sigmoid(kp).clamp(_EPS, 1.0 - _EPS)
    flat = (targets.points[..., 0].long() * W + targets.points[..., 1].long()).reshape(B, -1)
    flat = torch.where(targets.pt_valid.reshape(B, -1), flat, hw)
    flat = torch.sort(flat, dim=-1).values
    prev = torch.cat([flat.new_full((B, 1), -1), flat[:, :-1]], dim=1)
    uf = ((flat != prev) & (flat < hw)).to(torch.float32)
    pv = torch.gather(pred.reshape(B, hw), 1, flat.clamp(0, hw - 1))
    pos = (torch.log(pv) * (1.0 - pv) ** 2 * uf).sum()
    neg_corr = (torch.log(1.0 - pv) * pv ** 2 * uf).sum()
    neg_all = (torch.log(1.0 - pred) * pred ** 2).sum()
    return pos, neg_all - neg_corr, uf.sum()


def kp_focal_loss_from_union(kp_logits: torch.Tensor, union: torch.Tensor) -> torch.Tensor:
    return kp_focal_from_sums(*kp_focal_sums_from_union(kp_logits, union))


def kp_focal_loss_from_cnt(kp_logits: torch.Tensor, cnt: torch.Tensor) -> torch.Tensor:
    return kp_focal_from_sums(*kp_focal_sums_from_cnt(kp_logits, cnt))


def kp_focal_loss_from_points(kp_logits: torch.Tensor, targets: Targets) -> torch.Tensor:
    return kp_focal_from_sums(*kp_focal_sums_from_points(kp_logits, targets))


def focal_heatmap_loss(pred: torch.Tensor, gt: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """CornerNet's penalty-reduced focal loss over the last two dims, inside a
    0/1 window: pred in (0, 1), gt in [0, 1] with 1 at keypoints."""
    pred = pred.clamp(_EPS, 1.0 - _EPS)
    pos = (gt == 1.0).to(torch.float32) * window
    neg = (gt < 1.0).to(torch.float32) * window
    t2 = (1.0 - gt) * (1.0 - gt)
    neg_w = t2 * t2                                # (1 - gt)^4 by squaring, as XLA
    pos_loss = (torch.log(pred) * (1.0 - pred) ** 2 * pos).sum(dim=(-2, -1))
    neg_loss = (torch.log(1.0 - pred) * pred ** 2 * neg_w * neg).sum(dim=(-2, -1))
    num_pos = pos.sum(dim=(-2, -1))
    return torch.where(num_pos == 0, -neg_loss, -(pos_loss + neg_loss) / num_pos.clamp_min(1.0))


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


def _instance_windows(targets: Targets, xym: torch.Tensor, h: int, w: int):
    """Per instance (all [B, M, 2]): the truncated center (row, col), its
    embedding (the grid at the center clipped into the image), and the focal
    window lt/rb: the reference's 2x sample extent around the center, ``lt``
    clipped to [0, 2048], ``rb`` to the image (empty without samples)."""
    centers_int = targets.centers.to(torch.int32)
    ci = centers_int[..., 0].clamp(0, h - 1).long()
    cj = centers_int[..., 1].clamp(0, w - 1).long()
    c_emb = xym[ci, cj]
    val = targets.pt_valid[..., None]
    big = 1 << 20
    kmin = torch.where(val, targets.points, big).amin(dim=2)
    kmax = torch.where(val, targets.points, -big).amax(dim=2)
    half = kmax - kmin                          # mask_size // 2, mask_size = 2 * extent
    lt = (centers_int - half).clamp(0, 2048)
    rb = centers_int + half
    rb = torch.stack([rb[..., 0].clamp(0, h), rb[..., 1].clamp(0, w)], dim=-1)
    return centers_int, c_emb, lt, rb


def ae_table(targets: Targets, xym: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The per-instance table [B, M, 8] of K3/K4: center embedding, focal
    window lt/rb (``_instance_windows``) and the valid flag."""
    _, c_emb, lt, rb = _instance_windows(targets, xym, h, w)
    return ae_kernels.pack_table(c_emb, lt, rb, targets.inst_valid)


def ae_sample_count(targets: Targets, h: int, w: int) -> torch.Tensor:
    """u16 [B, M, H, W] per-instance sample-count map of the count-map route:
    a scatter-add of one per valid sample at its clipped pixel (exact in
    u16: counts <= P)."""
    return rasterize.i32_to_u16(rasterize.sample_count(targets.points, targets.pt_valid, h, w))


def ae_loss(ae: Tuple[torch.Tensor, ...], targets: Targets, xym: torch.Tensor,
            cnt: torch.Tensor, r2: torch.Tensor, cfg: LossConfig = LossConfig()) -> torch.Tensor:
    """ae: the four planar [B, H, W] heads (2 offsets, 2 log-sigmas); cnt/r2
    from K2, or from ``ae_sample_count`` and K6. Per instance: focal loss of
    the embedding affinity against the gaussian target inside the instance
    window, plus the pull term; summed over instances, divided by the valid
    count, averaged over images."""
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


def _pull_terms(ey: torch.Tensor, ex: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor,
                c_emb: torch.Tensor, targets: Targets) -> torch.Tensor:
    """The pull term per instance, [B, M] (the reference's ``_pull_term_one``
    for every instance at once): at each valid sample of instance m, the
    affinity of its embedding to every valid center; the L1 gap between the
    affinity to m's own center and the best one, summed over the samples."""
    B, H, W = ey.shape
    M, P = targets.points.shape[1:3]
    ys = targets.points[..., 0].clamp(0, H - 1).long()
    xs = targets.points[..., 1].clamp(0, W - 1).long()
    flat = (ys * W + xs).view(B, M * P)

    def at_samples(plane):                                  # [B, M, P, 1]
        return torch.gather(plane.reshape(B, H * W), 1, flat).view(B, M, P, 1)
    dy = at_samples(ey) - c_emb[:, None, None, :, 0]        # [B, M, P, M]
    dx = at_samples(ex) - c_emb[:, None, None, :, 1]
    d = torch.exp(-(dy * dy * at_samples(sy) + dx * dx * at_samples(sx)))
    d = torch.where(targets.inst_valid[:, None, None, :], d, float("-inf"))
    d_max = d.amax(dim=-1)                                  # ties share the gradient, as jnp.max
    own = torch.diagonal(d, dim1=1, dim2=3).permute(0, 2, 1)   # [B, M, P]: d[b, m, p, m]
    gap = torch.where(targets.pt_valid, (own - d_max).abs(), torch.zeros_like(own))
    return gap.sum(dim=-1)


def ae_loss_windowed(ae: Tuple[torch.Tensor, ...], targets: Targets, xym: torch.Tensor,
                     cfg: LossConfig) -> torch.Tensor:
    """The reference's ``_ae_loss_windowed`` (``cfg.ae_window`` set), for all
    instances at once: each instance's focal term over a fixed (wh, ww) crop
    at its center, the origin clipped into the image, against the gaussian
    target of its samples in the crop and inside its focal window; plus the
    pull term. Approximate where an instance's window exceeds the crop."""
    wh, ww = cfg.ae_window
    a0, a1, a2, a3 = ae
    B, H, W = a0.shape
    if wh > H or ww > W:
        raise ValueError(f"ae_window {cfg.ae_window} exceeds the {H}x{W} image")
    ey = torch.tanh(a0) + xym[..., 0]
    ex = torch.tanh(a1) + xym[..., 1]
    sy = torch.exp(a2)
    sx = torch.exp(a3)
    M = targets.points.shape[1]
    centers_int, c_emb, lt, rb = _instance_windows(targets, xym, H, W)
    valid_f = targets.inst_valid.to(torch.float32)
    origin = torch.stack([(centers_int[..., 0] - wh // 2).clamp(0, H - wh),
                          (centers_int[..., 1] - ww // 2).clamp(0, W - ww)], dim=-1)
    rows = origin[..., 0, None] + torch.arange(wh, device=a0.device)       # [B, M, wh]
    cols = origin[..., 1, None] + torch.arange(ww, device=a0.device)       # [B, M, ww]
    win_r = (rows >= lt[..., 0, None]) & (rows < rb[..., 0, None])
    win_c = (cols >= lt[..., 1, None]) & (cols < rb[..., 1, None])
    window = (win_r[..., :, None] & win_c[..., None, :]).to(torch.float32)
    window = window * valid_f[..., None, None]
    idx = (rows[..., :, None].long() * W + cols[..., None, :]).view(B, M * wh * ww)

    def crop(plane):                                        # [B, M, wh, ww]
        return torch.gather(plane.reshape(B, H * W), 1, idx).view(B, M, wh, ww)
    dy = crop(ey) - c_emb[..., 0, None, None]
    dx = crop(ex) - c_emb[..., 1, None, None]
    pred = torch.exp(-(dy * dy * crop(sy) + dx * dx * crop(sx)))
    rel = targets.points - origin[:, :, None, :]
    val_in = (targets.pt_valid & (rel[..., 0] >= 0) & (rel[..., 0] < wh)
              & (rel[..., 1] >= 0) & (rel[..., 1] < ww))
    tgt = gaussian_window_target(rel, val_in, wh, ww)
    i_loss = focal_heatmap_loss(pred, tgt, window=window) * valid_f
    v_loss = _pull_terms(ey, ex, sy, sx, c_emb, targets) * valid_f
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
                 cfg: LossConfig = LossConfig(), group=None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """outputs = (kp, ae, tan, regression, classification) from EfficientSeg in
    training mode (planar heads). Returns (total, the six stats). The kp and
    AE losses take the route of the module docstring.

    With a process group (data parallelism), this rank's batch is its slice
    of a global batch of equal slices: see ``_data_parallel``."""
    kp, ae, tan, regression, classification = outputs
    H, W = kp.shape[1], kp.shape[2]
    xym = coordinate_grid(H, W, kp.device)
    cls_l, reg_l = det_focal_loss(classification, regression, anchors, targets.det_ann, cfg)
    dense = targets.kp_tgt is not None      # the dense target comes first, as in JAX
    if cfg.ae_window is not None:
        kp_sums = None if dense else kp_focal_sums_from_points(kp, targets)
        ae_l = ae_loss_windowed(ae, targets, xym, cfg)
    else:
        if rasterizer_supported(H, W, targets.points.shape[2]):
            cnt, r2, union = rasterize.rasterize_cnt_r2(targets.points, targets.pt_valid, H, W)
            kp_sums = None if dense else kp_focal_sums_from_union(kp, union)
        else:
            cnt = ae_sample_count(targets, H, W)
            r2 = minr2.minr2_from_cnt(cnt, targets.pt_valid.any(dim=2))
            kp_sums = None if dense else kp_focal_sums_from_cnt(kp, cnt)
        ae_l = ae_loss(ae, targets, xym, cnt, r2, cfg)
    if dense:
        kp_sums = kp_focal_sums(kp, targets.kp_tgt)
    tan_l = tangent_loss(tan, targets, cfg)
    if group is not None:
        return _data_parallel(cls_l, reg_l, kp_sums, ae_l, tan_l, group)
    kp_l = kp_focal_from_sums(*kp_sums)
    total = cls_l + reg_l + kp_l + ae_l + tan_l
    stats = {"cls_loss": cls_l, "wh_loss": reg_l, "kp_loss": kp_l,
             "ae_loss": ae_l, "tan_loss": tan_l, "total_loss": total}
    return total, stats


def _data_parallel(cls_l, reg_l, kp_sums, ae_l, tan_l, group
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(this rank's share of the loss, the six global stats) for a rank of
    ``group``, whose gradients DDP averages over the group's ``n`` ranks.

    The det, AE and tangent losses are means over images, so the mean of the
    ranks' losses is the global one. The kp focal loss is not: its sums run
    over the whole batch and are divided once. So its three sums are summed
    over the ranks (one all-reduce, with the other four terms for the
    stats), the global positive count decides both the normaliser and the
    ``num_pos == 0`` branch, and this rank's share of the kp loss is ``n``
    times its own sums over that normaliser. The stats are the global
    losses, equal on every rank."""
    n = dist.get_world_size(group)
    pos, neg, num_pos = kp_sums
    local = torch.stack([cls_l, reg_l, ae_l, tan_l, pos, neg, num_pos]).detach()
    dist.all_reduce(local, group=group)
    cls_g, reg_g, ae_g, tan_g = (local[:4] / n).unbind()
    pos_g, neg_g, num_pos_g = local[4:].unbind()
    kp_g = kp_focal_from_sums(pos_g, neg_g, num_pos_g)
    kp_share = n * torch.where(num_pos_g == 0, -neg, -(pos + neg) / num_pos_g.clamp_min(1.0))
    total = cls_l + reg_l + kp_share + ae_l + tan_l
    stats = {"cls_loss": cls_g, "wh_loss": reg_g, "kp_loss": kp_g, "ae_loss": ae_g,
             "tan_loss": tan_g, "total_loss": cls_g + reg_g + kp_g + ae_g + tan_g}
    return total, stats
