"""Mask IoU between decoded instances and packed ground truth, on the device.

Counterpart of ``instance_segmentation_tpu/evaluation/device_iou.py``: the
predicted polygons are rasterized by ``ops/decode.render_masks`` and the
packed GT polygons by ``ops/geometry.rasterize_polygon`` on the tensors'
device, and only the [B, D', M] IoU matrix goes to the host, where
``match_and_score`` matches greedily into a ``utils/meters.APMeter``.
``res_divisor`` evaluates the IoUs at reduced resolution (2 = a quarter of
the pixels).
"""

from __future__ import annotations

import numpy as np
import torch

from instance_segmentation_torch.ops.decode import Detections, render_masks
from instance_segmentation_torch.ops.geometry import rasterize_polygon


def gt_masks_from_packed(polys: torch.Tensor, cls_ids: torch.Tensor, h: int, w: int,
                         scale: float = 1.0) -> torch.Tensor:
    """Packed GT polygons [B,M,V,2] (row, col) -> bool [B,M,h,w]. ``scale``
    maps label coordinates to the raster frame (e.g. 2.0 when labels are at
    model input resolution and masks at the original one)."""
    return rasterize_polygon(polys * scale, h, w) & (cls_ids >= 0)[..., None, None]


def iou_matrix(dets: Detections, gt_polys: torch.Tensor, gt_cls: torch.Tensor,
               orig_h: int, orig_w: int, label_scale: float = 2.0,
               res_divisor: int = 2, max_masks: int = 32):
    """IoU between decoded instances and GT instances, on their device.
    Returns (iou [B, D', M] f32, pred_valid [B, D'], gt_valid [B, M]) with
    D' = max_masks. Class agreement is left to the host matcher."""
    h, w = orig_h // res_divisor, orig_w // res_divisor
    pred = render_masks(dets._replace(polygons=dets.polygons / res_divisor,
                                      centers=dets.centers / res_divisor),
                        h, w, max_masks=max_masks)                      # [B,D',h,w]
    gt = gt_masks_from_packed(gt_polys, gt_cls, h, w,
                              scale=label_scale / res_divisor)          # [B,M,h,w]
    p = pred.reshape(pred.shape[0], pred.shape[1], -1).float()
    g = gt.reshape(gt.shape[0], gt.shape[1], -1).float()
    inter = torch.bmm(p, g.transpose(1, 2))
    union = torch.clamp(p.sum(-1)[:, :, None] + g.sum(-1)[:, None, :] - inter, min=1.0)
    return inter / union, dets.obj_valid[:, :max_masks], gt_cls >= 0


def match_and_score(iou: np.ndarray, pred_valid: np.ndarray, gt_valid: np.ndarray,
                    pred_cls: np.ndarray, pred_scores: np.ndarray,
                    gt_cls: np.ndarray, num_classes: int,
                    ap_meter, overlap: float = 0.5) -> None:
    """Host-side greedy matching of the IoU matrix into an APMeter."""
    B = iou.shape[0]
    for b in range(B):
        for c in np.unique(gt_cls[b][gt_valid[b]]):
            ap_meter.add_gt(int(c), int(((gt_cls[b] == c) & gt_valid[b]).sum()))
        order = np.argsort(-pred_scores[b], kind="stable")
        matched = np.zeros(iou.shape[2], bool)
        for d in order:
            if not pred_valid[b, d]:
                continue
            c = int(pred_cls[b, d])
            cand = np.where(~matched & gt_valid[b] & (gt_cls[b] == c)
                            & (iou[b, d] > overlap))[0]
            tp = False
            if cand.size:
                best = cand[np.argmax(iou[b, d][cand])]
                matched[best] = True
                tp = True
            ap_meter.add(c, float(pred_scores[b, d]), tp)
