"""Cityscapes instance-level average precision — official protocol, native.

A copy of ``instance_segmentation_tpu/evaluation/cityscapes_ap.py`` whose
masks come from this package's ``utils/image.poly_to_mask`` (``cv2.fillPoly``
bit for bit).

A dependency-free implementation of the exact matching/averaging rules of
`cityscapesscripts/evaluation/evalInstanceLevelSemanticLabeling.py`, which
the reference delegates to (ref utils/eval_util.py:96-127). Semantics
covered (verified against the official source's published algorithm):

  * per-class y_true/y_score accumulation over images; AP integrated with
    the official step-width convolution, averaged over mask-IoU thresholds
    0.50:0.05:0.95 ("AP") and reported at 0.50 ("AP50");
  * `*group` ground-truth regions (``InstanceGT.is_group``, the official
    ``instID < 1000``) and instances smaller than ``min_region_size``
    (official minRegionSizes=[100]) are excluded from matching, and their
    pixels count as ignore overlap for unmatched predictions;
  * an unmatched prediction becomes a false positive only when its ignore
    fraction (void pixels + same-class group/small-instance intersections,
    divided by the prediction's pixel count) is <= the IoU threshold —
    otherwise it is discarded (official "void-region discounting");
  * a ground truth matched by several predictions keeps the highest score
    as its true positive; each further match appends a false positive with
    the lower score (official multi-match rule — NOT greedy one-to-one);
  * classes with no ground truth anywhere are excluded from the mean.

IoUs are computed on rasterized polygon masks at original image resolution.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from instance_segmentation_torch.utils.image import poly_to_mask

OVERLAPS = tuple(np.arange(0.5, 1.0, 0.05))
MIN_REGION_SIZE = 100      # official args.minRegionSizes[0] for Cityscapes


@dataclass
class InstancePrediction:
    image_id: str
    cls_id: int
    score: float
    polygon: np.ndarray          # [n, 2] (x, y) float, original resolution


@dataclass
class InstanceGT:
    image_id: str
    cls_id: int
    polygon: np.ndarray          # [n, 2] (x, y)
    is_group: bool = False       # `*group` label (official instID < 1000)


def _poly_mask(poly: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    # single shared rasterizer (utils/image.py poly_to_mask) so eval and
    # loss-side rasterization cannot drift
    return poly_to_mask(np.asarray(poly, np.float32), hw).astype(np.uint8)


class _ImageClassData:
    """Per-(image, class) rasterized masks + pairwise intersections."""

    def __init__(self, preds: List[InstancePrediction], gts: List[InstanceGT],
                 hw: Tuple[int, int], void_mask: Optional[np.ndarray]):
        self.preds = preds
        self.gts = gts
        pm = [_poly_mask(p.polygon, hw).astype(bool) for p in preds]
        gm = [_poly_mask(g.polygon, hw).astype(bool) for g in gts]
        self.pred_px = np.array([int(m.sum()) for m in pm], np.int64)
        self.gt_px = np.array([int(m.sum()) for m in gm], np.int64)
        self.inter = np.zeros((len(pm), len(gm)), np.int64)
        for i, a in enumerate(pm):
            for j, b in enumerate(gm):
                self.inter[i, j] = int(np.logical_and(a, b).sum())
        if void_mask is not None and len(pm):
            self.void_inter = np.array(
                [int(np.logical_and(m, void_mask).sum()) for m in pm], np.int64)
        else:
            self.void_inter = np.zeros(len(pm), np.int64)

    def iou(self, pi: int, gi: int) -> float:
        union = self.pred_px[pi] + self.gt_px[gi] - self.inter[pi, gi]
        return float(self.inter[pi, gi]) / union if union > 0 else 0.0


def _official_ap(y_true: np.ndarray, y_score: np.ndarray, hard_fns: int,
                 have_gt: bool) -> float:
    """Official computeAverages AP integration (step-width convolution)."""
    n = len(y_score)
    if n == 0:
        return 0.0 if have_gt else float("nan")
    order = np.argsort(y_score)                       # ascending (official)
    y_score = y_score[order]
    y_true = y_true[order]
    cum_true = np.cumsum(y_true)
    thresholds, unique_idx = np.unique(y_score, return_index=True)
    nb_pr = len(unique_idx) + 1
    nb_true = cum_true[-1]
    precision = np.zeros(nb_pr)
    recall = np.zeros(nb_pr)
    for res_i, score_i in enumerate(unique_idx):
        below = cum_true[score_i - 1] if score_i > 0 else 0
        tp = nb_true - below
        fp = (n - score_i) - tp
        fn = below + hard_fns
        precision[res_i] = tp / (tp + fp) if tp + fp > 0 else 0.0
        recall[res_i] = tp / (tp + fn) if tp + fn > 0 else 0.0
    precision[-1] = 1.0                               # artificial first point
    recall[-1] = 0.0
    recall_conv = np.concatenate([[recall[0]], recall, [0.0]])
    step_widths = np.convolve(recall_conv, [-0.5, 0, 0.5], "valid")
    return float(np.dot(precision, step_widths))


def compute_instance_ap(predictions: Sequence[InstancePrediction],
                        ground_truth: Sequence[InstanceGT],
                        image_sizes: Dict[str, Tuple[int, int]],
                        num_classes: int,
                        overlaps: Sequence[float] = OVERLAPS,
                        min_region_size: int = MIN_REGION_SIZE,
                        void_regions: Optional[Dict[str, List[np.ndarray]]] = None,
                        ) -> Dict[str, object]:
    """Official-protocol instance AP.

    void_regions: optional {image_id: [polygon (x, y), ...]} of
    ignore-in-eval regions (the official void image); overlap with them
    discounts false positives.

    Returns {"AP": float, "AP50": float, "classes": {cls: {"AP", "AP50"}}}.
    """
    preds_by: Dict[Tuple[str, int], List[InstancePrediction]] = {}
    gts_by: Dict[Tuple[str, int], List[InstanceGT]] = {}
    for p in predictions:
        preds_by.setdefault((p.image_id, p.cls_id), []).append(p)
    for g in ground_truth:
        gts_by.setdefault((g.image_id, g.cls_id), []).append(g)

    void_masks: Dict[str, Optional[np.ndarray]] = {}

    def void_mask_for(img: str) -> Optional[np.ndarray]:
        if img not in void_masks:
            polys = (void_regions or {}).get(img)
            if polys:
                m = np.zeros(image_sizes[img], bool)
                for poly in polys:
                    m |= _poly_mask(poly, image_sizes[img]).astype(bool)
                void_masks[img] = m
            else:
                void_masks[img] = None
        return void_masks[img]

    data: Dict[Tuple[str, int], _ImageClassData] = {}
    for key in set(preds_by) | set(gts_by):
        data[key] = _ImageClassData(preds_by.get(key, []), gts_by.get(key, []),
                                    image_sizes[key[0]], void_mask_for(key[0]))

    per_class: Dict[int, Dict[str, float]] = {}
    ap_means, ap50s = [], []
    for c in range(num_classes):
        # official haveGt counts ELIGIBLE instances (non-group and >=
        # minRegionSize): a class whose only ground truth is group regions
        # or tiny instances is excluded from the mean (NaN in the official
        # script), not averaged in as 0
        have_gt = any(
            key[1] == c and not g.is_group and d.gt_px[gi] >= min_region_size
            for key, d in data.items() for gi, g in enumerate(d.gts))
        if not have_gt:
            continue
        aps = []
        ap50 = 0.0
        for th in overlaps:
            y_true_all: List[np.ndarray] = []
            y_score_all: List[np.ndarray] = []
            hard_fns = 0
            for key, d in data.items():
                if key[1] != c:
                    continue
                # eligible gts: real instances of sufficient size
                eligible = [gi for gi, g in enumerate(d.gts)
                            if not g.is_group and d.gt_px[gi] >= min_region_size]
                cur_true: List[int] = []
                cur_score: List[float] = []
                pred_matched = np.zeros(len(d.preds), bool)
                for gi in eligible:
                    gt_score = -np.inf
                    gt_matched = False
                    for pi in range(len(d.preds)):
                        if d.inter[pi, gi] <= 0 or d.iou(pi, gi) <= th:
                            continue
                        pred_matched[pi] = True
                        conf = d.preds[pi].score
                        if gt_matched:
                            # official multi-match: higher score stays the
                            # TP, lower becomes an FP entry
                            lo, hi = min(gt_score, conf), max(gt_score, conf)
                            gt_score = hi
                            cur_true.append(0)
                            cur_score.append(lo)
                        else:
                            gt_matched = True
                            gt_score = conf
                    if gt_matched:
                        cur_true.append(1)
                        cur_score.append(gt_score)
                    else:
                        hard_fns += 1
                # unmatched predictions -> FP unless mostly ignore overlap
                for pi in range(len(d.preds)):
                    if pred_matched[pi] or d.pred_px[pi] == 0:
                        continue
                    ignore_px = int(d.void_inter[pi])
                    for gi, g in enumerate(d.gts):
                        if g.is_group or d.gt_px[gi] < min_region_size:
                            ignore_px += int(d.inter[pi, gi])
                    if ignore_px / float(d.pred_px[pi]) <= th:
                        cur_true.append(0)
                        cur_score.append(d.preds[pi].score)
                if cur_true:
                    y_true_all.append(np.asarray(cur_true))
                    y_score_all.append(np.asarray(cur_score, np.float64))
            y_true = np.concatenate(y_true_all) if y_true_all else np.zeros(0)
            y_score = np.concatenate(y_score_all) if y_score_all else np.zeros(0)
            ap = _official_ap(y_true, y_score, hard_fns, have_gt=True)
            aps.append(ap)
            if abs(th - 0.5) < 1e-9:
                ap50 = ap
        per_class[c] = {"AP": float(np.mean(aps)), "AP50": float(ap50)}
        ap_means.append(per_class[c]["AP"])
        ap50s.append(per_class[c]["AP50"])

    return {
        "AP": float(np.mean(ap_means)) if ap_means else 0.0,
        "AP50": float(np.mean(ap50s)) if ap50s else 0.0,
        "classes": per_class,
    }
