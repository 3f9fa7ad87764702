"""COCO-protocol instance-mask average precision, without pycocotools.

Counterpart of ``instance_segmentation_tpu/evaluation/coco_ap.py``: a
re-implementation of pycocotools ``COCOeval`` (iouType="segm") matching and
accumulation, with the same semantics as there:

  * IoU thresholds 0.50:0.05:0.95, 101-point recall interpolation;
  * per-(image, category) greedy matching in score order, each detection
    taking the highest-IoU ground truth still available at the threshold;
  * ``iscrowd`` ground truth is ignore-only: it can absorb any number of
    detections, never counts as a true positive, and its IoU uses the
    crowd rule (union = detection area);
  * non-ignored ground truths are preferred over ignored ones even at
    lower IoU (the official "break on first ignored after a real match");
  * area-range buckets (all / small <32^2 / medium / large >96^2):
    out-of-range ground truth is ignored, unmatched out-of-range
    detections are discounted rather than counted as false positives;
  * categories with no (non-ignored) ground truth are excluded from means.

IoUs are computed on polygon masks rasterised at the original resolution
by the port's ``utils/image.poly_to_mask`` (``cv2.fillPoly`` bit for bit).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from instance_segmentation_torch.data import coco as coco_mod
from instance_segmentation_torch.utils.image import poly_to_mask

IOU_THRS = tuple(np.round(np.linspace(0.5, 0.95, 10), 2))
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}


@dataclass
class CocoPrediction:
    image_id: str
    cls_id: int                  # contiguous [0, num_classes) index
    score: float
    polygon: np.ndarray          # [n, 2] (x, y) float, original resolution


@dataclass
class CocoGT:
    image_id: str
    cls_id: int
    polygon: Optional[np.ndarray] = None   # [n, 2] (x, y); OR a mask:
    iscrowd: bool = False
    area: Optional[float] = None  # annotation area; mask area when absent
    mask: Optional[np.ndarray] = None      # [h, w] bool (RLE annotations)


def _poly_mask(poly: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    return poly_to_mask(np.asarray(poly, np.float32), hw).astype(bool)


def rle_to_mask(segm: dict) -> np.ndarray:
    """Decode a COCO RLE segmentation (compressed string or uncompressed
    counts list) to an [h, w] bool mask. iscrowd annotations are always RLE
    in COCO, so scoring their ignore semantics requires this decoder; the
    string format follows pycocotools rleFrString (5-bit chars offset by 48,
    continuation bit 0x20, sign-extension bit 0x10, delta from counts[i-2]),
    runs alternate 0/1 in column-major order."""
    h, w = segm["size"]
    counts = segm["counts"]
    if isinstance(counts, (bytes, str)):
        if isinstance(counts, bytes):
            counts = counts.decode("ascii")
        vals = []
        p = 0
        while p < len(counts):
            x, k, more = 0, 0, True
            while more:
                c = ord(counts[p]) - 48
                x |= (c & 0x1F) << (5 * k)
                more = bool(c & 0x20)
                p += 1
                k += 1
                if not more and (c & 0x10):
                    x |= -1 << (5 * k)
            if len(vals) > 2:
                x += vals[-2]
            vals.append(x)
        counts = vals
    flat = np.zeros(h * w, bool)
    pos, val = 0, False
    for run in counts:
        if val:
            flat[pos:pos + run] = True
        pos += run
        val = not val
    return flat.reshape(w, h).T        # column-major


class _ImageCatData:
    """Masks, areas, and the COCO IoU matrix for one (image, category)."""

    def __init__(self, preds: List[CocoPrediction], gts: List[CocoGT],
                 hw: Tuple[int, int]):
        # detections in descending score order (stable, like pycocotools)
        self.preds = sorted(preds, key=lambda p: -p.score)
        self.gts = gts
        pm = [_poly_mask(p.polygon, hw) for p in self.preds]
        gm = [g.mask if g.mask is not None else _poly_mask(g.polygon, hw)
              for g in gts]
        self.pred_area = np.array([m.sum() for m in pm], np.float64)
        gm_area = np.array([m.sum() for m in gm], np.float64)  # mask px (IoU)
        self.gt_area = np.array(
            [g.area if g.area is not None else a
             for g, a in zip(gts, gm_area)], np.float64)       # ann area (ignore)
        self.iou = np.zeros((len(pm), len(gm)), np.float64)
        for di, d in enumerate(pm):
            for gi, g in enumerate(gm):
                inter = float(np.logical_and(d, g).sum())
                if gts[gi].iscrowd:
                    union = self.pred_area[di]          # crowd rule
                else:
                    union = self.pred_area[di] + gm_area[gi] - inter
                self.iou[di, gi] = inter / union if union > 0 else 0.0

    def evaluate(self, area_rng: Tuple[float, float], max_dets: int,
                 iou_thrs: Sequence[float]):
        """COCOeval.evaluateImg: (dt_matched, dt_ignored, scores, n_pos_gt)."""
        n_gt, n_dt = len(self.gts), min(len(self.preds), max_dets)
        gt_ig = np.array(
            [g.iscrowd or not (area_rng[0] <= a <= area_rng[1])
             for g, a in zip(self.gts, self.gt_area)], bool)
        # non-ignored ground truth first (stable)
        g_order = np.argsort(gt_ig, kind="stable")
        T = len(iou_thrs)
        dtm = np.zeros((T, n_dt), bool)
        dt_ig = np.zeros((T, n_dt), bool)
        gtm = np.zeros((T, n_gt), bool)
        for ti, t in enumerate(iou_thrs):
            for di in range(n_dt):
                best = min(t, 1.0 - 1e-10)
                m = -1
                for gi in g_order:
                    if gtm[ti, gi] and not self.gts[gi].iscrowd:
                        continue
                    # past a real match, ignored gts can't improve it
                    if m > -1 and not gt_ig[m] and gt_ig[gi]:
                        break
                    if self.iou[di, gi] < best:
                        continue
                    best = self.iou[di, gi]
                    m = gi
                if m == -1:
                    continue
                dtm[ti, di] = True
                dt_ig[ti, di] = gt_ig[m]
                gtm[ti, m] = True
        # unmatched detections outside the area range are discounted
        out = ~((area_rng[0] <= self.pred_area[:n_dt])
                & (self.pred_area[:n_dt] <= area_rng[1]))
        dt_ig |= (~dtm) & out[None, :]
        scores = np.array([p.score for p in self.preds[:n_dt]], np.float64)
        return dtm, dt_ig, scores, int((~gt_ig).sum())


def compute_coco_ap(predictions: Sequence[CocoPrediction],
                    ground_truth: Sequence[CocoGT],
                    image_sizes: Dict[str, Tuple[int, int]],
                    num_classes: int,
                    max_dets: int = 100,
                    iou_thrs: Sequence[float] = IOU_THRS,
                    ) -> Dict[str, object]:
    """COCO AP over mask IoU.

    Returns {"AP", "AP50", "AP75", "AP_small", "AP_medium", "AP_large",
    "classes": {cls: {"AP", "AP50"}}} — AP/AP50/AP75 use the "all" area
    range and ``max_dets`` detections per image, like the headline COCO
    metrics.
    """
    preds_by: Dict[Tuple[str, int], List[CocoPrediction]] = {}
    gts_by: Dict[Tuple[str, int], List[CocoGT]] = {}
    for p in predictions:
        preds_by.setdefault((p.image_id, p.cls_id), []).append(p)
    for g in ground_truth:
        gts_by.setdefault((g.image_id, g.cls_id), []).append(g)

    data: Dict[Tuple[str, int], _ImageCatData] = {}
    for key in set(preds_by) | set(gts_by):
        data[key] = _ImageCatData(preds_by.get(key, []), gts_by.get(key, []),
                                  image_sizes[key[0]])

    T = len(iou_thrs)
    # precision[area][t, r, cls]; -1 marks "no ground truth"
    precision = {a: -np.ones((T, len(REC_THRS), num_classes))
                 for a in AREA_RANGES}
    per_class: Dict[int, Dict[str, float]] = {}

    for c in range(num_classes):
        keys = [k for k in data if k[1] == c]
        if not keys:
            continue
        for aname, arng in AREA_RANGES.items():
            evs = [data[k].evaluate(arng, max_dets, iou_thrs) for k in keys]
            npig = sum(e[3] for e in evs)
            if npig == 0:
                continue
            dtm = np.concatenate([e[0] for e in evs], axis=1)
            dt_ig = np.concatenate([e[1] for e in evs], axis=1)
            scores = np.concatenate([e[2] for e in evs])
            order = np.argsort(-scores, kind="mergesort")
            dtm, dt_ig = dtm[:, order], dt_ig[:, order]
            tps = np.cumsum(dtm & ~dt_ig, axis=1, dtype=np.float64)
            fps = np.cumsum(~dtm & ~dt_ig, axis=1, dtype=np.float64)
            for ti in range(T):
                tp, fp = tps[ti], fps[ti]
                rc = tp / npig
                pr = tp / np.maximum(tp + fp, np.spacing(1))
                # monotone non-increasing from the right (COCOeval)
                for i in range(len(pr) - 1, 0, -1):
                    pr[i - 1] = max(pr[i - 1], pr[i])
                q = np.zeros(len(REC_THRS))
                inds = np.searchsorted(rc, REC_THRS, side="left")
                valid = inds < len(pr)
                q[valid] = pr[inds[valid]]
                precision[aname][ti, :, c] = q
        p_all = precision["all"][:, :, c]
        if (p_all > -1).any():
            per_class[c] = {
                "AP": float(p_all[p_all > -1].mean()),
                "AP50": float(p_all[0][p_all[0] > -1].mean()),
            }

    def _mean(p) -> float:
        v = p[p > -1]
        return float(v.mean()) if v.size else 0.0

    return {
        "AP": _mean(precision["all"]),
        "AP50": _mean(precision["all"][0]),
        "AP75": _mean(precision["all"][5]),
        "AP_small": _mean(precision["small"]),
        "AP_medium": _mean(precision["medium"]),
        "AP_large": _mean(precision["large"]),
        "classes": per_class,
    }


def write_coco_results(path: str, dets_list, info_list,
                       cls_index_to_cat_id=None) -> int:
    """Standard COCO results-format json (list of {image_id, category_id,
    segmentation (polygon), score}) so detections can also be scored by the
    official pycocotools elsewhere. Returns the number written."""
    if cls_index_to_cat_id is None:
        index_to_cat = {}
        for cat in range(1, 91):
            if cat in coco_mod.skip_cls_ids:
                continue
            index_to_cat[coco_mod.convert_cls_id_to_index(cat)] = cat
        cls_index_to_cat_id = index_to_cat
    out = []
    for dets, info in zip(dets_list, info_list):
        img_path = info[0]
        # COCO image id: numeric part of the file name when present
        stem = os.path.splitext(os.path.basename(img_path))[0]
        img_id = int(stem) if stem.isdigit() else stem
        for det in dets:
            cls_id, score, _center, polygon = det
            poly = np.asarray(polygon, np.float32)
            out.append({
                "image_id": img_id,
                "category_id": int(cls_index_to_cat_id.get(int(cls_id),
                                                           int(cls_id))),
                "segmentation": [poly.reshape(-1).tolist()],
                "score": float(score),
            })
    with open(path, "w") as f:
        json.dump(out, f)
    return len(out)
