"""Metric accumulators; a copy of ``instance_segmentation_tpu/utils/meters.py``.

Covers the reference's meter surface (reference: utils/meter.py:4-21
`AverageMeter`, :24-68 `average_precision`, :71-135 `APMeter`) with fresh
vectorized implementations.
"""

from __future__ import annotations

import numpy as np


class AverageMeter:
    """Running average of a scalar stream."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0
        self.avg = 0.0

    def update(self, val: float, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


def average_precision(recall: np.ndarray, precision: np.ndarray, method: str = "area") -> float:
    """AP from a (recall, precision) curve.

    method='area': integrate the precision envelope (VOC2010-style).
    method='11point': mean of interpolated precision at 11 recall levels.
    """
    recall = np.asarray(recall, dtype=np.float64)
    precision = np.asarray(precision, dtype=np.float64)
    if recall.size == 0:
        return 0.0
    if method == "11point":
        levels = np.linspace(0.0, 1.0, 11)
        interp = [precision[recall >= t].max() if np.any(recall >= t) else 0.0 for t in levels]
        return float(np.mean(interp))
    # envelope integration
    r = np.concatenate([[0.0], recall, [1.0]])
    p = np.concatenate([[0.0], precision, [0.0]])
    p = np.maximum.accumulate(p[::-1])[::-1]
    steps = np.nonzero(r[1:] != r[:-1])[0]
    return float(np.sum((r[steps + 1] - r[steps]) * p[steps + 1]))


class APMeter:
    """Accumulates scored predictions vs. GT counts and reports per-class AP."""

    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self.reset()

    def reset(self):
        self._scores = [[] for _ in range(self.num_classes)]
        self._matched = [[] for _ in range(self.num_classes)]
        self._num_gt = np.zeros(self.num_classes, dtype=np.int64)

    def add(self, cls_id: int, score: float, is_true_positive: bool):
        self._scores[cls_id].append(float(score))
        self._matched[cls_id].append(bool(is_true_positive))

    def add_gt(self, cls_id: int, n: int = 1):
        self._num_gt[cls_id] += n

    def class_ap(self, cls_id: int, method: str = "area") -> float:
        scores = np.asarray(self._scores[cls_id])
        matched = np.asarray(self._matched[cls_id])
        n_gt = self._num_gt[cls_id]
        if n_gt == 0:
            return float("nan")
        if scores.size == 0:
            return 0.0
        order = np.argsort(-scores, kind="stable")
        tp = matched[order].astype(np.float64)
        fp = 1.0 - tp
        tp_cum, fp_cum = np.cumsum(tp), np.cumsum(fp)
        recall = tp_cum / n_gt
        precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-12)
        return average_precision(recall, precision, method=method)

    def value(self, method: str = "area") -> float:
        aps = [self.class_ap(c, method) for c in range(self.num_classes)]
        aps = [a for a in aps if not np.isnan(a)]
        return float(np.mean(aps)) if aps else 0.0
