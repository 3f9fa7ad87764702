"""Multiscale anchor generation as a pure function of (H, W), in numpy.

A copy of ``instance_segmentation_tpu/models/anchors.py``: importing that
module runs ``instance_segmentation_tpu/models/__init__.py``, which imports
flax, and this package must not depend on JAX.

Layout contract (must match the heads): levels stacked in order; within a
level, anchors are cell-major (row-major over the stride grid) with the
per-cell anchor index a = scale_idx * n_ratios + ratio_idx.
Boxes are (y1, x1, y2, x2) in input-pixel coordinates.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Sequence, Tuple

import numpy as np

DEFAULT_SCALES = (2 ** 0, 2 ** (1.0 / 3.0), 2 ** (2.0 / 3.0))
DEFAULT_RATIOS = ((1.0, 1.0), (1.4, 0.7), (0.7, 1.4))


@lru_cache(maxsize=16)
def _generate(h: int, w: int, pyramid_levels: Tuple[int, ...], anchor_scale: float,
              scales: Tuple[float, ...], ratios: Tuple[Tuple[float, float], ...]) -> np.ndarray:
    boxes_all = []
    for level in pyramid_levels:
        stride = 2 ** level
        if w % stride != 0 or h % stride != 0:
            raise ValueError(
                f"input size ({h},{w}) must be divisible by stride {stride}")
        x = np.arange(stride / 2, w, stride, dtype=np.float32)
        y = np.arange(stride / 2, h, stride, dtype=np.float32)
        xv, yv = np.meshgrid(x, y)        # row-major cells
        xv, yv = xv.reshape(-1), yv.reshape(-1)
        level_boxes = []
        for scale in scales:
            for ratio in ratios:
                base = anchor_scale * stride * scale
                ax2, ay2 = base * ratio[0] / 2.0, base * ratio[1] / 2.0
                b = np.stack([yv - ay2, xv - ax2, yv + ay2, xv + ax2], axis=1)
                level_boxes.append(b[:, None, :])
        boxes_all.append(np.concatenate(level_boxes, axis=1).reshape(-1, 4))
    out = np.vstack(boxes_all).astype(np.float32)
    out.setflags(write=False)
    return out


def generate_anchors(h: int, w: int, pyramid_levels: Sequence[int] = (3, 4, 5, 6, 7),
                     anchor_scale: float = 4.0,
                     scales: Sequence[float] = DEFAULT_SCALES,
                     ratios: Sequence[Tuple[float, float]] = DEFAULT_RATIOS) -> np.ndarray:
    """Return [A, 4] anchors (y1, x1, y2, x2) for an (h, w) input (read-only)."""
    scales = tuple(float(s) for s in scales)
    ratios = tuple((float(r[0]), float(r[1])) for r in ratios)
    return _generate(int(h), int(w), tuple(int(p) for p in pyramid_levels),
                     float(anchor_scale), scales, ratios)
