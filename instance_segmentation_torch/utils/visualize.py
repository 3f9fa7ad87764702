"""Prediction rendering without OpenCV.

Counterpart of ``instance_segmentation_tpu/utils/visualize.py``:
``visualize_instances`` fills each polygon into a copy of the image
(``utils/image.fill_poly``, ``cv2.fillPoly`` bit for bit) and blends it over
the image as ``cv2.addWeighted`` does on uint8: ``a * alpha + (b * beta +
gamma)`` as two fused multiply-adds in float32, rounded to the nearest
integer (ties to even) and saturated.
Colours are the reference's palette, applied to the channels in the order
the image holds them (the reference draws on OpenCV's BGR images).
``draw_rectangle`` and ``visualize_keypoints`` draw, in place, the pixels
``cv2.rectangle`` (one pixel wide) and ``cv2.circle`` (radius 1, filled)
draw, clipped at the image's borders.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from instance_segmentation_torch.utils.image import fill_poly, line_pixels

_PALETTE = np.array([
    (220, 20, 60), (255, 0, 0), (0, 0, 142), (0, 0, 70),
    (0, 60, 100), (0, 80, 100), (0, 0, 230), (119, 11, 32),
    (250, 170, 30), (220, 220, 0), (107, 142, 35), (152, 251, 152),
], np.uint8)


def add_weighted(a: np.ndarray, alpha: float, b: np.ndarray, beta: float,
                 gamma: float = 0.0) -> np.ndarray:
    """``cv2.addWeighted`` on uint8 images. A float32 product is exact in
    float64, so one float64 multiply-add rounded to float32 is the FMA."""
    def fma(x, w, z):
        return (x.astype(np.float64) * np.float64(np.float32(w)) + z).astype(np.float32)
    t = fma(a, alpha, fma(b, beta, np.float32(gamma)).astype(np.float64))
    return np.clip(np.rint(t), 0, 255).astype(np.uint8)


def visualize_instances(img: np.ndarray, polygons: Sequence[np.ndarray],
                        alpha: float = 0.5, colors: Optional[Sequence] = None) -> np.ndarray:
    """Filled-polygon alpha overlay per instance (ref visualize.py:20-38)."""
    overlay = img.copy()
    for i, poly in enumerate(polygons):
        color = tuple(int(c) for c in (
            colors[i] if colors is not None else _PALETTE[i % len(_PALETTE)]))
        fill_poly(overlay, np.asarray(poly, np.float32).astype(np.int32), color)
    return add_weighted(overlay, alpha, img, 1 - alpha)


def draw_rectangle(img: np.ndarray, pt1, pt2, color) -> np.ndarray:
    """``cv2.rectangle(img, pt1, pt2, color)``: the outline, one pixel wide."""
    h, w = img.shape[:2]
    (x1, y1), (x2, y2) = pt1, pt2
    xs, ys = line_pixels(w, h, [x1, x2, x2, x1], [y1, y1, y2, y2],
                         [x2, x2, x1, x1], [y1, y2, y2, y1])
    img[ys, xs] = color
    return img


def visualize_boxes(img: np.ndarray, centers, sizes, color=(0, 0, 255)) -> np.ndarray:
    """Rectangles from centers + (w, h) sizes, one pixel wide, in place
    (``cv2.rectangle``; ref visualize.py:55-67)."""
    for c, wh in zip(centers, sizes):
        x, y = float(c[0]), float(c[1])
        bw, bh = float(wh[0]), float(wh[1])
        draw_rectangle(img, (int(x - bw / 2), int(y - bh / 2)),
                       (int(x + bw / 2), int(y + bh / 2)), color)
    return img


_DOT = np.array([(0, 0), (-1, 0), (1, 0), (0, -1), (0, 1)])   # cv2.circle, radius 1


def visualize_keypoints(img: np.ndarray, kps: np.ndarray, color=(0, 255, 0)) -> np.ndarray:
    """A dot per keypoint (x, y), in place: ``cv2.circle(img, (int(x),
    int(y)), 1, color, -1)``, the point and its four neighbours (ref
    visualize.py:41-45)."""
    h, w = img.shape[:2]
    pts = np.asarray(kps, np.float64).reshape(-1, 2)
    xy = (np.trunc(pts).astype(np.int64)[:, None, :] + _DOT[None]).reshape(-1, 2)
    inside = (xy[:, 0] >= 0) & (xy[:, 0] < w) & (xy[:, 1] >= 0) & (xy[:, 1] < h)
    img[xy[inside, 1], xy[inside, 0]] = color
    return img
