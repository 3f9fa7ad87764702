"""Host image and polygon helpers, without OpenCV.

Counterpart of ``instance_segmentation_tpu/utils/image.py``. ``poly_to_mask``
is ``cv2.fillPoly`` with the default 8-connected lines, bit for bit on int32
vertices (any number, negative and out-of-frame ones included):

  * every edge's outline is drawn by OpenCV's 8-connected line iterator,
    from its left end, after ``cv::clipLine`` (``clip_lines``) where an end
    lies outside the frame;
  * the interior is the even-odd fill of the edges that are not horizontal,
    each active on rows [y0, y1) with its x in 16.16 fixed point stepping by
    ``dx`` (truncated), filled from ceil(left) to floor(right) and clipped
    to the frame. An edge with an end outside the frame takes its x from the
    clipped segment (its active rows stay the unclipped ones), so that the
    part of a polygon left or right of the frame fills column 0 or W-1 where
    a clipped edge runs along it.

Those rules were read off OpenCV 5.0's ``fillPoly`` and hold on the seeded
polygons of ``tests/test_torch_image.py``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT


def get_affine_transform(in_size, out_size, inv: bool = False) -> np.ndarray:
    """Corner-pinned affine between (h, w) frames, for (x, y) points: maps
    (0, 0), (0, h-1), (w-1, h-1) onto the same corners of the other frame
    (``cv2.getAffineTransform`` of those three pairs, in closed form; its
    LU solve gives zeros where the source corners are collinear)."""
    (h, w), (oh, ow) = (out_size, in_size) if inv else (in_size, out_size)
    if h == 1 or w == 1:
        return np.zeros((2, 3), np.float64)
    return np.array([[(ow - 1) / (w - 1), 0.0, 0.0], [0.0, (oh - 1) / (h - 1), 0.0]],
                    np.float64)


def apply_affine_transform(pts: np.ndarray, mat: np.ndarray, size_wh) -> np.ndarray:
    """Transform (x, y) points and clip into [0, size-1]."""
    pts = np.asarray(pts, np.float32).reshape(-1, 2)
    ones = np.ones((pts.shape[0], 1), np.float32)
    out = (np.asarray(mat, np.float32) @ np.hstack([pts, ones]).T).T
    out[:, 0] = out[:, 0].clip(0, size_wh[0] - 1)
    out[:, 1] = out[:, 1].clip(0, size_wh[1] - 1)
    return out


def clip_lines(w: int, h: int, x1, y1, x2, y2):
    """``cv::clipLine`` of many lines on a w x h frame: (inside, x1, y1, x2,
    y2) as int64 arrays. Ends move along their line, rows first; each offset
    is a float64 product and quotient truncated toward zero, as in C."""
    x1, y1, x2, y2 = (np.array(a, np.int64, ndmin=1) for a in (x1, y1, x2, y2))
    right, bottom = w - 1, h - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    def offset(num_a, num_b, den):
        with np.errstate(divide="ignore", invalid="ignore"):
            q = num_a.astype(np.float64) * num_b.astype(np.float64) / den.astype(np.float64)
        return np.trunc(np.where(np.isfinite(q), q, 0.0)).astype(np.int64)   # used where den != 0

    c1, c2 = code(x1, y1), code(x2, y2)
    todo = ((c1 & c2) == 0) & ((c1 | c2) != 0)
    m = todo & ((c1 & 12) != 0)
    a = np.where(c1 < 8, 0, bottom)
    x1 = np.where(m, x1 + offset(a - y1, x2 - x1, y2 - y1), x1)
    y1 = np.where(m, a, y1)
    c1 = np.where(m, (x1 < 0) + (x1 > right) * 2, c1)
    m = todo & ((c2 & 12) != 0)
    a = np.where(c2 < 8, 0, bottom)
    x2 = np.where(m, x2 + offset(a - y2, x2 - x1, y2 - y1), x2)
    y2 = np.where(m, a, y2)
    c2 = np.where(m, (x2 < 0) + (x2 > right) * 2, c2)
    todo &= ((c1 & c2) == 0) & ((c1 | c2) != 0)
    m = todo & (c1 != 0)
    a = np.where(c1 == 1, 0, right)
    y1 = np.where(m, y1 + offset(a - x1, y2 - y1, x2 - x1), y1)
    x1 = np.where(m, a, x1)
    c1 = np.where(m, 0, c1)
    m = todo & (c2 != 0)
    a = np.where(c2 == 1, 0, right)
    y2 = np.where(m, y2 + offset(a - x2, y2 - y1, x2 - x1), y2)
    x2 = np.where(m, a, x2)
    c2 = np.where(m, 0, c2)
    return (c1 | c2) == 0, x1, y1, x2, y2


def _inside(w: int, h: int, x, y):
    return (x >= 0) & (x < w) & (y >= 0) & (y < h)


def line_pixels(w: int, h: int, x1, y1, x2, y2):
    """(xs, ys) of OpenCV's 8-connected lines from (x1, y1) to (x2, y2) in a
    w x h frame (``cv::LineIterator``: clipped where an end lies outside,
    drawn from the left end), for arrays of lines, all pixels concatenated."""
    x1, y1, x2, y2 = (np.array(a, np.int64, ndmin=1) for a in (x1, y1, x2, y2))
    ok, cx1, cy1, cx2, cy2 = clip_lines(w, h, x1, y1, x2, y2)
    inside = _inside(w, h, x1, y1) & _inside(w, h, x2, y2)
    x1, y1, x2, y2 = (np.where(inside, a, b) for a, b in ((x1, cx1), (y1, cy1),
                                                           (x2, cx2), (y2, cy2)))
    keep = inside | ok
    x1, y1, x2, y2 = x1[keep], y1[keep], x2[keep], y2[keep]
    flip = x2 < x1
    x1, y1, x2, y2 = np.where(flip, x2, x1), np.where(flip, y2, y1), \
        np.where(flip, x1, x2), np.where(flip, y1, y2)
    dx, dy = x2 - x1, y2 - y1
    sy = np.where(dy < 0, -1, 1)
    dy = np.abs(dy)
    major, minor = np.maximum(dx, dy), np.minimum(dx, dy)
    count = major + 1
    line = np.repeat(np.arange(len(count)), count)
    k = np.arange(int(count.sum())) - np.repeat(np.cumsum(count) - count, count)
    # the iterator steps along the minor axis where its error term, starting
    # at major - 2 minor and falling 2 minor a step, is negative: after k
    # steps it has taken ceil((2 minor k - major) / (2 major)) such steps
    mj, mn = major[line], minor[line]
    m = np.where(mj > 0, -((mj - 2 * mn * k) // np.maximum(2 * mj, 1)), 0)
    vertical = (dy > dx)[line]
    xs = x1[line] + np.where(vertical, m, k)
    ys = y1[line] + sy[line] * np.where(vertical, k, m)
    return xs, ys


def fill_poly(img: np.ndarray, poly: np.ndarray, value) -> np.ndarray:
    """``cv2.fillPoly(img, [poly], value)`` for one int32 (x, y) polygon,
    in place; returns ``img``."""
    h, w = img.shape[:2]
    v1 = np.asarray(poly).reshape(-1, 2).astype(np.int64)
    v0 = np.roll(v1, 1, axis=0)                  # edge i runs from vertex i-1 to i
    x0, y0, x1, y1 = v0[:, 0], v0[:, 1], v1[:, 0], v1[:, 1]
    xs, ys = line_pixels(w, h, x0, y0, x1, y1)
    img[ys, xs] = value
    sloped = y0 != y1
    x0, y0, x1, y1 = x0[sloped], y0[sloped], x1[sloped], y1[sloped]
    if len(y0) < 2:
        return img
    # an edge with an end outside the frame takes its x from the clipped
    # segment, and its rows from it too unless that segment is flat
    _, tx0, ty0, tx1, ty1 = clip_lines(w, h, x0, y0, x1, y1)
    clipped = ~(_inside(w, h, x0, y0) & _inside(w, h, x1, y1))
    cx0, cx1 = np.where(clipped, tx0, x0) << XY_SHIFT, np.where(clipped, tx1, x1) << XY_SHIFT
    use_t = clipped & (ty0 != ty1)
    cy0, cy1 = np.where(use_t, ty0, y0), np.where(use_t, ty1, y1)
    num, den = cx1 - cx0, cy1 - cy0
    step = np.abs(num) // np.abs(den) * np.where((num < 0) == (den < 0), 1, -1)   # C division
    down = y0 < y1
    top, bottom = np.where(down, y0, y1), np.where(down, y1, y0)
    start = np.where(down, cx0 + (y0 - cy0) * step, cx1 + (y1 - cy1) * step)
    ys = np.arange(max(int(top.min()), 0), min(int(bottom.max()), h))
    if ys.size == 0:
        return img
    active = (ys[:, None] >= top[None]) & (ys[:, None] < bottom[None])
    never = np.iinfo(np.int64).max
    xs = np.where(active, start[None] + (ys[:, None] - top[None]) * step[None], never)
    xs = np.sort(xs, axis=1)
    left, right = xs[:, 0::2][:, :xs.shape[1] // 2], xs[:, 1::2]
    ok = right != never
    x1 = (left + (XY_ONE - 1)) >> XY_SHIFT
    x2 = right >> XY_SHIFT
    ok &= (x1 < w) & (x2 >= 0)
    x1, x2 = np.maximum(x1, 0), np.minimum(x2, w - 1)
    ok &= x1 <= x2
    row, pair = np.nonzero(ok)
    if row.size == 0:
        return img
    # spans as +1/-1 at their ends, summed along the rows, within the spans'
    # bounding box
    a, b = x1[row, pair], x2[row, pair]
    r0, c0 = int(row.min()), int(a.min())
    cover = np.zeros((int(row.max()) - r0 + 1, int(b.max()) - c0 + 2), np.int32)
    np.add.at(cover, (row - r0, a - c0), 1)
    np.add.at(cover, (row - r0, b - c0 + 1), -1)
    fill = np.cumsum(cover[:, :-1], axis=1) > 0
    y0 = int(ys[0]) + r0
    img[y0:y0 + fill.shape[0], c0:c0 + fill.shape[1]][fill] = value
    return img


def poly_to_mask(poly: np.ndarray, img_size: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """Rasterize an (x, y) polygon to an int32 0/1 mask (ref :180-185);
    float vertices are truncated to int32 first, as the reference does."""
    poly = np.asarray(poly).astype(np.int32)
    if img_size is None:
        img_size = tuple((poly.max(0) + 1)[::-1])
    return fill_poly(np.zeros(img_size, np.int32), poly, 1)


def compute_iou_for_mask(mask1: np.ndarray, mask2: np.ndarray) -> float:
    overlap = np.logical_and(mask1, mask2).sum()
    union = np.logical_or(mask1, mask2).sum()
    return float(overlap + 1) / float(union + 1)


def compute_iou_for_poly(poly1: np.ndarray, poly2: np.ndarray,
                         img_size: Optional[Tuple[int, int]] = None) -> float:
    if img_size is None:
        mx = np.maximum(np.asarray(poly1).max(0), np.asarray(poly2).max(0))
        img_size = (int(mx[1]) + 1, int(mx[0]) + 1)
    return compute_iou_for_mask(poly_to_mask(poly1, img_size),
                                poly_to_mask(poly2, img_size))


def is_cover(mask1: np.ndarray, mask2: np.ndarray) -> bool:
    inter = int((mask1 * mask2).sum())
    return int(mask1.sum()) == inter or int(mask2.sum()) == inter
