"""Outer contours of a binary mask and their area, without OpenCV.

``find_external_contours(mask)`` is ``cv2.findContours(mask, RETR_EXTERNAL,
CHAIN_APPROX_SIMPLE)`` and ``contour_area`` is ``cv2.contourArea``, point for
point and bit for bit against OpenCV 5.0 (``tests/test_torch_convert_polygon.py``).
The tracing follows OpenCV's Suzuki-Abe border following:

  * the mask is binarised (non-zero -> 1) inside a one-pixel zero frame, so
    that components touching the image border are traced along it;
  * a raster scan (rows top to bottom, columns left to right) starts an
    outer border at a 0 -> 1 step, unless the last border pixel the scan
    passed on this row carries a positive mark, which means the step lies
    inside a component already traced (holes are never traced: every
    component in a hole of another is skipped);
  * a border is followed from its start pixel: the first neighbour is
    searched clockwise from the left (directions 0 right, 1 up-right, 2 up,
    ... 7 down-right, y pointing down), each next one counter-clockwise
    from the direction back to the previous pixel, until the walk returns
    to the start pixel headed for its first neighbour. A followed pixel is
    marked -2 where the search passed its right neighbour as 0, else 2 if it
    was 1; an isolated pixel is marked -2 and gives a one-point contour;
  * the simple chain keeps a pixel where the direction changes;
  * contours come out in the reverse of the order the scan found them (the
    contour tree's insertion at the head of its list).
"""

from __future__ import annotations

from typing import List

import numpy as np

# (dx, dy) of the chain directions 0..7 (counter-clockwise, y down)
_DX = (1, 1, 0, -1, -1, -1, 0, 1)
_DY = (0, -1, -1, -1, 0, 1, 1, 1)
_MARK, _RIGHT_BOUND = 2, -2


def _follow(img: np.ndarray, y0: int, x0: int) -> List[List[int]]:
    """Trace the outer border starting at (y0, x0) of the framed int8 image
    ``img``, marking it; returns the simple chain's points (x, y) in the
    framed coordinates."""
    s = s_end = 4
    while True:
        s = (s - 1) & 7
        if img[y0 + _DY[s], x0 + _DX[s]] != 0 or s == s_end:
            break
    if s == s_end:                                  # an isolated pixel
        img[y0, x0] = _RIGHT_BOUND
        return [[x0, y0]]
    y1, x1 = y0 + _DY[s], x0 + _DX[s]
    points = []
    prev_s = s ^ 4
    y3, x3 = y0, x0
    px, py = x0, y0
    while True:
        s_end = s
        while True:
            s += 1
            y4, x4 = y3 + _DY[s & 7], x3 + _DX[s & 7]
            if img[y4, x4] != 0:
                break
        s &= 7
        if 0 < s <= s_end:          # the search passed direction 0: a 0 to the right
            img[y3, x3] = _RIGHT_BOUND
        elif img[y3, x3] == 1:
            img[y3, x3] = _MARK
        if s != prev_s:
            points.append([px, py])
            prev_s = s
        px, py = px + _DX[s], py + _DY[s]
        if y4 == y0 and x4 == x0 and y3 == y1 and x3 == x1:
            break
        y3, x3 = y4, x4
        s = (s + 4) & 7
    return points


def find_external_contours(mask: np.ndarray) -> List[np.ndarray]:
    """``cv2.findContours(mask, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)[0]``
    of a 2-D mask (any dtype; non-zero is set): a list of int32 [N, 1, 2]
    (x, y) arrays. The scan covers the mask's non-zero bounding box only,
    which the frame of zeros around it leaves equivalent."""
    mask = np.asarray(mask)
    rows, cols = np.nonzero(np.any(mask != 0, axis=1))[0], np.nonzero(np.any(mask != 0, axis=0))[0]
    if rows.size == 0:
        return []
    r0, c0 = int(rows[0]), int(cols[0])
    crop = mask[r0:int(rows[-1]) + 1, c0:int(cols[-1]) + 1] != 0
    img = np.zeros((crop.shape[0] + 2, crop.shape[1] + 2), np.int8)
    img[1:-1, 1:-1] = crop
    height, width = img.shape[0] - 1, img.shape[1] - 1
    found = []
    for y in range(1, height):
        row = img[y]
        x, prev, lnbd = 1, 0, 0
        while x < width:
            step = np.flatnonzero(row[x:width] != prev)
            if step.size == 0:
                break
            x += int(step[0])
            p = int(row[x])
            if prev == 0 and p == 1 and row[lnbd] <= 0:
                found.append(_follow(img, y, x))
                p = int(row[x])                     # the start pixel's mark
            prev = p
            if p & -2:                              # a mark (2 or -2)
                lnbd = x
            x += 1
    offset = np.array([c0 - 1, r0 - 1])
    return [(np.asarray(c, np.int64) + offset).astype(np.int32)[:, None, :]
            for c in reversed(found)]


def contour_area(contour: np.ndarray) -> float:
    """``cv2.contourArea(contour)``: the absolute shoelace area of an (x, y)
    point list, summed in float64 from the last point to the first."""
    pts = np.asarray(contour, np.float64).reshape(-1, 2)
    if len(pts) == 0:
        return 0.0
    prev = np.roll(pts, 1, axis=0)
    a = 0.0
    for (x0, y0), (x1, y1) in zip(prev.tolist(), pts.tolist()):
        a += x0 * y1 - y0 * x1
    return abs(a * 0.5)
