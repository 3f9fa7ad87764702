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

The train augmentations' OpenCV calls, bit for bit against OpenCV 5.0 on
x86-64 with AVX2 (``tests/test_torch_augment.py``):

  * ``rotation_matrix_2d`` is ``cv2.getRotationMatrix2D``;
  * ``warp_affine_linear`` is ``cv2.warpAffine`` with ``INTER_LINEAR`` and
    a constant border on uint8 images (``csrc/warp_affine.c`` says in what
    order OpenCV rounds; ``warp_affine_linear_numpy`` is its twin);
  * ``rgb_to_hsv_f32`` and ``hsv_to_rgb_f32`` are ``cv2.cvtColor`` with
    ``COLOR_RGB2HSV`` and ``COLOR_HSV2RGB`` on float32 images (hue in
    degrees), OpenCV's vector formulas with its fused multiply-adds, and its
    scalar ones on the last ``width % HSV_LANES`` pixels of each row.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

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


WARP_LANES = 16          # output columns per vector step of OpenCV's warpAffine (AVX2)
HSV_LANES = 8            # pixels per vector step of OpenCV's float HSV conversions (AVX2)
_FLT_EPSILON = np.float32(np.finfo(np.float32).eps)


def rotation_matrix_2d(center, angle: float, scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D(center, angle, scale)``: float64 [2, 3];
    ``angle`` in degrees, counter-clockwise; the center is taken as float32
    (OpenCV's ``Point2f``)."""
    cx, cy = (float(np.float32(v)) for v in center)
    angle = angle * (np.pi / 180)
    alpha, beta = np.cos(angle) * scale, np.sin(angle) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]], np.float64)


def invert_affine(mat: np.ndarray) -> np.ndarray:
    """``cv2.invertAffineTransform`` of a 2x3 matrix, in float64 (a singular
    matrix gives zeros, as there)."""
    m = np.asarray(mat, np.float64).reshape(2, 3)
    d = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22, a12, a21 = m[1, 1] * d, m[0, 0] * d, -m[0, 1] * d, -m[1, 0] * d
    b1 = -a11 * m[0, 2] - a12 * m[1, 2]
    b2 = -a21 * m[0, 2] - a22 * m[1, 2]
    return np.array([[a11, a12, b1], [a21, a22, b2]], np.float64)


def _fma32(a, b, c) -> np.ndarray:
    """float32 a * b + c rounded once (the float64 product, exact, and sum)."""
    return (np.multiply(a, b, dtype=np.float64) + c).astype(np.float32)


def _warp_setup(img: np.ndarray, mat, dsize, border_value):
    """(uint8 [h, w, c] source, float32 inverse map [6], uint8 border [c],
    (ow, oh)) of a warp, with ``cv2.warpAffine``'s argument rules: ``dsize``
    is (width, height); a number as ``border_value`` is (v, 0, 0, 0), a
    sequence is padded with zeros, each value rounded and saturated."""
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError(f"warp_affine_linear takes a uint8 [H, W] or [H, W, C] image, "
                         f"got {img.dtype} {img.shape}")
    ow, oh = (int(v) for v in dsize)
    if ow <= 0 or oh <= 0:
        raise ValueError(f"warp_affine_linear: empty output size {dsize}")
    src = np.ascontiguousarray(img).reshape(img.shape[0], img.shape[1], -1)
    c = src.shape[2]
    if c > 4:
        raise ValueError(f"warp_affine_linear takes at most 4 channels, got {c}")
    values = [float(v) for v in np.atleast_1d(border_value)][:4]
    border = np.clip(np.rint(np.array(values + [0.0] * (4 - len(values)))), 0, 255)
    m = invert_affine(mat).astype(np.float32).reshape(-1)
    return src, m, border.astype(np.uint8)[:c], (ow, oh)


def warp_affine_linear_numpy(img: np.ndarray, mat, dsize, border_value=0) -> np.ndarray:
    """The plain form of ``warp_affine_linear`` (``csrc/warp_affine.c`` gives
    the order of operations)."""
    src, m, border, (ow, oh) = _warp_setup(img, mat, dsize, border_value)
    h, w, c = src.shape
    x = np.arange(ow, dtype=np.float32)
    y = np.arange(oh, dtype=np.float32)[:, None]
    t0 = ow // WARP_LANES * WARP_LANES
    coords = []
    for a, b, off in ((m[0], m[1], m[2]), (m[3], m[4], m[5])):
        s = np.empty((oh, ow), np.float32)
        s[:, :t0] = _fma32(a, x[:t0], y * b + off)
        s[:, t0:] = _fma32(x[t0:], a, y * b) + off
        coords.append(s)
    sx, sy = coords
    fx, fy = np.floor(sx), np.floor(sy)
    ax, ay = (sx - fx)[..., None], (sy - fy)[..., None]
    ix, iy = fx.astype(np.int64), fy.astype(np.int64)
    # the taps from the source framed by one pixel of the border value: a
    # tap outside the frame is clamped onto that frame
    framed = np.empty((h + 2, w + 2, c), np.uint8)
    framed[...] = border
    framed[1:-1, 1:-1] = src
    flat = framed.reshape(-1, c)
    x0, x1 = np.clip(ix, -1, w) + 1, np.clip(ix + 1, -1, w) + 1
    y0, y1 = (np.clip(iy, -1, h) + 1) * (w + 2), (np.clip(iy + 1, -1, h) + 1) * (w + 2)
    p00, p01, p10, p11 = (flat[r + q].astype(np.float32)
                          for r, q in ((y0, x0), (y0, x1), (y1, x0), (y1, x1)))
    f0 = _fma32(ax, p01 - p00, p00)
    f1 = _fma32(ax, p11 - p10, p10)
    out = np.clip(np.rint(_fma32(ay, f1 - f0, f0)), 0, 255).astype(np.uint8)
    return out.reshape((oh, ow) + img.shape[2:])


@functools.cache
def _native_warp():
    from instance_segmentation_torch.kernels import build
    fn = build.load("warp_affine").iseg_warp_affine_linear
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn


def warp_affine_linear(img: np.ndarray, mat, dsize, border_value=0) -> np.ndarray:
    """``cv2.warpAffine(img, mat, dsize, flags=cv2.INTER_LINEAR,
    borderMode=cv2.BORDER_CONSTANT, borderValue=border_value)`` on a uint8
    [H, W] or [H, W, C] image (C <= 4), by the host C function of
    ``csrc/warp_affine.c`` (built on first use)."""
    src, m, border, (ow, oh) = _warp_setup(img, mat, dsize, border_value)
    h, w, c = src.shape
    out = np.empty((oh, ow, c), np.uint8)
    if _native_warp()(src.ctypes.data, h, w, c, m.ctypes.data, border.ctypes.data,
                      out.ctypes.data, oh, ow, WARP_LANES):
        raise ValueError(f"warp_affine_linear: bad shapes {img.shape} -> {dsize}")
    return out.reshape((oh, ow) + img.shape[2:])


def _rgb_to_hsv(r, g, b, vector: bool):
    v = np.maximum(np.maximum(r, g), b)
    diff = v - np.minimum(np.minimum(r, g), b)
    s = diff / (np.abs(v) + _FLT_EPSILON)
    r_max, g_max = r == v, g == v
    dh = np.where(r_max, g - b, np.where(g_max, b - r, r - g))
    base = np.where(r_max, np.float32(0), np.where(g_max, np.float32(120), np.float32(240)))
    scale = np.float32(60) / (diff + _FLT_EPSILON)
    if vector:      # the 360 of a negative hue is added inside the fused step
        h = _fma32(dh, scale, np.where(r_max & (dh < 0), np.float32(360), base))
    else:
        h = _fma32(dh, scale, base)
        h = np.where(h < 0, h + np.float32(360), h)
    return np.stack([h, s, v], -1)


def rgb_to_hsv_f32(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_RGB2HSV)`` of a float32 [H, W, 3] RGB
    image: hue in degrees [0, 360), saturation, value."""
    img = np.asarray(img, np.float32)
    t0 = img.shape[1] // HSV_LANES * HSV_LANES
    out = np.empty(img.shape, np.float32)
    for cols, vector in ((slice(0, t0), True), (slice(t0, None), False)):
        part = img[:, cols]
        out[:, cols] = _rgb_to_hsv(part[..., 0], part[..., 1], part[..., 2], vector)
    return out


# (b, g, r) of each hue sector as indices into (v, v(1-s), v(1-s f), v(1-s(1-f)))
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])
_HUE_SCALE = np.float32(6) / np.float32(360)


def _hsv_to_rgb(h, s, v, vector: bool):
    one = np.float32(1)
    h = h * _HUE_SCALE
    if vector:
        whole = np.trunc(h)
        f = h - whole
        sector = whole - np.trunc(whole * np.float32(1 / 6)) * np.float32(6)
        # OpenCV's masks give a negative sector (from a hue below -60) the
        # rows of sector 0; the sector is never above 5
        sector = np.where(sector >= 0, sector, 0).astype(np.int64)
    else:
        h = np.fmod(h, np.float32(6))
        whole = np.floor(h)
        f = h - whole
        sector = whole.astype(np.int64)
        sector = np.where(sector < 0, sector + 6, sector)       # a negative hue wraps
        outside = (sector < 0) | (sector >= 6)
        sector, f = np.where(outside, 0, sector), np.where(outside, np.float32(0), f)
    tab = np.stack([v, v * (one - s), v * _fma32(-s, f, one), v * _fma32(-s, one - f, one)], -1)
    bgr = np.take_along_axis(tab, _SECTORS[sector], -1)
    if not vector:
        bgr = np.where((s == 0)[..., None], v[..., None], bgr)
    return bgr[..., ::-1]


def hsv_to_rgb_f32(hsv: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)`` of a float32 [H, W, 3] image
    (hue in degrees); values are not clipped."""
    hsv = np.asarray(hsv, np.float32)
    t0 = hsv.shape[1] // HSV_LANES * HSV_LANES
    out = np.empty(hsv.shape, np.float32)
    for cols, vector in ((slice(0, t0), True), (slice(t0, None), False)):
        part = hsv[:, cols]
        out[:, cols] = _hsv_to_rgb(part[..., 0], part[..., 1], part[..., 2], vector)
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
