"""Label-aware host-side augmentation pipeline.

Counterpart of ``instance_segmentation_tpu/transforms/augment.py``, op for
op and draw for draw: every op takes the ``np.random.Generator`` it is
given and draws from it in the JAX op's order, so the same seed gives the
same frames and labels in both packages. The polygon bookkeeping
(``filter_bounds``, ``transform_label``, ``crop_label``) is a copy of the
JAX package's. The OpenCV calls are replaced, bit for bit, by
``utils/image.py`` (``warp_affine_linear``, ``rotation_matrix_2d``,
``rgb_to_hsv_f32``, ``hsv_to_rgb_f32``) and ``resize_linear`` below.
``CommonTransforms`` applies the ``shuffle_trans_seq`` prefix, then
``trans_seq``, and ends by turning label polygons into (row, col) int32.

``resize_linear`` is ``cv2.resize(..., interpolation=cv2.INTER_LINEAR)`` on
uint8, bit for bit:
  * same size: a copy;
  * exactly half in both axes: OpenCV's area path, ``(s + 2) >> 2`` of
    each 2x2 block's sum s (the Cityscapes case, 1024x2048 -> 512x1024);
  * otherwise its fixed-point bilinear (``_linear_taps``): weights in
    1/2048, the horizontal pass keeping the exact integer sums and the
    vertical pass rounding as OpenCV's vector code does, ``(((S0 >> 4) * b0
    >> 16) + ((S1 >> 4) * b1 >> 16) + 2) >> 2``.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from instance_segmentation_torch.utils.image import (
    hsv_to_rgb_f32, rgb_to_hsv_f32, rotation_matrix_2d, warp_affine_linear,
)

_COEF_SCALE = 2048


class TransInfo(NamedTuple):
    img_path: Optional[str]
    img_size: Tuple[int, int]      # original (h, w)


Label = Tuple[Sequence[int], List[np.ndarray]]


# ---------------------------------------------------------------------------
# polygon bookkeeping (ref filter_bounds :19-52, transform_label :55-65,
# crop_label :68-81)
# ---------------------------------------------------------------------------

def _border_flag(pt, size) -> int:
    """Which border a point is pinned to; -1 = interior. size = (w, h)."""
    if pt[0] == 0:
        return 0
    if pt[1] == 0:
        return 1
    if pt[0] == size[0] - 1:
        return 2
    if pt[1] == size[1] - 1:
        return 3
    return -1


def filter_bounds(poly: np.ndarray, size) -> Tuple[bool, np.ndarray]:
    """Collapse runs of points pinned to the same border to their endpoints;
    drop instances with no interior points (unless they touch all 4 borders)."""
    flags = [_border_flag(p, size) for p in poly]
    keep_any_interior = any(f == -1 for f in flags)
    touched = set(f for f in flags if f >= 0)
    keep = keep_any_interior or touched == {0, 1, 2, 3}

    out = []
    pending = None
    prev_flag = None
    for pt, f in zip(poly, flags):
        if prev_flag != f or f == -1:
            if pending is not None:
                out.append(pending)
            out.append(pt)
            pending = None
        else:
            pending = pt
        prev_flag = f
    if pending is not None:
        out.append(pending)
    return keep, np.asarray(out).reshape(-1, 2)


def transform_label(label: Optional[Label], mat: np.ndarray, size) -> Optional[Label]:
    if label is None:
        return None
    cls_ids, polygons = label
    new_ids, new_polys = [], []
    for cid, poly in zip(cls_ids, polygons):
        t = _affine_points(poly, mat, size)
        keep, filtered = filter_bounds(t, size)
        if keep:
            new_ids.append(cid)
            new_polys.append(filtered)
    return new_ids, new_polys


def crop_label(label: Optional[Label], lefttop, size) -> Optional[Label]:
    if label is None:
        return None
    cls_ids, polygons = label
    new_ids, new_polys = [], []
    for cid, poly in zip(cls_ids, polygons):
        p = np.asarray(poly, np.float32) - np.asarray(lefttop, np.float32)
        p[:, 0] = p[:, 0].clip(0, size[0] - 1)
        p[:, 1] = p[:, 1].clip(0, size[1] - 1)
        keep, filtered = filter_bounds(p, size)
        if keep:
            new_ids.append(cid)
            new_polys.append(filtered)
    return new_ids, new_polys


def _affine_points(pts: np.ndarray, mat: np.ndarray, size) -> np.ndarray:
    """Apply a 2x3 affine to (x, y) points and clip into [0, size-1]."""
    pts = np.asarray(pts, np.float32).reshape(-1, 2)
    ones = np.ones((pts.shape[0], 1), np.float32)
    out = (mat.astype(np.float32) @ np.hstack([pts, ones]).T).T
    out[:, 0] = out[:, 0].clip(0, size[0] - 1)
    out[:, 1] = out[:, 1].clip(0, size[1] - 1)
    return out[:, :2]


def _scale_affine(in_size_hw, out_size_wh) -> np.ndarray:
    """Corner-to-corner affine (ref utils/image.py:48-63): maps
    (0,0)->(0,0), (w-1,h-1)->(w'-1,h'-1) in (x, y) coords."""
    h, w = in_size_hw
    ow, oh = out_size_wh
    sx = (ow - 1) / max(w - 1, 1)
    sy = (oh - 1) / max(h - 1, 1)
    return np.array([[sx, 0, 0], [0, sy, 0]], np.float64)


def _linear_taps(src: int, dst: int, zero_at_edges: bool):
    """(first source index, second, weight of the first, of the second) of
    each output index, as OpenCV's INTER_LINEAR tables them: the source
    position ``(i + 0.5) * src / dst - 0.5`` in float32, its floor and
    fraction, the fraction as weights rounded to 1/2048. Indices are clamped
    into the source; columns past an edge also get the fraction 0
    (``zero_at_edges``), rows keep theirs (both taps then read the edge
    row)."""
    f = ((np.arange(dst) + 0.5) * (src / dst) - 0.5).astype(np.float32)
    i0 = np.floor(f).astype(np.int64)
    f = f - i0.astype(np.float32)
    if zero_at_edges:
        f[(i0 < 0) | (i0 >= src - 1)] = 0.0
    w1 = np.rint(f * np.float32(_COEF_SCALE)).astype(np.int64)
    w0 = np.rint((np.float32(1.0) - f) * np.float32(_COEF_SCALE)).astype(np.int64)
    return np.clip(i0, 0, src - 1), np.clip(i0 + 1, 0, src - 1), w0, w1


def resize_linear(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """``cv2.resize(img, (width, height), interpolation=cv2.INTER_LINEAR)``
    on a uint8 [H, W] or [H, W, C] image (see the module's docstring)."""
    if img.dtype != np.uint8:
        raise ValueError(f"resize_linear takes uint8, got {img.dtype}")
    h, w = img.shape[:2]
    if (width, height) == (w, h):
        return img.copy()
    if (w, h) == (2 * width, 2 * height):
        s = (img[0::2, 0::2].astype(np.int32) + img[1::2, 0::2] + img[0::2, 1::2]
             + img[1::2, 1::2])
        return ((s + 2) >> 2).astype(np.uint8)
    x0, x1, a0, a1 = _linear_taps(w, width, zero_at_edges=True)
    y0, y1, b0, b1 = _linear_taps(h, height, zero_at_edges=False)
    px = img.astype(np.int64).reshape(h, w, -1)
    rows = px[:, x0] * a0[None, :, None] + px[:, x1] * a1[None, :, None]
    b0, b1 = b0[:, None, None], b1[:, None, None]
    out = ((((rows[y0] >> 4) * b0) >> 16) + (((rows[y1] >> 4) * b1) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8).reshape(height, width, *img.shape[2:])


class Resize:
    """Deterministic downscale by 1/target_size (ref Resize :456-480:
    target_size=2 means half resolution)."""

    def __init__(self, target_size):
        self.target_size = target_size

    def __call__(self, rng, img, label=None):
        h, w = img.shape[:2]
        scale = 1.0 / self.target_size
        nh, nw = int(h * scale), int(w * scale)
        img = resize_linear(img, nw, nh)
        if label is not None:
            cls_ids, polys = label
            label = (cls_ids, [np.asarray(p, np.float32) * scale for p in polys])
        return img, label


class RandomHFlip:
    # swap_pair is accepted and discarded exactly like the reference, whose
    # RandomHFlip stores it but never reads it (ref :130-148)
    def __init__(self, ratio=0.5, swap_pair=None):
        self.ratio = ratio

    def __call__(self, rng, img, label=None):
        if rng.random() > self.ratio:
            return img, label
        w = img.shape[1]
        img = img[:, ::-1].copy()
        if label is not None:
            cls_ids, polys = label
            out = []
            for p in polys:
                p = np.asarray(p, np.float32).copy()
                p[:, 0] = w - p[:, 0] - 1
                out.append(p)
            label = (cls_ids, out)
        return img, label


class RandomBrightness:
    def __init__(self, ratio=0.5, shift_value=30):
        self.ratio = ratio
        self.shift = shift_value

    def __call__(self, rng, img, label=None):
        if rng.random() > self.ratio:
            return img, label
        shift = int(rng.integers(-self.shift, self.shift + 1))
        img = np.clip(np.rint(img.astype(np.float32) + shift), 0, 255).astype(np.uint8)
        return img, label


class RandomContrast:
    def __init__(self, ratio=0.5, lower=0.5, upper=1.5):
        self.ratio, self.lower, self.upper = ratio, lower, upper

    def __call__(self, rng, img, label=None):
        if rng.random() > self.ratio:
            return img, label
        f = rng.uniform(self.lower, self.upper)
        img = np.clip(img.astype(np.float32) * f, 0, 255).astype(np.uint8)
        return img, label


class RandomSaturation:
    def __init__(self, ratio=0.5, lower=0.5, upper=1.5):
        self.ratio, self.lower, self.upper = ratio, lower, upper

    def __call__(self, rng, img, label=None):
        if rng.random() > self.ratio:
            return img, label
        f = rng.uniform(self.lower, self.upper)
        hsv = rgb_to_hsv_f32(img.astype(np.float32))
        hsv[:, :, 1] *= f
        img = np.clip(hsv_to_rgb_f32(hsv), 0, 255).astype(np.uint8)
        return img, label


class RandomHue:
    def __init__(self, ratio=0.5, delta=18):
        self.ratio, self.delta = ratio, delta

    def __call__(self, rng, img, label=None):
        if rng.random() > self.ratio:
            return img, label
        d = rng.uniform(-self.delta, self.delta)
        hsv = rgb_to_hsv_f32(img.astype(np.float32))
        hsv[:, :, 0] = np.mod(hsv[:, :, 0] + d, 360.0)
        img = np.clip(hsv_to_rgb_f32(hsv), 0, 255).astype(np.uint8)
        return img, label


class RandomPerm:
    _perms = ((0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0))

    def __init__(self, ratio=0.5):
        self.ratio = ratio

    def __call__(self, rng, img, label=None):
        if rng.random() > self.ratio:
            return img, label
        p = self._perms[int(rng.integers(0, len(self._perms)))]
        return img[:, :, p].astype(np.uint8), label


class Padding:
    # the (104,117,123) fill is the reference's BGR-ordered constant applied
    # to RGB images, a reference quirk reproduced for parity (the reference
    # also converts to RGB before augmenting, image.py:97-103)
    def __init__(self, ratio=0.5, pad=(0, 0, 0, 0), mean=(104, 117, 123),
                 allow_outside_center=True):
        self.ratio, self.pad, self.mean = ratio, pad, mean

    def __call__(self, rng, img, label=None):
        if rng.random() > self.ratio:
            return img, label
        h, w, c = img.shape
        left, up, right, down = self.pad
        out = np.empty((h + up + down, w + left + right, c), img.dtype)
        out[...] = np.asarray(self.mean, img.dtype)
        out[up:up + h, left:left + w] = img
        if label is not None:
            cls_ids, polys = label
            shifted = []
            for p in polys:
                p = np.asarray(p, np.float32).copy()
                p[:, 0] += left
                p[:, 1] += up
                shifted.append(p)
            label = (cls_ids, shifted)
        return out, label


class RandomResize:
    def __init__(self, ratio=0.5, scale_range=(0.75, 1.25), aspect_range=(0.9, 1.1),
                 target_size=None, resize_bound=None, method="random",
                 max_side_bound=None, scale_list=None):
        self.ratio = ratio
        self.scale_range = scale_range
        self.aspect_range = aspect_range
        self.resize_bound = resize_bound
        self.method = method
        self.max_side_bound = max_side_bound
        self.scale_list = scale_list
        # target_size branch (ref cv2_aug_transforms.py:262-280): the random
        # scale ratios apply to this fixed (w, h) base instead of the image
        # size (the reference stores it but never reads it; here it is live,
        # as in the JAX package)
        if target_size is None:
            self.input_size = None
        elif isinstance(target_size, int):
            self.input_size = (target_size, target_size)
        elif isinstance(target_size, (list, tuple)) and len(target_size) == 2:
            self.input_size = tuple(target_size)
        else:
            raise TypeError(f"inappropriate target_size: {target_size!r}")

    def _scale(self, rng, img_size_wh):
        if self.method == "bound":
            return min(self.resize_bound[0] / min(img_size_wh),
                       self.resize_bound[1] / max(img_size_wh))
        return rng.uniform(*self.scale_range)

    def __call__(self, rng, img, label=None):
        h, w = img.shape[:2]
        if rng.random() < self.ratio:
            if self.scale_list is None:
                s = self._scale(rng, (w, h))
            else:
                s = self.scale_list[int(rng.integers(0, len(self.scale_list)))]
            a = rng.uniform(*self.aspect_range)
            ws, hs = math.sqrt(a) * s, math.sqrt(1.0 / a) * s
            if self.max_side_bound is not None and max(h * hs, w * ws) > self.max_side_bound:
                d = self.max_side_bound / max(h * hs, w * ws)
                ws, hs = ws * d, hs * d
        else:
            ws = hs = 1.0
        bw, bh = (w, h) if self.input_size is None else self.input_size
        nw, nh = int(bw * ws), int(bh * hs)
        mat = _scale_affine((h, w), (nw, nh))
        img = warp_affine_linear(img, mat, (nw, nh))
        label = transform_label(label, mat, (nw, nh))
        return img, label


class RandomRotate:
    def __init__(self, ratio=0.5, max_degree=10, mean=(104, 117, 123)):
        self.ratio, self.max_degree, self.mean = ratio, max_degree, mean

    def __call__(self, rng, img, label=None):
        if rng.random() >= self.ratio:
            return img, label
        deg = rng.uniform(-self.max_degree, self.max_degree)
        h, w = img.shape[:2]
        center = (w / 2.0, h / 2.0)
        mat = rotation_matrix_2d(center, deg, 1.0)
        cos_v, sin_v = abs(mat[0, 0]), abs(mat[0, 1])
        nw = int(h * sin_v + w * cos_v)
        nh = int(h * cos_v + w * sin_v)
        mat[0, 2] += nw / 2.0 - center[0]
        mat[1, 2] += nh / 2.0 - center[1]
        img = warp_affine_linear(img, mat, (nw, nh), border_value=self.mean)
        label = transform_label(label, mat, (nw, nh))
        return img, label


class RandomCrop:
    def __init__(self, ratio=0.5, crop_size=(512, 512), method="random", grid=None,
                 allow_outside_center=True):
        self.ratio, self.size, self.method, self.grid = ratio, tuple(crop_size), method, grid

    def _lefttop(self, rng, crop_wh, img_wh):
        if self.method == "center":
            return [(img_wh[0] - crop_wh[0]) // 2, (img_wh[1] - crop_wh[1]) // 2]
        if self.method == "grid":
            gx = int(rng.integers(0, self.grid[0]))
            gy = int(rng.integers(0, self.grid[1]))
            return [gx * ((img_wh[0] - crop_wh[0]) // (self.grid[0] - 1)),
                    gy * ((img_wh[1] - crop_wh[1]) // (self.grid[1] - 1))]
        return [int(rng.integers(0, img_wh[0] - crop_wh[0] + 1)),
                int(rng.integers(0, img_wh[1] - crop_wh[1] + 1))]

    def __call__(self, rng, img, label=None):
        if rng.random() > self.ratio:
            return img, label
        h, w = img.shape[:2]
        tw, th = min(self.size[0], w), min(self.size[1], h)
        left, up = self._lefttop(rng, (tw, th), (w, h))
        img = img[up:up + th, left:left + tw]
        label = crop_label(label, (left, up), (tw, th))
        return img, label


_OP_BUILDERS = {
    "resize": lambda c: Resize(target_size=c["target_size"]),
    "random_hflip": lambda c: RandomHFlip(ratio=c.get("ratio", 0.5),
                                          swap_pair=c.get("swap_pair")),
    "random_brightness": lambda c: RandomBrightness(ratio=c.get("ratio", 0.5),
                                                    shift_value=c.get("shift_value", 30)),
    "random_contrast": lambda c: RandomContrast(ratio=c.get("ratio", 0.5),
                                                lower=c.get("lower", 0.5),
                                                upper=c.get("upper", 1.5)),
    "random_saturation": lambda c: RandomSaturation(ratio=c.get("ratio", 0.5),
                                                    lower=c.get("lower", 0.5),
                                                    upper=c.get("upper", 1.5)),
    "random_hue": lambda c: RandomHue(ratio=c.get("ratio", 0.5), delta=c.get("delta", 18)),
    "random_perm": lambda c: RandomPerm(ratio=c.get("ratio", 0.5)),
    "padding": lambda c: Padding(ratio=c.get("ratio", 0.5), pad=c.get("pad", (0, 0, 0, 0)),
                                 mean=c.get("mean", (104, 117, 123))),
    "random_resize": lambda c: RandomResize(
        ratio=c.get("ratio", 0.5), scale_range=c.get("scale_range", (0.75, 1.25)),
        aspect_range=c.get("aspect_range", (0.9, 1.1)), method=c.get("method", "random"),
        resize_bound=c.get("resize_bound"), max_side_bound=c.get("max_side_bound"),
        scale_list=c.get("scale_list"), target_size=c.get("target_size")),
    "random_rotate": lambda c: RandomRotate(ratio=c.get("ratio", 0.5),
                                            max_degree=c.get("rotate_degree", 10),
                                            mean=c.get("mean", (104, 117, 123))),
    "random_crop": lambda c: RandomCrop(ratio=c.get("ratio", 0.5),
                                        crop_size=c.get("crop_size", (512, 512)),
                                        method=c.get("method", "random"),
                                        grid=c.get("grid")),
}


def _build_op(trans_cfg, section: str, name: str):
    params = trans_cfg.get(section, name, default={}) or {}
    if name not in _OP_BUILDERS:
        raise KeyError(f"unknown transform op: {name}")
    return _OP_BUILDERS[name](dict(params))


def build_augmentations(trans_cfg, split: str) -> List:
    """Build the op sequence from the JSON config (ref CV2AugCompose :483-819)."""
    section = "train_trans" if split == "train" else "val_trans"
    seq = trans_cfg.get(section, "trans_seq", default=[]) or []
    return [_build_op(trans_cfg, section, name) for name in seq]


def build_shuffle_augmentations(trans_cfg, split: str):
    """Ops for the ``shuffle_trans_seq`` key (ref CV2AugCompose :800-813):
    names applied in per-sample shuffled order BEFORE trans_seq. The config
    value is either a list of op names (order shuffled each call) or a list
    of name-lists (one list picked at random each call).

    Returns (ops_by_name, groups, nested): nested=True -> pick one group at
    random and apply it in its listed order; nested=False -> groups has one
    entry whose order is shuffled per call.
    """
    if split != "train":
        return {}, [], False
    raw = trans_cfg.get("train_trans", "shuffle_trans_seq", default=None)
    if not raw:
        return {}, [], False
    nested = isinstance(raw[0], (list, tuple))
    groups = [list(g) for g in raw] if nested else [list(raw)]
    names = {n for g in groups for n in g}
    ops = {n: _build_op(trans_cfg, "train_trans", n) for n in names}
    return ops, groups, nested


class CommonTransforms:
    """Aug pipeline facade (ref utils/tranform.py:126-178).

    __call__(img RGB uint8 HWC, label=(cls_ids, polygons (x,y))) ->
        (img uint8, label (cls_ids, polygons (row,col) int32), TransInfo)

    Normalization happens in the model on the device.
    """

    def __init__(self, trans_cfg, split: str = "train", seed: Optional[int] = None):
        self.configer = trans_cfg
        self.split = split
        self.ops = build_augmentations(trans_cfg, split)
        self._shuffle_ops, self._shuffle_groups, self._shuffle_nested = \
            build_shuffle_augmentations(trans_cfg, split)
        self._rng = np.random.default_rng(seed)

    def _shuffled_prefix(self, rng) -> List:
        """Per-sample shuffled ops applied before trans_seq
        (ref CV2AugCompose :800-813)."""
        if not self._shuffle_groups:
            return []
        if self._shuffle_nested:
            names = self._shuffle_groups[int(rng.integers(0, len(self._shuffle_groups)))]
        else:
            names = list(self._shuffle_groups[0])
            rng.shuffle(names)
        return [self._shuffle_ops[n] for n in names]

    def __call__(self, img: np.ndarray, label: Optional[Label] = None,
                 img_path: Optional[str] = None, rng: Optional[np.random.Generator] = None):
        rng = rng or self._rng
        img_size = img.shape[:2]
        for op in self._shuffled_prefix(rng) + self.ops:
            img, label = op(rng, img, label)
        if label is not None:
            cls_ids, polys = label
            # CoordinateReverser: (x, y) -> (row, col) int32 (ref tranform.py:92-96)
            polys = [np.asarray(p)[:, ::-1].astype(np.int32) for p in polys]
            label = (cls_ids, polys)
        return img, label, TransInfo(img_path, img_size)

    def detransform_pixel(self, pixels: np.ndarray, info: TransInfo) -> np.ndarray:
        """(row, col) model-space -> (x, y) original resolution
        (ref tranform.py:157-171)."""
        pixels = np.asarray(pixels, np.float32).reshape(-1, 2)
        xy = pixels[:, ::-1].copy()
        seq = self.configer.get("val_trans", "trans_seq", default=[]) or []
        if "resize" in seq:
            scale = self.configer.get("val_trans", "resize")["target_size"]
            h, w = info.img_size
            # round() here vs int() truncation in Resize is a reference quirk
            # reproduced verbatim (ref tranform.py:167 rounds, ref Resize :472
            # truncates); they differ only for odd dimensions
            tw, th = int(round(w / scale)), int(round(h / scale))
            mat = _scale_affine((th, tw), (w, h))
            xy = _affine_points(xy, mat, (w, h))
        return xy
