"""Host-side transform pipeline, the part the eval and test paths use.

Counterpart of ``instance_segmentation_tpu/transforms/augment.py``:
``TransInfo``, ``Resize``, ``_scale_affine``, ``_affine_points``,
``build_augmentations``, ``CommonTransforms`` (which ends by turning label
polygons into (row, col) int32) and its ``detransform_pixel``. The train
augmentations (flip, brightness, contrast, saturation, hue, channel
permutation, padding, random resize, rotation, crop) and
``shuffle_trans_seq`` are not ported yet: naming one raises
``NotImplementedError`` (ROADMAP Queue 1 item 12).

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

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

_COEF_SCALE = 2048


class TransInfo(NamedTuple):
    img_path: Optional[str]
    img_size: Tuple[int, int]      # original (h, w)


Label = Tuple[Sequence[int], List[np.ndarray]]


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


# the JAX package's op names (its _OP_BUILDERS); only "resize" is ported
_TRAIN_OPS = ("random_hflip", "random_brightness", "random_contrast", "random_saturation",
              "random_hue", "random_perm", "padding", "random_resize", "random_rotate",
              "random_crop")


def _build_op(trans_cfg, section: str, name: str):
    params = trans_cfg.get(section, name, default={}) or {}
    if name == "resize":
        return Resize(target_size=dict(params)["target_size"])
    if name in _TRAIN_OPS:
        raise NotImplementedError(f"transform op {name!r} is a train augmentation, not "
                                  "ported yet (ROADMAP Queue 1 item 12)")
    raise KeyError(f"unknown transform op: {name}")


def build_augmentations(trans_cfg, split: str) -> List:
    """Build the op sequence from the JSON config (ref CV2AugCompose :483-819)."""
    section = "train_trans" if split == "train" else "val_trans"
    seq = trans_cfg.get(section, "trans_seq", default=[]) or []
    if split == "train" and trans_cfg.get("train_trans", "shuffle_trans_seq", default=None):
        raise NotImplementedError("shuffle_trans_seq is a train augmentation, not ported yet "
                                  "(ROADMAP Queue 1 item 12)")
    return [_build_op(trans_cfg, section, name) for name in seq]


class CommonTransforms:
    """Transform pipeline facade (ref utils/tranform.py:126-178).

    __call__(img RGB uint8 HWC, label=(cls_ids, polygons (x,y))) ->
        (img uint8, label (cls_ids, polygons (row,col) int32), TransInfo)

    Normalization happens in the model on the device.
    """

    def __init__(self, trans_cfg, split: str = "train", seed: Optional[int] = None):
        self.configer = trans_cfg
        self.split = split
        self.ops = build_augmentations(trans_cfg, split)
        self._rng = np.random.default_rng(seed)

    def __call__(self, img: np.ndarray, label: Optional[Label] = None,
                 img_path: Optional[str] = None, rng: Optional[np.random.Generator] = None):
        rng = rng or self._rng
        img_size = img.shape[:2]
        for op in self.ops:
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
