"""A synthetic dataset in the Cityscapes directory layout, without OpenCV.

Counterpart of the JAX package's ``tools/make_synthetic_cityscapes.py``:
leftImg8bit/{split}/synth/*_leftImg8bit.png frames holding filled polygons
(class-coloured blobs) on a noisy background, and matching
gtFine/{split}/synth/*_gtFine_polygons.json labels. It draws the same random
numbers in the same order, so for one seed its labels and polygons equal
that tool's. Its pixels do not: the background is smoothed by a 7x7 box
filter where that tool uses ``cv2.GaussianBlur``, and the outline is two
pixels of this package's 8-connected line where it uses ``cv2.polylines``.
The frames are written as libpng writes by default (each row's filter
picked by its heuristic, zlib level 6), so reading them runs every row
filter as reading camera frames does.

    python3 -m instance_segmentation_torch.tools.make_synthetic_cityscapes --out DIR
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from instance_segmentation_torch.utils.image import fill_poly, line_pixels
from instance_segmentation_torch.utils.png import write_png

CLASSES = ["person", "rider", "car", "truck", "bus", "train", "motorcycle", "bicycle"]

# class-correlated appearance: each class has a distinct base colour
_CLASS_COLORS = np.array([
    (220, 40, 60), (40, 220, 60), (40, 60, 220), (220, 220, 40),
    (220, 40, 220), (40, 220, 220), (240, 140, 40), (140, 40, 240),
], np.float64)


def regular_polygon(rng, cy, cx, r_base, n_min=6, n_max=12):
    n = int(rng.integers(n_min, n_max + 1))
    angles = np.sort(rng.uniform(0, 2 * np.pi, n))
    radii = r_base * rng.uniform(0.6, 1.0, n)
    xs = cx + radii * np.cos(angles)
    ys = cy + radii * np.sin(angles)
    return np.stack([xs, ys], axis=1)     # (x, y)


def _box_blur(img: np.ndarray, k: int = 7) -> np.ndarray:
    """Mean over a k x k window (edges replicated), per channel."""
    pad = k // 2
    x = np.pad(img.astype(np.float64), ((pad, pad), (pad, pad), (0, 0)), mode="edge")
    for axis in (0, 1):
        c = np.cumsum(x, axis=axis)
        c = np.concatenate([np.zeros_like(np.take(c, [0], axis=axis)), c], axis=axis)
        n = x.shape[axis] - k + 1
        x = (np.take(c, np.arange(k, k + n), axis=axis)
             - np.take(c, np.arange(n), axis=axis)) / k
    return np.clip(np.rint(x), 0, 255).astype(np.uint8)


def make_image(rng, h, w, n_instances):
    img = _box_blur(rng.normal(110, 25, size=(h, w, 3)).clip(0, 255).astype(np.uint8))
    objects = []
    for _ in range(n_instances):
        cls_id = int(rng.integers(0, len(CLASSES)))
        r = float(rng.uniform(min(h, w) * 0.06, min(h, w) * 0.2))
        cy = float(rng.uniform(r + 8, h - r - 8))
        cx = float(rng.uniform(r + 8, w - r - 8))
        poly = regular_polygon(rng, cy, cx, r)
        poly[:, 0] = poly[:, 0].clip(2, w - 3)
        poly[:, 1] = poly[:, 1].clip(2, h - 3)
        color = tuple(int(c) for c in np.clip(
            _CLASS_COLORS[cls_id] + rng.normal(0, 12, 3), 0, 255))
        pts = poly.astype(np.int32)
        fill_poly(img, pts, color)
        edge = tuple(min(255, c + 40) for c in color)
        prev = np.roll(pts, 1, axis=0)
        for dx, dy in ((0, 0), (1, 0), (0, 1)):
            xs, ys = line_pixels(w, h, prev[:, 0] + dx, prev[:, 1] + dy, pts[:, 0] + dx,
                                 pts[:, 1] + dy)
            img[ys, xs] = edge
        objects.append({"label": CLASSES[cls_id], "polygon": poly.astype(int).tolist()})
    return img, objects


def generate(root, splits=(("train", 6), ("val", 3)), h=1024, w=2048, seed=0,
             instances=(3, 8)):
    rng = np.random.default_rng(seed)
    for split, count in splits:
        img_dir = os.path.join(root, "leftImg8bit", split, "synth")
        gt_dir = os.path.join(root, "gtFine", split, "synth")
        os.makedirs(img_dir, exist_ok=True)
        os.makedirs(gt_dir, exist_ok=True)
        for i in range(count):
            n_inst = int(rng.integers(instances[0], instances[1] + 1))
            img, objects = make_image(rng, h, w, n_inst)
            base = f"synth_{i:06d}_000019"
            write_png(os.path.join(img_dir, base + "_leftImg8bit.png"), img)
            with open(os.path.join(gt_dir, base + "_gtFine_polygons.json"), "w") as f:
                json.dump({"imgHeight": h, "imgWidth": w, "objects": objects}, f)
    return root


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="./datasets/synthetic_cityscapes")
    ap.add_argument("--train", type=int, default=6)
    ap.add_argument("--val", type=int, default=3)
    ap.add_argument("--height", type=int, default=1024)
    ap.add_argument("--width", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    generate(args.out, splits=(("train", args.train), ("val", args.val)),
             h=args.height, w=args.width, seed=args.seed)
    print(f"wrote synthetic cityscapes to {args.out}")
