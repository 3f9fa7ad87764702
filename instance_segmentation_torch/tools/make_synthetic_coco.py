"""A synthetic dataset in the COCO layout, without OpenCV or pycocotools.

Writes ``<root>/{train,val}/instances.json`` and the JPEG frames they name
(``utils/jpeg.write_jpeg``, quality 95, as ``cv2.imwrite`` writes them), N
seeded frames of one size per split. Each frame holds polygon instances of
categories that sit next to COCO's skipped ids (11, 13, 25, 27, ...: the
class map must skip 12, 26, ...), one ``iscrowd`` region stored as a
compressed-string RLE, and one non-crowd annotation stored only as an
uncompressed RLE (an axis-aligned rectangle, its ``bbox``), as COCO's
files hold them. Every annotation carries its mask's pixel count as
``area``; the frame draws the polygons and the rectangle over a smoothed
noise background.

    python3 -m instance_segmentation_torch.tools.make_synthetic_coco --out DIR \
        [--train 8] [--val 8] [--height 480] [--width 640] [--seed 0]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List

import numpy as np

from instance_segmentation_torch.tools.make_synthetic_cityscapes import (
    _box_blur, regular_polygon,
)
from instance_segmentation_torch.utils.image import fill_poly, poly_to_mask
from instance_segmentation_torch.utils.jpeg import write_jpeg

# category ids beside COCO's skipped ids (12, 26, 29, 30, 45, 66, 68, 69, 71, 83)
CATEGORY_IDS = (1, 11, 13, 25, 27, 28, 31, 44, 46, 65, 67, 70, 72, 82, 84, 90)


def rle_counts(mask: np.ndarray) -> List[int]:
    """COCO run lengths of a [h, w] mask: column-major, starting with 0s."""
    flat = np.asarray(mask, bool).T.reshape(-1)
    change = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    bounds = np.concatenate([[0], change, [flat.size]])
    runs = np.diff(bounds).tolist()
    return runs if not flat[0] else [0] + runs


def rle_string(counts: List[int]) -> str:
    """pycocotools' ``rleToString``: each count less the one two back (from
    the fourth on), in 5-bit groups, low first, 0x20 marking "more" and the
    last group's 0x10 the sign, each plus 48."""
    out = []
    for i, x in enumerate(counts):
        if i > 2:
            x -= counts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = x != -1 if c & 0x10 else x != 0
            if more:
                c |= 0x20
            out.append(chr(c + 48))
    return "".join(out)


def make_frame(rng, h: int, w: int, image_id: int, first_ann: int):
    """(uint8 RGB [h, w, 3], the frame's annotations)."""
    img = _box_blur(rng.normal(110, 25, size=(h, w, 3)).clip(0, 255).astype(np.uint8))
    anns: List[Dict] = []

    def add(cat, segmentation, mask, crowd, bbox):
        anns.append({"id": first_ann + len(anns), "image_id": image_id, "category_id": cat,
                     "segmentation": segmentation, "area": float(mask.sum()),
                     "bbox": bbox, "iscrowd": int(crowd)})

    for _ in range(int(rng.integers(3, 6))):
        cat = int(CATEGORY_IDS[rng.integers(0, len(CATEGORY_IDS))])
        r = float(rng.uniform(min(h, w) * 0.04, min(h, w) * 0.22))
        cy, cx = float(rng.uniform(r + 4, h - r - 4)), float(rng.uniform(r + 4, w - r - 4))
        poly = regular_polygon(rng, cy, cx, r)
        poly = np.round(np.clip(poly, 1, [w - 2, h - 2]), 1)
        pts = poly.astype(np.int32)
        fill_poly(img, pts, tuple(int(c) for c in rng.integers(30, 226, 3)))
        mask = poly_to_mask(poly, (h, w))
        x0, y0 = poly.min(0)
        x1, y1 = poly.max(0)
        add(cat, [poly.reshape(-1).tolist()], mask, False,
            [float(x0), float(y0), float(x1 - x0), float(y1 - y0)])

    # a crowd region: compressed-string RLE
    r = float(rng.uniform(min(h, w) * 0.08, min(h, w) * 0.15))
    cy, cx = float(rng.uniform(r + 4, h - r - 4)), float(rng.uniform(r + 4, w - r - 4))
    crowd = poly_to_mask(regular_polygon(rng, cy, cx, r, 10, 16), (h, w)).astype(bool)
    img[crowd] = (img[crowd] // 2 + 60).astype(np.uint8)
    ys, xs = np.nonzero(crowd)
    add(int(CATEGORY_IDS[rng.integers(0, len(CATEGORY_IDS))]),
        {"size": [h, w], "counts": rle_string(rle_counts(crowd))}, crowd, True,
        [float(xs.min()), float(ys.min()), float(np.ptp(xs) + 1), float(np.ptp(ys) + 1)])

    # a non-crowd annotation given only as an uncompressed RLE: a rectangle
    bw, bh = int(rng.integers(w // 16, w // 5)), int(rng.integers(h // 16, h // 5))
    x, y = int(rng.integers(1, w - bw - 1)), int(rng.integers(1, h - bh - 1))
    rect = np.zeros((h, w), bool)
    rect[y:y + bh, x:x + bw] = True
    img[rect] = rng.integers(30, 226, 3).astype(np.uint8)
    add(int(CATEGORY_IDS[rng.integers(0, len(CATEGORY_IDS))]),
        {"size": [h, w], "counts": rle_counts(rect)}, rect, False,
        [float(x), float(y), float(bw), float(bh)])
    return img, anns


def generate(root: str, splits=(("train", 8), ("val", 8)), h: int = 480, w: int = 640,
             seed: int = 0) -> str:
    rng = np.random.default_rng(seed)
    categories = [{"id": c, "name": f"category_{c}"} for c in CATEGORY_IDS]
    for split, count in splits:
        out_dir = os.path.join(root, split)
        os.makedirs(out_dir, exist_ok=True)
        images, annotations = [], []
        for i in range(count):
            image_id = 1000 + i
            img, anns = make_frame(rng, h, w, image_id, len(annotations) + 1)
            name = f"{image_id:012d}.jpg"
            write_jpeg(os.path.join(out_dir, name), img)
            images.append({"id": image_id, "file_name": name, "height": h, "width": w})
            annotations.extend(anns)
        with open(os.path.join(out_dir, "instances.json"), "w") as f:
            json.dump({"images": images, "annotations": annotations,
                       "categories": categories}, f)
    return root


def gt_detections(root: str, subset: str):
    """The ground truth of ``subset`` as the evaluation loop's cached
    detections, in the frames' own coordinates: (dets per image, infos)
    for ``evaluate_from_json(dataset="coco", orig_hw=<the frames' size>)``.
    Each non-crowd annotation is a detection of score 1: a polygon as it is,
    a rectangle RLE as its bbox's corners (which ``poly_to_mask`` fills
    back to the same pixels)."""
    from instance_segmentation_torch.data.coco import convert_cls_id_to_index
    with open(os.path.join(root, subset, "instances.json")) as f:
        blob = json.load(f)
    dets = {im["id"]: [] for im in blob["images"]}
    for ann in blob["annotations"]:
        if ann["iscrowd"]:
            continue
        segm = ann["segmentation"]
        if isinstance(segm, list):
            poly = np.asarray(segm[0], np.float32).reshape(-1, 2)
        else:
            x, y, bw, bh = ann["bbox"]
            poly = np.array([[x, y], [x + bw - 1, y], [x + bw - 1, y + bh - 1],
                             [x, y + bh - 1]], np.float32)
        dets[ann["image_id"]].append([convert_cls_id_to_index(ann["category_id"]), 1.0,
                                      poly.mean(0).tolist(), poly.tolist()])
    infos = [[os.path.join(root, subset, im["file_name"]), [im["height"], im["width"]]]
             for im in blob["images"]]
    return [dets[im["id"]] for im in blob["images"]], infos


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="./datasets/synthetic_coco")
    ap.add_argument("--train", type=int, default=8)
    ap.add_argument("--val", type=int, default=8)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    generate(args.out, splits=(("train", args.train), ("val", args.val)),
             h=args.height, w=args.width, seed=args.seed)
    print(f"wrote synthetic COCO to {args.out}")
