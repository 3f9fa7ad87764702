"""Offline preprocessing: pre-pack Cityscapes labels into static-shape npz.

    python -m instance_segmentation_torch.tools.preprocess_cityscapes \
        --root DATA --subset train --out DATA/packed/train [--cache_images]

Counterpart of the JAX package's ``tools/preprocess_cityscapes.py``, with the
same flags and outputs, and PNG reading (``utils/png.py``) and
``resize_linear`` in place of OpenCV: walks the gtFine tree, parses each
``*_gtFine_polygons.json``, applies the deterministic resize by
``1 / target_size``, packs the labels to the padded (polys, n_verts,
cls_ids) arrays and writes one ``.npz`` per image next to a
``manifest.json``. With ``--cache_images`` it also writes each
leftImg8bit frame, resized, as ``<key>_img.npy``, so that training skips
the PNG decode and resize. The ``cityscapes_packed`` dataset reads them.
Parallel workers (``--workers``) are forked from the data loader's fork
server (``data.registry.worker_context``).
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

import numpy as np

from instance_segmentation_torch.data.cityscapes import (
    is_label_file, load_rgb_image, parse_label_json,
)
from instance_segmentation_torch.data.packing import pack_label
from instance_segmentation_torch.data.registry import worker_context
from instance_segmentation_torch.transforms.augment import resize_linear


def process_item(args):
    gt_path, out_dir, target_size, max_instances, max_verts, cache_images = args
    with open(gt_path) as f:
        blob = json.load(f)
    cls_ids, polygons = parse_label_json(blob)
    scale = 1.0 / target_size
    # resize + CoordinateReverser: (x, y) -> scaled (row, col) int32
    polys_rc = [np.asarray(p, np.float32)[:, ::-1] * scale for p in polygons]
    polys_rc = [p.astype(np.int32) for p in polys_rc]
    polys, n_verts, cls_arr = pack_label(cls_ids, polys_rc, max_instances, max_verts)
    base = os.path.splitext(os.path.basename(gt_path))[0]
    out = os.path.join(out_dir, base + ".npz")
    np.savez_compressed(out, polys=polys, n_verts=n_verts, cls_ids=cls_arr,
                        img_h=blob.get("imgHeight", 1024), img_w=blob.get("imgWidth", 2048))
    if cache_images:
        img_path = gt_path.replace("gtFine", "leftImg8bit", 1).replace(
            "_leftImg8bit_polygons.json", "_leftImg8bit.png").replace(
            "_gtFine_polygons.json", "_leftImg8bit.png")
        if os.path.exists(img_path):
            img = load_rgb_image(img_path)
            h, w = img.shape[:2]
            img = resize_linear(img, int(w * scale), int(h * scale))
            key = base.rsplit("_gtFine_polygons", 1)[0]
            np.save(os.path.join(out_dir, key + "_img.npy"), img)
    return out


def preprocess(root: str, subset: str, out_dir: str, target_size: int = 2,
               max_instances: int = 96, max_verts: int = 256, workers: int = 1,
               cache_images: bool = False):
    labels_root = os.path.join(root, "gtFine", subset)
    gt_files = sorted(
        os.path.join(dp, f) for dp, _, fn in os.walk(labels_root)
        for f in fn if is_label_file(f))
    os.makedirs(out_dir, exist_ok=True)
    tasks = [(g, out_dir, target_size, max_instances, max_verts, cache_images)
             for g in gt_files]
    if workers > 1:
        if cache_images:            # the PNG row unfilter, built once before the workers
            from instance_segmentation_torch.kernels import build
            build.build("png_unfilter")
        with worker_context().Pool(workers) as pool:
            outs = pool.map(process_item, tasks)
    else:
        outs = [process_item(t) for t in tasks]
    manifest = os.path.join(out_dir, "manifest.json")
    with open(manifest, "w") as f:
        json.dump({"root": root, "subset": subset, "target_size": target_size,
                   "files": outs}, f)
    print(f"packed {len(outs)} labels -> {out_dir}")


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--subset", default="train")
    ap.add_argument("--out", required=True)
    ap.add_argument("--target_size", type=int, default=2)
    ap.add_argument("--max_instances", type=int, default=96)
    ap.add_argument("--max_verts", type=int, default=256)
    ap.add_argument("--workers", type=int, default=max(1, (os.cpu_count() or 1)))
    ap.add_argument("--cache_images", action="store_true",
                    help="also pre-resize and cache the leftImg8bit frames")
    a = ap.parse_args(argv)
    preprocess(a.root, a.subset, a.out, a.target_size, a.max_instances,
               a.max_verts, a.workers, a.cache_images)


if __name__ == "__main__":
    main()
