"""Offline ground-truth polygon cleanup: fill each polygon and re-extract its
outer contour, without OpenCV.

Counterpart of the JAX package's ``tools/convert_polygon.py``: each object's
polygon is filled (``utils/image.fill_poly``, ``cv2.fillPoly`` bit for
bit), its outer contours traced (``utils/contours.find_external_contours``,
``cv2.findContours`` with ``RETR_EXTERNAL`` and ``CHAIN_APPROX_SIMPLE``) and
the largest by ``contour_area`` kept (the first of equal areas, as Python's
``max`` picks), so self-intersecting and degenerate polygons become simple
filled ones; an object left with fewer than three points is dropped. Every
``*_gtFine_polygons.json`` under ``--root`` is rewritten as
``*_fill_polygons.json`` beside it.

    python -m instance_segmentation_torch.tools.convert_polygon --root DIR
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

import numpy as np

from instance_segmentation_torch.data.cityscapes import is_label_file
from instance_segmentation_torch.utils.contours import contour_area, find_external_contours
from instance_segmentation_torch.utils.image import fill_poly


def fill_polygon(polygon: np.ndarray, h: int, w: int) -> Optional[np.ndarray]:
    """fillPoly -> findContours round trip: the largest outer contour of the
    filled polygon as int32 [N, 2] (x, y), or None when nothing was filled."""
    mask = np.zeros((h, w), np.uint8)
    fill_poly(mask, np.asarray(polygon).astype(np.int32), 1)
    contours = find_external_contours(mask)
    if not contours:
        return None
    return max(contours, key=contour_area).reshape(-1, 2)


def convert_file(path: str) -> str:
    """Rewrite one label file; returns the path written."""
    with open(path) as f:
        blob = json.load(f)
    h, w = blob.get("imgHeight", 1024), blob.get("imgWidth", 2048)
    new_objects = []
    for obj in blob.get("objects", []):
        filled = fill_polygon(np.asarray(obj["polygon"], np.int32), h, w)
        if filled is None or filled.shape[0] < 3:
            continue
        new_objects.append({"label": obj["label"], "polygon": filled.tolist()})
    blob["objects"] = new_objects
    out = path.replace("_gtFine_polygons.json", "_fill_polygons.json")
    with open(out, "w") as f:
        json.dump(blob, f)
    return out


def convert_tree(root: str) -> list:
    """Convert every label file under ``root``; returns the paths written."""
    written = []
    for dp, _, names in os.walk(root):
        for name in sorted(names):
            if is_label_file(name):
                written.append(convert_file(os.path.join(dp, name)))
    return written


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True, help="gtFine directory root")
    args = ap.parse_args(argv)
    print(f"converted {len(convert_tree(args.root))} label files")


if __name__ == "__main__":
    main()
