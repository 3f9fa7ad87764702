"""COCO instance-segmentation dataset, JSON parsing without pycocotools.

Counterpart of ``instance_segmentation_tpu/data/coco.py`` (ref data/coco.py:
skip-id class remapping :23-36, first-polygon segmentation parsing :39-60,
per-subset instances.json :63-107). Frames are read by
``cityscapes.load_rgb_image`` (PNG or JPEG by magic bytes; COCO's frames
are JPEG, decoded by ``utils/jpeg.py`` bit for bit as ``cv2.imread``).
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import List, Optional

import numpy as np

from instance_segmentation_torch.data.cityscapes import load_rgb_image
from instance_segmentation_torch.data.dataset import DatasetBuilder

# COCO category ids absent from the 80-class contiguous indexing.
skip_cls_ids = [12, 26, 29, 30, 45, 66, 68, 69, 71, 83]
num_cls = 80


def convert_cls_id_to_index(cls_id: int) -> int:
    """COCO category id -> contiguous [0, 80) index (ref :26-36)."""
    skip = 0
    while skip < len(skip_cls_ids) and skip_cls_ids[skip] < cls_id:
        skip += 1
    return cls_id - skip - 1


def parse_segmentation(ann: dict) -> Optional[np.ndarray]:
    """First polygon of a segmentation as an (x, y) float array (ref :39-60);
    RLE annotations are skipped, as in the reference."""
    segm = ann.get("segmentation")
    if isinstance(segm, list) and segm:
        return np.asarray(segm[0], dtype=np.float32).reshape(-1, 2)
    return None


class COCODataset:
    def __init__(self, root: str, transforms=None, subset: str = "train"):
        self._data_dir = root
        self._phase = subset
        self._transforms = transforms
        with open(os.path.join(root, subset, "instances.json"), "r") as f:
            blob = json.load(f)
        self._imgs = {im["id"]: im for im in blob.get("images", [])}
        self._anns_by_img = defaultdict(list)
        for ann in blob.get("annotations", []):
            self._anns_by_img[ann["image_id"]].append(ann)
        self.ids = sorted(self._imgs.keys())

    def __len__(self) -> int:
        return len(self.ids)

    def __getitem__(self, index: int):
        img_id = self.ids[index]
        path = os.path.join(self._data_dir, self._phase, self._imgs[img_id]["file_name"])
        img = load_rgb_image(path)
        h, w = img.shape[:2]
        cls_ids: List[int] = []
        polygons: List[np.ndarray] = []
        for ann in self._anns_by_img[img_id]:
            poly = parse_segmentation(ann)
            if poly is None or poly.shape[0] <= 2:
                continue
            poly = poly.astype(np.int32)
            poly[:, 0] = np.clip(poly[:, 0], 0, w - 1)
            poly[:, 1] = np.clip(poly[:, 1], 0, h - 1)
            polygons.append(poly)
            cls_ids.append(convert_cls_id_to_index(ann["category_id"]))
        label = (cls_ids, polygons)
        if self._transforms is not None:
            return self._transforms(img, label, path)
        return img, label, None


class COCODatasetBuilder(DatasetBuilder):
    def get_dataset(self, **kwargs):
        return COCODataset(self._data_dir, subset=self._phase, **kwargs)
