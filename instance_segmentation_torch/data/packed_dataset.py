"""Dataset over offline pre-packed labels (``tools/preprocess_cityscapes.py``).

Counterpart of ``instance_segmentation_tpu/data/packed_dataset.py``, with
``transforms.augment.resize_linear`` (``cv2.resize`` bit for bit) in place
of OpenCV: training reads images plus already-packed static-shape label
arrays from .npz, skipping JSON parsing, augmentation-time polygon
bookkeeping and packing on the host.

Images are resized on the fly to the packed target scale, or read from the
pre-resized ``<key>_img.npy`` cache that ``--cache_images`` writes; the
packed labels are already in (row, col) int coordinates at that scale.
Photometric and flip augmentation run on the device in this mode
(``tpu.device_aug``, ``ops/device_aug.py``).
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from instance_segmentation_torch.data.cityscapes import load_rgb_image
from instance_segmentation_torch.data.dataset import DatasetBuilder
from instance_segmentation_torch.transforms.augment import TransInfo, resize_linear


class PackedCityscapesDataset:
    """Pairs leftImg8bit images with pre-packed npz labels via the manifest."""

    def __init__(self, root: str, packed_dir: str, subset: str = "train"):
        with open(os.path.join(packed_dir, "manifest.json")) as f:
            manifest = json.load(f)
        self.target_size = manifest["target_size"]
        self.packed_files = sorted(manifest["files"])
        self.images_root = os.path.join(root, "leftImg8bit", subset)
        # map by the shared basename prefix <city>_<seq>_<frame>
        imgs = {}
        for dp, _, fn in os.walk(os.path.expanduser(self.images_root)):
            for f in fn:
                if f.endswith("_leftImg8bit.png") or f.endswith("_leftImg8bit.jpg"):
                    key = f.rsplit("_leftImg8bit", 1)[0]
                    imgs[key] = os.path.join(dp, f)
        self.items = []
        for p in self.packed_files:
            key = os.path.basename(p).rsplit("_gtFine_polygons", 1)[0]
            if key in imgs:
                self.items.append((imgs[key], p))

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, index: int):
        img_path, packed_path = self.items[index]
        blob = np.load(packed_path)
        h, w = int(blob["img_h"]), int(blob["img_w"])
        # the pre-resized image cache (preprocess --cache_images), else
        # decode and resize
        key = os.path.basename(packed_path).rsplit("_gtFine_polygons", 1)[0]
        cached = os.path.join(os.path.dirname(packed_path), key + "_img.npy")
        if os.path.exists(cached):
            img = np.load(cached)
        else:
            img = load_rgb_image(img_path)
            scale = 1.0 / self.target_size
            img = resize_linear(img, int(w * scale), int(h * scale))
        label = ("packed", blob["polys"], blob["n_verts"], blob["cls_ids"])
        return img, label, TransInfo(img_path, (h, w))


class PackedCityscapesDatasetBuilder(DatasetBuilder):
    def get_dataset(self, packed_dir: Optional[str] = None, **kwargs):
        kwargs.pop("transforms", None)      # labels are already packed
        packed_dir = packed_dir or os.path.join(self._data_dir, "packed", self._phase)
        return PackedCityscapesDataset(self._data_dir, packed_dir,
                                       subset=self._phase)
