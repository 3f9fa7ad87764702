"""Cityscapes dataset: label table, polygon parsing, map-style dataset.

Counterpart of ``instance_segmentation_tpu/data/cityscapes.py``, with
frames read by ``utils/png.py`` and ``utils/jpeg.py`` instead of OpenCV
(``load_rgb_image`` picks the reader by the file's first bytes, not its
name). It mirrors ref data/cityscapes.py: the standard
35-entry Cityscapes label table
(public metadata from the Cityscapes benchmark), the 8 instance-evaluated
classes, `gtFine_polygons.json` parsing into (cls_ids, polygons) with
polygons as int32 (x, y) vertex arrays (ref :152-166), and directory walking
over leftImg8bit/gtFine (ref :169-201).
"""

from __future__ import annotations

import json
import os
from collections import namedtuple
from typing import List, Tuple

import numpy as np

from instance_segmentation_torch.data.dataset import DatasetBuilder
from instance_segmentation_torch.utils.jpeg import is_jpeg, read_jpeg
from instance_segmentation_torch.utils.png import SIGNATURE, read_png

Label = namedtuple("Label", [
    "name", "id", "trainId", "category", "categoryId",
    "hasInstances", "ignoreInEval", "color",
])

# Standard Cityscapes label metadata (public benchmark definition), stored
# compactly as name|id|trainId|category|catId|hasInstances|ignoreInEval|color.
_LABEL_ROWS = """
unlabeled|0|255|void|0|0|1|0,0,0
ego vehicle|1|255|void|0|0|1|0,0,0
rectification border|2|255|void|0|0|1|0,0,0
out of roi|3|255|void|0|0|1|0,0,0
static|4|255|void|0|0|1|0,0,0
dynamic|5|255|void|0|0|1|111,74,0
ground|6|255|void|0|0|1|81,0,81
road|7|0|flat|1|0|0|128,64,128
sidewalk|8|1|flat|1|0|0|244,35,232
parking|9|255|flat|1|0|1|250,170,160
rail track|10|255|flat|1|0|1|230,150,140
building|11|2|construction|2|0|0|70,70,70
wall|12|3|construction|2|0|0|102,102,156
fence|13|4|construction|2|0|0|190,153,153
guard rail|14|255|construction|2|0|1|180,165,180
bridge|15|255|construction|2|0|1|150,100,100
tunnel|16|255|construction|2|0|1|150,120,90
pole|17|5|object|3|0|0|153,153,153
polegroup|18|255|object|3|0|1|153,153,153
traffic light|19|6|object|3|0|0|250,170,30
traffic sign|20|7|object|3|0|0|220,220,0
vegetation|21|8|nature|4|0|0|107,142,35
terrain|22|9|nature|4|0|0|152,251,152
sky|23|10|sky|5|0|0|70,130,180
person|24|11|human|6|1|0|220,20,60
rider|25|12|human|6|1|0|255,0,0
car|26|13|vehicle|7|1|0|0,0,142
truck|27|14|vehicle|7|1|0|0,0,70
bus|28|15|vehicle|7|1|0|0,60,100
caravan|29|255|vehicle|7|1|1|0,0,90
trailer|30|255|vehicle|7|1|1|0,0,110
train|31|16|vehicle|7|1|0|0,80,100
motorcycle|32|17|vehicle|7|1|0|0,0,230
bicycle|33|18|vehicle|7|1|0|119,11,32
license plate|-1|-1|vehicle|7|0|1|0,0,142
""".strip()


def _parse_label_rows(rows: str):
    out = []
    for line in rows.splitlines():
        name, lid, tid, cat, cid, inst, ign, color = line.split("|")
        out.append(Label(name, int(lid), int(tid), cat, int(cid),
                         inst == "1", ign == "1",
                         tuple(int(c) for c in color.split(","))))
    return out


labels = _parse_label_rows(_LABEL_ROWS)

name2label = {l.name: l for l in labels}
id2label = {l.id: l for l in labels}

# the 8 instance classes scored by the Cityscapes instance-level benchmark
eval_labels = [l for l in labels if l.hasInstances and not l.ignoreInEval]
name2index = {l.name: i for i, l in enumerate(eval_labels)}
class_labels = [(i, l.name, l.id) for i, l in enumerate(eval_labels)]
num_cls = len(eval_labels)

IMAGE_EXTENSIONS = (".jpg", ".png")


def is_image(filename: str) -> bool:
    return filename.endswith(IMAGE_EXTENSIONS)


def is_label_file(filename: str) -> bool:
    return filename.endswith("gtFine_polygons.json")


def load_rgb_image(path: str) -> np.ndarray:
    """RGB uint8 [H, W, 3] of a PNG or JPEG frame (``utils.png.read_png``,
    ``utils.jpeg.read_jpeg``), chosen by the file's magic bytes as
    ``cv2.imread`` chooses; anything else raises a ``ValueError``."""
    with open(path, "rb") as f:
        head = f.read(8)
    if head == SIGNATURE:
        return read_png(path)
    if is_jpeg(head):
        return read_jpeg(path)
    raise ValueError(f"{path}: neither a PNG nor a JPEG file")


def parse_label_json(label_json: dict) -> Tuple[List[int], List[np.ndarray]]:
    """gtFine polygons -> (cls_ids, [(x, y) int32 polygon arrays])."""
    cls_ids, polygons = [], []
    for obj in label_json.get("objects", []):
        name = obj["label"]
        if name not in name2index:
            continue
        cls_ids.append(name2index[name])
        polygons.append(np.asarray(obj["polygon"], dtype=np.int32))
    return cls_ids, polygons


def parse_eval_label_json(label_json: dict):
    """gtFine polygons -> official-eval ground truth.

    Returns (cls_ids, polygons, is_group, void_polygons):
      * instance-class objects (the 8 scored classes) with is_group=False;
      * `<class>group` objects (e.g. "cargroup" — the official instID<1000
        group regions, cityscapesscripts name2label endswith('group')
        handling) mapped to the base class with is_group=True;
      * void_polygons: objects whose label has ignoreInEval=True (incl.
        hasInstances classes like caravan/trailer that the official
        instance benchmark treats as void) — the FP-discount regions.
    Other stuff labels (road, sky, ...) are skipped: not scored, not void.
    """
    cls_ids: List[int] = []
    polygons: List[np.ndarray] = []
    is_group: List[bool] = []
    void_polys: List[np.ndarray] = []
    for obj in label_json.get("objects", []):
        name = obj["label"]
        poly = np.asarray(obj["polygon"], dtype=np.int32)
        if name in name2index:
            cls_ids.append(name2index[name])
            polygons.append(poly)
            is_group.append(False)
        elif name.endswith("group") and name[:-len("group")] in name2index:
            cls_ids.append(name2index[name[:-len("group")]])
            polygons.append(poly)
            is_group.append(True)
        elif name in name2label and name2label[name].ignoreInEval:
            void_polys.append(poly)
    return cls_ids, polygons, is_group, void_polys


class CityscapesDataset:
    """Map-style dataset over a Cityscapes directory tree."""

    def __init__(self, root: str, transforms=None, subset: str = "train"):
        self.images_root = os.path.join(root, "leftImg8bit", subset)
        self.labels_root = os.path.join(root, "gtFine", subset)
        self.filenames = sorted(
            os.path.join(dp, f)
            for dp, _, fn in os.walk(os.path.expanduser(self.images_root))
            for f in fn if is_image(f))
        self.filenames_gt = sorted(
            os.path.join(dp, f)
            for dp, _, fn in os.walk(os.path.expanduser(self.labels_root))
            for f in fn if is_label_file(f))
        # the two sorted walks are paired by index: verify the pairing by
        # basename stem so one missing/extra file can't silently shift every
        # subsequent sample onto the wrong label
        if len(self.filenames) != len(self.filenames_gt):
            raise ValueError(
                f"{self.images_root}: {len(self.filenames)} images vs "
                f"{len(self.filenames_gt)} label files")
        for img, gt in zip(self.filenames, self.filenames_gt):
            istem = os.path.basename(img).split("_leftImg8bit")[0]
            gstem = os.path.basename(gt).split("_gtFine")[0].split("_fill")[0]
            if istem != gstem:
                raise ValueError(f"image/label mismatch: {img} vs {gt}")
        self._transforms = transforms

    def __len__(self) -> int:
        return len(self.filenames)

    def __getitem__(self, index: int):
        img_path = self.filenames[index]
        img = load_rgb_image(img_path)
        with open(self.filenames_gt[index], "r") as f:
            label = parse_label_json(json.load(f))
        if self._transforms is not None:
            return self._transforms(img, label, img_path)
        return img, label, None


class CityscapesDatasetBuilder(DatasetBuilder):
    def get_dataset(self, **kwargs):
        return CityscapesDataset(self._data_dir, subset=self._phase, **kwargs)
