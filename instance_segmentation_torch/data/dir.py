"""Unlabeled directory dataset for inference (ref data/dir.py:18-47);
counterpart of ``instance_segmentation_tpu/data/dir.py``. ``.jpg`` and
``.png`` files are listed as there and read by ``load_rgb_image``, which
picks the decoder by the file's magic bytes."""

from __future__ import annotations

import os

from instance_segmentation_torch.data.cityscapes import load_rgb_image
from instance_segmentation_torch.data.dataset import DatasetBuilder


class DirDataset:
    def __init__(self, data_dir: str, transforms=None):
        self._transforms = transforms
        self.imgs = sorted(
            os.path.join(dp, f)
            for dp, _, fn in os.walk(os.path.expanduser(data_dir))
            for f in fn if f.endswith((".jpg", ".png")))

    def __len__(self) -> int:
        return len(self.imgs)

    def __getitem__(self, index: int):
        path = self.imgs[index]
        img = load_rgb_image(path)
        if self._transforms is not None:
            img, _, info = self._transforms(img, img_path=path)
            return img, None, info
        return img, None, None


class DirDatasetBuilder(DatasetBuilder):
    def get_dataset(self, **kwargs):
        kwargs.pop("subset", None)
        return DirDataset(self._data_dir, **kwargs)
