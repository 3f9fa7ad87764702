"""Dataset registry and batched loader (ref data/__init__.py:18-102).

Counterpart of ``instance_segmentation_tpu/data/registry.py``:
``get_dataloader`` returns an iterable of static-shape batches

    images:  uint8 [B, H, W, 3] (numpy)
    labels:  PackedLabels (padded polys/n_verts/cls_ids) or None
    infos:   list[TransInfo]

read serially or by one prefetch thread, as there. ``device_prefetch``
takes the place of ``jax.device_put``: pinned host copies and
``non_blocking`` copies onto a torch device, a few batches ahead. The
``cityscapes`` and ``dir`` datasets are ported; ``coco`` and
``cityscapes_packed`` raise, as does a multi-process pool (``num_workers``
> 0): ROADMAP Queue 1 item 12 lists them.
"""

from __future__ import annotations

import collections
import queue
import threading
from typing import Iterator, List, Optional

import numpy as np
import torch

from instance_segmentation_torch.data import cityscapes
from instance_segmentation_torch.data.cityscapes import CityscapesDatasetBuilder
from instance_segmentation_torch.data.dataset import DatasetBuilder, is_train_phase
from instance_segmentation_torch.data.dir import DirDatasetBuilder
from instance_segmentation_torch.data.packing import PackedLabels, pack_batch

COCO_NUM_CLS = 80          # instance_segmentation_tpu/data/coco.py:num_cls


class _NotPortedBuilder(DatasetBuilder):
    name = ""

    def get_dataset(self, **kwargs):
        raise NotImplementedError(f"the {self.name!r} dataset is not ported yet "
                                  "(ROADMAP Queue 1 item 12)")


class COCODatasetBuilder(_NotPortedBuilder):
    name = "coco"


class PackedCityscapesDatasetBuilder(_NotPortedBuilder):
    name = "cityscapes_packed"


datasetBuildersMap = {
    "cityscapes": CityscapesDatasetBuilder,
    "cityscapes_packed": PackedCityscapesDatasetBuilder,
    "coco": COCODatasetBuilder,
    "dir": DirDatasetBuilder,
}

datasetClsNumMap = {
    "cityscapes": cityscapes.num_cls,
    "coco": COCO_NUM_CLS,
}

datasetEvalLabelMap = {
    "cityscapes": cityscapes.class_labels,
}


def get_eval_labels(dataset_type: str):
    return datasetEvalLabelMap[dataset_type]


def get_cls_num(dataset_type: str) -> int:
    return datasetClsNumMap[dataset_type]


class BatchLoader:
    """Iterable over packed batches with optional shuffling and prefetch."""

    def __init__(self, dataset, batch_size: int, shuffle: bool, drop_last: bool,
                 max_instances: int, max_verts: int, with_label: bool = True,
                 seed: int = 0, prefetch: int = 2, num_workers: int = 0):
        if num_workers > 0:
            raise NotImplementedError("the multi-process loader (num_workers > 0) is not "
                                      "ported yet (ROADMAP Queue 1 item 12)")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.max_instances = max_instances
        self.max_verts = max_verts
        self.with_label = with_label
        self.prefetch = prefetch
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _make_batch(self, indices) -> tuple:
        images, labels, infos = [], [], []
        for i in indices:
            img, label, info = self.dataset[i]
            images.append(np.ascontiguousarray(img))
            labels.append(label)
            infos.append(info)
        images = np.stack(images)
        packed: Optional[PackedLabels] = None
        if self.with_label and labels[0] is not None:
            packed = pack_batch(labels, self.max_instances, self.max_verts)
        return images, packed, infos

    def _index_batches(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            self._rng.shuffle(order)
        for s in range(0, n, self.batch_size):
            chunk = order[s:s + self.batch_size]
            if len(chunk) < self.batch_size and self.drop_last:
                return
            yield chunk

    def __iter__(self) -> Iterator:
        if self.prefetch <= 0:
            for idx in self._index_batches():
                yield self._make_batch(idx)
            return

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        stop = threading.Event()
        failure: List[BaseException] = []

        def put_stop_aware(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for idx in self._index_batches():
                    if stop.is_set():
                        return
                    if not put_stop_aware(self._make_batch(idx)):
                        return
            except BaseException as e:
                # a raising batch fails the epoch, not ends it early: a
                # swallowed error would truncate an eval sweep silently (and
                # the {epoch}_dets.json cache would pin the truncation)
                failure.append(e)
            finally:
                put_stop_aware(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    if failure:
                        raise RuntimeError("data prefetch worker failed") from failure[0]
                    break
                yield item
        finally:
            # the consumer may leave the epoch early: unblock and join the
            # worker so that threads and batches do not accumulate
            stop.set()
            while t.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    pass
                t.join(timeout=0.05)


def device_prefetch(loader, device: torch.device, size: int = 2):
    """Batches of ``loader`` with images and packed labels as tensors on
    ``device``, copied ``size`` batches ahead: from pinned host memory with
    ``non_blocking`` copies when ``device`` is a CUDA device, so that the
    copies overlap the work queued on the card."""
    device = torch.device(device)
    pin = device.type == "cuda"

    def put(batch):
        images, packed, infos = batch

        def move(a):
            t = torch.from_numpy(np.ascontiguousarray(a))
            return (t.pin_memory() if pin else t).to(device, non_blocking=pin)
        images = move(images)
        if packed is not None:
            packed = type(packed)(*(move(a) for a in packed))
        return images, packed, infos

    ahead = collections.deque()
    it = iter(loader)
    try:
        for batch in it:
            ahead.append(put(batch))
            if len(ahead) > size:
                yield ahead.popleft()
        while ahead:
            yield ahead.popleft()
    finally:
        # an early exit of the consumer ends the loader's prefetch thread
        if hasattr(it, "close"):
            it.close()


def get_dataloader(batch_size: int, dataset_type: str, data_dir: str, phase: str,
                   transforms=None, max_instances: int = 96, max_verts: int = 256,
                   random: bool = True, with_label: bool = True, seed: int = 0,
                   prefetch: int = 2, num_workers: int = 0) -> BatchLoader:
    builder = datasetBuildersMap[dataset_type](data_dir, phase)
    dataset = builder.get_dataset(transforms=transforms)
    train = is_train_phase(phase)
    return BatchLoader(
        dataset, batch_size,
        shuffle=train and random, drop_last=train,
        max_instances=max_instances, max_verts=max_verts,
        with_label=with_label, seed=seed, prefetch=prefetch,
        num_workers=num_workers)
