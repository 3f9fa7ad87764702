"""Dataset abstraction; counterpart of ``instance_segmentation_tpu/data/dataset.py``."""

from __future__ import annotations

from abc import ABC, abstractmethod

TRAIN_PHASES = ("train",)
VAL_PHASES = ("val", "test")


def is_train_phase(phase: str) -> bool:
    return phase in TRAIN_PHASES


def is_val_phase(phase: str) -> bool:
    return phase in VAL_PHASES


class DatasetBuilder(ABC):
    def __init__(self, data_dir: str, phase: str):
        self._data_dir = data_dir
        self._phase = phase

    @abstractmethod
    def get_dataset(self, **kwargs):
        ...
