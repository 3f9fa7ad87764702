from instance_segmentation_torch.transforms.augment import (
    CommonTransforms, TransInfo, build_augmentations,
)

__all__ = ["CommonTransforms", "TransInfo", "build_augmentations"]
