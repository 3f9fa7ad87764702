from instance_segmentation_torch.training.trainer import Trainer

__all__ = ["Trainer"]
