from instance_segmentation_torch.losses.losses import LossConfig, compose_loss  # noqa: F401
