"""The training step: targets, train-mode forward, losses, backward, Adam.

Counterpart of ``instance_segmentation_tpu/parallel/train_step.py``
(``make_optimizer`` and ``make_train_step`` with ``device_aug=False``), on one
device. One ``Trainer.step`` takes uint8 frames and packed polygon labels
and, all on the trainer's device: generates the targets, runs the model in
training mode (batch statistics; the running statistics are updated in
place), computes the five losses of ``compose_loss``, back-propagates into
the float32 master weights and applies the optimizer. Each stage runs in
a ``torch.profiler.record_function`` range (targets, forward, loss,
backward, optimizer) that a profiler trace shows and that costs nothing
without one.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple, Union

import torch
from torch.profiler import record_function

from instance_segmentation_torch.device import require_cuda
from instance_segmentation_torch.losses import LossConfig, compose_loss
from instance_segmentation_torch.models import EfficientSeg, EfficientSegConfig, generate_anchors
from instance_segmentation_torch.ops.targets import generate_targets
from instance_segmentation_torch.weights import init_random, load_flax_variables


def make_optimizer(params, opt_type: str = "Adam", lr: float = 2e-5) -> torch.optim.Optimizer:
    """The reference's optimizer menu, Adam only so far. Its
    ``optax.chain(add_decayed_weights(1e-4), adam(lr, 0.9, 0.999, eps=1e-8))``
    adds the L2 term to the gradient before the Adam moments, over every
    parameter (batch-norm scale/bias and fusion weights included): that is
    ``torch.optim.Adam`` with ``weight_decay=1e-4``."""
    if opt_type == "Adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=1e-4)
    raise NotImplementedError(f"optimizer {opt_type!r} is not ported (Adam is)")


class Trainer:
    """A model with float32 master weights, its optimizer and anchors, on one
    device (the CUDA card unless ``device`` says otherwise). ``weights`` is
    the JAX package's ``{"params", "batch_stats"}`` tree (numpy leaves) or a
    CPU ``torch.Generator`` for seeded untrained weights; ``drop_seed`` seeds
    the drop-connect generator on the device."""

    def __init__(self, cfg: EfficientSegConfig, weights: Union[Mapping, torch.Generator],
                 input_hw: Tuple[int, int], loss_cfg: LossConfig = LossConfig(),
                 max_points: int = 2048, opt_type: str = "Adam", lr: float = 2e-5,
                 device: Optional[torch.device] = None, drop_seed: int = 0):
        self.device = torch.device(device) if device is not None else require_cuda()
        self.cfg, self.loss_cfg = cfg, loss_cfg
        self.input_hw = tuple(input_hw)
        self.max_points = max_points
        model = EfficientSeg(cfg, param_dtype=torch.float32)
        if isinstance(weights, torch.Generator):
            init_random(model, weights)
        else:
            load_flax_variables(model, weights)
        self.model = model.to(self.device).train()
        generator = torch.Generator(device=self.device)
        generator.manual_seed(drop_seed)
        self.model.backbone_net["model"].generator = generator
        self.optimizer = make_optimizer(self.model.parameters(), opt_type, lr)
        anchors = generate_anchors(*self.input_hw, pyramid_levels=cfg.pyramid_levels,
                                   anchor_scale=cfg.anchor_scale, scales=cfg.scales,
                                   ratios=cfg.ratios)
        self.anchors = torch.tensor(anchors, device=self.device)

    def _as_batch(self, images, polys, n_verts, cls_ids):
        images = torch.as_tensor(images)
        if images.dtype != torch.uint8 or tuple(images.shape[1:]) != (*self.input_hw, 3):
            raise ValueError(f"want uint8 [B, {self.input_hw[0]}, {self.input_hw[1]}, 3] "
                             f"frames, got {images.dtype} {tuple(images.shape)}")
        dev = self.device
        return (images.to(dev, non_blocking=True),
                torch.as_tensor(polys, dtype=torch.float32).to(dev),
                torch.as_tensor(n_verts).to(dev, torch.int32),
                torch.as_tensor(cls_ids).to(dev, torch.int32))

    def compute_grads(self, images, polys, n_verts, cls_ids) -> Dict[str, torch.Tensor]:
        """Forward and backward: fills every parameter's ``.grad`` (replacing
        what was there), updates the batch-norm running statistics, and
        returns the six loss stats (detached scalars on the device)."""
        images, polys, n_verts, cls_ids = self._as_batch(images, polys, n_verts, cls_ids)
        h, w = self.input_hw
        with record_function("targets"):
            targets = generate_targets(polys, n_verts, cls_ids, h, w,
                                       max_points=self.max_points, dense_kp=False)
        self.optimizer.zero_grad(set_to_none=True)
        with record_function("forward"):
            outputs = self.model(images)
        with record_function("loss"):
            total, stats = compose_loss(outputs, targets, self.anchors, self.loss_cfg)
        with record_function("backward"):
            total.backward()
        return {k: v.detach() for k, v in stats.items()}

    def step(self, images, polys, n_verts, cls_ids) -> Dict[str, torch.Tensor]:
        """One training step (``compute_grads`` then the optimizer update)."""
        stats = self.compute_grads(images, polys, n_verts, cls_ids)
        with record_function("optimizer"):
            self.optimizer.step()
        return stats
