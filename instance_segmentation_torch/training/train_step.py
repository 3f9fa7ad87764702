"""The training step: targets, train-mode forward, losses, backward, optimizer.

Counterpart of ``instance_segmentation_tpu/parallel/train_step.py``
(``make_optimizer`` and ``make_train_step``). One ``Trainer.step`` takes
uint8 frames and packed polygon labels and, all on the trainer's device:
optionally augments them (``device_aug``), generates the targets, runs the
model in training mode (batch statistics; the running statistics are
updated in place), computes the five losses of ``compose_loss``,
back-propagates into the float32 master weights and applies the optimizer.
Each stage runs in a ``utils/profiling.span`` (targets, forward, loss,
backward, optimizer): a ``torch.profiler`` range while a profiler records,
and a shared no-op context, which costs a flag's read, while none does.

Data parallelism (the reference's data mesh): given an initialised process
group, each rank's trainer takes its slice of the global batch, its batch
norms take the statistics of the global batch, the kp focal loss its global
normaliser, and ``DistributedDataParallel`` averages the gradients, so N
ranks compute the losses, gradients and batch statistics one device
computes on the whole batch. Drop-connect stays per rank: its generator is
seeded ``drop_seed + rank``, so its masks differ from one device's. Each
gradient bucket's all-reduce (DDP's default, through a comm hook) opens an
"allreduce:grad" span, as each batch-norm statistics' all-reduce opens
"allreduce:bn" (``models/layers.py``).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.algorithms.ddp_comm_hooks import default_hooks
from torch.nn.parallel import DistributedDataParallel

from instance_segmentation_torch.device import require_cuda
from instance_segmentation_torch.losses import LossConfig, compose_loss
from instance_segmentation_torch.models import EfficientSeg, EfficientSegConfig, generate_anchors
from instance_segmentation_torch.models.layers import set_batchnorm_group
from instance_segmentation_torch.ops.device_aug import (
    draw_hflip_brightness, random_hflip_brightness,
)
from instance_segmentation_torch.ops.targets import generate_targets
from instance_segmentation_torch.parallel.multihost import process_batch_slice
from instance_segmentation_torch.utils.profiling import span
from instance_segmentation_torch.weights import init_random, load_flax_variables


def make_optimizer(params, opt_type: str = "Adam", lr: float = 2e-5,
                   momentum: float = 0.9) -> torch.optim.Optimizer:
    """The reference's optimizer menu (ref train.py:104-117):

    * ``SGD``: ``optax.sgd(lr, momentum=momentum)``, no weight decay (the
      config's ``optimizer.momentum``; Adam and Adadelta ignore it);
    * ``Adam``: ``optax.chain(add_decayed_weights(1e-4), adam(lr, 0.9,
      0.999, eps=1e-8))`` adds the L2 term to the gradient before the Adam
      moments, over every parameter (batch-norm scale/bias and fusion
      weights included): ``torch.optim.Adam`` with ``weight_decay=1e-4``;
    * ``Adadelta``: ``optax.adadelta(lr)`` (rho 0.9, eps 1e-6), no weight
      decay."""
    if opt_type == "SGD":
        return torch.optim.SGD(params, lr=lr, momentum=momentum)
    if opt_type == "Adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=1e-4)
    if opt_type == "Adadelta":
        return torch.optim.Adadelta(params, lr=lr, rho=0.9, eps=1e-6)
    raise ValueError(f"unknown optimizer type: {opt_type}")


def allreduce_hook(process_group, bucket):  # unannotated: DDP checks unresolved annotations
    """DDP's default all-reduce of a gradient bucket (the mean over the
    ranks), inside an "allreduce:grad" span."""
    with span("allreduce:grad"):
        return default_hooks.allreduce_hook(process_group, bucket)


class Trainer:
    """A model with float32 master weights, its optimizer and anchors, on one
    device (the CUDA card unless ``device`` says otherwise). ``weights`` is
    the JAX package's ``{"params", "batch_stats"}`` tree (numpy leaves) or a
    CPU ``torch.Generator`` for seeded untrained weights; ``drop_seed`` seeds
    the drop-connect generator on the device. ``device_aug`` flips and
    shifts the brightness of each image before target generation
    (``ops/device_aug.py``), its draws from a generator on the device
    seeded with ``aug_seed``.

    ``group``: an initialised process group whose every rank builds a
    trainer alike (the same weights; DDP broadcasts rank 0's anyway) and
    calls ``step`` with the same global batch; each rank takes its slice.
    None: one device, the whole batch."""

    def __init__(self, cfg: EfficientSegConfig, weights: Union[Mapping, torch.Generator],
                 input_hw: Tuple[int, int], loss_cfg: LossConfig = LossConfig(),
                 max_points: int = 2048, opt_type: str = "Adam", lr: float = 2e-5,
                 momentum: float = 0.9, device: Optional[torch.device] = None, drop_seed: int = 0,
                 group=None, device_aug: bool = False, aug_seed: int = 0):
        self.device = torch.device(device) if device is not None else require_cuda()
        self.cfg, self.loss_cfg = cfg, loss_cfg
        self.input_hw = tuple(input_hw)
        self.max_points = max_points
        self.group = group
        self.rank = 0 if group is None else dist.get_rank(group)
        self.steps = 0
        model = EfficientSeg(cfg, param_dtype=torch.float32)
        if isinstance(weights, torch.Generator):
            init_random(model, weights)
        else:
            load_flax_variables(model, weights)
        self.model = model.to(self.device).train()
        self.drop_generator = torch.Generator(device=self.device)
        self.drop_generator.manual_seed(drop_seed + self.rank)
        self.model.backbone_net["model"].generator = self.drop_generator
        self.aug_generator = None
        if device_aug:
            self.aug_generator = torch.Generator(device=self.device)
            self.aug_generator.manual_seed(aug_seed)
        self.forward = self.model
        if group is not None:
            set_batchnorm_group(self.model, group)
            index = self.device.index
            if self.device.type == "cuda" and index is None:
                index = torch.cuda.current_device()
            self.forward = DistributedDataParallel(
                self.model, device_ids=None if index is None else [index],
                process_group=group, broadcast_buffers=False, find_unused_parameters=False)
            self.forward.register_comm_hook(group, allreduce_hook)
        self.optimizer = make_optimizer(self.model.parameters(), opt_type, lr, momentum)
        anchors = generate_anchors(*self.input_hw, pyramid_levels=cfg.pyramid_levels,
                                   anchor_scale=cfg.anchor_scale, scales=cfg.scales,
                                   ratios=cfg.ratios)
        self.anchors = torch.tensor(anchors, device=self.device)

    def _as_batch(self, images, polys, n_verts, cls_ids):
        """This rank's slice of the global batch on the device, augmented when
        ``device_aug`` is on (the draws made for the global batch)."""
        images = torch.as_tensor(images)
        if images.dtype != torch.uint8 or tuple(images.shape[1:]) != (*self.input_hw, 3):
            raise ValueError(f"want uint8 [B, {self.input_hw[0]}, {self.input_hw[1]}, 3] "
                             f"frames, got {images.dtype} {tuple(images.shape)}")
        batch = images.shape[0]
        start, n = (0, batch) if self.group is None else process_batch_slice(batch, self.group)
        part = slice(start, start + n)
        dev = self.device
        images = images[part].to(dev, non_blocking=True)
        polys = torch.as_tensor(polys, dtype=torch.float32)[part].to(dev)
        if self.aug_generator is not None:
            draws = draw_hflip_brightness(batch, self.aug_generator)
            images, polys = random_hflip_brightness(images, polys, *(d[part] for d in draws))
        return (images, polys, torch.as_tensor(n_verts)[part].to(dev, torch.int32),
                torch.as_tensor(cls_ids)[part].to(dev, torch.int32))

    def compute_grads(self, images, polys, n_verts, cls_ids) -> Dict[str, torch.Tensor]:
        """Forward and backward: fills every parameter's ``.grad`` (replacing
        what was there; averaged over the ranks with a group), updates the
        batch-norm running statistics, and returns the six loss stats
        (detached scalars on the device; those of the global batch)."""
        images, polys, n_verts, cls_ids = self._as_batch(images, polys, n_verts, cls_ids)
        h, w = self.input_hw
        with span("targets"):
            targets = generate_targets(polys, n_verts, cls_ids, h, w,
                                       max_points=self.max_points, dense_kp=False)
        self.optimizer.zero_grad(set_to_none=True)
        with span("forward"):
            outputs = self.forward(images)
        with span("loss"):
            total, stats = compose_loss(outputs, targets, self.anchors, self.loss_cfg,
                                        group=self.group)
        with span("backward"):
            total.backward()
        return {k: v.detach() for k, v in stats.items()}

    def step(self, images, polys, n_verts, cls_ids) -> Dict[str, torch.Tensor]:
        """One training step (``compute_grads`` then the optimizer update)."""
        stats = self.compute_grads(images, polys, n_verts, cls_ids)
        with span("optimizer"):
            self.optimizer.step()
        self.steps += 1
        return stats
