"""The epoch loop of the train entry point.

Counterpart of ``instance_segmentation_tpu/training/trainer.py`` (ref
train.py:172-271): the epoch loop, per-iteration loss and timing meters,
checkpoints every ``save_span`` iterations and every epoch, auto-resume from
the save directory (or the non-strict warm start from ``pretrained_path``,
which skips resume), and the in-loop evaluation from ``start_eval_epoch``
on. It wraps the step trainer (``train_step.Trainer``), which holds the
model, optimizer and generators and runs one step on the device.

The host reads a step's loss stats one step late (the step it just queued
keeps the device busy meanwhile); a NaN total raises ``RuntimeError`` one
step late, and the stats of a ``save_span`` step are read (and NaN-gated)
before its checkpoint, so that the checkpoint is the state after that step.

Under a process group (``group``) every rank loads the same global batches
and the step trainer takes its slice; rank 0 alone logs, evaluates and
writes checkpoints, and ``best_ap`` is broadcast so that every rank saves
the same. Stated differences from the JAX trainer: seeded weights come from
``weights.init_random(seed)``; drop-connect and ``device_aug`` draw from
torch generators seeded with ``seed + 1`` (JAX splits ``PRNGKey(seed + 1)``
each step).
"""

from __future__ import annotations

import time
from typing import Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from instance_segmentation_torch import data as data_mod
from instance_segmentation_torch.configs import Config, Configer, parse_anchor_expr, static_shapes_from
from instance_segmentation_torch.data.registry import device_prefetch
from instance_segmentation_torch.evaluation import evaluate_model
from instance_segmentation_torch.losses import LossConfig
from instance_segmentation_torch.models import EfficientSegConfig
from instance_segmentation_torch.training import train_step
from instance_segmentation_torch.transforms import CommonTransforms
from instance_segmentation_torch.utils.checkpoint import CheckpointManager, load_pretrained_file
from instance_segmentation_torch.utils.logger import Logger
from instance_segmentation_torch.utils.meters import AverageMeter

LOSS_NAMES = ("cls_loss", "wh_loss", "kp_loss", "ae_loss", "tan_loss", "total_loss")


class Trainer:
    """The epoch loop. ``weights``: the JAX package's ``{"params",
    "batch_stats"}`` tree to start from; None starts from
    ``init_random(cfg.seed)``. ``device``: where the step runs (the CUDA card
    unless given). ``group``: an initialised process group (every rank
    builds a Trainer alike)."""

    def __init__(self, cfg: Config, decode_cfg: Config, trans_cfg: Configer,
                 logger: Optional[Logger] = None, device: Optional[torch.device] = None,
                 group=None, weights: Optional[Mapping] = None):
        self.cfg = cfg
        self.decode_cfg = decode_cfg
        self.trans_cfg = trans_cfg
        self.data_cfg = cfg.data
        self.logger = logger or Logger.get_logger()
        self.static = static_shapes_from(cfg)
        self.group = group
        self.rank = 0 if group is None else dist.get_rank(group)

        num_classes = self.data_cfg.num_classes
        if num_classes == -1:
            num_classes = data_mod.get_cls_num(self.data_cfg.dataset)
        self.num_classes = num_classes

        tpu_cfg = cfg.get("tpu")
        self.input_hw = tuple(tpu_cfg.input_size) if tpu_cfg else (512, 1024)
        dtype = torch.bfloat16
        if tpu_cfg and tpu_cfg.get("compute_dtype") == "float32":
            dtype = torch.float32
        scales = tuple(parse_anchor_expr(cfg.anchors_scales))
        ratios = tuple(tuple(r) for r in parse_anchor_expr(cfg.anchors_ratios))
        self.model_cfg = EfficientSegConfig(
            num_classes=num_classes, compound_coef=cfg.compound_coef,
            scales=scales, ratios=ratios, compute_dtype=dtype,
            remat=bool(tpu_cfg.get("remat")) if tpu_cfg else False)

        opt = cfg.optimizer
        lr = float(parse_anchor_expr(opt.lr)) if isinstance(opt.lr, str) else float(opt.lr)
        ae_window = tuple(tpu_cfg.ae_window) if tpu_cfg and tpu_cfg.get("ae_window") else None
        # tpu.device_aug: flip and brightness run on the device in the step
        # (ops/device_aug.py); the host trans_seq then resizes only
        device_aug = bool(tpu_cfg.get("device_aug")) if tpu_cfg else False
        self.step_trainer = train_step.Trainer(
            self.model_cfg,
            torch.Generator().manual_seed(cfg.seed) if weights is None else weights,
            self.input_hw, LossConfig(ae_window=ae_window),
            max_points=self.static.max_points, opt_type=opt.type, lr=lr,
            momentum=float(opt.get("momentum", 0.9)), device=device,
            drop_seed=cfg.seed + 1, group=group, device_aug=device_aug,
            aug_seed=cfg.seed + 1)
        self.device = self.step_trainer.device

        self.ckpt = CheckpointManager(self.data_cfg.save_dir)
        pretrained = cfg.get("pretrained_path")
        if pretrained:
            # warm start (ref train.py:119-132: pretrained_path set => load it
            # non-strict and do NOT resume from save_dir)
            n_match, n_total = load_pretrained_file(pretrained, self.step_trainer.model)
            self.start_epoch, self.best_ap = 0, 0.0
            self._write(f"pretrained warm start from {pretrained}: "
                        f"{n_match}/{n_total} checkpoint arrays matched")
        else:
            self.start_epoch, self.best_ap = self.ckpt.restore_latest(self.step_trainer)
            if self.start_epoch > 0:
                self._write(f"resumed from epoch {self.start_epoch - 1}, best_ap={self.best_ap}")

    def _write(self, msg: str, level: int = 0) -> None:
        if self.rank == 0:
            self.logger.write(msg, level=level)

    # ------------------------------------------------------------------
    def make_loaders(self):
        train_tf = CommonTransforms(self.trans_cfg, "train", seed=self.cfg.seed)
        eval_tf = CommonTransforms(self.trans_cfg, "val", seed=self.cfg.seed)
        # data.num_workers: the worker pool (the reference's DataLoader
        # num_workers, ref data/__init__.py:42-64); None reads
        # ISEG_DATA_WORKERS, 0 is the prefetch thread
        train_loader = data_mod.get_dataloader(
            self.data_cfg.batch_size, self.data_cfg.dataset, self.data_cfg.train_dir,
            phase="train", transforms=train_tf,
            max_instances=self.static.max_instances, max_verts=self.static.max_vertices,
            seed=self.cfg.seed, num_workers=self.data_cfg.get("num_workers"))
        # the in-loop eval reads the val split of eval_dir when configured
        # (ref train.py:264-268 / evaluate.py:80 both honour the eval root)
        eval_dir = self.data_cfg.get("eval_dir") or self.data_cfg.train_dir
        eval_loader = data_mod.get_dataloader(
            self.data_cfg.batch_size, self.data_cfg.dataset, eval_dir,
            phase="val", transforms=eval_tf,
            max_instances=self.static.max_instances, max_verts=self.static.max_vertices,
            seed=self.cfg.seed)
        return train_loader, eval_loader, train_tf, eval_tf

    def train_epoch(self, loader, epoch: int):
        num_iter = len(loader)
        if self.cfg.max_iter > 0:
            num_iter = min(num_iter, self.cfg.max_iter)
        data_time, batch_time = AverageMeter(), AverageMeter()
        running = AverageMeter()
        avg = {k: AverageMeter() for k in LOSS_NAMES}
        start = last = time.time()

        def consume(pending):
            # read a PREVIOUS step's stats: once step k+1 is queued, step k's
            # scalars are (nearly) done, so this one-step-late read does not
            # stall the device the way a same-step float(total) would
            p_iter, p_bs, p_stats = pending
            host = {k: float(v) for k, v in p_stats.items()}
            total = host["total_loss"]
            if not np.isfinite(total):
                # the reference's NaN hard-fail (ref loss.py:243-244),
                # detected one step late
                raise RuntimeError(f"loss nan at epoch {epoch} iter {p_iter}: {host}")
            running.update(total, p_bs)
            msg = (f"train per epoch: [{epoch}][{p_iter}/{num_iter}]"
                   f"|Tot: {time.time() - start:.1f}")
            for k in LOSS_NAMES:
                avg[k].update(host[k], p_bs)
                msg += f"|{k}:{avg[k].avg:.4f}"
            msg += (f"|Data {data_time.val:.3f}s({data_time.avg:.3f}s)"
                    f"|Net {batch_time.avg:.3f}s")
            self._write(msg, level=1)

        pending = None
        for iter_id, (images, packed, infos) in enumerate(device_prefetch(loader, self.device)):
            if iter_id >= num_iter:
                break
            data_time.update(time.time() - last)
            stats = self.step_trainer.step(images, packed.polys, packed.n_verts, packed.cls_ids)
            if pending is not None:
                consume(pending)
                pending = None
            if (iter_id + 1) % self.cfg.save_span == 0:
                # read THIS step's stats before saving, so that the
                # checkpoint is the state after iter_id, NaN-gated through
                # it (saves are rare: the stall does not show)
                consume((iter_id, images.shape[0], stats))
                self.ckpt.save(self.step_trainer, epoch, self.best_ap, iter_id)
            else:
                pending = (iter_id, images.shape[0], stats)
            batch_time.update(time.time() - last)
            last = time.time()
        if pending is not None:
            consume(pending)
        return running, avg

    def write_metric(self, metric, epoch: int, phase: str):
        if self.rank != 0:
            return
        line = f"{phase} : [{epoch}/{self.cfg.num_epochs}]|"
        for k, v in metric.items():
            self.logger.scalar_summary(f"{phase}/{k}", v.avg, epoch)
            line += f"{k} {v.avg:8f} | "
        self.logger.write(line)

    def evaluate(self, eval_loader, eval_tf, epoch: int) -> float:
        """The in-loop eval (rank 0) on the unwrapped model in eval mode,
        then training mode again; returns the mAP (broadcast from rank 0
        under a group). The eval reads the running statistics and draws no
        drop-connect mask, so the training state is left as it was."""
        m_ap = 0.0
        if self.rank == 0:
            model = self.step_trainer.model
            try:
                _, m_ap, _ = evaluate_model(
                    self.data_cfg, eval_loader, eval_tf, model, epoch,
                    self.data_cfg.dataset, self.decode_cfg, self.logger,
                    input_hw=self.input_hw)
            finally:
                model.train()
        if self.group is not None:
            box = [m_ap]
            dist.broadcast_object_list(box, src=dist.get_global_rank(self.group, 0),
                                       group=self.group)
            m_ap = box[0]
        return float(m_ap)

    def train(self):
        train_loader, eval_loader, _, eval_tf = self.make_loaders()
        try:
            for epoch in range(self.start_epoch, self.cfg.num_epochs):
                _, avg = self.train_epoch(train_loader, epoch)
                self.write_metric(avg, epoch, "train")
                self.ckpt.save(self.step_trainer, epoch, self.best_ap)
                if epoch >= self.cfg.start_eval_epoch:
                    m_ap = self.evaluate(eval_loader, eval_tf, epoch)
                    if self.best_ap < m_ap:
                        self.best_ap = m_ap
            self._write(f"the best mAP:{self.best_ap}")
            self.ckpt.wait()
        finally:
            train_loader.close()
            eval_loader.close()
