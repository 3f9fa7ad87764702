"""Evaluation entry point of the port.

    python -m instance_segmentation_torch.evaluate --cfg_path eval.yaml [--device cpu]

Counterpart of the JAX package's ``evaluate.py``, reading the same config
files: it scores one checkpoint (``weights_path``'s directory, its latest
file; or the save directory's) or sweeps ``weights_dir`` (every 10th
checkpoint, ref evaluate.py:112-129). The model is EfficientSeg in bf16
whatever ``tpu.compute_dtype`` says (the JAX ``evaluate.py:67-70`` forces
it), at ``tpu.input_size`` (512x1024 without it). Without a checkpoint the
weights are the seeded initialisation of ``weights.init_random`` from
``seed``, which is not the JAX package's ``PRNGKey(seed)`` initialisation.
Runs on the CUDA card (PNG frames through the C row unfilter) unless
``--device cpu`` is given. ``tpu.quant: int8`` evaluates through the int8
path (``models/layers.int8_conv2d``), as the JAX CLI does.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import torch

from instance_segmentation_torch import data as data_mod
from instance_segmentation_torch.configs import (
    Config, load_decode_config, load_trans_config, static_shapes_from,
)
from instance_segmentation_torch.device import require_cuda
from instance_segmentation_torch.evaluation import evaluate_model
from instance_segmentation_torch.models import EfficientSeg, EfficientSegConfig
from instance_segmentation_torch.transforms import CommonTransforms
from instance_segmentation_torch.utils.checkpoint import CheckpointManager
from instance_segmentation_torch.utils.logger import Logger
from instance_segmentation_torch.weights import init_random


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="evaluate")
    ap.add_argument("--cfg_path", dest="cfg_path", type=str, required=True)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default: the card, or fail) or cpu")
    return ap.parse_args(argv)


def pick_device(name: str) -> torch.device:
    return torch.device("cpu") if name == "cpu" else require_cuda()


def seeded_model(cfg: Config, num_classes: int, device: torch.device) -> EfficientSeg:
    """EfficientSeg of ``cfg.compound_coef`` (its backbone ``cfg.backbone``
    where given, e.g. ``efficientnetv2-l``) in bf16 with the seeded
    initialisation of ``cfg.seed``, in eval mode on ``device``; with
    ``tpu.quant: int8`` its dense convs take the int8 path (the JAX
    ``evaluate.py:70``)."""
    tpu_cfg = cfg.get("tpu")
    quant = (tpu_cfg.get("quant") or "none") if tpu_cfg else "none"
    model = EfficientSeg(EfficientSegConfig(num_classes=num_classes,
                                            compound_coef=cfg.compound_coef,
                                            compute_dtype=torch.bfloat16, quant=quant,
                                            backbone=cfg.get("backbone")))
    init_random(model, torch.Generator().manual_seed(cfg.seed))
    return model.to(device).eval()


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    device = pick_device(args.device)
    cfg = Config(args.cfg_path)
    data_cfg = cfg.data
    decode_cfg = load_decode_config(cfg.get("decode_cfg_path"))
    trans_cfg = load_trans_config(cfg.get("trans_cfg_path"))
    os.makedirs(data_cfg.save_dir, exist_ok=True)
    logger = Logger.init_logger(data_cfg.save_dir, run_config=cfg)

    num_classes = data_cfg.num_classes
    if num_classes == -1:
        num_classes = data_mod.get_cls_num(data_cfg.dataset)
        data_cfg.num_classes = num_classes

    static = static_shapes_from(cfg)
    tpu_cfg = cfg.get("tpu")
    input_hw = tuple(tpu_cfg.input_size) if tpu_cfg else (512, 1024)
    model = seeded_model(cfg, num_classes, device)

    ckpt_dir = cfg.get("weights_dir") or os.path.dirname(cfg.get("weights_path") or "")
    mgr = CheckpointManager(ckpt_dir or data_cfg.save_dir)

    eval_tf = CommonTransforms(trans_cfg, "val")
    eval_loader = data_mod.get_dataloader(
        data_cfg.batch_size, data_cfg.dataset,
        data_cfg.get("eval_dir") or data_cfg.get("train_dir"),
        phase=data_cfg.get("subset", "val"), transforms=eval_tf,
        max_instances=static.max_instances, max_verts=static.max_vertices)

    if cfg.get("weights_dir"):
        # sweep the checkpoint directory, every 10th (ref evaluate.py:112-129)
        names = mgr.list_checkpoints()[::10] or mgr.list_checkpoints()[-1:]
        for name in names:
            epoch, _ = mgr.restore_named(name, model)
            logger.write(f"evaluating checkpoint {name} (epoch {epoch - 1})")
            evaluate_model(data_cfg, eval_loader, eval_tf, model, epoch - 1,
                           data_cfg.dataset, decode_cfg, logger, input_hw=input_hw)
    else:
        epoch, _ = mgr.restore_latest(model)
        evaluate_model(data_cfg, eval_loader, eval_tf, model, epoch,
                       data_cfg.dataset, decode_cfg, logger, input_hw=input_hw)


if __name__ == "__main__":
    main()
