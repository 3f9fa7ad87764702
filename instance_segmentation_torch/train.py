"""Training entry point of the port.

    python -m instance_segmentation_torch.train --cfg_path train.yaml [--device cpu]
    torchrun --nproc_per_node N -m instance_segmentation_torch.train --cfg_path train.yaml

Counterpart of the JAX package's ``train.py``, reading the same config files
(the train YAML, its ``trans_cfg_path`` JSON and ``decode_cfg_path`` YAML;
the package's defaults where they are empty). Under torchrun each rank
joins the process group (``parallel.multihost.maybe_initialize``: NCCL on
the cards, gloo with ``--device cpu``) and trains on its slice of every
global batch. Runs on the CUDA card unless ``--device cpu`` is given; it
raises where there is none. Checkpoints go to ``data.save_dir``
(``efficient_weights_*.pth``), which the ``evaluate`` entry point's
``weights_path`` reads.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import torch.distributed as dist

from instance_segmentation_torch.configs import (
    load_decode_config, load_train_config, load_trans_config,
)
from instance_segmentation_torch.evaluate import pick_device
from instance_segmentation_torch.parallel.multihost import maybe_initialize
from instance_segmentation_torch.training import Trainer
from instance_segmentation_torch.utils.logger import Logger


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="training")
    ap.add_argument("--cfg_path", dest="cfg_path", type=str, default=None,
                    help="path to the train config yaml")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default: the card, or fail) or cpu")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    device = maybe_initialize(args.device)
    joined = device is not None
    try:
        if device is None:
            device = pick_device(args.device)
        group = dist.group.WORLD if joined else None
        cfg = load_train_config(args.cfg_path)
        decode_cfg = load_decode_config(cfg.get("decode_cfg_path"))
        trans_cfg = load_trans_config(cfg.get("trans_cfg_path"))

        data_cfg = cfg.data
        if not os.path.exists(data_cfg.train_dir):
            raise FileNotFoundError(f"the train dir cannot be found: {data_cfg.train_dir}")
        os.makedirs(data_cfg.save_dir, exist_ok=True)

        rank0 = not joined or dist.get_rank() == 0
        logger = Logger.init_logger(data_cfg.save_dir if rank0 else None, run_config=cfg)
        if rank0:
            logger.write("start to train...")
        Trainer(cfg, decode_cfg, trans_cfg, logger, device=device, group=group).train()
    finally:
        if joined:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
