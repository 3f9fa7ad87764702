"""Learning capstone: overfit a tiny synthetic set and score instance AP.

Counterpart of the JAX package's ``tools/overfit_demo.py``, with its
protocol and flags. Four synthetic Cityscapes-format frames (generator seed
21, 2-4 class-coloured polygon blobs each; val a copy of train) are resized
to half their size; EfficientSeg-B0 (8 classes, bf16 compute over float32
master weights) trains on them with Adam at ``--lr``, batch 2, M=16, 64
vertices, ``max_points=512``, through the port's step trainer (targets, the
four losses and kernels K2-K5 on the card); then the full eval pipeline
(forward, decode with K1, polygons, mask AP) scores the same frames. The
same weights are scored again with ``group_mode="kmeans"``, and with
``--quant_ab`` through the int8 path. Prints the loss every 200 steps and
one JSON line ``{"AP", "AP50", "AP_kmeans", "AP50_kmeans"[, "AP_int8",
"AP50_int8", "dAP_int8"]}``.

    python -m instance_segmentation_torch.tools.overfit_demo [--steps 2400] \\
        [--lr 3e-4] [--out DIR] [--seed 0] [--quant_ab] [--device cpu]

The final weights are saved as a port checkpoint under ``OUT/ckpt``;
``--steps 0`` restores them instead of training. The seeded weights come
from ``weights.init_random(seed)``, not JAX's ``PRNGKey(seed)``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time
from typing import Optional, Sequence, Tuple

import torch

from instance_segmentation_torch.configs import Config, Configer
from instance_segmentation_torch.data import get_dataloader
from instance_segmentation_torch.data.registry import device_prefetch
from instance_segmentation_torch.device import require_cuda
from instance_segmentation_torch.evaluation import evaluate_model
from instance_segmentation_torch.models import EfficientSeg, EfficientSegConfig
from instance_segmentation_torch.tools.make_synthetic_cityscapes import generate
from instance_segmentation_torch.training.train_step import Trainer
from instance_segmentation_torch.transforms import CommonTransforms
from instance_segmentation_torch.utils.checkpoint import CheckpointManager
from instance_segmentation_torch.utils.logger import Logger

DECODE = {"cls_th": 0.3, "iou_th": 0.2, "kp_th": 20000, "obj_pixel_th": 2, "wh_delta": 0.1,
          "draw_flag": False}
TRANS = {"train_trans": {"trans_seq": ["resize"], "resize": {"target_size": 2}},
         "val_trans": {"trans_seq": ["resize"], "resize": {"target_size": 2}},
         "normalize": {"div_value": 255.0, "mean": [0.485, 0.456, 0.406],
                       "std": [0.229, 0.224, 0.225]}}


def make_data(root: str, train_n: int, val_n: int, gen_hw: Tuple[int, int]) -> None:
    """The synthetic tree (generator seed 21): a disjoint val split with
    ``val_n`` > 0, else val a copy of train."""
    gh, gw = gen_hw
    if val_n > 0:
        generate(root, splits=(("train", train_n), ("val", val_n)), h=gh, w=gw, seed=21,
                 instances=(2, 4))
        return
    generate(root, splits=(("train", train_n),), h=gh, w=gw, seed=21, instances=(2, 4))
    for part in ("leftImg8bit", "gtFine"):
        shutil.copytree(os.path.join(root, part, "train"), os.path.join(root, part, "val"))


def _evaluate(model, root: str, save_dir: str, hw, gen_hw, group_mode: str = "affinity"):
    """Scores ``model`` on the val split into a fresh ``save_dir``."""
    shutil.rmtree(save_dir, ignore_errors=True)     # the eval caches its detections there
    os.makedirs(save_dir)
    loader = get_dataloader(2, "cityscapes", root, "val",
                            transforms=CommonTransforms(Configer(TRANS), "val", seed=0),
                            max_instances=16, max_verts=64)
    data_cfg = Config({"save_dir": save_dir, "num_classes": 8, "eval_dir": root,
                       "train_dir": root})
    decode_cfg = Config(dict(DECODE, group_mode=group_mode))
    _, _, results = evaluate_model(data_cfg, loader, None, model, 0, "cityscapes", decode_cfg,
                                   Logger(save_dir), input_hw=hw, orig_hw=tuple(gen_hw))
    return results


def run(steps: int = 2400, lr: float = 3e-4, out: Optional[str] = None,
        quant_ab: bool = False, train_n: int = 4, val_n: int = 0, seed: int = 0,
        data: Optional[str] = None, gen_hw: Tuple[int, int] = (512, 1024),
        device: Optional[torch.device] = None, log_every: int = 200) -> dict:
    """The capstone. Returns {"ap": the printed JSON, "losses": [(step,
    total loss)] at every ``log_every``-th step and the last, "train_s":
    seconds of the training loop, synchronised}."""
    device = torch.device(device) if device is not None else require_cuda()
    out = out or os.path.join(tempfile.gettempdir(), "iseg_overfit")
    os.makedirs(out, exist_ok=True)
    gh, gw = gen_hw
    root = data or os.path.join(out, "data")
    if not os.path.isdir(root):
        make_data(root, train_n, val_n, gen_hw)
    loader = get_dataloader(2, "cityscapes", root, "train",
                            transforms=CommonTransforms(Configer(TRANS), "train", seed=seed),
                            max_instances=16, max_verts=64, seed=seed)

    H, W = gh // 2, gw // 2
    cfg = EfficientSegConfig(num_classes=8, compound_coef=0, compute_dtype=torch.bfloat16)
    trainer = Trainer(cfg, torch.Generator().manual_seed(seed), (H, W), max_points=512,
                      opt_type="Adam", lr=lr, device=device, drop_seed=seed + 1)
    ckpt = CheckpointManager(os.path.join(out, "ckpt"))
    if steps == 0 and ckpt.list_checkpoints():
        # resume the saved capstone weights (e.g. for a quant A/B re-run)
        ckpt.restore_latest(trainer.model)
        print(f"restored {ckpt.save_dir}/{ckpt.list_checkpoints()[-1]}")

    losses, it = [], 0
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    while it < steps:
        for images, packed, _ in device_prefetch(loader, device):
            stats = trainer.step(images, packed.polys, packed.n_verts, packed.cls_ids)
            if it % log_every == 0 or it % 200 == 0 or it == steps - 1:
                losses.append((it, float(stats["total_loss"])))
            if it % 200 == 0:
                print(f"it {it:5d} loss {losses[-1][1]:9.3f} "
                      f"({time.perf_counter() - t0:.0f}s)", flush=True)
            it += 1
            if it >= steps:
                break
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    train_s = time.perf_counter() - t0
    if steps > 0:
        path = ckpt.save(trainer, 0, 0.0)
        ckpt.wait()
        print(f"saved {path}")

    model = trainer.model
    results = _evaluate(model, root, os.path.join(out, "eval"), (H, W), gen_hw)
    out_json = {"AP": results["AP"], "AP50": results["AP50"]}
    km = _evaluate(model, root, os.path.join(out, "eval_kmeans"), (H, W), gen_hw, "kmeans")
    out_json["AP_kmeans"], out_json["AP50_kmeans"] = km["AP"], km["AP50"]
    if quant_ab:
        # the same weights through the int8 dense-conv path: the AP delta is
        # the quantization's cost (the parameters are the float model's)
        q_model = EfficientSeg(EfficientSegConfig(num_classes=8, compound_coef=0,
                                                  compute_dtype=torch.bfloat16, quant="int8"))
        q_model.load_state_dict(model.state_dict())
        q = _evaluate(q_model.to(device), root, os.path.join(out, "eval_int8"), (H, W), gen_hw)
        out_json["AP_int8"], out_json["AP50_int8"] = q["AP"], q["AP50"]
        out_json["dAP_int8"] = q["AP"] - results["AP"]
    print(json.dumps(out_json), flush=True)
    return {"ap": out_json, "losses": losses, "train_s": train_s}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=2400)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--out", default=None,
                    help="output directory (default: iseg_overfit in the temp directory)")
    ap.add_argument("--train_n", type=int, default=4)
    ap.add_argument("--val_n", type=int, default=0,
                    help=">0 evaluates on a DISJOINT val split (generalization, not overfit)")
    ap.add_argument("--quant_ab", action="store_true",
                    help="after the float eval, re-evaluate the same weights through the int8 "
                         "inference path and report the AP delta")
    ap.add_argument("--seed", type=int, default=0,
                    help="model-init / shuffle / drop-connect seed (the synthetic data tree "
                         "itself stays pinned at generator seed 21)")
    ap.add_argument("--data", default=None,
                    help="existing synthetic tree to reuse (skips generation)")
    ap.add_argument("--gen_hw", type=int, nargs=2, default=(512, 1024),
                    help="generated frame size (model input = half this)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default: the card, or fail) or cpu")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    a = parse_args(argv)
    device = torch.device("cpu") if a.device == "cpu" else require_cuda()
    return run(a.steps, a.lr, a.out, a.quant_ab, a.train_n, a.val_n, a.seed, a.data,
               tuple(a.gen_hw), device)


if __name__ == "__main__":
    main()
