"""Inference entry point of the port.

    python -m instance_segmentation_torch.test --cfg_path test.yaml [--device cpu]

Counterpart of the JAX package's ``test.py``, reading the same config
files: the model (bf16, as there) and the full decode over an image
directory (``test_dir``) or one ``test_image``, each frame's instances
filled over it at alpha 0.5 (``utils/visualize.visualize_instances``) and
written into ``save_dir`` under the frame's name, in the format its
extension names as ``cv2.imwrite`` does: JPEG at quality 95 for ``.jpg``,
``.jpeg`` and ``.jpe``, PNG otherwise. ``weights_path`` must name a
checkpoint exactly; without it the save directory's latest is taken, and
without any the seeded initialisation of ``seed``. ``draw_flag: true`` in
the decode config adds each frame's three debug drawings
(``utils/debug_draw.dump_detections``). Runs on the CUDA card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from instance_segmentation_torch import data as data_mod
from instance_segmentation_torch.configs import (
    Config, load_decode_config, load_trans_config, parse_anchor_expr,
)
from instance_segmentation_torch.data.cityscapes import load_rgb_image
from instance_segmentation_torch.evaluate import parse_args, pick_device, seeded_model
from instance_segmentation_torch.evaluation.eval_loop import decode_cfg_from, detections_to_json
from instance_segmentation_torch.models import generate_anchors
from instance_segmentation_torch.ops.decode import forward_and_decode
from instance_segmentation_torch.transforms import CommonTransforms
from instance_segmentation_torch.utils.checkpoint import CheckpointManager
from instance_segmentation_torch.utils.debug_draw import dump_detections
from instance_segmentation_torch.utils.jpeg import write_jpeg
from instance_segmentation_torch.utils.logger import Logger
from instance_segmentation_torch.utils.png import write_png
from instance_segmentation_torch.utils.visualize import visualize_instances


def write_image(path: str, rgb) -> None:
    """``cv2.imwrite`` of the BGR image: a JPEG (quality 95) for a JPEG
    extension, else a PNG."""
    if os.path.splitext(path)[1].lower() in (".jpg", ".jpeg", ".jpe"):
        write_jpeg(path, rgb)
    else:
        write_png(path, rgb)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    device = pick_device(args.device)
    cfg = Config(args.cfg_path)
    data_cfg = cfg.data
    decode_cfg = load_decode_config(cfg.get("decode_cfg_path"))
    trans_cfg = load_trans_config(cfg.get("trans_cfg_path"))
    os.makedirs(data_cfg.save_dir, exist_ok=True)
    logger = Logger.init_logger(data_cfg.save_dir, run_config=cfg)

    model = seeded_model(cfg, data_cfg.num_classes, device)
    input_hw = (512, 1024)
    if "input_size" in data_cfg:
        input_hw = tuple(parse_anchor_expr(data_cfg.input_size)) \
            if isinstance(data_cfg.input_size, str) else tuple(data_cfg.input_size)

    # the EXACT named checkpoint when weights_path is given (ref test.py:85-94
    # loads the named file strict); restore_latest only without a path
    weights_path = cfg.get("weights_path")
    if weights_path:
        weights_path = weights_path.rstrip("/")
        mgr = CheckpointManager(os.path.dirname(weights_path))
        name = os.path.basename(weights_path)
        if name not in mgr.list_checkpoints():
            raise FileNotFoundError(
                f"weights_path {weights_path!r} is not a checkpoint "
                f"(available: {mgr.list_checkpoints()})")
        mgr.restore_named(name, model)
    else:
        CheckpointManager(data_cfg.save_dir).restore_latest(model)

    eval_tf = CommonTransforms(trans_cfg, "val")
    test_image = data_cfg.get("test_image")
    if test_image:
        timg, _, info = eval_tf(load_rgb_image(test_image), img_path=test_image)
        batches = [(timg[None], None, [info])]
    else:
        batches = data_mod.get_dataloader(
            data_cfg.batch_size, "dir", data_cfg.test_dir, phase="test",
            transforms=eval_tf, with_label=False)

    h, w = input_hw
    mc = model.cfg
    anchors = torch.tensor(generate_anchors(
        h, w, pyramid_levels=mc.pyramid_levels, anchor_scale=mc.anchor_scale,
        scales=mc.scales, ratios=mc.ratios), device=device)
    dcfg = decode_cfg_from(decode_cfg)
    scale = trans_cfg.get("val_trans", "resize", default={}).get("target_size", 1)
    orig_hw = (h * scale, w * scale)
    draw_flag = bool(decode_cfg.get("draw_flag"))

    with torch.inference_mode():
        for images, _, infos in batches:
            images = torch.from_numpy(np.ascontiguousarray(images)).to(device)
            dets = forward_and_decode(model, images, anchors, orig_hw[0], orig_hw[1],
                                      float(scale), dcfg)
            for i, (det_list, info) in enumerate(zip(detections_to_json(dets, infos), infos)):
                # the reference draws on OpenCV's BGR frame with its palette
                bgr = load_rgb_image(info.img_path)[..., ::-1]
                polys = [np.asarray(d[3], np.float32) for d in det_list]
                out = os.path.join(data_cfg.save_dir, os.path.basename(info.img_path))
                write_image(out, visualize_instances(bgr, polys)[..., ::-1])
                logger.write(f"wrote {out} ({len(det_list)} instances)")
                if draw_flag:
                    dump_detections(dets, i, info.img_path, data_cfg.save_dir)


if __name__ == "__main__":
    main()
