"""Evaluation pipeline: forward and decode on the device -> dets JSON -> AP.

Counterpart of ``instance_segmentation_tpu/evaluation/eval_loop.py``, with
the reference's protocol (ref utils/eval_util.py):
  * detections are cached to "{epoch}_dets.json" / "{epoch}_infos.json" and
    reused when present (ref :36-47);
  * a detection is (cls_id, score, center (x, y), polygon (x, y)) at the
    original resolution (ref decode_single :441);
  * the decode frame ``orig_hw`` is fixed at (1024, 2048) with
    ``scale_int = round(orig_hw[0] / h)``, whatever the frames' size, as the
    JAX loop does (ROADMAP Queue 3 logs it);
  * official Cityscapes result files (results/<base>_<cls>_<k>.png and
    <base>pred.txt) are written and ``cityscapesscripts`` is run when that
    package can be imported (ref :74-127); the native AP
    (``cityscapes_ap.py``) scores the same records either way.
Each batch is one ``forward_and_decode`` call on the model's device, so K1
(the grouping kernel) launches once a batch. Eager PyTorch needs no padding
of the last, partial batch (the JAX loop pads it to compile once); the JSON
is the same. A ``coco`` dataset is scored by the native COCO-protocol AP
(``coco_ap.py``) against its ``instances.json``, with each prediction mapped
corner to corner from the ``orig_hw`` decode frame into its image's size,
and its detections written in the COCO results format too.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from instance_segmentation_torch import data as data_mod
from instance_segmentation_torch.data.cityscapes import parse_eval_label_json
from instance_segmentation_torch.data.coco import convert_cls_id_to_index, parse_segmentation
from instance_segmentation_torch.data.registry import device_prefetch
from instance_segmentation_torch.evaluation.cityscapes_ap import (
    InstanceGT, InstancePrediction, compute_instance_ap,
)
from instance_segmentation_torch.evaluation.coco_ap import (
    CocoGT, CocoPrediction, compute_coco_ap, rle_to_mask, write_coco_results,
)
from instance_segmentation_torch.models.anchors import generate_anchors
from instance_segmentation_torch.ops.decode import DecodeConfig, forward_and_decode
from instance_segmentation_torch.utils.image import poly_to_mask
from instance_segmentation_torch.utils.png import write_png


def decode_cfg_from(cfg) -> DecodeConfig:
    """The decode YAML's keys, and ``group_mode`` ("affinity" without it)
    and ``exact_topk`` (true without it), which the JAX package's reader
    leaves at their defaults."""
    exact = cfg.get("exact_topk", DecodeConfig.exact_topk)
    if not isinstance(exact, bool):
        raise ValueError(f"decode exact_topk: want true or false, got {exact!r}")
    return DecodeConfig(
        cls_th=float(cfg.cls_th), iou_th=float(cfg.iou_th),
        kp_th=int(cfg.kp_th), obj_pixel_th=int(cfg.obj_pixel_th),
        wh_delta=float(cfg.wh_delta),
        group_mode=str(cfg.get("group_mode") or DecodeConfig.group_mode),
        exact_topk=exact)


def detections_to_json(dets, infos) -> List[List]:
    """Packed Detections -> reference-format per-image det lists."""
    classes = dets.classes.cpu().numpy()
    scores = dets.scores.cpu().numpy()
    centers = dets.centers.cpu().numpy()
    polys = dets.polygons.cpu().numpy()
    lens = dets.poly_len.cpu().numpy()
    ok = dets.obj_valid.cpu().numpy()
    out = []
    for b in range(scores.shape[0]):
        img_dets = []
        for d in np.nonzero(ok[b])[0]:
            img_dets.append([
                int(classes[b, d]), float(scores[b, d]),
                centers[b, d].tolist(),
                polys[b, d, : lens[b, d]].tolist(),
            ])
        out.append(img_dets)
    return out


def _gt_path_for_image(img_path: str) -> Optional[str]:
    """leftImg8bit image path -> gtFine polygons json path."""
    if "leftImg8bit" not in img_path:
        return None
    p = img_path.replace("leftImg8bit/", "gtFine/", 1)
    p = p.replace("_leftImg8bit.png", "_gtFine_polygons.json")
    p = p.replace("_leftImg8bit.jpg", "_gtFine_polygons.json")
    return p if os.path.exists(p) else None


def eval_outputs(output_dir: str, eval_loader, model, epoch: int, decode_cfg, logger,
                 input_hw: Tuple[int, int], orig_hw: Tuple[int, int] = (1024, 2048)):
    """Forward and decode over the loader on ``model``'s device, cached to
    JSON (ref :35-71). Returns the two JSON paths."""
    dets_path = os.path.join(output_dir, f"{epoch}_dets.json")
    infos_path = os.path.join(output_dir, f"{epoch}_infos.json")
    if os.path.exists(dets_path) and os.path.exists(infos_path):
        return dets_path, infos_path
    device = next(model.parameters()).device
    h, w = input_hw
    mc = model.cfg
    anchors = torch.tensor(generate_anchors(
        h, w, pyramid_levels=mc.pyramid_levels, anchor_scale=mc.anchor_scale,
        scales=mc.scales, ratios=mc.ratios), device=device)
    dcfg = decode_cfg_from(decode_cfg)
    scale_int = round(orig_hw[0] / h)
    model.eval()
    all_dets, all_infos = [], []
    with torch.inference_mode():
        for images, _, infos in device_prefetch(eval_loader, device):
            dets = forward_and_decode(model, images, anchors, orig_hw[0], orig_hw[1],
                                      float(scale_int), dcfg)
            all_dets.extend(detections_to_json(dets, infos))
            all_infos.extend([(i.img_path, list(i.img_size)) for i in infos])
    logger.write(f"[{epoch}] finish evaluate step ({len(all_dets)} images)")
    with open(dets_path, "w") as f:
        f.write(json.dumps(all_dets))
    with open(infos_path, "w") as f:
        f.write(json.dumps(all_infos))
    return dets_path, infos_path


def evaluate_from_json(data_cfg, epoch: int, output_dir: str, dataset: str,
                       logger, num_classes: int,
                       orig_hw: Tuple[int, int] = (1024, 2048)):
    """Score cached detections: a ``coco`` dataset with the native COCO AP,
    any other with the native Cityscapes AP, and with the official
    cityscapesscripts harness too where it can be imported. ``orig_hw`` is
    the frame the decode detransformed into (``eval_outputs``)."""
    with open(os.path.join(output_dir, f"{epoch}_dets.json")) as f:
        dets_list = json.load(f)
    with open(os.path.join(output_dir, f"{epoch}_infos.json")) as f:
        info_list = json.load(f)
    if dataset == "coco":
        return _evaluate_coco(data_cfg, epoch, output_dir, logger, num_classes,
                              dets_list, info_list, orig_hw)
    predictions: List[InstancePrediction] = []
    ground_truth: List[InstanceGT] = []
    image_sizes: Dict[str, Tuple[int, int]] = {}
    void_regions: Dict[str, List[np.ndarray]] = {}
    for dets, info in zip(dets_list, info_list):
        img_path, img_size = info[0], tuple(info[1])
        image_sizes[img_path] = img_size
        for det in dets:
            cls_id, score, _center, polygon = det
            predictions.append(InstancePrediction(
                image_id=img_path, cls_id=int(cls_id), score=float(score),
                polygon=np.asarray(polygon, np.float32)))
        gt_path = _gt_path_for_image(img_path)
        if gt_path is not None:
            with open(gt_path) as f:
                cls_ids, polys, grp, voids = parse_eval_label_json(json.load(f))
            for c, p, g in zip(cls_ids, polys, grp):
                ground_truth.append(InstanceGT(
                    image_id=img_path, cls_id=int(c),
                    polygon=np.asarray(p, np.float32), is_group=bool(g)))
            if voids:
                void_regions.setdefault(img_path, []).extend(
                    np.asarray(v, np.float32) for v in voids)
    results = compute_instance_ap(predictions, ground_truth, image_sizes,
                                  num_classes, void_regions=void_regions)
    logger.write(f"[{epoch}] AP={results['AP']:.4f} AP50={results['AP50']:.4f}")
    for c, vals in results["classes"].items():
        logger.write(f"  class {c}: AP={vals['AP']:.4f} AP50={vals['AP50']:.4f}")
    _maybe_official_eval(data_cfg, epoch, output_dir, dataset, logger,
                         dets_list, info_list, num_classes)
    return results


def _evaluate_coco(data_cfg, epoch: int, output_dir: str, logger, num_classes: int,
                   dets_list, info_list, orig_hw: Tuple[int, int] = (1024, 2048)):
    """Native COCO-protocol mask AP over cached detections (JAX
    ``_evaluate_coco``). Ground truth comes from the per-subset
    instances.json the dataset reads; RLE annotations (every iscrowd
    region) are decoded to masks. The detections are also written to
    "{epoch}_coco_results.json" in the COCO results format."""
    root = data_cfg.get("eval_dir") or data_cfg.get("train_dir")
    subset = data_cfg.get("subset") or "val"
    with open(os.path.join(root, subset, "instances.json")) as f:
        blob = json.load(f)
    path_of = {im["id"]: os.path.join(root, subset, im["file_name"])
               for im in blob.get("images", [])}
    wanted = {info[0] for info in info_list}
    ground_truth = []
    for ann in blob.get("annotations", []):
        img_path = path_of.get(ann["image_id"])
        if img_path not in wanted:
            continue
        cls_id = convert_cls_id_to_index(ann["category_id"])
        area = float(ann["area"]) if "area" in ann else None
        crowd = bool(ann.get("iscrowd", 0))
        poly = parse_segmentation(ann)
        if poly is not None and poly.shape[0] > 2:
            ground_truth.append(CocoGT(image_id=img_path, cls_id=cls_id, polygon=poly,
                                       iscrowd=crowd, area=area))
        elif isinstance(ann.get("segmentation"), dict):
            ground_truth.append(CocoGT(image_id=img_path, cls_id=cls_id,
                                       mask=rle_to_mask(ann["segmentation"]),
                                       iscrowd=crowd, area=area))
    # the decode detransformed into the fixed orig_hw frame; COCO images
    # have their own sizes, so each polygon is mapped corner to corner
    predictions = []
    image_sizes = {}
    for dets, info in zip(dets_list, info_list):
        img_path, img_size = info[0], tuple(info[1])
        image_sizes[img_path] = img_size
        fx = (img_size[1] - 1) / max(orig_hw[1] - 1, 1)
        fy = (img_size[0] - 1) / max(orig_hw[0] - 1, 1)
        for det in dets:
            cls_id, score, _center, polygon = det
            poly = np.asarray(polygon, np.float32) * np.array([fx, fy], np.float32)
            predictions.append(CocoPrediction(image_id=img_path, cls_id=int(cls_id),
                                              score=float(score), polygon=poly))
    results = compute_coco_ap(predictions, ground_truth, image_sizes, num_classes)
    logger.write(f"[{epoch}] COCO AP={results['AP']:.4f} "
                 f"AP50={results['AP50']:.4f} AP75={results['AP75']:.4f}")
    write_coco_results(os.path.join(output_dir, f"{epoch}_coco_results.json"),
                       dets_list, info_list)
    return results


def write_official_results(output_dir, dataset, dets_list, info_list, num_classes) -> int:
    """The official Cityscapes result files: a binary PNG per instance under
    results/ and one <base>pred.txt per image of "<png> <labelId> <score>"
    lines (ref eval_util.py:100-125). Returns the number of instances."""
    eval_labels = data_mod.get_eval_labels(dataset)
    label_names = [l[1] for l in eval_labels]
    label_ids = [l[2] for l in eval_labels]
    os.makedirs(os.path.join(output_dir, "results"), exist_ok=True)
    n = 0
    for dets, info in zip(dets_list, info_list):
        img_path, img_size = info[0], tuple(info[1])
        base = os.path.splitext(os.path.basename(img_path))[0]
        with open(os.path.join(output_dir, base + "pred.txt"), "w") as fid:
            for j in range(num_classes):
                for k, det in enumerate(dets):
                    cls_id, score, _c, polygon = det
                    if int(cls_id) != j:
                        continue
                    mask = poly_to_mask(np.asarray(polygon, np.float32), img_size)
                    png = os.path.join("results", f"{base}_{label_names[j]}_{k}.png")
                    fid.write(f"{png} {label_ids[j]} {score}\n")
                    write_png(os.path.join(output_dir, png), (mask * 255).astype(np.uint8))
                    n += 1
    return n


def _maybe_official_eval(data_cfg, epoch, output_dir, dataset, logger,
                         dets_list, info_list, num_classes):
    """Write the official result files and run cityscapesscripts when it
    can be imported (golden harness, ref eval_util.py:74-127)."""
    try:
        import cityscapesscripts  # noqa: F401
    except ImportError:
        return
    os.environ["CITYSCAPES_DATASET"] = data_cfg.get("eval_dir") or data_cfg.get("train_dir")
    os.environ["CITYSCAPES_RESULTS"] = output_dir
    import cityscapesscripts.evaluation.evalInstanceLevelSemanticLabeling as cs_eval
    write_official_results(output_dir, dataset, dets_list, info_list, num_classes)
    logger.write("running official cityscapesscripts evaluation...")
    cs_eval.main()


def evaluate_model(data_cfg, eval_loader, transforms, model, epoch: int,
                   dataset: str, decode_cfg, logger,
                   input_hw: Tuple[int, int] = (512, 1024),
                   orig_hw: Tuple[int, int] = (1024, 2048)):
    """Full eval (ref evaluate_model :130-133). Returns (epoch, mAP, results)."""
    out_dir = data_cfg.save_dir
    num_classes = data_cfg.num_classes
    if num_classes == -1:
        num_classes = data_mod.get_cls_num(dataset)
    eval_outputs(out_dir, eval_loader, model, epoch, decode_cfg, logger, input_hw, orig_hw)
    results = evaluate_from_json(data_cfg, epoch, out_dir, dataset, logger, num_classes,
                                 orig_hw=orig_hw)
    return epoch, results["AP"], results
