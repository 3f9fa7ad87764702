"""Decode stage by stage: forward | boxes+NMS | peak top-k | group | assembly | full.

Counterpart of the JAX package's ``tools/profile_decode.py``. On seeded
untrained weights and seeded uint8 frames, each stage of
``ops/decode.decode_output`` runs alone on the materialised outputs of the
stage before it, each call between two synchronisations of the device:
the model's eval forward, ``decode_boxes`` (with the host reads that
``leader_nms``'s loop makes on the CPU, one a sweep, counted: 0 on the
card, where NMS is one kernel, ``kernels/nms.py``), ``select_peaks_batch``
(``--topk exact``: the bisection, ``approx``: the value-ordered top-k; the
JAX tool reads ``ISEG_BENCH_TOPK`` in ``bench.py``), the grouping
(``keypoint_embeddings`` and ``group_keypoints``: K1, then Lloyd steps with
``--group kmeans``), ``assemble_objects``, and the whole ``decode_output``.
The staged outputs, put together, must equal ``decode_output``'s
``Detections`` bit for bit: the tool raises if they differ.

    python -m instance_segmentation_torch.tools.profile_decode [--batch 8] \\
        [--compound 3] [--hw 512 1024] [--iters 30] [--topk exact|approx] \\
        [--group affinity|kmeans] [--trace DIR [--top 10]] [--device cpu]

``--trace DIR`` writes one chrome trace of the whole decode to DIR and
prints its top kernels by device time and the device's idle share. The
card unless ``--device cpu``; one line per stage, then one JSON record.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
from typing import Optional, Sequence

import numpy as np
import torch

from instance_segmentation_torch.kernels import affinity
from instance_segmentation_torch.models import EfficientSeg, EfficientSegConfig, generate_anchors
from instance_segmentation_torch.ops import decode
from instance_segmentation_torch.utils import profiling
from instance_segmentation_torch.weights import init_random


@contextlib.contextmanager
def counted_nms_reads():
    """While open, each evaluation of ``leader_nms``'s loop condition (one
    host read of a device value, once a sweep) adds one to the list's only
    element."""
    reads = [0]
    real = decode._nms_unsettled

    def counted(*args):
        reads[0] += 1
        return real(*args)
    decode._nms_unsettled = counted
    try:
        yield reads
    finally:
        decode._nms_unsettled = real


def check_equal(staged: decode.Detections, full: decode.Detections) -> None:
    """Raise unless every field of the staged decode equals the full one's
    bit for bit (dtype, shape and values)."""
    for name, s, f in zip(full._fields, staged, full):
        if s.dtype != f.dtype or s.shape != f.shape or not torch.equal(s, f):
            raise AssertionError(f"the staged decode's {name} differs from decode_output's")


def run(batch: int = 8, compound: int = 3, hw=(512, 1024), iters: int = 30,
        topk: str = "exact", group: str = "affinity", device: str = "cuda",
        trace: Optional[str] = None, top: int = 10, log=print) -> dict:
    """Times each stage; returns the record the CLI prints."""
    dev = profiling.resolve_device(device)
    label = profiling.device_label(dev)
    H, W = hw
    cfg = EfficientSegConfig(num_classes=8, compound_coef=compound, compute_dtype=torch.bfloat16)
    model = EfficientSeg(cfg)
    init_random(model, torch.Generator().manual_seed(0))
    model = model.to(dev).eval()
    anchors = torch.tensor(generate_anchors(H, W, pyramid_levels=cfg.pyramid_levels,
                                            anchor_scale=cfg.anchor_scale, scales=cfg.scales,
                                            ratios=cfg.ratios), device=dev)
    dcfg = decode.DecodeConfig(exact_topk=topk == "exact", group_mode=group)
    images = torch.from_numpy(np.random.default_rng(0).integers(
        0, 255, (batch, H, W, 3), dtype=np.uint8)).to(dev)

    with torch.inference_mode():
        outs = model(images)
        kp, ae, _tan, regression, classification = outs
        with counted_nms_reads() as reads:
            boxes, scores, classes, det_valid = decode.decode_boxes(
                classification, regression, anchors, H, W, dcfg)
        nms_reads = reads[0]
        flat_idx, kp_ok = decode.select_peaks_batch(kp[..., 0], dcfg.kp_th, exact=dcfg.exact_topk)

        def group_stage():
            kp_rc, emb, sig, c_emb = decode.keypoint_embeddings(flat_idx, ae, boxes, H, W)
            return kp_rc, decode.group_keypoints(kp_rc, kp_ok, emb, sig, c_emb, boxes,
                                                 det_valid, dcfg)
        kp_rc, assign = group_stage()

        def assembly():
            return decode.assemble_objects(kp_rc, kp_ok, assign, boxes, det_valid, H, W,
                                           2 * H, 2 * W, 2.0, dcfg)

        def full():
            return decode.decode_output(outs, anchors, 2 * H, 2 * W, 2.0, dcfg)
        polys, lens, centers, obj_ok = assembly()
        staged = decode.Detections(boxes, scores, classes, det_valid, polys, lens, centers,
                                   obj_ok)
        check_equal(staged, full())

        stages = {
            "forward": lambda: model(images),
            "boxes+nms": lambda: decode.decode_boxes(classification, regression, anchors, H, W,
                                                     dcfg),
            "peak_topk": lambda: decode.select_peaks_batch(kp[..., 0], dcfg.kp_th,
                                                           exact=dcfg.exact_topk),
            "group": group_stage,
            "assembly": assembly,
            "full": full,
        }
        affinity.launches = 0
        times = {name: profiling.spread(profiling.synced_ms(fn, iters, dev))
                 for name, fn in stages.items()}
        k1 = affinity.launches / (2 * (iters + 1))
        window = None
        if trace:
            window = profiling.traced(full, dev, os.path.join(
                trace, f"profile_decode_b{batch}_{topk}_{group}.json"), top)
    for name, s in times.items():
        log(f"{name:10s} {profiling.spread_text(s)}  ({s['median'] / batch:.3f} ms/img)"
            + (f"; leader_nms host reads a call {nms_reads}" if name == "boxes+nms" else "")
            + f"; [{label}]", flush=True)
    img_s = 1e3 * batch / times["full"]["median"]
    log(f"B={batch} topk {topk} group {group}: staged Detections equal decode_output's bit for "
        f"bit; decode alone {img_s:.2f} img/s; K1 launches per decode {k1:g}; detections "
        f"{int(det_valid.sum())}, objects {int(obj_ok.sum())}, peaks {int(kp_ok.sum())}; "
        f"[{label}]", flush=True)
    if window is not None:
        for line in profiling.trace_lines(window, f"B={batch} decode_output"):
            log(line, flush=True)
    return {"tool": "profile_decode", "device": label, "compound": compound, "hw": [H, W],
            "batch": batch, "topk": topk, "group": group, "stages": times, "img_s": img_s,
            "nms_host_reads": nms_reads, "k1_per_decode": k1, "staged_equal": True,
            "detections": int(det_valid.sum()), "objects": int(obj_ok.sum()),
            "peaks": int(kp_ok.sum()), "trace": window}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--compound", type=int, default=3)
    ap.add_argument("--hw", type=int, nargs=2, default=(512, 1024))
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--topk", default="exact", choices=("exact", "approx"))
    ap.add_argument("--group", default="affinity", choices=("affinity", "kmeans"))
    ap.add_argument("--trace", default=None, help="directory for the chrome trace")
    ap.add_argument("--top", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> None:
    a = parse_args(argv)
    print(json.dumps(run(a.batch, a.compound, tuple(a.hw), a.iters, a.topk, a.group,
                         a.device, a.trace, a.top)), flush=True)


if __name__ == "__main__":
    main()
