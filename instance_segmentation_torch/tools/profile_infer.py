"""Serving split: eval forward | decode | composed, at each batch size.

Counterpart of the JAX package's ``tools/profile_infer.py``. For each batch
it times, on seeded untrained weights and seeded uint8 frames, the model's
eval forward, the decode of its outputs and the two composed
(``forward_and_decode``: what ``serve.Predictor`` runs eagerly, without its
CUDA graphs), each call between
two synchronisations of the device: the median and the highest percentile
the sample supports, and img/s at the composed median. One composed request
under ``torch.profiler`` gives the device kernels and launches per request
and the device's busy time, also as a share of the untraced composed
median; K1's launches are counted over every decode.

    python -m instance_segmentation_torch.tools.profile_infer [--batches 1 8] \\
        [--compound 3] [--hw 512 1024] [--iters 30] [--quant none|int8] \\
        [--topk exact|approx] [--trace DIR [--top 10]] [--device cpu]

``--trace DIR`` keeps each profiled request's chrome trace in DIR and prints
its top kernels by device time and the device's idle share of the window.
The card unless ``--device cpu``; one line per measurement, then one JSON
record.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
from typing import Optional, Sequence

import numpy as np
import torch

from instance_segmentation_torch.kernels import affinity
from instance_segmentation_torch.models import EfficientSeg, EfficientSegConfig, generate_anchors
from instance_segmentation_torch.ops.decode import DecodeConfig, decode_output, forward_and_decode
from instance_segmentation_torch.utils import profiling
from instance_segmentation_torch.weights import init_random


def run(batches=(1, 8), compound: int = 3, hw=(512, 1024), iters: int = 30,
        quant: str = "none", topk: str = "exact", device: str = "cuda",
        trace: Optional[str] = None, top: int = 10, log=print) -> dict:
    """Times every batch of ``batches``; returns the record the CLI prints."""
    dev = profiling.resolve_device(device)
    label = profiling.device_label(dev)
    H, W = hw
    cfg = EfficientSegConfig(num_classes=8, compound_coef=compound,
                             compute_dtype=torch.bfloat16, quant=quant)
    model = EfficientSeg(cfg)
    init_random(model, torch.Generator().manual_seed(0))
    model = model.to(dev).eval()
    anchors = torch.tensor(generate_anchors(H, W, pyramid_levels=cfg.pyramid_levels,
                                            anchor_scale=cfg.anchor_scale, scales=cfg.scales,
                                            ratios=cfg.ratios), device=dev)
    dcfg = DecodeConfig(exact_topk=topk == "exact")
    record = {"tool": "profile_infer", "device": label, "compound": compound, "hw": [H, W],
              "quant": quant, "topk": topk, "batches": {}}
    with tempfile.TemporaryDirectory() as tmp:     # the traces, unless --trace keeps them
        for b in batches:
            images = torch.from_numpy(np.random.default_rng(0).integers(
                0, 255, (b, H, W, 3), dtype=np.uint8)).to(dev)
            with torch.inference_mode():
                outs = model(images)
                stages = {"forward": lambda: model(images),
                          "decode": lambda: decode_output(outs, anchors, 2 * H, 2 * W, 2.0,
                                                          dcfg),
                          "composed": lambda: forward_and_decode(model, images, anchors, 2 * H,
                                                                 2 * W, 2.0, dcfg)}
                affinity.launches = 0
                times = {name: profiling.spread(profiling.synced_ms(fn, iters, dev))
                         for name, fn in stages.items()}
                decodes = 2 * (iters + 1)
                k1 = affinity.launches / decodes
                path = os.path.join(trace or tmp, f"profile_infer_b{b}_{quant}_{topk}.json")
                window = profiling.traced(stages["composed"], dev, path, top)
            img_s = 1e3 * b / times["composed"]["median"]
            # the traced request's device busy time over the untraced median
            # (the tracer slows the host, so its own window idles more)
            busy = (None if window["busy_ms"] is None
                    else window["busy_ms"] / times["composed"]["median"])
            log(f"B={b} {quant} {topk}: " + ", ".join(
                f"{name} {profiling.spread_text(s)}" for name, s in times.items())
                + f"; {img_s:.2f} img/s; device kernels per request {window['launches']} "
                f"launches of {window['kernels']} kernels, busy "
                + ("not measured" if busy is None else f"{window['busy_ms']:.3f} ms, "
                   f"{busy:.3f} of the composed median")
                + f"; K1 launches per decode {k1:g}; [{label}]", flush=True)
            if trace:
                for line in profiling.trace_lines(window, f"B={b} composed request ({path})"):
                    log(line, flush=True)
            record["batches"][str(b)] = {**times, "img_s": img_s, "k1_per_decode": k1,
                                         "launches": window["launches"],
                                         "kernels": window["kernels"],
                                         "busy_ms": window["busy_ms"],
                                         "busy_share": busy,
                                         "idle_share": window["idle_share"],
                                         "top": window["top"] if trace else []}
    return record


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 8])
    ap.add_argument("--compound", type=int, default=3)
    ap.add_argument("--hw", type=int, nargs=2, default=(512, 1024))
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--quant", default="none", choices=("none", "int8"))
    ap.add_argument("--topk", default="exact", choices=("exact", "approx"))
    ap.add_argument("--trace", default=None, help="directory for the chrome traces")
    ap.add_argument("--top", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> None:
    a = parse_args(argv)
    print(json.dumps(run(a.batches, a.compound, tuple(a.hw), a.iters, a.quant, a.topk,
                         a.device, a.trace, a.top)), flush=True)


if __name__ == "__main__":
    main()
