"""From-disk training throughput against the same step on device-resident batches.

Counterpart of the JAX package's ``tools/bench_train_data.py``: a synthetic
Cityscapes set on disk (``make_synthetic_cityscapes``, full-resolution
frames so that the host's PNG decode costs what it would) feeds the
training loader (``data.get_dataloader`` with the arguments the train
CLI's epoch trainer gives it, ``--workers`` data workers), then
``device_prefetch``, then the step trainer: EfficientSeg bf16 over float32
master weights, Adam 2e-5, M=96, V=256, P=1024. One warm-up step, then
``--steps`` timed steps from disk and as many on the last batch held on the
device, each run between two synchronisations of the device.

  --mode packed   labels packed offline and the frames cached pre-resized
                  (``preprocess_cityscapes --cache_images``), the
                  ``cityscapes_packed`` dataset;
  --mode json     PNG frames and gtFine JSON read, resized and packed on the
                  host every step (``cityscapes``).

Prints one JSON line: ``from_disk_imgs_per_sec``,
``device_resident_imgs_per_sec``, ``data_stall_frac`` (1 - from-disk over
resident), ``batch``, ``steps``, and the kernels' launches over the timed
steps. ``--data_only`` prints the host loader's rate alone
(``host_loader_imgs_per_sec``). A tool, not the benchmark.

    python -m instance_segmentation_torch.tools.bench_train_data [--mode packed|json] \\
        [--images 32] [--steps 30] [--batch 4] [--compound 3] [--workers 0] \\
        [--frame_hw 1024 2048] [--out DIR] [--data_only] [--device cpu]

The set is written once into ``--out`` (default: ``iseg_dbench`` in the
temporary directory), one frame a process at a time from the data loader's
fork server. The card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time
from typing import Optional, Sequence

import torch

from instance_segmentation_torch.configs import Configer
from instance_segmentation_torch.data import get_dataloader
from instance_segmentation_torch.data.registry import device_prefetch, worker_context
from instance_segmentation_torch.kernels import ae_terms, rasterize
from instance_segmentation_torch.models import EfficientSegConfig
from instance_segmentation_torch.tools import make_synthetic_cityscapes, preprocess_cityscapes
from instance_segmentation_torch.training.train_step import Trainer
from instance_segmentation_torch.transforms import CommonTransforms
from instance_segmentation_torch.utils import profiling

M, V, P = 96, 256, 1024
SEED = 7
TRANS = {"train_trans": {"trans_seq": ["resize"], "resize": {"target_size": 2}},
         "val_trans": {"trans_seq": ["resize"], "resize": {"target_size": 2}},
         "normalize": {"div_value": 255.0, "mean": [0.485, 0.456, 0.406],
                       "std": [0.229, 0.224, 0.225]}}
COUNTERS = ((rasterize, "rasterize_cnt_r2"), (rasterize, "rasterize_nmap"),
            (ae_terms, "ae_terms_fwd"), (ae_terms, "ae_terms_bwd"))


def write_set(root: str, images: int, frame_hw, procs: int) -> None:
    """``images`` train frames of ``frame_hw`` with 8-16 instances each,
    frame i from generator seed ``SEED * 1000 + i`` (the same set whatever
    ``procs``), ``procs`` frames at a time."""
    h, w = frame_hw
    jobs = [(os.path.join(root, "parts", f"{i:06d}"), (("train", 1),), h, w, SEED * 1000 + i,
             (8, 16)) for i in range(images)]
    if procs > 1:
        with worker_context().Pool(procs) as pool:
            pool.starmap(make_synthetic_cityscapes.generate, jobs)
    else:
        for job in jobs:
            make_synthetic_cityscapes.generate(*job)
    for i, (part, *_) in enumerate(jobs):
        for kind, suffix in (("leftImg8bit", "_leftImg8bit.png"),
                             ("gtFine", "_gtFine_polygons.json")):
            dst = os.path.join(root, kind, "train", "synth")
            os.makedirs(dst, exist_ok=True)
            os.rename(os.path.join(part, kind, "train", "synth", f"synth_000000_000019{suffix}"),
                      os.path.join(dst, f"synth_{i:06d}_000019{suffix}"))
    shutil.rmtree(os.path.join(root, "parts"))


def make_loader(mode: str, root: str, batch: int, workers: int, seed: int = 0):
    """The training loader of ``mode`` on ``root``, built as the epoch
    trainer builds it (``training/trainer.py:make_loaders``)."""
    dataset = "cityscapes_packed" if mode == "packed" else "cityscapes"
    return get_dataloader(batch, dataset, root, "train",
                          transforms=CommonTransforms(Configer(TRANS), "train", seed=seed),
                          max_instances=M, max_verts=V, seed=seed, num_workers=workers)


def prepare(mode: str, out: str, images: int, frame_hw, procs: int) -> str:
    """The data root under ``out``: the set written if missing, and for
    ``packed`` its labels packed and frames cached. Returns the root."""
    root = os.path.join(out, "data")
    if not os.path.isdir(os.path.join(root, "gtFine")):
        write_set(root, images, frame_hw, procs)
    packed_dir = os.path.join(root, "packed", "train")
    if mode == "packed" and not os.path.isdir(packed_dir):
        preprocess_cityscapes.preprocess(root, "train", packed_dir, target_size=2,
                                         max_instances=M, max_verts=V, workers=procs,
                                         cache_images=True)
    return root


def launches() -> dict:
    return {name: module.launches[name] for module, name in COUNTERS}


def run(mode: str = "packed", images: int = 32, steps: int = 30, batch: int = 4,
        compound: int = 3, out: Optional[str] = None, data_only: bool = False,
        workers: int = 0, frame_hw=(1024, 2048), device: str = "cuda",
        procs: Optional[int] = None) -> dict:
    """Returns the record the CLI prints."""
    dev = profiling.resolve_device(device)
    label = profiling.device_label(dev)
    out = out or os.path.join(tempfile.gettempdir(), "iseg_dbench")
    procs = procs or min(8, os.cpu_count() or 1)
    root = prepare(mode, out, images, frame_hw, procs)
    loader = make_loader(mode, root, batch, workers)
    if len(loader) == 0:
        raise ValueError(f"{images} images make no batch of {batch}")
    if data_only:
        # the host loader's rate alone (no device work): the data side's
        # bound on any from-disk train throughput
        n, t0 = 0, time.perf_counter()
        while n < steps * batch:
            for images_b, _, _ in loader:
                n += images_b.shape[0]
                if n >= steps * batch:
                    break
        dt = time.perf_counter() - t0
        loader.close()
        return {"mode": mode, "data_only": True, "host_loader_imgs_per_sec": n / dt,
                "batch": batch, "images_seen": n, "workers": workers, "device": label}

    h, w = frame_hw[0] // 2, frame_hw[1] // 2
    trainer = Trainer(EfficientSegConfig(num_classes=8, compound_coef=compound,
                                         compute_dtype=torch.bfloat16),
                      torch.Generator().manual_seed(0), (h, w), max_points=P, lr=2e-5,
                      device=dev)
    done, last, counts0, t0 = -1, None, None, None
    while done < steps:                      # epochs until the warm-up and the timed steps
        for images_b, packed_b, _ in device_prefetch(loader, dev):
            trainer.step(images_b, packed_b.polys, packed_b.n_verts, packed_b.cls_ids)
            last = (images_b, packed_b)
            done += 1
            if done == 0:                    # the warm-up step: the clock starts after it
                profiling.sync(dev)
                counts0, t0 = launches(), time.perf_counter()
            if done >= steps:
                break
    profiling.sync(dev)
    ips = steps * batch / (time.perf_counter() - t0)
    counts = {k: v - counts0[k] for k, v in launches().items()}
    loader.close()

    images_b, packed_b = last                # the same step on the last batch, held on the device
    profiling.sync(dev)
    t1 = time.perf_counter()
    for _ in range(steps):
        stats = trainer.step(images_b, packed_b.polys, packed_b.n_verts, packed_b.cls_ids)
    profiling.sync(dev)
    ips_resident = steps * batch / (time.perf_counter() - t1)
    return {"mode": mode, "from_disk_imgs_per_sec": ips,
            "device_resident_imgs_per_sec": ips_resident,
            "data_stall_frac": max(0.0, 1.0 - ips / ips_resident), "batch": batch,
            "steps": steps, "workers": workers, "launches": counts,
            "total_loss": float(stats["total_loss"]), "device": label}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=("packed", "json"), default="packed")
    ap.add_argument("--images", type=int, default=32)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--compound", type=int, default=3)
    ap.add_argument("--workers", type=int, default=0, help="data worker processes (0: a "
                    "prefetch thread)")
    ap.add_argument("--frame_hw", type=int, nargs=2, default=(1024, 2048),
                    help="the frames' size on disk (the model input is half of it)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--data_only", action="store_true",
                    help="measure the host loader rate only (no device work)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> None:
    a = parse_args(argv)
    print(json.dumps(run(a.mode, a.images, a.steps, a.batch, a.compound, a.out, a.data_only,
                         a.workers, tuple(a.frame_hw), a.device)), flush=True)


if __name__ == "__main__":
    main()
