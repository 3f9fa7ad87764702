"""A tiny copy of the benchmark for CPU rehearsals: the benchmark's files in
a temporary root, with B0 configurations at 128x256 and short mixes, whose
cells run through the harness on the CPU."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import torch

from benchmark import cell as cells, harness

REPO = Path(__file__).resolve().parents[2]
LIMITS_OPEN = {"serve": {"heads_gap": 1.0, "dets_mismatch": 1.0},
               "train": {"loss_gap": 1.0, "grad_gap": 1.0, "change_gap": 1.0, "bn_gap": 1.0}}


def config(name: str, dtype: str = "float32") -> dict:
    full = json.loads((REPO / "benchmark/configs/effseg-d3-cityscapes.json").read_text())
    full.update(name=name, compound_coef=0, backbone="efficientnet-b0", fpn_filters=64,
                fpn_repeats=3, box_class_repeats=3, compute_dtype=dtype,
                input_hw=[128, 256], orig_hw=[256, 512], decode={"kp_th": 2000},
                train={"optimizer": "Adam", "lr": 2e-5, "max_instances": 8, "max_points": 64})
    return full


def make_root(tmp: Path, dtype: str = "float32", limits=LIMITS_OPEN) -> Path:
    """A checkout-like root in ``tmp``: ``BENCHMARK.json`` with the cells
    ``tiny-serve`` and ``tiny-train`` (B0, 128x256, CPU-sized mixes) and the
    benchmark's files beside them."""
    shutil.copytree(REPO / "benchmark", tmp / "benchmark",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    base = tmp / "benchmark"
    (base / "configs/tiny.json").write_text(json.dumps(config("tiny", dtype)))
    (base / "traffic/tiny-serve.json").write_text(json.dumps(
        {"kind": "serve_closed", "batch": 1, "pool": 2, "warmup": 1, "checked": 2, "traced": 2}))
    (base / "traffic/tiny-train.json").write_text(json.dumps(
        {"kind": "train_resident", "batch": 2, "instances": 3, "batches": 4, "warmup": 0,
         "traced": 1}))
    for kind in ("serve", "train"):
        (base / f"workloads/tiny-{kind}.json").write_text(json.dumps({"limits": limits[kind]}))
    bench["configs"].append({"name": "tiny", "source": "tiny", "file": "benchmark/configs/tiny.json",
                             "reduced": [], "why": "CPU rehearsal"})
    bench["workloads"] += [
        {"name": f"tiny-{kind}", "config": "tiny", "traffic": f"tiny-{kind}", "chips": 1,
         "why": "CPU rehearsal"} for kind in ("serve", "train")]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            kind = "serve" if any("serve" in w for w in m["workloads"]) else "train"
            m["workloads"].append(f"tiny-{kind}")
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


def run(root: Path, name: str, seed: int = 2 ** 33 + 17, trace: bool = False,
        control: bool = False, seconds: float = 0.5) -> dict:
    import time
    cell = cells.load(root, name)
    return harness.run(cell, seed, seconds, trace, torch.device("cpu"), time.perf_counter(),
                       control=control)
