"""The numbers that decide ``correct``, each held to the cell's limit.

A cell's ``workloads/<cell>.json`` names the numbers compared and their
limits; the drivers compute more, which are printed as not compared.
Serving (``traffic/serve_closed.py``): each of the model's five heads
against the reference's forward of the same frames (``rel_l2``), over the
gap of the reference computed at the configuration's stated precision
(``heads_excess``), and the detections against the reference's decode of
its own heads at the stated precision (``dets_mismatch``). Training
(``traffic/train_resident.py``): the first three steps' losses, the first
gradient, the weights' and the batch-norm statistics' change over three
steps, against the reference's three steps from the same weights and
batches, at the stated precision (``stated_*``) and in float32; a tree is
judged by its worst or its median leaf (``tree_gaps``).
"""

from __future__ import annotations

import contextlib
import statistics
import sys
from typing import Dict, Iterable, Mapping, Optional

import torch

# a leaf whose reference gradient is under this share of the median leaf's
# moves under Adam by round-off alone: it is left out of the change
STILL_LEAF = 1e-3


@contextlib.contextmanager
def float32_exact():
    """TF32 off for the reference's float32 products, restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def rel_l2(value: torch.Tensor, ref: torch.Tensor) -> float:
    """||value - ref|| / ||ref||, in float64."""
    value, ref = value.double(), ref.double().to(value.device)
    return float(torch.linalg.vector_norm(value - ref) / torch.linalg.vector_norm(ref))


def norms(tree: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tree.items()}


def leaf_gaps(value: Mapping[str, float], ref: Mapping[str, float],
              keys: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Each leaf's gap between two trees' norms, |value - ref|, over the
    larger of the reference's norm of that leaf and of the median leaf."""
    keys = sorted(ref if keys is None else keys)
    median = statistics.median(ref[k] for k in keys)
    return {k: abs(value[k] - ref[k]) / max(ref[k], median) for k in keys}


def tree_gaps(value: Mapping[str, float], ref: Mapping[str, float], label: str,
              keys: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """``{label}_gap``: the worst leaf's ``leaf_gaps``, and
    ``{label}_gap_median``: the median leaf's. The three worst leaves (gap,
    the two norms and the median leaf's reference norm) are printed."""
    gaps = leaf_gaps(value, ref, keys)
    median = statistics.median(ref[k] for k in gaps)
    for k in sorted(gaps, key=gaps.get, reverse=True)[:3]:
        print(f"{label} leaf {k} gap {gaps[k]:.4g} norms {value[k]:.4g} ref {ref[k]:.4g} "
              f"median {median:.4g}", flush=True)
    return {f"{label}_gap": max(gaps.values()),
            f"{label}_gap_median": statistics.median(gaps.values())}


def moving_leaves(ref_grad_norms: Mapping[str, float]) -> list:
    """The leaves whose reference gradient is at least ``STILL_LEAF`` of the
    median leaf's."""
    median = statistics.median(ref_grad_norms.values())
    return [k for k, g in ref_grad_norms.items() if g >= STILL_LEAF * median]


def dets_mismatch(dets, ref) -> int:
    """Detection slots [B, D] of ``dets`` that differ from ``ref``: in
    validity, or in a valid slot's class, score, box, polygon validity,
    vertex count, vertices or centre."""
    ref = type(ref)(*(t.to(dets.boxes.device) for t in ref))
    close = lambda a, b, tol: ((a.float() - b.float()).abs() <= tol).flatten(2).all(-1)
    same_obj = ((dets.obj_valid == ref.obj_valid) & (dets.poly_len == ref.poly_len)
                & (~dets.obj_valid | (close(dets.polygons, ref.polygons, 1e-3)
                                      & close(dets.centers, ref.centers, 1e-3))))
    same = (dets.det_valid == ref.det_valid) & (
        ~dets.det_valid | ((dets.classes == ref.classes)
                           & ((dets.scores.float() - ref.scores.float()).abs() <= 1e-6)
                           & close(dets.boxes, ref.boxes, 1e-3) & same_obj))
    return int((~same).sum())


def verdict(numbers: Mapping[str, float], limits: Mapping[str, float]) -> Dict:
    """{name: {"value", "limit"}} of every number compared (those the cell's
    limits name), printed to standard error as the run's last lines;
    ``correct`` is whether each is within its limit (a number that is
    missing or not finite fails). The numbers not compared are printed to
    standard output."""
    for name in sorted(set(numbers) - set(limits)):
        print(f"not compared {name} {numbers[name]}", flush=True)
    out = {}
    for name in sorted(limits):
        value = numbers.get(name)
        out[name] = {"value": value, "limit": limits[name]}
        print(f"compared {name} {value} limit {limits[name]}", file=sys.stderr)
    return out


def within(compared: Mapping[str, Mapping]) -> bool:
    return all(c["value"] is not None and c["value"] == c["value"]
               and c["value"] <= c["limit"] for c in compared.values())
