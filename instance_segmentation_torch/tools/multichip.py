"""Data-parallel training over N ranks, one process and one device each.

Counterpart of the JAX package's ``__graft_entry__.dryrun_multichip``:

    torchrun --nproc_per_node N -m instance_segmentation_torch.tools.multichip [--check]

Without ``--check``: a few steps at full width, each rank on its card
(``cuda:LOCAL_RANK``, NCCL): EfficientSeg-B3 in bf16 with float32 master
weights, 512x1024, global batch 8 (each rank its slice), M=96, P=1024, Adam
2e-5, ``training/synthetic.py``'s batch; one untimed step, then three
timed ones. Each rank prints one JSON line: its ms/step, peak device memory,
the global loss stats of the last step and its kernel launches.

With ``--check``: the N-rank step against the 1-rank step on the same
inputs, as ``dryrun_multichip`` holds the mesh step to the one-device step:
EfficientSeg-B0, 128x512, float32, global batch 4 (its last image without
labels), drop-connect 0, at P=64
(the rasterizer K2's route) and P=60 (the count map and K6). Each rank
computes the 1-rank step itself, then its share of the N-rank one, and
prints the largest relative difference of the six loss stats, the relative
L2 distance of the (averaged) gradients, of the whole tree and of each loss
term's own head, the largest difference of any gradient element over the
step's max|g|, the batch-norm running statistics' largest difference and
whether they are bitwise equal on every rank (the bounds are below); then a
checkpoint round trip: save on rank 0, restore into a fresh trainer on
every rank, and one more step against the trainer that went on.

With ``--infer [--spatial S]``: serving under a (data, spatial) mesh,
S ranks splitting the image W axis (default: every rank), the batch split
over the N / S data rows (the counterpart of the inference half of
``dryrun_multichip``):

    torchrun --nproc_per_node N -m instance_segmentation_torch.tools.multichip --infer --spatial S [--check]

Without ``--check``: EfficientSeg-B3 in bf16 at 512x1024 (a 1024x2048
frame at scale 2), seeded weights, ``DecodeConfig()``, a ``Predictor`` on
the mesh timed at global batch 1 and 8 (1 untimed call, then 5, host
clock after a device sync); then the same frames through the model on
the mesh and on this rank alone, each output's max|diff| over its max|.|
(``HEADS_REL_BF16``) and both decodes' object counts. With ``--check``:
the dry run's protocol at EfficientSeg-B0, float32, 128x256,
``max(2, N)`` frames, ``CHECK_DECODE``: the mesh's outputs against this
rank's one-rank forward of its data slice (``HEADS_REL_F32``), and the
mesh's decode against the one-rank decode: ``obj_valid`` equal, classes
equal on the valid objects, boxes within ``BOXES_ATOL``, more than 0
objects. Each rank prints one JSON line: ms per call, peak memory,
collectives per forward by kind, K1 launches and object counts.

``spawned`` runs the same from ``parallel.multihost.spawn`` (a rendezvous
file instead of torchrun's variables), saving each rank's result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from instance_segmentation_torch.device import require_cuda
from instance_segmentation_torch.kernels import ae_terms, affinity, minr2, rasterize
from instance_segmentation_torch.models import EfficientSegConfig
from instance_segmentation_torch.ops import decode
from instance_segmentation_torch.ops.decode import DecodeConfig, Detections
from instance_segmentation_torch.parallel import spatial
from instance_segmentation_torch.parallel.mesh import (
    Mesh, MeshSpec, batch_shard, data_shard, make_mesh,
)
from instance_segmentation_torch.parallel.multihost import maybe_initialize
from instance_segmentation_torch.serve import Predictor
from instance_segmentation_torch.training.synthetic import bench_train_batch, small_train_batch
from instance_segmentation_torch.training.train_step import Trainer
from instance_segmentation_torch.utils.checkpoint import CheckpointManager

RUN_DIR = Path(__file__).resolve().parents[2] / "build" / "multichip"   # gitignored
TRAIN_HW, TRAIN_M, TRAIN_P, TRAIN_ITERS = (512, 1024), 96, 1024, 3   # bench.py's train cell
CHECK_HW, CHECK_M, CHECK_BATCH = (128, 512), 8, 4
CHECK_CASES = ({"p": 64, "remat": False}, {"p": 60, "remat": False})
STAT_RTOL, BN_TOL, RESUME_RTOL = 1e-5, dict(rtol=1e-5, atol=1e-6), 1e-6
# Gradient bounds. Each loss term's own head (the parameters only that term
# reaches) within 1e-4 in relative L2. The whole gradient within 2e-2 in
# relative L2 and every element of it within 1e-2 of the step's max|g|: in
# float32 this step's gradient moves by up to 6.4e-3 in relative L2 between
# two 1-rank runs that differ only in summation order (a near-tie in a
# max-pool window flips; ~1e-5 without such a flip), and by 1.9e-3 of max|g|
# in an element (seed-0 weights, the batch's images reversed, on the CPU and
# the H100 alike), so 1e-4 and 1e-3 would fail a correct step. ``check``
# reports that floor for each run.
HEADS = ("regressor.", "classifier.", "kp_header.kp.", "kp_header.ae.", "kp_header.tan.")
HEAD_REL_L2, GRAD_LEAF_TOL, GRAD_REL_L2 = 1e-4, 1e-2, 2e-2
COUNTERS = {"rasterize_cnt_r2": rasterize.launches, "rasterize_nmap": rasterize.launches,
            "ae_terms_fwd": ae_terms.launches, "ae_terms_bwd": ae_terms.launches,
            "minr2_from_cnt": minr2.launches}

# Serving under the mesh (--infer). Full width: B3 bf16 at the 1024x2048
# serving size, batches 1 and 8, 1 untimed call and INFER_ITERS timed.
INFER_ORIG_HW, INFER_SCALE, INFER_BATCHES, INFER_ITERS = (1024, 2048), 2.0, (1, 8), 5
FULL_WIDTH = EfficientSegConfig(num_classes=8, compound_coef=3, compute_dtype=torch.bfloat16)
# The check (--infer --check): the dry run's B0 float32 protocol.
INFER_CHECK_HW = (128, 256)
CHECK_DECODE = DecodeConfig(kp_th=256, pre_nms=64, max_dets=16, max_poly=64)
BOXES_ATOL = 1e-3
# max|mesh - one rank| over max|one rank|, per output. Float32: summation
# order only (the SE sums, the convs of narrower slabs); bf16 (full width,
# the card): a few roundings of the compute dtype.
HEADS_REL_F32, HEADS_REL_BF16 = 1e-5, 3e-2
OUTPUTS = ("kp", "ae", "tan", "regression", "classification")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true",
                    help="the N-rank step against the 1-rank step (B0, 128x512, f32)")
    ap.add_argument("--infer", action="store_true",
                    help="serving under a (data, spatial) mesh instead of training")
    ap.add_argument("--spatial", type=int, default=-1,
                    help="with --infer: ranks splitting the image W axis (default: every rank)")
    ap.add_argument("--batch", type=int, default=8, help="global batch")
    ap.add_argument("--device-type", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backend", default=None, help="nccl or gloo (default: nccl on cuda)")
    return ap.parse_args(argv)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def full_width_trainer(group, device: torch.device) -> Trainer:
    """EfficientSeg-B3, bf16 compute over float32 master weights, 512x1024,
    P=1024, Adam 2e-5, seeded weights."""
    cfg = EfficientSegConfig(num_classes=8, compound_coef=3, compute_dtype=torch.bfloat16)
    return Trainer(cfg, torch.Generator().manual_seed(0), TRAIN_HW, max_points=TRAIN_P,
                   lr=2e-5, device=device, group=group)


def train(trainer: Trainer, frames, labels) -> dict:
    """One untimed step on the global batch, then ``TRAIN_ITERS`` timed
    ones; returns this rank's result record."""
    device = trainer.device
    trainer.step(frames, *labels)
    _sync(device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    for name, table in COUNTERS.items():
        table[name] = 0
    times = []
    for _ in range(TRAIN_ITERS):
        t0 = time.perf_counter()
        stats = trainer.step(frames, *labels)
        _sync(device)
        times.append(1e3 * (time.perf_counter() - t0))
    stats = {k: float(v) for k, v in stats.items()}
    group = trainer.group
    return {"rank": trainer.rank, "world": 1 if group is None else dist.get_world_size(group),
            "device": torch.cuda.get_device_name(device) if cuda else str(device),
            "global_batch": len(frames), "ms_per_step": times,
            "peak_bytes": torch.cuda.max_memory_allocated(device) if cuda else None,
            "stats": stats, "launches": {n: t[n] for n, t in COUNTERS.items()}}


def check_batch(seed: int = 0):
    """The check's global batch. Its last image has no labels, so that the
    ranks' kp positive counts differ (one rank's is 0 on 4 ranks) and a kp
    normaliser left per rank shows in the gradient."""
    frames, (polys, n_verts, cls_ids) = small_train_batch(CHECK_BATCH, CHECK_M, *CHECK_HW,
                                                          seed=seed)
    polys[-1], n_verts[-1], cls_ids[-1] = polys[-1, 0, 0], 0, -1
    return frames, (polys, n_verts, cls_ids)


def check_trainer(weights: Union[int, Mapping], p: int, remat: bool, group,
                  device: torch.device) -> Trainer:
    """The check's trainer: B0 at 128x512, float32, drop-connect 0;
    ``weights`` a seed or the JAX package's variable tree."""
    cfg = EfficientSegConfig(num_classes=8, compound_coef=0, drop_connect_rate=0.0,
                             remat=remat)
    seeded = isinstance(weights, int)
    return Trainer(cfg, torch.Generator().manual_seed(weights) if seeded else weights,
                   CHECK_HW, max_points=p, device=device, group=group)


def _bn_buffers(trainer: Trainer) -> Dict[str, torch.Tensor]:
    return {k: b.detach().cpu().clone() for k, b in trainer.model.named_buffers()
            if k.endswith(("running_mean", "running_var"))}


def step_record(trainer: Trainer, frames, labels) -> dict:
    """compute_grads on (frames, labels): the stats, every gradient and the
    batch-norm running statistics, on the CPU."""
    stats = trainer.compute_grads(frames, *labels)
    return {"stats": {k: float(v) for k, v in stats.items()},
            "grads": {k: q.grad.detach().cpu().clone()
                      for k, q in trainer.model.named_parameters()},
            "buffers": _bn_buffers(trainer)}


def rel_l2(got: Mapping[str, torch.Tensor], want: Mapping[str, torch.Tensor]) -> float:
    """|got - want| / |want| over every tensor together, in float64."""
    num = sum(float(((got[k].double() - w.double()) ** 2).sum()) for k, w in want.items())
    den = sum(float((w.double() ** 2).sum()) for w in want.values())
    return (num / max(den, 1e-300)) ** 0.5


def compare(got: dict, want: dict, group) -> dict:
    """The distances of an N-rank step record from the 1-rank one, and
    whether the batch-norm running statistics are bitwise equal on every
    rank of ``group``."""
    stat_rel = max(abs(got["stats"][k] - v) / abs(v) for k, v in want["stats"].items())
    bn_close = all(torch.allclose(got["buffers"][k], v, **BN_TOL)
                   for k, v in want["buffers"].items())
    bn_abs = max(float((got["buffers"][k] - v).abs().max()) for k, v in want["buffers"].items())
    everyone = [got["buffers"]]
    if group is not None:
        everyone = [None] * dist.get_world_size(group)
        dist.all_gather_object(everyone, got["buffers"], group=group)
    bn_equal = all(torch.equal(other[k], v) for other in everyone
                   for k, v in got["buffers"].items())
    head_rel = max(rel_l2(*({k: v for k, v in r["grads"].items() if k.startswith(head)}
                            for r in (got, want))) for head in HEADS)
    top = max(float(w.abs().max()) for w in want["grads"].values())
    leaf = max(float((got["grads"][k] - w).abs().max()) for k, w in want["grads"].items())
    return {"stat_rel": stat_rel, "head_rel_l2": head_rel, "grad_leaf_rel": leaf / top,
            "grad_rel_l2": rel_l2(got["grads"], want["grads"]), "bn_close": bn_close,
            "bn_max_abs": bn_abs, "bn_equal_across_ranks": bn_equal}


def check(group, device: torch.device, weights: Union[int, Mapping] = 0,
          cases: Sequence[Mapping] = CHECK_CASES, keep: bool = False) -> List[dict]:
    """Each case (P, remat) as an N-rank step over ``group`` against the
    1-rank step on the global batch, computed here. ``weights``: a seed or
    the JAX package's variable tree. With ``keep`` each result carries the
    N-rank step record (``"record"``).

    Each result also carries the float32 floor of its distances
    (``floor_leaf_rel``, ``floor_rel_l2``): the 1-rank step on the batch's
    images in reverse order against the 1-rank step, a change of summation
    order only."""
    frames, labels = check_batch()
    refs, floors, out = {}, {}, []
    for case in cases:
        p = case["p"]
        if p not in refs:
            refs[p] = step_record(check_trainer(weights, p, False, None, device), frames, labels)
            turned = step_record(check_trainer(weights, p, False, None, device),
                                 frames[::-1].copy(), tuple(x[::-1].copy() for x in labels))
            floor = compare(turned, refs[p], None)
            floors[p] = {"floor_leaf_rel": floor["grad_leaf_rel"],
                         "floor_rel_l2": floor["grad_rel_l2"]}
        trainer = check_trainer(weights, p, case["remat"], group, device)
        got = step_record(trainer, frames, labels)
        result = {**case, **compare(got, refs[p], group), **floors[p], "stats": got["stats"]}
        if keep:
            result["record"] = got
        out.append(result)
    return out


def check_resume(group, device: torch.device, save_dir: str, weights: Union[int, Mapping] = 0
                 ) -> dict:
    """A trainer takes a step and is saved (rank 0 writes); a fresh trainer
    (other weights) restores the file; both take one step on the same batch.
    Returns the largest relative difference of their stats, the restored
    (epoch + 1, best_ap) and the file's name."""
    frames, labels = check_batch(seed=1)
    going = check_trainer(weights, 64, False, group, device)
    going.step(frames, *labels)
    manager = CheckpointManager(save_dir)
    path = manager.save(going, epoch=2, best_ap=0.25, iter_id=7)
    manager.wait()
    other = (weights + 1) if isinstance(weights, int) else 1
    fresh = check_trainer(other, 64, False, group, device)
    start, best_ap = manager.restore_latest(fresh)
    want = {k: float(v) for k, v in going.step(frames, *labels).items()}
    got = {k: float(v) for k, v in fresh.step(frames, *labels).items()}
    return {"resume_rel": max(abs(got[k] - v) / abs(v) for k, v in want.items()),
            "start_epoch": start, "best_ap": best_ap, "file": os.path.basename(path),
            "stats": got}


def check_ok(results: Sequence[dict], resume: dict) -> List[str]:
    """What fails the bounds (empty: every case and the resume pass)."""
    bad = []
    for r in results:
        what = f"P={r['p']} remat={r['remat']}"
        if r["stat_rel"] > STAT_RTOL:
            bad.append(f"{what}: stats differ by {r['stat_rel']:.3g} > {STAT_RTOL}")
        if r["head_rel_l2"] > HEAD_REL_L2:
            bad.append(f"{what}: a head's gradient rel-L2 {r['head_rel_l2']:.3g} > {HEAD_REL_L2}")
        if r["grad_leaf_rel"] > GRAD_LEAF_TOL:
            bad.append(f"{what}: a gradient element differs by {r['grad_leaf_rel']:.3g} "
                       f"of max|g| > {GRAD_LEAF_TOL}")
        if r["grad_rel_l2"] > GRAD_REL_L2:
            bad.append(f"{what}: gradients rel-L2 {r['grad_rel_l2']:.3g} > {GRAD_REL_L2}")
        if not r["bn_close"]:
            bad.append(f"{what}: BN running stats differ by {r['bn_max_abs']:.3g}")
        if not r["bn_equal_across_ranks"]:
            bad.append(f"{what}: BN running stats differ between ranks")
    if resume["resume_rel"] > RESUME_RTOL:
        bad.append(f"resumed step differs by {resume['resume_rel']:.3g} > {RESUME_RTOL}")
    if (resume["start_epoch"], resume["best_ap"]) != (3, 0.25):
        bad.append(f"restore returned {(resume['start_epoch'], resume['best_ap'])}")
    return bad


@contextlib.contextmanager
def first_k1_inputs():
    """While open, the decode's K1 calls go through a wrapper that keeps a
    copy of the first call's inputs in the list it yields (the wrapper
    launches K1 as the decode would, and counts as it)."""
    kept = []

    def capture(*args):
        if not kept:
            kept.extend(a.clone() for a in args)
        return affinity.affinity_assign(*args)
    decode.affinity_assign = capture
    try:
        yield kept
    finally:
        decode.affinity_assign = affinity.affinity_assign


def mesh_outputs(pred: Predictor, frames: np.ndarray) -> tuple:
    """The five outputs of the predictor's model on the mesh, for this
    rank's data slice of ``frames``."""
    images = batch_shard(torch.as_tensor(frames), pred.mesh).to(pred.device)
    with spatial.sharded(pred.mesh):
        return pred.model(images)


def one_rank(pred: Predictor, frames: np.ndarray) -> Tuple[tuple, Detections]:
    """The outputs and the decode of this rank's data slice of ``frames``
    by the predictor's model on this rank alone."""
    images = data_shard(torch.as_tensor(frames), pred.mesh).to(pred.device)
    outputs = pred.model(images)
    return outputs, decode.decode_output(outputs, pred.anchors, *pred.orig_hw, pred.scale,
                                         pred.decode_cfg)


def heads_rel(got: Sequence[torch.Tensor], want: Sequence[torch.Tensor]) -> Dict[str, float]:
    """max|got - want| over max|want| for each of the five outputs."""
    return {name: float((g.float() - w.float()).abs().max() / w.float().abs().max())
            for name, g, w in zip(OUTPUTS, got, want)}


def decode_differences(got: Detections, want: Detections) -> List[str]:
    """The dry run's rule for two decodes: ``obj_valid`` equal, classes
    equal on the valid objects, boxes within ``BOXES_ATOL``, more than 0
    objects. Returns what fails (empty: equal)."""
    bad = []
    valid = want.obj_valid
    if not torch.equal(got.obj_valid, valid):
        bad.append(f"obj_valid differs at {int((got.obj_valid != valid).sum())} slots")
        return bad
    if int(valid.sum()) == 0:
        bad.append("decode equality vacuous: 0 objects decoded")
    if not torch.equal(got.classes[valid], want.classes[valid]):
        bad.append("classes differ on the valid objects")
    err = float((got.boxes[valid] - want.boxes[valid]).abs().max()) if bool(valid.any()) else 0.0
    if err > BOXES_ATOL:
        bad.append(f"boxes differ by {err:.3g} > {BOXES_ATOL}")
    return bad


def _reset_counts() -> None:
    for kind in spatial.calls:
        spatial.calls[kind] = 0
    affinity.launches = 0


def infer_check(mesh: Mesh, weights: Union[int, Mapping] = 0,
                batch: Optional[int] = None) -> dict:
    """The dry run's protocol on ``mesh`` (B0, float32, 128x256, ``batch``
    frames from ``np.random.default_rng(0)``, default ``max(2, N)``,
    ``CHECK_DECODE``): ``weights`` a seed or the JAX package's variable
    tree. Returns this rank's record: the outputs' distances from the
    one-rank forward, the decode's differences from the one-rank decode,
    its objects, the collectives of one forward, K1's launches in one call,
    the mesh's detections and K1's inputs on the gathered maps (on the
    CPU), and the failures."""
    world = mesh.data * mesh.spatial
    h, w = INFER_CHECK_HW
    batch = batch or max(2, world)
    frames = np.random.default_rng(0).integers(0, 256, (batch, h, w, 3), dtype=np.uint8)
    cfg = EfficientSegConfig(num_classes=8, compound_coef=0)
    seeded = isinstance(weights, int)
    pred = Predictor(cfg, CHECK_DECODE, torch.Generator().manual_seed(weights) if seeded
                     else weights, mesh.device, (2 * h, 2 * w), 2.0, mesh=mesh)
    with torch.inference_mode():
        want_out, want = one_rank(pred, frames)
        _reset_counts()
        with first_k1_inputs() as k1:
            dets = pred.predict(frames)
        collectives, launches = dict(spatial.calls), affinity.launches
        rel = heads_rel(mesh_outputs(pred, frames), want_out)
    bad = decode_differences(dets, want)
    bad += [f"{k} differs by {v:.3g} of max|.| > {HEADS_REL_F32}" for k, v in rel.items()
            if not v <= HEADS_REL_F32]
    if mesh.device.type == "cuda" and launches != 1:
        bad.append(f"K1 launched {launches} times for one decoded batch")
    return {"rank": mesh.rank, "mesh": [mesh.data, mesh.spatial], "frames": len(frames),
            "heads_rel": rel,
            "objects": int(dets.obj_valid.sum()), "objects_one_rank": int(want.obj_valid.sum()),
            "collectives": collectives, "k1_launches": launches,
            "dets": Detections(*(t.cpu() for t in dets)),
            "k1_inputs": [t.cpu() for t in k1], "failures": bad}


def infer_full_width(mesh: Mesh, cfg: EfficientSegConfig = FULL_WIDTH,
                     orig_hw: Tuple[int, int] = INFER_ORIG_HW,
                     batches: Sequence[int] = INFER_BATCHES) -> dict:
    """Serving ``cfg`` (EfficientSeg-B3 bf16) at ``orig_hw`` / 2 (512x1024)
    on ``mesh``: per global batch of ``batches``, the ms of each of
    ``INFER_ITERS`` ``predict`` calls after one untimed call, the peak
    device memory over them, the collectives of one forward, K1's launches,
    and the mesh's outputs and objects against this rank's one-rank forward
    and decode."""
    device = mesh.device
    pred = Predictor(cfg, DecodeConfig(), torch.Generator().manual_seed(0), device,
                     orig_hw, INFER_SCALE, mesh=mesh)
    h, w = pred.input_hw
    frames = np.random.default_rng(0).integers(0, 256, (max(batches), h, w, 3), dtype=np.uint8)
    cuda = device.type == "cuda"
    out = []
    for b in batches:
        x = frames[:b]
        pred.predict(x)
        _sync(device)
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        _reset_counts()
        times = []
        for _ in range(INFER_ITERS):
            t0 = time.perf_counter()
            dets = pred.predict(x)
            _sync(device)
            times.append(1e3 * (time.perf_counter() - t0))
        collectives = {k: v // INFER_ITERS for k, v in spatial.calls.items()}
        launches = affinity.launches
        peak = torch.cuda.max_memory_allocated(device) if cuda else None
        with torch.inference_mode():
            want_out, want = one_rank(pred, x)
            rel = heads_rel(mesh_outputs(pred, x), want_out)
        out.append({"batch": b, "ms": times, "peak_bytes": peak, "collectives": collectives,
                    "k1_launches": launches, "objects": int(dets.obj_valid.sum()),
                    "objects_one_rank": int(want.obj_valid.sum()), "heads_rel": rel})
    bad = [f"b{r['batch']}: {k} differs by {v:.3g} of max|.| > {HEADS_REL_BF16}"
           for r in out for k, v in r["heads_rel"].items() if not v <= HEADS_REL_BF16]
    bad += [f"b{r['batch']}: K1 launched {r['k1_launches']} times in {INFER_ITERS} calls"
            for r in out if cuda and r["k1_launches"] != INFER_ITERS]
    return {"rank": mesh.rank, "mesh": [mesh.data, mesh.spatial],
            "device": torch.cuda.get_device_name(device) if cuda else str(device),
            "batches": out, "failures": bad}


def run(args: argparse.Namespace, device: torch.device, save_dir: str) -> dict:
    """This rank's part: the full-width steps, or the check; with
    ``--infer``, serving on the mesh at full width, or its check."""
    group = dist.group.WORLD if dist.is_initialized() else None
    world = 1 if group is None else dist.get_world_size(group)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.infer:
        mesh = make_mesh(MeshSpec(spatial=world if args.spatial < 1 else args.spatial),
                         device=device)
        return infer_check(mesh) if args.check else infer_full_width(mesh)
    if not args.check:
        frames, labels = bench_train_batch(args.batch, TRAIN_M, *TRAIN_HW)
        return train(full_width_trainer(group, device), frames, labels)
    results = check(group, device)
    resume = check_resume(group, device, save_dir)
    return {"rank": 0 if group is None else dist.get_rank(group), "world": world,
            "cases": results, "resume": resume, "failures": check_ok(results, resume)}


def spawned(rank: int, world_size: int, init_method: str, argv: Sequence[str],
            out_dir: str, one_card: bool = False) -> None:
    """Entry point of a rank started by ``parallel.multihost.spawn``: joins
    the group at ``init_method`` (on ``cuda:rank``, or with ``one_card`` on
    ``cuda:0``: gloo only, NCCL refuses two ranks on one card) and saves its
    result to ``out_dir/rank{rank}.pt``."""
    torch.set_num_threads(2)
    args = parse_args(argv)
    device = maybe_initialize(args.device_type, args.backend, init_method=init_method,
                              rank=rank, world_size=world_size,
                              local_rank=0 if one_card else rank)
    try:
        result = run(args, device, os.path.join(out_dir, "checkpoints"))
        torch.save(result, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    device = maybe_initialize(args.device_type, args.backend)
    if device is None:          # not started by torchrun: one rank
        device = require_cuda() if args.device_type == "cuda" else torch.device("cpu")
    rank = dist.get_rank() if dist.is_initialized() else 0
    RUN_DIR.mkdir(parents=True, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=RUN_DIR) if rank == 0 else None
    try:
        picked = [tmp]
        if dist.is_initialized():           # rank 0's directory for every rank
            dist.broadcast_object_list(picked, src=0)
        result = run(args, device, picked[0])
        if dist.is_initialized():
            dist.barrier()
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
        if dist.is_initialized():
            dist.destroy_process_group()
    if args.infer and args.check:
        result = {k: v for k, v in result.items() if k not in ("dets", "k1_inputs")}
    print(json.dumps(result), flush=True)
    if (args.check or args.infer) and result["failures"]:
        raise SystemExit("check failed: " + "; ".join(result["failures"]))


if __name__ == "__main__":
    main()
