#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one result line each; any failure raises and exits non-zero:
  1. device: the card's name and nvidia-smi's name and power limit;
  2. build kernel K1 (``csrc/affinity.cu``) from the sources in the checkout
     (the other kernels' ``nvcc`` runs at the same time), with what
     ``nvcc -Xptxas -v`` says of its registers, spills and shared memory;
  3. K1 against its plain PyTorch version computed on the CPU at main-path
     shapes (B=8, K=20000, D=96), with keypoints in no box, invalid
     detections and duplicate centers (exact ties), the keypoints in random
     order and in the decode's ascending pixel order; wrapper, twin (on the
     card) and kernel-alone times beside the bound; then on edge cases (NaN,
     inf and underflow in the scores, D = 1 and 1024, K not a multiple of
     the block, no box near the keypoints), in both orders;
  4. decode of a synthetic two-square scene on the card (through K1) against
     the same decode on the CPU (plain grouping);
  5. the serving slice: an EfficientSeg-B3 ``Predictor`` in bf16 at 512x1024
     (frames of a 1024x2048 image at scale 2), seeded untrained weights,
     default decode, answering 3 requests at batch 1 and 3 at batch 8; then
     K1 held and timed as in phase 3 on the inputs it got in the first b8
     call (a warm-up);
  6. build kernels K2-K6 (``csrc/rasterize.cu``, ``csrc/ae_terms.cu``), one
     ``-Xptxas -v`` line per kernel;
  7. K2, K5, K3 and K4 against their plain twins at the train cell's shapes
     (B=8, M=96, P=1024, 512x1024; bench.py's 16 octagons per image plus a
     border-clipped instance and an image with no labels): K2 bitwise, K5
     bitwise against its twin on the CPU and across two launches (and to
     rtol 1e-5 against the twin on the card), K3 to rtol 1e-5 and bitwise
     across two launches, K4 to 1e-4 of max|g| (its autograd twin at B=2);
     wrapper and twin times (CUDA events) beside each kernel's bound, K3's
     time split by device kernel, and K5's yardstick, one ``index_add_`` of
     the masked normals;
  8. the training slice: a ``Trainer`` with EfficientSeg-B3, bf16 compute and
     float32 master weights, 512x1024, batch 8, M=96, P=1024, Adam 2e-5,
     seeded untrained weights: 1 warm-up step, then 5 timed steps through
     K2-K5 with finite losses;
  9. one float32 step of EfficientSeg-B0 at 128x512, batch 2, on the card
     (kernels) against the same step on the CPU (twins), at P=64 (the
     rasterizer K2's route) and at P=60 (P % 8 != 0: the count-map route
     through K6);
 10. K6 (``csrc/rasterize.cu``, built in phase 6) against its twin, bitwise,
     at the train cell (B=8, M=96, 512x1024, the count map of phase 7's
     labels), at the full-resolution shape (B=1, M=96, P=1024, 1024x2048,
     ``fullres_batch``), on a slab with counts but no valid sample and on
     edge shapes (bands and count vectors ending raggedly, samples on the
     borders, padding only); kernel and twin times beside the bound, and
     the kernel alone with every slab padding; at 1024x2048 also K5, K3 and
     K4 against their twins on the count route's (cnt, r2), to phase 7's
     tolerances (K4's autograd twin at B=1), and the two routes to
     (cnt, r2), K2 alone against the count map then K6, timed;
 11. the full-resolution training slice through the entry point
     ``instance_segmentation_torch.tools.fullres_demo``: EfficientSeg-B3,
     bf16 with float32 master weights, 1024x2048, M=96, P=1024, Adam 2e-5,
     1 warm-up and 3 timed steps in each of five configurations (batch 1
     and 4, each with and without remat; batch 4 with ae_window (256, 512)),
     with finite losses and each configuration's launch counts: K6, K3, K4
     and K5 once a step and K2 never on the count-map route; K5 alone on
     the windowed one;
 12. the data-parallel slice through ``tools/multichip.py``'s ranks, each
     spawned (``parallel.multihost.spawn``, a rendezvous file, a timeout),
     each loading the kernels phases 2 and 6 built: (a) on every card over
     NCCL, EfficientSeg-B3 bf16 at 512x1024, global batch 8, M=96, P=1024,
     Adam 2e-5, 1 warm-up and 3 timed steps with finite global stats, K2-K5
     launched once a step on every rank, each rank's ms/step and peak memory
     beside phase 8's; (b) two ranks on the one card over gloo (CUDA
     tensors), EfficientSeg-B0 f32 at 128x512, global batch 4, drop-connect
     0, at P=64 (K2) and P=60 (the count map and K6), each against a 1-rank
     step on the card on the same inputs: the six global stats to rtol 1e-5,
     each loss term's head gradient to rel-L2 1e-4, every gradient element
     to 1e-2 of max|g| and the whole gradient to rel-L2 2e-2
     (``multichip.py`` says why; the float32 floor of both, the 1-rank step
     on the batch reversed, is printed beside them), the running statistics to rtol 1e-5
     and bitwise equal on both ranks; (c) on the same two ranks, a trainer
     saved by rank 0 and restored into a fresh trainer on both, whose next
     step's stats equal the continuing trainer's to rtol 1e-6;
 13. the evaluation slice through the entry points ``python -m
     instance_segmentation_torch.evaluate`` and ``.test`` (called
     in-process): a synthetic Cityscapes tree of 8 val frames at 1024x2048
     (``tools/make_synthetic_cityscapes.py`` of the port, rows filtered as
     libpng filters them, zlib level 6); the PNG row unfilter built here
     (``csrc/png_unfilter.c``, host code) held bit for bit against its numpy
     twin on streams of all five filter types and on the frames; host ms
     per frame for PNG decode and resize; the native
     Cityscapes AP of the ground-truth polygons (must be 1); the evaluate
     CLI at B3 bf16 512x1024 (the default eval config) at batch 2 and 8 on
     seeded weights (random batch norms, as the CPU tests') whose class bias
     is raised by 0.5, saved as a checkpoint: ms per
     batch of forward and decode (synchronised), the sweep's img/s, seconds
     of AP scoring, detections (at least one) and K1's launches (one a
     batch), and K1 held and timed as in phase 3 on the inputs it got in
     the first batch of each timed run (B=2 and B=8, K=20000, D=96);
     ``iou_matrix`` on the card against the CPU (1e-6); the test CLI
     writing one overlay per frame, each decoding to the frame's shape, and
     K1 held on its first batch's inputs.

Beside every timed wrapper (phases 3, 5, 7 and 10) ``kernel_timing.py``
gives the kernel's own device time per call (its C entry point called
again on the inputs the wrapper prepared, queued, no host gaps) and, from
a ``torch.profiler`` window, how many device kernels one call launches,
PyTorch's included.

Each path's launch counts are set to 0 just before it runs and read just
after: K1's from the serving slice, K2-K5's from the training slice, K6's
from the full-resolution slice; phase 12's ranks count their own; phase 13
counts K1 over each CLI run. The
lines before the last are a JSON record of the kernels and the
``nvidia-smi --query-gpu=name,power.limit`` line; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device it raises before
printing anything.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from instance_segmentation_torch import evaluate as evaluate_cli
from instance_segmentation_torch import test as test_cli
from instance_segmentation_torch.configs import Config, load_trans_config
from instance_segmentation_torch.data import get_dataloader
from instance_segmentation_torch.data.cityscapes import CityscapesDataset, parse_eval_label_json
from instance_segmentation_torch.device import nvidia_smi_name_power, require_cuda
from instance_segmentation_torch.evaluation import device_iou, eval_loop
from instance_segmentation_torch.kernels import ae_terms, affinity, build, minr2, rasterize
from instance_segmentation_torch.losses import losses
from instance_segmentation_torch.models import EfficientSegConfig, generate_anchors
from instance_segmentation_torch.models.layers import BatchNorm
from instance_segmentation_torch.ops import decode
from instance_segmentation_torch.ops.decode import DecodeConfig, decode_output
from instance_segmentation_torch.ops.targets import generate_targets
from instance_segmentation_torch.parallel import multihost
from instance_segmentation_torch.serve import Predictor
from instance_segmentation_torch.tools import fullres_demo, make_synthetic_cityscapes, multichip
from instance_segmentation_torch.training.synthetic import bench_train_batch, fullres_batch
from instance_segmentation_torch.training.train_step import Trainer
from instance_segmentation_torch.transforms import CommonTransforms
from instance_segmentation_torch.utils import png
from instance_segmentation_torch.utils.logger import Logger
import kernel_timing

AFFINITY_SHAPE = (8, 20000, 96)          # B, K (kp_th), D (max_dets)
TRAIN_SHAPE = (8, 96, 1024, 512, 1024)   # B, M, P, H, W: bench.py's train cell
FULLRES_SHAPE = (1, 96, 1024, 1024, 2048)  # B, M, P, H, W: tools/fullres_demo.py's defaults
FULLRES_RUNS = (("--batch", "1"), ("--batch", "1", "--remat"), ("--batch", "4"),
                ("--batch", "4", "--remat"), ("--batch", "4", "--ae-window", "256", "512"))
FULLRES_ITERS = 3
HBM_BYTES_PER_MS = 3.35e9                # H100 SXM: 3.35 TB/s
F32_OPS_PER_MS = 67e9                    # H100 SXM: 67 TFLOP/s float32 (no tensor cores)
KERNELS = ("affinity", "rasterize", "ae_terms")
HOST_HELPERS = ("png_unfilter",)          # csrc/png_unfilter.c: host code, not a kernel
EVAL_IMAGES, EVAL_HW, EVAL_BATCHES = 8, (1024, 2048), (2, 8)
EVAL_INPUT, EVAL_COMPOUND = (512, 1024), 3   # eval_cfg.yaml's input at scale 2, B3
SCENE_SQUARES = (((20, 30), (60, 70), 0), ((80, 100), (110, 150), 1))
SCENE_DECODE = DecodeConfig(kp_th=2000, pre_nms=64, max_dets=8, max_poly=512)


def synthetic_scene(h: int = 128, w: int = 192, margin: float = 0.0):
    """Model-like outputs holding two clean squares (the JAX package's decode
    test scene): kp logits 8 on the square outlines and -8 elsewhere, zero
    embedding offsets with sigma exp(5), and for each square its best-IoU
    anchor given score 0.95 and the regression onto the square grown by
    ``margin`` pixels. With margin 0 the box edges fall exactly on the outline
    pixels, so whether those pixels lie in their box turns on the last bit of
    ``exp``; a margin of half a pixel makes the scene independent of it.
    Returns ((kp, ae, tan, regression, classification), anchors) as numpy."""
    kp = np.full((1, h, w, 1), -8.0, np.float32)
    ae = np.zeros((1, h, w, 4), np.float32)
    ae[..., 2:4] = 5.0
    tan = np.zeros((1, h, w, 2), np.float32)
    for (y1, x1), (y2, x2), _ in SCENE_SQUARES:
        kp[0, y1:y2 + 1, [x1, x2], 0] = 8.0
        kp[0, [y1, y2], x1:x2 + 1, 0] = 8.0
    anchors = generate_anchors(h, w, pyramid_levels=(3, 4, 5))
    cls_prob = np.full((1, anchors.shape[0], 3), 1e-3, np.float32)
    reg = np.zeros((1, anchors.shape[0], 4), np.float32)
    ay1, ax1, ay2, ax2 = anchors[:, 0], anchors[:, 1], anchors[:, 2], anchors[:, 3]
    for (y1, x1), (y2, x2), cls in SCENE_SQUARES:
        gt = np.array([x1 - margin, y1 - margin, x2 + margin, y2 + margin], np.float32)
        iw = np.clip(np.minimum(ax2, gt[2]) - np.maximum(ax1, gt[0]), 0, None)
        ih = np.clip(np.minimum(ay2, gt[3]) - np.maximum(ay1, gt[1]), 0, None)
        inter = iw * ih
        union = (ax2 - ax1) * (ay2 - ay1) + (gt[2] - gt[0]) * (gt[3] - gt[1]) - inter
        best = int(np.argmax(inter / np.clip(union, 1e-8, None)))
        cls_prob[0, best, cls] = 0.95
        aw, ah = ax2[best] - ax1[best], ay2[best] - ay1[best]
        acx, acy = (ax1[best] + ax2[best]) / 2, (ay1[best] + ay2[best]) / 2
        gcx, gcy = (gt[0] + gt[2]) / 2, (gt[1] + gt[3]) / 2
        reg[0, best] = [(gcy - acy) / ah, (gcx - acx) / aw,
                        np.log((gt[3] - gt[1]) / ah), np.log((gt[2] - gt[0]) / aw)]
    return (kp, ae, tan, reg, cls_prob), anchors


def affinity_inputs(b: int, k: int, d: int, seed: int = 0, decode_order: bool = False):
    """Grouping inputs at decode shapes for a 512x1024 input: keypoints over
    the whole frame (many in no box), a quarter of the detections invalid,
    and centers d+d/2 duplicating d (exact ties). With ``decode_order`` the
    keypoints are unique pixels in ascending flat index, as
    ``select_peaks_batch`` returns them; else drawn in random order, where
    culling centers by the keypoints' rows cannot help. Numpy float32/bool."""
    rng = np.random.default_rng(seed)
    if decode_order:
        flat = np.sort(np.stack([rng.choice(512 * 1024, k, replace=False) for _ in range(b)]))
        kp_rc = np.stack([flat // 1024, flat % 1024], axis=-1).astype(np.float32)
    else:
        kp_rc = np.stack([rng.integers(0, 512, (b, k)), rng.integers(0, 1024, (b, k))],
                         axis=-1).astype(np.float32)
    emb = np.stack([kp_rc[..., 0] / 1023.0, kp_rc[..., 1] * (2.0 / 2047.0)], -1)
    emb = (emb + rng.normal(0.0, 0.05, (b, k, 2))).astype(np.float32)
    sig = np.exp(rng.normal(3.0, 1.0, (b, k, 2))).astype(np.float32)
    xy = np.stack([rng.uniform(0, 900, (b, d)), rng.uniform(0, 450, (b, d))], -1)
    wh = rng.uniform(20, 250, (b, d, 2))
    boxes = np.concatenate([xy, xy + wh], axis=-1).astype(np.float32)
    ctr = (boxes[..., :2] + boxes[..., 2:]) / 2
    c_emb = np.stack([ctr[..., 1] / 1023.0, ctr[..., 0] * (2.0 / 2047.0)], -1)
    c_emb = c_emb.astype(np.float32)
    det_valid = rng.uniform(size=(b, d)) > 0.25
    half = d // 2
    c_emb[:, half:2 * half] = c_emb[:, :half]
    boxes[:, half:2 * half] = boxes[:, :half]
    det_valid[:, half:2 * half] = det_valid[:, :half]
    return kp_rc, emb, sig, c_emb, boxes, det_valid


def affinity_edge_cases():
    """[(name, inputs)]: grouping inputs where NaN, inf and underflow decide
    the result, and shapes at the kernel's limits, each in decode order and
    in random order. The scores follow the JAX decode's ``dists *
    contained`` (NaN * 0 is NaN) and ``jnp.argmax`` (the first NaN wins)."""
    def contained(a):
        return affinity.contained_plain(*(torch.from_numpy(a[i]) for i in (0, 4, 5))).numpy()

    def nan_emb(a):                  # NaN everywhere: slot 0, best NaN
        inside = contained(a)[0].any(-1)
        a[1][0, np.flatnonzero(inside)[:3], 0] = np.nan
        a[1][0, np.flatnonzero(~inside)[:3], 1] = np.nan

    def inf_sig_outside(a):          # 0 * inf at center 5 only: slot 5, NaN
        out = np.flatnonzero(~contained(a)[0].any(-1))[:4]
        a[2][0, out, 0] = np.inf
        a[1][0, out, 0] = a[3][0, 5, 0]

    def zero_sig(a):                 # sig 0: score 1 in every box; inf * 0
        a[2][0, np.flatnonzero(contained(a)[0].any(-1))[:4]] = 0.0
        a[3][1, 0, 0] = 2e19         # dy^2 overflows for every center but 0
        a[1][1, :5, 0] = 2e19
        a[2][1, :5, 0] = 0.0

    def nonfinite_c_emb(a):          # invalid detections: NaN * 0 is NaN
        a[3][0, 3, 0] = np.nan
        a[5][0, 3] = False
        a[3][1, 2, 1] = np.inf
        a[5][1, 2] = False

    def underflow(a):                # contained, but every score 0: slot 0
        c = contained(a)[0]
        late = np.flatnonzero(c.any(-1) & ~c[:, 0])[:6]
        a[2][0, late] = 1e30

    def empty_lists(a):              # no box meets the keypoints' rows
        a[0][..., 0] = np.floor(a[0][..., 0] / 4)
        a[4][..., 1] = 200 + a[4][..., 1] % 100
        a[4][..., 3] = a[4][..., 1] + 50
        a[3][1, 4] = np.nan          # the NaN rule still applies

    cases = []
    for order in ("decode order", "random order"):
        def make(b, k, d, seed, edit=None):
            a = list(affinity_inputs(b, k, d, seed, decode_order=order == "decode order"))
            if edit is not None:
                edit(a)
            return tuple(a)
        cases += [
            (f"NaN embedding in and out of boxes, {order}", make(1, 300, 16, 1, nan_emb)),
            (f"sig inf with dy 0 in no box, {order}", make(1, 300, 16, 2, inf_sig_outside)),
            (f"sig 0, dy^2 overflowing, {order}", make(2, 300, 16, 3, zero_sig)),
            (f"non-finite c_emb of invalid detections, {order}",
             make(2, 300, 16, 4, nonfinite_c_emb)),
            (f"contained scores underflowing to 0, {order}", make(1, 300, 16, 5, underflow)),
            (f"D=1, K=1037, {order}", make(2, 1037, 1, 6)),
            (f"D=1024, K=3000, {order}", make(1, 3000, 1024, 7)),
            (f"every culled list empty, {order}", make(2, 2000, 16, 8, empty_lists)),
        ]
    return cases


def against_cpu_twin(assign: torch.Tensor, best: torch.Tensor, inputs) -> dict:
    """K1's (assign, best) against the plain grouping computed on the CPU:
    best to rtol 1e-6 with NaN where the twin has NaN, assign equal outside
    near ties (a row without NaN whose top score has another score within
    1e-6 of it that is not equal to it: the card's expf and the CPU's exp
    may differ in the last bit)."""
    cpu = [t.cpu() for t in inputs]
    scored = affinity.affinity_scores_plain(*cpu)
    b_p, a_p = scored.max(dim=-1)
    nan = b_p.isnan()
    top = b_p[..., None]
    runner_up = scored.masked_fill((scored == top) | scored.isnan(), -1.0).amax(-1)
    near = (b_p - runner_up <= 1e-6 * b_p) & ~nan
    a_k, b_k = assign.cpu(), best.cpu()
    mismatch = a_k != a_p.int()
    finite = ~nan & ~b_k.isnan()
    return {"mismatch": int(mismatch.sum()), "bad": int((mismatch & ~near).sum()),
            "near": int(near.sum()),
            "exact_ties": int((((scored == top).sum(-1) > 1) & (b_p > 0)).sum()),
            "best_ok": bool(torch.allclose(b_k, b_p, rtol=1e-6, atol=0.0, equal_nan=True)),
            "nan": int(nan.sum()),
            "max_abs": float((b_k - b_p)[finite].abs().max()) if bool(finite.any()) else 0.0,
            "in_no_box": int((~affinity.contained_plain(
                cpu[0], cpu[4], cpu[5]).any(-1)).sum())}


def cuda_median_ms(fn, iters: int = 20) -> float:
    """Median over ``iters`` calls of the time between CUDA events recorded
    just before and just after one call of ``fn``: the device time of its
    kernels plus the host time before its first launch (the card is idle at
    the first event)."""
    fn()
    times = []
    for _ in range(iters):
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return float(np.median(times))


def own_time(fn):
    """(device ms per call of the port's own kernels, device kernels per
    call, of which the port's): ``kernel_timing``'s measures of a wrapper."""
    ms, _ = kernel_timing.own_ms(fn)
    return (ms, *kernel_timing.kernels_per_call(fn))


def own_text(own) -> str:
    ms, total, port = own
    return (f"kernel alone {ms:.4f} ms, {total} device kernels per call ({port} the port's "
            f"own)")


def bound(n_bytes: float, n_ops: float):
    """(least time in ms, "bytes" or "operations"): the bytes over the card's
    memory rate against the float32 operations over its float32 rate."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_MS, n_ops / F32_OPS_PER_MS
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def culled_lists(kp_rc: torch.Tensor, boxes: torch.Tensor, det_valid: torch.Tensor):
    """K1's culled lists, one a warp: the valid centers whose box meets the
    bounding rectangle of 32 consecutive keypoints. Returns their mean and
    their largest length."""
    b, k = kp_rc.shape[:2]
    rc = torch.nn.functional.pad(kp_rc, (0, 0, 0, (-k) % 32), value=float("nan"))
    rc = rc.view(b, -1, 32, 2)
    placed = ~rc.isnan().any(-1, keepdim=True)
    lo = rc.masked_fill(~placed, float("inf")).amin(2)                # [B, warps, 2]
    hi = rc.masked_fill(~placed, float("-inf")).amax(2)
    kept = ((boxes[:, None, :, 1] <= hi[..., 0:1]) & (boxes[:, None, :, 3] >= lo[..., 0:1]) &
            (boxes[:, None, :, 0] <= hi[..., 1:2]) & (boxes[:, None, :, 2] >= lo[..., 1:2]) &
            det_valid[:, None, :]).sum(-1)                            # [B, warps]
    return float(kept.float().mean()), int(kept.max())


def hold_affinity(phase: int, what: str, inputs, strict: bool = True) -> dict:
    """K1 against its plain twin on the CPU, timed against the twin on the
    card and the bound, on grouping inputs at main-path shapes; prints a line
    and returns the kernel's record (launches filled in by the serving
    slice). A difference raises when ``strict``, else it is printed."""
    a_k, b_k = affinity.affinity_assign(*inputs)
    torch.cuda.synchronize()
    cmp = against_cpu_twin(a_k, b_k, inputs)
    if strict:
        check(cmp["bad"] == 0, f"K1 assign differs from the twin at {cmp['bad']} keypoints "
              f"outside near ties ({what})")
        check(cmp["best_ok"], f"K1 best off by {cmp['max_abs']} or NaN elsewhere ({what})")
    elif cmp["bad"] or not cmp["best_ok"]:
        print(f"[{phase}] K1 DIFFERS from the twin on the CPU ({what}): {cmp}", flush=True)
    ms = cuda_median_ms(lambda: affinity.affinity_assign(*inputs))
    plain_ms = cuda_median_ms(lambda: affinity.affinity_assign_plain(*inputs))
    alone = own_time(lambda: affinity.affinity_assign(*inputs))
    kp_rc, emb, sig, _, boxes, det_valid = inputs
    (b, k), d = kp_rc.shape[:2], boxes.shape[1]
    # keypoints the kernel scores against every center (see csrc/affinity.cu)
    odd = int((~(emb.isfinite().all(-1) & (sig > 0).all(-1) & sig.isfinite().all(-1))).sum())
    lists = culled_lists(kp_rc, boxes, det_valid)
    contained = int(affinity.contained_plain(kp_rc, boxes, det_valid).sum())
    valid_pairs = k * int(det_valid.sum())
    # reads row/col, embedding and sigma (24 B) and writes assign and best
    # (8 B) per keypoint, and the center table; the work the function needs:
    # a containment test (4 compares) per (keypoint, valid center) pair, and
    # per contained pair 2 sub, 4 mul, 1 add, 1 neg, 1 exp and the max (10)
    n_bytes = b * k * (24 + 8) + b * d * (8 + 16 + 1)
    bound_ms, bound_by = bound(n_bytes, 4 * valid_pairs + 10 * contained)
    # the earlier bound: 14 operations for every (keypoint, center) pair
    old_ms, old_by = bound(n_bytes, b * k * d * 14)
    print(f"[{phase}] K1 vs twin (CPU) B,K,D={(b, k, d)}, {what}: assign mismatches "
          f"{cmp['mismatch']} (near ties {cmp['near']}, exact ties {cmp['exact_ties']}; all "
          f"agree outside near ties), keypoints in no box {cmp['in_no_box']}, {contained} "
          f"contained pairs of {valid_pairs} valid, centers kept a warp: mean "
          f"{lists[0]:.1f}, max {lists[1]} of {int(det_valid.sum()) / b:.1f} valid; "
          f"keypoints scored against every center {odd}, best max|err| "
          f"{cmp['max_abs']:.3g} (rtol 1e-6); wrapper {ms:.4f} ms, twin {plain_ms:.4f} ms "
          f"(median of 20), bound "
          f"{bound_ms:.4f} ms ({bound_by}; earlier bound {old_ms:.4f} ms, {old_by}), share "
          f"alone {bound_ms / alone[0]:.0%} (earlier bound {old_ms / alone[0]:.0%}); "
          f"{own_text(alone)}", flush=True)
    return {"name": "affinity_assign", "route": "cuda",
            "source": "instance_segmentation_torch/csrc/affinity.cu",
            "replaces": "instance_segmentation_tpu/ops/pallas_kernels.py:77",
            "max_abs_err": cmp["max_abs"], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "kernel_ms": alone[0], "kernels_per_call": alone[1]}


def hold_affinity_edge_cases(dev: torch.device, strict: bool = True) -> None:
    """K1 against its twin on the CPU on ``affinity_edge_cases``: assign
    equal outside near ties, best to rtol 1e-6 and NaN where the twin's is.
    Prints a line per case; a difference raises when ``strict``."""
    for name, arrays in affinity_edge_cases():
        inputs = [torch.from_numpy(a).to(dev) for a in arrays]
        a_k, b_k = affinity.affinity_assign(*inputs)
        torch.cuda.synchronize()
        cmp = against_cpu_twin(a_k, b_k, inputs)
        ok = cmp["bad"] == 0 and cmp["best_ok"]
        if strict:
            check(ok, f"K1 differs from the twin on the CPU ({name}): {cmp}")
        print(f"[3] K1 edge case, {name}: {'equal to' if ok else 'DIFFERS from'} the twin on "
              f"the CPU (NaN best {cmp['nan']}, keypoints in no box {cmp['in_no_box']}, "
              f"assign mismatches {cmp['mismatch']}, near ties {cmp['near']})", flush=True)


def phase_affinity(dev: torch.device, strict: bool = True) -> None:
    """K1 against its twin at main-path shapes, keypoints in random order and
    in decode order, and on the edge cases."""
    for what, order in (("keypoints in random order", False),
                        ("keypoints in decode order", True)):
        inputs = [torch.from_numpy(a).to(dev)
                  for a in affinity_inputs(*AFFINITY_SHAPE, decode_order=order)]
        hold_affinity(3, what, inputs, strict)
    hold_affinity_edge_cases(dev, strict)


def phase_decode(dev: torch.device) -> None:
    """Synthetic scene: card (K1 grouping) against CPU (plain grouping)."""
    outputs, anchors = synthetic_scene(margin=0.5)
    h, w = outputs[0].shape[1:3]

    def run(device):
        outs = tuple(torch.from_numpy(o).to(device) for o in outputs)
        dets = decode_output(outs, torch.tensor(anchors, device=device),
                             2 * h, 2 * w, 2.0, SCENE_DECODE)
        return type(dets)(*(t.cpu() for t in dets))

    gpu, cpu = run(dev), run(torch.device("cpu"))
    for dets in (gpu, cpu):
        check(int(dets.obj_valid.sum()) == 2, "synthetic scene: want two objects")
        check(set(dets.classes[dets.obj_valid].tolist()) == {0, 1},
              "synthetic scene: want classes {0, 1}")
    worst = 0.0
    for name, g, c in zip(gpu._fields, gpu, cpu):
        if g.dtype.is_floating_point:
            check(torch.allclose(g, c, rtol=1e-5, atol=1e-5), f"decode field {name} differs")
            worst = max(worst, float((g - c).abs().max()))
        else:
            check(torch.equal(g, c), f"decode field {name} differs")
    print(f"[4] synthetic decode: 2 objects, classes {{0, 1}}, poly_len "
          f"{gpu.poly_len[gpu.obj_valid].tolist()}; card (K1) == cpu (plain) on int/bool "
          f"fields, floats max|diff| {worst:.3g} (tol 1e-5)", flush=True)


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


def phase_slice(dev: torch.device, smi: str):
    """B3 512x1024 bf16 Predictor: 3 requests at b1 and 3 at b8. Returns the
    number of K1 launches made by those requests and the inputs K1 got in
    the first b8 call (a warm-up)."""
    cfg = EfficientSegConfig(num_classes=8, compound_coef=3, compute_dtype=torch.bfloat16)
    dcfg = DecodeConfig()
    pred = Predictor(cfg, dcfg, torch.Generator().manual_seed(0), dev,
                     orig_hw=(1024, 2048), scale=2.0)
    frames = np.random.default_rng(0).integers(0, 256, (8, 512, 1024, 3), dtype=np.uint8)
    pred.predict(frames[:1])              # warm-up, not counted
    with first_k1_inputs() as served:     # the first b8 call's grouping inputs
        pred.predict(frames)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)

    affinity.launches = 0
    requests = [(1, frames[i:i + 1]) for i in range(3)] + [(8, frames)] * 3
    times = {1: [], 8: []}
    results = []
    for b, x in requests:
        t0 = time.perf_counter()
        dets = pred.predict(x)
        torch.cuda.synchronize()
        times[b].append(time.perf_counter() - t0)
        results.append((b, dets))
    launches = affinity.launches

    for b, dets in results:
        check(tuple(dets.boxes.shape) == (b, dcfg.max_dets, 4), "boxes shape")
        check(tuple(dets.polygons.shape) == (b, dcfg.max_dets, dcfg.max_poly, 2),
              "polygons shape")
        check(dets.poly_len.dtype == torch.int32 and dets.classes.dtype == torch.int32,
              "int32 fields")
        for name in ("boxes", "scores", "polygons", "centers"):
            check(bool(torch.isfinite(getattr(dets, name)).all()), f"{name} not finite")
    check(launches == len(requests), f"K1 launched {launches} times for {len(requests)} requests")
    peak = torch.cuda.max_memory_allocated(dev)
    n_det = [int(d.det_valid.sum()) for _, d in results]
    n_obj = [int(d.obj_valid.sum()) for _, d in results]
    for b in (1, 8):
        ms = [1e3 * t for t in times[b]]
        print(f"[5] B3 512x1024 bf16 batch {b}: ms/request {[round(t, 3) for t in ms]} "
              f"(median {np.median(ms):.3f}), img/s {1e3 * b / np.median(ms):.2f}; "
              f"[{smi}]", flush=True)
    print(f"[5] K1 launches in the 6 requests: {launches}; detections {n_det}, "
          f"objects {n_obj}; peak device memory {peak} B ({peak / 2**30:.2f} GiB); "
          f"[{smi}]", flush=True)
    return launches, served


def visited_tiles(tab: torch.Tensor, cntp: torch.Tensor, h: int, w: int):
    """(tile-instance pairs K3/K4 visit, tiles holding samples, tiles with at
    least one visited pair): the kernels' skip rule, for their byte and
    operation counts."""
    nh, nw = ae_terms.num_tiles(h, w)
    r0 = (torch.arange(nh, device=tab.device) * ae_terms.TILE_H).view(nh, 1).float()
    c0 = (torch.arange(nw, device=tab.device) * ae_terms.TILE_W).view(1, nw).float()
    t = tab[..., None, None]
    win = ((t[:, :, ae_terms.VALID] > 0) & (t[:, :, ae_terms.LT0] < r0 + ae_terms.TILE_H)
           & (t[:, :, ae_terms.RB0] > r0) & (t[:, :, ae_terms.LT1] < c0 + ae_terms.TILE_W)
           & (t[:, :, ae_terms.RB1] > c0))
    present = ae_terms.presence_dense(cntp, tab.shape[1])
    visited = win.flatten(2) | present
    return (int(visited.sum()), int(present.any(dim=1).sum()),
            int(visited.any(dim=1).sum()))


def phase_train_kernels(dev: torch.device) -> list:
    """K2, K5, K3, K4 against their twins at the train cell's shapes; returns
    their records (launches filled in by the training slice)."""
    b, m, p, h, w = TRAIN_SHAPE
    _, labels = bench_train_batch(b, m, h, w, edge_cases=True)
    t = generate_targets(*(torch.from_numpy(a).to(dev) for a in labels), h, w, max_points=p)
    live = int(t.pt_valid.any(dim=2).sum())
    records = []

    # K2
    got = rasterize.rasterize_cnt_r2(t.points, t.pt_valid, h, w)
    want = rasterize.rasterize_cnt_r2_plain(t.points, t.pt_valid, h, w)
    torch.cuda.synchronize()
    err = 0
    for name, g, x in zip(("cnt", "r2", "union"), got, want):
        check(g.dtype == x.dtype and g.shape == x.shape, f"K2 {name} dtype/shape")
        g32 = rasterize.u16_to_i32(g) if g.dtype == torch.uint16 else g.to(torch.int32)
        x32 = rasterize.u16_to_i32(x) if x.dtype == torch.uint16 else x.to(torch.int32)
        err = max(err, int((g32 - x32).abs().max()))
    check(err == 0, f"K2 differs from its twin by {err}")
    ms = cuda_median_ms(lambda: rasterize.rasterize_cnt_r2(t.points, t.pt_valid, h, w))
    plain_ms = cuda_median_ms(lambda: rasterize.rasterize_cnt_r2_plain(t.points, t.pt_valid, h, w))
    alone = own_time(lambda: rasterize.rasterize_cnt_r2(t.points, t.pt_valid, h, w))
    # reads the point list once, writes cnt (2 B), r2 (1 B) and the union;
    # its work is integer counting and min, no float32 operations
    bound_ms, bound_by = bound(b * m * p * 9 + b * m * h * w * 3 + b * h * w, 0)
    print(f"[7] K2 rasterize_cnt_r2 B,M,P,H,W={TRAIN_SHAPE} ({live} of {b * m} slots live, "
          f"{int(t.pt_valid.sum())} samples): cnt, r2, union bitwise equal to the twin; "
          f"wrapper {ms:.4f} ms, twin {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
          f"{own_text(alone)}", flush=True)
    records.append({"name": "rasterize_cnt_r2", "route": "cuda",
                    "source": "instance_segmentation_torch/csrc/rasterize.cu",
                    "replaces": "instance_segmentation_tpu/losses/rasterize_pallas.py:222",
                    "max_abs_err": float(err), "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
                    "kernel_ms": alone[0], "kernels_per_call": alone[1]})

    cnt, r2, _ = got
    return records + hold_loss_kernels(dev, 7, TRAIN_SHAPE, t, cnt, r2, [0, b - 1])


def hold_loss_kernels(dev: torch.device, phase: int, shape, t, cnt: torch.Tensor,
                      r2: torch.Tensor, sub) -> list:
    """K5, K3 and K4 against their twins at ``shape`` (B, M, P, H, W), on the
    targets ``t`` and the maps (cnt, r2) of the route the step takes there:
    K5 and K3 to rtol 1e-5, K4 to 1e-4 of max|g| (its autograd twin on the
    images ``sub``). Prints a line per kernel; returns their records
    (launches filled in by a training slice)."""
    b, m, p, h, w = shape
    where = f"B,M,P,H,W={shape}"
    records = []

    # K5: to rtol 1e-5 against the twin on the card, bitwise against the twin
    # on the CPU (both sum each pixel in (instance, sample) order) and
    # between two launches
    nk = rasterize.rasterize_nmap(t.points, t.pt_valid, t.normals, h, w)
    again = rasterize.rasterize_nmap(t.points, t.pt_valid, t.normals, h, w)
    npl = rasterize.rasterize_nmap_plain(t.points, t.pt_valid, t.normals, h, w)
    cpu = rasterize.rasterize_nmap_plain(t.points.cpu(), t.pt_valid.cpu(), t.normals.cpu(), h, w)
    torch.cuda.synchronize()
    err = max(float((a - c).abs().max()) for a, c in zip(nk, npl))
    check(all(torch.allclose(a, c, rtol=1e-5, atol=1e-5) for a, c in zip(nk, npl)),
          f"K5 differs from its twin by {err}")

    def bits(x):
        return x.view(torch.int32).cpu()
    check(all(torch.equal(bits(a), bits(c)) for a, c in zip(nk, cpu)),
          "K5 differs from its twin on the CPU in some bit")
    check(all(torch.equal(bits(a), bits(c)) for a, c in zip(nk, again)),
          "two launches of K5 differ in some bit")
    ms = cuda_median_ms(lambda: rasterize.rasterize_nmap(t.points, t.pt_valid, t.normals, h, w))
    plain_ms = cuda_median_ms(lambda: rasterize.rasterize_nmap_plain(t.points, t.pt_valid,
                                                                     t.normals, h, w))
    alone = own_time(lambda: rasterize.rasterize_nmap(t.points, t.pt_valid, t.normals, h, w))
    # the nearest single PyTorch call: one index_add_ of the masked normals
    # [N, 2] into a [B*H*W, 2] buffer at prebuilt flat indices (building the
    # indices and zeroing the buffer are left out of its time)
    flat = (torch.arange(b, device=dev).view(b, 1, 1) * (h * w)
            + t.points[..., 0].clamp(0, h - 1).long() * w
            + t.points[..., 1].clamp(0, w - 1).long())[t.pt_valid]
    nrm = t.normals[t.pt_valid].contiguous()
    buf = torch.zeros((b * h * w, 2), dtype=torch.float32, device=dev)
    library_ms = cuda_median_ms(lambda: buf.index_add_(0, flat, nrm))
    # reads pt_valid once and the point (8 B) and normal (8 B) of each valid
    # sample, writes two f32 planes; one add per channel and valid sample
    n_samples = int(t.pt_valid.sum())
    bound_ms, bound_by = bound(b * m * p + 16 * n_samples + 2 * b * h * w * 4, 2 * n_samples)
    print(f"[{phase}] K5 rasterize_nmap {where}: max|kernel - twin| {err:.3g} (rtol 1e-5, "
          f"atol 1e-5), bitwise equal to the CPU twin and across two launches; wrapper "
          f"{ms:.4f} ms, twin {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
          f"{own_text(alone)}; index_add_ {library_ms:.4f} ms", flush=True)
    records.append({"name": "rasterize_nmap", "route": "cuda",
                    "source": "instance_segmentation_torch/csrc/rasterize.cu",
                    "replaces": "instance_segmentation_tpu/losses/rasterize_pallas.py:163",
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
                    "kernel_ms": alone[0], "kernels_per_call": alone[1]})

    # K3
    xym = losses.coordinate_grid(h, w, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    planes = torch.randn((4, b, h, w), generator=gen, device=dev)
    fields = [(torch.tanh(planes[0]) + xym[..., 0]).contiguous(),
              (torch.tanh(planes[1]) + xym[..., 1]).contiguous(),
              torch.exp(planes[2]), torch.exp(planes[3])]
    tab = losses.ae_table(t, xym, h, w)
    lut = ae_terms.neg4_lut(losses._NEG4_TABLE, dev)
    cntp = ae_terms.tile_presence(t.points, t.pt_valid, h, w)
    rest = (r2, cnt, tab, lut, cntp)
    k3 = ae_terms.ae_terms_fwd(*fields, *rest)
    again = ae_terms.ae_terms_fwd(*fields, *rest)
    with torch.no_grad():
        p3 = ae_terms.ae_terms_plain(*fields, *rest)
    torch.cuda.synchronize()
    err = max(float((a - c).abs().max()) for a, c in zip(k3, p3))
    for name, a, c, a2 in zip(("pos", "neg", "npos", "pull"), k3, p3, again):
        check(torch.allclose(a, c, rtol=1e-5, atol=0.0),
              f"K3 {name} differs from its twin by {float((a - c).abs().max())}")
        check(torch.equal(bits(a), bits(a2)), f"two launches of K3 differ in {name}")
    ms = cuda_median_ms(lambda: ae_terms.ae_terms_fwd(*fields, *rest))
    with torch.no_grad():
        plain_ms = cuda_median_ms(lambda: ae_terms.ae_terms_plain(*fields, *rest))
    alone = own_time(lambda: ae_terms.ae_terms_fwd(*fields, *rest))
    split = kernel_timing.device_split(lambda: ae_terms.ae_terms_fwd(*fields, *rest))
    pairs, any_tiles, tiles = visited_tiles(tab, cntp, h, w)
    tile_px = ae_terms.TILE_H * ae_terms.TILE_W
    n_valid = int(t.inst_valid.sum()) // b
    # reads the 4 fields in the tiles with a visited pair (the others are
    # skipped whole) and 3 B per pixel of each visited (tile, instance)
    # slab; per visited pixel ~21 operations (affinity 9, clip 2, neg term 6,
    # pull 4), per pixel of a sample tile and valid center 10 (dmax)
    table_bytes = b * m * 8 * 4 + 256 * 4 + cntp.numel() * 4
    bound_ms, bound_by = bound(4 * tiles * tile_px * 4 + pairs * tile_px * 3 + table_bytes,
                               pairs * tile_px * 21 + any_tiles * tile_px * n_valid * 10)
    print(f"[{phase}] K3 ae_terms forward {where}: {pairs} (tile, instance) pairs visited of "
          f"{b * m * cntp.shape[1]}, {tiles} tiles of {b * cntp.shape[1]} visited, {any_tiles} "
          f"sample tiles; max|kernel - twin| {err:.3g} (rtol 1e-5), bitwise equal across two "
          f"launches; wrapper {ms:.4f} ms, twin {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}); {own_text(alone)}; device split "
          f"{', '.join(f'{k} {v:.4f} ms' for k, v in split.items())}", flush=True)
    records.append({"name": "ae_terms_fwd", "route": "cuda",
                    "source": "instance_segmentation_torch/csrc/ae_terms.cu",
                    "replaces": "instance_segmentation_tpu/losses/ae_pallas.py:325",
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
                    "kernel_ms": alone[0], "kernels_per_call": alone[1]})

    # K4: the kernel on images ``sub`` against the twin's autograd there;
    # through the autograd.Function too
    sub = torch.tensor(sub, device=dev)
    fields2 = [f[sub].contiguous().requires_grad_() for f in fields]
    rest2 = (r2[sub].contiguous(), cnt.view(torch.int16)[sub].view(torch.uint16),
             tab[sub].contiguous(), lut,
             cntp[sub].contiguous())
    wts = torch.randn((3, b, m), generator=gen, device=dev)
    k4 = ae_terms.ae_terms_bwd(*(f.detach() for f in fields2), *rest2, *wts[:, sub])
    pos, neg, _, pull = ae_terms.ae_terms_plain(*fields2, *rest2)
    objective = (wts[0, sub] * pos + wts[1, sub] * neg + wts[2, sub] * pull).sum()
    p4 = torch.autograd.grad(objective, fields2, retain_graph=True)
    pos, neg, _, pull = ae_terms.ae_terms(*fields2, *rest2)
    f4 = torch.autograd.grad((wts[0, sub] * pos + wts[1, sub] * neg + wts[2, sub] * pull).sum(),
                             fields2)
    torch.cuda.synchronize()
    err = max(float((a - c).abs().max()) for a, c in zip(k4, p4))
    for name, a, c, f in zip(("ey", "ex", "sy", "sx"), k4, p4, f4):
        check(float((a - c).abs().max()) <= 1e-4 * float(c.abs().max()),
              f"K4 d{name} differs from its twin by {float((a - c).abs().max())}")
        check(torch.equal(a, f), f"K4 d{name} through the autograd.Function differs")
    full = [f.detach() for f in fields]
    cot = wts.unbind(0)
    ms = cuda_median_ms(lambda: ae_terms.ae_terms_bwd(*full, *rest, *cot))
    plain_ms = cuda_median_ms(lambda: torch.autograd.grad(objective, fields2, retain_graph=True))
    alone = own_time(lambda: ae_terms.ae_terms_bwd(*full, *rest, *cot))
    # reads the 4 fields, writes 4 gradient planes, 3 B per visited slab
    # pixel; per visited pixel ~51 operations, per sample-tile pixel 10 per
    # valid center (argmax) and 21 for the argmax center's term
    bound_ms, bound_by = bound(8 * b * h * w * 4 + pairs * tile_px * 3 + table_bytes,
                               pairs * tile_px * 51 + any_tiles * tile_px * (n_valid * 10 + 21))
    print(f"[{phase}] K4 ae_terms backward {where} (images {sub.tolist()}): max|kernel - twin "
          f"autograd| {err:.3g} (<= 1e-4 max|g|), autograd.Function equal; wrapper {ms:.4f} ms "
          f"at B={b}, twin backward {plain_ms:.4f} ms at B={len(sub)}, bound {bound_ms:.4f} ms "
          f"({bound_by}); {own_text(alone)}", flush=True)
    records.append({"name": "ae_terms_bwd", "route": "cuda",
                    "source": "instance_segmentation_torch/csrc/ae_terms.cu",
                    "replaces": "instance_segmentation_tpu/losses/ae_pallas.py:366",
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "plain_batch": len(sub),
                    "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
                    "kernel_ms": alone[0], "kernels_per_call": alone[1]})
    return records


TRAIN_KERNELS = {"rasterize_cnt_r2": rasterize, "rasterize_nmap": rasterize,
                 "ae_terms_fwd": ae_terms, "ae_terms_bwd": ae_terms}


def phase_train_slice(dev: torch.device, smi: str) -> dict:
    """B3 512x1024 bf16 training, batch 8: 1 warm-up step, 5 timed steps.
    Returns the K2-K5 launch counts of the timed steps and the median
    ms/step."""
    b, m, p, h, w = TRAIN_SHAPE
    cfg = EfficientSegConfig(num_classes=8, compound_coef=3, compute_dtype=torch.bfloat16)
    trainer = Trainer(cfg, torch.Generator().manual_seed(0), (h, w), max_points=p, device=dev)
    frames, labels = bench_train_batch(b, m, h, w)
    trainer.step(frames, *labels)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for name, module in TRAIN_KERNELS.items():
        module.launches[name] = 0
    times, stats = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        s = trainer.step(frames, *labels)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        stats.append({k: float(v) for k, v in s.items()})
    counts = {name: module.launches[name] for name, module in TRAIN_KERNELS.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    for i, s in enumerate(stats):
        check(all(np.isfinite(v) for v in s.values()), f"step {i}: a loss is not finite: {s}")
        print(f"[8] step {i}: " + ", ".join(f"{k} {v:.6g}" for k, v in s.items()), flush=True)
    for name, n in counts.items():
        check(n == len(times), f"{name} launched {n} times in {len(times)} steps")
    med = float(np.median(times))
    print(f"[8] B3 512x1024 bf16 train b{b} (M={m}, P={p}, Adam 2e-5): ms/step "
          f"{[round(t, 3) for t in times]} (median {med:.3f}), img/s {1e3 * b / med:.2f}; "
          f"peak device memory {peak} B ({peak / 2**30:.2f} GiB); launches {counts}; [{smi}]",
          flush=True)
    return counts, med


def phase_train_parity(dev: torch.device) -> None:
    """One float32 B0 step at 128x512, batch 2: card (kernels) against CPU
    (twins), same seeded weights and inputs; at P=64 through K2 and at P=60
    (P % 8 != 0) through the count map and K6."""
    h, w, m = 128, 512, 8
    cfg = EfficientSegConfig(num_classes=8, compound_coef=0, drop_connect_rate=0.0)
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 256, (2, h, w, 3), dtype=np.uint8)
    polys = np.zeros((2, m, 8, 2), np.float32)
    ang = np.linspace(0, 2 * np.pi, 9)[:-1]
    for i in range(5):
        cy, cx = rng.uniform(25, h - 25), rng.uniform(60, w - 60)
        polys[0, i] = np.stack([cy + 15 * np.sin(ang), cx + 30 * np.cos(ang)], -1)
    polys[0, 5:] = polys[0, 0, 0]
    polys[1] = polys[0, ::-1]
    cls_ids = np.where(np.arange(m) < 5, np.arange(m) % 8, -1)[None].repeat(2, 0)
    cls_ids[1] = cls_ids[0, ::-1]
    labels = (polys, np.where(cls_ids >= 0, 8, 0), cls_ids)
    for p in (64, 60):
        count_route = not losses.rasterizer_supported(h, w, p)
        grads, stats = [], []
        for device in (dev, torch.device("cpu")):
            k2, k6 = rasterize.launches["rasterize_cnt_r2"], minr2.launches["minr2_from_cnt"]
            trainer = Trainer(cfg, torch.Generator().manual_seed(0), (h, w), max_points=p,
                              device=device)
            stats.append({k: float(v) for k, v in trainer.compute_grads(frames, *labels).items()})
            grads.append({k: q.grad.cpu() for k, q in trainer.model.named_parameters()})
            if device == dev:
                route = (rasterize.launches["rasterize_cnt_r2"] - k2,
                         minr2.launches["minr2_from_cnt"] - k6)
        check(route == ((0, 1) if count_route else (1, 0)),
              f"P={p}: K2, K6 launched {route} times on the card")
        for k in stats[1]:
            check(np.isclose(stats[0][k], stats[1][k], rtol=1e-4, atol=0.0),
                  f"P={p} {k}: card {stats[0][k]} vs cpu {stats[1][k]}")
        top = max(float(g.abs().max()) for g in grads[1].values())
        worst = max(float((grads[0][k] - g).abs().max()) for k, g in grads[1].items())
        check(worst <= 1e-3 * top, f"P={p}: gradients differ by {worst} (max|g| {top})")
        print(f"[9] B0 128x512 f32 step at P={p} ({'count map + K6' if count_route else 'K2'}), "
              f"card (kernels) vs cpu (twins): stats rtol 1e-4 "
              f"({', '.join(f'{k} {v:.6g}' for k, v in stats[0].items())}); gradients max|diff| "
              f"{worst:.3g} <= 1e-3 x max|g| {top:.3g}", flush=True)


def phase_minr2(dev: torch.device) -> dict:
    """K6 against its twin, bitwise, at the train cell and at full resolution,
    and on a slab with counts but has == 0; at full resolution also K5, K3
    and K4 against their twins on the count route's maps, and the two routes
    to (cnt, r2) timed. Returns K6's record (launches filled in by phase 11)."""
    cases = []
    b, m, p, h, w = TRAIN_SHAPE
    _, labels = bench_train_batch(b, m, h, w, edge_cases=True)
    cases.append(("train cell", TRAIN_SHAPE, labels))
    b, m, p, h, w = FULLRES_SHAPE
    cases.append(("full resolution", FULLRES_SHAPE, fullres_batch(b, m, h, w)[1]))
    record = None
    for name, (b, m, p, h, w), labels in cases:
        t = generate_targets(*(torch.from_numpy(a).to(dev) for a in labels), h, w, max_points=p)
        cnt = losses.ae_sample_count(t, h, w)
        has = t.pt_valid.any(dim=2)
        got = minr2.minr2_from_cnt(cnt, has)
        want = minr2.minr2_from_cnt_plain(cnt, has)
        torch.cuda.synchronize()
        err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
        check(got.dtype == torch.uint8 and err == 0, f"K6 differs from its twin by {err} ({name})")
        ms = cuda_median_ms(lambda: minr2.minr2_from_cnt(cnt, has))
        plain_ms = cuda_median_ms(lambda: minr2.minr2_from_cnt_plain(cnt, has))
        alone = own_time(lambda: minr2.minr2_from_cnt(cnt, has))
        padding = torch.zeros_like(has)
        fill_ms, _ = kernel_timing.own_ms(lambda: minr2.minr2_from_cnt(cnt, padding))
        live = int(has.sum())
        # reads the live slabs' counts (2 B/px) and has, writes r2 for every
        # slab (1 B/px); its work is integer min, no float32 operations
        bound_ms, bound_by = bound(2 * live * h * w + b * m * h * w + b * m, 0)
        print(f"[10] K6 minr2_from_cnt {name} B,M,P,H,W={(b, m, p, h, w)} ({live} of {b * m} "
              f"slabs live): bitwise equal to the twin; wrapper {ms:.4f} ms, twin "
              f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}) (median of 20); "
              f"{own_text(alone)}; alone with every slab padding {fill_ms:.4f} ms", flush=True)
        # the record keeps the last case, the full-resolution shape of phase 11
        record = {"name": "minr2_from_cnt", "route": "cuda",
                  "source": "instance_segmentation_torch/csrc/rasterize.cu",
                  "replaces": "instance_segmentation_tpu/losses/minr2_pallas.py:90",
                  "max_abs_err": float(err), "ms": ms, "plain_ms": plain_ms,
                  "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
                  "kernel_ms": alone[0], "kernels_per_call": alone[1]}

    # the full-resolution case goes on: K5, K3 and K4 on its count-route maps
    hold_loss_kernels(dev, 10, FULLRES_SHAPE, t, cnt, got, [0])

    # and a live slab marked as having no sample
    slot = int(has[0].nonzero()[0])
    check(bool(cnt.view(torch.int16)[0, slot].any()), "K6: the chosen slab holds no counts")
    has_off = has.clone()
    has_off[0, slot] = False
    got = minr2.minr2_from_cnt(cnt, has_off)
    want = minr2.minr2_from_cnt_plain(cnt, has_off)
    torch.cuda.synchronize()
    check(torch.equal(got, want) and bool((got[0, slot] == 200).all()),
          "K6: a slab with counts but has == 0 is not all 200")
    print(f"[10] K6 slab (0, {slot}) with counts but has == 0: all 200, equal to the twin",
          flush=True)
    for shape, what in minr2_edge_cases(dev):
        print(f"[10] K6 edge shape B,M,H,W={shape}, {what}: bitwise equal to the twin",
              flush=True)

    # the two routes to (cnt, r2) at 1024x2048
    def count_route():
        c = losses.ae_sample_count(t, h, w)
        return c, minr2.minr2_from_cnt(c, has)
    k2 = rasterize.rasterize_cnt_r2(t.points, t.pt_valid, h, w)
    cr = count_route()
    torch.cuda.synchronize()
    check(torch.equal(k2[0].view(torch.int16), cr[0].view(torch.int16))
          and torch.equal(k2[1], cr[1]), "K2 and the count route disagree at 1024x2048")
    k2_ms = cuda_median_ms(lambda: rasterize.rasterize_cnt_r2(t.points, t.pt_valid, h, w))
    cr_ms = cuda_median_ms(count_route)
    print(f"[10] (cnt, r2) at B,M,P,H,W={FULLRES_SHAPE}: K2 alone {k2_ms:.4f} ms, count map "
          f"+ K6 {cr_ms:.4f} ms (median of 20; the same maps bitwise)", flush=True)
    return record


def minr2_edge_cases(dev: torch.device):
    """K6 against its twin, bitwise, where its bands and vectors end
    raggedly: H not a multiple of ``minr2.BAND_H``, W a multiple of 4 (and
    of 8) but not of ``minr2.BAND_W``, samples on all four borders, a slab
    with counts but has == 0, and a batch of padding only. Returns (shape,
    what) for each case checked."""
    rng = np.random.default_rng(7)
    done = []
    for b, m, h, w in ((2, 5, 70, 260), (1, 3, 130, 200), (3, 2, 64, 132)):
        cnt = (rng.uniform(size=(b, m, h, w)) < 0.002) * rng.integers(1, 4, (b, m, h, w))
        cnt[0, 0, [0, h - 1], :] = 1                     # the top and bottom rows
        cnt[0, 0, :, [0, w - 1]] = 2                     # the left and right columns
        cnt_t = torch.from_numpy(cnt.astype(np.int16)).to(dev).view(torch.uint16)
        has = torch.from_numpy(cnt.reshape(b, m, -1).any(-1)).to(dev)
        has[-1, -1] = False                              # counts, but no valid sample
        for flags, what in ((has, f"{int(has.sum())} of {b * m} slabs live, samples on the "
                             "four borders, a slab with counts but has == 0"),
                            (torch.zeros_like(has), "every slab padding")):
            got = minr2.minr2_from_cnt(cnt_t, flags)
            want = minr2.minr2_from_cnt_plain(cnt_t, flags)
            torch.cuda.synchronize()
            check(torch.equal(got, want), f"K6 differs from its twin at B,M,H,W={(b, m, h, w)}, "
                  f"{what}")
            done.append(((b, m, h, w), what))
    return done


def phase_fullres_slice(smi: str) -> int:
    """Five full-resolution configurations through the entry point; returns
    K6's launches over them."""
    counters = {"rasterize_cnt_r2": rasterize.launches, "rasterize_nmap": rasterize.launches,
                "ae_terms_fwd": ae_terms.launches, "ae_terms_bwd": ae_terms.launches,
                "minr2_from_cnt": minr2.launches}
    k6 = 0
    for flags in FULLRES_RUNS:
        args = fullres_demo.parse_args(["--iters", str(FULLRES_ITERS), *flags])
        for name, table in counters.items():
            table[name] = 0
        gc.collect()
        out = fullres_demo.run(args)
        counts = {name: table[name] for name, table in counters.items()}
        steps = 1 + FULLRES_ITERS
        if args.ae_window:
            want = {name: steps if name == "rasterize_nmap" else 0 for name in counters}
        else:
            want = {name: 0 if name == "rasterize_cnt_r2" else steps for name in counters}
        check(counts == want, f"{flags}: launches {counts}, want {want}")
        k6 += counts["minr2_from_cnt"]
        print(f"[11] B3 1024x2048 bf16 train b{out['batch']} remat {out['remat']} ae_window "
              f"{out['ae_window']} (M=96, P=1024, Adam 2e-5): ms/step {out['step_ms']:.3f} "
              f"(mean of {FULLRES_ITERS} after 1 warm-up), img/s {out['img_per_s']:.3f}, "
              f"total_loss {out['total_loss']:.6g}; peak device memory "
              f"{out['peak_hbm_gb']:.3f} GiB of {out['hbm_limit_gb']:.3f}; launches {counts}; "
              f"[{smi}]", flush=True)
    return k6


DP_TIMEOUT = 300.0                       # seconds for each spawn


def spawn_ranks(world: int, argv, one_card: bool = False) -> list:
    """``multichip.spawned`` on ``world`` ranks; their results, rank by rank."""
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR.parent) as tmp:
        out = Path(tmp)
        multihost.spawn(multichip.spawned, world,
                        (f"file://{out}/rendezvous", list(argv), str(out), one_card),
                        timeout=DP_TIMEOUT)
        return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(world)]


def phase_data_parallel(smi: str, train_ms: float) -> None:
    """(a) B3 full width on every card over NCCL; (b) the 2-rank step on one
    card over gloo against the 1-rank step; (c) save, restore, step."""
    gc.collect()
    torch.cuda.empty_cache()
    world = torch.cuda.device_count()
    results = spawn_ranks(world, ["--device-type", "cuda", "--backend", "nccl"])
    want = {name: 0 if name == "minr2_from_cnt" else multichip.TRAIN_ITERS
            for name in multichip.COUNTERS}
    for r in results:
        check(all(np.isfinite(v) for v in r["stats"].values()),
              f"rank {r['rank']}: a loss is not finite: {r['stats']}")
        check(r["launches"] == want, f"rank {r['rank']}: launches {r['launches']}, want {want}")
        check(r["stats"] == results[0]["stats"], f"rank {r['rank']}: stats differ from rank 0's")
        med = float(np.median(r["ms_per_step"]))
        print(f"[12a] B3 512x1024 bf16 train, global batch {r['global_batch']} on {r['world']} "
              f"rank(s) over NCCL, rank {r['rank']} ({r['device']}): ms/step "
              f"{[round(t, 3) for t in r['ms_per_step']]} (median {med:.3f}; phase 8's one-card "
              f"b8 step {train_ms:.3f}), peak device memory {r['peak_bytes']} B "
              f"({r['peak_bytes'] / 2**30:.2f} GiB); launches {r['launches']}; global stats "
              + ", ".join(f"{k} {v:.6g}" for k, v in r["stats"].items()) + f"; [{smi}]",
              flush=True)
    results = spawn_ranks(2, ["--check", "--device-type", "cuda", "--backend", "gloo"],
                          one_card=True)
    for r in results:
        check(not r["failures"], f"rank {r['rank']}: {r['failures']}")
        for c in r["cases"]:
            print(f"[12b] rank {r['rank']}/2 on one card over gloo, B0 128x512 f32 global batch "
                  f"{multichip.CHECK_BATCH} at P={c['p']}, against the 1-rank step on the card: "
                  f"stats max rel {c['stat_rel']:.3g} (<= {multichip.STAT_RTOL}), head gradients "
                  f"rel-L2 {c['head_rel_l2']:.3g} (<= {multichip.HEAD_REL_L2}), largest gradient "
                  f"element difference {c['grad_leaf_rel']:.3g} of max|g| "
                  f"(<= {multichip.GRAD_LEAF_TOL}), whole gradient "
                  f"rel-L2 {c['grad_rel_l2']:.3g} (<= {multichip.GRAD_REL_L2}); float32 floor "
                  f"(1-rank step, images reversed) {c['floor_leaf_rel']:.3g} of max|g|, "
                  f"rel-L2 {c['floor_rel_l2']:.3g}; BN running stats "
                  f"max|diff| {c['bn_max_abs']:.3g} (rtol 1e-5), equal on every rank "
                  f"{c['bn_equal_across_ranks']}; [{smi}]", flush=True)
        resume = r["resume"]
        print(f"[12c] rank {r['rank']}/2: saved by rank 0 as {resume['file']}, restored "
              f"(start epoch {resume['start_epoch']}, best_ap {resume['best_ap']}); next step's "
              f"stats max rel {resume['resume_rel']:.3g} from the continuing trainer's "
              f"(<= {multichip.RESUME_RTOL})", flush=True)


def yaml_text(tree: dict, indent: str = "") -> str:
    """A nested dict of scalars and lists as YAML the port's reader takes
    (strings single-quoted, None empty)."""
    def scalar(v):
        if v is None:
            return ""
        if isinstance(v, bool):
            return "true" if v else "false"
        if isinstance(v, str):
            return "'" + v.replace("'", "''") + "'"
        if isinstance(v, (list, tuple)):
            return "[" + ", ".join(scalar(x) for x in v) + "]"
        return repr(v)
    out = ""
    for k, v in tree.items():
        if isinstance(v, dict):
            out += f"{indent}{k}:\n" + yaml_text(v, indent + "  ")
        else:
            out += f"{indent}{k}: {scalar(v)}".rstrip() + "\n"
    return out


def hold_png_unfilter(root: Path) -> None:
    """The PNG row unfilter built on this machine (``csrc/png_unfilter.c``)
    against its numpy twin, bit for bit: streams of every filter type at 1-4
    bytes a pixel (``png.filter_rows``, no OpenCV), and the synthetic tree's
    frames."""
    rng = np.random.default_rng(13)
    rows = 0
    for bpp in (1, 2, 3, 4):
        h, w = 67, 129
        y, x = np.mgrid[0:h, 0:w * bpp]
        img = ((x * 3 + y * 5) % 256 + rng.integers(0, 16, (h, w * bpp))).astype(np.uint8)
        types = rng.integers(0, 5, h)
        types[:5] = np.arange(5)
        stream = png.filter_rows(img, bpp, types).reshape(-1)
        native = png.unfilter_native(stream, h, w * bpp, bpp)
        check(np.array_equal(native, png.unfilter_numpy(stream, h, w * bpp, bpp)),
              f"PNG unfilter: C helper differs from the numpy twin at {bpp} B a pixel")
        check(np.array_equal(native, img), f"PNG unfilter: not the encoded image at {bpp} B")
        rows += h
    frames = sorted(root.rglob("*_leftImg8bit.png"))[:2]
    types = np.zeros(5, np.int64)
    for f in frames:
        stream, h, rowbytes, bpp = png.inflate(str(f))[:4]
        types += np.bincount(stream.reshape(h, -1)[:, 0], minlength=5)
        check(np.array_equal(png.unfilter_native(stream, h, rowbytes, bpp),
                             png.unfilter_numpy(stream, h, rowbytes, bpp)),
              f"PNG unfilter: C helper differs from the numpy twin on {f.name}")
    print(f"[13] PNG row unfilter (csrc/png_unfilter.c, host C) == numpy twin bit for bit on "
          f"{rows} rows of all five filter types at 1-4 B a pixel and on {len(frames)} "
          f"{EVAL_HW[0]}x{EVAL_HW[1]} frames (rows by filter type 0-4: {types.tolist()})",
          flush=True)


def timed(fn, store: list):
    """``fn`` with the time of each call, the card synchronised before and
    after it, appended to ``store``."""
    def wrapper(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        store.append(time.perf_counter() - t0)
        return out
    return wrapper


def gt_ap(root: Path, out: Path) -> dict:
    """``evaluate_from_json`` on detections made of the ground-truth polygons
    of every image (score 1): AP and AP50 must be 1."""
    dets, infos = [], []
    for label in sorted((root / "gtFine" / "val").rglob("*_gtFine_polygons.json")):
        cls_ids, polys, groups, _ = parse_eval_label_json(json.loads(label.read_text()))
        dets.append([[c, 1.0, np.asarray(p, np.float32).mean(0).tolist(),
                      np.asarray(p, np.float32).tolist()]
                     for c, p, g in zip(cls_ids, polys, groups) if not g])
        img = str(label).replace("gtFine", "leftImg8bit", 1).replace(
            "_gtFine_polygons.json", "_leftImg8bit.png")
        infos.append([img, list(EVAL_HW)])
    out.mkdir()
    (out / "0_dets.json").write_text(json.dumps(dets))
    (out / "0_infos.json").write_text(json.dumps(infos))
    return eval_loop.evaluate_from_json(Config({"eval_dir": str(root)}), 0, str(out),
                                        "cityscapes", Logger(), 8)


@torch.no_grad()
def eval_weights(model: torch.nn.Module, seed: int) -> None:
    """Seeded weights that decode instances, as the CPU tests' weights do
    (``tests/test_torch_model.random_flax_variables``): batch-norm scale and
    variance ~ U(0.5, 1.5), bias and mean ~ N(0, 0.1) over ``init_random``'s
    convolutions (whose identity batch norms decode no object at 512x1024),
    and the class logits' bias raised by 0.5."""
    g = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, BatchNorm):
            for t, draw in ((m.weight, "u"), (m.bias, "n"), (m.running_mean, "n"),
                            (m.running_var, "u")):
                t.copy_(0.5 + torch.rand(t.shape, generator=g) if draw == "u"
                        else 0.1 * torch.randn(t.shape, generator=g))
    model.classifier.header.pointwise_conv.conv.bias.add_(0.5)


def phase_eval_slice(dev: torch.device, smi: str) -> None:
    """The evaluation slice through the port's entry points: a synthetic
    Cityscapes tree of 8 val frames at 1024x2048, the ``evaluate`` CLI at B3
    bf16 512x1024 (the default eval config) at batch 2 and 8 on
    ``eval_weights``, then the ``test`` CLI."""
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR.parent) as tmp:
        base = Path(tmp)
        root = base / "cityscapes"
        t0 = time.perf_counter()
        make_synthetic_cityscapes.generate(str(root), splits=(("val", EVAL_IMAGES),),
                                           h=EVAL_HW[0], w=EVAL_HW[1], seed=0, instances=(2, 6))
        print(f"[13] synthetic Cityscapes tree: {EVAL_IMAGES} val frames at {EVAL_HW[0]}x"
              f"{EVAL_HW[1]}, 2-6 instances each, written in {time.perf_counter() - t0:.2f} s",
              flush=True)
        hold_png_unfilter(root)

        dataset = CityscapesDataset(str(root), CommonTransforms(load_trans_config(), "val"),
                                    subset="val")
        host_ms = []
        for i in range(len(dataset)):
            t0 = time.perf_counter()
            dataset[i]
            host_ms.append(1e3 * (time.perf_counter() - t0))
        inflated = png.inflate(dataset.filenames[0])[:4]
        t0 = time.perf_counter()
        png.unfilter_numpy(*inflated)
        twin_ms = 1e3 * (time.perf_counter() - t0)
        print(f"[13] host PNG decode (C unfilter) + 2x resize + labels: ms/image "
              f"{[round(t, 2) for t in host_ms]} (median {np.median(host_ms):.2f}); the numpy "
              f"unfilter twin alone {twin_ms:.1f} ms/image", flush=True)

        gt = gt_ap(root, base / "gt_dets")
        check(abs(gt["AP"] - 1.0) <= 1e-12 and gt["AP50"] == 1.0,
              f"AP of the ground-truth polygons: {gt['AP']}, AP50 {gt['AP50']}")
        print(f"[13] evaluate_from_json on the ground-truth polygons: AP {gt['AP']!r} AP50 "
              f"{gt['AP50']!r} (want 1 within 1e-12) over classes {sorted(gt['classes'])}",
              flush=True)

        weights = base / "weights"
        weights.mkdir()
        cfg = {"seed": 1, "compound_coef": EVAL_COMPOUND}
        model = evaluate_cli.seeded_model(Config(cfg), 8, torch.device("cpu"))
        eval_weights(model, seed=1)
        # saved as before epoch 0 (epoch -1), so that a restore starts at
        # epoch 0 and the sweep writes 0_dets.json
        ckpt = weights / "efficient_weights_00000000.pth"
        torch.save({"model": model.state_dict(), "epoch": -1, "best_ap": 0.0}, ckpt)
        del model

        real = {name: getattr(eval_loop, name) for name in
                ("forward_and_decode", "eval_outputs", "evaluate_from_json")}
        for batch in EVAL_BATCHES:
            for run in ("warm-up", "timed"):     # the warm-up pays the first calls' set-up
                out = base / f"eval_b{batch}_{run}"
                eval_cfg = {"data": {"eval_dir": str(root), "save_dir": str(out),
                                     "dataset": "cityscapes", "batch_size": batch,
                                     "input_size": list(EVAL_INPUT), "num_classes": -1,
                                     "subset": "val"},
                            **cfg, "weights_path": str(ckpt), "weights_dir": None,
                            "decode_cfg_path": None, "trans_cfg_path": None,
                            "tpu": {"compute_dtype": "bfloat16",
                                    "input_size": list(EVAL_INPUT)}}
                (base / f"eval_b{batch}_{run}.yaml").write_text(yaml_text(eval_cfg))
            evaluate_cli.main(["--cfg_path", str(base / f"eval_b{batch}_warm-up.yaml")])
            times = {name: [] for name in real}
            for name, fn in real.items():
                setattr(eval_loop, name, timed(fn, times[name]))
            gc.collect()
            torch.cuda.reset_peak_memory_stats(dev)
            affinity.launches = 0
            try:
                with first_k1_inputs() as grouped:
                    t0 = time.perf_counter()
                    evaluate_cli.main(["--cfg_path", str(base / f"eval_b{batch}_timed.yaml")])
                    total = time.perf_counter() - t0
            finally:
                for name, fn in real.items():
                    setattr(eval_loop, name, fn)
            launches = affinity.launches
            batches = math.ceil(EVAL_IMAGES / batch)
            check(launches == batches, f"evaluate b{batch}: K1 launched {launches} times for "
                  f"{batches} batches")
            dets = json.loads((out / "0_dets.json").read_text())
            n_det = sum(len(d) for d in dets)
            check(len(dets) == EVAL_IMAGES and n_det >= 1,
                  f"evaluate b{batch}: {n_det} detections over {len(dets)} images")
            fwd = [1e3 * t for t in times["forward_and_decode"]]
            sweep = times["eval_outputs"][0]
            print(f"[13] evaluate CLI, B3 512x1024 bf16 batch {batch} on {EVAL_IMAGES} frames "
                  f"(after a warm-up run): "
                  f"forward+decode ms/batch {[round(t, 3) for t in fwd]} (median "
                  f"{np.median(fwd):.3f}, synced); sweep {sweep:.3f} s = "
                  f"{EVAL_IMAGES / sweep:.2f} img/s (host data, device, dets JSON); AP scoring "
                  f"{times['evaluate_from_json'][0]:.3f} s; whole CLI {total:.2f} s; detections "
                  f"{n_det}; K1 launches {launches} = batches {batches}; peak device memory "
                  f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; [{smi}]", flush=True)
            hold_affinity(13, f"the evaluate CLI's first b{batch} batch", grouped)

        model = evaluate_cli.seeded_model(Config(cfg), 8, dev)
        model.load_state_dict(torch.load(ckpt, weights_only=True)["model"])
        loader = get_dataloader(2, "cityscapes", str(root), "val",
                                transforms=CommonTransforms(load_trans_config(), "val"))
        images, packed, _ = next(iter(loader))
        mc = model.cfg
        anchors = torch.tensor(generate_anchors(*EVAL_INPUT, pyramid_levels=mc.pyramid_levels,
                                                anchor_scale=mc.anchor_scale), device=dev)
        with torch.inference_mode():
            dets = decode.forward_and_decode(model, torch.from_numpy(images).to(dev), anchors,
                                             *EVAL_HW, 2.0, DecodeConfig())
        gt_polys, gt_cls = (torch.from_numpy(a) for a in (packed.polys, packed.cls_ids))
        card_ms = []
        iou = device_iou.iou_matrix(dets, gt_polys.to(dev), gt_cls.to(dev), *EVAL_HW)
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            device_iou.iou_matrix(dets, gt_polys.to(dev), gt_cls.to(dev), *EVAL_HW)
            torch.cuda.synchronize()
            card_ms.append(1e3 * (time.perf_counter() - t0))
        cpu = device_iou.iou_matrix(type(dets)(*(t.cpu() for t in dets)), gt_polys, gt_cls,
                                    *EVAL_HW)
        err = float((iou[0].cpu() - cpu[0]).abs().max())
        check(err <= 1e-6 and all(torch.equal(a.cpu(), b) for a, b in zip(iou[1:], cpu[1:])),
              f"iou_matrix: card and CPU differ by {err}")
        print(f"[13] iou_matrix (2 frames, 32 decoded x 96 GT masks at 512x1024): card == CPU "
              f"within {err:.3g} (<= 1e-6), max IoU {float(iou[0].max()):.4f}; card ms "
              f"{[round(t, 2) for t in card_ms]}", flush=True)
        del model, dets

        out = base / "test_out"
        test_cfg = {"data": {"test_dir": str(root / "leftImg8bit" / "val"), "test_image": None,
                             "save_dir": str(out), "dataset": "dir", "batch_size": 2,
                             "input_size": list(EVAL_INPUT), "num_classes": 8},
                    **cfg, "weights_path": str(ckpt), "decode_cfg_path": None,
                    "trans_cfg_path": None}
        (base / "test.yaml").write_text(yaml_text(test_cfg))
        affinity.launches = 0
        with first_k1_inputs() as grouped:
            t0 = time.perf_counter()
            test_cli.main(["--cfg_path", str(base / "test.yaml")])
            total = time.perf_counter() - t0
        launches = affinity.launches
        frames = sorted(p.name for p in (root / "leftImg8bit" / "val").rglob("*.png"))
        overlays = sorted(p.name for p in out.glob("*.png"))
        check(overlays == frames, f"test CLI wrote {overlays}, want {frames}")
        for name in overlays:
            shape = png.read_png(str(out / name)).shape
            check(shape == (*EVAL_HW, 3), f"overlay {name} decodes to {shape}")
        check(launches == math.ceil(EVAL_IMAGES / 2), f"test CLI: K1 launched {launches} times")
        print(f"[13] test CLI, B3 512x1024 bf16 batch 2: {len(overlays)} overlays, each "
              f"decoding to {EVAL_HW[0]}x{EVAL_HW[1]}x3; K1 launches {launches}; "
              f"{total:.2f} s; [{smi}]", flush=True)
        hold_affinity(13, "the test CLI's first b2 batch", grouped)


def main() -> None:
    dev = require_cuda()
    kernel_timing.hook(build)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_name_power()
    print(f"[1] device {name} (count {torch.cuda.device_count()}); nvidia-smi: {smi}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    built = build.build_all(KERNELS + HOST_HELPERS)
    lib, seconds = built["affinity"]
    build.load("affinity")
    print(f"[2] built K1 {lib.relative_to(build.BUILD_DIR.parents[1])} in "
          f"{seconds:.2f} s; ptxas: {'; '.join(build.ptxas_usage('affinity'))}", flush=True)

    phase_affinity(dev)
    phase_decode(dev)
    launches, served = phase_slice(dev, smi)
    record = hold_affinity(5, "the serving slice's first b8 call", served)
    record["launches"] = launches

    for kernel in KERNELS[1:]:
        build.load(kernel)
    print("[6] built K2-K6 " + ", ".join(
        f"{built[n][0].relative_to(build.BUILD_DIR.parents[1])} in {built[n][1]:.2f} s"
        for n in KERNELS[1:]) + " (all nvcc runs started together)", flush=True)
    for kernel in KERNELS[1:]:
        for line in build.ptxas_usage(kernel):
            print(f"[6] ptxas {kernel}.cu {line}", flush=True)
    records = phase_train_kernels(dev)
    counts, train_ms = phase_train_slice(dev, smi)
    for r in records:
        r["launches"] = counts[r["name"]]
    phase_train_parity(dev)
    k6_record = phase_minr2(dev)
    k6_record["launches"] = phase_fullres_slice(smi)
    phase_data_parallel(smi, train_ms)
    phase_eval_slice(dev, smi)

    print(json.dumps({"kernels": [record] + records + [k6_record]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
