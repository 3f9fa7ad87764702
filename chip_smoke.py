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
     the block, no box near the keypoints), in both orders; then the NMS
     kernel (``csrc/nms.cu``) against its twin (the eager fixpoint on the
     CPU) at the serving decode's B=1 and B=8, K=512, with wrapper, kernel
     alone and the eager sweeps it replaced (host clock) beside its bound;
  4. decode of a synthetic two-square scene on the card (through K1) against
     the same decode on the CPU (plain grouping);
  5. the serving slice: an EfficientSeg-B3 ``Predictor`` in bf16 at 512x1024
     (frames of a 1024x2048 image at scale 2), seeded untrained weights,
     default decode, answering 3 requests at batch 1 and 3 at batch 8: K1
     launched once a request; the NMS kernel launched by the host once a
     shape's eager request (the warm-ups) and once a capture (the shape's
     second request), and on the card once a replayed request (counted in
     a profiler window of 3 more requests of each batch size); then K1 held
     and timed as in phase 3 on the inputs it got in the first b8 call (a
     warm-up);
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
     K1 held on its first batch's inputs;
 14. the training slice through the entry point ``python -m
     instance_segmentation_torch.train`` (called in-process) on a synthetic
     Cityscapes tree of 16 train and 4 val frames at 1024x2048 (written by
     8 processes from the data loader's fork server): EfficientSeg-B3 bf16 with
     float32 master weights at 512x1024, batch 4, M=96, V=256, P=1024, Adam
     2e-5 (the JAX default train config): (a) the default transforms
     (resize, hflip, brightness) with 4 data workers, 2 epochs of 2 steps,
     checkpoints every 2 steps and every epoch, the in-loop eval in epoch 1,
     then the same run resumed to a third epoch with 1 worker (from the file
     ``restore_latest`` picks); (b) every train op (``shuffle_trans_seq``
     over flip, brightness, contrast, saturation, hue and channel
     permutation, then resize, random resize, rotation and a 1024x512 crop)
     with 4 workers, 1 epoch of 2 steps; (c) the packed path: the port's
     ``preprocess_cityscapes --cache_images``, then ``cityscapes_packed``
     with ``tpu.device_aug``, 1 epoch of 2 steps. Each run prints its
     synchronised step times, the data wait before each step and the
     data-wait share of its epochs, peak memory, its first and last loss
     lines, its checkpoints, and its launches (K2-K5 once a step, K6 never,
     K1 once an eval batch); (a) prints its AP line. K2, K5, K3 and K4 are
     held against their twins on (a)'s first step's targets and AE fields,
     and K1 on its first eval batch, as in phases 7 and 13; the warp's C
     helper against its numpy twin and the HSV pair are timed on one
     512x1024 frame, and one batch of each data path on one host thread.
 16. (run before 15) the COCO path and the modules beside it:
     (a) the JPEG codec (``csrc/jpeg_codec.c``, host code built here) on
     ``tools/jpeg_digests.py``'s seeded 480x640 and 1024x2048 frames at
     qualities 75 and 95, its bytes and decoded pixels held to the committed
     SHA-256 digests of ``cv2.imwrite``'s bytes and ``cv2.imread``'s pixels,
     encode and decode timed; (b) a synthetic COCO tree
     (``tools/make_synthetic_coco.py``: 8 train + 8 val JPEG frames at
     480x640, polygons, a crowd RLE, an RLE-only instance) whose ground
     truth, scored as predictions, has COCO AP 1; (c) the evaluate CLI on it
     (B3 bf16 512x1024, ``dataset: coco``, 80 classes, batch 8, the frames
     stretched to the input by ``random_resize`` at a fixed size, seeded
     weights with the class bias raised) with affinity and with kmeans
     grouping, each after a warm-up run: ms of forward and decode
     (synchronised), img/s, detections, the COCO results file and AP line,
     K1's launches (one a batch) and K1 held on the first batch; then the
     kmeans decode on the card against the CPU on the same model outputs
     (final labels counted, near-ties among them; each Lloyd step replayed
     on the CPU from the card's state must differ only at near-ties, its
     centre update within 1e-5); (d) the test CLI with ``draw_flag``: a JPEG
     overlay per frame decoding to its shape and three debug PNGs; (e) the
     train CLI on the tree (B3 bf16 512x1024 b4, 80 classes, 2 workers, 1
     epoch of 2 steps, the in-loop COCO eval; K2-K5 once a step, K6 never,
     K1 once an eval batch); (f) ``generate_targets(dense_kp=True)`` and
     ``kp_focal_loss`` at the train cell on the card against the CPU
     (target bitwise, loss to rtol 1e-5); (g) an EfficientSeg coef-8
     ``Predictor`` (B7 backbone, P3-P8) in bf16 at 1536x1536, seeded
     weights, 2 requests at b1 through the full decode (K1 once a request),
     ms and peak memory.
 17. (run before 15) the last modules: (a) the learning capstone through
     ``tools/overfit_demo.run`` (the JAX protocol: EfficientSeg-B0 bf16 at
     256x512 on 4 synthetic 512x1024 frames, b2, Adam 3e-4, M=16, P=512) for
     ``CAPSTONE_STEPS`` steps, then its evaluations (affinity, kmeans, int8):
     ms/step, the loss at the first and last logged steps (falling), the
     APs, and K2-K5 once a step and K1 once an eval batch; (b) the int8 path
     at B3 bf16 512x1024 b8 on seeded weights: the int32 accumulators of the
     first MBConv expand and project convs and of the U-Net input stage's
     3x3 (K = 171) equal to the CPU's bit for bit on the same int8
     operands (themselves equal), forward + decode ms int8 against bf16, and
     the largest dense-head difference; (c) ``tools/export_model`` at B3
     512x1024 b1 on the card: export seconds, artifact MB, the loaded program
     equal to the live model and to a ``Predictor`` on the same seeded
     weights, K1 once a call, ms per request program against ``Predictor``;
     (d) ``decode_centers`` on the card against the CPU on a seeded map (all
     five outputs equal); (e) ``tools/convert_polygon`` over (a)'s gtFine
     tree.
 18. (run before 15, in a process of its own so that its profiler windows
     come early in a process) the profilers of the serving and from-disk
     training paths, through their entry points, at EfficientSeg-B3 bf16
     512x1024 on seeded weights: (a) ``tools/profile_infer`` at b1 and b8,
     bf16 and int8: forward, decode and composed ms (median and highest
     supported percentile), img/s, device kernels and launches per request,
     K1 once a decode (held); (b) ``tools/profile_decode`` at b8 with the
     exact and the value-ordered top-k: each stage's ms and leader_nms's
     host reads (0: NMS is a kernel on the card), the staged Detections
     equal to ``decode_output``'s bit for bit (the tool raises otherwise),
     K1 once a decode; then the
     value-ordered top-k of the serving slice's b8 keypoint map held equal
     across its ``torch.topk`` form, a stable sort of the keys and the CPU,
     ``select_peaks_batch`` card == CPU in both modes, the forms, the
     bisection and ``torch.topk`` of the values timed in turns (CUDA events
     around a call, and the device time of 20 queued calls), K1 held against its twin on the value-ordered inputs
     of a ``Predictor`` with ``DecodeConfig(exact_topk=False)`` (as phase 5
     holds it), and phase 4's scene decoded that way, card against CPU;
     (c) ``tools/profile_infer_blocks`` and ``tools/profile_blocks`` at b8;
     (d) ``tools/bench_train_data`` at b4, packed and json, 16 frames of
     1024x2048, 4 data workers, 8 timed steps: from-disk and resident img/s,
     the stall share, K2-K5 once a step (held); (e) ``tools/profile_infer
     --trace`` at b1 as a subprocess: the top 10 kernels and the device's
     idle share of the traced request (device kernels required).
 19. (run before 15) the roofline through ``tools/roofline``, each run a
     process of its own (its profiler window early in its process), at
     EfficientSeg-B3 bf16 on seeded weights: the train step at 512x1024 b8
     (M=96, P=1024, Adam 2e-5; K2-K5), forward + decode at b8 (``--eval``;
     K1) and the full-resolution step at 1024x2048 b4 (``--fullres``; K6,
     K3-K5), 5 traced calls each: the top rows by operation (by block for
     the eval run) and the JSON line (step ms, model FLOPs, mfu, the sum of
     the joined kernels' least times against the device's busy time); each
     run must join at least 90% of its device kernel time to counted
     operations, and each kernel of its path must appear with its launches
     and the bytes ``kernels/bounds.py`` gives it.
 20. (run after 12) the spatial (image-W) mesh axis of serving through
     ``tools/multichip.py --infer``'s ranks, spawned as in phase 12: (a) two
     ranks on the one card over gloo, data 1 x spatial 2, the dry run's
     protocol (EfficientSeg-B0 f32 at 128x256, 2 frames, small decode): the
     gathered outputs within ``HEADS_REL_F32`` of each rank's one-rank
     forward, the decode equal to the one-rank decode (obj_valid, classes,
     boxes to 1e-3, more than 0 objects), K1 once a decoded batch, and K1
     held against its twin on the CPU on rank 0's gathered maps; (b) the
     same two ranks at full width, EfficientSeg-B3 bf16 at 512x1024, b1 and
     b8, 1 + 5 ``Predictor.predict`` calls: ms per call (two ranks share a
     card through the host: a correctness run), peak memory, collectives
     per forward, K1 launches, each output within ``HEADS_REL_BF16`` of
     max|.| of the one-rank forward, both decodes' object counts; (c) on
     every card over NCCL (S = the card count) when there are two or more,
     the same full-width run beside phase 5's one-card numbers; on one card
     it says so.

Beside every timed wrapper (phases 3, 5, 7 and 10) ``kernel_timing.py``
gives the kernel's own device time per call (its C entry point called
again on the inputs the wrapper prepared, queued, no host gaps) and, from
a ``torch.profiler`` window, how many device kernels one call launches,
PyTorch's included.

Each path's launch counts are set to 0 just before it runs and read just
after: K1's from the serving slice, K2-K5's from the training slice, K6's
from the full-resolution slice; phase 12's ranks count their own; phase 13
counts K1 over each CLI run, phase 14 every kernel over each train run, and
phase 16 K1 over each CLI run and the coef-8 requests and every kernel over
its train run; phase 17 K1-K5 over the capstone and K1 over one call of the
exported program; phase 18 K1 over each profiled decode and K2-K5 over the
from-disk steps; phase 19 each kernel over each roofline run's traced calls;
phase 20's ranks count K1 over their own calls.
Phase 15, the last, stops the data workers' fork server and fails if a process this
script started (its descendants, multiprocessing's resource tracker aside:
it ends with this process) is still alive. The
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
import multiprocessing.resource_tracker
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from instance_segmentation_torch import evaluate as evaluate_cli
from instance_segmentation_torch import test as test_cli
from instance_segmentation_torch import train as train_cli
from instance_segmentation_torch.configs import Config, load_trans_config
from instance_segmentation_torch.data import get_dataloader
from instance_segmentation_torch.data.registry import (HOST_HELPERS, BatchMaker, stop_fork_server,
                                                       worker_context)
from instance_segmentation_torch.data.cityscapes import CityscapesDataset, parse_eval_label_json
from instance_segmentation_torch.data.packed_dataset import PackedCityscapesDataset
from instance_segmentation_torch.device import nvidia_smi_name_power, require_cuda
from instance_segmentation_torch.evaluation import device_iou, eval_loop
from instance_segmentation_torch.kernels import (ae_terms, affinity, bounds, build, minr2, nms,
                                                 rasterize)
from instance_segmentation_torch.losses import losses
from instance_segmentation_torch.models import EfficientSeg, EfficientSegConfig, generate_anchors
from instance_segmentation_torch.models.efficientseg import INPUT_SIZES
from instance_segmentation_torch.models.layers import BatchNorm, int8_accumulate, quantize_int8
from instance_segmentation_torch.ops import decode
from instance_segmentation_torch.ops import kmeans as kmeans_ops
from instance_segmentation_torch.ops.decode import DecodeConfig, decode_output
from instance_segmentation_torch.ops.targets import generate_targets
from instance_segmentation_torch.parallel import multihost
from instance_segmentation_torch.serve import Predictor
from instance_segmentation_torch.tools import (
    bench_train_data, convert_polygon, export_model, fullres_demo, jpeg_digests,
    make_synthetic_cityscapes, make_synthetic_coco, multichip, overfit_demo, preprocess_cityscapes,
    profile_blocks, profile_decode, profile_infer, profile_infer_blocks,
)
from instance_segmentation_torch.training.synthetic import bench_train_batch, fullres_batch
from instance_segmentation_torch.training.train_step import Trainer
from instance_segmentation_torch.transforms import CommonTransforms
from instance_segmentation_torch.utils import image as image_utils
from instance_segmentation_torch.utils import jpeg, png
from instance_segmentation_torch.utils.checkpoint import CheckpointManager
from instance_segmentation_torch.utils.logger import Logger
from instance_segmentation_torch.weights import init_random
import kernel_timing

AFFINITY_SHAPE = (8, 20000, 96)          # B, K (kp_th), D (max_dets)
TRAIN_SHAPE = (8, 96, 1024, 512, 1024)   # B, M, P, H, W: bench.py's train cell
FULLRES_SHAPE = (1, 96, 1024, 1024, 2048)  # B, M, P, H, W: tools/fullres_demo.py's defaults
FULLRES_RUNS = (("--batch", "1"), ("--batch", "1", "--remat"), ("--batch", "4"),
                ("--batch", "4", "--remat"), ("--batch", "4", "--ae-window", "256", "512"))
FULLRES_ITERS = 3
KERNELS = ("affinity", "rasterize", "ae_terms")
NMS_SHAPES = ((1, 512), (8, 512))       # B, K (pre_nms): the serving decode's NMS at b1 and b8
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
    work = bounds.affinity_assign(*inputs)
    bound_ms, bound_by = bounds.bound(*work)
    # the earlier bound: 14 operations for every (keypoint, center) pair
    old_ms, old_by = bounds.bound(work.bytes, b * k * d * 14)
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


def nms_inputs(b: int, k: int, seed: int = 0, iou_th: float = 0.2):
    """(sup [b, k, k], valid [b, k]) of ``leader_nms`` on a serving-like set:
    k rank-sorted boxes of 10-200 px in a 512x1024 frame, 8 classes (the
    class offset apart), 90% valid."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, (1024, 512), (b, k, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(10, 200, (b, k, 2))], -1).astype(np.float32)
    boxes += (rng.integers(0, 8, (b, k, 1)) * 3072.0 * np.array([1, 0, 1, 0])).astype(np.float32)
    boxes = torch.from_numpy(boxes)
    rank = torch.arange(k)
    sup = (decode._iou_xyxy(boxes) > iou_th) & (rank[:, None] < rank[None, :])
    return sup, torch.from_numpy(rng.uniform(size=(b, k)) > 0.1)


def phase_nms(dev: torch.device) -> list:
    """The NMS kernel against its twin (the eager fixpoint on the CPU) at the
    serving decode's shapes, timed: the wrapper, the kernel alone, and the
    route it replaced (the fixpoint's sweeps on the card, a host read after
    each, by host clock), beside its bound."""
    records = []
    for b, k in NMS_SHAPES:
        sup, valid = nms_inputs(b, k)
        want = nms.nms_keep_plain(sup, valid)
        sup_d, valid_d = sup.to(dev), valid.to(dev)
        before = nms.launches
        got = nms.nms_keep(sup_d, valid_d)
        torch.cuda.synchronize()
        check(nms.launches == before + 1, "the NMS kernel did not launch")
        check(torch.equal(got.cpu(), want), f"NMS kernel != twin at B={b}, K={k}")
        wrapper = cuda_median_ms(lambda: nms.nms_keep(sup_d, valid_d))
        own = own_time(lambda: nms.nms_keep(sup_d, valid_d))

        def sweeps():
            nms.nms_keep_plain(sup_d, valid_d)
            torch.cuda.synchronize()
        eager = timed_ms(sweeps, runs=20)
        work = bounds.nms_keep(sup, valid)
        least, by = bounds.bound(work.bytes, work.ops)
        print(f"[3] NMS kernel B={b} K={k}: == twin ({int(want.sum())} kept of "
              f"{int(valid.sum())} valid); wrapper {wrapper:.4f} ms, {own_text(own)}; the "
              f"eager sweeps on the card {np.median(eager):.4f} ms a call (host clock, "
              f"{len(eager)} calls); bound {least:.6f} ms ({by}), share alone "
              f"{100 * least / own[0]:.2f}%", flush=True)
        records.append({"name": "nms", "shape": [b, k], "wrapper_ms": wrapper,
                        "alone_ms": own[0], "eager_sweeps_ms": float(np.median(eager)),
                        "bound_ms": least, "kernels_per_call": own[1]})
    for line in build.ptxas_usage("nms"):
        print(f"[3] ptxas nms.cu {line}", flush=True)
    return records


def phase_decode(dev: torch.device, cfg: DecodeConfig = SCENE_DECODE, tag: str = "[4]") -> None:
    """Synthetic scene: card (K1 grouping) against CPU (plain grouping)."""
    outputs, anchors = synthetic_scene(margin=0.5)
    h, w = outputs[0].shape[1:3]

    def run(device):
        outs = tuple(torch.from_numpy(o).to(device) for o in outputs)
        dets = decode_output(outs, torch.tensor(anchors, device=device),
                             2 * h, 2 * w, 2.0, cfg)
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
    print(f"{tag} synthetic decode (exact_topk={cfg.exact_topk}): 2 objects, classes {{0, 1}}, "
          f"poly_len {gpu.poly_len[gpu.obj_valid].tolist()}; card (K1) == cpu (plain) on "
          f"int/bool fields, floats max|diff| {worst:.3g} (tol 1e-5)", flush=True)


first_k1_inputs = multichip.first_k1_inputs


def phase_slice(dev: torch.device, smi: str):
    """B3 512x1024 bf16 Predictor: 3 requests at b1 and 3 at b8. Returns the
    launches ({"affinity": K1's in those requests, "nms": {batch: the NMS
    kernel's on the card per replayed request}}), the inputs K1 got in the
    first b8 call (a warm-up) and the median ms per batch and peak memory."""
    cfg = EfficientSegConfig(num_classes=8, compound_coef=3, compute_dtype=torch.bfloat16)
    dcfg = DecodeConfig()
    pred = Predictor(cfg, dcfg, torch.Generator().manual_seed(0), dev,
                     orig_hw=(1024, 2048), scale=2.0)
    frames = np.random.default_rng(0).integers(0, 256, (8, 512, 1024, 3), dtype=np.uint8)
    nms.launches = 0
    pred.predict(frames[:1])              # warm-up, not counted
    with first_k1_inputs() as served:     # the first b8 call's grouping inputs
        pred.predict(frames)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    check(nms.launches == 2, f"NMS launched {nms.launches} times in 2 eager requests")

    affinity.launches = nms.launches = 0
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
    captures = nms.launches
    medians = {b: 1e3 * float(np.median(t)) for b, t in times.items()}

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
    replayed = {b: kernel_timing.launches_per_call(lambda x=x: pred.predict(x), "nms_kernel", 3)
                for b, x in ((1, frames[:1]), (8, frames))}
    check(captures == 2, f"NMS launched {captures} times by the host in the 6 requests, "
          "want 2 (one capture a batch size)")
    check(replayed == {1: 1.0, 8: 1.0}, f"NMS kernels on the card per replayed request: {replayed}")
    n_det = [int(d.det_valid.sum()) for _, d in results]
    n_obj = [int(d.obj_valid.sum()) for _, d in results]
    for b in (1, 8):
        ms = [1e3 * t for t in times[b]]
        print(f"[5] B3 512x1024 bf16 batch {b}: ms/request {[round(t, 3) for t in ms]} "
              f"(median {np.median(ms):.3f}), img/s {1e3 * b / np.median(ms):.2f}; "
              f"[{smi}]", flush=True)
    print(f"[5] K1 launches in the 6 requests: {launches}; NMS launches by the host: 2 in "
          f"the 2 eager warm-ups, {captures} in the 6 requests (the captures); NMS kernels "
          f"on the card per replayed request (profiler, 3 requests a batch size): b1 "
          f"{replayed[1]:g}, b8 {replayed[8]:g}; detections {n_det}, objects {n_obj}; peak "
          f"device memory {peak} B ({peak / 2**30:.2f} GiB); [{smi}]", flush=True)
    return ({"affinity": launches, "nms": replayed}, served,
            {"ms": medians, "peak_bytes": peak})


def phase_train_kernels(dev: torch.device) -> list:
    """K2, K5, K3, K4 against their twins at the train cell's shapes; returns
    their records (launches filled in by the training slice)."""
    b, m, p, h, w = TRAIN_SHAPE
    _, labels = bench_train_batch(b, m, h, w, edge_cases=True)
    t = generate_targets(*(torch.from_numpy(a).to(dev) for a in labels), h, w, max_points=p,
                         dense_kp=False)
    record, (cnt, r2, _) = hold_rasterizer(7, TRAIN_SHAPE, t)
    return [record] + hold_loss_kernels(dev, 7, TRAIN_SHAPE, t, cnt, r2, [0, b - 1])


def hold_rasterizer(phase: int, shape, t) -> tuple:
    """K2 against its twin, bitwise, on the targets ``t`` at ``shape`` (B,
    M, P, H, W), timed beside its bound; prints a line. Returns its record
    (launches filled in by a training slice) and the kernel's (cnt, r2,
    union)."""
    b, m, p, h, w = shape
    live = int(t.pt_valid.any(dim=2).sum())
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
    bound_ms, bound_by = bounds.bound(*bounds.rasterize_cnt_r2(t.points, t.pt_valid, h, w))
    print(f"[{phase}] K2 rasterize_cnt_r2 B,M,P,H,W={shape} ({live} of {b * m} slots live, "
          f"{int(t.pt_valid.sum())} samples): cnt, r2, union bitwise equal to the twin; "
          f"wrapper {ms:.4f} ms, twin {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
          f"{own_text(alone)}", flush=True)
    return {"name": "rasterize_cnt_r2", "route": "cuda",
            "source": "instance_segmentation_torch/csrc/rasterize.cu",
            "replaces": "instance_segmentation_tpu/losses/rasterize_pallas.py:222",
            "max_abs_err": float(err), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "kernel_ms": alone[0], "kernels_per_call": alone[1]}, got


def hold_loss_kernels(dev: torch.device, phase: int, shape, t, cnt: torch.Tensor,
                      r2: torch.Tensor, sub, fields=None) -> list:
    """K5, K3 and K4 against their twins at ``shape`` (B, M, P, H, W), on the
    targets ``t`` and the maps (cnt, r2) of the route the step takes there:
    K5 and K3 to rtol 1e-5, K4 to 1e-4 of max|g| (its autograd twin on the
    images ``sub``). K3 and K4 read ``fields`` (ey, ex, sy, sx), or fields
    drawn from a seeded generator when None. Prints a line per kernel;
    returns their records (launches filled in by a training slice)."""
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
    bound_ms, bound_by = bounds.bound(*bounds.rasterize_nmap(t.points, t.pt_valid, t.normals,
                                                             h, w))
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
    if fields is None:
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
    pairs, any_tiles, tiles = bounds.visited_tiles(tab, cntp, h, w)
    bound_ms, bound_by = bounds.bound(*bounds.ae_terms_fwd(*fields, *rest))
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
    bound_ms, bound_by = bounds.bound(*bounds.ae_terms_bwd(*full, *rest, *cot))
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
        t = generate_targets(*(torch.from_numpy(a).to(dev) for a in labels), h, w, max_points=p,
                             dense_kp=False)
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
        bound_ms, bound_by = bounds.bound(*bounds.minr2_from_cnt(cnt, has))
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


TRAIN_CLI_SPLITS = (("train", 16), ("val", 4))   # phase 14's synthetic tree
TRAIN_CLI_HW = (1024, 2048)
TRAIN_CLI_BATCH, TRAIN_CLI_STEPS = 4, 2
TRAIN_CLI_KERNELS = dict(TRAIN_KERNELS, minr2_from_cnt=minr2)
EVERY_OP_TRANS = {       # every train op: shuffled photometric ops, then the geometric ones
    "train_trans": {
        "shuffle_trans_seq": ["random_hflip", "random_brightness", "random_contrast",
                              "random_saturation", "random_hue", "random_perm"],
        "trans_seq": ["resize", "random_resize", "random_rotate", "random_crop"],
        "resize": {"target_size": 2},
        "random_resize": {"scale_range": [1.1, 1.25], "aspect_range": [0.95, 1.05]},
        "random_rotate": {"rotate_degree": 5},
        "random_crop": {"ratio": 1.0, "crop_size": [1024, 512]},
    },
    "val_trans": {"trans_seq": ["resize"], "resize": {"target_size": 2}},
}


def write_train_tree(root: Path, procs: int = 8) -> None:
    """Phase 14's synthetic Cityscapes tree (``TRAIN_CLI_SPLITS`` at
    ``TRAIN_CLI_HW``, 2-6 instances a frame, ~1.8 s a 1024x2048 frame on one
    core): each
    frame written by ``make_synthetic_cityscapes.generate`` with a seed of
    its own into a part of its own, ``procs`` parts at a time (processes
    from the data loader's fork server), then moved into one tree."""
    jobs = [(str(root / "parts" / f"{split}{i:03d}"), ((split, 1),), *TRAIN_CLI_HW,
             1000 * k + i, (2, 6))
            for k, (split, count) in enumerate(TRAIN_CLI_SPLITS) for i in range(count)]
    with worker_context().Pool(procs) as pool:
        pool.starmap(make_synthetic_cityscapes.generate, jobs)
    for part, ((split, _),), *_ in jobs:
        index = int(Path(part).name[len(split):])
        for kind, suffix in (("leftImg8bit", "_leftImg8bit.png"),
                             ("gtFine", "_gtFine_polygons.json")):
            dst = root / kind / split / "synth"
            dst.mkdir(parents=True, exist_ok=True)
            (Path(part) / kind / split / "synth" / f"synth_000000_000019{suffix}").rename(
                dst / f"synth_{index:06d}_000019{suffix}")
    shutil.rmtree(root / "parts")


def train_cli_cfg(root: Path, save_dir: Path, trans_path, **top) -> dict:
    """The JAX default train config (configs/defaults/train_cfg.yaml) at
    batch 4 on ``root``: B3, bf16 over float32 weights, 512x1024, Adam 2e-5,
    M=96, V=256, P=1024."""
    cfg = {"data": {"train_dir": str(root), "save_dir": str(save_dir), "dataset": "cityscapes",
                    "batch_size": TRAIN_CLI_BATCH, "num_classes": -1, "num_workers": 4},
           "optimizer": {"lr": "2e-5", "type": "Adam", "momentum": 0.9},
           "max_iter": TRAIN_CLI_STEPS, "num_epochs": 1, "save_span": 1000, "seed": 1,
           "compound_coef": 3,
           "anchors_scales": "[2 ** 0, 2 ** (1.0 / 3.0), 2 ** (2.0 / 3.0)]",
           "anchors_ratios": "[(1.0, 1.0), (1.4, 0.7), (0.7, 1.4)]",
           "pretrained_path": None, "decode_cfg_path": None,
           "trans_cfg_path": None if trans_path is None else str(trans_path),
           "start_eval_epoch": 1000,
           "tpu": {"compute_dtype": "bfloat16", "remat": False, "input_size": list(TRAIN_SHAPE[3:])},
           "static": {"max_instances": TRAIN_SHAPE[1], "max_vertices": 256,
                      "max_points": TRAIN_SHAPE[2]}}
    for key, value in top.items():
        if isinstance(value, dict):
            cfg[key] = {**cfg[key], **value}
        else:
            cfg[key] = value
    return cfg


@contextlib.contextmanager
def timed_training(record: dict):
    """While open, every step is timed with the card synchronised before and
    after it (its stats and batch shape kept), and every epoch's wall time is
    kept: the rest of an epoch is the loop waiting for data (and logging)."""
    from instance_segmentation_torch.training import train_step as step_mod
    from instance_segmentation_torch.training import trainer as epoch_mod
    real_step, real_epoch = step_mod.Trainer.step, epoch_mod.Trainer.train_epoch
    record.update(step_ms=[], stats=[], shapes=[], epochs=[], gaps=[])

    def step(self, images, polys, n_verts, cls_ids):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        record["gaps"].append(t0 - record.pop("last", record["epoch_start"]))
        stats = real_step(self, images, polys, n_verts, cls_ids)
        torch.cuda.synchronize()
        record["last"] = time.perf_counter()
        record["step_ms"].append(1e3 * (record["last"] - t0))
        record["stats"].append({k: float(v) for k, v in stats.items()})
        record["shapes"].append(tuple(images.shape))
        return stats

    def train_epoch(self, loader, epoch):
        record["epoch_start"] = time.perf_counter()
        record.pop("last", None)
        n = len(record["step_ms"])
        out = real_epoch(self, loader, epoch)
        record["epochs"].append((time.perf_counter() - record["epoch_start"],
                                 sum(record["step_ms"][n:]) / 1e3))
        return out
    step_mod.Trainer.step, epoch_mod.Trainer.train_epoch = step, train_epoch
    try:
        yield record
    finally:
        step_mod.Trainer.step, epoch_mod.Trainer.train_epoch = real_step, real_epoch


@contextlib.contextmanager
def first_step_inputs():
    """While open, the first training step's targets (K2's and K5's inputs,
    and K3/K4's tables) and the four AE fields K3 gets are kept, copied."""
    from instance_segmentation_torch.training import train_step as step_mod
    kept = {}
    real_targets, real_ae = step_mod.generate_targets, ae_terms.ae_terms

    def targets(*args, **kwargs):
        t = real_targets(*args, **kwargs)
        if "targets" not in kept:
            kept["targets"] = type(t)(*(x.clone() if isinstance(x, torch.Tensor) else x
                                        for x in t))
        return t

    def ae(*args):
        if "fields" not in kept:
            kept["fields"] = [a.detach().float().contiguous().clone() for a in args[:4]]
        return real_ae(*args)
    step_mod.generate_targets, ae_terms.ae_terms = targets, ae
    try:
        yield kept
    finally:
        step_mod.generate_targets, ae_terms.ae_terms = real_targets, real_ae


def host_batch_ms(dataset) -> float:
    """ms of one batch of 4 made on one host thread (``BatchMaker``: read,
    transform, pack)."""
    maker = BatchMaker(dataset, TRAIN_SHAPE[1], 256, True)
    t0 = time.perf_counter()
    maker(range(TRAIN_CLI_BATCH))
    return 1e3 * (time.perf_counter() - t0)


def run_train_cli(base: Path, name: str, cfg: dict, dev: torch.device, smi: str,
                  evals: int, phase: int = 14,
                  eval_frames: int = TRAIN_CLI_SPLITS[1][1]) -> dict:
    """``train.main`` on ``cfg`` (written as YAML), timed; checks finite
    losses, 512x1024 frames and the launches (K2-K5 once a step, K6 never,
    K1 once an eval batch of ``eval_frames``); prints its lines (tagged
    ``phase``) and returns its record."""
    path = base / f"{name}.yaml"
    path.write_text(yaml_text(cfg))
    for kname, module in TRAIN_CLI_KERNELS.items():
        module.launches[kname] = 0
    affinity.launches = 0
    gc.collect()
    torch.cuda.reset_peak_memory_stats(dev)
    rec = {}
    with timed_training(rec):
        t0 = time.perf_counter()
        train_cli.main(["--cfg_path", str(path)])
        wall = time.perf_counter() - t0
    counts = {k: module.launches[k] for k, module in TRAIN_CLI_KERNELS.items()}
    k1 = affinity.launches
    steps = len(rec["step_ms"])
    epochs = len(rec["epochs"])
    check(steps == TRAIN_CLI_STEPS * epochs, f"{name}: {steps} steps in {epochs} epochs")
    for i, s in enumerate(rec["stats"]):
        check(all(np.isfinite(v) for v in s.values()), f"{name} step {i}: a loss is not finite")
    check(all(sh == (TRAIN_CLI_BATCH, *TRAIN_SHAPE[3:], 3) for sh in rec["shapes"]),
          f"{name}: batches {sorted(set(rec['shapes']))}")
    want = {k: (0 if k == "minr2_from_cnt" else steps) for k in counts}
    check(counts == want, f"{name}: launches {counts}, want {want}")
    eval_batches = evals * math.ceil(eval_frames / TRAIN_CLI_BATCH)
    check(k1 == eval_batches, f"{name}: K1 launched {k1} times for {eval_batches} eval batches")
    peak = torch.cuda.max_memory_allocated(dev)
    gaps = [1e3 * g for g in rec["gaps"]]
    epoch_wall = sum(e[0] for e in rec["epochs"])
    wait_share = 1 - sum(e[1] for e in rec["epochs"]) / epoch_wall
    files = sorted(p.name for p in Path(cfg["data"]["save_dir"]).glob("efficient_weights_*.pth"))
    rec.update(wall=wall, files=files, peak=peak, counts=counts, k1=k1, wait_share=wait_share)
    fmt = lambda s: ", ".join(f"{k} {v:.6g}" for k, v in s.items())   # noqa: E731
    print(f"[{phase}] {name}: {steps} steps in {epochs} epoch(s), B3 512x1024 bf16 b{TRAIN_CLI_BATCH} "
          f"(M=96, V=256, P=1024, Adam 2e-5, {cfg['data']['num_workers']} data workers): step "
          f"ms {[round(t, 3) for t in rec['step_ms']]} (synced); data wait before each step "
          f"ms {[round(g, 3) for g in gaps]} (the first of an epoch includes the loader's "
          f"start); data-wait share of the epochs {wait_share:.1%} of {epoch_wall:.2f} s; "
          f"whole CLI {wall:.2f} s; peak device memory {peak / 2**30:.2f} GiB; launches "
          f"{counts} = {steps} steps, K1 {k1} = eval batches {eval_batches}; [{smi}]", flush=True)
    print(f"[{phase}] {name}: first loss line: {fmt(rec['stats'][0])}", flush=True)
    print(f"[{phase}] {name}: last loss line: {fmt(rec['stats'][-1])}", flush=True)
    print(f"[{phase}] {name}: checkpoints {files}", flush=True)
    return rec


def host_image_ops(frame: np.ndarray) -> None:
    """The warp (C helper against its numpy twin, bitwise) and the HSV pair
    on one 512x1024x3 frame, host ms."""
    h, w = frame.shape[:2]
    mat = image_utils.rotation_matrix_2d((w / 2.0, h / 2.0), 5.0, 1.0)
    times = {}
    for name, fn in (("warp_affine_linear (C)", image_utils.warp_affine_linear),
                     ("warp_affine_linear_numpy", image_utils.warp_affine_linear_numpy)):
        fn(frame, mat, (w, h), (104, 117, 123))
        t0 = time.perf_counter()
        times[name] = fn(frame, mat, (w, h), (104, 117, 123))
        times[name + " ms"] = 1e3 * (time.perf_counter() - t0)
    check(np.array_equal(times["warp_affine_linear (C)"], times["warp_affine_linear_numpy"]),
          "warp_affine_linear: the C helper differs from its numpy twin")
    rgb = frame.astype(np.float32)
    t0 = time.perf_counter()
    hsv = image_utils.rgb_to_hsv_f32(rgb)
    t1 = time.perf_counter()
    image_utils.hsv_to_rgb_f32(hsv)
    t2 = time.perf_counter()
    print(f"[14] host ops on one {h}x{w}x3 frame: warp_affine_linear (5 deg rotation, "
          f"csrc/warp_affine.c) {times['warp_affine_linear (C) ms']:.2f} ms, its numpy twin "
          f"{times['warp_affine_linear_numpy ms']:.2f} ms (bitwise equal); rgb_to_hsv_f32 "
          f"{1e3 * (t1 - t0):.2f} ms, hsv_to_rgb_f32 {1e3 * (t2 - t1):.2f} ms", flush=True)


def phase_train_cli(dev: torch.device, smi: str) -> None:
    """The train entry point ``python -m instance_segmentation_torch.train``
    (called in-process) on phase 14's synthetic tree: (a) the default
    transforms with 4 data workers, 2 epochs of 2 steps and the in-loop
    eval in the last, then resumed to a third epoch with 1 worker; (b) every
    train op with 4 workers; (c) the packed path (the preprocess tool's
    labels and image cache) with ``device_aug``. K2-K5 held against their
    twins on (a)'s first step, K1 on its first eval batch."""
    start = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR.parent) as tmp:
        base = Path(tmp)
        root = base / "cityscapes"
        t0 = time.perf_counter()
        write_train_tree(root)
        print(f"[14] synthetic Cityscapes tree: {dict(TRAIN_CLI_SPLITS)} frames at "
              f"{TRAIN_CLI_HW[0]}x{TRAIN_CLI_HW[1]}, "
              f"2-6 instances each, written by 8 processes in {time.perf_counter() - t0:.2f} s "
              "(the fork server's start included)", flush=True)
        train_cli_runs(dev, smi, base, root)
    print(f"[14] phase 14 took {time.perf_counter() - start:.1f} s", flush=True)


def train_cli_runs(dev: torch.device, smi: str, base: Path, root: Path) -> None:
    """Phase 14's runs on the tree at ``root`` (see ``phase_train_cli``)."""
    default_tf = load_trans_config()
    (base / "every_op.json").write_text(json.dumps(EVERY_OP_TRANS))
    datasets = {
        "default": CityscapesDataset(str(root), CommonTransforms(default_tf, "train", seed=1)),
        "every_op": CityscapesDataset(str(root), CommonTransforms(
            load_trans_config(str(base / "every_op.json")), "train", seed=1)),
    }
    frame = datasets["default"][0][0]
    host_image_ops(frame)

    # (a) the default transforms, 4 workers; the last epoch evaluates
    save = base / "run_a"
    cfg = train_cli_cfg(root, save, None, num_epochs=2, save_span=2, start_eval_epoch=1,
                        data={"eval_dir": str(root)})
    with first_step_inputs() as kept, first_k1_inputs() as grouped:
        run_train_cli(base, "(a) default transforms", cfg, dev, smi, evals=1)
    ap_lines = [line for line in (save / "logs" / "log.txt").read_text().splitlines()
                if "] AP=" in line]
    check(len(ap_lines) == 1 and (save / "1_dets.json").exists(),
          f"(a): AP lines {ap_lines}, dets {sorted(p.name for p in save.glob('*_dets.json'))}")
    print(f"[14] (a) in-loop eval at epoch 1: {ap_lines[0]}", flush=True)
    t = kept["targets"]
    shape = (TRAIN_CLI_BATCH, *TRAIN_SHAPE[1:])
    _, (cnt, r2, _) = hold_rasterizer(14, shape, t)
    hold_loss_kernels(dev, 14, shape, t, cnt, r2, [0, TRAIN_CLI_BATCH - 1], kept["fields"])
    hold_affinity(14, "the train CLI's in-loop eval, first batch", grouped)

    # (a) resumed to a third epoch, 1 worker
    latest = CheckpointManager(str(save)).list_checkpoints()[-1]
    check(latest == "efficient_weights_00000001.pth", f"(a): restore_latest would pick {latest}")
    cfg = train_cli_cfg(root, save, None, num_epochs=3, save_span=2, start_eval_epoch=1,
                        data={"eval_dir": str(root), "num_workers": 1})
    rec = run_train_cli(base, "(a) resumed", cfg, dev, smi, evals=1)
    resumed = [line for line in (save / "logs" / "log.txt").read_text().splitlines()
               if "resumed from epoch" in line]
    check(len(rec["epochs"]) == 1 and resumed and "resumed from epoch 1," in resumed[-1],
          f"(a) resumed: {len(rec['epochs'])} epochs, log {resumed}")
    print(f"[14] (a) resumed from {latest}: {resumed[-1].split('] ', 1)[-1]}; ran epoch 2 only",
          flush=True)

    # (b) every train op, 4 workers
    cfg = train_cli_cfg(root, base / "run_b", base / "every_op.json")
    run_train_cli(base, "(b) every train op", cfg, dev, smi, evals=0)

    # (c) the packed path: labels and the image cache from the preprocess tool
    t0 = time.perf_counter()
    for subset in ("train", "val"):
        preprocess_cityscapes.main(["--root", str(root), "--subset", subset, "--out",
                                    str(root / "packed" / subset), "--cache_images",
                                    "--workers", "8"])
    cached = len(list((root / "packed" / "train").glob("*_img.npy")))
    check(cached == TRAIN_CLI_SPLITS[0][1], f"(c): {cached} cached train frames")
    print(f"[14] (c) preprocess_cityscapes --cache_images (8 workers): "
          f"{TRAIN_CLI_SPLITS} frames in {time.perf_counter() - t0:.2f} s", flush=True)
    datasets["packed"] = PackedCityscapesDataset(str(root), str(root / "packed" / "train"))
    # num_classes given: the class-count table knows "cityscapes", not
    # "cityscapes_packed" (in both packages)
    cfg = train_cli_cfg(root, base / "run_c", None, tpu={"device_aug": True},
                        data={"dataset": "cityscapes_packed", "num_classes": 8,
                              "num_workers": 0})
    run_train_cli(base, "(c) packed, device_aug", cfg, dev, smi, evals=0)
    print("[14] host ms per batch of 4 on one thread (read, transform, pack): " + ", ".join(
        f"{k} {host_batch_ms(d):.1f}" for k, d in datasets.items()) + f"; [{smi}]", flush=True)


COCO_SPLITS, COCO_HW, COCO_BATCH = (("train", 8), ("val", 8)), (480, 640), 8
COCO_TRANS = {   # COCO frames stretched to the 512x1024 input (random_resize at a fixed size)
    "train_trans": {"trans_seq": ["random_resize", "random_hflip", "random_brightness"],
                    "random_resize": {"ratio": 0.0, "target_size": [1024, 512]},
                    "random_hflip": {"ratio": 0.5, "swap_pair": []},
                    "random_brightness": {"ratio": 1.0, "shift_value": 10}},
    "val_trans": {"trans_seq": ["random_resize"],
                  "random_resize": {"ratio": 0.0, "target_size": [1024, 512]}},
}
COCO_DECODE = {"cls_th": 0.3, "iou_th": 0.2, "kp_th": 20000, "obj_pixel_th": 2,
               "wh_delta": 0.1, "alpha_ratio": 2, "draw_flag": False}
KMEANS_TIE = 1e-5


@contextlib.contextmanager
def kmeans_calls():
    """While open, every ``kmeans`` call of the decode is kept: (points,
    centres seeded, valid, labels, centres)."""
    kept = []
    real = decode.kmeans

    def capture(points, init, valid=None, **kwargs):
        labels, centres = real(points, init, valid=valid, **kwargs)
        kept.append((points, init, valid, labels, centres))
        return labels, centres
    decode.kmeans = capture
    try:
        yield kept
    finally:
        decode.kmeans = real


def kmeans_mismatches(points, labels, want, centres) -> tuple:
    """(labels differing from ``want``, of which near-ties): points whose
    two labels' squared distances to ``centres`` (float64; the outlier
    label K at infinity) lie within KMEANS_TIE of each other, relative."""
    got, want = labels.long().cpu(), want.long().cpu()
    b, k = (got != want).nonzero(as_tuple=True)
    if b.numel() == 0:
        return 0, 0
    p = points.cpu().double()[b, k]                                    # [n, 2]
    c = centres.cpu().double()[b]                                      # [n, D, 2]
    d = ((p[:, None, :] - c) ** 2).sum(-1)
    d = torch.cat([d, torch.full_like(d[:, :1], math.inf)], dim=-1)
    da, db = d.gather(1, got[b, k][:, None])[:, 0], d.gather(1, want[b, k][:, None])[:, 0]
    near = (da - db).abs() <= KMEANS_TIE * db.abs().clamp(min=1e-3)
    return int(b.numel()), int(near.sum())


def kmeans_steps(points, init, valid, iters: int) -> tuple:
    """Each Lloyd step of ``kmeans`` on the card replayed on the CPU from the
    card's own state, so that no earlier flip carries over: the labels from
    the card's centres after n steps (n = 0..iters), and each step's centre
    update from the card's labels before it. Returns (label mismatches,
    near-ties among them, max centre error)."""
    diff = near = 0
    err, prev = 0.0, None
    valid_h, points_h = valid.cpu(), points.cpu()
    k = init.shape[1]
    for n in range(iters + 1):
        labels, centres = decode.kmeans(points, init, valid=valid, num_iters=n)
        centres_h = centres.cpu()
        want = kmeans_ops.pairwise_distance(points_h, centres_h).argmin(-1)
        want = torch.where(valid_h, want, torch.full_like(want, k))
        d, nr = kmeans_mismatches(points_h, labels, want, centres_h)
        diff, near = diff + d, near + nr
        if prev is not None:
            member = torch.nn.functional.one_hot(prev.clamp(max=k - 1).long(), k).float()
            member = member * valid_h[..., None].float()
            update = (member.transpose(-1, -2) @ points_h) / member.sum(-2).clamp(min=1.0)[..., None]
            err = max(err, float((update - centres_h).abs().max()))
        prev = labels.cpu()
    return diff, near, err


def coco_eval_runs(dev: torch.device, smi: str, base: Path, root: Path, cfg: dict,
                   ckpt: Path) -> None:
    """(c): the evaluate CLI on the COCO tree, affinity and kmeans grouping,
    after a warm-up run; then kmeans's decode on the card against the CPU."""
    real = {name: getattr(eval_loop, name) for name in ("forward_and_decode", "eval_outputs")}
    for mode in ("affinity", "kmeans"):
        (base / f"decode_{mode}.yaml").write_text(yaml_text({**COCO_DECODE, "group_mode": mode}))
        for run in ("warm-up", "timed"):      # the warm-up pays the first calls' set-up
            eval_cfg = {"data": {"eval_dir": str(root), "save_dir": str(base / f"{mode}_{run}"),
                                 "dataset": "coco", "batch_size": COCO_BATCH,
                                 "input_size": list(EVAL_INPUT), "num_classes": -1,
                                 "subset": "val"},
                        **cfg, "weights_path": str(ckpt), "weights_dir": None,
                        "decode_cfg_path": str(base / f"decode_{mode}.yaml"),
                        "trans_cfg_path": str(base / "coco_trans.json"),
                        "tpu": {"compute_dtype": "bfloat16", "input_size": list(EVAL_INPUT)}}
            (base / f"coco_eval_{mode}_{run}.yaml").write_text(yaml_text(eval_cfg))
        evaluate_cli.main(["--cfg_path", str(base / f"coco_eval_{mode}_warm-up.yaml")])
        out = base / f"{mode}_timed"
        times = {name: [] for name in real}
        for name, fn in real.items():
            setattr(eval_loop, name, timed(fn, times[name]))
        affinity.launches = 0
        try:
            with first_k1_inputs() as grouped:
                evaluate_cli.main(["--cfg_path", str(base / f"coco_eval_{mode}_timed.yaml")])
        finally:
            for name, fn in real.items():
                setattr(eval_loop, name, fn)
        frames = COCO_SPLITS[1][1]
        batches = math.ceil(frames / COCO_BATCH)
        check(affinity.launches == batches,
              f"[16] evaluate ({mode}): K1 launched {affinity.launches} times for {batches}")
        dets = json.loads((out / "0_dets.json").read_text())
        n_det = sum(len(d) for d in dets)
        results = json.loads((out / "0_coco_results.json").read_text())
        ap = [line.split("] ", 2)[-1] for line in
              (out / "logs" / "log.txt").read_text().splitlines() if "COCO AP=" in line]
        check(len(dets) == frames and n_det >= 1 and len(results) == n_det and len(ap) == 1,
              f"[16] evaluate ({mode}): {n_det} detections, {len(results)} results, AP {ap}")
        fwd = [1e3 * t for t in times["forward_and_decode"]]
        sweep = times["eval_outputs"][0]
        print(f"[16] (c) evaluate CLI, coco, {mode} grouping, B3 512x1024 bf16 80 classes "
              f"batch {COCO_BATCH} on {frames} frames (after a warm-up run): forward+decode "
              f"ms/batch {[round(t, 3) for t in fwd]} (synced); sweep {sweep:.3f} s = "
              f"{frames / sweep:.2f} img/s; detections {n_det}; {out.name}/0_coco_results.json "
              f"holds {len(results)}; {ap[0]}; K1 launches {affinity.launches} = batches "
              f"{batches}; [{smi}]", flush=True)
        hold_affinity(16, f"the evaluate CLI's first coco batch ({mode})", grouped)

    model = evaluate_cli.seeded_model(Config(cfg), 80, dev)
    model.load_state_dict(torch.load(ckpt, weights_only=True)["model"])
    trans = load_trans_config(str(base / "coco_trans.json"))
    loader = get_dataloader(COCO_BATCH, "coco", str(root), "val",
                            transforms=CommonTransforms(trans, "val"))
    images = next(iter(loader))[0]
    mc = model.cfg
    anchors = generate_anchors(*EVAL_INPUT, pyramid_levels=mc.pyramid_levels,
                               anchor_scale=mc.anchor_scale)
    dcfg = DecodeConfig(group_mode="kmeans")
    with torch.inference_mode():
        outputs = model(torch.from_numpy(images).to(dev))
        with kmeans_calls() as card:
            got = decode_output(outputs, torch.tensor(anchors, device=dev), *EVAL_HW, 2.0, dcfg)
        host = tuple(o.cpu() for o in outputs)
        t0 = time.perf_counter()
        with kmeans_calls() as cpu:
            want = decode_output(host, torch.tensor(anchors), *EVAL_HW, 2.0, dcfg)
        cpu_s = time.perf_counter() - t0
        points, init, valid, labels, centres = card[0]
        steps = kmeans_steps(points, init, valid, dcfg.kmeans_iters)
    n_valid = int(valid.sum())
    check(steps[0] == steps[1] and steps[2] <= 1e-5,
          f"[16] kmeans steps on the card vs the CPU: {steps[0]} labels differ, {steps[1]} of "
          f"them near-ties; centres off by {steps[2]}")
    diff, near = kmeans_mismatches(cpu[0][0], labels, cpu[0][3], cpu[0][4])
    check(diff <= n_valid // 100, f"[16] kmeans decode card vs CPU: {diff} labels differ")
    objs = (int(got.obj_valid.sum()), int(want.obj_valid.sum()))
    same_len = int(((got.poly_len.cpu() == want.poly_len) & want.obj_valid).sum())
    print(f"[16] (c) kmeans decode ({dcfg.kmeans_iters} Lloyd steps, B={points.shape[0]}, "
          f"K={points.shape[1]}, D={init.shape[1]}) on the card against the CPU on the same "
          f"model outputs: {diff} of {n_valid} valid keypoints' final labels differ, {near} of "
          f"them near-ties (within {KMEANS_TIE} relative) and the rest carried from a flip in "
          f"an earlier step; each step replayed on the CPU from the card's state: {steps[0]} "
          f"labels differ over {dcfg.kmeans_iters + 1} assignments, all {steps[1]} near-ties, "
          f"centre updates within {steps[2]:.2e}; objects {objs[0]} card / {objs[1]} CPU, equal "
          f"polygon lengths on {same_len}; CPU decode {cpu_s:.2f} s", flush=True)


def phase_coco(dev: torch.device, smi: str) -> None:
    """Phase 16, the COCO path and the modules beside it: (a) the JPEG
    codec on the host against committed digests of OpenCV's bytes and
    pixels, timed; (b) a synthetic COCO tree of 8 + 8 frames at 480x640,
    its ground truth scored as predictions (AP 1); (c) the evaluate CLI on
    it (B3 bf16 512x1024, 80 classes, batch 8), affinity and kmeans
    grouping, K1 held on each first batch, kmeans's decode on the card
    against the CPU; (d) the test CLI with draw_flag; (e) the train CLI,
    batch 4, 2 workers, 2 steps and the in-loop COCO eval; (f) the dense kp
    target and its focal loss on the card against the CPU at the train
    cell; (g) an EfficientSeg-B7 coef-8 Predictor at 1536x1536."""
    start = time.perf_counter()
    rows = jpeg_digests.check()
    bad = [r["case"] for r in rows if not (r["bytes_ok"] and r["pixels_ok"])]
    check(not bad, f"[16] JPEG codec: the digests of {bad} differ from OpenCV's")
    print("[16] (a) JPEG codec (csrc/jpeg_codec.c, host) against the committed digests of "
          "cv2.imwrite's bytes and cv2.imread's pixels, equal on every case: " + "; ".join(
              f"{r['case']} encode {r['encode_ms']:.2f} ms, decode {r['decode_ms']:.2f} ms"
              for r in rows), flush=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR.parent) as tmp:
        base = Path(tmp)
        root = base / "coco"
        t0 = time.perf_counter()
        make_synthetic_coco.generate(str(root), COCO_SPLITS, *COCO_HW, seed=0)
        dets, infos = make_synthetic_coco.gt_detections(str(root), "val")
        out = base / "coco_gt"
        out.mkdir()
        (out / "0_dets.json").write_text(json.dumps(dets))
        (out / "0_infos.json").write_text(json.dumps(infos))
        gt = eval_loop.evaluate_from_json(Config({"eval_dir": str(root)}), 0, str(out), "coco",
                                          Logger(), 80, orig_hw=COCO_HW)
        check(gt["AP"] == 1.0 and gt["AP50"] == 1.0, f"[16] COCO AP of the ground truth: {gt}")
        print(f"[16] (b) synthetic COCO tree {dict(COCO_SPLITS)} at {COCO_HW[0]}x{COCO_HW[1]} "
              f"(JPEG, each frame polygons, a crowd RLE, an RLE-only instance) written in "
              f"{time.perf_counter() - t0:.2f} s; its ground truth scored as predictions: COCO "
              f"AP {gt['AP']!r} AP50 {gt['AP50']!r} AP75 {gt['AP75']!r} over "
              f"{len(gt['classes'])} classes", flush=True)

        cfg = {"seed": 1, "compound_coef": EVAL_COMPOUND}
        model = evaluate_cli.seeded_model(Config(cfg), 80, torch.device("cpu"))
        eval_weights(model, seed=1)
        ckpt = base / "weights" / "efficient_weights_00000000.pth"
        ckpt.parent.mkdir()
        torch.save({"model": model.state_dict(), "epoch": -1, "best_ap": 0.0}, ckpt)
        del model
        (base / "coco_trans.json").write_text(json.dumps(COCO_TRANS))
        coco_eval_runs(dev, smi, base, root, cfg, ckpt)

        out = base / "coco_test"
        (base / "decode_draw.yaml").write_text(yaml_text({**COCO_DECODE, "draw_flag": True}))
        test_cfg = {"data": {"test_dir": str(root / "val"), "test_image": None,
                             "save_dir": str(out), "dataset": "dir", "batch_size": COCO_BATCH,
                             "input_size": list(EVAL_INPUT), "num_classes": 80},
                    **cfg, "weights_path": str(ckpt),
                    "decode_cfg_path": str(base / "decode_draw.yaml"),
                    "trans_cfg_path": str(base / "coco_trans.json")}
        (base / "coco_test.yaml").write_text(yaml_text(test_cfg))
        affinity.launches = 0
        t0 = time.perf_counter()
        test_cli.main(["--cfg_path", str(base / "coco_test.yaml")])
        total = time.perf_counter() - t0
        frames = sorted(p.name for p in (root / "val").glob("*.jpg"))
        check(sorted(p.name for p in out.glob("*.jpg")) == frames, "[16] test CLI overlays")
        for name in frames:
            shape = jpeg.read_jpeg(str(out / name)).shape
            check(shape == (*COCO_HW, 3), f"[16] overlay {name} decodes to {shape}")
            for kind in ("box", "candid", "instances"):
                check((out / f"{name[:-4]}_{kind}.png").exists(), f"[16] no {kind} PNG of {name}")
        check(affinity.launches == 1, f"[16] test CLI: K1 launched {affinity.launches} times")
        print(f"[16] (d) test CLI with draw_flag, B3 512x1024 bf16 batch {COCO_BATCH}: "
              f"{len(frames)} JPEG overlays each decoding to {COCO_HW[0]}x{COCO_HW[1]}x3, three "
              f"debug PNGs a frame; K1 launches {affinity.launches}; {total:.2f} s; [{smi}]",
              flush=True)

        save = base / "coco_train"
        cfg = train_cli_cfg(root, save, base / "coco_trans.json", start_eval_epoch=0,
                            data={"dataset": "coco", "eval_dir": str(root), "num_workers": 2})
        run_train_cli(base, "(e) train CLI on the COCO tree", cfg, dev, smi, evals=1, phase=16,
                      eval_frames=COCO_SPLITS[1][1])
        ap = [line for line in (save / "logs" / "log.txt").read_text().splitlines()
              if "COCO AP=" in line]
        check(len(ap) == 1 and (save / "0_coco_results.json").exists(), f"[16] (e) AP lines {ap}")
        print(f"[16] (e) in-loop eval: {ap[0].split('] ', 1)[-1]}", flush=True)

    b, m, p, h, w = TRAIN_SHAPE
    labels = bench_train_batch(b, m, h, w, edge_cases=True)[1]
    kp = torch.from_numpy(np.random.default_rng(1).normal(-2, 2, (b, h, w)).astype(np.float32))
    card_t = generate_targets(*(torch.from_numpy(a).to(dev) for a in labels), h, w, max_points=p)
    host_t = generate_targets(*map(torch.from_numpy, labels), h, w, max_points=p)
    check(torch.equal(card_t.kp_tgt.cpu(), host_t.kp_tgt), "[16] dense kp target: card != CPU")
    got = float(losses.kp_focal_loss(kp.to(dev), card_t.kp_tgt))
    want = float(losses.kp_focal_loss(kp, host_t.kp_tgt))
    check(abs(got - want) <= 1e-5 * abs(want), f"[16] kp_focal_loss card {got} vs CPU {want}")
    target_ms = cuda_median_ms(lambda: generate_targets(
        *(torch.from_numpy(a).to(dev) for a in labels), h, w, max_points=p), iters=5)
    print(f"[16] (f) generate_targets(dense_kp=True) at B={b}, M={m}, P={p}, {h}x{w}: the card's "
          f"kp_tgt equal to the CPU's bit for bit ({int(host_t.kp_tgt.sum())} pixels set), "
          f"{target_ms:.3f} ms on the card; kp_focal_loss card {got!r} vs CPU {want!r} "
          f"(rtol {abs(got - want) / abs(want):.2e} <= 1e-5)", flush=True)

    cfg8 = EfficientSegConfig(num_classes=80, compound_coef=8, compute_dtype=torch.bfloat16)
    size = INPUT_SIZES[8]
    t0 = time.perf_counter()
    pred = Predictor(cfg8, DecodeConfig(), torch.Generator().manual_seed(0), dev,
                     orig_hw=(size, size), scale=1.0)
    build_s = time.perf_counter() - t0
    frames = np.random.default_rng(3).integers(0, 256, (2, size, size, 3), dtype=np.uint8)
    gc.collect()
    torch.cuda.reset_peak_memory_stats(dev)
    affinity.launches = 0
    ms = []
    for i in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dets = pred.predict(frames[i:i + 1])
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    check(affinity.launches == 2, f"[16] coef 8: K1 launched {affinity.launches} times")
    check(bool(torch.isfinite(dets.boxes).all()), "[16] coef 8: boxes not finite")
    print(f"[16] (g) EfficientSeg coef 8 (B7 backbone, P3-P8, 384-wide BiFPN x8) Predictor, bf16 "
          f"{size}x{size}, 80 classes, seeded weights (built in {build_s:.1f} s): 2 requests at "
          f"b1, ms {[round(t, 2) for t in ms]} (the first pays the set-up); K1 launches "
          f"{affinity.launches}; peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; [{smi}]", flush=True)
    del pred, dets
    print(f"[16] phase 16 took {time.perf_counter() - start:.1f} s", flush=True)


CAPSTONE_STEPS = 200        # phase 17 (a): about a minute of B0 steps at 256x512, b2
INT8_SHAPE = (8, 512, 1024)  # phase 17 (b): B, H, W
EXPORT_HW = (512, 1024)      # phase 17 (c): B3 at b1
CENTERS_MAP = (256, 512, 4)  # phase 17 (d): H, W, classes


def timed_ms(fn, runs: int = 5) -> list:
    """Synchronised host ms (``timed``) of ``runs`` calls of ``fn`` after one
    warm-up."""
    fn()
    store = []
    for _ in range(runs):
        timed(fn, store)()
    return [1e3 * t for t in store]


def phase_capstone(dev: torch.device, smi: str, base: Path) -> Path:
    """Phase 17 (a): the learning capstone through its entry point, at the
    JAX protocol but CAPSTONE_STEPS steps. Returns its data tree."""
    counts = {**{name: 0 for name in TRAIN_KERNELS}, "affinity_assign": 0}
    for name, module in TRAIN_KERNELS.items():
        module.launches[name] = 0
    affinity.launches = 0
    res = overfit_demo.run(steps=CAPSTONE_STEPS, out=str(base / "overfit"), quant_ab=True,
                           device=dev, log_every=100)
    counts.update({name: module.launches[name] for name, module in TRAIN_KERNELS.items()})
    counts["affinity_assign"] = affinity.launches
    (s0, l0), (s1, l1) = res["losses"][0], res["losses"][-1]
    check(np.isfinite(l0) and np.isfinite(l1) and l1 < l0,
          f"[17] capstone: loss {l0} at step {s0}, {l1} at step {s1}: not falling")
    for name in TRAIN_KERNELS:
        check(counts[name] == CAPSTONE_STEPS,
              f"[17] capstone: {name} launched {counts[name]} times in {CAPSTONE_STEPS} steps")
    check(counts["affinity_assign"] == 6,
          f"[17] capstone: K1 launched {counts['affinity_assign']} times in 3 evals of 2 batches")
    ap = res["ap"]
    print(f"[17] (a) capstone (tools/overfit_demo.py: B0 bf16, 256x512 from 4 synthetic 512x1024 "
          f"frames, b2, Adam 3e-4, M=16, P=512) {CAPSTONE_STEPS} steps in {res['train_s']:.1f} s, "
          f"{1e3 * res['train_s'] / CAPSTONE_STEPS:.2f} ms/step; loss {l0:.3f} at step {s0} -> "
          f"{l1:.3f} at step {s1}; losses {[(s, round(v, 3)) for s, v in res['losses']]}; "
          f"AP {ap['AP']:.4f} AP50 {ap['AP50']:.4f}, kmeans AP {ap['AP_kmeans']:.4f} AP50 "
          f"{ap['AP50_kmeans']:.4f}, int8 AP {ap['AP_int8']:.4f} AP50 {ap['AP50_int8']:.4f} "
          f"(dAP {ap['dAP_int8']:+.4f}); launches {counts}; [{smi}]", flush=True)
    return base / "overfit" / "data"


def phase_int8(dev: torch.device, smi: str) -> None:
    """Phase 17 (b): EfficientSeg-B3 at 512x1024 b8 through the int8 path
    against bf16 on seeded weights; three convs' int32 accumulators held
    bitwise against the CPU's on the same int8 operands."""
    b, h, w = INT8_SHAPE
    models = {}
    for quant in ("none", "int8"):
        m = EfficientSeg(EfficientSegConfig(num_classes=8, compound_coef=3,
                                            compute_dtype=torch.bfloat16, quant=quant))
        init_random(m, torch.Generator().manual_seed(0))
        models[quant] = m.to(dev).eval()
    frames = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, (b, h, w, 3), dtype=np.uint8)).to(dev)
    anchors = torch.tensor(generate_anchors(
        h, w, pyramid_levels=models["none"].cfg.pyramid_levels,
        anchor_scale=models["none"].cfg.anchor_scale), device=dev)
    mods = dict(models["int8"].named_modules())
    # the first block's expand and project convs (1x1) and the U-Net input
    # stage's 3x3 (K = 171)
    block = next(n for n in mods if n.endswith("._expand_conv")).rsplit(".", 1)[0]
    held_convs = (f"{block}._expand_conv", f"{block}._project_conv",
                  "kp_header.double_conv_input.0")
    inputs = {}
    hooks = [mods[n].register_forward_pre_hook(
        lambda mod, args, n=n: inputs.setdefault(n, args[0].clone())) for n in held_convs]
    with torch.inference_mode():
        heads_q = models["int8"](frames)
        heads_f = models["none"](frames)
    for hook in hooks:
        hook.remove()
    held = []
    for n in held_convs:
        conv = getattr(mods[n], "conv", mods[n])      # a Conv2dSame's inner conv
        x_q, _, w_q, _ = quantize_int8(inputs[n], conv.weight)
        cx_q, _, cw_q, _ = quantize_int8(inputs[n].cpu(), conv.weight.cpu())
        check(torch.equal(x_q.cpu(), cx_q) and torch.equal(w_q.cpu(), cw_q),
              f"[17] int8 {n}: the card's int8 operands differ from the CPU's")
        acc = int8_accumulate(x_q, w_q, conv.padding[0])
        want = int8_accumulate(cx_q, cw_q, conv.padding[0])
        check(torch.equal(acc.cpu(), want), f"[17] int8 {n}: int32 accumulators differ")
        k = w_q.shape[1] * w_q.shape[2] * w_q.shape[3]
        held.append(f"{n} {tuple(acc.shape)} K={k} max|acc| {int(acc.abs().max())}")
    diff = {name: float((q.float() - f.float()).abs().max() / f.float().abs().max())
            for name, q, f in zip(("kp", "ae", "tan"), heads_q[:3], heads_f[:3])}
    ms = {}
    for quant, m in models.items():
        with torch.inference_mode():
            ms[quant] = timed_ms(lambda: decode.forward_and_decode(
                m, frames, anchors, 2 * h, 2 * w, 2.0, DecodeConfig()))
    print(f"[17] (b) int8 path, B3 {h}x{w} b{b}, seeded weights: int32 accumulators equal to the "
          f"CPU's bit for bit ({'; '.join(held)}); forward + decode ms int8 "
          f"{[round(t, 3) for t in ms['int8']]} (median {np.median(ms['int8']):.3f}) vs bf16 "
          f"{[round(t, 3) for t in ms['none']]} (median {np.median(ms['none']):.3f}); largest "
          f"head difference int8 vs bf16 (of max|bf16|) {diff}; [{smi}]", flush=True)
    del models, heads_q, heads_f, inputs


def phase_export(dev: torch.device, smi: str, base: Path) -> None:
    """Phase 17 (c): B3 at 512x1024 b1 exported on the card, saved, loaded,
    verified exactly, K1 launched once a call; request ms beside the
    Predictor's on the same seeded weights (whose outputs it must equal)."""
    t0 = time.perf_counter()
    h, w = EXPORT_HW
    program, live, example = export_model.build_export(3, (h, w), 1, 8, device=dev)
    export_s = time.perf_counter() - t0
    path = base / "b3.pt2"
    torch.export.save(program, str(path))
    loaded = export_model.load(str(path))
    export_model.verify(loaded, live, example)
    run = loaded.module()
    affinity.launches = 0
    with torch.no_grad():
        got = run(example)
    torch.cuda.synchronize()
    k1 = affinity.launches
    check(k1 == 1, f"[17] export: K1 launched {k1} times in one call of the program")
    pred = Predictor(EfficientSegConfig(num_classes=8, compound_coef=3,
                                        compute_dtype=torch.bfloat16),
                     DecodeConfig(), torch.Generator().manual_seed(0), dev,
                     orig_hw=(2 * h, 2 * w), scale=2.0)
    dets = pred.predict(example)
    same = all(torch.equal(g, w) for g, w in zip(got, (
        dets.classes, dets.scores, dets.centers, dets.polygons, dets.poly_len, dets.obj_valid)))
    check(same, "[17] export: the program's outputs differ from the Predictor's")
    with torch.no_grad():
        prog_ms = timed_ms(lambda: run(example), runs=9)
    pred_ms = timed_ms(lambda: pred.predict(example), runs=9)
    print(f"[17] (c) export (tools/export_model.py) B3 {h}x{w} b1 on the card: torch.export "
          f"{export_s:.1f} s, artifact {path.stat().st_size / 1e6:.1f} MB; loaded program equal "
          f"to the live model exactly and to the Predictor; K1 launches in one call {k1}; ms "
          f"per request loaded program {[round(t, 3) for t in prog_ms]} (median "
          f"{np.median(prog_ms):.3f}) vs Predictor {[round(t, 3) for t in pred_ms]} (median "
          f"{np.median(pred_ms):.3f}); [{smi}]", flush=True)


def phase_decode_centers(dev: torch.device) -> None:
    """Phase 17 (d): decode_centers on the card against the CPU."""
    h, w, n_cls = CENTERS_MAP
    rng = np.random.default_rng(6)
    conf = rng.uniform(-0.2, 1.0, (h, w)).astype(np.float32)
    conf[rng.uniform(size=(h, w)) < 0.3] = 0.0
    maps = (conf, rng.integers(0, n_cls, (h, w)).astype(np.int32),
            rng.uniform(2, 40, (h, w, 2)).astype(np.float32))
    card, host = ([t.cpu() for t in decode.decode_centers(
        *(torch.from_numpy(a).to(d) for a in maps), num_centers=2000, iou_th=0.5, max_out=96)]
        for d in (dev, torch.device("cpu")))
    for name, g, c in zip(("centers", "classes", "confs", "whs", "valid"), card, host):
        check(torch.equal(g, c), f"[17] decode_centers: {name} card != CPU")
    print(f"[17] (d) decode_centers on a seeded {h}x{w} map, 2000 peaks, {n_cls} classes: card "
          f"equal to CPU on all five outputs, {int(host[4].sum())} centres kept",
          flush=True)


def phase_convert_polygon(root: Path) -> None:
    """Phase 17 (e): the GT cleanup tool over the capstone's gtFine tree."""
    gt = root / "gtFine"
    before = sum(len(json.loads(p.read_text())["objects"])
                 for p in gt.rglob("*_gtFine_polygons.json"))
    t0 = time.perf_counter()
    written = convert_polygon.convert_tree(str(gt))
    seconds = time.perf_counter() - t0
    kept = sum(len(json.loads(Path(p).read_text())["objects"]) for p in written)
    check(len(written) == 8 and 0 < kept <= before,
          f"[17] convert_polygon: {len(written)} files, {kept} of {before} objects")
    print(f"[17] (e) convert_polygon over the capstone's gtFine tree: {len(written)} files, "
          f"{kept} of {before} objects kept, {seconds:.2f} s", flush=True)


def phase_last_modules(dev: torch.device, smi: str) -> None:
    """Phase 17: the capstone, int8, export, decode_centers, convert_polygon."""
    start = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR.parent) as tmp:
        base = Path(tmp)
        root = phase_capstone(dev, smi, base)
        gc.collect()
        phase_int8(dev, smi)
        gc.collect()
        phase_export(dev, smi, base)
        phase_decode_centers(dev)
        phase_convert_polygon(root)
    print(f"[17] phase 17 took {time.perf_counter() - start:.1f} s", flush=True)

# ---------------------------------------------------------------------------
# Phase 18: the profilers of the serving and from-disk training paths
# ---------------------------------------------------------------------------

TOOL_ITERS = {"infer": 20, "decode": 10, "blocks": 10, "train_blocks": 5}
TOOL_COMPOUND, TOOL_HW, TOOL_BATCH = 3, (512, 1024), 8   # the serving slice; frames 2x TOOL_HW
DATA_BENCH = {"images": 16, "steps": 8, "batch": 4, "workers": 4}   # (d), per mode
TOPK_ROUNDS = 6                      # (b): rounds of the top-k forms' timings
PHASE18_TIMEOUT = 600.0              # seconds for the phase's own process


def tool_log(part: str):
    """A tool's ``log``: its lines printed under the phase and the part."""
    def log(msg, **kw):
        print(f"[18] ({part}) {msg}", **kw)
    return log


def value_topk_by_sort(flat: torch.Tensor, k: int):
    """The value-ordered top-k as one stable descending sort of the
    monotonic keys: the form ``ops/decode.value_topk_indices`` was timed
    against (phase 18 (b))."""
    _, idx = torch.sort(decode._monotonic_u32(flat), dim=1, descending=True, stable=True)
    idx = idx[:, :k]
    return flat.gather(1, idx), idx


def phase_topk(dev: torch.device, smi: str) -> None:
    """Phase 18 (b), beside ``profile_decode``: the serving slice's b8
    keypoint map with the value-ordered top-k; the top-k forms timed and held
    (card against CPU, the sort against ``torch.topk`` over unique keys); K1
    held against its twin on the value-ordered inputs it gets; the approx
    decode of phase 4's scene card against CPU."""
    cfg = EfficientSegConfig(num_classes=8, compound_coef=TOOL_COMPOUND,
                             compute_dtype=torch.bfloat16)
    dcfg = DecodeConfig(exact_topk=False)
    h, w = TOOL_HW
    pred = Predictor(cfg, dcfg, torch.Generator().manual_seed(0), dev,
                     orig_hw=(2 * h, 2 * w), scale=2.0)
    frames = np.random.default_rng(0).integers(0, 256, (TOOL_BATCH, h, w, 3), dtype=np.uint8)
    affinity.launches = 0
    with first_k1_inputs() as served:
        dets = pred.predict(frames)
    torch.cuda.synchronize()
    check(affinity.launches == 1, f"[18] approx decode: K1 launched {affinity.launches} times")
    check(bool(torch.isfinite(dets.polygons).all()), "[18] approx decode: polygons not finite")
    with torch.inference_mode():
        kp = pred.model(torch.from_numpy(frames).to(dev))[0][..., 0].float()
    flat = kp.reshape(kp.shape[0], -1)
    k = dcfg.kp_th
    forms = {"value_topk_indices (torch.topk over unique keys)": decode.value_topk_indices,
             "stable sort of the keys": value_topk_by_sort,
             "exact bisection (exact_topk_indices)": decode.exact_topk_indices}
    got = {name: fn(flat, k) for name, fn in forms.items()}
    names = list(forms)
    check(torch.equal(got[names[0]][1], got[names[1]][1]),
          "[18] value-ordered top-k: torch.topk form and sort form differ")
    _, cpu_i = decode.value_topk_indices(flat.cpu(), k)
    check(torch.equal(got[names[0]][1].cpu(), cpu_i), "[18] value-ordered top-k: card != CPU")
    for exact in (False, True):
        card = [t.cpu() for t in decode.select_peaks_batch(kp, k, exact=exact)]
        host = decode.select_peaks_batch(kp.cpu(), k, exact=exact)
        check(all(torch.equal(a, b) for a, b in zip(card, host)),
              f"[18] select_peaks_batch(exact={exact}): card != CPU")
    ties = int((flat[:, None, :] == got[names[0]][0][:, -1:, None]).sum())
    forms["torch.topk of the values alone (ties not ruled)"] = (
        lambda f, k: torch.topk(f, k, dim=1))
    # in turns (forward and reverse order), each round: the CUDA events
    # around one call (host time before the first launch included) and the
    # device time of 20 calls queued behind a device wait (no host gaps)
    calls, queued = ({name: [] for name in forms} for _ in range(2))
    for r in range(TOPK_ROUNDS):
        for name in (list(forms) if r % 2 == 0 else list(forms)[::-1]):
            calls[name].append(cuda_median_ms(lambda fn=forms[name]: fn(flat, k)))
            queued[name].append(kernel_timing.queued_ms(lambda fn=forms[name]: fn(flat, k)))
    ascending = bool((served[0][..., 0] * w + served[0][..., 1]).diff(dim=1).ge(0).all())
    print(f"[18] (b) top-k of the b8 keypoint map {tuple(flat.shape)}, k={k}: the torch.topk "
          f"form equals the sort form and the CPU's; select_peaks_batch card == CPU in both "
          f"modes; values equal to the k-th {ties}; ms, {TOPK_ROUNDS} rounds in turns, each "
          f"the median of 20 calls between CUDA events | the device time of 20 calls queued: "
          + "; ".join(f"{name} {[round(t, 4) for t in calls[name]]} (median "
                      f"{np.median(calls[name]):.4f}) | {[round(t, 4) for t in queued[name]]} "
                      f"(median {np.median(queued[name]):.4f})" for name in forms)
          + f"; [{smi}]", flush=True)
    hold_affinity(18, f"the approx decode's b8 inputs (keypoints in value order; ascending "
                      f"pixel order {ascending})", served)
    phase_decode(dev, DecodeConfig(kp_th=2000, pre_nms=64, max_dets=8, max_poly=512,
                                   exact_topk=False), tag="[18] (b)")
    del pred


def phase_tools() -> None:
    """Phase 18 in a process of its own (``phase_tools_process``), so that
    its profiler windows come early in their process."""
    sys.stdout.flush()
    start = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", "import chip_smoke; "
                           "chip_smoke.phase_tools_process()"],
                          cwd=Path(__file__).resolve().parent, timeout=PHASE18_TIMEOUT)
    check(proc.returncode == 0, f"[18] phase 18 exited with {proc.returncode}")
    print(f"[18] phase 18 took {time.perf_counter() - start:.1f} s", flush=True)


def phase_tools_process() -> None:
    """Phase 18: the profilers through their entry points, on the card."""
    dev = require_cuda()
    kernel_timing.hook(build)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_name_power()
    shape = {"compound": TOOL_COMPOUND, "hw": TOOL_HW}
    for quant in ("none", "int8"):
        rec = profile_infer.run(batches=(1, TOOL_BATCH), iters=TOOL_ITERS["infer"], quant=quant,
                                log=tool_log("a"), **shape)
        for b, r in rec["batches"].items():
            check(r["k1_per_decode"] == 1.0,
                  f"[18] profile_infer {quant} b{b}: K1 {r['k1_per_decode']} launches a decode")
            check(bool(r["launches"]), f"[18] profile_infer {quant} b{b}: no device kernels "
                  f"in the profiled request")
    for topk in ("exact", "approx"):
        rec = profile_decode.run(batch=TOOL_BATCH, iters=TOOL_ITERS["decode"], topk=topk,
                                 log=tool_log("b"), **shape)
        check(rec["staged_equal"] and rec["k1_per_decode"] == 1.0,
              f"[18] profile_decode {topk}: {rec['k1_per_decode']} K1 launches a decode")
    gc.collect()
    phase_topk(dev, smi)
    gc.collect()
    profile_infer_blocks.run(batch=TOOL_BATCH, iters=TOOL_ITERS["blocks"], log=tool_log("c"),
                             **shape)
    profile_blocks.run(batch=TOOL_BATCH, iters=TOOL_ITERS["train_blocks"], log=tool_log("c"),
                       **shape)
    gc.collect()
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR.parent) as tmp:
        for mode in ("packed", "json"):
            rec = bench_train_data.run(mode, compound=TOOL_COMPOUND, out=tmp,
                                       frame_hw=(2 * TOOL_HW[0], 2 * TOOL_HW[1]), **DATA_BENCH)
            print(f"[18] (d) bench_train_data {json.dumps(rec)}", flush=True)
            steps = DATA_BENCH["steps"]
            check(all(n == steps for n in rec["launches"].values()),
                  f"[18] bench_train_data {mode}: launches {rec['launches']} in {steps} steps")
            check(np.isfinite(rec["total_loss"]), f"[18] bench_train_data {mode}: loss")
        stop_fork_server()
        trace_dir = Path(tmp) / "trace"
        out = subprocess.run(
            [sys.executable, "-m", "instance_segmentation_torch.tools.profile_infer",
             "--batches", "1", "--iters", "5", "--trace", str(trace_dir), "--top", "10",
             "--compound", str(TOOL_COMPOUND), "--hw", *map(str, TOOL_HW)],
            cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
            timeout=PHASE18_TIMEOUT)
        check(out.returncode == 0, f"[18] (e) profile_infer --trace failed: {out.stderr[-2000:]}")
        lines = out.stdout.strip().splitlines()
        for line in lines[:-1]:
            print(f"[18] (e) {line}", flush=True)
        traced = json.loads(lines[-1])["batches"]["1"]
        check(bool(traced["launches"]) and traced["idle_share"] is not None and traced["top"],
              "[18] (e) the trace holds no device kernels")


# ---------------------------------------------------------------------------
# Phase 19: the roofline of the train step, of serving and of the
# full-resolution step
# ---------------------------------------------------------------------------

ROOFLINE_RUNS = (  # (label, flags, the kernels of its path)
    ("train b8", ("--batch", "8"),
     ("rasterize_cnt_r2", "rasterize_nmap", "ae_terms_fwd", "ae_terms_bwd")),
    ("eval b8", ("--eval", "--batch", "8", "--by", "block"), ("affinity_assign", "nms_keep")),
    ("fullres b4", ("--fullres", "--batch", "4"),
     ("minr2_from_cnt", "ae_terms_fwd", "ae_terms_bwd", "rasterize_nmap")))
ROOFLINE_ITERS = 5
ROOFLINE_MATCHED = 0.9               # the least share of device kernel time joined
PHASE19_TIMEOUT = 600.0              # seconds for each run's process


def phase_roofline() -> None:
    """Phase 19: ``tools/roofline`` on the card, each run in a process of its
    own; fails unless a run joins ``ROOFLINE_MATCHED`` of its device kernel
    time and launches each kernel of its path with ``kernels/bounds.py``'s
    bytes."""
    start = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    for label, flags, kernels in ROOFLINE_RUNS:
        out = subprocess.run(
            [sys.executable, "-m", "instance_segmentation_torch.tools.roofline", *flags,
             "--iters", str(ROOFLINE_ITERS), "--top", "15"],
            cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
            timeout=PHASE19_TIMEOUT)
        check(out.returncode == 0, f"[19] roofline {label} failed: {out.stderr[-3000:]}")
        lines = out.stdout.strip().splitlines()
        for line in lines[:-1]:
            print(f"[19] ({label}) {line}", flush=True)
        rec = json.loads(lines[-1])
        print(f"[19] ({label}) {lines[-1]}", flush=True)
        check(rec["matched_share"] is not None and rec["matched_share"] >= ROOFLINE_MATCHED,
              f"[19] roofline {label}: joined {rec['matched_share']} of the kernel time")
        for name in kernels:
            k = rec["kernels"].get(name)
            check(k is not None and k["launches"] > 0 and k["calls"] > 0
                  and len(k["bytes"]) == k["calls"] and min(k["bytes"]) > 0,
                  f"[19] roofline {label}: {name} not launched with its bytes: {k}")
        check(all(rec[key] is not None for key in ("model_flops", "mfu", "bound_ms", "busy_ms")),
              f"[19] roofline {label}: a measure is missing")
    print(f"[19] phase 19 took {time.perf_counter() - start:.1f} s", flush=True)


def spatial_line(r: dict, b: dict, smi: str) -> str:
    """One full-width batch of a rank of phase 20 (b) or (c)."""
    ms = b["ms"]
    rel = ", ".join(f"{k} {v:.3g}" for k, v in b["heads_rel"].items())
    return (f"rank {r['rank']} of mesh data {r['mesh'][0]} x spatial {r['mesh'][1]} "
            f"({r['device']}), B3 512x1024 bf16 b{b['batch']}: ms/call "
            f"{[round(t, 3) for t in ms]} (median {np.median(ms):.3f}), peak device memory "
            f"{b['peak_bytes']} B ({b['peak_bytes'] / 2**30:.2f} GiB), collectives per forward "
            f"{b['collectives']} ({sum(b['collectives'].values())}), K1 launches "
            f"{b['k1_launches']} in {multichip.INFER_ITERS} calls; outputs against the one-rank "
            f"forward, max|diff| / max|.|: {rel} (<= {multichip.HEADS_REL_BF16}); objects "
            f"{b['objects']} on the mesh, {b['objects_one_rank']} on one rank; [{smi}]")


def phase_spatial(smi: str, one_card: Optional[dict]) -> None:
    """Phase 20: serving on a spatial mesh. (a) the dry run's check on two
    ranks of the one card over gloo, K1 held on rank 0's gathered maps;
    (b) those ranks at full width; (c) every card over NCCL when there are
    two or more, beside phase 5's ``one_card`` numbers."""
    start = time.perf_counter()
    smi = smi.replace("\n", "; ")           # one line for every card
    gc.collect()
    torch.cuda.empty_cache()
    results = spawn_ranks(2, ["--infer", "--check", "--device-type", "cuda", "--backend",
                              "gloo"], one_card=True)
    for r in results:
        check(not r["failures"], f"[20a] rank {r['rank']}: {r['failures']}")
        rel = ", ".join(f"{k} {v:.3g}" for k, v in r["heads_rel"].items())
        print(f"[20a] rank {r['rank']}/2 on one card over gloo, data 1 x spatial 2, B0 128x256 "
              f"f32, {r['frames']} frames: outputs against the one-rank forward, max|diff| / "
              f"max|.|: {rel} (<= {multichip.HEADS_REL_F32}); decode equal to the one-rank "
              f"decode (obj_valid, classes, boxes within {multichip.BOXES_ATOL}): {r['objects']} "
              f"objects; collectives per forward {r['collectives']}; K1 launches "
              f"{r['k1_launches']} for one decoded batch", flush=True)
    dets = [r["dets"] for r in results]
    check(all(torch.equal(a, b) for a, b in zip(*dets)),
          "[20a] the two spatial ranks' detections differ")
    dev = torch.device("cuda")
    hold_affinity(20, "rank 0's gathered maps, data 1 x spatial 2",
                  [t.to(dev) for t in results[0]["k1_inputs"]])

    results = spawn_ranks(2, ["--infer", "--device-type", "cuda", "--backend", "gloo"],
                          one_card=True)
    for r in results:
        check(not r["failures"], f"[20b] rank {r['rank']}: {r['failures']}")
        for b in r["batches"]:
            print("[20b] two ranks on one card over gloo (a correctness run: the ranks share "
                  "the card through the host), " + spatial_line(r, b, smi), flush=True)

    cards = torch.cuda.device_count()
    if cards < 2:
        print(f"[20c] NCCL over the spatial axis needs two cards; this machine has {cards}",
              flush=True)
    else:
        results = spawn_ranks(cards, ["--infer", "--spatial", str(cards), "--device-type",
                                      "cuda", "--backend", "nccl"])
        for r in results:
            check(not r["failures"], f"[20c] rank {r['rank']}: {r['failures']}")
            for b in r["batches"]:
                beside = ("" if one_card is None else
                          f" (phase 5, one card: median {one_card['ms'][b['batch']]:.3f} ms, "
                          f"peak {one_card['peak_bytes'] / 2**30:.2f} GiB)")
                print(f"[20c] {cards} cards over NCCL, " + spatial_line(r, b, smi) + beside,
                      flush=True)
    print(f"[20] phase 20 took {time.perf_counter() - start:.1f} s", flush=True)


def descendants() -> list:
    """(pid, command) of every live process below this one, from ``/proc``."""
    parent, command = {}, {}
    for entry in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{entry}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        head, tail = stat.rsplit(")", 1)
        fields = tail.split()
        if fields[0] != "Z":
            parent[int(entry)], command[int(entry)] = int(fields[1]), head.split("(", 1)[1]
    below, frontier = [], [os.getpid()]
    while frontier:
        kids = [pid for pid, pp in parent.items() if pp in frontier]
        below += kids
        frontier = kids
    return [(pid, command[pid]) for pid in below]


def phase_processes() -> None:
    """Phase 15: the fork server stopped, no process of this script is left
    but multiprocessing's resource tracker (its pipe from this process
    closes when this process ends, and it ends then)."""
    stop_fork_server()
    tracker = multiprocessing.resource_tracker._resource_tracker._pid
    left = [p for p in descendants() if p[0] != tracker]
    check(not left, f"[15] processes still running: {left}")
    print(f"[15] no process left running (resource tracker {tracker} ends with this one)",
          flush=True)


def main() -> None:
    dev = require_cuda()
    kernel_timing.hook(build)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_name_power()
    print(f"[1] device {name} (count {torch.cuda.device_count()}); nvidia-smi: {smi}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    built = build.build_all(KERNELS + ("nms",) + HOST_HELPERS)
    lib, seconds = built["affinity"]
    build.load("affinity")
    print(f"[2] built K1 {lib.relative_to(build.BUILD_DIR.parents[1])} in "
          f"{seconds:.2f} s; ptxas: {'; '.join(build.ptxas_usage('affinity'))}", flush=True)

    phase_affinity(dev)
    nms_records = phase_nms(dev)
    phase_decode(dev)
    launches, served, one_card = phase_slice(dev, smi)
    record = hold_affinity(5, "the serving slice's first b8 call", served)
    record["launches"] = launches["affinity"]
    for r in nms_records:                 # per replayed request at the record's batch
        r["launches"] = launches["nms"][r["shape"][0]]

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
    phase_spatial(smi, one_card)
    phase_eval_slice(dev, smi)
    phase_train_cli(dev, smi)
    phase_coco(dev, smi)
    phase_last_modules(dev, smi)
    phase_tools()
    phase_roofline()
    phase_processes()

    print(json.dumps({"kernels": [record] + nms_records + records + [k6_record]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
