"""Kernel K1: keypoint -> center affinity grouping (``csrc/affinity.cu``).

Replaces ``instance_segmentation_tpu/ops/pallas_kernels.py:affinity_assign``,
batched over images, and computes the JAX decode's grouping expression
(``ops/decode.py``: ``dists * contained``, then ``jnp.argmax``). For each
keypoint: box containment x det_valid x ``exp(-sum((emb - c_emb)^2 * sig))``
over the centers, then the first-max argmax (``assign``, int32) and the max
(``best``, float32). A keypoint whose scores are all 0 gets slot 0. A NaN
score counts above every number and the first NaN wins, and NaN * 0 is NaN,
so a NaN can come from a pair outside its box: the expression's own rules,
op by op (under ``jax.jit`` XLA rewrites the product into a select, which
scores an outside pair 0).

``affinity_assign`` checks its inputs and calls the custom op
``torch.ops.iseg.affinity_assign``, registered here: its CUDA implementation
launches the kernel, its CPU implementation runs the plain PyTorch version,
and its fake implementation gives the output shapes, so ``torch.export``
captures the call as one node (importing this module registers the op, as
loading an exported program needs). Any other device raises. ``launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from instance_segmentation_torch.kernels import build

MAX_CENTERS = 1024
launches = 0


def contained_plain(kp_rc: torch.Tensor, boxes: torch.Tensor,
                    det_valid: torch.Tensor) -> torch.Tensor:
    """[B,K,D] bool: keypoint k lies in the box of valid detection d."""
    row, col = kp_rc[..., 0:1], kp_rc[..., 1:2]                        # [B,K,1]
    return ((row >= boxes[:, None, :, 1]) & (row <= boxes[:, None, :, 3]) &
            (col >= boxes[:, None, :, 0]) & (col <= boxes[:, None, :, 2]) &
            det_valid[:, None, :])


def affinity_scores_plain(kp_rc: torch.Tensor, emb: torch.Tensor, sig: torch.Tensor,
                          c_emb: torch.Tensor, boxes: torch.Tensor,
                          det_valid: torch.Tensor) -> torch.Tensor:
    """The reference's dense scores (``ops/decode.py`` grouping), [B,K,D]:
    ``exp(-sum((emb - c_emb)^2 * sig)) * contained``. A NaN stays NaN outside
    the box too (NaN * 0)."""
    dists = torch.exp(-(((emb[:, :, None, :] - c_emb[:, None, :, :]) ** 2)
                        * sig[:, :, None, :]).sum(dim=-1))              # [B,K,D]
    return dists * contained_plain(kp_rc, boxes, det_valid).float()


def affinity_assign_plain(kp_rc: torch.Tensor, emb: torch.Tensor, sig: torch.Tensor,
                          c_emb: torch.Tensor, boxes: torch.Tensor,
                          det_valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's grouping, batched: kp_rc/emb/sig [B,K,2], c_emb
    [B,D,2], boxes [B,D,4] (x1,y1,x2,y2), det_valid [B,D] -> (assign [B,K]
    int32, best [B,K] float32). ``max(dim)`` takes the first maximum and,
    as ``jnp.argmax``, the first NaN over any number (on the CPU)."""
    best, assign = affinity_scores_plain(kp_rc, emb, sig, c_emb, boxes, det_valid).max(dim=-1)
    return assign.int(), best


def _check(kp_rc, emb, sig, c_emb, boxes, det_valid) -> Tuple[int, int, int]:
    B, K = kp_rc.shape[0], kp_rc.shape[1]
    D = c_emb.shape[1] if c_emb.dim() == 3 else -1
    want = {"kp_rc": (kp_rc, (B, K, 2)), "emb": (emb, (B, K, 2)),
            "sig": (sig, (B, K, 2)), "c_emb": (c_emb, (B, D, 2)),
            "boxes": (boxes, (B, D, 4))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{name}: want float32 {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if tuple(det_valid.shape) != (B, D) or det_valid.dtype != torch.bool:
        raise ValueError(f"det_valid: want bool {(B, D)}, got {det_valid.dtype} "
                         f"{tuple(det_valid.shape)}")
    if not 1 <= D <= MAX_CENTERS:
        raise ValueError(f"affinity kernel takes 1..{MAX_CENTERS} centers, got {D}")
    tensors = (kp_rc, emb, sig, c_emb, boxes, det_valid)
    if any(t.device != kp_rc.device for t in tensors):
        raise ValueError("affinity inputs lie on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("affinity inputs must be contiguous")
    return B, K, D


@functools.cache
def _kernel():
    fn = build.load("affinity").iseg_affinity_assign
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    return fn


def _launch(kp_rc, emb, sig, c_emb, boxes, det_valid):
    global launches
    B, K, D = _check(kp_rc, emb, sig, c_emb, boxes, det_valid)
    if any(t.data_ptr() % 8 for t in (kp_rc, emb, sig)):
        raise ValueError("affinity kernel reads kp_rc, emb and sig as 8-byte pairs: "
                         "they must be 8-byte aligned")
    # two allocations: a custom op's outputs may not alias one another
    assign = torch.empty((B, K), dtype=torch.int32, device=kp_rc.device)
    best = torch.empty((B, K), dtype=torch.float32, device=kp_rc.device)
    if B * K == 0:
        return assign, best
    err = build.launch(_kernel(), kp_rc.device, kp_rc.data_ptr(), emb.data_ptr(),
                       sig.data_ptr(), c_emb.data_ptr(), boxes.data_ptr(), det_valid.data_ptr(),
                       B, K, D, assign.data_ptr(), best.data_ptr())
    if err != 0:
        raise RuntimeError(f"affinity kernel launch failed: CUDA error {err}")
    launches += 1
    return assign, best


@torch.library.custom_op("iseg::affinity_assign", mutates_args=(), device_types="cpu")
def _affinity_op(kp_rc: torch.Tensor, emb: torch.Tensor, sig: torch.Tensor,
                 c_emb: torch.Tensor, boxes: torch.Tensor,
                 det_valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    _check(kp_rc, emb, sig, c_emb, boxes, det_valid)
    return affinity_assign_plain(kp_rc, emb, sig, c_emb, boxes, det_valid)


@_affinity_op.register_kernel("cuda")
def _affinity_op_cuda(kp_rc, emb, sig, c_emb, boxes, det_valid):
    return _launch(kp_rc, emb, sig, c_emb, boxes, det_valid)


@_affinity_op.register_fake
def _affinity_op_fake(kp_rc, emb, sig, c_emb, boxes, det_valid):
    shape = kp_rc.shape[:2]
    return kp_rc.new_empty(shape, dtype=torch.int32), kp_rc.new_empty(shape)


def affinity_assign(kp_rc: torch.Tensor, emb: torch.Tensor, sig: torch.Tensor,
                    c_emb: torch.Tensor, boxes: torch.Tensor,
                    det_valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grouping: (assign [B,K] int32, best [B,K] float32) by the op
    ``iseg::affinity_assign``. CUDA tensors run kernel K1; CPU tensors run
    ``affinity_assign_plain``."""
    if kp_rc.device.type not in ("cuda", "cpu"):
        raise ValueError(f"affinity_assign runs on cuda or cpu tensors, not {kp_rc.device}")
    _check(kp_rc, emb, sig, c_emb, boxes, det_valid)
    return torch.ops.iseg.affinity_assign(kp_rc, emb, sig, c_emb, boxes, det_valid)
