"""Greedy NMS over a suppression matrix (``csrc/nms.cu``): the keep mask of
``ops/decode.leader_nms``.

Replaces no TPU kernel: the JAX decode runs NMS as a ``lax.while_loop`` of
whole-array sweeps, which, run eagerly, need a host read of the loop's
condition after each sweep, and a CUDA graph holds no host read. Given
``sup`` [B, K, K] bool (``sup[b, j, i]``: keeping box j suppresses box i;
only j < i, boxes in rank order) and ``valid`` [B, K] bool, ``keep``
[B, K] bool is the sequential greedy result

    keep_i = valid_i and not any(keep_j and sup[j, i] for j < i),

the unique fixpoint of those sweeps. The kernel reads only ``sup``'s strict
upper triangle and does no float arithmetic, so the IoUs and their threshold
stay PyTorch's.

``nms_keep`` checks its inputs and launches the kernel on the current stream
(no host read, so a CUDA graph can hold it); it takes CUDA tensors only, and
``ops/decode.leader_nms`` calls it on those alone. ``nms_keep_plain`` is its
twin, the fixpoint as ``leader_nms`` runs it eagerly on the CPU. ``launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from instance_segmentation_torch.kernels import build

launches = 0


def nms_keep_plain(sup: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The twin: ``leader_nms``'s fixpoint run eagerly (``ops/decode._nms_eager``,
    one host read of the loop's condition a sweep, each in a span
    "sync:nms")."""
    from instance_segmentation_torch.ops import decode     # decode imports this module
    sweeps = torch.zeros((), dtype=torch.int64, device=sup.device)
    return decode._nms_eager((valid.clone(), ~valid, sweeps), (valid, sup))


def _check(sup: torch.Tensor, valid: torch.Tensor) -> Tuple[int, int]:
    if valid.dim() != 2 or valid.dtype != torch.bool:
        raise ValueError(f"valid: want bool [B, K], got {valid.dtype} {tuple(valid.shape)}")
    B, K = valid.shape
    if tuple(sup.shape) != (B, K, K) or sup.dtype != torch.bool:
        raise ValueError(f"sup: want bool {(B, K, K)}, got {sup.dtype} {tuple(sup.shape)}")
    if sup.device != valid.device:
        raise ValueError("nms inputs lie on different devices")
    if not (sup.is_contiguous() and valid.is_contiguous()):
        raise ValueError("nms inputs must be contiguous")
    return B, K


@functools.cache
def _kernel():
    lib = build.load("nms")
    lib.iseg_nms_scratch_words.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.iseg_nms_scratch_words.restype = ctypes.c_longlong
    fn = lib.iseg_nms_keep
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    return fn, lib.iseg_nms_scratch_words


def nms_keep(sup: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The greedy keep mask [B, K] bool of CUDA tensors, by the kernel."""
    global launches
    B, K = _check(sup, valid)
    if valid.device.type != "cuda":
        raise ValueError(f"nms_keep launches a CUDA kernel: want cuda tensors, not {valid.device}")
    keep = torch.empty((B, K), dtype=torch.bool, device=valid.device)
    if B * K == 0:
        return keep
    fn, scratch_words = _kernel()
    words = scratch_words(B, K)
    scratch = torch.empty(words, dtype=torch.int32, device=valid.device) if words else None
    err = build.launch(fn, valid.device, sup.data_ptr(), valid.data_ptr(), B, K,
                       None if scratch is None else scratch.data_ptr(), keep.data_ptr())
    if err != 0:
        raise RuntimeError(f"nms kernel launch failed: CUDA error {err}")
    launches += 1
    return keep
