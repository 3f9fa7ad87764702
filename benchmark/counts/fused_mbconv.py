"""The least time of an EfficientNetV2 backbone's Fused-MBConv stages on the
H100, from their shapes.

Each fused block (``reference/efficientnetv2.py``) does its convolutions'
FLOPs, 2 a multiply-add: the k x k conv with the block's stride into the
expanded width and the 1x1 project conv (with expand 1 the k x k conv
alone). Its least bytes are its input read once, its output written once
and its parameters read once: the conv kernels in the activation dtype (as
serving holds them) and four float32 vectors a batch norm. The stages'
least time is the larger of their FLOPs over the dense bf16 peak and their
bytes over the memory rate (``bounds.py``'s peaks).
"""

from __future__ import annotations

import math

from benchmark.counts.bounds import BF16_FLOPS_PER_S, BYTES_PER_S, Work
from benchmark.reference.efficientnetv2 import FUSED, blocks


def fused_block(n: int, h: int, w: int, k: int, stride: int, expand: int, cin: int,
                cout: int, act_bytes: int = 2) -> Work:
    """(bytes, FLOPs) of one fused block on an [n, cin, h, w] input."""
    ho, wo = math.ceil(h / stride), math.ceil(w / stride)
    out_px = n * ho * wo
    if expand != 1:
        mid = cin * expand
        flops = 2 * out_px * mid * k * k * cin + 2 * out_px * cout * mid
        weights = mid * k * k * cin + cout * mid
        norms = mid + cout
    else:
        flops = 2 * out_px * cout * k * k * cin
        weights = cout * k * k * cin
        norms = cout
    moved = (n * cin * h * w + out_px * cout + weights) * act_bytes + 4 * 4 * norms
    return Work(moved, flops)


def fused_stages(name: str, n: int, h: int, w: int, act_bytes: int = 2) -> Work:
    """(bytes, FLOPs) of the fused blocks of backbone ``name`` on an [n, 3,
    h, w] frame (after its stride-2 stem, TF-SAME)."""
    h, w = math.ceil(h / 2), math.ceil(w / 2)
    total = Work(0, 0)
    for kind, k, s, e, cin, cout, _ in blocks(name):
        if kind != FUSED:
            continue
        one = fused_block(n, h, w, k, s, e, cin, cout, act_bytes)
        total = Work(total.bytes + one.bytes, total.ops + one.ops)
        h, w = math.ceil(h / s), math.ceil(w / s)
    return total


def least_seconds(work: Work) -> float:
    """The larger of FLOPs over the bf16 peak and bytes over the memory rate."""
    return max(work.ops / BF16_FLOPS_PER_S, work.bytes / BYTES_PER_S)

