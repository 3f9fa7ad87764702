"""The least time of a MaxViT backbone's attention sub-blocks on the H100,
from their shapes, whatever implements them.

A sub-block (``reference/maxvit.py``: layer norm, partition, QKV,
attention, projection, inverse partition, residual) over T tokens of C
channels in groups of N = P * P does 2 FLOPs a multiply-add: the QKV
product 2 T C 3C, the logits q k^T and the product A v 2 T N C each, and the
projection 2 T C C. Its least bytes are its input read once and its output
written once in the activation dtype, its QKV and projection weights and
biases in the activation dtype (as serving holds them), and its float32
layer-norm parameters and bias table. A sub-block's least time is the
larger of its FLOPs over the dense bf16 peak and its bytes over the memory
rate (``bounds.py``'s peaks); the backbone's is the sum over its sub-blocks
(block and grid attention in every block), which run one after another.
"""

from __future__ import annotations

from typing import List

from benchmark.counts.bounds import BF16_FLOPS_PER_S, BYTES_PER_S, Work
from benchmark.reference.maxvit import TABLES


def sub_block(tokens: int, c: int, heads: int, p: int, act_bytes: int = 2) -> Work:
    """(bytes, FLOPs) of one attention sub-block over ``tokens`` tokens."""
    n = p * p
    flops = 2 * tokens * c * 3 * c + 2 * 2 * tokens * n * c + 2 * tokens * c * c
    moved = ((2 * tokens * c + 4 * c * c + 4 * c) * act_bytes
             + 4 * (heads * (2 * p - 1) ** 2 + 2 * c))
    return Work(moved, flops)


def sub_blocks(name: str, n: int, h: int, w: int, act_bytes: int = 2) -> List[Work]:
    """The attention sub-blocks of backbone ``name`` on an [n, 3, h, w]
    frame, in order (the stem halves h and w, each stage again)."""
    a = TABLES[name]
    h, w = h // 2, w // 2
    out = []
    for depth, c in zip(a.depths, a.channels):
        h, w = h // 2, w // 2
        one = sub_block(n * h * w, c, c // a.head_dim, a.partition, act_bytes)
        out += [one] * (2 * depth)
    return out


def least_seconds(works: List[Work]) -> float:
    """The sum over the sub-blocks of each one's larger of FLOPs over the
    bf16 peak and bytes over the memory rate."""
    return sum(max(w.ops / BF16_FLOPS_PER_S, w.bytes / BYTES_PER_S) for w in works)
