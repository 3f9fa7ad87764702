"""Fixed-iteration k-means with an outlier gate.

Counterpart of ``instance_segmentation_tpu/ops/kmeans.py`` (ref
utils/kmeans.py:16-93): Lloyd iterations from given initial centres, a
fixed iteration count instead of the reference's convergence loop, points
farther than ``max_distance`` from every centre (or not ``valid``) labelled
K. Batched over any leading dimensions (the JAX decode ``vmap``s it over
images). The centre update ``member.T @ points`` is a plain product, as
there; no TPU kernel stands behind this module.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def pairwise_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distances [..., N, K] of a [..., N, D] and b
    [..., K, D] (ref kmeans.py:96-112)."""
    return ((a[..., :, None, :] - b[..., None, :, :]) ** 2).sum(-1)


def pairwise_cosine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """1 - cosine similarity [..., N, K] (ref kmeans.py:115-130)."""
    an = a / a.norm(dim=-1, keepdim=True).clamp(min=1e-8)
    bn = b / b.norm(dim=-1, keepdim=True).clamp(min=1e-8)
    return 1.0 - an @ bn.transpose(-1, -2)


def kmeans(points: torch.Tensor, init_centers: torch.Tensor,
           valid: Optional[torch.Tensor] = None, max_distance: float = math.inf,
           num_iters: int = 10, distance: str = "euclidean"
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lloyd iterations with an outlier gate: points [..., N, D],
    init_centers [..., K, D], valid bool [..., N]. Returns (labels
    [..., N] int32 in [0, K], K marking outliers and invalid points;
    centres [..., K, D]). Invalid points take no part in the updates; a
    centre with no member becomes 0 (its sum over a count clamped to 1), as
    in the JAX package."""
    k = init_centers.shape[-2]
    if valid is None:
        valid = torch.ones(points.shape[:-1], dtype=torch.bool, device=points.device)
    dist_fn = pairwise_cosine if distance == "cosine" else pairwise_distance
    weight = valid[..., None].to(points.dtype)
    centers = init_centers
    for _ in range(num_iters):
        labels = dist_fn(points, centers).argmin(-1)
        member = F.one_hot(labels, k).to(points.dtype) * weight             # [..., N, K]
        counts = member.sum(-2).clamp(min=1.0)                               # [..., K]
        centers = (member.transpose(-1, -2) @ points) / counts[..., None]
    d = dist_fn(points, centers)
    labels = d.argmin(-1)
    best = d.gather(-1, labels[..., None])[..., 0]
    labels = torch.where(valid & (best <= max_distance), labels, torch.full_like(labels, k))
    return labels.int(), centers
