"""On-device, static-shape target generation from packed polygon labels.

Counterpart of ``instance_segmentation_tpu/ops/targets.py`` (``Targets``,
``_sample_one_polygon``, ``generate_targets``), batched over images and
instances instead of vmapped. Label packing, as in the reference:

    polys:   f32 [B, M, V, 2]  (row, col), replication-padded vertices
    n_verts: i32 [B, M]
    cls_ids: i32 [B, M]        (-1 for padding instances)

Produced targets:

    det_ann:  f32 [B, M, 5]     (x1, y1, x2, y2, cls), -1 rows for padding
    centers:  f32 [B, M, 2]     box centers (row, col)
    inst_valid: bool [B, M]
    points:   i32 [B, M, P, 2]  boundary samples, 2 px max-norm spacing
    normals:  f32 [B, M, P, 2]  inward unit normals per sample
    pt_valid: bool [B, M, P]
    kp_tgt:   f32 [B, H, W]    1 at every valid sample pixel (``dense_kp``,
              the default as in JAX), else None: the train step asks for
              ``dense_kp=False`` and its kp loss reads the rasterizer's
              union map, the same binary map

The reference picks each slot's edge data with a one-hot matmul at HIGHEST
precision (exact); here it is a plain gather. The sample position
``v0 + d / md * k`` is rounded once, as a fused multiply-add, the way the
reference's compiler contracts it: one ulp decides which pixel a sample
truncates to.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from benchmark.reference.geometry import fma, point_in_polygon


class Targets(NamedTuple):
    det_ann: torch.Tensor      # [B, M, 5]
    centers: torch.Tensor      # [B, M, 2] (row, col) float
    inst_valid: torch.Tensor   # [B, M] bool
    points: torch.Tensor       # [B, M, P, 2] int32 (row, col)
    normals: torch.Tensor      # [B, M, P, 2] float32
    pt_valid: torch.Tensor     # [B, M, P] bool
    kp_tgt: Optional[torch.Tensor]


def _sample_one_polygon(poly: torch.Tensor, max_points: int, h: int, w: int):
    """Dense boundary sampling of replication-padded polygons [..., V, 2]
    (padded edges are zero-length and emit no samples). Walks each edge in
    steps of 2 px of max-norm distance, emitting the integer point and the
    edge's inward unit normal; points within 2 px of the border are dropped.
    Returns (points i32 [..., P, 2], normals f32 [..., P, 2], valid [..., P])."""
    v0 = poly
    v1 = torch.roll(poly, -1, dims=-2)
    d = v1 - v0                                                   # [..., V, 2]
    max_dist = torch.maximum(d[..., 0].abs(), d[..., 1].abs())    # [..., V]
    m_int = torch.floor(max_dist).to(torch.int32)
    n_samp = torch.where(max_dist > 0, torch.div(m_int + 1, 2, rounding_mode="floor"),
                         torch.zeros_like(m_int))

    # inward normal per edge: n = (-dcol, drow), normalized, flipped if
    # midpoint + n / |max(n)| falls outside the polygon
    normal = torch.stack([-d[..., 1], d[..., 0]], dim=-1)
    norm_len = torch.clamp_min(torch.sqrt((normal * normal).sum(-1, keepdim=True)), 1e-4)
    normal = normal / norm_len
    step = normal / torch.clamp_min(normal.max(dim=-1, keepdim=True).values.abs(), 1e-8)
    test_pts = (v0 + v1) / 2.0 + step                             # [..., V, 2]
    inside = point_in_polygon(test_pts, poly)                     # [..., V]
    normal = torch.where(inside[..., None], normal, -normal)

    cum = torch.cumsum(n_samp, dim=-1)                            # [..., V]
    total = cum[..., -1:]
    slots = torch.arange(max_points, device=poly.device, dtype=torch.int32)
    # edge index = number of cum entries <= slot (searchsorted side="right")
    edge = (cum[..., None, :] <= slots[:, None]).sum(-1)          # [..., P]
    edge = edge.clamp(0, poly.shape[-2] - 1)
    cum_prev = (cum - n_samp).to(torch.float32)

    def pick(t):                                                  # [..., V, C] -> [..., P, C]
        idx = edge[..., None].expand(*edge.shape, t.shape[-1])
        return torch.gather(t, -2, idx)

    v0_s, d_s, nrm = pick(v0), pick(d), pick(normal)
    md_s = pick(max_dist[..., None])[..., 0]
    start = pick(cum_prev[..., None])[..., 0]
    k = (slots.to(torch.float32) - start) * 2.0                   # step along the edge
    md = torch.clamp_min(md_s, 1e-8)
    pts = fma(d_s / md[..., None], k[..., None], v0_s)            # [..., P, 2]

    in_bounds = ((pts[..., 0] > 1) & (pts[..., 0] < h - 2) &
                 (pts[..., 1] > 1) & (pts[..., 1] < w - 2))
    valid = (slots < total) & in_bounds
    return pts.to(torch.int32), nrm, valid                        # trunc == floor (coords >= 0)


def generate_targets(polys: torch.Tensor, n_verts: torch.Tensor, cls_ids: torch.Tensor,
                     h: int, w: int, max_points: int = 2048,
                     dense_kp: bool = True) -> Targets:
    """Batch target generation. polys [B,M,V,2] f32, n_verts [B,M], cls_ids
    [B,M] int. ``dense_kp`` scatters the max of the valid samples, their
    indices clipped into the map, into a zero [B, H, W] map (JAX :143-152);
    without it ``kp_tgt`` is None."""
    del n_verts          # replication padding makes the vertex count unneeded
    inst_valid = cls_ids >= 0                                     # [B, M]
    ymin, ymax = polys[..., 0].amin(-1), polys[..., 0].amax(-1)
    xmin, xmax = polys[..., 1].amin(-1), polys[..., 1].amax(-1)
    det = torch.stack([xmin, ymin, xmax, ymax, cls_ids.to(torch.float32)], dim=-1)
    det = torch.where(inst_valid[..., None], det, torch.full_like(det, -1.0))
    centers = torch.stack([(ymin + ymax) / 2.0, (xmin + xmax) / 2.0], dim=-1)
    points, normals, pt_valid = _sample_one_polygon(polys, max_points, h, w)
    pt_valid = pt_valid & inst_valid[..., None]
    kp_tgt = None
    if dense_kp:
        B = polys.shape[0]
        rows = points[..., 0].reshape(B, -1).clamp(0, h - 1).long()
        cols = points[..., 1].reshape(B, -1).clamp(0, w - 1).long()
        kp_tgt = torch.zeros(B, h * w, dtype=torch.float32, device=polys.device)
        kp_tgt.scatter_reduce_(1, rows * w + cols, pt_valid.reshape(B, -1).to(torch.float32),
                               reduce="amax")
        kp_tgt = kp_tgt.view(B, h, w)
    return Targets(det_ann=det, centers=centers, inst_valid=inst_valid, points=points,
                   normals=normals, pt_valid=pt_valid, kp_tgt=kp_tgt)


def _shift_zero_fill(x: torch.Tensor, d: int, dim: int) -> torch.Tensor:
    """x shifted by d along dim (out[i] = x[i - d]), zeros shifted in."""
    y = torch.roll(x, d, dims=dim)
    if d > 0:
        y.narrow(dim, 0, d).zero_()
    elif d < 0:
        y.narrow(dim, x.shape[dim] + d, -d).zero_()
    return y


def gaussian_window_target(points: torch.Tensor, pt_valid: torch.Tensor, h: int, w: int,
                           radius: int = 3) -> torch.Tensor:
    """The radius-3 CenterNet gaussian (sigma = diameter / 6) max-splatted at
    every valid sample, [..., h, w] for points [..., P, 2] (row, col) and
    pt_valid [..., P]; the reference's ``gaussian_window_target`` for each
    leading index. Samples are clipped into the window; impulses are
    max-spread by a column pass then a row pass of gaussian-weighted shifts
    (the weights rounded to float32, the products in float32)."""
    *lead, _, _ = points.shape
    n = math.prod(lead)
    ys = points[..., 0].clamp(0, h - 1).long()
    xs = points[..., 1].clamp(0, w - 1).long()
    base = torch.arange(n, device=points.device).view(*lead, 1) * (h * w)
    impulses = torch.zeros(n * h * w, dtype=torch.float32, device=points.device)
    impulses[(base + ys * w + xs)[pt_valid]] = 1.0
    impulses = impulses.view(*lead, h, w)
    sigma = (2 * radius + 1) / 6.0
    tmp = impulses
    for dx in range(-radius, radius + 1):
        if dx:
            g = math.exp(-(dx * dx) / (2.0 * sigma * sigma))
            tmp = torch.maximum(tmp, g * _shift_zero_fill(impulses, dx, -1))
    out = tmp
    for dy in range(-radius, radius + 1):
        if dy:
            g = math.exp(-(dy * dy) / (2.0 * sigma * sigma))
            out = torch.maximum(out, g * _shift_zero_fill(tmp, dy, -2))
    return out
