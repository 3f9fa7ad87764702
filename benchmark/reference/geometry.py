"""Polygon geometry on tensors.

Counterpart of ``point_in_polygon``, ``polygon_area`` and
``rasterize_polygon`` in ``instance_segmentation_tpu/ops/geometry.py``.
Polygons are replication-padded [..., V, 2]: vertices past the valid count
repeat the last valid vertex, so the closing edge list holds the valid edges
plus zero-length ones that cross nothing.
"""

from __future__ import annotations

import torch


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once to float32, as a fused multiply-add: the
    product of two float32 values is exact in float64, so one float64 add and
    one cast reproduce the reference's contracted arithmetic (its compiler
    fuses these expressions), where separate float32 ops would round twice."""
    return (a.double() * b.double() + c.double()).float()


def point_in_polygon(points: torch.Tensor, poly: torch.Tensor) -> torch.Tensor:
    """Even-odd (crossing number) test: True when strictly inside.

    points: [..., P, 2]; poly: [..., V, 2], with the same leading dims, in
    the same (first, second) coordinate order; the ray runs along +second.
    Returns bool [..., P].
    """
    py, px = points[..., 0:1], points[..., 1:2]                 # [..., P, 1]
    ay, ax = poly[..., None, :, 0], poly[..., None, :, 1]       # [..., 1, V]
    by, bx = torch.roll(ay, -1, dims=-1), torch.roll(ax, -1, dims=-1)
    cond = (ay > py) != (by > py)                               # [..., P, V]
    denom = by - ay
    denom = torch.where(denom == 0, torch.ones_like(denom), denom)
    t = torch.where(cond, (py - ay) / denom, torch.zeros_like(py))
    x_int = fma(t, bx - ax, ax)
    crossing = cond & (px < x_int)
    return crossing.sum(dim=-1) % 2 == 1


def polygon_area(poly: torch.Tensor) -> torch.Tensor:
    """|shoelace| area of replication-padded polygons [..., V, 2] (zero
    edges drop out, so the valid vertex count is not needed)."""
    y, x = poly[..., 0], poly[..., 1]
    y2, x2 = torch.roll(y, -1, dims=-1), torch.roll(x, -1, dims=-1)
    return 0.5 * torch.abs(torch.sum(x * y2 - x2 * y, dim=-1))


RASTER_CHUNK = 16      # polygons a pass: bounds the [chunk, h, V] crossing tables


def rasterize_polygon(poly: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Even-odd scanline rasterization of padded (row, col) polygons
    [..., V, 2] -> bool [..., h, w], on the polygons' device: a pixel is
    inside when an odd number of edge crossings of its row lie strictly left
    of its column. The reference's arithmetic (edge crossings with one
    rounding of ``ax + t * (bx - ax)``, sorted, then counted by a left
    binary search), so masks agree with it bit for bit. ``RASTER_CHUNK``
    polygons at a time."""
    flat = poly.reshape(-1, *poly.shape[-2:])
    masks = [_rasterize(flat[i:i + RASTER_CHUNK], h, w)
             for i in range(0, flat.shape[0], RASTER_CHUNK)]
    out = torch.cat(masks) if masks else torch.zeros((0, h, w), dtype=torch.bool,
                                                     device=poly.device)
    return out.reshape(*poly.shape[:-2], h, w)


def _rasterize(poly: torch.Tensor, h: int, w: int) -> torch.Tensor:
    rows = torch.arange(h, dtype=torch.float32, device=poly.device)[:, None]      # [h, 1]
    ay, ax = poly[..., None, :, 0], poly[..., None, :, 1]                        # [..., 1, V]
    by, bx = torch.roll(ay, -1, dims=-1), torch.roll(ax, -1, dims=-1)
    cond = (ay > rows) != (by > rows)                                            # [..., h, V]
    denom = by - ay
    denom = torch.where(denom == 0, torch.ones_like(denom), denom)
    t = torch.where(cond, (rows - ay) / denom, torch.zeros_like(cond, dtype=poly.dtype))
    x_int = torch.where(cond, fma(t, bx - ax, ax), torch.full_like(t, float("inf")))
    x_sorted = torch.sort(x_int, dim=-1).values.contiguous()                     # [..., h, V]
    cols = torch.arange(w, dtype=torch.float32, device=poly.device)
    cols = cols.expand(*x_sorted.shape[:-1], w).contiguous()
    idx = torch.searchsorted(x_sorted, cols, side="left")
    return idx % 2 == 1
