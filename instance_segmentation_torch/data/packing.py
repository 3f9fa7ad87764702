"""Ragged label -> static-shape packing; a copy of
``instance_segmentation_tpu/data/packing.py`` (numpy only).

The reference's collate keeps labels as python lists of ragged polygon arrays
(ref data/__init__.py:42-52), which forces host-side target generation. Here
every image's label becomes three fixed-size arrays (the defining constraint
of the TPU rebuild, SURVEY.md §7.3):

    polys:   f32 [M, V, 2] (row, col), replication-padded
    n_verts: i32 [M]
    cls_ids: i32 [M]   (-1 padding)

Instances beyond M are dropped largest-first is NOT what we want — we keep
the M largest by bbox area so small far-away instances are the ones dropped
when a crowd exceeds the budget (rare at M=96 on Cityscapes).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np


class PackedLabels(NamedTuple):
    polys: np.ndarray     # [B, M, V, 2] float32
    n_verts: np.ndarray   # [B, M] int32
    cls_ids: np.ndarray   # [B, M] int32


def pack_polygon(poly: np.ndarray, max_verts: int) -> Tuple[np.ndarray, int]:
    """Pad/decimate one [n,2] polygon to [max_verts,2] with replication."""
    poly = np.asarray(poly, dtype=np.float32).reshape(-1, 2)
    n = poly.shape[0]
    if n == 0:
        return np.zeros((max_verts, 2), np.float32), 0
    if n > max_verts:
        idx = np.unique(np.linspace(0, n - 1, max_verts).round().astype(np.int64))
        poly = poly[idx]
        n = poly.shape[0]
    out = np.concatenate([poly, np.repeat(poly[-1:], max_verts - n, axis=0)], axis=0)
    return out, n


def pack_label(cls_ids: Sequence[int], polygons: Sequence[np.ndarray],
               max_instances: int, max_verts: int):
    """Pack one image's ragged label. Polygons are int (row, col) arrays
    (post-CoordinateReverser convention, ref utils/tranform.py:92-96)."""
    m = len(cls_ids)
    if m > max_instances:
        # keep the largest instances by bbox area
        areas = []
        for p in polygons:
            p = np.asarray(p)
            if p.size == 0:
                areas.append(0.0)
            else:
                ext = p.max(0) - p.min(0)
                areas.append(float(ext[0]) * float(ext[1]))
        order = np.argsort(-np.asarray(areas), kind="stable")[:max_instances]
        order = np.sort(order)
        cls_ids = [cls_ids[i] for i in order]
        polygons = [polygons[i] for i in order]
        m = max_instances

    polys = np.zeros((max_instances, max_verts, 2), np.float32)
    n_verts = np.zeros((max_instances,), np.int32)
    out_cls = -np.ones((max_instances,), np.int32)
    for i in range(m):
        p, n = pack_polygon(np.asarray(polygons[i], np.float32), max_verts)
        if n == 0:
            continue
        polys[i], n_verts[i] = p, n
        out_cls[i] = int(cls_ids[i])
    return polys, n_verts, out_cls


def pack_batch(labels, max_instances: int, max_verts: int) -> PackedLabels:
    """labels: list of (cls_ids, polygons) per image."""
    ps, ns, cs = [], [], []
    for cls_ids, polygons in labels:
        p, n, c = pack_label(cls_ids, polygons, max_instances, max_verts)
        ps.append(p)
        ns.append(n)
        cs.append(c)
    return PackedLabels(np.stack(ps), np.stack(ns), np.stack(cs))
