"""Synthetic training batches: seeded uint8 frames, then per image a few
octagons, the other instance slots padding (class -1, replicated vertices).
``bench_train_batch`` is the batch of the JAX package's ``bench.py``
(``_measure_train``), ``fullres_batch`` that of its
``tools/fullres_demo.py``, ``small_train_batch`` that of the data-parallel
equivalence check (``tools/multichip.py --check``)."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def bench_train_batch(b: int, m: int, h: int, w: int, seed: int = 0,
                      edge_cases: bool = False, n_real: int = 16
                      ) -> Tuple[np.ndarray, Tuple[np.ndarray, ...]]:
    """(frames uint8 [b, h, w, 3], (polys f32 [b, m, 8, 2], n_verts, cls_ids)):
    per image ``n_real`` octagons centred at least 80 rows and 120 columns
    from the borders (a quarter of the side on frames under 320x480). With
    ``edge_cases`` instance 16 of image 0 is a rectangle reaching 500 px
    past the left border and the last image has no labels."""
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 255, (b, h, w, 3), dtype=np.uint8)
    polys = np.zeros((b, m, 8, 2), np.float32)
    n_verts = np.zeros((b, m), np.int32)
    cls_ids = np.full((b, m), -1, np.int32)
    ang = np.linspace(0, 2 * np.pi, 9)[:-1]
    my, mx = min(80, h // 4), min(120, w // 4)
    for i in range(b):
        for j in range(n_real):
            cy, cx = rng.uniform(my, h - my), rng.uniform(mx, w - mx)
            rh, rw = rng.uniform(20, 70), rng.uniform(30, 100)
            polys[i, j] = np.stack([cy + rh * np.sin(ang), cx + rw * np.cos(ang)], -1)
            n_verts[i, j] = 8
            cls_ids[i, j] = rng.integers(0, 8)
        polys[i, n_real:] = polys[i, 0, 0]
    if edge_cases:
        polys[0, 16] = [[200, 60], [260, 60], [260, -500], [200, -500]] * 2
        n_verts[0, 16], cls_ids[0, 16] = 4, 2
        polys[-1], n_verts[-1], cls_ids[-1] = polys[-1, 0, 0], 0, -1
    return frames, (polys, n_verts, cls_ids)


def fullres_batch(b: int, m: int, h: int, w: int, n_real: int = 16, seed: int = 0
                  ) -> Tuple[np.ndarray, Tuple[np.ndarray, ...]]:
    """(frames uint8 [b, h, w, 3], (polys f32 [b, m, 8, 2], n_verts, cls_ids)):
    per image ``n_real`` octagons centred in (160, h - 160) x (240, w - 240)
    with radii 40-140 rows and 60-200 columns, drawn in the reference demo's
    order from one generator."""
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 255, (b, h, w, 3), dtype=np.uint8)
    polys = np.zeros((b, m, 8, 2), np.float32)
    n_verts = np.zeros((b, m), np.int32)
    cls_ids = np.full((b, m), -1, np.int32)
    ang = np.linspace(0, 2 * np.pi, 9)[:-1]
    for i in range(b):
        for j in range(n_real):
            cy, cx = rng.uniform(160, h - 160), rng.uniform(240, w - 240)
            rh, rw = rng.uniform(40, 140), rng.uniform(60, 200)
            polys[i, j] = np.stack([cy + rh * np.sin(ang), cx + rw * np.cos(ang)], -1)
            n_verts[i, j] = 8
            cls_ids[i, j] = rng.integers(0, 8)
        polys[i, n_real:] = polys[i, 0, 0]
    return frames, (polys, n_verts, cls_ids)


def small_train_batch(b: int, m: int, h: int, w: int, n_real: int = 5, seed: int = 0
                      ) -> Tuple[np.ndarray, Tuple[np.ndarray, ...]]:
    """(frames uint8 [b, h, w, 3], (polys f32 [b, m, 8, 2], n_verts, cls_ids))
    for small frames (128x512): per image ``n_real`` octagons centred in
    (25, h - 25) x (60, w - 60) with radii 8-22 rows and 15-45 columns."""
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)
    polys = np.zeros((b, m, 8, 2), np.float32)
    n_verts = np.zeros((b, m), np.int32)
    cls_ids = np.full((b, m), -1, np.int32)
    ang = np.linspace(0, 2 * np.pi, 9)[:-1]
    for i in range(b):
        for j in range(n_real):
            cy, cx = rng.uniform(25, h - 25), rng.uniform(60, w - 60)
            rh, rw = rng.uniform(8, 22), rng.uniform(15, 45)
            polys[i, j] = np.stack([cy + rh * np.sin(ang), cx + rw * np.cos(ang)], -1)
            n_verts[i, j] = 8
            cls_ids[i, j] = rng.integers(0, 8)
        polys[i, n_real:] = polys[i, 0, 0]
    return frames, (polys, n_verts, cls_ids)
