"""The benchmark's inputs, made from the seed.

``bench_train_batch`` is frozen from the port's ``training/synthetic.py``
(the batch of the JAX package's train bench): seeded uint8 frames, then per
image ``n_real`` octagons, the other instance slots padding (class -1,
replicated vertices). ``frames`` makes serving frames on the device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def frames(n: int, h: int, w: int, seed: int, device: torch.device) -> np.ndarray:
    """``n`` distinct uint8 frames [n, h, w, 3] drawn on ``device`` from a
    generator seeded with ``seed``, in host memory, one at a time."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = np.empty((n, h, w, 3), np.uint8)
    for i in range(n):
        out[i] = torch.randint(0, 256, (h, w, 3), generator=gen, device=device,
                               dtype=torch.uint8).cpu().numpy()
    return out


def bench_train_batch(b: int, m: int, h: int, w: int, seed: int, n_real: int
                      ) -> Tuple[np.ndarray, Tuple[np.ndarray, ...]]:
    """(frames uint8 [b, h, w, 3], (polys f32 [b, m, 8, 2], n_verts, cls_ids)):
    per image ``n_real`` octagons centred at least 80 rows and 120 columns
    from the borders (a quarter of the side on frames under 320x480)."""
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
    return frames, (polys, n_verts, cls_ids)
