"""The H100's peak rates and the least time of each of the port's kernels.

A kernel's least time is the larger of the bytes it must move (each input
read once, each output written once) over the card's memory rate and the
operations it must do on these inputs over its float32 rate. Each function
below counts a kernel's bytes and operations from the arguments its wrapper
takes, counting what these inputs need where the work depends on the data.

The peaks are NVIDIA's datasheet figures for one ``NVIDIA H100 80GB HBM3``
(H100 SXM5, 700 W): 3.35 TB/s of HBM3, 67 TFLOP/s in float32 without the
tensor cores, dense 989 TFLOP/s in bf16 on them. The rooflines and ``mfu``
are shares of these peaks on whatever card runs the cell; the result line
names the card.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, Mapping, NamedTuple, Optional, Tuple

import torch

from benchmark.reference import kernels as ae_terms
from benchmark.reference.kernels import contained_plain

BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12


def bound(n_bytes: float, n_ops: float) -> Tuple[float, str]:
    """(least time in ms, "bytes" or "operations") of a kernel whose work is
    float32 or integer, as each of the port's is."""
    t_bytes = n_bytes / (BYTES_PER_S / 1e3)
    t_ops = n_ops / (F32_OPS_PER_S / 1e3)
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


class Work(NamedTuple):
    """A kernel call's bytes to move and operations to do."""
    bytes: int
    ops: int


def affinity_assign(kp_rc, emb, sig, c_emb, boxes, det_valid) -> Work:
    """K1 reads row/col, embedding and sigma (24 B) and writes assign and
    best (8 B) per keypoint, and reads the center table; it needs a
    containment test (4 compares) per (keypoint, valid center) pair, and per
    contained pair 2 sub, 4 mul, 1 add, 1 neg, 1 exp and the max (10)."""
    (b, k), d = kp_rc.shape[:2], boxes.shape[1]
    contained = int(contained_plain(kp_rc, boxes, det_valid).sum())
    valid_pairs = k * int(det_valid.sum())
    return Work(b * k * (24 + 8) + b * d * (8 + 16 + 1), 4 * valid_pairs + 10 * contained)


def rasterize_cnt_r2(points, pt_valid, h: int, w: int) -> Work:
    """K2 reads the point list once and writes cnt (2 B), r2 (1 B) and the
    union; its work is integer counting and min, no float32 operations."""
    b, m, p = pt_valid.shape
    return Work(b * m * p * 9 + b * m * h * w * 3 + b * h * w, 0)


def rasterize_nmap(points, pt_valid, normals, h: int, w: int) -> Work:
    """K5 reads pt_valid once and the point (8 B) and normal (8 B) of each
    valid sample, writes two f32 planes; one add per channel and valid
    sample."""
    b, m, p = pt_valid.shape
    n_samples = int(pt_valid.sum())
    return Work(b * m * p + 16 * n_samples + 2 * b * h * w * 4, 2 * n_samples)


def minr2_from_cnt(cnt, has) -> Work:
    """K6 reads the live slabs' counts (2 B/px) and has, writes r2 for every
    slab (1 B/px); its work is integer min, no float32 operations."""
    b, m, h, w = cnt.shape
    return Work(2 * int(has.sum()) * h * w + b * m * h * w + b * m, 0)


def visited_tiles(tab: torch.Tensor, cntp: torch.Tensor, h: int, w: int) -> Tuple[int, int, int]:
    """(tile-instance pairs K3/K4 visit, tiles holding samples, tiles with at
    least one visited pair): the kernels' skip rule."""
    nh, nw = ae_terms.num_tiles(h, w)
    r0 = (torch.arange(nh, device=tab.device) * ae_terms.TILE_H).view(nh, 1).float()
    c0 = (torch.arange(nw, device=tab.device) * ae_terms.TILE_W).view(1, nw).float()
    t = tab[..., None, None]
    win = ((t[:, :, ae_terms.VALID] > 0) & (t[:, :, ae_terms.LT0] < r0 + ae_terms.TILE_H)
           & (t[:, :, ae_terms.RB0] > r0) & (t[:, :, ae_terms.LT1] < c0 + ae_terms.TILE_W)
           & (t[:, :, ae_terms.RB1] > c0))
    present = ae_terms.presence_dense(cntp, tab.shape[1])
    visited = win.flatten(2) | present
    return (int(visited.sum()), int(present.any(dim=1).sum()),
            int(visited.any(dim=1).sum()))


def _ae_counts(ey, tab, cntp) -> Tuple[int, int, int, int, int]:
    """(visited pairs, sample tiles, visited tiles, valid instances an image,
    bytes of the instance table, the lookup table and the tile presence)."""
    b, h, w = ey.shape
    pairs, any_tiles, tiles = visited_tiles(tab, cntp, h, w)
    n_valid = int((tab[..., ae_terms.VALID] > 0).sum()) // b
    return pairs, any_tiles, tiles, n_valid, tab.numel() * 4 + 256 * 4 + cntp.numel() * 4


def ae_terms_fwd(ey, ex, sy, sx, r2, cnt, tab, lut, cntp) -> Work:
    """K3 reads the 4 fields in the tiles with a visited pair (the others
    are skipped whole) and 3 B per pixel of each visited (tile, instance)
    slab; per visited pixel ~21 operations (affinity 9, clip 2, neg term 6,
    pull 4), per pixel of a sample tile and valid center 10 (dmax)."""
    pairs, any_tiles, tiles, n_valid, table_bytes = _ae_counts(ey, tab, cntp)
    px = ae_terms.TILE_H * ae_terms.TILE_W
    return Work(4 * tiles * px * 4 + pairs * px * 3 + table_bytes,
                pairs * px * 21 + any_tiles * px * n_valid * 10)


def ae_terms_bwd(ey, ex, sy, sx, r2, cnt, tab, lut, cntp, g_pos=None, g_neg=None,
                 g_pull=None) -> Work:
    """K4 reads the 4 fields, writes 4 gradient planes, 3 B per visited slab
    pixel; per visited pixel ~51 operations, per sample-tile pixel 10 per
    valid center (argmax) and 21 for the argmax center's term."""
    pairs, any_tiles, _, n_valid, table_bytes = _ae_counts(ey, tab, cntp)
    px = ae_terms.TILE_H * ae_terms.TILE_W
    return Work(8 * ey.numel() * 4 + pairs * px * 3 + table_bytes,
                pairs * px * 51 + any_tiles * px * (n_valid * 10 + 21))


# each wrapper's work, by the name its launch count has
WORK = {"affinity_assign": affinity_assign, "rasterize_cnt_r2": rasterize_cnt_r2,
        "rasterize_nmap": rasterize_nmap, "ae_terms_fwd": ae_terms_fwd,
        "ae_terms_bwd": ae_terms_bwd, "minr2_from_cnt": minr2_from_cnt}
# each device kernel of the port (the ``*_kernel`` in its name) -> its wrapper
DEVICE_KERNELS: Dict[str, str] = {
    "affinity_kernel": "affinity_assign", "cnt_r2_kernel": "rasterize_cnt_r2",
    "nmap_bin_kernel": "rasterize_nmap", "nmap_band_kernel": "rasterize_nmap",
    "ae_fwd_kernel": "ae_terms_fwd", "ae_sum_kernel": "ae_terms_fwd",
    "ae_bwd_kernel": "ae_terms_bwd", "minr2_kernel": "minr2_from_cnt"}
def wrapper_of(kernel: str) -> Optional[str]:
    """The wrapper (a ``WORK`` name) of a port's device kernel, by the
    ``*_kernel`` in its name."""
    found = re.search(r"(\w+_kernel)\b", kernel)
    return DEVICE_KERNELS.get(found.group(1)) if found else None


def roofline_share(summary: Mapping, wrappers: Iterable[str]) -> Optional[float]:
    """The least time of every call of ``wrappers`` in a traced segment
    (``summary["bound_s"]``) over their kernels' device time, in %; None
    where none of their kernels ran."""
    wrappers = tuple(wrappers)
    device_s = sum(s for name, s in summary["kernel_s"].items() if wrapper_of(name) in wrappers)
    if not device_s:
        return None
    return 100.0 * sum(summary["bound_s"].get(w, 0.0) for w in wrappers) / device_s


def mfu(summary: Mapping) -> Optional[float]:
    """FLOPs of one request or step over its untraced time, in % of the
    H100's dense bf16 peak."""
    if not summary.get("flops_per_unit") or not summary.get("unit_s"):
        return None
    return 100.0 * summary["flops_per_unit"] / summary["unit_s"] / BF16_FLOPS_PER_S

