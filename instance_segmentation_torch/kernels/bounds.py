"""The card's peak rates and the least time of each of the port's kernels.

A kernel's least time on a card is the larger of the bytes it must move
(each input read once, each output written once) over the card's memory
rate and the operations it must do on these inputs over the card's rate for
their type. Each function below counts a kernel's bytes and operations from
the arguments its wrapper takes, counting what these inputs need where the
work depends on the data. The roofline tool (``tools/roofline.py``) reads
its bounds from here; ``tests/test_torch_roofline.py`` holds them.

The peaks are NVIDIA's datasheet figures for one ``NVIDIA H100 80GB HBM3``
(H100 SXM5, 700 W): 3.35 TB/s of HBM3; dense 989 TFLOP/s in bf16 and fp16
and 494.7 in TF32 on the tensor cores, 1,979 TOP/s in int8; 67 TFLOP/s in
float32 without them. Another card raises, unless its peaks are given.
"""

from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Optional, Tuple

import torch

from instance_segmentation_torch.kernels import ae_terms
from instance_segmentation_torch.kernels.affinity import contained_plain


class Peaks(NamedTuple):
    """A card's memory rate (bytes/s) and operation rates (ops/s) by dtype."""
    card: str
    bytes_per_s: float
    ops_per_s: Mapping[str, float]


H100_SXM = Peaks("NVIDIA H100 80GB HBM3", 3.35e12,
                 {"bf16": 989e12, "f16": 989e12, "tf32": 494.7e12, "f32": 67e12,
                  "int8": 1979e12})
CARDS = {H100_SXM.card: H100_SXM}


def peaks_for(card: str, gbps: Optional[float] = None,
              tflops: Optional[float] = None) -> Peaks:
    """The peaks of ``card`` (``torch.cuda.get_device_name``). A card not in
    ``CARDS`` raises unless ``gbps`` and ``tflops`` are given; then every
    dtype's rate is ``tflops`` (a rate no dtype exceeds keeps each bound a
    least time)."""
    if gbps is not None or tflops is not None:
        if gbps is None or tflops is None:
            raise ValueError("give both the memory rate (GB/s) and the peak TFLOP/s")
        return Peaks(card, gbps * 1e9, dict.fromkeys(H100_SXM.ops_per_s, tflops * 1e12))
    if card not in CARDS:
        raise ValueError(f"no peak rates known for {card!r} (known: {sorted(CARDS)}); give "
                         f"--peak-gbps and --peak-tflops")
    return CARDS[card]


def least_ms(n_bytes: float, n_ops: float, dtype: str = "f32",
             peaks: Peaks = H100_SXM) -> Tuple[float, str]:
    """(least time in ms, "bytes" or "operations"): the bytes over the
    memory rate against the operations over the rate of ``dtype``."""
    t_bytes = n_bytes / (peaks.bytes_per_s / 1e3)
    t_ops = n_ops / (peaks.ops_per_s[dtype] / 1e3)
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def bound(n_bytes: float, n_ops: float) -> Tuple[float, str]:
    """``least_ms`` of float32 operations on the H100: the bound of each of
    the port's kernels, whose work is float32 or integer."""
    return least_ms(n_bytes, n_ops)


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


def nms_keep(sup, valid) -> Work:
    """The NMS kernel reads the strict upper triangle of the suppression
    matrix (K(K-1)/2 B) and the validity (K B) and writes the keep mask (K B)
    per image; its work is bit logic, no float32 operations."""
    b, k = valid.shape
    return Work(b * (k * (k - 1) // 2 + 2 * k), 0)


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


def bn_act(x, scale, shift=None, act: str = "none") -> Work:
    """The BN kernel reads x once and writes y once (the element size each),
    and reads the scale and shift tables; per element a multiply, an add
    with a shift, and SiLU's 4 (negate, exp, add, divide) or ReLU's 1."""
    n, size = x.numel(), x.element_size()
    tables = sum(t.numel() * t.element_size() for t in (scale, shift) if t is not None)
    ops = 1 + (shift is not None) + {"none": 0, "silu": 4, "relu": 1}[act]
    return Work(2 * n * size + tables, ops * n)


# each wrapper's work, by the name its launch count has
WORK = {"affinity_assign": affinity_assign, "rasterize_cnt_r2": rasterize_cnt_r2,
        "rasterize_nmap": rasterize_nmap, "ae_terms_fwd": ae_terms_fwd,
        "ae_terms_bwd": ae_terms_bwd, "minr2_from_cnt": minr2_from_cnt, "nms_keep": nms_keep,
        "bn_act": bn_act}
# each device kernel of the port (the ``*_kernel`` in its name) -> its wrapper
DEVICE_KERNELS: Dict[str, str] = {
    "affinity_kernel": "affinity_assign", "cnt_r2_kernel": "rasterize_cnt_r2",
    "nmap_bin_kernel": "rasterize_nmap", "nmap_band_kernel": "rasterize_nmap",
    "ae_fwd_kernel": "ae_terms_fwd", "ae_sum_kernel": "ae_terms_fwd",
    "ae_bwd_kernel": "ae_terms_bwd", "minr2_kernel": "minr2_from_cnt", "nms_kernel": "nms_keep",
    "bn_act_kernel": "bn_act"}
# the TPU kernel each wrapper replaces, K1-K6 (NMS and BN replace none)
TAGS = {"affinity_assign": "K1", "rasterize_cnt_r2": "K2", "ae_terms_fwd": "K3",
        "ae_terms_bwd": "K4", "rasterize_nmap": "K5", "minr2_from_cnt": "K6",
        "nms_keep": "NMS", "bn_act": "BN"}
