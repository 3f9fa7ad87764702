"""Decode on the device: boxes -> NMS -> boundary peaks -> affinity grouping
-> polygon assembly, batched, with fixed output shapes.

Counterpart of the standard path of ``instance_segmentation_tpu/ops/decode.py``
(``decode_output``). Every stage reproduces the reference's tie rules and
roundings, so integer and boolean outputs agree with it on the same inputs
(up to the last bit of ``exp``/``tanh``/``atan2``, which the two libraries
compute differently):

  * box top-k is a stable descending sort (the reference's TopK puts the
    lower index first on ties, and invalid slots gather ``b_k[0]``);
  * the keypoint top-k (``exact_topk=True``) is the reference's 18-step
    bisection in monotonic-u32 space plus its band rule (everything above
    ``hi``, the rest of k from the band ``(lo, hi]`` in index order), not
    ``torch.topk``; ``exact_topk=False`` is the value-ordered top-k that the
    reference's ``approx_max_k`` computes off the TPU (XLA's TopK: values
    descending, ties to the lower index), ``value_topk_indices``;
  * the 3x3 peak test zero-fills outside the map;
  * grouping (kernel K1) gives keypoints in no box slot 0 and lets the first
    maximum win; ``group_mode="kmeans"`` refines K1's assignment with
    ``kmeans_iters`` Lloyd steps in embedding space seeded at the centre
    embeddings (``ops/kmeans.py``), keeping a refined label only where the
    keypoint lies in that label's box (JAX ``_decode_core``);
  * the polar sort is stable over ``inf``-padded angles;
  * where the reference's compiler fuses ``a * b + c`` into one rounding
    (box centres, polygon edge crossings) the port does too (``fma``).

Coordinates follow the reference: boxes (x1, y1, x2, y2) at input
resolution; polygons and centers (x, y) at original resolution. The
embedding frame is the reference's fixed 1024x2048 grid (i / 1023,
2 j / 2047), computed at the keypoints and box centres rather than sliced
from the grid, so the decode also takes frames larger than the grid (the
JAX decode raises there; ROADMAP Queue 3).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from torch._higher_order_ops.while_loop import while_loop_op

from instance_segmentation_torch.kernels.affinity import affinity_assign
from instance_segmentation_torch.kernels.nms import nms_keep
from instance_segmentation_torch.ops.kmeans import kmeans
from instance_segmentation_torch.ops.geometry import fma, point_in_polygon, rasterize_polygon
from instance_segmentation_torch.utils.profiling import span


@dataclass(frozen=True)
class DecodeConfig:
    """Static decode parameters (reference configs/decode_cfg.yaml)."""

    cls_th: float = 0.3
    iou_th: float = 0.2
    kp_th: int = 20000            # boundary peak budget (top-K)
    obj_pixel_th: int = 2
    wh_delta: float = 0.1
    pre_nms: int = 512            # boxes entering NMS
    max_dets: int = 96            # detections kept
    max_poly: int = 1024          # polygon vertex budget per object
    pair_candidates: int = 12     # points tried for the internal-point fallback
    exact_topk: bool = True       # False: the value-ordered top-k (approx_max_k off the TPU)
    group_mode: str = "affinity"  # "affinity" (K1) or "kmeans" (K1, then Lloyd steps)
    kmeans_iters: int = 5


class Detections(NamedTuple):
    boxes: torch.Tensor       # [B, D, 4] float32 (x1, y1, x2, y2) input-res
    scores: torch.Tensor      # [B, D] float32
    classes: torch.Tensor     # [B, D] int32
    det_valid: torch.Tensor   # [B, D] bool: survived score threshold + NMS
    polygons: torch.Tensor    # [B, D, Q, 2] float32 (x, y) original-res
    poly_len: torch.Tensor    # [B, D] int32
    centers: torch.Tensor     # [B, D, 2] float32 (x, y) original-res
    obj_valid: torch.Tensor   # [B, D] bool: has a valid polygon


def coordinate_grid(h: int, w: int, device: torch.device | str = "cpu") -> torch.Tensor:
    """The fixed embedding frame of a 1024x2048 grid sliced to (h, w):
    [h, w, 2] with channels (i / 1023, 2 j / 2047)."""
    if h > 1024 or w > 2048:
        raise ValueError(f"coordinate grid is fixed at 1024x2048 (got {h}x{w})")
    ys = torch.arange(h, dtype=torch.float32, device=device) / 1023.0
    xs = torch.arange(w, dtype=torch.float32, device=device) * (2.0 / 2047.0)
    return torch.stack([ys[:, None].expand(h, w), xs[None, :].expand(h, w)], dim=-1)


# ---------------------------------------------------------------------------
# Box decode + class-aware NMS
# ---------------------------------------------------------------------------

def bbox_transform(anchors: torch.Tensor, regression: torch.Tensor,
                   h: int, w: int) -> torch.Tensor:
    """anchors [A,4] (y1,x1,y2,x2) + deltas [...,A,4] (dy,dx,dh,dw)
    -> clipped boxes [...,A,4] (x1,y1,x2,y2)."""
    yca = (anchors[:, 0] + anchors[:, 2]) / 2
    xca = (anchors[:, 1] + anchors[:, 3]) / 2
    ha = anchors[:, 2] - anchors[:, 0]
    wa = anchors[:, 3] - anchors[:, 1]
    wb = torch.exp(regression[..., 3]) * wa
    hb = torch.exp(regression[..., 2]) * ha
    yc = fma(regression[..., 0], ha, yca)
    xc = fma(regression[..., 1], wa, xca)
    x1 = torch.clamp(xc - wb / 2, min=0)
    y1 = torch.clamp(yc - hb / 2, min=0)
    x2 = torch.clamp(xc + wb / 2, max=w - 1)
    y2 = torch.clamp(yc + hb / 2, max=h - 1)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def _iou_xyxy(b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of [..., K, 4] xyxy boxes -> [..., K, K]."""
    bi, bj = b[..., :, None, :], b[..., None, :, :]
    x1 = torch.maximum(bi[..., 0], bj[..., 0])
    y1 = torch.maximum(bi[..., 1], bj[..., 1])
    x2 = torch.minimum(bi[..., 2], bj[..., 2])
    y2 = torch.minimum(bi[..., 3], bj[..., 3])
    inter = torch.clamp(x2 - x1, min=0) * torch.clamp(y2 - y1, min=0)
    area = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    union = area[..., :, None] + area[..., None, :] - inter
    return inter / torch.clamp(union, min=1e-8)


def _nms_unsettled(keep, prev, sweeps, valid, sup):
    """``leader_nms``'s loop condition: the last sweep changed ``keep`` and
    fewer than K sweeps ran."""
    return (sweeps < sup.shape[-1]) & (keep != prev).any()


def _nms_sweep(keep, prev, sweeps, valid, sup):
    """One sweep of ``leader_nms``'s fixpoint."""
    return valid & ~(keep[..., :, None] & sup).any(dim=-2), keep.clone(), sweeps + 1


def _nms_read(cond: torch.Tensor) -> bool:
    """A host read of ``leader_nms``'s loop condition, in a span "sync:nms"."""
    with span("sync:nms"):
        return bool(cond)


def _nms_eager(carried, extra) -> torch.Tensor:
    """``leader_nms``'s sweeps run eagerly, with the kernels and host reads
    of ``while_loop_op``'s eager path (``while_loop_dense``): as there, the
    first condition is read twice (its ``if`` and its ``while``), and the
    final ``keep`` is returned. The loop does not run only where K is 0 (the
    first sweep's ``keep != prev`` holds everywhere), whose clones there
    launch nothing."""
    cond = _nms_unsettled(*carried, *extra)
    go = _nms_read(cond) and _nms_read(cond)
    while go:
        carried = _nms_sweep(*carried, *extra)
        go = _nms_read(_nms_unsettled(*carried, *extra))
    return carried[0]


def leader_nms(boxes: torch.Tensor, valid: torch.Tensor, iou_th: float,
               max_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS over rank-sorted boxes [..., K, 4], as the fixpoint of
        keep_i <- valid_i & not exists j < i: keep_j & iou_ij > th
    (unique, reached within K sweeps; in practice 2-6). Under ``torch.export``
    or ``torch.compile`` the sweeps run in ``torch.while_loop``'s operator,
    as the JAX decode's ``lax.while_loop``, so that the program captures the
    loop. Eagerly, CUDA tensors compute the fixpoint in one kernel
    (``kernels/nms.py``, the sequential greedy walk, with no host read), and
    CPU tensors run the sweeps as that operator runs them (``_nms_eager``),
    reading the condition on the host once a sweep. Either way the IoUs and
    the threshold are PyTorch's. Returns the first ``max_out`` kept indices
    (-1 where fewer were kept) and their validity."""
    K = boxes.shape[-2]
    rank = torch.arange(K, device=boxes.device)
    # sup[..., j, i]: keeping j suppresses i (strictly lower rank suppresses)
    sup = (_iou_xyxy(boxes) > iou_th) & (rank[:, None] < rank[None, :])
    if boxes.is_cuda and not torch.compiler.is_compiling():
        keep = nms_keep(sup.reshape(-1, K, K).contiguous(),
                        valid.reshape(-1, K).contiguous()).view(valid.shape)
    else:
        sweeps = torch.zeros((), dtype=torch.int64, device=boxes.device)
        carried = (valid.clone(), ~valid, sweeps)
        if torch.compiler.is_compiling():
            keep, _, _ = while_loop_op(_nms_unsettled, _nms_sweep, carried, (valid, sup))
        else:
            keep = _nms_eager(carried, (valid, sup))
    order = torch.argsort(torch.where(keep, rank, K + rank), dim=-1)
    idx = order[..., :max_out]
    ok = keep.gather(-1, idx)
    return torch.where(ok, idx, torch.full_like(idx, -1)), ok


def greedy_nms(boxes: torch.Tensor, valid: torch.Tensor, iou_th: float) -> torch.Tensor:
    """Greedy NMS over score-sorted [K, 4] boxes -> keep mask [K], by K
    sequential steps (strict >): the sequential oracle ``leader_nms`` is
    held to (JAX ``greedy_nms``)."""
    K = boxes.shape[0]
    iou = _iou_xyxy(boxes)
    rank = torch.arange(K, device=boxes.device)
    keep = torch.zeros(K, dtype=torch.bool, device=boxes.device)
    keep[:1] = valid[:1]
    for i in range(1, K):
        keep[i] = valid[i] & ~((iou[i] > iou_th) & keep & (rank < i)).any()
    return keep


def _x_columns(device: torch.device) -> torch.Tensor:
    """[1, 0, 1, 0] float32, the x columns of an xyxy box, filled on
    ``device``: no copy from the host, which a CUDA graph cannot hold and
    which waits for the stream."""
    mask = torch.zeros(4, device=device)
    mask[0::2] = 1.0
    return mask


def decode_boxes(classification: torch.Tensor, regression: torch.Tensor,
                 anchors: torch.Tensor, h: int, w: int, cfg: DecodeConfig):
    """Batched box decode -> (boxes [B,D,4] xyxy, scores, classes int32, valid)."""
    scores, classes = classification.max(dim=-1)                      # [B, A]
    boxes = bbox_transform(anchors, regression, h, w)                  # [B, A, 4]
    masked = torch.where(scores > cfg.cls_th, scores, torch.full_like(scores, -1.0))
    # stable descending sort == the reference TopK's lower-index-first ties
    top_s, top_i = torch.sort(masked, dim=1, descending=True, stable=True)
    top_s, top_i = top_s[:, :cfg.pre_nms], top_i[:, :cfg.pre_nms]
    b_k = boxes.gather(1, top_i[..., None].expand(-1, -1, 4))
    c_k = classes.gather(1, top_i)
    valid_k = top_s > cfg.cls_th
    # class-aware NMS via coordinate offsetting (one NMS for all classes)
    off = (c_k.float() * (w + h) * 2.0)[..., None]
    shifted = b_k + off * _x_columns(off.device)
    order, keep = leader_nms(shifted, valid_k, cfg.iou_th, cfg.max_dets)
    order = order.clamp(0, cfg.pre_nms - 1)
    return (b_k.gather(1, order[..., None].expand(-1, -1, 4)),
            top_s.gather(1, order),
            c_k.gather(1, order).int(),
            keep)


# ---------------------------------------------------------------------------
# Boundary-peak selection
# ---------------------------------------------------------------------------

def _monotonic_u32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> its order-preserving u32 key, held in int64."""
    u = x.contiguous().view(torch.int32).long() & 0xFFFFFFFF
    return torch.where(u >> 31 == 1, u ^ 0xFFFFFFFF, u | 0x80000000)


def _bisect_band(u: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """18 bisection steps on [B, N] monotonic keys -> per-row (lo, hi) with
    count(>lo) > k >= count(>hi)."""
    B = u.shape[0]
    lo = torch.zeros(B, dtype=torch.int64, device=u.device)
    hi = torch.full((B,), 0xFFFFFFFF, dtype=torch.int64, device=u.device)
    for _ in range(18):
        mid = lo + (hi - lo) // 2
        more = (u > mid[:, None]).sum(dim=1) > k
        lo = torch.where(more, mid, lo)
        hi = torch.where(more, hi, mid)
    return lo, hi


def _exact_k_mask(u: torch.Tensor, k: int) -> torch.Tensor:
    """[B, N] monotonic keys -> mask of exactly k per row: all keys above
    ``hi``, then the band ``(lo, hi]`` in index order."""
    lo, hi = _bisect_band(u, k)
    gt = u > hi[:, None]
    band = (u > lo[:, None]) & ~gt
    n_gt = gt.sum(dim=1, keepdim=True)
    tie_rank = torch.cumsum(band, dim=1)
    return gt | (band & (tie_rank <= k - n_gt))


def exact_topk_indices(flat: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k of [B, N] float32 with the reference's tie rule ->
    (values [B, k], indices [B, k] ascending). The mask is compacted by its
    running count, at fixed shapes; a device-side assert checks that it
    selected k in every row (no host sync)."""
    B, N = flat.shape
    k = min(k, N)
    mask = _exact_k_mask(_monotonic_u32(flat), k)
    slot = torch.cumsum(mask, dim=1) - 1                               # [B, N]
    torch._assert_async((slot[:, -1] == k - 1).all(), "exact-k mask did not select k")
    slot = torch.where(mask, slot, torch.full_like(slot, k))           # k: a dropped slot
    cols = torch.arange(N, device=flat.device).expand(B, N)
    idx = torch.zeros((B, k + 1), dtype=torch.int64, device=flat.device)
    idx = idx.scatter(1, slot, cols)[:, :k]
    return flat.gather(1, idx), idx


def value_topk_indices(flat: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of [B, N] float32 in value order -> (values [B, k], indices
    [B, k]): values descending in float32's total order (-0 below +0, NaN
    above inf), and where values tie the lower index first, both in which of
    the tied values at the k-th place are kept and in their order. That is
    XLA's TopK, which the reference's ``approx_max_k`` lowers to off the TPU.
    One ``torch.topk`` over unique int64 keys (the monotonic key above the
    index's complement), so no tie is left to ``torch.topk``'s order."""
    B, N = flat.shape
    k = min(k, N)
    bits = max(1, (N - 1).bit_length())
    if bits > 31:
        raise ValueError(f"value_topk_indices takes rows of at most 2**31 values (got {N})")
    low = (1 << bits) - 1
    cols = torch.arange(N, device=flat.device)
    key = (_monotonic_u32(flat) << bits) | (low - cols)
    idx = low - (torch.topk(key, k, dim=1).values & low)
    return flat.gather(1, idx), idx


def select_peaks_batch(hm: torch.Tensor, k: int,
                       exact: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k + 3x3 peak test on [B, H, W] maps -> (flat indices [B, k], peak
    [B, k] bool). ``exact``: the bisection top-k, indices ascending
    (``exact_topk_indices``); else the value-ordered top-k
    (``value_topk_indices``). The peak test runs on the top-k-masked map
    (every pixel at or above the k-th value), with masked-out pixels and the
    outside of the map counting as 0."""
    B, H, W = hm.shape
    topk = exact_topk_indices if exact else value_topk_indices
    top_v, top_i = topk(hm.reshape(B, -1), k)
    thresh = top_v.min(dim=1).values
    masked = torch.where(hm >= thresh[:, None, None], hm, torch.zeros_like(hm))
    hmax = F.max_pool2d(F.pad(masked[:, None], (1, 1, 1, 1)), 3, stride=1)[:, 0]
    peak = hmax.reshape(B, -1).gather(1, top_i) == top_v
    return top_i, peak


def select_peaks(hm: torch.Tensor, k: int, exact: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-image ``select_peaks_batch``: [H, W] -> ([k], [k])."""
    idx, ok = select_peaks_batch(hm[None], k, exact=exact)
    return idx[0], ok[0]


# ---------------------------------------------------------------------------
# Polygon assembly
# ---------------------------------------------------------------------------

def _find_internal_point(pts: torch.Tensor, n: torch.Tensor, default: torch.Tensor,
                         n_pairs: int) -> torch.Tensor:
    """Point for the polar sort: the default (box center) if inside, else the
    member mean if inside, else the first inside midpoint of ``n_pairs``
    members spread over the member list, else the default.
    pts [..., Q, 2] replication-padded past n [...]; default [..., 2]."""
    Q = pts.shape[-2]
    q = torch.arange(Q, device=pts.device)
    members = (q < n[..., None])[..., None]
    # the member sum is exact in float64, so the mean does not depend on the
    # summation order (which differs between devices): it matters where the
    # mean sits exactly on an edge of the member polygon
    total = torch.where(members, pts, torch.zeros_like(pts)).double().sum(dim=-2)
    mean = (total / n.double().clamp(min=1.0)[..., None]).float()

    span = (n.float() - 1.0).clamp(min=0.0)
    lin = torch.linspace(0.0, 1.0, n_pairs, device=pts.device)
    cand_idx = torch.round(lin * span[..., None]).long()            # [..., P]
    cand = pts.gather(-2, cand_idx[..., None].expand(*cand_idx.shape, 2))
    mids = (cand[..., :, None, :] + cand[..., None, :, :]) / 2.0
    mids = mids.reshape(*mids.shape[:-3], n_pairs * n_pairs, 2)
    ok = point_in_polygon(mids, pts)
    first = ok.to(torch.uint8).argmax(dim=-1)
    pair_pt = mids.gather(-2, first[..., None, None].expand(*first.shape, 1, 2))[..., 0, :]
    pair_pt = torch.where(ok.any(dim=-1)[..., None], pair_pt, default)

    def inside(p):
        return point_in_polygon(p[..., None, :], pts)[..., 0, None]
    return torch.where(inside(default), default,
                       torch.where(inside(mean), mean, pair_pt))


def _replicate_last(pts: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """[B, D, Q, 2]: slots at or past n repeat slot n-1 (slot 0 when n=0)."""
    Q = pts.shape[2]
    last_idx = (n - 1).clamp(0, Q - 1)[..., None, None].expand(*n.shape, 1, 2)
    last = pts.gather(2, last_idx)
    members = torch.arange(Q, device=pts.device) < n[..., None]
    return torch.where(members[..., None], pts, last)


def assemble_objects(kp_rc: torch.Tensor, kp_valid: torch.Tensor,
                     assign: torch.Tensor, boxes: torch.Tensor,
                     det_valid: torch.Tensor, in_h: int, in_w: int,
                     orig_h: int, orig_w: int, scale_int: float,
                     cfg: DecodeConfig):
    """kp_rc [B,K,2] (row, col) input-res; assign [B,K] -> detection index;
    boxes [B,D,4] xyxy input-res. Returns (polygons [B,D,Q,2] (x, y)
    original-res, poly_len [B,D] int32, centers [B,D,2], obj_valid [B,D])."""
    B, K, _ = kp_rc.shape
    D = boxes.shape[1]
    Q = cfg.max_poly
    dev = kp_rc.device

    # detransform to original resolution (corner-to-corner affine)
    tw = int(round(orig_w / scale_int))
    th = int(round(orig_h / scale_int))
    sx = (orig_w - 1) / (tw - 1)
    sy = (orig_h - 1) / (th - 1)
    kp_x = torch.clamp(kp_rc[..., 1] * sx, 0, orig_w - 1)
    kp_y = torch.clamp(kp_rc[..., 0] * sy, 0, orig_h - 1)
    centers = torch.stack(
        [torch.clamp((boxes[..., 0] + boxes[..., 2]) / 2 * sx, 0, orig_w - 1),
         torch.clamp((boxes[..., 1] + boxes[..., 3]) / 2 * sy, 0, orig_h - 1)], dim=-1)
    half_x = (0.5 + cfg.wh_delta) * ((boxes[..., 2] - boxes[..., 0]) * scale_int)
    half_y = (0.5 + cfg.wh_delta) * ((boxes[..., 3] - boxes[..., 1]) * scale_int)

    # ghost filter: a keypoint stays only inside its own detection's window
    a = assign.long()

    def own(t):
        return t.gather(1, a)
    cx, cy = own(centers[..., 0]), own(centers[..., 1])
    hx, hy = own(half_x), own(half_y)
    sel = (kp_valid & own(det_valid) & (kp_x > cx - hx) & (kp_x < cx + hx)
           & (kp_y > cy - hy) & (kp_y < cy + hy))

    # one sort per image: members of object d form a contiguous run in
    # row-major order (keys are unique)
    rm_key = kp_rc[..., 0].long() * in_w + kp_rc[..., 1].long()
    obj = torch.where(sel, a, torch.full_like(a, D))
    order = torch.argsort(obj * (in_h * in_w) + rm_key, dim=1)
    xs, ys = kp_x.gather(1, order), kp_y.gather(1, order)
    counts = torch.zeros(B, D + 1, dtype=torch.int64, device=dev).scatter_add_(
        1, obj, torch.ones_like(obj))[:, :D]
    starts = counts.cumsum(dim=1) - counts
    n = counts.clamp(max=Q)

    # member windows: pts[b, d, q] = sorted[b, starts[b, d] + q]
    idx = (starts[..., None] + torch.arange(Q, device=dev)).clamp(max=K - 1)
    idx = idx.reshape(B, D * Q)
    pts = torch.stack([xs.gather(1, idx), ys.gather(1, idx)], dim=-1).view(B, D, Q, 2)
    pts = _replicate_last(pts, n)

    ip = _find_internal_point(pts, n, centers, cfg.pair_candidates)   # [B,D,2]
    ang = torch.remainder(torch.atan2(pts[..., 1] - ip[..., 1:2],
                                      pts[..., 0] - ip[..., 0:1]), 2.0 * math.pi)
    members = torch.arange(Q, device=dev) < n[..., None]
    ang = torch.where(members, ang, torch.full_like(ang, math.inf))
    perm = torch.sort(ang, dim=-1, stable=True).indices
    poly = pts.gather(2, perm[..., None].expand(B, D, Q, 2))
    poly = _replicate_last(poly, n)

    # validity: non-degenerate area (shoelace >= 0.5) + center inside; the
    # shoelace sum is taken in float64 so its order hardly matters
    x, y = poly[..., 0].double(), poly[..., 1].double()
    x2, y2 = torch.roll(x, -1, dims=-1), torch.roll(y, -1, dims=-1)
    area = 0.5 * torch.abs(torch.sum(x * y2 - x2 * y, dim=-1))
    inside = point_in_polygon(centers[..., None, :], poly)[..., 0]
    enough = det_valid & (counts >= cfg.obj_pixel_th)
    ok = enough & (area >= 0.5) & inside

    n = torch.where(enough, n, torch.zeros_like(n)).int()
    poly = torch.where(enough[..., None, None], poly, torch.zeros_like(poly))
    return poly, n, centers, ok


def render_masks(dets: Detections, h: int, w: int, max_masks: int | None = None
                 ) -> torch.Tensor:
    """Decoded polygons rasterized to instance masks on the detections'
    device (``geometry.rasterize_polygon``): bool [B, D', h, w], D' =
    ``max_masks`` or D; invalid detections render empty. Counterpart of
    ``render_masks`` in the JAX decode (``ops/decode.py:586-606``)."""
    polys, valid = dets.polygons, dets.obj_valid
    if max_masks is not None:
        polys, valid = polys[:, :max_masks], valid[:, :max_masks]
    masks = rasterize_polygon(polys.flip(-1), h, w)              # (x, y) -> (row, col)
    return masks & valid[..., None, None]


def decode_centers(conf_hm: torch.Tensor, cls_hm: torch.Tensor, wh_map: torch.Tensor,
                   num_centers: int, iou_th: float = 0.5, max_out: int = 96):
    """Centre-heatmap detection decode (JAX ``decode_centers``; the live path
    does not call it): the top ``num_centers`` peaks of ``conf_hm`` with a
    confidence above 0, each with its class and (h, w) size, then
    class-aware NMS on the implied boxes (class offset ``(H + W) * 2``).

    conf_hm [H, W] float32, cls_hm [H, W] int, wh_map [H, W, 2] ((h, w) per
    pixel). Returns (centers_rc [M, 2] int32, classes [M] int32, confs [M],
    whs [M, 2], valid [M]), M = min(num_centers, max_out)."""
    H, W = conf_hm.shape
    flat_idx, ok = select_peaks(conf_hm, num_centers)
    rr = torch.div(flat_idx, W, rounding_mode="floor").float()
    cc = (flat_idx % W).float()
    conf = conf_hm.reshape(-1)[flat_idx]
    ok = ok & (conf > 0)
    cls = cls_hm.reshape(-1)[flat_idx].int()
    wh = wh_map.reshape(-1, 2)[flat_idx]                              # [K, 2] (h, w)

    boxes = torch.stack([cc - wh[:, 1] / 2, rr - wh[:, 0] / 2,
                         cc + wh[:, 1] / 2, rr + wh[:, 0] / 2], dim=-1)
    order = torch.argsort(-torch.where(ok, conf, torch.full_like(conf, -math.inf)),
                          stable=True)
    boxes_s, ok_s = boxes[order], ok[order]
    off = (cls[order].float() * (H + W) * 2.0)[:, None]
    keep_idx, keep_ok = leader_nms(boxes_s + off * _x_columns(off.device), ok_s, iou_th, max_out)
    sel = order[keep_idx.clamp(0, boxes_s.shape[0] - 1)]
    centers = torch.stack([rr[sel], cc[sel]], dim=-1).int()
    return centers, cls[sel], conf[sel], wh[sel], keep_ok


# ---------------------------------------------------------------------------
# Full decode
# ---------------------------------------------------------------------------

def keypoint_embeddings(flat_idx: torch.Tensor, ae: torch.Tensor, boxes: torch.Tensor,
                        H: int, W: int):
    """The grouping's inputs from the peaks' flat indices [B, K] into the
    [B, H, W] map and the AE map [B, H, W, 4]: (kp_rc [B, K, 2] (row, col),
    emb [B, K, 2], sig [B, K, 2], c_emb [B, D, 2] at the box centres)."""
    B = flat_idx.shape[0]
    rr = torch.div(flat_idx, W, rounding_mode="floor").float()
    cc = (flat_idx % W).float()
    kp_rc = torch.stack([rr, cc], dim=-1)                               # [B,K,2]

    ae_flat = ae.reshape(B, -1, 4).gather(1, flat_idx[..., None].expand(-1, -1, 4))
    # the embedding frame is coordinate_grid, computed at the peaks
    xym_flat = torch.stack([rr / 1023.0, cc * (2.0 / 2047.0)], dim=-1)
    emb = torch.tanh(ae_flat[..., 0:2]) + xym_flat
    sig = torch.exp(ae_flat[..., 2:4])

    ci = ((boxes[..., 1] + boxes[..., 3]) / 2).int().clamp(0, H - 1)
    cj = ((boxes[..., 0] + boxes[..., 2]) / 2).int().clamp(0, W - 1)
    # the centres' embeddings: coordinate_grid at (ci, cj), computed there so
    # that frames past 1024x2048 (coef 8's 1536x1536) decode too
    c_emb = torch.stack([ci.float() / 1023.0, cj.float() * (2.0 / 2047.0)], dim=-1)
    return kp_rc, emb, sig, c_emb


def group_keypoints(kp_rc, kp_ok, emb, sig, c_emb, boxes, det_valid,
                    cfg: DecodeConfig) -> torch.Tensor:
    """Each keypoint's detection [B, K]: K1 (``affinity_assign``), refined by
    ``cfg.kmeans_iters`` Lloyd steps where ``group_mode`` is "kmeans"."""
    assign, _best = affinity_assign(kp_rc, emb, sig, c_emb, boxes, det_valid)
    if cfg.group_mode == "kmeans":
        km, _ = kmeans(emb, c_emb, valid=kp_ok, num_iters=cfg.kmeans_iters)
        D = boxes.shape[1]
        slot = km.clamp(max=D - 1).long()
        box = boxes.gather(1, slot[..., None].expand(-1, -1, 4))
        in_box = ((kp_rc[..., 0] >= box[..., 1]) & (kp_rc[..., 0] <= box[..., 3]) &
                  (kp_rc[..., 1] >= box[..., 0]) & (kp_rc[..., 1] <= box[..., 2]) &
                  det_valid.gather(1, slot))
        assign = torch.where((km < D) & in_box, km, assign)
    return assign


class Candidates(NamedTuple):
    """The decode up to the grouping (``decode_candidates``)."""
    boxes: torch.Tensor       # [B, D, 4] float32 (x1, y1, x2, y2) input-res
    scores: torch.Tensor      # [B, D] float32
    classes: torch.Tensor     # [B, D] int32
    det_valid: torch.Tensor   # [B, D] bool
    kp_rc: torch.Tensor       # [B, K, 2] float32 (row, col) of the boundary peaks
    kp_ok: torch.Tensor       # [B, K] bool: a peak
    emb: torch.Tensor         # [B, K, 2] float32
    sig: torch.Tensor         # [B, K, 2] float32
    c_emb: torch.Tensor       # [B, D, 2] float32


def decode_candidates(outputs, anchors: torch.Tensor, cfg: DecodeConfig) -> Candidates:
    """The decode's first part: boxes and NMS ("decode.boxes"), the boundary
    peaks ("decode.peaks") and the grouping's embeddings ("decode.embed"), at
    fixed shapes and with no host wait on the device."""
    kp, ae, _tan, regression, classification = outputs
    H, W = kp.shape[1:3]
    with span("decode.boxes"):
        boxes, scores, classes, det_valid = decode_boxes(
            classification, regression, anchors, H, W, cfg)
    with span("decode.peaks"):
        flat_idx, kp_ok = select_peaks_batch(kp[..., 0], cfg.kp_th, exact=cfg.exact_topk)
    with span("decode.embed"):
        kp_rc, emb, sig, c_emb = keypoint_embeddings(flat_idx, ae, boxes, H, W)
    return Candidates(boxes, scores, classes, det_valid, kp_rc, kp_ok, emb, sig, c_emb)


def group_candidates(cand: Candidates, cfg: DecodeConfig) -> torch.Tensor:
    """The decode's second part ("decode.group"): ``group_keypoints`` on
    ``cand``, each keypoint's detection [B, K]."""
    if cfg.group_mode not in ("affinity", "kmeans"):
        raise ValueError(f"group_mode={cfg.group_mode!r}: 'affinity' or 'kmeans'")
    with span("decode.group"):
        return group_keypoints(cand.kp_rc, cand.kp_ok, cand.emb, cand.sig, cand.c_emb,
                               cand.boxes, cand.det_valid, cfg)


def assemble_candidates(cand: Candidates, assign: torch.Tensor, in_hw: Tuple[int, int],
                        orig_h: int, orig_w: int, scale_int: float,
                        cfg: DecodeConfig) -> Detections:
    """The decode's last part ("decode.assemble"): the polygons of the
    grouped keypoints, with ``cand``'s detections."""
    with span("decode.assemble"):
        polys, lens, centers, obj_ok = assemble_objects(
            cand.kp_rc, cand.kp_ok, assign, cand.boxes, cand.det_valid, *in_hw,
            orig_h, orig_w, scale_int, cfg)
    return Detections(boxes=cand.boxes, scores=cand.scores, classes=cand.classes,
                      det_valid=cand.det_valid, polygons=polys, poly_len=lens,
                      centers=centers, obj_valid=obj_ok)


def decode_output(outputs, anchors: torch.Tensor, orig_h: int, orig_w: int,
                  scale_int: float, cfg: DecodeConfig = DecodeConfig()) -> Detections:
    """Full decode of a model forward pass: ``decode_candidates``, then
    ``group_candidates``, then ``assemble_candidates``.

    outputs = (kp [B,H,W,1], ae [B,H,W,4], tan, regression [B,A,4],
    classification [B,A,C]), float32, on one device; anchors [A, 4] on it.
    Grouping runs kernel K1 on CUDA tensors and its plain version on CPU ones,
    and so does NMS (``kernels/nms.py``). The decode runs in a span "decode",
    each stage in its own inside it ("decode.boxes", NMS included; ".peaks";
    ".embed"; ".group"; ".assemble"). On CPU tensors each host read of NMS's
    loop condition opens a span "sync:nms"; on CUDA tensors the decode holds
    no host wait on the card.
    """
    with span("decode"):
        cand = decode_candidates(outputs, anchors, cfg)
        assign = group_candidates(cand, cfg)
        return assemble_candidates(cand, assign, tuple(outputs[0].shape[1:3]),
                                   orig_h, orig_w, scale_int, cfg)


def forward_and_decode(model, images: torch.Tensor, anchors: torch.Tensor,
                       orig_h: int, orig_w: int, scale_int: float,
                       cfg: DecodeConfig = DecodeConfig()) -> Detections:
    """Model forward (eval, standard head layout) followed by the full decode."""
    with span("forward"):
        outputs = model(images)
    return decode_output(outputs, anchors, orig_h, orig_w, scale_int, cfg)
