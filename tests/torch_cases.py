"""Inputs and fixtures the port's tests share, free of JAX and of the CLIs:
the card files import them on the machine with the card, which has no JAX
(README: ``pytest --noconftest -m cuda``).

- ``cuda_device``: the CUDA card, or a skip where there is none;
- ``synthetic_scene`` / ``SCENE_DECODE``: model-like outputs of two squares;
- ``affinity_inputs`` / ``affinity_edge_cases`` / ``against_cpu_twin``: K1's
  grouping inputs at decode shapes and the comparison with its CPU twin;
- ``nms_inputs``: the NMS kernel's inputs on a serving-like set;
- ``yaml_text``: a config written as YAML without PyYAML;
- ``SERVING_CONFIGS`` / ``bn_calls``: the serving cells' models and the
  shapes their eval forward hands the batch-norm kernel;
- the shapes of the serving decode's grouping and of the train cells.
"""

import numpy as np
import pytest
import torch

from instance_segmentation_torch.kernels import affinity, bn_act
from instance_segmentation_torch.models import EfficientSeg, EfficientSegConfig, generate_anchors
from instance_segmentation_torch.ops import decode
from instance_segmentation_torch.ops.decode import DecodeConfig

AFFINITY_SHAPE = (8, 20000, 96)          # B, K (kp_th), D (max_dets)
TRAIN_SHAPE = (8, 96, 1024, 512, 1024)   # B, M, P, H, W: the d3-train-b8 cell
FULLRES_SHAPE = (1, 96, 1024, 1024, 2048)  # B, M, P, H, W: tools/fullres_demo.py's defaults
SCENE_SQUARES = (((20, 30), (60, 70), 0), ((80, 100), (110, 150), 1))
SCENE_DECODE = DecodeConfig(kp_th=2000, pre_nms=64, max_dets=8, max_poly=512)


@pytest.fixture
def cuda_device():
    """The CUDA card, with TF32 off while the test runs (float32 on the card
    is then held to the CPU's float32); a skip where there is no card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: what this test holds runs only there")
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield torch.device("cuda")
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def synthetic_scene(h: int = 128, w: int = 192, margin: float = 0.0):
    """Model-like outputs holding two clean squares (the JAX package's decode
    test scene): kp logits 8 on the square outlines and -8 elsewhere, zero
    embedding offsets with sigma exp(5), and for each square its best-IoU
    anchor given score 0.95 and the regression onto the square grown by
    ``margin`` pixels. With margin 0 the box edges fall exactly on the outline
    pixels, so whether those pixels lie in their box turns on the last bit of
    ``exp``; a margin of half a pixel makes the scene independent of it.
    Returns ((kp, ae, tan, regression, classification), anchors) as numpy."""
    kp = np.full((1, h, w, 1), -8.0, np.float32)
    ae = np.zeros((1, h, w, 4), np.float32)
    ae[..., 2:4] = 5.0
    tan = np.zeros((1, h, w, 2), np.float32)
    for (y1, x1), (y2, x2), _ in SCENE_SQUARES:
        kp[0, y1:y2 + 1, [x1, x2], 0] = 8.0
        kp[0, [y1, y2], x1:x2 + 1, 0] = 8.0
    anchors = generate_anchors(h, w, pyramid_levels=(3, 4, 5))
    cls_prob = np.full((1, anchors.shape[0], 3), 1e-3, np.float32)
    reg = np.zeros((1, anchors.shape[0], 4), np.float32)
    ay1, ax1, ay2, ax2 = anchors[:, 0], anchors[:, 1], anchors[:, 2], anchors[:, 3]
    for (y1, x1), (y2, x2), cls in SCENE_SQUARES:
        gt = np.array([x1 - margin, y1 - margin, x2 + margin, y2 + margin], np.float32)
        iw = np.clip(np.minimum(ax2, gt[2]) - np.maximum(ax1, gt[0]), 0, None)
        ih = np.clip(np.minimum(ay2, gt[3]) - np.maximum(ay1, gt[1]), 0, None)
        inter = iw * ih
        union = (ax2 - ax1) * (ay2 - ay1) + (gt[2] - gt[0]) * (gt[3] - gt[1]) - inter
        best = int(np.argmax(inter / np.clip(union, 1e-8, None)))
        cls_prob[0, best, cls] = 0.95
        aw, ah = ax2[best] - ax1[best], ay2[best] - ay1[best]
        acx, acy = (ax1[best] + ax2[best]) / 2, (ay1[best] + ay2[best]) / 2
        gcx, gcy = (gt[0] + gt[2]) / 2, (gt[1] + gt[3]) / 2
        reg[0, best] = [(gcy - acy) / ah, (gcx - acx) / aw,
                        np.log((gt[3] - gt[1]) / ah), np.log((gt[2] - gt[0]) / aw)]
    return (kp, ae, tan, reg, cls_prob), anchors


def affinity_inputs(b: int, k: int, d: int, seed: int = 0, decode_order: bool = False):
    """Grouping inputs at decode shapes for a 512x1024 input: keypoints over
    the whole frame (many in no box), a quarter of the detections invalid,
    and centers d+d/2 duplicating d (exact ties). With ``decode_order`` the
    keypoints are unique pixels in ascending flat index, as
    ``select_peaks_batch`` returns them; else drawn in random order, where
    culling centers by the keypoints' rows cannot help. Numpy float32/bool."""
    rng = np.random.default_rng(seed)
    if decode_order:
        flat = np.sort(np.stack([rng.choice(512 * 1024, k, replace=False) for _ in range(b)]))
        kp_rc = np.stack([flat // 1024, flat % 1024], axis=-1).astype(np.float32)
    else:
        kp_rc = np.stack([rng.integers(0, 512, (b, k)), rng.integers(0, 1024, (b, k))],
                         axis=-1).astype(np.float32)
    emb = np.stack([kp_rc[..., 0] / 1023.0, kp_rc[..., 1] * (2.0 / 2047.0)], -1)
    emb = (emb + rng.normal(0.0, 0.05, (b, k, 2))).astype(np.float32)
    sig = np.exp(rng.normal(3.0, 1.0, (b, k, 2))).astype(np.float32)
    xy = np.stack([rng.uniform(0, 900, (b, d)), rng.uniform(0, 450, (b, d))], -1)
    wh = rng.uniform(20, 250, (b, d, 2))
    boxes = np.concatenate([xy, xy + wh], axis=-1).astype(np.float32)
    ctr = (boxes[..., :2] + boxes[..., 2:]) / 2
    c_emb = np.stack([ctr[..., 1] / 1023.0, ctr[..., 0] * (2.0 / 2047.0)], -1)
    c_emb = c_emb.astype(np.float32)
    det_valid = rng.uniform(size=(b, d)) > 0.25
    half = d // 2
    c_emb[:, half:2 * half] = c_emb[:, :half]
    boxes[:, half:2 * half] = boxes[:, :half]
    det_valid[:, half:2 * half] = det_valid[:, :half]
    return kp_rc, emb, sig, c_emb, boxes, det_valid


def affinity_edge_cases():
    """[(name, inputs)]: grouping inputs where NaN, inf and underflow decide
    the result, and shapes at the kernel's limits, each in decode order and
    in random order. The scores follow the JAX decode's ``dists *
    contained`` (NaN * 0 is NaN) and ``jnp.argmax`` (the first NaN wins)."""
    def contained(a):
        return affinity.contained_plain(*(torch.from_numpy(a[i]) for i in (0, 4, 5))).numpy()

    def nan_emb(a):                  # NaN everywhere: slot 0, best NaN
        inside = contained(a)[0].any(-1)
        a[1][0, np.flatnonzero(inside)[:3], 0] = np.nan
        a[1][0, np.flatnonzero(~inside)[:3], 1] = np.nan

    def inf_sig_outside(a):          # 0 * inf at center 5 only: slot 5, NaN
        out = np.flatnonzero(~contained(a)[0].any(-1))[:4]
        a[2][0, out, 0] = np.inf
        a[1][0, out, 0] = a[3][0, 5, 0]

    def zero_sig(a):                 # sig 0: score 1 in every box; inf * 0
        a[2][0, np.flatnonzero(contained(a)[0].any(-1))[:4]] = 0.0
        a[3][1, 0, 0] = 2e19         # dy^2 overflows for every center but 0
        a[1][1, :5, 0] = 2e19
        a[2][1, :5, 0] = 0.0

    def nonfinite_c_emb(a):          # invalid detections: NaN * 0 is NaN
        a[3][0, 3, 0] = np.nan
        a[5][0, 3] = False
        a[3][1, 2, 1] = np.inf
        a[5][1, 2] = False

    def underflow(a):                # contained, but every score 0: slot 0
        c = contained(a)[0]
        late = np.flatnonzero(c.any(-1) & ~c[:, 0])[:6]
        a[2][0, late] = 1e30

    def empty_lists(a):              # no box meets the keypoints' rows
        a[0][..., 0] = np.floor(a[0][..., 0] / 4)
        a[4][..., 1] = 200 + a[4][..., 1] % 100
        a[4][..., 3] = a[4][..., 1] + 50
        a[3][1, 4] = np.nan          # the NaN rule still applies

    cases = []
    for order in ("decode order", "random order"):
        def make(b, k, d, seed, edit=None):
            a = list(affinity_inputs(b, k, d, seed, decode_order=order == "decode order"))
            if edit is not None:
                edit(a)
            return tuple(a)
        cases += [
            (f"NaN embedding in and out of boxes, {order}", make(1, 300, 16, 1, nan_emb)),
            (f"sig inf with dy 0 in no box, {order}", make(1, 300, 16, 2, inf_sig_outside)),
            (f"sig 0, dy^2 overflowing, {order}", make(2, 300, 16, 3, zero_sig)),
            (f"non-finite c_emb of invalid detections, {order}",
             make(2, 300, 16, 4, nonfinite_c_emb)),
            (f"contained scores underflowing to 0, {order}", make(1, 300, 16, 5, underflow)),
            (f"D=1, K=1037, {order}", make(2, 1037, 1, 6)),
            (f"D=1024, K=3000, {order}", make(1, 3000, 1024, 7)),
            (f"every culled list empty, {order}", make(2, 2000, 16, 8, empty_lists)),
        ]
    return cases


def against_cpu_twin(assign: torch.Tensor, best: torch.Tensor, inputs) -> dict:
    """K1's (assign, best) against the plain grouping computed on the CPU:
    best to rtol 1e-6 with NaN where the twin has NaN, assign equal outside
    near ties (a row without NaN whose top score has another score within
    1e-6 of it that is not equal to it: the card's expf and the CPU's exp
    may differ in the last bit)."""
    cpu = [t.cpu() for t in inputs]
    scored = affinity.affinity_scores_plain(*cpu)
    b_p, a_p = scored.max(dim=-1)
    nan = b_p.isnan()
    top = b_p[..., None]
    runner_up = scored.masked_fill((scored == top) | scored.isnan(), -1.0).amax(-1)
    near = (b_p - runner_up <= 1e-6 * b_p) & ~nan
    a_k, b_k = assign.cpu(), best.cpu()
    mismatch = a_k != a_p.int()
    finite = ~nan & ~b_k.isnan()
    return {"mismatch": int(mismatch.sum()), "bad": int((mismatch & ~near).sum()),
            "near": int(near.sum()),
            "exact_ties": int((((scored == top).sum(-1) > 1) & (b_p > 0)).sum()),
            "best_ok": bool(torch.allclose(b_k, b_p, rtol=1e-6, atol=0.0, equal_nan=True)),
            "nan": int(nan.sum()),
            "max_abs": float((b_k - b_p)[finite].abs().max()) if bool(finite.any()) else 0.0,
            "in_no_box": int((~affinity.contained_plain(
                cpu[0], cpu[4], cpu[5]).any(-1)).sum())}


def nms_inputs(b: int, k: int, seed: int = 0, iou_th: float = 0.2):
    """(sup [b, k, k], valid [b, k]) of ``leader_nms`` on a serving-like set:
    k rank-sorted boxes of 10-200 px in a 512x1024 frame, 8 classes (the
    class offset apart), 90% valid."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, (1024, 512), (b, k, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(10, 200, (b, k, 2))], -1).astype(np.float32)
    boxes += (rng.integers(0, 8, (b, k, 1)) * 3072.0 * np.array([1, 0, 1, 0])).astype(np.float32)
    boxes = torch.from_numpy(boxes)
    rank = torch.arange(k)
    sup = (decode._iou_xyxy(boxes) > iou_th) & (rank[:, None] < rank[None, :])
    return sup, torch.from_numpy(rng.uniform(size=(b, k)) > 0.1)


def yaml_text(tree: dict, indent: str = "") -> str:
    """A nested dict of scalars and lists as YAML the port's reader takes
    (strings single-quoted, None empty), where PyYAML is not installed."""
    def scalar(v):
        if v is None:
            return ""
        if isinstance(v, bool):
            return "true" if v else "false"
        if isinstance(v, str):
            return "'" + v.replace("'", "''") + "'"
        if isinstance(v, (list, tuple)):
            return "[" + ", ".join(scalar(x) for x in v) + "]"
        return repr(v)
    out = ""
    for k, v in tree.items():
        if isinstance(v, dict):
            out += f"{indent}{k}:\n" + yaml_text(v, indent + "  ")
        else:
            out += f"{indent}{k}: {scalar(v)}".rstrip() + "\n"
    return out


# the serving cells' models at b1 (benchmark/configs/): (config, input H x W)
SERVING_CONFIGS = {
    "d3": (EfficientSegConfig(num_classes=8, compound_coef=3, compute_dtype=torch.bfloat16),
           (512, 1024)),
    "v2l": (EfficientSegConfig(num_classes=8, compound_coef=3, compute_dtype=torch.bfloat16,
                               backbone="efficientnetv2-l"), (512, 1024)),
    "d7x": (EfficientSegConfig(num_classes=80, compound_coef=8, compute_dtype=torch.bfloat16),
            (1536, 1536)),
    "maxvitb": (EfficientSegConfig(num_classes=8, compound_coef=3, compute_dtype=torch.bfloat16,
                                   backbone="maxvit-b"), (512, 1024)),
}


def bn_calls(cfg: EfficientSegConfig, hw, batch: int = 1) -> list:
    """Every application of a frozen batch norm or gate in the eval forward
    of ``cfg`` on [batch, H, W, 3] frames, in order, as (x's shape, scale
    per image, with a shift, act): the forward run on the meta device
    (shapes, no data), each ``bn_act.bn_act`` call recorded."""
    calls = []
    op = bn_act.bn_act

    def record(x, scale, shift=None, act="none"):
        calls.append((tuple(x.shape), scale.dim() == 2, shift is not None, act))
        return op(x, scale, shift, act)
    with torch.device("meta"):
        model = EfficientSeg(cfg)
    frames = torch.empty((batch, *hw, 3), dtype=torch.uint8, device="meta")
    bn_act.bn_act = record
    try:
        with torch.no_grad():
            model(frames)
    finally:
        bn_act.bn_act = op
    return calls
