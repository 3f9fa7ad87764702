"""The greedy-NMS kernel (``kernels/nms.py``, ``csrc/nms.cu``) and the class
offset of ``ops/decode.decode_boxes``.

On the CPU: the kernel's twin ``nms_keep_plain`` (the fixpoint ``leader_nms``
runs eagerly there) against ``greedy_nms`` and the JAX decode's fixpoint and
greedy oracle, on rank-sorted sets at K = 1, 7 and 512, B = 1, 3 and 8, with
IoUs exactly at the threshold, duplicate boxes, all-invalid and all-valid
rows, and 8 classes set apart as the decode's class offset does; a numpy model of the kernel's packing and chunked walk against
``greedy_nms`` (and blind to what lies on and below the diagonal); the input
checks, CPU tensors refused; the class offset filled on the device against the mask copied from the host,
bit for bit. JAX is imported inside the tests that use it.

On a CUDA card only (marked ``cuda``): the kernel against the twin and
``greedy_nms`` on 1,040 random sets (K up to 700, B up to 8, threshold
ties, shared-memory and scratch layouts, an unaligned ``sup``), and against
the twin at the serving decode's B=1 and B=8, K=512:

    python -m pytest --noconftest -m cuda tests/test_torch_nms.py
"""

import numpy as np
import pytest
import torch

from instance_segmentation_torch.kernels import nms
from instance_segmentation_torch.ops import decode

import torch_cases
from torch_cases import cuda_device  # noqa: F401 (a fixture)

torch.set_num_threads(2)


def _boxes(rng, b, k, scale=80.0):
    """[b, k, 4] xyxy float32 boxes in rank order."""
    xy = rng.uniform(0, scale, (b, k, 2))
    wh = rng.uniform(scale / 16, scale / 3, (b, k, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def _sup(boxes: torch.Tensor, iou_th: float) -> torch.Tensor:
    """``leader_nms``'s suppression matrix of [..., K, 4] boxes."""
    K = boxes.shape[-2]
    rank = torch.arange(K, device=boxes.device)
    return (decode._iou_xyxy(boxes) > iou_th) & (rank[:, None] < rank[None, :])


def _tie_boxes(rng, b, k):
    """Pairs whose IoU is exactly 1/2 or 1/4 (the thresholds the tie cases
    use): a unit box [x, y, x+1, y+1] beside [x, y, x+2, y+1] (IoU 1/2) and
    [x, y, x+4, y+1] (IoU 1/4), at integer corners, in random rank order."""
    out = np.empty((b, k, 4), np.float32)
    for img in range(b):
        corners = rng.integers(0, 6, (k, 2)).astype(np.float32)
        widths = rng.choice([1.0, 2.0, 4.0], k).astype(np.float32)
        out[img] = np.concatenate([corners, corners + np.stack([widths, np.ones(k)], -1)], -1)
    return out


CASES = {
    # name: (B, K, iou_th, boxes rule, valid rule)
    "k1-b1": (1, 1, 0.2, "random", "random"),
    "k7-b3": (3, 7, 0.2, "random", "random"),
    "k512-b1": (1, 512, 0.2, "random", "random"),
    "k512-b3": (3, 512, 0.3, "random", "random"),
    "ties-half": (3, 64, 0.5, "ties", "random"),
    "ties-quarter": (1, 96, 0.25, "ties", "all"),
    "duplicates": (3, 48, 0.2, "duplicates", "random"),
    "all-invalid": (3, 40, 0.2, "random", "none"),
    "all-valid": (3, 200, 0.2, "random", "all"),
    "classes-b8": (8, 512, 0.2, "classes", "random"),
}


def _case(name, seed=0):
    B, K, th, boxes_rule, valid_rule = CASES[name]
    rng = np.random.default_rng(seed)
    if boxes_rule == "ties":
        boxes = _tie_boxes(rng, B, K)
    else:
        boxes = _boxes(rng, B, K)
        if boxes_rule == "duplicates":            # each box twice or more, neighbours in rank
            boxes = np.ascontiguousarray(boxes[:, np.sort(rng.integers(0, K // 3, K))])
        if boxes_rule == "classes":               # 8 classes apart, as the decode offsets them
            boxes += (rng.integers(0, 8, (B, K, 1)) * 3072.0 * np.array([1, 0, 1, 0]))
            boxes = boxes.astype(np.float32)
    valid = {"random": rng.uniform(size=(B, K)) > 0.25, "all": np.ones((B, K), bool),
             "none": np.zeros((B, K), bool)}[valid_rule]
    return torch.from_numpy(boxes), torch.from_numpy(valid), th


@pytest.mark.parametrize("name", list(CASES))
def test_cpu_twin_equals_greedy_and_the_jax_fixpoint(name):
    import jax
    from instance_segmentation_tpu.ops import decode as jd

    boxes, valid, th = _case(name)
    B, K = valid.shape
    keep = nms.nms_keep_plain(_sup(boxes, th), valid)
    assert keep.dtype == torch.bool and keep.shape == (B, K)
    if name == "ties-half":                        # the pairs at exactly 1/2 are there
        iou = decode._iou_xyxy(boxes)
        assert bool((iou == 0.5).any()) and bool((iou > 0.5).any())
    greedy = jax.jit(lambda b, v: jd.greedy_nms(b, v, th))
    fixpoint = jax.jit(lambda b, v: jd.leader_nms(b, v, th, K))
    for img in range(B):
        want = decode.greedy_nms(boxes[img], valid[img], th)
        assert torch.equal(keep[img], want), img
        np.testing.assert_array_equal(
            np.asarray(greedy(boxes[img].numpy(), valid[img].numpy())), want.numpy())
        idx, ok = (np.asarray(a) for a in fixpoint(boxes[img].numpy(), valid[img].numpy()))
        jax_keep = np.zeros(K, bool)
        jax_keep[idx[ok]] = True
        np.testing.assert_array_equal(jax_keep, want.numpy())
    if name == "all-invalid":
        assert not bool(keep.any())
    if name == "duplicates":                       # a duplicate below its kept twin goes
        assert bool(keep.any()) and int(keep.sum()) < int(valid.sum())


def test_cpu_twin_is_leader_nms_eager_fixpoint_with_its_sync_spans():
    """The twin is ``_nms_eager``: on the CPU it reads the loop's condition on
    the host, in a span "sync:nms", once a sweep and the first twice."""
    from torch.profiler import ProfilerActivity, profile
    from instance_segmentation_torch.utils import profiling

    boxes, valid, th = _case("k7-b3")
    sup = _sup(boxes, th)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        keep = nms.nms_keep_plain(sup, valid)
    reads = sum(e.name == "sync:nms" for e in profiling.trace_events(prof)
                if e.annotation and not e.device)
    sweeps, prev = 0, ~valid
    cur = valid.clone()
    while bool((cur != prev).any()) and sweeps < valid.shape[1]:
        cur, prev = valid & ~(cur[..., :, None] & sup).any(dim=-2), cur
        sweeps += 1
    assert torch.equal(keep, cur)
    assert reads == sweeps + 2


def _kernel_model(sup: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """The kernel in numpy: pack each row's strict upper triangle into 32-bit
    words (bits at and below the diagonal cleared), then walk the chunks of
    32 boxes, resolving each chunk in registers and ORing its kept rows into
    the later words of ``supp``."""
    B, K = valid.shape
    nw = (K + 31) // 32
    keep = np.zeros((B, K), bool)
    for b in range(B):
        padded = np.zeros((K, nw * 32), bool)
        padded[:, :K] = sup[b] != 0
        weights = (1 << np.arange(32, dtype=np.uint64))
        bits = (padded.reshape(K, nw, 32) * weights).sum(-1).astype(np.uint64)
        for j in range(K):
            bits[j, j // 32] &= ~np.uint64((2 << (j % 32)) - 1) & np.uint64(0xFFFFFFFF)
        supp = np.zeros(nw, np.uint64)
        for c in range(nw):
            rows = [int(bits[i, c]) if i < K else 0 for i in range(32 * c, 32 * c + 32)]
            ballot = sum(1 << t for t in range(32) if 32 * c + t < K and valid[b, 32 * c + t])
            cand = ballot & ~int(supp[c]) & 0xFFFFFFFF
            for t in range(32):
                if (cand >> t) & 1:
                    cand &= ~rows[t]
            for t in range(32):
                if 32 * c + t < K:
                    keep[b, 32 * c + t] = bool((cand >> t) & 1)
            for w in range(c + 1, nw):
                for t in range(32):
                    if (cand >> t) & 1:
                        supp[w] |= bits[32 * c + t, w]
    return keep


@pytest.mark.parametrize("K", [1, 31, 32, 33, 100, 130])
def test_kernel_model_equals_greedy(K):
    rng = np.random.default_rng(K)
    for seed in range(6):
        B = 1 + seed % 3
        boxes = torch.from_numpy(_boxes(rng, B, K, scale=40.0))
        valid = torch.from_numpy(rng.uniform(size=(B, K)) > 0.2)
        th = float(rng.choice([0.1, 0.2, 0.5]))
        sup = _sup(boxes, th)
        # what lies on and below the diagonal must not matter
        noisy = sup | torch.from_numpy(np.tril(rng.uniform(size=(B, K, K)) > 0.5))
        got = _kernel_model(noisy.numpy(), valid.numpy())
        for img in range(B):
            want = decode.greedy_nms(boxes[img], valid[img], th)
            np.testing.assert_array_equal(got[img], want.numpy())
        np.testing.assert_array_equal(got, nms.nms_keep_plain(sup, valid).numpy())


@pytest.mark.parametrize("case, message", [
    ("sup_dtype", "sup: want bool"), ("sup_shape", "sup: want bool"),
    ("valid_dtype", "valid: want bool"), ("meta", "want cuda tensors"),
    ("cpu", "want cuda tensors"), ("devices", "different devices"), ("strided", "contiguous")])
def test_nms_keep_checks_its_inputs(case, message):
    sup = torch.zeros(2, 8, 8, dtype=torch.bool)
    valid = torch.ones(2, 8, dtype=torch.bool)
    if case == "sup_dtype":
        sup = sup.float()
    elif case == "sup_shape":
        sup = sup[:, :7]
    elif case == "valid_dtype":
        valid = valid.int()
    elif case == "meta":
        sup, valid = sup.to("meta"), valid.to("meta")
    elif case == "devices":
        sup = sup.to("meta")
    elif case == "strided":
        sup = sup.transpose(1, 2)
        sup[0, 0, 1] = True
    with pytest.raises(ValueError, match=message):
        nms.nms_keep(sup, valid)


def test_class_offset_filled_on_the_device_equals_the_host_mask():
    """``b_k + off * _x_columns(dev)`` is ``b_k + off * [1, 0, 1, 0]`` bit for
    bit, -0.0 coordinates and class 0 included (-0 + +0 is +0 on both)."""
    rng = np.random.default_rng(5)
    b_k = torch.from_numpy(rng.uniform(-5, 500, (2, 512, 4)).astype(np.float32))
    b_k[0, :8] = -0.0
    b_k[1, :4] = torch.tensor([0.0, -0.0, float("inf"), 1e-45])
    c_k = torch.from_numpy(rng.integers(0, 80, (2, 512)))
    c_k[:, :16] = 0
    off = (c_k.float() * (1024 + 512) * 2.0)[..., None]
    mask = decode._x_columns(torch.device("cpu"))
    host = torch.tensor([1.0, 0.0, 1.0, 0.0])
    assert mask.dtype == torch.float32 and torch.equal(mask.view(torch.int32),
                                                       host.view(torch.int32))
    got, want = b_k + off * mask, b_k + off * host
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert bool((got[0, :8, 1].view(torch.int32) == 0).all())       # -0 + +0 = +0


def test_decode_boxes_copies_nothing_from_the_host(monkeypatch):
    """``decode_boxes`` builds every tensor on its device: no ``torch.tensor``
    or ``as_tensor`` of host data, which a CUDA graph cannot hold."""
    rng = np.random.default_rng(6)
    A, C = 300, 8
    cls = torch.from_numpy(rng.uniform(size=(2, A, C)).astype(np.float32))
    reg = torch.from_numpy(rng.normal(0, 0.2, (2, A, 4)).astype(np.float32))
    anchors = torch.from_numpy(_boxes(rng, 1, A, scale=100.0)[0][:, [1, 0, 3, 2]])
    cfg = decode.DecodeConfig(pre_nms=64, max_dets=16)
    want = decode.decode_boxes(cls, reg, anchors, 128, 256, cfg)

    def refuse(*args, **kwargs):
        raise AssertionError("a tensor made from host data")

    monkeypatch.setattr(torch, "tensor", refuse)
    monkeypatch.setattr(torch, "as_tensor", refuse)
    got = decode.decode_boxes(cls, reg, anchors, 128, 256, cfg)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert int(got[3].sum()) > 0


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------

def _card_sets():
    """(B, K, iou_th, ties) per batch: 130 batches, 1,040 sets."""
    rng = np.random.default_rng(21)
    shapes = [(8, 512), (8, 7), (8, 1), (8, 33), (8, 100), (8, 608), (8, 640), (8, 700),
              (8, 96), (8, 512)]
    for n in range(130):
        B, K = shapes[n % len(shapes)]
        yield B, K, float(rng.choice([0.2, 0.25, 0.5])), n % 3 == 0, n


@pytest.mark.cuda
def test_kernel_equals_the_twin_and_greedy_on_1040_sets(cuda_device):
    sets = 0
    before = nms.launches
    for B, K, th, ties, seed in _card_sets():
        rng = np.random.default_rng(seed)
        boxes = torch.from_numpy(_tie_boxes(rng, B, K) if ties else _boxes(rng, B, K))
        valid = torch.from_numpy(rng.uniform(size=(B, K)) > 0.2)
        sup = _sup(boxes, th)
        got = nms.nms_keep(sup.to(cuda_device), valid.to(cuda_device)).cpu()
        twin = nms.nms_keep_plain(sup, valid)
        assert torch.equal(got, twin), (B, K, th, ties, seed)
        if seed % 10 == 0:
            for img in range(B):
                assert torch.equal(got[img], decode.greedy_nms(boxes[img], valid[img], th))
        sets += B
    assert sets >= 1000
    assert nms.launches - before == 130


@pytest.mark.cuda
def test_kernel_reads_an_unaligned_sup_a_byte_at_a_time(cuda_device):
    rng = np.random.default_rng(22)
    B, K, th = 3, 512, 0.2
    boxes = torch.from_numpy(_boxes(rng, B, K))
    valid = torch.from_numpy(rng.uniform(size=(B, K)) > 0.2)
    sup = _sup(boxes, th)
    flat = torch.zeros(B * K * K + 1, dtype=torch.bool, device=cuda_device)
    shifted = flat[1:].view(B, K, K)
    shifted.copy_(sup)
    assert shifted.data_ptr() % 16 == 1
    got = nms.nms_keep(shifted, valid.to(cuda_device)).cpu()
    assert torch.equal(got, nms.nms_keep_plain(sup, valid))


@pytest.mark.cuda
def test_leader_nms_on_the_card_equals_the_cpu_and_reads_nothing(cuda_device, monkeypatch):
    rng = np.random.default_rng(23)
    boxes = torch.from_numpy(_boxes(rng, 8, 512))
    valid = torch.from_numpy(rng.uniform(size=(8, 512)) > 0.2)
    want = decode.leader_nms(boxes, valid, 0.2, 96)
    monkeypatch.setattr(decode, "_nms_read", None)             # no host read on the card
    got = decode.leader_nms(boxes.to(cuda_device), valid.to(cuda_device), 0.2, 96)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 8])
def test_kernel_equals_the_twin_at_the_serving_decodes_shapes(cuda_device, b):
    """One launch at B=1 and B=8, K=512 (the serving decode's pre_nms) on
    rank-sorted boxes of 8 classes, equal to the eager fixpoint on the CPU."""
    sup, valid = torch_cases.nms_inputs(b, 512)
    want = nms.nms_keep_plain(sup, valid)
    before = nms.launches
    got = nms.nms_keep(sup.to(cuda_device), valid.to(cuda_device))
    torch.cuda.synchronize()
    assert nms.launches == before + 1
    assert torch.equal(got.cpu(), want)
    assert 0 < int(want.sum()) < int(valid.sum())
