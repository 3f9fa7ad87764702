"""The port's centre-heatmap decode (ops/decode.py ``decode_centers``, with
``greedy_nms`` and ``select_peaks``) against the JAX decode on the same
numpy inputs: ``tests/test_decode.py``'s cases (greedy NMS against the
classic oracle, leader NMS against greedy, the two-centre scene) and seeded
random maps. Every output is compared exactly (integers, booleans and the
float confidences and sizes, which are read from the maps, not computed)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from instance_segmentation_tpu.ops import decode as jd
from instance_segmentation_torch.ops import decode as td

from test_decode import nms_oracle

torch.set_num_threads(2)


def _boxes(seed, n=64):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 80, size=(n, 2))
    wh = rng.uniform(5, 30, size=(n, 2))
    boxes = np.concatenate([xy, xy + wh], axis=1).astype(np.float32)
    return boxes, rng.uniform(0.1, 1.0, size=n).astype(np.float32)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_greedy_nms_matches_oracle_and_jax(seed):
    boxes, scores = _boxes(seed)
    order = np.argsort(-scores)
    sb = boxes[order]
    for valid in (np.ones(len(sb), bool), scores[order] > 0.5):
        keep = td.greedy_nms(torch.from_numpy(sb), torch.from_numpy(valid), 0.3)
        want = jax.jit(lambda b, v: jd.greedy_nms(b, v, 0.3))(sb, valid)
        np.testing.assert_array_equal(keep.numpy(), np.asarray(want))
        if valid.all():
            assert sorted(order[keep.numpy()]) == nms_oracle(boxes, scores, 0.3)


@pytest.mark.parametrize("seed", [2, 4])
def test_leader_nms_equals_greedy_nms(seed):
    boxes, scores = _boxes(seed)
    sb = torch.from_numpy(boxes[np.argsort(-scores)])
    for valid in (torch.ones(len(sb), dtype=torch.bool),
                  torch.from_numpy(np.sort(scores)[::-1].copy() > 0.5)):
        keep = td.greedy_nms(sb, valid, 0.3)
        idx, ok = td.leader_nms(sb, valid, 0.3, 16)
        assert idx[ok].tolist() == torch.nonzero(keep)[:, 0][:int(ok.sum())].tolist()
        assert int(ok.sum()) == min(16, int(keep.sum()))


def _jax_centers(conf, cls, wh, **kw):
    return [np.asarray(o) for o in jax.jit(
        lambda c, k, w: jd.decode_centers(c, k, w, **kw))(conf, cls, wh)]


def _assert_equal(got, want):
    names = ("centers", "classes", "confs", "whs", "valid")
    for name, g, w in zip(names, got, want):
        assert g.numpy().dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


def test_decode_centers_two_centre_scene():
    H, W = 64, 96
    conf = np.zeros((H, W), np.float32)
    cls = np.zeros((H, W), np.int32)
    wh = np.zeros((H, W, 2), np.float32)
    conf[20, 30] = 0.9; cls[20, 30] = 2; wh[20, 30] = (10, 14)
    conf[40, 70] = 0.8; cls[40, 70] = 5; wh[40, 70] = (8, 8)
    conf[21, 30] = 0.5     # adjacent non-peak
    got = td.decode_centers(*map(torch.from_numpy, (conf, cls, wh)), num_centers=32)
    _assert_equal(got, _jax_centers(conf, cls, wh, num_centers=32))
    centers, classes, _, _, ok = got
    assert {tuple(c) for c in centers[ok].tolist()} == {(20, 30), (40, 70)}
    assert set(classes[ok].tolist()) == {2, 5}


def _random_maps(seed, h=48, w=80, n_cls=4):
    rng = np.random.default_rng(seed)
    conf = rng.uniform(-0.2, 1.0, (h, w)).astype(np.float32)
    conf[rng.uniform(size=(h, w)) < 0.3] = 0.0                   # flat zero regions
    conf[5, 5] = conf[5, 6] = 0.95                               # a tie between neighbours
    cls = rng.integers(0, n_cls, (h, w)).astype(np.int32)
    wh = rng.uniform(2, 24, (h, w, 2)).astype(np.float32)
    return conf, cls, wh


@pytest.mark.parametrize("seed,num_centers,iou_th,max_out", [
    (0, 64, 0.5, 96), (1, 200, 0.3, 32), (2, 512, 0.5, 96), (3, 16, 0.1, 8)])
def test_decode_centers_equals_jax_on_random_maps(seed, num_centers, iou_th, max_out):
    conf, cls, wh = _random_maps(seed)
    kw = dict(num_centers=num_centers, iou_th=iou_th, max_out=max_out)
    got = td.decode_centers(*map(torch.from_numpy, (conf, cls, wh)), **kw)
    want = _jax_centers(conf, cls, wh, **kw)
    _assert_equal(got, want)
    assert 0 < int(got[4].sum()) <= min(num_centers, max_out)


def test_select_peaks_single_image_equals_jax():
    conf, _, _ = _random_maps(5)
    idx, ok = td.select_peaks(torch.from_numpy(conf), 100)
    want_idx, want_ok = jax.jit(lambda a: jd.select_peaks(a, 100))(conf)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(want_ok))
