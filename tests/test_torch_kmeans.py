"""The port's k-means (``ops/kmeans.py``) and the decode's
``group_mode="kmeans"`` against the JAX package on the CPU.

``kmeans`` runs on seeded points (euclidean and cosine, with invalid points
and a finite ``max_distance`` that makes outliers): the centres agree to
1e-5 and the labels are equal except at near-ties, points whose two
nearest centres lie within 1e-5 of each other (relative, in the JAX
centres' distances), which are counted and must be few. The centre update
``member.T @ points`` sums in another order in the two libraries, so a
centre may move by an ulp and flip such a point.

``decode_output(group_mode="kmeans")`` runs on the outputs of a seeded
EfficientSeg-B0 at 128x256 (class bias raised so that there are
detections), and on the synthetic two-object scene, against the jitted
JAX decode: integer and boolean fields equal, floats to 1e-5, polygon
vertices that tie in polar angle in either order (``assert_detections_match``
of ``test_torch_decode.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instance_segmentation_tpu.ops import decode as jd
from instance_segmentation_tpu.ops import kmeans as jk
from instance_segmentation_torch.models import EfficientSeg, EfficientSegConfig
from instance_segmentation_torch.models.anchors import generate_anchors
from instance_segmentation_torch.ops import decode as td
from instance_segmentation_torch.ops import kmeans as tk
from instance_segmentation_torch.weights import init_random

import torch_cases
from test_torch_decode import assert_detections_match

torch.set_num_threads(2)
TIE = 1e-5


def _points(seed, n=600, k=12, d=2):
    rng = np.random.default_rng(seed)
    centres = rng.uniform(-1, 1, (k, d)).astype(np.float32)
    pts = (centres[rng.integers(0, k, n)] + rng.normal(0, 0.15, (n, d))).astype(np.float32)
    init = (centres + rng.normal(0, 0.2, (k, d))).astype(np.float32)
    valid = rng.random(n) > 0.1
    return pts, init, valid


def near_ties(points, centers, got, want, distance):
    """Indices where the labels differ, and whether each is a near-tie: the
    two labels' distances (float64, from JAX's centres) within TIE."""
    p, c = points.astype(np.float64), np.asarray(centers, np.float64)
    if distance == "cosine":
        pn = p / np.maximum(np.linalg.norm(p, axis=1, keepdims=True), 1e-8)
        cn = c / np.maximum(np.linalg.norm(c, axis=1, keepdims=True), 1e-8)
        d = 1.0 - pn @ cn.T
    else:
        d = ((p[:, None] - c[None]) ** 2).sum(-1)
    d = np.concatenate([d, np.full((len(p), 1), np.inf)], axis=1)   # the outlier label
    diff = np.flatnonzero(got != want)
    a, b = d[diff, got[diff]], d[diff, want[diff]]
    return diff, np.abs(a - b) <= TIE * np.maximum(np.abs(b), 1e-3)


@pytest.mark.parametrize("distance", ["euclidean", "cosine"])
@pytest.mark.parametrize("seed", range(3))
def test_kmeans_equals_jax(distance, seed):
    pts, init, valid = _points(seed)
    max_d = 0.05 if distance == "euclidean" else 0.02
    want_l, want_c = jax.jit(lambda p, i, v: jk.kmeans(p, i, valid=v, max_distance=max_d,
                                                       num_iters=6, distance=distance))(
        jnp.asarray(pts), jnp.asarray(init), jnp.asarray(valid))
    got_l, got_c = tk.kmeans(torch.from_numpy(pts), torch.from_numpy(init),
                             valid=torch.from_numpy(valid), max_distance=max_d, num_iters=6,
                             distance=distance)
    assert got_l.dtype == torch.int32
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=1e-5, atol=1e-5)
    got_l, want_l = got_l.numpy(), np.asarray(want_l)
    diff, tie = near_ties(pts, want_c, got_l, want_l, distance)
    print(f"{distance} seed {seed}: {diff.size} of {pts.shape[0]} labels differ, "
          f"all near-ties: {bool(tie.all())}")
    assert tie.all() and diff.size <= 3
    assert (got_l[~valid] == init.shape[0]).all()
    outliers = (got_l == init.shape[0]) & valid
    assert outliers.any() and (~outliers & valid).any()


def test_kmeans_batched_and_defaults():
    """Leading dimensions are images (the JAX decode vmaps); no ``valid``
    means all points; a centre seeded far from every point (an empty
    cluster: its centre becomes 0, then may gather points) as in JAX."""
    pts, init, _ = _points(5, n=300, k=6)
    far = init.copy()
    far[0] = 50.0                                          # no point comes near
    batch_p = np.stack([pts, pts[::-1].copy()])
    batch_i = np.stack([far, init])
    got_l, got_c = tk.kmeans(torch.from_numpy(batch_p), torch.from_numpy(batch_i), num_iters=4)
    for b in range(2):
        wl, wc = jk.kmeans(jnp.asarray(batch_p[b]), jnp.asarray(batch_i[b]), num_iters=4)
        np.testing.assert_allclose(got_c[b].numpy(), np.asarray(wc), rtol=1e-5, atol=1e-5)
        diff, tie = near_ties(batch_p[b], wc, got_l[b].numpy(), np.asarray(wl), "euclidean")
        assert tie.all()
    d = tk.pairwise_distance(torch.from_numpy(pts), torch.from_numpy(init))
    np.testing.assert_allclose(d.numpy(), np.asarray(jk.pairwise_distance(
        jnp.asarray(pts), jnp.asarray(init))), rtol=1e-6, atol=1e-7)


def _b0_outputs():
    """Eval outputs of a seeded EfficientSeg-B0 at 128x256 on a seeded
    frame batch, as numpy, with the class bias raised by 0.5."""
    model = EfficientSeg(EfficientSegConfig(num_classes=8, compound_coef=0))
    init_random(model, torch.Generator().manual_seed(3))
    with torch.no_grad():
        model.classifier.header.pointwise_conv.conv.bias += 0.5
        frames = np.random.default_rng(2).integers(0, 256, (2, 128, 256, 3), np.uint8)
        outputs = model(torch.from_numpy(frames))
    anchors = generate_anchors(128, 256, pyramid_levels=model.cfg.pyramid_levels,
                               anchor_scale=model.cfg.anchor_scale)
    return tuple(o.numpy() for o in outputs), anchors


@pytest.mark.parametrize("source", ["b0", "scene"])
def test_kmeans_decode_equals_jax(source):
    if source == "b0":
        outputs, anchors = _b0_outputs()
        cfg = dict(kp_th=2000)
        orig = (256, 512)
    else:
        outputs, anchors = torch_cases.synthetic_scene(128, 192)
        cfg = dict(kp_th=2000, pre_nms=64, max_dets=8, max_poly=512)
        orig = (256, 384)
    jcfg = jd.DecodeConfig(group_mode="kmeans", **cfg)
    want = jax.jit(lambda o, a: jd.decode_output(o, a, *orig, 2.0, jcfg))(
        tuple(map(jnp.asarray, outputs)), jnp.asarray(anchors))
    got = td.decode_output(tuple(map(torch.from_numpy, outputs)), torch.tensor(anchors),
                           *orig, 2.0, td.DecodeConfig(group_mode="kmeans", **cfg))
    assert_detections_match(got, want, angle_ties=True)
    assert int(got.obj_valid.sum()) >= 2
    affinity = td.decode_output(tuple(map(torch.from_numpy, outputs)), torch.tensor(anchors),
                                *orig, 2.0, td.DecodeConfig(**cfg))
    assert int(affinity.obj_valid.sum()) >= 1
    if source == "b0":             # the refinement moves keypoints between objects here
        assert not torch.equal(got.poly_len, affinity.poly_len)
