"""Port target generation (instance_segmentation_torch/ops/targets.py) against
the JAX package's ``generate_targets(..., dense_kp=False)`` on seeded numpy
labels: integer and bool fields and the boxes/centers bit for bit, normals
to rtol 1e-6."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from instance_segmentation_tpu.ops import targets as jt
import instance_segmentation_torch.ops.targets as tt

torch.set_num_threads(2)
H, W, M, P = 128, 512, 8, 64


def octagons(B, M, H, W, seed, n_real=5):
    """Octagons as in bench.py's train labels, scaled to (H, W); padding
    instances replicate a vertex and carry class -1."""
    rng = np.random.default_rng(seed)
    polys = np.zeros((B, M, 8, 2), np.float32)
    n_verts = np.zeros((B, M), np.int32)
    cls_ids = np.full((B, M), -1, np.int32)
    ang = np.linspace(0, 2 * np.pi, 9)[:-1]
    for b in range(B):
        for m in range(n_real):
            cy, cx = rng.uniform(0.16 * H, 0.84 * H), rng.uniform(0.12 * W, 0.88 * W)
            rh, rw = rng.uniform(0.04 * H, 0.14 * H), rng.uniform(0.03 * W, 0.1 * W)
            polys[b, m] = np.stack([cy + rh * np.sin(ang), cx + rw * np.cos(ang)], -1)
            n_verts[b, m] = 8
            cls_ids[b, m] = rng.integers(0, 8)
        polys[b, n_real:] = polys[b, 0, 0]
    return polys, n_verts, cls_ids


def integer_polygons(B, M, H, W, seed, V=12):
    """Random star-shaped polygons with integer vertices (as annotation tools
    give them): samples then fall exactly on pixel edges, where one rounding
    of ``v0 + d / md * k`` decides the pixel."""
    rng = np.random.default_rng(seed)
    cy = rng.uniform(20, H - 20, (B, M, 1))
    cx = rng.uniform(20, W - 20, (B, M, 1))
    ang = np.sort(rng.uniform(0, 2 * np.pi, (B, M, V)), -1)
    r = rng.uniform(5, 40, (B, M, V))
    polys = np.stack([np.round(cy + r * np.sin(ang)), np.round(cx + 2 * r * np.cos(ang))],
                     -1).astype(np.float32)
    return polys, np.full((B, M), V, np.int32), rng.integers(0, 8, (B, M)).astype(np.int32)


def border_and_empty(B, M, H, W):
    """Image 0: one instance mostly off the image (cols -500..60) and one
    inside; image 1: no labels."""
    polys = np.zeros((B, M, 8, 2), np.float32)
    n_verts = np.zeros((B, M), np.int32)
    cls_ids = np.full((B, M), -1, np.int32)
    polys[0, 0] = [[80, 60], [120, 60], [120, -500], [80, -500]] * 2
    polys[0, 1] = [[30, 100], [30, 180], [100, 180], [100, 100]] * 2
    n_verts[0, :2] = 4
    cls_ids[0, :2] = (2, 5)
    polys[0, 2:] = polys[0, 1, 0]
    return polys, n_verts, cls_ids


LABELS = {"octagons": lambda: octagons(2, M, H, W, seed=0),
          "integer_vertices": lambda: integer_polygons(4, 32, H, W, seed=3),
          "border_and_empty": lambda: border_and_empty(2, M, H, W)}


def jax_targets(polys, n_verts, cls_ids, max_points=P):
    fn = jax.jit(lambda p, n, c: jt.generate_targets(p, n, c, H, W, max_points=max_points,
                                                     dense_kp=False))
    return fn(*map(jnp.asarray, (polys, n_verts, cls_ids)))


def port_targets(polys, n_verts, cls_ids, max_points=P):
    return tt.generate_targets(*map(torch.from_numpy, (polys, n_verts, cls_ids)), H, W,
                               max_points=max_points, dense_kp=False)


def assert_targets_match(got, want):
    for name in ("points", "pt_valid", "inst_valid", "det_ann", "centers"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    np.testing.assert_allclose(got.normals.numpy(), np.asarray(want.normals), rtol=1e-6,
                               atol=1e-7)
    assert got.kp_tgt is None and want.kp_tgt is None


@pytest.mark.parametrize("labels", list(LABELS))
def test_targets_match_jax(labels):
    arrays = LABELS[labels]()
    got = port_targets(*arrays, max_points=256)
    assert_targets_match(got, jax_targets(*arrays, max_points=256))
    assert got.points.dtype == torch.int32 and got.pt_valid.dtype == torch.bool


def test_border_instance_keeps_its_in_image_samples():
    got = port_targets(*border_and_empty(2, M, H, W))
    assert int(got.pt_valid[0, 0].sum()) > 0
    assert not bool(got.pt_valid[1].any()) and not bool(got.inst_valid[1].any())
    assert bool((got.det_ann[1] == -1).all())


def test_sample_position_is_rounded_once(monkeypatch):
    """On integer vertices a sample lands on a pixel edge often enough that
    rounding ``d / md * k`` before adding ``v0`` moves one: the port rounds
    as the reference's fused multiply-add does, and matches (see above);
    separate float32 ops do not."""
    polys, n_verts, cls_ids = integer_polygons(4, 32, H, W, seed=3)
    fused = port_targets(polys, n_verts, cls_ids, max_points=256)
    monkeypatch.setattr(tt, "fma", lambda a, b, c: a * b + c)
    split = port_targets(polys, n_verts, cls_ids, max_points=256)
    moved = (fused.points != split.points).any(-1) & fused.pt_valid
    assert int(moved.sum()) >= 1


def test_dense_kp_is_not_ported():
    """Named when the dense kp map raised; it is ported: the map equals the
    JAX package's bit for bit, with ``dense_kp=True`` the default of both
    (the other fields as ``assert_targets_match`` holds them)."""
    arrays = octagons(2, M, H, W, 0)
    got = tt.generate_targets(*map(torch.from_numpy, arrays), H, W, max_points=P)
    want = jax.jit(lambda p, n, c: jt.generate_targets(p, n, c, H, W, max_points=P))(
        *map(jnp.asarray, arrays))
    assert got.kp_tgt.dtype == torch.float32
    np.testing.assert_array_equal(got.kp_tgt.numpy(), np.asarray(want.kp_tgt))
    assert float(got.kp_tgt.sum()) > 0
