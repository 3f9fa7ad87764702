"""Port decode (instance_segmentation_torch/ops/decode.py) against the JAX
decode on the same numpy inputs. Integer and boolean results must be
exactly equal (top-k indices, NMS order, peaks, assignments, polygon
lengths, validity); float results agree to 1e-5."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from instance_segmentation_tpu.losses.losses import coordinate_grid as j_coordinate_grid
from instance_segmentation_tpu.models.anchors import generate_anchors as j_generate_anchors
from instance_segmentation_tpu.ops import decode as jd
from instance_segmentation_tpu.ops.geometry import point_in_polygon as j_point_in_polygon
from instance_segmentation_torch.models import anchors as tanchors
from instance_segmentation_torch.models.anchors import generate_anchors
from instance_segmentation_torch.ops import decode as td
from instance_segmentation_torch.ops.geometry import point_in_polygon

import torch_cases

torch.set_num_threads(2)
FTOL = dict(rtol=1e-5, atol=1e-5)


def assert_detections_match(got: td.Detections, want: jd.Detections,
                            angle_ties: bool = False):
    """Integer/bool fields equal, float fields to 1e-5. With ``angle_ties``,
    polygon vertices that tie in polar angle around the internal point
    (lattice points on one ray from it, whose float angles differ only by
    the two libraries' atan2 rounding) may come in either order: each run
    of differing slots must hold the same vertices."""
    assert got._fields == want._fields
    for name in got._fields:
        g, w = getattr(got, name).cpu().numpy(), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if name == "polygons" and angle_ties:
            _assert_polygons_match_up_to_angle_ties(g, w)
        elif np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, err_msg=name, **FTOL)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


def _assert_polygons_match_up_to_angle_ties(got, want, max_run=8):
    differs = ~np.isclose(got, want, **FTOL).all(-1)                 # [B, D, Q]
    for b, d in zip(*np.nonzero(differs.any(-1))):
        q = np.nonzero(differs[b, d])[0]
        runs = np.split(q, np.nonzero(np.diff(q) > 1)[0] + 1)
        for run in runs:
            assert len(run) <= max_run, (b, d, run)
            g = got[b, d, run][np.lexsort(got[b, d, run].T)]
            w = want[b, d, run][np.lexsort(want[b, d, run].T)]
            np.testing.assert_allclose(g, w, err_msg=f"polygon {b},{d}", **FTOL)


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _random_boxes(seed, n=64):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 80, size=(n, 2))
    wh = rng.uniform(5, 30, size=(n, 2))
    boxes = np.concatenate([xy, xy + wh], axis=1).astype(np.float32)
    scores = rng.uniform(0.1, 1.0, size=n).astype(np.float32)
    order = np.argsort(-scores)
    return boxes[order], scores[order]


def test_coordinate_grid_matches_reference():
    np.testing.assert_array_equal(td.coordinate_grid(40, 70).numpy(),
                                  np.asarray(j_coordinate_grid(40, 70)))


@pytest.mark.parametrize("valid_rule", ["all", "partial"])
def test_leader_nms_matches_reference(valid_rule):
    boxes, scores = _random_boxes(2)
    valid = np.ones(len(boxes), bool) if valid_rule == "all" else scores > 0.5
    want = jax.jit(lambda b, v: jd.leader_nms(b, v, 0.3, 16))(boxes, valid)
    got = td.leader_nms(*_t(boxes, valid), 0.3, 16)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # batched: each row as on its own
    boxes2, _ = _random_boxes(3)
    batched = td.leader_nms(*_t(np.stack([boxes, boxes2]), np.stack([valid, valid])), 0.3, 16)
    single = td.leader_nms(*_t(boxes2, valid), 0.3, 16)
    assert torch.equal(batched[0][1], single[0]) and torch.equal(batched[1][1], single[1])


def _topk_rows():
    rng = np.random.default_rng(3)
    ties = rng.normal(size=(2, 4096)).astype(np.float32)
    ties[0, 100] = ties[0, 200] = 5.0
    n = 1024
    degenerate = np.stack([
        np.full(n, 3.25, np.float32),
        -np.abs(np.random.default_rng(0).normal(size=n)).astype(np.float32),
        np.linspace(-1e30, 1e30, n, dtype=np.float32),
        np.where(np.arange(n) % 7 == 0, np.float32(np.inf), np.float32(-np.inf)),
    ])
    return {"ties_k128": (ties, 128), "degenerate_k64": (degenerate, 64),
            "degenerate_kN": (degenerate, n), "ties_k_over_n": (ties[:, :100], 128)}


@pytest.mark.parametrize("case", list(_topk_rows()))
def test_exact_topk_indices_equal_reference(case):
    x, k = _topk_rows()[case]
    want_v, want_i = jax.jit(lambda a: jd.exact_topk_indices(a, k))(x)
    got_v, got_i = td.exact_topk_indices(*_t(x), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    assert bool((got_i[:, 1:] > got_i[:, :-1]).all())


def test_select_peaks_tie_band_scene_equals_reference():
    """The synthetic scene: ~320 outline pixels at 8.0 and a background of
    -8.0 ties inside the top-2000 band, taken in index order."""
    (kp, *_), _ = torch_cases.synthetic_scene()
    hm = kp[..., 0]
    want_i, want_ok = jax.jit(lambda h: jd.select_peaks_batch(h, 2000))(hm)
    got_i, got_ok = td.select_peaks_batch(*_t(hm), 2000)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(want_ok))
    assert 0 < int(got_ok.sum()) < 2000


def test_select_peaks_small_map_equals_reference():
    hm = np.zeros((1, 32, 48), np.float32)
    hm[0, 5, 7], hm[0, 5, 8], hm[0, 20, 30] = 3.0, 2.0, 4.0
    hm[0, 0, 0] = -1.0                     # a negative corner: zero-filled border
    want = jax.jit(lambda h: jd.select_peaks_batch(h, 16))(hm)
    got = td.select_peaks_batch(*_t(hm), 16)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    peaks = set(got[0][got[1]].tolist())
    assert {5 * 48 + 7, 20 * 48 + 30} <= peaks and 5 * 48 + 8 not in peaks


def _random_heads(seed, h=128, w=256, num_classes=3):
    anchors = j_generate_anchors(h, w)
    rng = np.random.default_rng(seed)
    a = anchors.shape[0]
    reg = rng.normal(0.0, 0.3, (2, a, 4)).astype(np.float32)
    cls = (1.0 / (1.0 + np.exp(-rng.normal(-2.0, 1.5, (2, a, num_classes))))).astype(np.float32)
    return anchors, reg, cls


def _bbox_float64(anchors, reg, h, w):
    """``bbox_transform`` in float64 numpy, the arbiter when the two sides
    differ."""
    a, r = anchors.astype(np.float64), reg.astype(np.float64)
    ha, wa = a[:, 2] - a[:, 0], a[:, 3] - a[:, 1]
    yc, xc = r[..., 0] * ha + (a[:, 0] + a[:, 2]) / 2, r[..., 1] * wa + (a[:, 1] + a[:, 3]) / 2
    hb, wb = np.exp(r[..., 2]) * ha, np.exp(r[..., 3]) * wa
    return np.stack([np.maximum(xc - wb / 2, 0), np.maximum(yc - hb / 2, 0),
                     np.minimum(xc + wb / 2, w - 1), np.minimum(yc + hb / 2, h - 1)], -1)


def test_bbox_transform_matches_reference():
    """Bit-exact wherever the two libraries' float32 ``exp`` agree (the
    reference's fused multiply-add for the box centres is reproduced);
    elsewhere within what an ulp of ``exp`` moves. On a mismatch the
    message says which side left the float64 result and whether the
    cached anchors still equal a fresh computation (ROADMAP Queue 3: this
    test has failed twice in whole runs, never alone)."""
    anchors, reg, _ = _random_heads(4)
    want = np.asarray(jax.jit(lambda a, r: jd.bbox_transform(a, r, 128, 256))(anchors, reg))
    got = td.bbox_transform(*_t(anchors, reg), 128, 256).numpy()
    exact = _bbox_float64(anchors, reg, 128, 256)
    fresh = tanchors._generate.__wrapped__(128, 256, (3, 4, 5, 6, 7), 4.0,
                                           tanchors.DEFAULT_SCALES, tanchors.DEFAULT_RATIOS)
    why = (f"max|port - f64| {np.abs(got - exact).max():.3g}, max|jax - f64| "
           f"{np.abs(want - exact).max():.3g}; cached anchors equal a fresh copy: "
           f"{np.array_equal(anchors, fresh)}")
    # an ulp of exp moves an edge by an ulp of the box extent (<= 3.1e-5 here)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4, err_msg=why)
    j_exp = np.asarray(jax.jit(jnp.exp)(reg[..., 2:]))
    same_exp = (torch.exp(torch.from_numpy(reg[..., 2:])).numpy() == j_exp).all(-1)
    assert same_exp.mean() > 0.5
    np.testing.assert_array_equal(got[same_exp], want[same_exp])


def test_decode_boxes_matches_reference():
    anchors, reg, cls = _random_heads(5)
    cfg = jd.DecodeConfig()
    want = jax.jit(lambda c, r, a: jd.decode_boxes(c, r, a, 128, 256, cfg))(cls, reg, anchors)
    got = td.decode_boxes(*_t(cls, reg, anchors), 128, 256, td.DecodeConfig())
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == w.dtype
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-4)
        else:
            np.testing.assert_array_equal(g, w)
    assert int(got[3].sum()) > 0


def test_point_in_polygon_matches_reference_on_edges():
    """Points placed on polygon edges, where the crossing test turns on the
    rounding of the edge intersection."""
    rng = np.random.default_rng(6)
    poly = rng.uniform(0, 100, (7, 2)).astype(np.float32)
    ay, ax = poly[:, 0], poly[:, 1]
    by, bx = np.roll(ay, -1), np.roll(ax, -1)
    pts = []
    for i in range(len(poly)):
        t = rng.uniform(0, 1, 300).astype(np.float32)
        pts.append(np.stack([ay[i] + t * (by[i] - ay[i]), ax[i] + t * (bx[i] - ax[i])], -1))
    pts.append(rng.uniform(0, 100, (500, 2)))
    pts = np.concatenate(pts).astype(np.float32)
    want = jax.jit(j_point_in_polygon)(pts, poly)
    got = point_in_polygon(*_t(pts, poly))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_assemble_objects_matches_reference():
    """The reference's long-run case: a 300-member ring truncated to a
    200-vertex budget, its run starting mid-block after 131 members of
    another object."""
    K, Q = 512, 200
    kp_rc = np.zeros((1, K, 2), np.float32)
    assign = np.zeros((1, K), np.int32)
    valid = np.zeros((1, K), bool)
    for i in range(131):
        kp_rc[0, i] = (i // 16, 16 + i % 16)
        assign[0, i], valid[0, i] = 1, True
    ang = np.linspace(0, 2 * np.pi, 301)[:-1]
    ring = np.round(np.stack([120 + 60 * np.sin(ang), 120 + 60 * np.cos(ang)], -1))
    ring = ring[np.sort(np.unique(ring, axis=0, return_index=True)[1])]   # unique pixels
    kp_rc[0, 131:131 + len(ring)] = ring
    valid[0, 131:131 + len(ring)] = True
    boxes = np.array([[[40, 40, 200, 200], [0, 0, 64, 64]]], np.float32)
    det_valid = np.array([[True, True]])
    want = jax.jit(lambda *a: jd.assemble_objects(
        *a, 256, 256, 512, 512, 2.0, jd.DecodeConfig(max_poly=Q)))(
        kp_rc, valid, assign, boxes, det_valid)
    got = td.assemble_objects(*_t(kp_rc, valid, assign, boxes, det_valid),
                              256, 256, 512, 512, 2.0, td.DecodeConfig(max_poly=Q))
    for name, g, w in zip(("polygons", "poly_len", "centers", "obj_valid"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert got[1].tolist() == [[Q, 131]]


def _u_shape(q=64):
    u = np.array([[0, 0], [10, 0], [10, 10], [7, 10], [7, 3],
                  [3, 3], [3, 10], [0, 10]], np.float32)
    dense = [u[i] + t * (u[(i + 1) % len(u)] - u[i])
             for i in range(len(u)) for t in np.linspace(0.0, 1.0, 6, endpoint=False)]
    pts = np.asarray(dense, np.float32)
    return np.concatenate([pts, np.repeat(pts[:1], q - len(pts), 0)], 0), len(pts)


def test_internal_point_concave_fallback_matches_reference():
    """Box center and member mean both in the concavity of a U: the pair
    midpoint fallback finds an interior point, the same one as the reference."""
    padded, n = _u_shape()
    default = np.array([5.0, 6.0], np.float32)
    want = jax.jit(lambda p, k, d: jd._find_internal_point(p, k, d, 12))(
        padded, np.int32(n), default)
    got = td._find_internal_point(*_t(padded[None], np.array([n]), default[None]), 12)[0]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert bool(point_in_polygon(got[None], torch.from_numpy(padded))[0])
    assert not bool(point_in_polygon(torch.from_numpy(default[None]),
                                     torch.from_numpy(padded))[0])


def test_internal_point_degenerate_returns_default():
    padded = np.full((1, 32, 2), 7.0, np.float32)
    got = td._find_internal_point(*_t(padded, np.array([1]), np.array([[3.0, 4.0]],
                                                                     np.float32)), 12)
    np.testing.assert_array_equal(got.numpy(), [[3.0, 4.0]])


def test_synthetic_scene_is_the_reference_scene():
    from test_decode import _synthetic_scene
    (kp, ae, tan, _, _), anchors = torch_cases.synthetic_scene(128, 192)
    want_kp, want_ae, want_tan, _ = _synthetic_scene(128, 192)
    np.testing.assert_array_equal(kp, want_kp)
    np.testing.assert_array_equal(ae, want_ae)
    np.testing.assert_array_equal(tan, want_tan)
    np.testing.assert_array_equal(anchors, j_generate_anchors(128, 192, pyramid_levels=(3, 4, 5)))


@pytest.mark.parametrize("margin", [0.0, 0.5], ids=["edges_on_pixels", "half_pixel_margin"])
def test_decode_output_synthetic_scene_equals_reference(margin):
    outputs, anchors = torch_cases.synthetic_scene(128, 192, margin=margin)
    cfg = jd.DecodeConfig(kp_th=2000, pre_nms=64, max_dets=8, max_poly=512)
    want = jax.jit(lambda o, a: jd.decode_output(o, a, 256, 384, 2.0, cfg))(
        tuple(map(jnp.asarray, outputs)), jnp.asarray(anchors))
    got = td.decode_output(_t(*outputs), torch.tensor(anchors), 256, 384, 2.0,
                           torch_cases.SCENE_DECODE)
    assert_detections_match(got, want)
    assert int(got.obj_valid.sum()) == 2
    assert set(got.classes[got.obj_valid].tolist()) == {0, 1}
    assert all(n > 50 for n in got.poly_len[got.obj_valid].tolist())


def test_unported_modes_raise():
    """A grouping mode that is neither "affinity" nor "kmeans" raises
    (kmeans, once listed here, is ported: tests/test_torch_kmeans.py; so is
    ``exact_topk=False``: the value-ordered top-k tests below)."""
    outputs, anchors = torch_cases.synthetic_scene()
    with pytest.raises(ValueError, match="group_mode"):
        td.decode_output(_t(*outputs), torch.tensor(anchors), 256, 384, 2.0,
                         td.DecodeConfig(kp_th=2000, group_mode="spectral"))


def _value_topk_maps():
    """[B, H, W] maps and k for the value-ordered top-k."""
    rng = np.random.default_rng(12)
    random = rng.normal(size=(2, 64, 96)).astype(np.float32)
    # few distinct values: ties inside the top k and across the k-th place,
    # signed zeros among them
    ties = (rng.integers(0, 5, size=(2, 64, 96)) * 0.5).astype(np.float32)
    ties[0, 3, 4], ties[1, 60, 90] = -0.0, 0.0
    special = rng.normal(size=(2, 40, 50)).astype(np.float32)
    special[0, 1, 1] = special[1, 7, 7] = np.nan
    special[0, 2, 2], special[1, 3, 3] = np.inf, -np.inf
    # at k = H*W XLA's fallback sorts the whole row without keeping ties in
    # index order (the k = H*W tie case below holds what it does keep)
    return {"random_k500": (random, 500), "ties_k2000": (ties, 2000),
            "random_k_hw": (random, 64 * 96), "random_k_over_hw": (random[:, :8, :8], 100),
            "nan_inf_k300": (special, 300)}


@pytest.mark.parametrize("case", list(_value_topk_maps()))
def test_value_topk_select_peaks_equal_reference(case):
    """``select_peaks_batch(exact=False)`` against the JAX decode's jitted
    ``approx_max_k`` branch, which XLA lowers off the TPU to an exact top-k
    in value order: indices and peak flags bitwise."""
    hm, k = _value_topk_maps()[case]
    want_i, want_ok = jax.jit(lambda h: jd.select_peaks_batch(h, k, exact=False))(hm)
    got_i, got_ok = td.select_peaks_batch(*_t(hm), k, exact=False)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(want_ok))
    want_v, _ = jax.jit(lambda a: jax.lax.top_k(a, min(k, a.shape[1])))(
        hm.reshape(hm.shape[0], -1))
    got_v, _ = td.value_topk_indices(*_t(hm.reshape(hm.shape[0], -1)), k)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def test_value_topk_ties_at_k_hw_match_reference_up_to_tie_order():
    """k = H*W on a map of five values: the same values in the same order and,
    within each run of equal values, the same indices as JAX's branch (which
    there orders a run's indices as its sort leaves them, and takes -0.0 and
    0.0 as equal); peaks bitwise once the runs are in index order."""
    hm = np.abs(_value_topk_maps()["ties_k2000"][0])     # its sort takes -0.0 == 0.0
    k = hm.shape[1] * hm.shape[2]
    want_i, want_ok = (np.asarray(a) for a in jax.jit(
        lambda h: jd.select_peaks_batch(h, k, exact=False))(hm))
    got_i, got_ok = (a.numpy() for a in td.select_peaks_batch(*_t(hm), k, exact=False))
    flat = hm.reshape(hm.shape[0], -1)
    for b in range(hm.shape[0]):
        vals = flat[b, got_i[b]]
        np.testing.assert_array_equal(vals, flat[b, want_i[b]])
        assert (np.diff(vals) <= 0).all()
        runs = np.split(np.arange(k), np.nonzero(np.diff(vals))[0] + 1)
        for run in runs:
            assert (np.diff(got_i[b, run]) > 0).all()
            np.testing.assert_array_equal(got_i[b, run], np.sort(want_i[b, run]))
        order = np.argsort(want_i[b])
        np.testing.assert_array_equal(got_ok[b][np.argsort(got_i[b])], want_ok[b][order])


def test_value_topk_ties_take_the_lower_index():
    """Ties at the k-th place keep the lower indices, and tied values come
    in index order: the rule, on a map of one value."""
    flat = torch.zeros(1, 50)
    flat[0, [7, 3, 40]] = torch.tensor([2.0, 1.0, 1.0])
    v, i = td.value_topk_indices(flat, 6)
    assert i[0].tolist() == [7, 3, 40, 0, 1, 2]
    assert v[0].tolist() == [2.0, 1.0, 1.0, 0.0, 0.0, 0.0]


def test_decode_output_value_topk_synthetic_scene_equals_reference():
    """The synthetic scene (a -8.0 background tied across the k-th place) with
    ``exact_topk=False``: the whole decode against JAX's."""
    outputs, anchors = torch_cases.synthetic_scene(128, 192, margin=0.5)
    cfg = jd.DecodeConfig(kp_th=2000, pre_nms=64, max_dets=8, max_poly=512, exact_topk=False)
    want = jax.jit(lambda o, a: jd.decode_output(o, a, 256, 384, 2.0, cfg))(
        tuple(map(jnp.asarray, outputs)), jnp.asarray(anchors))
    got = td.decode_output(_t(*outputs), torch.tensor(anchors), 256, 384, 2.0,
                           td.DecodeConfig(kp_th=2000, pre_nms=64, max_dets=8, max_poly=512,
                                           exact_topk=False))
    assert_detections_match(got, want)
    assert int(got.obj_valid.sum()) == 2


@pytest.fixture(scope="module")
def value_topk_slice():
    """The B0 slice of tests/test_torch_slice.py (128x256, JAX-converted
    weights, kp_th 2000) decoded with ``exact_topk=False``."""
    from test_torch_slice import make_slice_case
    return make_slice_case(exact_topk=False)


def test_decode_output_value_topk_b0_matches_jax(value_topk_slice):
    """The port's decode of the JAX forward's head maps against JAX's jitted
    decode, both with the value-ordered top-k, under test_torch_slice.py's
    rules (vertices tied in polar angle may swap)."""
    _, outputs, dets, pred = value_topk_slice
    got = td.decode_output(tuple(torch.from_numpy(o) for o in outputs), pred.anchors,
                           256, 512, 2.0, pred.decode_cfg)
    assert_detections_match(got, dets, angle_ties=True)
    assert int(got.det_valid.sum()) > 0 and int(got.obj_valid.sum()) > 0


def test_forward_and_decode_value_topk_b0_matches_jax(value_topk_slice):
    """``forward_and_decode`` (through the Predictor) with the value-ordered
    top-k: equal to the port's decode of the port's own head maps, and, as
    test_torch_slice.py holds a Predictor (its model within 2e-4 of JAX's),
    with JAX's jitted forward + decode's detections per image."""
    frames, _, dets, pred = value_topk_slice
    got = pred.predict(frames)
    with torch.no_grad():
        heads = pred.model(torch.from_numpy(frames))
    again = td.decode_output(heads, pred.anchors, 256, 512, 2.0, pred.decode_cfg)
    for name, g, a in zip(got._fields, got, again):
        assert torch.equal(g, a), name
    np.testing.assert_array_equal(got.det_valid.sum(1).numpy(),
                                  np.asarray(dets.det_valid).sum(1))
    exact = td.forward_and_decode(pred.model, torch.from_numpy(frames), pred.anchors,
                                  256, 512, 2.0, td.DecodeConfig(kp_th=2000))
    assert torch.equal(exact.det_valid, got.det_valid)


def test_decode_config_and_anchors_match_reference():
    assert td.DecodeConfig().__dict__ == jd.DecodeConfig().__dict__
    for args in ((128, 256), (512, 1024), (64, 96, (3, 4, 5), 5.0)):
        np.testing.assert_array_equal(generate_anchors(*args), j_generate_anchors(*args))
