"""The port's OpenCV-free image pieces against OpenCV and the JAX package:
``utils/image.poly_to_mask`` equals ``cv2.fillPoly`` bit for bit on 2500
seeded int32 polygons (convex, concave, self-intersecting, collinear or
degenerate, partly or wholly outside the frame); ``transforms.Resize``
equals ``cv2.resize(INTER_LINEAR)`` bit for bit for target sizes 1, 2 and 4
on even and odd frames; ``utils/visualize.visualize_instances`` equals the
JAX one (``cv2.fillPoly`` + ``cv2.addWeighted``) bit for bit; and
``get_affine_transform`` equals cv2's within 1e-6."""

import cv2
import numpy as np
import pytest

from instance_segmentation_tpu.transforms import augment as jaug
from instance_segmentation_tpu.utils import image as jimage
from instance_segmentation_tpu.utils import visualize as jvis
from instance_segmentation_torch.transforms import augment as taug
from instance_segmentation_torch.utils import image as timage
from instance_segmentation_torch.utils import visualize as tvis

KINDS = ("inside", "star", "partly_outside", "collinear", "far_outside")
PER_KIND = 500


def _polygon(rng, kind, h, w):
    n = int(rng.integers(1, 14))
    if kind == "inside":            # random vertices: concave, self-intersecting
        pts = np.stack([rng.integers(0, w, n), rng.integers(0, h, n)], 1)
    elif kind == "star":            # sorted angles: convex or star-shaped
        ang = np.sort(rng.uniform(0, 2 * np.pi, n))
        r = rng.uniform(2, 30, n)
        pts = np.stack([w / 2 + r * np.cos(ang), h / 2 + r * np.sin(ang)], 1)
    elif kind == "partly_outside":
        pts = np.stack([rng.integers(-20, w + 20, n), rng.integers(-20, h + 20, n)], 1)
    elif kind == "collinear":       # points on one line, repeated vertices
        t = rng.integers(-5, 40, n)
        pts = np.stack([t * int(rng.integers(-2, 3)) + 5, t * int(rng.integers(-2, 3)) + 5], 1)
    else:
        pts = np.stack([rng.integers(-500, 500, n), rng.integers(-500, 500, n)], 1)
    return pts.astype(np.int32)


@pytest.mark.parametrize("kind", KINDS)
def test_poly_to_mask_equals_cv2_fill_poly(kind):
    rng = np.random.default_rng(KINDS.index(kind))
    differing = []
    for i in range(PER_KIND):
        h, w = int(rng.integers(5, 60)), int(rng.integers(5, 60))
        poly = _polygon(rng, kind, h, w)
        want = cv2.fillPoly(np.zeros((h, w), np.int32), [poly], 1)
        got = timage.poly_to_mask(poly, (h, w))
        if not np.array_equal(got, want):
            differing.append((i, int((got != want).sum()), poly.tolist()))
    assert not differing, f"{len(differing)} of {PER_KIND} differ, e.g. {differing[:3]}"


def test_poly_to_mask_on_float_polygons_and_colour_images():
    """Float vertices are truncated as the reference's astype(int32); a
    colour fill writes the colour to every channel."""
    rng = np.random.default_rng(9)
    for _ in range(50):
        poly = rng.uniform(-30, 130, (int(rng.integers(3, 30)), 2)).astype(np.float32)
        np.testing.assert_array_equal(timage.poly_to_mask(poly, (100, 120)),
                                      jimage.poly_to_mask(poly, (100, 120)))
        img = rng.integers(0, 256, (100, 120, 3), dtype=np.uint8)
        pts = poly.astype(np.int32)
        np.testing.assert_array_equal(timage.fill_poly(img.copy(), pts, (7, 8, 9)),
                                      cv2.fillPoly(img.copy(), [pts], (7, 8, 9)))
    a, b = _sq(10, 10, 60, 60), _sq(30, 30, 90, 80)
    assert timage.compute_iou_for_poly(a, b) == jimage.compute_iou_for_poly(a, b)
    ma, mb = timage.poly_to_mask(a, (100, 100)), timage.poly_to_mask(b, (100, 100))
    assert timage.is_cover(ma, ma | mb) and not timage.is_cover(ma, mb)


def _sq(x0, y0, x1, y1):
    return np.array([[x0, y0], [x1, y0], [x1, y1], [x0, y1]], np.float32)


@pytest.mark.parametrize("target_size", [1, 2, 4])
@pytest.mark.parametrize("hw", [(64, 128), (66, 130), (65, 129), (63, 127), (33, 77),
                                (256, 512), (257, 513)])
def test_resize_equals_cv2(target_size, hw):
    rng = np.random.default_rng(hash((target_size,) + hw) % 2 ** 32)
    for shape in (hw + (3,), hw):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        label = ([0], [np.array([[1, 2], [30, 5], [12, 40]], np.float32)])
        got, got_label = taug.Resize(target_size)(None, img, label)
        want, want_label = jaug.Resize(target_size)(None, img, label)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got_label[1][0], want_label[1][0])


def test_resize_linear_on_random_sizes():
    rng = np.random.default_rng(4)
    for _ in range(150):
        h, w = int(rng.integers(1, 70)), int(rng.integers(1, 70))
        nh, nw = int(rng.integers(1, 70)), int(rng.integers(1, 70))
        img = rng.integers(0, 256, (h, w, int(rng.choice([1, 3, 4]))), dtype=np.uint8)
        want = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR).reshape(nh, nw, -1)
        np.testing.assert_array_equal(taug.resize_linear(img, nw, nh).reshape(nh, nw, -1),
                                      want, err_msg=str((h, w, nh, nw)))


@pytest.mark.parametrize("alpha", [0.5, 0.3, 0.77])
def test_visualize_instances_equals_jax(alpha):
    rng = np.random.default_rng(int(alpha * 100))
    img = rng.integers(0, 256, (96, 128, 3), dtype=np.uint8)
    polys = [rng.uniform(-10, 140, (int(rng.integers(3, 20)), 2)).astype(np.float32)
             for _ in range(14)]
    want = jvis.visualize_instances(img, polys, alpha=alpha)
    np.testing.assert_array_equal(tvis.visualize_instances(img, polys, alpha=alpha), want)
    for g in (0.0, 3.7):
        np.testing.assert_array_equal(tvis.add_weighted(img, alpha, want, 1 - alpha, g),
                                      cv2.addWeighted(img, alpha, want, 1 - alpha, g))
    centers, sizes = rng.uniform(-10, 140, (12, 2)), rng.uniform(1, 60, (12, 2))
    np.testing.assert_array_equal(tvis.visualize_boxes(img.copy(), centers, sizes),
                                  jvis.visualize_boxes(img.copy(), centers, sizes))


@pytest.mark.parametrize("inv", [False, True])
def test_affine_transform_equals_cv2(inv):
    for in_size, out_size in (((1024, 2048), (512, 1024)), ((257, 513), (128, 256)),
                              ((2, 3), (7, 5)), ((100, 1), (50, 1))):
        want = jimage.get_affine_transform(in_size, out_size, inv=inv)
        got = timage.get_affine_transform(in_size, out_size, inv=inv)
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
        pts = np.random.default_rng(0).uniform(-5, 600, (20, 2))
        np.testing.assert_array_equal(
            timage.apply_affine_transform(pts, got, (out_size[1], out_size[0])),
            jimage.apply_affine_transform(pts, got, (out_size[1], out_size[0])))


def test_detransform_and_scale_affine_equal_jax():
    cfg = {"val_trans": {"trans_seq": ["resize"], "resize": {"target_size": 2}}}
    from instance_segmentation_tpu.configs import Configer as JC
    from instance_segmentation_torch.configs import Configer as TC
    pix = np.random.default_rng(1).uniform(0, 300, (50, 2))
    for size in ((257, 513), (1024, 2048)):
        info = taug.TransInfo("x.png", size)
        np.testing.assert_array_equal(
            taug.CommonTransforms(TC(cfg), "val").detransform_pixel(pix, info),
            jaug.CommonTransforms(JC(cfg), "val").detransform_pixel(pix, info))


def test_train_ops_raise_not_implemented():
    """The name is kept from when the train ops raised NotImplementedError:
    now every train op and ``shuffle_trans_seq`` build (as the JAX
    package's ops), and an unknown op name still raises KeyError."""
    from instance_segmentation_torch.configs import Configer
    cfg = Configer({"train_trans": {"trans_seq": ["resize", "random_hflip"],
                                    "resize": {"target_size": 2},
                                    "shuffle_trans_seq": ["random_hue", "random_perm"]}})
    pipeline = taug.CommonTransforms(cfg, "train")
    assert [type(op).__name__ for op in pipeline.ops] == ["Resize", "RandomHFlip"]
    assert sorted(pipeline._shuffle_ops) == ["random_hue", "random_perm"]
    assert sorted(taug._OP_BUILDERS) == sorted(jaug._OP_BUILDERS)
    with pytest.raises(KeyError):
        taug.CommonTransforms(Configer({"val_trans": {"trans_seq": ["nope"]}}), "val")
    with pytest.raises(KeyError):
        taug.CommonTransforms(Configer({"train_trans": {"shuffle_trans_seq": ["nope"]}}),
                              "train")
