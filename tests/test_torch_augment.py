"""The port's train augmentations (``transforms/augment.py``) and their
OpenCV-free image pieces (``utils/image.py``) against the JAX package and
OpenCV:

* every op against the JAX op of the same config on seeded frames and
  polygons, 50 draws each, both given ``np.random.default_rng(s)``: frames
  and labels bit for bit, and the two generators' next draw equal (so the
  port draws what JAX draws, in its order);
* ``filter_bounds``, ``transform_label`` and ``crop_label`` on polygons that
  run along each border and through the corners;
* ``warp_affine_linear`` (the C helper) and ``warp_affine_linear_numpy``
  against ``cv2.warpAffine(INTER_LINEAR, BORDER_CONSTANT)`` bit for bit on
  240 seeded cases (scales up and down, rotations to 15 degrees either way,
  three border values, odd sizes, 1 and 3 channels), and
  ``rotation_matrix_2d`` against ``cv2.getRotationMatrix2D`` exactly;
* ``rgb_to_hsv_f32`` and ``hsv_to_rgb_f32`` against ``cv2.cvtColor`` bit for
  bit (float32 results compared as bits), on the ops' inputs and on
  arbitrary floats, at widths that do and do not fill OpenCV's vector steps;
* ``shuffle_trans_seq``, flat and nested, and ``CommonTransforms("train")``
  on the default config and on chip_smoke.py's every-op config, against the
  JAX pipeline over 20 frames.
No tolerance is needed anywhere: everything is compared bit for bit.
"""

import cv2
import numpy as np
import pytest

from instance_segmentation_tpu.configs import Configer as JConfiger
from instance_segmentation_tpu.transforms import augment as jaug
from instance_segmentation_torch.configs import Configer as TConfiger
from instance_segmentation_torch.configs import load_trans_config
from instance_segmentation_torch.transforms import augment as taug
from instance_segmentation_torch.utils import image as timage

DRAWS = 50

# (op name, its config): the JAX package's defaults and the branches of each op
OP_CASES = {
    "resize": ("resize", {"target_size": 2}),
    "hflip": ("random_hflip", {"ratio": 0.5, "swap_pair": []}),
    "brightness": ("random_brightness", {"ratio": 1.0, "shift_value": 10}),
    "brightness_default": ("random_brightness", {}),
    "contrast": ("random_contrast", {}),
    "saturation": ("random_saturation", {"ratio": 0.7}),
    "hue": ("random_hue", {"ratio": 0.7}),
    "perm": ("random_perm", {"ratio": 0.8}),
    "padding": ("padding", {"ratio": 0.6, "pad": [3, 5, 2, 7]}),
    "resize_random": ("random_resize", {"ratio": 0.8, "scale_range": [0.6, 1.4]}),
    "resize_target": ("random_resize", {"ratio": 0.6, "target_size": [70, 45],
                                        "aspect_range": [0.8, 1.2]}),
    "resize_bound": ("random_resize", {"ratio": 0.7, "method": "bound",
                                       "resize_bound": [40, 90]}),
    "resize_list": ("random_resize", {"ratio": 0.7, "scale_list": [0.5, 0.75, 1.5],
                                      "max_side_bound": 90}),
    "rotate": ("random_rotate", {"ratio": 0.7, "rotate_degree": 15}),
    "rotate_default": ("random_rotate", {}),
    "crop_random": ("random_crop", {"ratio": 0.8, "crop_size": [40, 30]}),
    "crop_center": ("random_crop", {"ratio": 0.8, "crop_size": [50, 200],
                                    "method": "center"}),
    "crop_grid": ("random_crop", {"ratio": 1.0, "crop_size": [32, 24], "method": "grid",
                                  "grid": [3, 2]}),
}

# chip_smoke.py phase 14(b)'s config, cut to 128x256 frames
EVERY_OP = {
    "train_trans": {
        "shuffle_trans_seq": ["random_hflip", "random_brightness", "random_contrast",
                              "random_saturation", "random_hue", "random_perm"],
        "trans_seq": ["resize", "random_resize", "random_rotate", "random_crop"],
        "resize": {"target_size": 2},
        "random_resize": {"scale_range": [1.1, 1.25], "aspect_range": [0.95, 1.05]},
        "random_rotate": {"rotate_degree": 5},
        "random_crop": {"ratio": 1.0, "crop_size": [128, 64]},
    },
    "val_trans": {"trans_seq": ["resize"], "resize": {"target_size": 2}},
}


def _frame(rng, h=None, w=None):
    h = h or int(rng.integers(20, 70))
    w = w or int(rng.integers(20, 100))
    return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)


def _label(rng, h, w, n=None):
    """(cls_ids, int32 (x, y) polygons): inside, crossing and along the
    borders of an h x w frame."""
    n = int(rng.integers(0, 6)) if n is None else n
    polys = []
    for i in range(n):
        k = int(rng.integers(3, 12))
        if i % 3 == 2:          # clipped onto the frame: runs along borders
            p = np.stack([rng.integers(-10, w + 10, k), rng.integers(-10, h + 10, k)], 1)
            p = np.stack([p[:, 0].clip(0, w - 1), p[:, 1].clip(0, h - 1)], 1)
        else:
            p = np.stack([rng.integers(0, w, k), rng.integers(0, h, k)], 1)
        polys.append(p.astype(np.int32))
    return [int(c) for c in rng.integers(0, 8, n)], polys


def _assert_labels_equal(got, want):
    assert (got is None) == (want is None)
    if got is None:
        return
    assert list(got[0]) == list(want[0])
    assert len(got[1]) == len(want[1])
    for a, b in zip(got[1], want[1]):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", list(OP_CASES))
def test_op_equals_jax_draw_for_draw(case):
    name, cfg = OP_CASES[case]
    j_op = jaug._OP_BUILDERS[name](dict(cfg))
    t_op = taug._OP_BUILDERS[name](dict(cfg))
    assert type(t_op).__name__ == type(j_op).__name__
    data = np.random.default_rng(list(OP_CASES).index(case))
    applied = 0
    for s in range(DRAWS):
        img = _frame(data)
        label = _label(data, *img.shape[:2]) if s % 5 else None
        j_rng, t_rng = np.random.default_rng(s), np.random.default_rng(s)
        j_img, j_label = j_op(j_rng, img.copy(), label)
        t_img, t_label = t_op(t_rng, img.copy(), label)
        assert t_img.dtype == j_img.dtype and t_img.shape == j_img.shape, (s, t_img.shape)
        np.testing.assert_array_equal(t_img, j_img, err_msg=f"draw {s}")
        _assert_labels_equal(t_label, j_label)
        assert t_rng.random() == j_rng.random(), f"draw {s}: the generators parted"
        applied += not np.array_equal(j_img, img) if j_img.shape == img.shape else 1
    assert applied > 0, "the op never changed a frame"


def test_every_op_name_builds_and_an_unknown_name_raises():
    assert sorted(taug._OP_BUILDERS) == sorted(jaug._OP_BUILDERS)
    cfg = TConfiger({"train_trans": {"trans_seq": sorted(taug._OP_BUILDERS),
                                     "resize": {"target_size": 2}}})
    ops = taug.build_augmentations(cfg, "train")
    assert [type(o).__name__ for o in ops] == \
        [type(o).__name__ for o in jaug.build_augmentations(JConfiger(cfg.to_dict()), "train")]
    with pytest.raises(KeyError, match="nope"):
        taug.CommonTransforms(TConfiger({"train_trans": {"trans_seq": ["nope"]}}), "train")


# ---- polygon bookkeeping ---------------------------------------------------------------

def _border_polygons(w, h):
    """Polygons along each border, through the corners, wholly on the border
    (touching all four or fewer) and with interior points."""
    r, b = w - 1, h - 1
    return [
        [[0, 5], [0, 9], [0, 14], [6, 10], [0, 3]],              # left run, one inside
        [[3, 0], [8, 0], [12, 0], [9, 7]],                       # top run
        [[r, 2], [r, 6], [r, 9], [r - 4, 5]],                    # right run
        [[2, b], [7, b], [11, b], [5, b - 3]],                   # bottom run
        [[0, 0], [r, 0], [r, b], [0, b]],                        # the four corners
        [[0, 0], [0, 5], [0, b], [6, b], [r, b], [r, 3], [r, 0], [4, 0]],  # all borders
        [[0, 0], [0, 8], [0, b]],                                # one border only: dropped
        [[0, 0], [5, 0], [0, 5]],                                # two borders only: dropped
        [[0, 4], [0, 4], [3, 3], [3, 3], [0, 6]],                # repeated vertices
        [[r, b], [r, b - 1], [r - 1, b], [r - 2, b - 2]],        # bottom-right corner
        [[1, 1], [2, 5], [7, 3]],                                # inside only
    ]


@pytest.mark.parametrize("size", [(16, 12), (25, 17)])
def test_filter_bounds_equals_jax_on_border_and_corner_polygons(size):
    w, h = size
    for poly in _border_polygons(w, h):
        for dtype in (np.int32, np.float32):
            p = np.asarray(poly, dtype)
            gk, gp = taug.filter_bounds(p, size)
            wk, wp = jaug.filter_bounds(p, size)
            assert gk == wk, poly
            assert gp.dtype == wp.dtype
            np.testing.assert_array_equal(gp, wp)
    keep, run = taug.filter_bounds(np.asarray(_border_polygons(w, h)[0]), size)
    assert keep and run.tolist() == [[0, 5], [0, 14], [6, 10], [0, 3]]
    assert not taug.filter_bounds(np.asarray(_border_polygons(w, h)[6]), size)[0]
    assert taug.filter_bounds(np.asarray(_border_polygons(w, h)[5]), size)[0]


def test_transform_and_crop_label_equal_jax_on_border_polygons():
    rng = np.random.default_rng(3)
    w, h = 40, 30
    polys = [np.asarray(p, np.int32) for p in _border_polygons(w, h)]
    label = (list(range(len(polys))), polys)
    mats = [np.array([[1.3, 0, 0], [0, 0.7, 0]]), np.array([[0.5, 0, 0], [0, 0.5, 0]]),
            timage.rotation_matrix_2d((w / 2, h / 2), 12.0, 1.0),
            timage.rotation_matrix_2d((w / 2, h / 2), -7.0, 1.1)]
    for mat in mats:
        size = (int(w * 1.2), int(h * 0.9))
        _assert_labels_equal(taug.transform_label(label, mat, size),
                             jaug.transform_label(label, mat, size))
    for _ in range(20):
        lefttop = (int(rng.integers(0, 12)), int(rng.integers(0, 10)))
        size = (int(rng.integers(8, w)), int(rng.integers(6, h)))
        _assert_labels_equal(taug.crop_label(label, lefttop, size),
                             jaug.crop_label(label, lefttop, size))
    assert taug.transform_label(None, mats[0], (w, h)) is None
    assert taug.crop_label(None, (0, 0), (w, h)) is None


# ---- warp and HSV against OpenCV -------------------------------------------------------

def _warp_cases(n=240):
    rng = np.random.default_rng(11)
    borders = [(0,), (7,), (104, 117, 123)]
    for i in range(n):
        h, w = int(rng.integers(2, 160)), int(rng.integers(2, 240))
        c = (1, 3)[i % 2]
        img = rng.integers(0, 256, (h, w, 3) if c == 3 else (h, w), dtype=np.uint8)
        kind = i % 3
        if kind < 2:                     # scale, down (0) or up (1)
            s = rng.uniform(0.3, 0.95) if kind == 0 else rng.uniform(1.05, 2.5)
            a = rng.uniform(0.85, 1.15)
            nw, nh = max(1, int(w * s * a)), max(1, int(h * s / a))
            mat = taug._scale_affine((h, w), (nw, nh))
        else:                            # rotation about the center, enlarged frame
            mat = timage.rotation_matrix_2d((w / 2.0, h / 2.0), rng.uniform(-15, 15), 1.0)
            cos_v, sin_v = abs(mat[0, 0]), abs(mat[0, 1])
            nw, nh = max(1, int(h * sin_v + w * cos_v)), max(1, int(h * cos_v + w * sin_v))
            mat[0, 2] += nw / 2.0 - w / 2.0
            mat[1, 2] += nh / 2.0 - h / 2.0
        yield i, img, mat, (nw, nh), borders[(i // 3) % 3]


def test_warp_affine_linear_equals_cv2():
    differing = []
    kinds = set()
    for i, img, mat, dsize, border in _warp_cases():
        want = cv2.warpAffine(img, mat, dsize, flags=cv2.INTER_LINEAR,
                              borderMode=cv2.BORDER_CONSTANT, borderValue=border)
        for fn in (timage.warp_affine_linear, timage.warp_affine_linear_numpy):
            got = fn(img, mat, dsize, border)
            assert got.shape == want.shape and got.dtype == np.uint8
            if not np.array_equal(got, want):
                differing.append((i, fn.__name__, int((got != want).sum())))
        kinds.add((img.ndim, dsize[0] % timage.WARP_LANES != 0, border))
    assert not differing, differing[:5]
    assert len(kinds) == 12              # 1 and 3 channels x ragged widths x 3 borders


def test_warp_affine_linear_rejects_what_cv2_rejects():
    img = np.zeros((4, 5, 3), np.uint8)
    with pytest.raises(ValueError, match="uint8"):
        timage.warp_affine_linear(img.astype(np.float32), np.eye(2, 3), (5, 4))
    with pytest.raises(ValueError, match="empty"):
        timage.warp_affine_linear(img, np.eye(2, 3), (0, 4))


def test_rotation_matrix_2d_equals_cv2():
    rng = np.random.default_rng(5)
    for _ in range(200):
        center = (float(rng.uniform(0, 3000)), float(rng.uniform(0, 3000)))
        angle, scale = float(rng.uniform(-180, 180)), float(rng.uniform(0.2, 3))
        np.testing.assert_array_equal(timage.rotation_matrix_2d(center, angle, scale),
                                      cv2.getRotationMatrix2D(center, angle, scale))


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.int32)


def test_hsv_pair_equals_cv2():
    rng = np.random.default_rng(6)
    widths = set()
    for i in range(120):
        h, w = int(rng.integers(1, 40)), int(rng.integers(1, 60))
        widths.add(w % timage.HSV_LANES == 0)
        rgb = rng.integers(0, 256, (h, w, 3)).astype(np.float32)      # the ops' inputs
        if i % 4 == 3:
            rgb = rng.uniform(-100, 400, (h, w, 3)).astype(np.float32)  # any float
        rgb[0, : min(w, 3)] = rgb[0, :1]                              # grey pixels: s = 0
        want = cv2.cvtColor(rgb, cv2.COLOR_RGB2HSV)
        np.testing.assert_array_equal(_bits(timage.rgb_to_hsv_f32(rgb)), _bits(want))
        hsv = want.copy()
        if i % 3 == 0:
            hsv[:, :, 1] *= rng.uniform(0.5, 1.5)
        elif i % 3 == 1:
            hsv[:, :, 0] = np.mod(hsv[:, :, 0] + rng.uniform(-18, 18), 360.0)
        else:
            hsv = np.stack([rng.uniform(-800, 800, (h, w)), rng.uniform(-0.5, 2, (h, w)),
                            rng.uniform(-10, 300, (h, w))], -1).astype(np.float32)
        np.testing.assert_array_equal(_bits(timage.hsv_to_rgb_f32(hsv)),
                                      _bits(cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)))
    assert widths == {True, False}


# ---- the pipeline ----------------------------------------------------------------------

def _pipelines(tree, seed=0):
    return (taug.CommonTransforms(TConfiger(tree), "train", seed=seed),
            jaug.CommonTransforms(JConfiger(tree), "train", seed=seed))


@pytest.mark.parametrize("nested", [False, True], ids=["flat", "nested"])
def test_shuffle_trans_seq_equals_jax(nested):
    names = ["random_hflip", "random_brightness", "random_perm", "random_contrast"]
    seq = [names[:2], names[2:], names[1:3]] if nested else names
    tree = {"train_trans": {"shuffle_trans_seq": seq, "trans_seq": ["random_crop"],
                            "random_crop": {"ratio": 1.0, "crop_size": [30, 20]},
                            "random_brightness": {"ratio": 1.0}}}
    t, j = _pipelines(tree)
    assert t._shuffle_nested == j._shuffle_nested == nested
    assert t._shuffle_groups == j._shuffle_groups
    orders = set()
    for s in range(30):
        t_rng, j_rng = np.random.default_rng(s), np.random.default_rng(s)
        t_ops, j_ops = t._shuffled_prefix(t_rng), j._shuffled_prefix(j_rng)
        assert [type(o).__name__ for o in t_ops] == [type(o).__name__ for o in j_ops]
        orders.add(tuple(type(o).__name__ for o in t_ops))
        assert t_rng.random() == j_rng.random()
    assert len(orders) > 2
    # the val split and a config without the key have no prefix
    assert taug.CommonTransforms(TConfiger(tree), "val")._shuffled_prefix(None) == []


@pytest.mark.parametrize("config", ["default", "every_op"])
def test_common_transforms_train_equals_jax(config):
    tree = load_trans_config().to_dict() if config == "default" else EVERY_OP
    t, j = _pipelines(tree, seed=4)
    data = np.random.default_rng(9)
    for i in range(20):
        img = _frame(data, 128, 256)
        label = _label(data, 128, 256, n=int(data.integers(1, 8)))
        ti, tl, tinfo = t(img.copy(), label, img_path=f"f{i}.png")
        ji, jl, jinfo = j(img.copy(), label, img_path=f"f{i}.png")
        np.testing.assert_array_equal(ti, ji, err_msg=f"frame {i}")
        _assert_labels_equal(tl, jl)
        assert tuple(tinfo) == tuple(jinfo)
        assert ti.shape == (64, 128, 3)     # every frame keeps the network's size
        assert all(p.dtype == np.int32 for p in tl[1])
    assert t._rng.random() == j._rng.random()
