"""The port's GT cleanup tool (tools/convert_polygon.py, with
utils/contours.py) against the JAX tool, which calls OpenCV 5.0: contours
point for point and in OpenCV's order, areas bit for bit, ``fill_polygon``
on random, self-intersecting, border-touching, one-pixel-wide and degenerate
polygons and on masks with several components of equal area, and
``convert_file`` byte for byte on a synthetic gtFine tree."""

import importlib.util
import json
import os
import shutil

import cv2
import numpy as np
import pytest

from instance_segmentation_torch.tools import convert_polygon as port
from instance_segmentation_torch.tools import make_synthetic_cityscapes
from instance_segmentation_torch.utils.contours import contour_area, find_external_contours

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "jax_convert_polygon", os.path.join(REPO, "tools", "convert_polygon.py"))
jax_tool = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jax_tool)


def _assert_contours_equal(mask):
    want = cv2.findContours(mask, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)[0]
    got = find_external_contours(mask)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
        assert contour_area(g) == cv2.contourArea(w)


@pytest.mark.parametrize("seed", range(4))
def test_contours_of_random_masks_equal_opencv(seed):
    """Noise masks of every density (holes, nested components, one-pixel and
    one-line components, components on every border)."""
    rng = np.random.default_rng(seed)
    for _ in range(400):
        h, w = (int(v) for v in rng.integers(1, 24, 2))
        mask = (rng.uniform(size=(h, w)) < rng.uniform(0.05, 0.95)).astype(np.uint8)
        _assert_contours_equal(mask)


def test_contours_of_shapes_equal_opencv():
    shapes = []
    m = np.zeros((20, 30), np.uint8); m[5:15, 5:25] = 1; m[8:12, 10:20] = 0; m[9:11, 14:16] = 1
    shapes.append(m)                                     # a ring with an island
    m = np.zeros((12, 12), np.uint8); m[3, 3] = m[8, 8] = 1
    shapes.append(m)                                     # two single pixels
    m = np.zeros((10, 16), np.uint8); m[4, 2:14] = 1; m[1:9, 7] = 1
    shapes.append(m)                                     # one-pixel-wide lines
    shapes.append(np.ones((7, 9), np.uint8) * 255)       # the whole frame
    m = np.zeros((9, 9), np.uint8); np.fill_diagonal(m, 3)
    shapes.append(m)                                     # a diagonal
    m = np.zeros((16, 24), np.uint8); m[2:6, 2:6] = m[2:6, 10:14] = m[9:13, 4:8] = 1
    shapes.append(m)                                     # three squares of equal area
    shapes.append(np.zeros((5, 5), np.uint8))            # nothing
    for m in shapes:
        _assert_contours_equal(m)


def _random_polygons(seed, n, h, w):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        kind = i % 5
        k = int(rng.integers(3, 12))
        if kind == 0:                                    # self-intersecting: random order
            pts = rng.uniform([0, 0], [w, h], (k, 2))
        elif kind == 1:                                  # beyond the borders
            pts = rng.uniform([-w / 3, -h / 3], [w * 4 / 3, h * 4 / 3], (k, 2))
        elif kind == 2:                                  # one pixel wide
            x0, y0 = rng.uniform([0, 0], [w, h])
            pts = np.array([[x0, y0], [x0 + rng.uniform(-w, w), y0 + rng.integers(0, 2)],
                            [x0 + rng.uniform(-w, w), y0]])
        elif kind == 3:                                  # degenerate: collinear or a point
            x0, y0 = rng.uniform([0, 0], [w, h])
            t = rng.uniform(0, 1, (k, 1)) * (rng.integers(0, 2))
            pts = np.array([x0, y0]) + t * rng.uniform(-w / 2, w / 2, (1, 2))
        else:                                            # a bow tie: two triangles
            cx, cy, r = rng.integers(6, w - 6), rng.integers(6, h - 6), rng.integers(2, 6)
            pts = np.array([[cx - r, cy - r], [cx + r, cy + r], [cx + r, cy - r],
                            [cx - r, cy + r]])
        out.append(pts.astype(np.int32))
    return out


def test_fill_polygon_takes_the_first_of_equal_areas_as_the_jax_tool():
    """An n shape whose crossbar lies above the frame fills two equal legs;
    OpenCV lists the one found last first, and ``max`` keeps it."""
    h, w = 20, 30
    poly = np.array([[2, -8], [26, -8], [26, 10], [20, 10], [20, -3], [8, -3], [8, 10],
                     [2, 10]], np.int32)
    mask = np.zeros((h, w), np.uint8)
    cv2.fillPoly(mask, [poly], 1)
    areas = [cv2.contourArea(c) for c in
             cv2.findContours(mask, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)[0]]
    assert len(areas) == 2 and areas[0] == areas[1]
    want = jax_tool.fill_polygon(poly, h, w)
    got = port.fill_polygon(poly, h, w)
    np.testing.assert_array_equal(got, want)
    assert int(got[:, 0].min()) == 20


@pytest.mark.parametrize("seed", range(3))
def test_fill_polygon_equals_the_jax_tool(seed):
    h, w = 40, 64
    for poly in _random_polygons(seed, 60, h, w):
        want = jax_tool.fill_polygon(poly, h, w)
        got = port.fill_polygon(poly, h, w)
        if want is None:
            assert got is None
            continue
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_convert_file_equals_the_jax_tool_byte_for_byte(tmp_path):
    root = tmp_path / "data"
    make_synthetic_cityscapes.generate(str(root), splits=(("train", 3),), h=96, w=192,
                                       seed=3, instances=(3, 6))
    gt = root / "gtFine" / "train" / "synth"
    extra = gt / "odd_000000_000019_gtFine_polygons.json"
    extra.write_text(json.dumps({"imgHeight": 40, "imgWidth": 64, "objects": [
        {"label": "car", "polygon": p.tolist()} for p in _random_polygons(7, 20, 40, 64)]}))
    mirror = tmp_path / "mirror"
    shutil.copytree(gt, mirror)
    written = port.convert_tree(str(gt))
    assert len(written) == 4
    for path in written:
        src = os.path.join(mirror, os.path.basename(path).replace(
            "_fill_polygons.json", "_gtFine_polygons.json"))
        want = jax_tool.convert_file(src)
        with open(path, "rb") as f, open(want, "rb") as g:
            assert f.read() == g.read()
    kept = sum(len(json.load(open(p))["objects"]) for p in written)
    assert 0 < kept < sum(len(json.load(open(p))["objects"])
                          for p in map(str, gt.glob("*_gtFine_polygons.json")))


def test_cli_counts_the_files(tmp_path, capsys):
    root = tmp_path / "data"
    make_synthetic_cityscapes.generate(str(root), splits=(("val", 2),), h=64, w=128, seed=1,
                                       instances=(1, 2))
    port.main(["--root", str(root / "gtFine")])
    assert capsys.readouterr().out.strip() == "converted 2 label files"
    assert len(list((root / "gtFine").rglob("*_fill_polygons.json"))) == 2
