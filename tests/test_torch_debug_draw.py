"""The debug drawings of ``draw_flag`` against the JAX package and OpenCV
5.0 on the CPU: ``visualize_keypoints`` equals ``cv2.circle(img, (x, y), 1,
color, -1)`` and ``draw_rectangle`` ``cv2.rectangle`` bit for bit, borders
and points outside the image included; ``dump_detections`` writes the three
PNGs that JAX's writes (read back, pixel for pixel) on the same detections,
from a JPEG and from a PNG frame."""

import os

import cv2
import numpy as np
import pytest
import torch

from instance_segmentation_tpu.ops import decode as jd
from instance_segmentation_tpu.utils import debug_draw as jdraw
from instance_segmentation_torch.ops import decode as td
from instance_segmentation_torch.utils import debug_draw as tdraw
from instance_segmentation_torch.utils.jpeg import write_jpeg
from instance_segmentation_torch.utils.png import read_png, write_png
from instance_segmentation_torch.utils.visualize import draw_rectangle, visualize_keypoints

import torch_cases

torch.set_num_threads(2)


def test_keypoints_equal_cv2_circle():
    rng = np.random.default_rng(0)
    h, w = 23, 31
    pts = np.concatenate([rng.uniform(-3, [w + 3, h + 3], (60, 2)),
                          [[0, 0], [w - 1, h - 1], [-1, 5], [w, 5], [5, -1], [5, h],
                           [-0.7, 3.2], [w - 0.2, h - 0.9]]]).astype(np.float32)
    base = rng.integers(0, 256, (h, w, 3), np.uint8)
    got = visualize_keypoints(base.copy(), pts, color=(1, 200, 37))
    want = base.copy()
    for x, y in pts:
        cv2.circle(want, (int(x), int(y)), 1, (1, 200, 37), -1)
    np.testing.assert_array_equal(got, want)


def test_rectangle_equals_cv2():
    rng = np.random.default_rng(1)
    h, w = 40, 52
    for _ in range(40):
        x1, x2 = rng.integers(-10, w + 10, 2)
        y1, y2 = rng.integers(-10, h + 10, 2)
        base = rng.integers(0, 256, (h, w, 3), np.uint8)
        want = base.copy()
        cv2.rectangle(want, (int(x1), int(y1)), (int(x2), int(y2)), (9, 8, 7))
        got = draw_rectangle(base.copy(), (int(x1), int(y1)), (int(x2), int(y2)), (9, 8, 7))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ext", ["jpg", "png"])
def test_dump_detections_equals_jax(ext, tmp_path):
    outputs, anchors = torch_cases.synthetic_scene(128, 192)
    dets = td.decode_output(tuple(map(torch.from_numpy, outputs)), torch.tensor(anchors),
                            256, 384, 2.0, torch_cases.SCENE_DECODE)
    assert int(dets.obj_valid.sum()) == 2
    frame = np.random.default_rng(2).integers(0, 256, (256, 384, 3), np.uint8)
    path = str(tmp_path / f"frame_0001.{ext}")
    (write_jpeg if ext == "jpg" else write_png)(path, frame)
    jdets = jd.Detections(*(t.numpy() for t in dets))
    for i in range(dets.boxes.shape[0]):
        tdraw.dump_detections(dets, i, path, str(tmp_path / "port"))
        jdraw.dump_detections(jdets, i, path, str(tmp_path / "jax"))
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) == \
        [f"frame_0001_{k}.png" for k in ("box", "candid", "instances")]
    for name in names:
        got = read_png(str(tmp_path / "port" / name))
        want = cv2.imread(str(tmp_path / "jax" / name))[..., ::-1]
        np.testing.assert_array_equal(got, want, err_msg=name)
        assert not np.array_equal(got, cv2.imread(path)[..., ::-1])      # something drawn
    tdraw.dump_detections(dets, 0, str(tmp_path / "missing.jpg"), str(tmp_path / "none"))
    assert os.listdir(tmp_path / "none") == []       # an unreadable frame is skipped
