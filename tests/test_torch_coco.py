"""The port's COCO path against the JAX package on the CPU, on a synthetic
COCO tree of JPEG frames (``tools/make_synthetic_coco.py``): the class map
over ids 1..90; ``COCODataset`` items and train batches from the registry
(serial and one worker) bit for bit; ``rle_to_mask`` and
``compute_coco_ap`` equal to JAX's (exactly: the same float64 arithmetic)
on random ground truth with crowds, RLE masks and area overrides, random
predictions, every area range and ``max_dets``, and the port meets every
fixture of ``tests/test_coco_ap.py``; ``evaluate_from_json(dataset="coco")``
equal to JAX's on the same cached detections, its results file equal byte
for byte; the ground truth scored as predictions gives AP 1; and the
``evaluate``, ``test`` (``draw_flag``, JPEG overlays) and ``train`` entry
points run on the tree with ``--device cpu``."""

import inspect
import json
import os

import cv2
import numpy as np
import pytest
import torch
import yaml

import test_coco_ap as jax_fixtures
from instance_segmentation_tpu import data as jdata
from instance_segmentation_tpu.configs import Config as JConfig
from instance_segmentation_tpu.configs import Configer as JConfiger
from instance_segmentation_tpu.data import coco as jcoco
from instance_segmentation_tpu.evaluation import coco_ap as jap
from instance_segmentation_tpu.evaluation import eval_loop as jel
from instance_segmentation_tpu.transforms import CommonTransforms as JTransforms
from instance_segmentation_tpu.utils.logger import Logger as JLogger
from instance_segmentation_torch import data as tdata
from instance_segmentation_torch import evaluate as t_evaluate
from instance_segmentation_torch import test as t_test
from instance_segmentation_torch import train as t_train
from instance_segmentation_torch.configs import Config as TConfig
from instance_segmentation_torch.configs import Configer as TConfiger
from instance_segmentation_torch.data import coco as tcoco
from instance_segmentation_torch.evaluation import coco_ap as tap
from instance_segmentation_torch.evaluation import eval_loop as tel
from instance_segmentation_torch.tools import make_synthetic_coco as msc
from instance_segmentation_torch.transforms import CommonTransforms as TTransforms
from instance_segmentation_torch.utils.image import poly_to_mask
from instance_segmentation_torch.utils.jpeg import read_jpeg
from instance_segmentation_torch.utils.logger import Logger as TLogger
from instance_segmentation_torch.utils.png import read_png

torch.set_num_threads(2)
FH, FW = 96, 128                 # frame size of the tree
H, W = 128, 256                  # model input of the entry points
TRANS = {"train_trans": {"trans_seq": ["random_resize", "random_hflip", "random_brightness"],
                         "random_resize": {"ratio": 0.0, "target_size": [W, H]},
                         "random_hflip": {"ratio": 0.5, "swap_pair": []},
                         "random_brightness": {"ratio": 1.0, "shift_value": 10}},
         "val_trans": {"trans_seq": ["random_resize"],
                       "random_resize": {"ratio": 0.0, "target_size": [W, H]}}}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("coco") / "data")
    msc.generate(root, (("train", 4), ("val", 3)), FH, FW, seed=4)
    return root


def test_class_map_over_coco_ids():
    got = [tcoco.convert_cls_id_to_index(c) for c in range(1, 91)]
    assert got == [jcoco.convert_cls_id_to_index(c) for c in range(1, 91)]
    kept = [c for c in range(1, 91) if c not in tcoco.skip_cls_ids]
    assert [tcoco.convert_cls_id_to_index(c) for c in kept] == list(range(80))
    assert tdata.get_cls_num("coco") == jdata.get_cls_num("coco") == 80


def test_dataset_items_equal_jax(tree):
    """The port reads the JPEG frames with its own decoder, JAX with cv2."""
    for subset in ("train", "val"):
        t = tcoco.COCODataset(tree, subset=subset)
        j = jcoco.COCODataset(tree, subset=subset)
        assert len(t) == len(j) > 0
        for i in range(len(t)):
            (ti, (tc, tp), _), (ji, (jc, jp), _) = t[i], j[i]
            np.testing.assert_array_equal(ti, ji)
            assert tc == jc and len(tp) == len(jp) > 0
            for a, b in zip(tp, jp):
                np.testing.assert_array_equal(a, b)
    ids = {tcoco.convert_cls_id_to_index(a["category_id"])
           for a in json.load(open(os.path.join(tree, "train", "instances.json")))["annotations"]}
    assert ids & {10, 11, 23, 24}          # categories 11/13/25/27, beside skipped ids


@pytest.mark.parametrize("workers", [0, 1])
def test_train_batches_equal_jax(tree, workers):
    jt = JTransforms(JConfiger(TRANS), "train", seed=3)
    tt = TTransforms(TConfiger(TRANS), "train", seed=3)
    j = jdata.get_dataloader(2, "coco", tree, "train", transforms=jt, max_instances=8,
                             max_verts=32, seed=3, num_workers=workers)
    t = tdata.get_dataloader(2, "coco", tree, "train", transforms=tt, max_instances=8,
                             max_verts=32, seed=3, num_workers=workers)
    try:
        jb, tb = list(j), list(t)
    finally:
        t.close()
    assert len(tb) == len(jb) == 2
    for (ti, tp, tinf), (ji, jp, jinf) in zip(tb, jb):
        assert ti.shape == (2, H, W, 3)
        np.testing.assert_array_equal(ti, ji)
        for a, b in zip(tp, jp):
            np.testing.assert_array_equal(a, b)
        assert (tp.cls_ids >= 0).any()
        assert [tuple(i) for i in tinf] == [tuple(i) for i in jinf]


def _random_masks(rng, n, h, w):
    masks = []
    for _ in range(n):
        m = np.zeros((h, w), bool)
        for _ in range(int(rng.integers(1, 4))):
            y0, x0 = rng.integers(0, h - 2), rng.integers(0, w - 2)
            m[y0:y0 + int(rng.integers(1, h // 2)), x0:x0 + int(rng.integers(1, w // 2))] = True
        masks.append(m)
    masks[0][:] = False
    masks[1][0, 0] = True          # a mask that starts with a 1 (leading zero run)
    return masks


def test_rle_to_mask_equals_jax():
    rng = np.random.default_rng(0)
    for m in _random_masks(rng, 12, 37, 53):
        counts = msc.rle_counts(m)
        for segm in ({"size": [37, 53], "counts": counts},
                     {"size": [37, 53], "counts": msc.rle_string(counts)},
                     {"size": [37, 53], "counts": msc.rle_string(counts).encode()}):
            got = tap.rle_to_mask(segm)
            np.testing.assert_array_equal(got, jap.rle_to_mask(segm))
            np.testing.assert_array_equal(got, m)


def _random_case(seed):
    """Ground truth (polygons, crowds, RLE masks, area overrides) and
    predictions (jittered copies, false positives, wrong classes) over three
    images of different sizes and four classes."""
    rng = np.random.default_rng(seed)
    sizes = {"a": (64, 80), "b": (120, 96), "c": (200, 240)}
    gts, preds = [], []
    for img, (h, w) in sizes.items():
        for _ in range(int(rng.integers(3, 9))):
            cls = int(rng.integers(0, 4))
            cx, cy = rng.uniform(5, w - 5), rng.uniform(5, h - 5)
            r = rng.uniform(2, min(h, w) / 2.5)
            ang = np.sort(rng.uniform(0, 2 * np.pi, int(rng.integers(3, 9))))
            poly = np.stack([cx + r * np.cos(ang), cy + r * np.sin(ang)], 1).astype(np.float32)
            kind = rng.integers(0, 4)
            area = float(rng.uniform(10, 12000)) if kind == 3 else None
            if kind == 2:
                gts.append(tap.CocoGT(img, cls, mask=poly_to_mask(poly, (h, w)).astype(bool),
                                      iscrowd=bool(rng.integers(0, 2)), area=area))
            else:
                gts.append(tap.CocoGT(img, cls, polygon=poly, iscrowd=kind == 1, area=area))
            for _ in range(int(rng.integers(0, 3))):
                jit = poly + rng.normal(0, r * 0.2, poly.shape).astype(np.float32)
                c = cls if rng.random() < 0.8 else int(rng.integers(0, 4))
                preds.append(tap.CocoPrediction(img, c, float(rng.random()), jit))
        for _ in range(int(rng.integers(0, 4))):
            x0, y0 = rng.uniform(0, w - 10), rng.uniform(0, h - 10)
            box = np.array([[x0, y0], [x0 + 9, y0], [x0 + 9, y0 + 9], [x0, y0 + 9]], np.float32)
            preds.append(tap.CocoPrediction(img, int(rng.integers(0, 4)),
                                            float(rng.random()), box))
    return preds, gts, sizes


def _as_jax(preds, gts):
    return ([jap.CocoPrediction(p.image_id, p.cls_id, p.score, p.polygon) for p in preds],
            [jap.CocoGT(g.image_id, g.cls_id, g.polygon, g.iscrowd, g.area, g.mask)
             for g in gts])


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("max_dets", [100, 3])
def test_compute_coco_ap_equals_jax(seed, max_dets):
    preds, gts, sizes = _random_case(seed)
    jpreds, jgts = _as_jax(preds, gts)
    got = tap.compute_coco_ap(preds, gts, sizes, num_classes=5, max_dets=max_dets)
    want = jap.compute_coco_ap(jpreds, jgts, sizes, num_classes=5, max_dets=max_dets)
    assert got == want
    assert 0.0 < got["AP"] < 1.0
    assert any(g.iscrowd for g in gts) and any(g.mask is not None for g in gts)


@pytest.mark.parametrize("name", [n for n, f in inspect.getmembers(jax_fixtures)
                                  if n.startswith("test_") and inspect.isfunction(f)])
def test_port_meets_the_jax_fixtures(name, monkeypatch, tmp_path):
    """Each test of tests/test_coco_ap.py, run with the port's coco_ap (and
    the port's ``evaluate_from_json`` for the eval-loop fixtures) in place
    of the JAX package's."""
    for attr in ("CocoGT", "CocoPrediction", "compute_coco_ap", "write_coco_results"):
        monkeypatch.setattr(jax_fixtures, attr, getattr(tap, attr))
    monkeypatch.setattr(jap, "rle_to_mask", tap.rle_to_mask)
    monkeypatch.setattr(jel, "evaluate_from_json", tel.evaluate_from_json)
    fn = getattr(jax_fixtures, name)
    fn(tmp_path) if "tmp_path" in inspect.signature(fn).parameters else fn()


def _cached_dets(tree, rng):
    """Detections in the (1024, 2048) decode frame: the ground truth mapped
    corner to corner into it, jittered, with random scores, some classes
    wrong, and a stray box per image."""
    dets, infos = msc.gt_detections(tree, "val")
    fx, fy = (2048 - 1) / (FW - 1), (1024 - 1) / (FH - 1)
    out = []
    for img_dets in dets:
        new = []
        for cls, _, center, poly in img_dets:
            p = np.asarray(poly) * [fx, fy] + rng.normal(0, 6, (len(poly), 2))
            cls = cls if rng.random() < 0.8 else int(rng.integers(0, 80))
            new.append([cls, float(rng.random()), center, p.tolist()])
        new.append([int(rng.integers(0, 80)), float(rng.random()), [10.0, 10.0],
                    [[100.0, 100.0], [300.0, 100.0], [300.0, 260.0], [100.0, 260.0]]])
        out.append(new)
    return out, infos


def test_evaluate_from_json_coco_equals_jax(tree, tmp_path):
    dets, infos = _cached_dets(tree, np.random.default_rng(1))
    results = {}
    for name, mod, cfg, logger in (("port", tel, TConfig, TLogger), ("jax", jel, JConfig,
                                                                      JLogger)):
        out = tmp_path / name
        out.mkdir()
        json.dump(dets, open(out / "0_dets.json", "w"))
        json.dump(infos, open(out / "0_infos.json", "w"))
        results[name] = mod.evaluate_from_json(cfg({"eval_dir": tree, "subset": "val"}), 0,
                                               str(out), "coco", logger(), 80)
    assert results["port"] == results["jax"]
    assert 0.0 < results["port"]["AP"] < 1.0
    assert (tmp_path / "port" / "0_coco_results.json").read_bytes() == \
        (tmp_path / "jax" / "0_coco_results.json").read_bytes()


def test_ground_truth_as_predictions_scores_one(tree, tmp_path):
    dets, infos = msc.gt_detections(tree, "val")
    json.dump(dets, open(tmp_path / "0_dets.json", "w"))
    json.dump(infos, open(tmp_path / "0_infos.json", "w"))
    blob = json.load(open(os.path.join(tree, "val", "instances.json")))
    crowd = [a for a in blob["annotations"] if a["iscrowd"]]
    rle_only = [a for a in blob["annotations"]
                if not a["iscrowd"] and isinstance(a["segmentation"], dict)]
    assert len(crowd) == len(rle_only) == 3 and all(isinstance(a["segmentation"]["counts"], str)
                                                    for a in crowd)
    got = tel.evaluate_from_json(TConfig({"eval_dir": tree}), 0, str(tmp_path), "coco",
                                 TLogger(), 80, orig_hw=(FH, FW))
    assert got["AP"] == got["AP50"] == got["AP75"] == 1.0


def test_entry_points_on_a_coco_tree(tree, tmp_path):
    """evaluate (kmeans grouping), test (draw_flag: a JPEG overlay per frame
    and three debug PNGs) and train (one step and the in-loop COCO eval),
    B0 float32 at 128x256, 80 classes, on the CPU."""
    decode = {"cls_th": 0.3, "iou_th": 0.2, "kp_th": 2000, "obj_pixel_th": 2, "wh_delta": 0.1,
              "alpha_ratio": 2, "draw_flag": True, "group_mode": "kmeans"}
    yaml.safe_dump(decode, open(tmp_path / "decode.yaml", "w"))
    json.dump(TRANS, open(tmp_path / "trans.json", "w"))
    common = {"seed": 1, "compound_coef": 0, "decode_cfg_path": str(tmp_path / "decode.yaml"),
              "trans_cfg_path": str(tmp_path / "trans.json"),
              "static": {"max_instances": 8, "max_vertices": 16, "max_points": 128}}
    ev = {**common, "data": {"eval_dir": tree, "save_dir": str(tmp_path / "eval"),
                             "dataset": "coco", "batch_size": 2, "input_size": [H, W],
                             "num_classes": -1, "subset": "val"},
          "weights_path": None, "weights_dir": None,
          "tpu": {"compute_dtype": "float32", "input_size": [H, W]}}
    yaml.safe_dump(ev, open(tmp_path / "eval.yaml", "w"))
    t_evaluate.main(["--cfg_path", str(tmp_path / "eval.yaml"), "--device", "cpu"])
    assert len(json.load(open(tmp_path / "eval" / "0_dets.json"))) == 3
    assert isinstance(json.load(open(tmp_path / "eval" / "0_coco_results.json")), list)

    te = {**common, "data": {"test_dir": os.path.join(tree, "val"), "test_image": None,
                             "save_dir": str(tmp_path / "test"), "dataset": "dir",
                             "batch_size": 2, "input_size": [H, W], "num_classes": 80},
          "weights_path": None}
    yaml.safe_dump(te, open(tmp_path / "test.yaml", "w"))
    t_test.main(["--cfg_path", str(tmp_path / "test.yaml"), "--device", "cpu"])
    frames = sorted(f for f in os.listdir(os.path.join(tree, "val")) if f.endswith(".jpg"))
    for f in frames:
        overlay = str(tmp_path / "test" / f)
        assert open(overlay, "rb").read(3) == b"\xff\xd8\xff"       # JPEG, as cv2.imwrite
        assert read_jpeg(overlay).shape == (FH, FW, 3)
        np.testing.assert_array_equal(read_jpeg(overlay), cv2.imread(overlay)[..., ::-1])
        for kind in ("box", "candid", "instances"):
            assert read_png(str(tmp_path / "test" / f"{f[:-4]}_{kind}.png")).shape == (FH, FW, 3)

    tr = {**common, "data": {"train_dir": tree, "save_dir": str(tmp_path / "train"),
                             "dataset": "coco", "batch_size": 2, "num_classes": -1,
                             "num_workers": 0},
          "optimizer": {"lr": "2e-5", "type": "Adam", "momentum": 0.9},
          "max_iter": 1, "num_epochs": 1, "save_span": 1000, "start_eval_epoch": 0,
          "anchors_scales": "[2 ** 0, 2 ** (1.0 / 3.0), 2 ** (2.0 / 3.0)]",
          "anchors_ratios": "[(1.0, 1.0), (1.4, 0.7), (0.7, 1.4)]", "pretrained_path": None,
          "tpu": {"compute_dtype": "float32", "remat": False, "input_size": [H, W]}}
    yaml.safe_dump(tr, open(tmp_path / "train.yaml", "w"))
    t_train.main(["--cfg_path", str(tmp_path / "train.yaml"), "--device", "cpu"])
    assert os.path.exists(tmp_path / "train" / "efficient_weights_00000000.pth")
    assert os.path.exists(tmp_path / "train" / "0_coco_results.json")
