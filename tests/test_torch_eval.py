"""The port's evaluation path against the JAX package's, on the CPU:
``compute_instance_ap`` to 1e-12 on seeded cases (perfect, perturbed,
groups, voids, small regions, multi-match); ``rasterize_polygon``,
``render_masks`` and ``iou_matrix`` (masks bit for bit, every differing
pixel counted; IoU to 1e-6); ``eval_outputs`` at EfficientSeg-B0 128x256
float32 (256x512 frames at scale 2, kp_th 2000, class bias raised by 0.5 so
that detections exist) against the jitted JAX ``eval_outputs`` on the same
weights and tree, batch by batch (class counts equal, the slice's
tolerances on the rest), and both AP implementations on the port's
detections; and the ``evaluate`` and ``test`` entry points run in-process
with ``--device cpu``."""

import json
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from instance_segmentation_tpu import data as jdata
from instance_segmentation_tpu.configs import Config as JConfig
from instance_segmentation_tpu.configs import Configer as JConfiger
from instance_segmentation_tpu.evaluation import cityscapes_ap as jap
from instance_segmentation_tpu.evaluation import device_iou as jiou
from instance_segmentation_tpu.evaluation import eval_loop as jel
from instance_segmentation_tpu.models import EfficientSeg as JaxSeg
from instance_segmentation_tpu.models import EfficientSegConfig as JaxCfg
from instance_segmentation_tpu.ops import decode as jd
from instance_segmentation_tpu.ops import geometry as jgeo
from instance_segmentation_tpu.transforms import CommonTransforms as JTransforms
from instance_segmentation_tpu.utils.logger import Logger as JLogger
from instance_segmentation_torch import data as tdata
from instance_segmentation_torch import evaluate as t_evaluate
from instance_segmentation_torch import test as t_test
from instance_segmentation_torch.configs import Config as TConfig
from instance_segmentation_torch.configs import Configer as TConfiger
from instance_segmentation_torch.evaluation import cityscapes_ap as tap
from instance_segmentation_torch.evaluation import device_iou as tiou
from instance_segmentation_torch.evaluation import eval_loop as tel
from instance_segmentation_torch.models import EfficientSeg, EfficientSegConfig
from instance_segmentation_torch.ops import decode as td
from instance_segmentation_torch.ops import geometry as tgeo
from instance_segmentation_torch.transforms import CommonTransforms as TTransforms
from instance_segmentation_torch.utils import png
from instance_segmentation_torch.utils.logger import Logger as TLogger
from instance_segmentation_torch.weights import load_flax_variables

from test_torch_decode import assert_detections_match
from test_torch_model import random_flax_variables

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 128, 256
TRANS = {"train_trans": {"trans_seq": ["resize"], "resize": {"target_size": 2}},
         "val_trans": {"trans_seq": ["resize"], "resize": {"target_size": 2}},
         "normalize": {"div_value": 255.0, "mean": [0.485, 0.456, 0.406],
                       "std": [0.229, 0.224, 0.225]}}
DECODE = {"cls_th": 0.3, "iou_th": 0.2, "kp_th": 2000, "obj_pixel_th": 2, "wh_delta": 0.1,
          "alpha_ratio": 2, "draw_flag": False}


# ---------------------------------------------------------------------------
# Cityscapes AP
# ---------------------------------------------------------------------------

def _star(rng, cx, cy, r, n=None):
    n = n or int(rng.integers(5, 12))
    ang = np.sort(rng.uniform(0, 2 * np.pi, n))
    rad = r * rng.uniform(0.6, 1.0, n)
    return np.stack([cx + rad * np.cos(ang), cy + rad * np.sin(ang)], 1).astype(np.float32)


def _ap_case(kind, seed):
    """(predictions, ground truth, image sizes, voids) as plain tuples."""
    rng = np.random.default_rng(seed)
    sizes = {f"img{i}": (int(rng.integers(120, 200)), int(rng.integers(150, 260)))
             for i in range(3)}
    gts, preds, voids = [], [], {}
    for img, (h, w) in sizes.items():
        for _ in range(int(rng.integers(2, 6))):
            r = float(rng.uniform(8, 30))
            poly = _star(rng, rng.uniform(r, w - r), rng.uniform(r, h - r), r)
            cls = int(rng.integers(0, 4))
            group = kind == "groups" and rng.random() < 0.4
            if kind == "small":
                poly = poly * np.float32(rng.choice([0.2, 1.0])) + np.float32(5)
            gts.append((img, cls, poly, group))
            if kind == "perfect":
                preds.append((img, cls, float(rng.uniform(0.3, 1)), poly))
            else:
                jitter = rng.normal(0, 3 if kind != "multi" else 1, poly.shape)
                preds.append((img, cls, float(rng.uniform(0.3, 1)),
                              (poly + jitter).astype(np.float32)))
                if kind == "multi":      # a second, shifted match of the same instance
                    preds.append((img, cls, float(rng.uniform(0.3, 1)),
                                  (poly + np.float32(rng.uniform(2, 6))).astype(np.float32)))
        if kind in ("perturbed", "voids"):   # false positives somewhere
            preds.append((img, int(rng.integers(0, 4)), float(rng.uniform(0.3, 1)),
                          _star(rng, w / 2, h / 2, 15)))
        if kind == "voids":
            voids[img] = [_star(rng, rng.uniform(20, w - 20), rng.uniform(20, h - 20), 25)]
            preds.append((img, 0, 0.5, voids[img][0] + np.float32(2)))
    return preds, gts, sizes, voids


def _run_ap(mod, case):
    preds, gts, sizes, voids = case
    return mod.compute_instance_ap(
        [mod.InstancePrediction(i, c, s, p) for i, c, s, p in preds],
        [mod.InstanceGT(i, c, p, g) for i, c, p, g in gts], sizes, num_classes=8,
        void_regions=voids or None)


def _assert_ap_equal(got, want):
    assert abs(got["AP"] - want["AP"]) <= 1e-12 and abs(got["AP50"] - want["AP50"]) <= 1e-12
    assert got["classes"].keys() == want["classes"].keys()
    for c in got["classes"]:
        for k in ("AP", "AP50"):
            assert abs(got["classes"][c][k] - want["classes"][c][k]) <= 1e-12


@pytest.mark.parametrize("kind", ["perfect", "perturbed", "groups", "voids", "small", "multi"])
def test_compute_instance_ap_equals_jax(kind):
    for seed in range(3):
        case = _ap_case(kind, seed)
        got, want = _run_ap(tap, case), _run_ap(jap, case)
        _assert_ap_equal(got, want)
        if kind == "perfect":
            assert abs(got["AP"] - 1.0) <= 1e-12 and got["AP50"] == 1.0


# ---------------------------------------------------------------------------
# Rasterization and device IoU
# ---------------------------------------------------------------------------

def _padded_polys(rng, n, V, h, w):
    polys = np.zeros((n, V, 2), np.float32)
    for i in range(n):
        k = int(rng.integers(3, V + 1))
        r = float(rng.uniform(5, min(h, w) / 2))
        p = _star(rng, rng.uniform(-5, w + 5), rng.uniform(-5, h + 5), r, n=k)[:, ::-1]
        if i % 4 == 3:             # integer vertices: exact ties on rows and columns
            p = np.round(p)
        polys[i, :k], polys[i, k:] = p, p[-1]
    return polys


def _count_differing(got, want, what):
    n = int((np.asarray(got) != np.asarray(want)).sum())
    assert n == 0, f"{what}: {n} of {np.asarray(want).size} pixels differ"


def test_rasterize_polygon_and_area_equal_jax():
    rng = np.random.default_rng(0)
    h, w = 48, 80
    polys = _padded_polys(rng, 24, 16, h, w)
    want = np.asarray(jax.jit(jax.vmap(lambda p: jgeo.rasterize_polygon(p, h, w)))(polys))
    got = tgeo.rasterize_polygon(torch.from_numpy(polys), h, w).numpy()
    _count_differing(got, want, "rasterize_polygon")
    area = np.asarray(jax.vmap(lambda p: jgeo.polygon_area(p, 0))(polys))
    np.testing.assert_allclose(tgeo.polygon_area(torch.from_numpy(polys)).numpy(), area,
                               rtol=1e-6)
    assert polys.shape[0] > tgeo.RASTER_CHUNK           # more than one pass


def _fake_dets(rng, B, D, Q, h, w):
    polys = np.stack([_padded_polys(rng, D, Q, h, w)[..., ::-1] for _ in range(B)])
    lens = np.full((B, D), Q, np.int32)
    ok = rng.random((B, D)) < 0.8
    arrays = dict(boxes=np.zeros((B, D, 4), np.float32),
                  scores=rng.uniform(0.3, 1, (B, D)).astype(np.float32),
                  classes=rng.integers(0, 3, (B, D)).astype(np.int32), det_valid=ok,
                  polygons=np.ascontiguousarray(polys), poly_len=lens,
                  centers=polys.mean(2).astype(np.float32), obj_valid=ok)
    return (jd.Detections(**{k: jnp.asarray(v) for k, v in arrays.items()}),
            td.Detections(**{k: torch.from_numpy(np.ascontiguousarray(v))
                             for k, v in arrays.items()}))


def test_render_masks_and_iou_matrix_equal_jax():
    rng = np.random.default_rng(1)
    OH, OW = 96, 160
    jdets, tdets = _fake_dets(rng, 2, 6, 12, OH, OW)
    want = np.asarray(jax.jit(lambda d: jd.render_masks(d, OH, OW, max_masks=5))(jdets))
    got = td.render_masks(tdets, OH, OW, max_masks=5).numpy()
    _count_differing(got, want, "render_masks")
    gt_polys = np.stack([_padded_polys(rng, 4, 10, OH // 2, OW // 2) for _ in range(2)])
    gt_cls = np.array([[0, 1, 2, -1], [2, -1, 1, 0]], np.int32)
    for res_divisor in (1, 2):
        jm = np.asarray(jax.jit(lambda p, c: jiou.gt_masks_from_packed(
            p, c, OH // res_divisor, OW // res_divisor, 2.0 / res_divisor))(gt_polys, gt_cls))
        tm = tiou.gt_masks_from_packed(torch.from_numpy(gt_polys), torch.from_numpy(gt_cls),
                                       OH // res_divisor, OW // res_divisor,
                                       2.0 / res_divisor).numpy()
        _count_differing(tm, jm, "gt_masks_from_packed")
        j_iou, j_pv, j_gv = jax.jit(lambda d, p, c: jiou.iou_matrix(
            d, p, c, OH, OW, label_scale=2.0, res_divisor=res_divisor, max_masks=5))(
            jdets, jnp.asarray(gt_polys), jnp.asarray(gt_cls))
        t_iou, t_pv, t_gv = tiou.iou_matrix(tdets, torch.from_numpy(gt_polys),
                                            torch.from_numpy(gt_cls), OH, OW, label_scale=2.0,
                                            res_divisor=res_divisor, max_masks=5)
        np.testing.assert_allclose(t_iou.numpy(), np.asarray(j_iou), atol=1e-6, rtol=0)
        assert float(t_iou.max()) > 0.05          # some instances overlap
        np.testing.assert_array_equal(t_pv.numpy(), np.asarray(j_pv))
        np.testing.assert_array_equal(t_gv.numpy(), np.asarray(j_gv))
    from instance_segmentation_tpu.utils.meters import APMeter as JMeter
    from instance_segmentation_torch.utils.meters import APMeter as TMeter
    meters = []
    for meter_cls, match in ((JMeter, jiou.match_and_score), (TMeter, tiou.match_and_score)):
        m = meter_cls(3)
        match(t_iou.numpy(), t_pv.numpy(), t_gv.numpy(), tdets.classes[:, :5].numpy(),
              tdets.scores[:, :5].numpy(), gt_cls, 3, m, overlap=0.1)
        meters.append([m.class_ap(c) for c in range(3)])
    np.testing.assert_array_equal(meters[0], meters[1])


# ---------------------------------------------------------------------------
# eval_outputs against JAX, and the entry points
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from make_synthetic_cityscapes import generate
    base = tmp_path_factory.mktemp("eval")
    root = str(base / "data")
    generate(root, splits=(("train", 1), ("val", 3)), h=2 * H, w=2 * W, seed=5,
             instances=(2, 4))
    cfg = base / "cfg"
    cfg.mkdir()
    yaml.safe_dump(DECODE, open(cfg / "decode.yaml", "w"))
    json.dump(TRANS, open(cfg / "trans.json", "w"))
    return base, root


@pytest.fixture(scope="module")
def weights():
    model = JaxSeg(JaxCfg(num_classes=8, compound_coef=0))
    variables = random_flax_variables(model, jnp.zeros((1, H, W, 3), jnp.uint8),
                                      train=False, seed=11)
    head = variables["params"]["classifier"]["tower"]["head"]["pointwise"]["Conv_0"]
    head["bias"] = head["bias"] + np.float32(0.5)
    return model, variables


def _capture(monkeypatch, module, store):
    real = module.detections_to_json

    def record(dets, infos):
        store.append((dets, len(infos)))
        return real(dets, infos)
    monkeypatch.setattr(module, "detections_to_json", record)


def test_eval_outputs_matches_jax(tree, weights, monkeypatch, tmp_path):
    base, root = tree
    jmodel, variables = weights
    jstate = types.SimpleNamespace(params=variables["params"],
                                   batch_stats=variables["batch_stats"])
    tmodel = EfficientSeg(EfficientSegConfig(num_classes=8, compound_coef=0))
    load_flax_variables(tmodel, variables)
    jloader = jdata.get_dataloader(2, "cityscapes", root, "val",
                                   transforms=JTransforms(JConfiger(TRANS), "val"),
                                   max_instances=8, max_verts=16, num_workers=0)
    tloader = tdata.get_dataloader(2, "cityscapes", root, "val",
                                   transforms=TTransforms(TConfiger(TRANS), "val"),
                                   max_instances=8, max_verts=16)
    jcaught, tcaught = [], []
    _capture(monkeypatch, jel, jcaught)
    _capture(monkeypatch, tel, tcaught)
    jout, tout = tmp_path / "jax", tmp_path / "port"
    jout.mkdir()
    tout.mkdir()
    jel.eval_outputs(str(jout), jloader, jmodel, jstate, 0, JConfig(DECODE), JLogger(), (H, W))
    tel.eval_outputs(str(tout), tloader, tmodel, 0, TConfig(DECODE), TLogger(), (H, W))
    assert len(tcaught) == len(jcaught) == 2     # 3 images at batch 2; JAX pads the last
    for (tdets, n), (jdets, _) in zip(tcaught, jcaught):
        jdets = jd.Detections(*(np.asarray(a)[:n] for a in jdets))
        assert tdets.boxes.shape[0] == n
        assert_detections_match(tdets, jdets, angle_ties=True)
    tjson = json.load(open(tout / "0_dets.json"))
    jjson = json.load(open(jout / "0_dets.json"))
    assert json.load(open(tout / "0_infos.json")) == json.load(open(jout / "0_infos.json"))
    assert [sorted(d[0] for d in img) for img in tjson] == \
        [sorted(d[0] for d in img) for img in jjson]
    assert sum(len(img) for img in tjson) > 0
    # both AP implementations on the port's detections
    data_cfg = TConfig({"eval_dir": root, "save_dir": str(tout)})
    got = tel.evaluate_from_json(data_cfg, 0, str(tout), "cityscapes", TLogger(), 8)
    want = jel.evaluate_from_json(JConfig(data_cfg.to_dict()), 0, str(tout), "cityscapes",
                                  JLogger(), 8)
    _assert_ap_equal(got, want)
    # COCO scoring is ported (tests/test_torch_coco.py): this tree has no
    # COCO annotation file
    with pytest.raises(FileNotFoundError, match="instances.json"):
        tel.evaluate_from_json(data_cfg, 0, str(tout), "coco", TLogger(), 80)


def _write_checkpoint(model, path, epoch):
    torch.save({"model": model.state_dict(), "epoch": epoch, "best_ap": 0.0}, path)


def test_entry_points_on_cpu(tree, weights, tmp_path, capsys):
    base, root = tree
    _, variables = weights
    cfg = base / "cfg"
    model = EfficientSeg(EfficientSegConfig(num_classes=8, compound_coef=0))
    load_flax_variables(model, variables)
    ckpts = tmp_path / "ckpt"
    ckpts.mkdir()
    _write_checkpoint(model, ckpts / "efficient_weights_00000004.pth", 4)
    ev = {"data": {"eval_dir": root, "save_dir": str(tmp_path / "eval_out"),
                   "dataset": "cityscapes", "batch_size": 2, "input_size": [H, W],
                   "num_classes": -1, "subset": "val"},
          "seed": 1, "compound_coef": 0, "weights_path": None, "weights_dir": None,
          "decode_cfg_path": str(cfg / "decode.yaml"), "trans_cfg_path": str(cfg / "trans.json"),
          "tpu": {"compute_dtype": "float32", "input_size": [H, W]},
          "static": {"max_instances": 8, "max_vertices": 16, "max_points": 128}}
    yaml.safe_dump(ev, open(tmp_path / "eval.yaml", "w"))
    t_evaluate.main(["--cfg_path", str(tmp_path / "eval.yaml"), "--device", "cpu"])
    dets = json.load(open(tmp_path / "eval_out" / "0_dets.json"))
    assert len(dets) == 3
    ev["weights_dir"] = str(ckpts)
    yaml.safe_dump(ev, open(tmp_path / "eval_sweep.yaml", "w"))
    t_evaluate.main(["--cfg_path", str(tmp_path / "eval_sweep.yaml"), "--device", "cpu"])
    swept = json.load(open(tmp_path / "eval_out" / "4_dets.json"))
    assert sum(len(d) for d in swept) > 0          # the raised class bias
    out = capsys.readouterr().out
    assert "[0] AP=" in out and "[4] AP=" in out and "evaluating checkpoint" in out

    te = {"data": {"test_dir": os.path.join(root, "leftImg8bit", "val"), "test_image": None,
                   "save_dir": str(tmp_path / "test_out"), "dataset": "dir", "batch_size": 2,
                   "input_size": [H, W], "num_classes": 8},
          "seed": 1, "compound_coef": 0,
          "weights_path": str(ckpts / "efficient_weights_00000004.pth"),
          "decode_cfg_path": str(cfg / "decode.yaml"), "trans_cfg_path": str(cfg / "trans.json")}
    yaml.safe_dump(te, open(tmp_path / "test.yaml", "w"))
    t_test.main(["--cfg_path", str(tmp_path / "test.yaml"), "--device", "cpu"])
    frames = sorted(os.listdir(te["data"]["test_dir"] + "/synth"))
    outs = sorted(f for f in os.listdir(tmp_path / "test_out") if f.endswith(".png"))
    assert outs == frames
    drawn = 0
    for f in outs:
        frame = png.read_png(os.path.join(te["data"]["test_dir"], "synth", f))
        overlay = png.read_png(str(tmp_path / "test_out" / f))
        assert overlay.shape == frame.shape
        drawn += not np.array_equal(overlay, frame)
    assert drawn > 0
    one = os.path.join(te["data"]["test_dir"], "synth", frames[0])
    te["data"].update(test_image=one, save_dir=str(tmp_path / "one_out"))
    yaml.safe_dump(te, open(tmp_path / "test_one.yaml", "w"))
    t_test.main(["--cfg_path", str(tmp_path / "test_one.yaml"), "--device", "cpu"])
    np.testing.assert_array_equal(png.read_png(str(tmp_path / "one_out" / frames[0])),
                                  png.read_png(str(tmp_path / "test_out" / frames[0])))
    te["weights_path"] = str(ckpts / "efficient_weights_00000005.pth")
    yaml.safe_dump(te, open(tmp_path / "test_missing.yaml", "w"))
    with pytest.raises(FileNotFoundError, match="not a checkpoint"):
        t_test.main(["--cfg_path", str(tmp_path / "test_missing.yaml"), "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            t_evaluate.main(["--cfg_path", str(tmp_path / "eval.yaml")])


def test_official_results_meters_and_writers_equal_jax(tmp_path):
    """write_official_results (instance PNGs through utils/png.py, pred.txt),
    the meters, the TensorBoard writer and the logger against the JAX copies."""
    import cv2
    from instance_segmentation_tpu.utils import meters as jm
    from instance_segmentation_tpu.utils import tb_writer as jtb
    from instance_segmentation_torch.utils import meters as tm
    from instance_segmentation_torch.utils import tb_writer as ttb
    rng = np.random.default_rng(5)
    dets = [[[int(rng.integers(0, 8)), float(rng.uniform(0.3, 1)), [5.0, 5.0],
              _star(rng, 60, 40, 20).tolist()] for _ in range(4)] for _ in range(2)]
    infos = [[f"/x/leftImg8bit/val/c/img{i}_leftImg8bit.png", [90, 130]] for i in range(2)]
    for out, mod in ((tmp_path / "jax", jel), (tmp_path / "port", tel)):
        out.mkdir()
        assert mod.write_official_results(str(out), "cityscapes", dets, infos, 8) == 8
    jfiles = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*.*"))
    assert jfiles == sorted(p.relative_to(tmp_path / "port")
                            for p in (tmp_path / "port").rglob("*.*"))
    for f in jfiles:
        if f.suffix == ".txt":
            assert (tmp_path / "port" / f).read_text() == (tmp_path / "jax" / f).read_text()
        else:
            np.testing.assert_array_equal(
                cv2.imread(str(tmp_path / "port" / f), cv2.IMREAD_UNCHANGED),
                cv2.imread(str(tmp_path / "jax" / f), cv2.IMREAD_UNCHANGED))
    scores, hits = rng.uniform(0, 1, 40), rng.random(40) < 0.5
    meters = []
    for mod in (jm, tm):
        m = mod.APMeter(3)
        for i in range(40):
            m.add(i % 3, scores[i], bool(hits[i]))
        m.add_gt(0, 9)
        m.add_gt(1, 4)
        avg = mod.AverageMeter()
        for v in scores[:7]:
            avg.update(v, 2)
        meters.append((m.value(), m.value("11point"), m.class_ap(2), avg.avg))
    assert meters[0][:2] == meters[1][:2] and np.isnan(meters[1][2]) and \
        meters[0][3] == meters[1][3]
    assert ttb._scalar_event("loss", 0.25, 7, 123.5) == jtb._scalar_event("loss", 0.25, 7, 123.5)
    assert ttb._masked_crc(b"abc") == jtb._masked_crc(b"abc")
    log = TLogger(str(tmp_path / "log"), run_config=TConfig({"a": 1}))
    log.write("hello")
    log.scalar_summary("ap", 0.5, 3)
    log.close()
    lines = (tmp_path / "log" / "logs" / "metrics.jsonl").read_text().splitlines()
    assert json.loads(lines[0])["tag"] == "ap"
    assert "hello" in (tmp_path / "log" / "logs" / "log.txt").read_text()


def test_decode_cfg_from_reads_the_top_k_mode():
    """The decode YAML's ``exact_topk`` (absent: true, JAX's default; the JAX
    reader ignores it) reaches the DecodeConfig; anything but a boolean
    raises."""
    assert tel.decode_cfg_from(TConfig(DECODE)) == td.DecodeConfig(kp_th=2000)
    assert tel.decode_cfg_from(TConfig(DECODE)) == td.DecodeConfig(
        **{k: v for k, v in jel.decode_cfg_from(JConfig(DECODE)).__dict__.items()})
    approx = tel.decode_cfg_from(TConfig({**DECODE, "exact_topk": False}))
    assert approx == td.DecodeConfig(kp_th=2000, exact_topk=False)
    with pytest.raises(ValueError, match="exact_topk"):
        tel.decode_cfg_from(TConfig({**DECODE, "exact_topk": "false"}))
