"""The port's slice end to end on the CPU: a serve.Predictor (EfficientSeg-B0
at 128x256, float32, kp_th 2000) holding JAX-converted weights, against the
JAX model and decode on the same weights and frames; the port's import
boundary (no jax, flax, yaml, cv2, PIL or orbax); and each test file the card
runs imports where none of those can be imported, as on the machine with the
card (README: ``pytest --noconftest -m cuda``)."""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from instance_segmentation_tpu.models import EfficientSeg as JaxSeg
from instance_segmentation_tpu.models import EfficientSegConfig as JaxCfg
from instance_segmentation_tpu.models import generate_anchors as j_generate_anchors
from instance_segmentation_tpu.ops import decode as jd
from instance_segmentation_torch.models import EfficientSegConfig
from instance_segmentation_torch.ops import decode as td
from instance_segmentation_torch.serve import Predictor

from test_torch_decode import assert_detections_match
from test_torch_model import random_flax_variables

torch.set_num_threads(2)
H, W = 128, 256
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=2e-4, atol=2e-4)


def make_slice_case(exact_topk: bool = True):
    """(frames, the JAX forward's outputs, the JAX decode of them, a port
    Predictor on the same weights), both decodes at kp_th 2000 with
    ``exact_topk``."""
    cfg = JaxCfg(num_classes=8, compound_coef=0)
    model = JaxSeg(cfg)
    frames = np.random.default_rng(10).integers(0, 256, (2, H, W, 3), dtype=np.uint8)
    variables = random_flax_variables(model, jnp.asarray(frames), train=False, seed=11)
    # raise the class logits so that detections exist
    head = variables["params"]["classifier"]["tower"]["head"]["pointwise"]["Conv_0"]
    head["bias"] = head["bias"] + np.float32(0.5)
    outputs = jax.jit(lambda v, x: model.apply(v, x, train=False, packed_heads=False))(
        variables, jnp.asarray(frames))
    anchors = j_generate_anchors(H, W, pyramid_levels=cfg.pyramid_levels,
                                 anchor_scale=cfg.anchor_scale)
    dcfg = jd.DecodeConfig(kp_th=2000, exact_topk=exact_topk)
    dets = jax.jit(lambda o: jd.decode_output(o, jnp.asarray(anchors), 2 * H, 2 * W,
                                              2.0, dcfg))(outputs)
    pred = Predictor(EfficientSegConfig(num_classes=8, compound_coef=0),
                     td.DecodeConfig(kp_th=2000, exact_topk=exact_topk), variables,
                     torch.device("cpu"), orig_hw=(2 * H, 2 * W), scale=2.0)
    return frames, [np.array(o) for o in outputs], dets, pred


@pytest.fixture(scope="module")
def slice_case():
    return make_slice_case()


def test_predictor_model_matches_jax(slice_case):
    frames, outputs, _, pred = slice_case
    with torch.no_grad():
        got = pred.model(torch.from_numpy(frames))
    for g, w in zip(got, outputs):
        np.testing.assert_allclose(g.numpy(), w, **TOL)


def test_decode_of_jax_head_maps_matches_jax(slice_case):
    """Random-weight maps scatter each object's members, so some lattice
    points lie on one ray from the internal point: those may swap places."""
    _, outputs, dets, pred = slice_case
    got = td.decode_output(tuple(torch.from_numpy(o) for o in outputs), pred.anchors,
                           2 * H, 2 * W, 2.0, pred.decode_cfg)
    assert_detections_match(got, dets, angle_ties=True)
    assert int(got.det_valid.sum()) > 0 and int(got.obj_valid.sum()) > 0


def test_predictor_answers_requests(slice_case):
    frames, _, dets, pred = slice_case
    got = pred.predict(frames)
    assert tuple(got.boxes.shape) == (2, 96, 4)
    assert tuple(got.polygons.shape) == (2, 96, 1024, 2)
    assert got.classes.dtype == got.poly_len.dtype == torch.int32
    for t in (got.boxes, got.scores, got.polygons, got.centers):
        assert bool(torch.isfinite(t).all())
    # the model agrees with JAX to 2e-4, so the detections it keeps do too
    np.testing.assert_array_equal(got.det_valid.sum(1).numpy(),
                                  np.asarray(dets.det_valid).sum(1))
    one = pred.predict(frames[1:])
    assert torch.equal(one.det_valid[0], got.det_valid[1])
    with pytest.raises(ValueError, match="uint8"):
        pred.predict(frames.astype(np.float32))
    with pytest.raises(ValueError, match="uint8"):
        pred.predict(frames[:, :64])


def test_port_imports_no_jax_flax_yaml_or_cv2():
    """Every module of the port and the entry points import none of jax,
    flax, yaml, cv2, PIL, orbax or the JAX package."""
    prog = (
        "import sys\n"
        "import instance_segmentation_torch.serve, instance_segmentation_torch.device\n"
        "import instance_segmentation_torch.kernels.build\n"
        "import instance_segmentation_torch.training.train_step, instance_segmentation_torch.losses\n"
        "import instance_segmentation_torch.kernels.rasterize, instance_segmentation_torch.kernels.ae_terms\n"
        "import instance_segmentation_torch.kernels.minr2, instance_segmentation_torch.tools.fullres_demo\n"
        "import instance_segmentation_torch.ops.targets, instance_segmentation_torch.weights\n"
        "import instance_segmentation_torch.evaluate, instance_segmentation_torch.test\n"
        "import instance_segmentation_torch.train\n"
        "import instance_segmentation_torch.configs, instance_segmentation_torch.data\n"
        "import instance_segmentation_torch.data.packed_dataset\n"
        "import instance_segmentation_torch.transforms, instance_segmentation_torch.evaluation\n"
        "import instance_segmentation_torch.evaluation.device_iou\n"
        "import instance_segmentation_torch.utils.png, instance_segmentation_torch.utils.image\n"
        "import instance_segmentation_torch.utils.jpeg\n"
        "import instance_segmentation_torch.utils.visualize, instance_segmentation_torch.utils.meters\n"
        "import instance_segmentation_torch.utils.logger, instance_segmentation_torch.utils.checkpoint\n"
        "import instance_segmentation_torch.tools.make_synthetic_cityscapes\n"
        "import instance_segmentation_torch.tools.make_synthetic_coco\n"
        "import instance_segmentation_torch.tools.preprocess_cityscapes\n"
        "import instance_segmentation_torch.tools.profile_infer\n"
        "import instance_segmentation_torch.tools.profile_decode\n"
        "import instance_segmentation_torch.tools.profile_infer_blocks\n"
        "import instance_segmentation_torch.tools.profile_blocks\n"
        "import instance_segmentation_torch.tools.bench_train_data\n"
        "import instance_segmentation_torch.tools.multichip, instance_segmentation_torch.tools.roofline\n"
        "import instance_segmentation_torch.tools.export_model\n"
        "import instance_segmentation_torch.tools.overfit_demo\n"
        "import instance_segmentation_torch.tools.convert_polygon\n"
        "import instance_segmentation_torch.tools.jpeg_digests\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'yaml', 'cv2', 'PIL',\n"
        "                                    'orbax', 'instance_segmentation_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True,
                       cwd=REPO, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-2000:]


CARD_FILES = ("test_torch_affinity", "test_torch_nms", "test_torch_losses", "test_torch_minr2",
              "test_torch_quant", "test_torch_serve_graph", "test_torch_on_card",
              "test_torch_bn_act")


@pytest.mark.parametrize("name", CARD_FILES)
def test_card_file_imports_without_jax(name):
    """The file imports in a process where jax, flax, the JAX package,
    PyYAML, OpenCV and PIL cannot be imported, from the test directory and
    the repository as ``pytest --noconftest`` finds them."""
    prog = (
        "import sys\n"
        "class Absent:\n"
        "    def find_spec(self, fullname, path=None, target=None):\n"
        "        if fullname.split('.')[0] in ('jax', 'jaxlib', 'flax', 'yaml', 'cv2', 'PIL',\n"
        "                                      'instance_segmentation_tpu'):\n"
        "            raise ImportError(f'no module named {fullname!r} on the card machine')\n"
        "sys.meta_path.insert(0, Absent())\n"
        f"import {name}\n"
        "print('ok')\n")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([os.path.join(REPO, "tests"), REPO])}
    r = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True,
                       cwd=REPO, env=env, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-2000:]
