"""The port on the CUDA card, module by module: what no kernel file holds.

Every test is marked ``cuda`` and skips without a card. The machine with
the card has no JAX, so this file imports none of it, and the card runs it
with the kernel files (README):

    python -m pytest --noconftest -m cuda tests/test_torch_on_card.py

- decode: the two-square scene decoded on the card (K1) as on the CPU, with
  the exact and the value-ordered top-k; the top-k forms and
  ``select_peaks_batch`` card == CPU; ``decode_centers``; the kmeans decode,
  each Lloyd step replayed on the CPU from the card's state; the dense kp
  target and its focal loss; a coef-8 ``Predictor`` launching K1 once a
  request;
- training: one B3 bf16 step at the d3-train-b8 cell through K2-K5 with
  finite losses; the float32 B0 step against the CPU on both (cnt, r2)
  routes; the full-resolution step through K6, K3, K4 and K5, never K2;
- ranks: two ranks on the one card over gloo (``tools/multichip``'s
  ``--check`` and ``--infer --check``) against one rank;
- entry points: the evaluate, test and train CLIs at the CPU tests' small
  configs on a Cityscapes and a COCO tree; ``iou_matrix``; an exported
  program; ``tools/roofline --eval``;
- host helpers built on the card's machine against their numpy twins and
  the committed JPEG digests.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from instance_segmentation_torch import evaluate as evaluate_cli
from instance_segmentation_torch import test as test_cli
from instance_segmentation_torch import train as train_cli
from instance_segmentation_torch.configs import Config, load_trans_config
from instance_segmentation_torch.data import get_dataloader
from instance_segmentation_torch.evaluation import device_iou
from instance_segmentation_torch.kernels import ae_terms, affinity, minr2, rasterize
from instance_segmentation_torch.losses import losses
from instance_segmentation_torch.models import EfficientSegConfig, generate_anchors
from instance_segmentation_torch.models.efficientseg import INPUT_SIZES
from instance_segmentation_torch.models.layers import BatchNorm
from instance_segmentation_torch.ops import decode
from instance_segmentation_torch.ops import kmeans as kmeans_ops
from instance_segmentation_torch.ops.decode import DecodeConfig, decode_output
from instance_segmentation_torch.ops.targets import generate_targets
from instance_segmentation_torch.parallel import multihost
from instance_segmentation_torch.serve import Predictor
from instance_segmentation_torch.tools import (
    export_model, fullres_demo, jpeg_digests, make_synthetic_cityscapes, make_synthetic_coco,
    multichip,
)
from instance_segmentation_torch.training import train_step
from instance_segmentation_torch.training.synthetic import bench_train_batch
from instance_segmentation_torch.training.train_step import Trainer
from instance_segmentation_torch.transforms import CommonTransforms
from instance_segmentation_torch.utils import image as image_utils
from instance_segmentation_torch.utils import jpeg, png

from torch_cases import SCENE_DECODE, TRAIN_SHAPE, against_cpu_twin, synthetic_scene, yaml_text
from torch_cases import cuda_device  # noqa: F401 (a fixture)

pytestmark = pytest.mark.cuda
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_KERNELS = {"rasterize_cnt_r2": rasterize, "rasterize_nmap": rasterize,
                 "ae_terms_fwd": ae_terms, "ae_terms_bwd": ae_terms, "minr2_from_cnt": minr2}


def _cpu(dets):
    return type(dets)(*(t.cpu() for t in dets))


def _zero_launches():
    for name, module in TRAIN_KERNELS.items():
        module.launches[name] = 0
    affinity.launches = 0


def _launches() -> dict:
    return {name: module.launches[name] for name, module in TRAIN_KERNELS.items()}


@torch.no_grad()
def eval_weights(model: torch.nn.Module, seed: int) -> None:
    """Seeded weights that decode instances, as the CPU tests' weights do
    (``tests/test_torch_model.random_flax_variables``): batch-norm scale and
    variance ~ U(0.5, 1.5), bias and mean ~ N(0, 0.1) over ``init_random``'s
    convolutions (whose identity batch norms decode no object), and the
    class logits' bias raised by 0.5."""
    g = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, BatchNorm):
            for t, draw in ((m.weight, "u"), (m.bias, "n"), (m.running_mean, "n"),
                            (m.running_var, "u")):
                t.copy_(0.5 + torch.rand(t.shape, generator=g) if draw == "u"
                        else 0.1 * torch.randn(t.shape, generator=g))
    model.classifier.header.pointwise_conv.conv.bias.add_(0.5)


def seeded_model(compound: int, num_classes: int, device: torch.device):
    """The evaluate CLI's seeded bf16 EfficientSeg with ``eval_weights``."""
    model = evaluate_cli.seeded_model(Config({"seed": 1, "compound_coef": compound}),
                                      num_classes, torch.device("cpu"))
    eval_weights(model, seed=1)
    return model.to(device)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("exact_topk", [True, False])
def test_two_square_scene_decodes_on_the_card_as_on_the_cpu(cuda_device, exact_topk):
    outputs, anchors = synthetic_scene(margin=0.5)
    h, w = outputs[0].shape[1:3]
    cfg = dataclasses.replace(SCENE_DECODE, exact_topk=exact_topk)

    def run(device):
        outs = tuple(torch.from_numpy(o).to(device) for o in outputs)
        return _cpu(decode_output(outs, torch.tensor(anchors, device=device), 2 * h, 2 * w,
                                  2.0, cfg))

    before = affinity.launches
    card = run(cuda_device)
    assert affinity.launches == before + 1
    cpu = run(torch.device("cpu"))
    for dets in (card, cpu):
        assert int(dets.obj_valid.sum()) == 2
        assert set(dets.classes[dets.obj_valid].tolist()) == {0, 1}
    for name, g, c in zip(card._fields, card, cpu):
        if g.dtype.is_floating_point:
            assert torch.allclose(g, c, rtol=1e-5, atol=1e-5), name
        else:
            assert torch.equal(g, c), name


def test_top_k_forms_and_peak_selection_on_the_card_equal_the_cpu(cuda_device):
    """A bf16-rounded b8 512x1024 keypoint map (many exact ties), k the
    serving decode's: the value-ordered top-k equals a stable descending
    sort of the monotonic keys and the CPU's; ``select_peaks_batch`` in both
    modes equals the CPU's."""
    rng = np.random.default_rng(0)
    kp = torch.from_numpy(rng.normal(-2.0, 2.0, (8, 512, 1024)).astype(np.float32))
    kp = kp.to(torch.bfloat16).float().to(cuda_device)
    flat = kp.reshape(kp.shape[0], -1)
    k = DecodeConfig().kp_th
    _, idx = decode.value_topk_indices(flat, k)
    _, by_sort = torch.sort(decode._monotonic_u32(flat), dim=1, descending=True, stable=True)
    assert torch.equal(idx, by_sort[:, :k])
    assert torch.equal(idx.cpu(), decode.value_topk_indices(flat.cpu(), k)[1])
    for exact in (False, True):
        card = decode.select_peaks_batch(kp, k, exact=exact)
        host = decode.select_peaks_batch(kp.cpu(), k, exact=exact)
        for a, b in zip(card, host):
            assert torch.equal(a.cpu(), b), exact


def test_decode_centers_on_the_card_equals_the_cpu(cuda_device):
    h, w, n_cls = 256, 512, 4
    rng = np.random.default_rng(6)
    conf = rng.uniform(-0.2, 1.0, (h, w)).astype(np.float32)
    conf[rng.uniform(size=(h, w)) < 0.3] = 0.0
    maps = (conf, rng.integers(0, n_cls, (h, w)).astype(np.int32),
            rng.uniform(2, 40, (h, w, 2)).astype(np.float32))
    card, host = ([t.cpu() for t in decode.decode_centers(
        *(torch.from_numpy(a).to(d) for a in maps), num_centers=2000, iou_th=0.5, max_out=96)]
        for d in (cuda_device, torch.device("cpu")))
    for name, g, c in zip(("centers", "classes", "confs", "whs", "valid"), card, host):
        assert torch.equal(g, c), name
    assert int(host[4].sum()) > 0


KMEANS_TIE = 1e-5


def _kmeans_mismatches(points, labels, want, centres) -> tuple:
    """(labels differing from ``want``, of which near-ties): points whose
    two labels' squared distances to ``centres`` (float64; the outlier
    label K at infinity) lie within KMEANS_TIE of each other, relative."""
    got, want = labels.long().cpu(), want.long().cpu()
    b, k = (got != want).nonzero(as_tuple=True)
    if b.numel() == 0:
        return 0, 0
    p = points.cpu().double()[b, k]
    c = centres.cpu().double()[b]
    d = ((p[:, None, :] - c) ** 2).sum(-1)
    d = torch.cat([d, torch.full_like(d[:, :1], math.inf)], dim=-1)
    da, db = d.gather(1, got[b, k][:, None])[:, 0], d.gather(1, want[b, k][:, None])[:, 0]
    near = (da - db).abs() <= KMEANS_TIE * db.abs().clamp(min=1e-3)
    return int(b.numel()), int(near.sum())


def test_kmeans_decode_on_the_card_follows_the_cpu(cuda_device, monkeypatch):
    """B3 bf16 512x1024 b2 outputs on seeded weights, decoded with kmeans
    grouping on the card and on the CPU: each Lloyd step replayed on the CPU
    from the card's own state (the labels from the card's centres after n
    steps, each centre update from the card's labels before it) differs only
    at near-ties and within 1e-5; the final labels differ on at most 1% of
    the valid keypoints (a flip carries over to later steps)."""
    model = seeded_model(3, 8, cuda_device)
    frames = np.random.default_rng(3).integers(0, 256, (2, 512, 1024, 3), dtype=np.uint8)
    anchors = generate_anchors(512, 1024, pyramid_levels=model.cfg.pyramid_levels,
                               anchor_scale=model.cfg.anchor_scale)
    dcfg = DecodeConfig(group_mode="kmeans")
    calls, real = [], decode.kmeans

    def capture(points, init, valid=None, **kwargs):
        labels, centres = real(points, init, valid=valid, **kwargs)
        calls.append((points, init, valid, labels, centres))
        return labels, centres
    monkeypatch.setattr(decode, "kmeans", capture)
    with torch.inference_mode():
        outputs = model(torch.from_numpy(frames).to(cuda_device))
        decode_output(outputs, torch.tensor(anchors, device=cuda_device), 1024, 2048, 2.0, dcfg)
        decode_output(tuple(o.cpu() for o in outputs), torch.tensor(anchors), 1024, 2048, 2.0,
                      dcfg)
    (points, init, valid, labels, _), cpu = calls
    n_valid = int(valid.sum())
    assert n_valid > 0
    diff = near = 0
    err, prev = 0.0, None
    valid_h, points_h, k = valid.cpu(), points.cpu(), init.shape[1]
    with torch.inference_mode():
        for n in range(dcfg.kmeans_iters + 1):
            step_labels, centres = real(points, init, valid=valid, num_iters=n)
            centres_h = centres.cpu()
            want = kmeans_ops.pairwise_distance(points_h, centres_h).argmin(-1)
            want = torch.where(valid_h, want, torch.full_like(want, k))
            d, nr = _kmeans_mismatches(points_h, step_labels, want, centres_h)
            diff, near = diff + d, near + nr
            if prev is not None:
                member = torch.nn.functional.one_hot(prev.clamp(max=k - 1).long(), k).float()
                member = member * valid_h[..., None].float()
                update = ((member.transpose(-1, -2) @ points_h)
                          / member.sum(-2).clamp(min=1.0)[..., None])
                err = max(err, float((update - centres_h).abs().max()))
            prev = step_labels.cpu()
    assert diff == near and err <= 1e-5, (diff, near, err)
    assert _kmeans_mismatches(cpu[0], labels, cpu[3], cpu[4])[0] <= n_valid // 100


def test_dense_kp_target_and_focal_loss_on_the_card_equal_the_cpu(cuda_device):
    """At the train cell (B=8, M=96, P=1024, 512x1024): the card's dense kp
    target equal to the CPU's bit for bit, ``kp_focal_loss`` to rtol 1e-5."""
    b, m, p, h, w = TRAIN_SHAPE
    labels = bench_train_batch(b, m, h, w, edge_cases=True)[1]
    kp = torch.from_numpy(np.random.default_rng(1).normal(-2, 2, (b, h, w)).astype(np.float32))
    card_t = generate_targets(*(torch.from_numpy(a).to(cuda_device) for a in labels), h, w,
                              max_points=p)
    host_t = generate_targets(*map(torch.from_numpy, labels), h, w, max_points=p)
    assert torch.equal(card_t.kp_tgt.cpu(), host_t.kp_tgt) and int(host_t.kp_tgt.sum()) > 0
    got = float(losses.kp_focal_loss(kp.to(cuda_device), card_t.kp_tgt))
    want = float(losses.kp_focal_loss(kp, host_t.kp_tgt))
    assert abs(got - want) <= 1e-5 * abs(want)


def test_coef_8_predictor_launches_k1_once_a_request(cuda_device):
    """EfficientSeg coef 8 (B7 backbone, P3-P8) in bf16 at 1536x1536, 80
    classes, seeded weights: two b1 requests, K1 once each, finite boxes."""
    size = INPUT_SIZES[8]
    pred = Predictor(EfficientSegConfig(num_classes=80, compound_coef=8,
                                        compute_dtype=torch.bfloat16),
                     DecodeConfig(), torch.Generator().manual_seed(0), cuda_device,
                     orig_hw=(size, size), scale=1.0)
    frames = np.random.default_rng(3).integers(0, 256, (2, size, size, 3), dtype=np.uint8)
    before = affinity.launches
    dets = [pred.predict(frames[i:i + 1]) for i in range(2)]
    torch.cuda.synchronize()
    assert affinity.launches == before + 2
    assert all(bool(torch.isfinite(d.boxes).all()) for d in dets)


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def test_d3_train_step_launches_k2_to_k5_once_with_finite_losses(cuda_device):
    """The d3-train-b8 cell's step (B3 bf16 over float32 weights, 512x1024,
    b8, M=96, P=1024, Adam 2e-5, seeded weights): after one warm-up step,
    two steps with finite losses, K2-K5 once a step and K6 never."""
    b, m, p, h, w = TRAIN_SHAPE
    cfg = EfficientSegConfig(num_classes=8, compound_coef=3, compute_dtype=torch.bfloat16)
    trainer = Trainer(cfg, torch.Generator().manual_seed(0), (h, w), max_points=p,
                      device=cuda_device)
    frames, labels = bench_train_batch(b, m, h, w)
    trainer.step(frames, *labels)
    _zero_launches()
    stats = [{k: float(v) for k, v in trainer.step(frames, *labels).items()} for _ in range(2)]
    torch.cuda.synchronize()
    assert all(math.isfinite(v) for s in stats for v in s.values()), stats
    assert _launches() == {name: 0 if name == "minr2_from_cnt" else 2 for name in TRAIN_KERNELS}


@pytest.mark.parametrize("p", [64, 60])
def test_float32_b0_step_on_the_card_equals_the_cpu(cuda_device, p):
    """One float32 B0 step at 128x512, batch 2, seeded weights and inputs:
    the card (kernels) against the CPU (twins), at P=64 through K2 and at
    P=60 (P % 8 != 0) through the count map and K6: the stats to rtol 1e-4,
    every gradient within 1e-3 of max|g|."""
    h, w, m = 128, 512, 8
    cfg = EfficientSegConfig(num_classes=8, compound_coef=0, drop_connect_rate=0.0)
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 256, (2, h, w, 3), dtype=np.uint8)
    polys = np.zeros((2, m, 8, 2), np.float32)
    ang = np.linspace(0, 2 * np.pi, 9)[:-1]
    for i in range(5):
        cy, cx = rng.uniform(25, h - 25), rng.uniform(60, w - 60)
        polys[0, i] = np.stack([cy + 15 * np.sin(ang), cx + 30 * np.cos(ang)], -1)
    polys[0, 5:] = polys[0, 0, 0]
    polys[1] = polys[0, ::-1]
    cls_ids = np.where(np.arange(m) < 5, np.arange(m) % 8, -1)[None].repeat(2, 0)
    cls_ids[1] = cls_ids[0, ::-1]
    labels = (polys, np.where(cls_ids >= 0, 8, 0), cls_ids)
    count_route = not losses.rasterizer_supported(h, w, p)
    grads, stats = [], []
    for device in (cuda_device, torch.device("cpu")):
        _zero_launches()
        trainer = Trainer(cfg, torch.Generator().manual_seed(0), (h, w), max_points=p,
                          device=device)
        stats.append({k: float(v) for k, v in trainer.compute_grads(frames, *labels).items()})
        grads.append({k: q.grad.cpu() for k, q in trainer.model.named_parameters()})
        if device == cuda_device:
            route = (rasterize.launches["rasterize_cnt_r2"], minr2.launches["minr2_from_cnt"])
    assert route == ((0, 1) if count_route else (1, 0))
    for k in stats[1]:
        assert np.isclose(stats[0][k], stats[1][k], rtol=1e-4, atol=0.0), k
    top = max(float(g.abs().max()) for g in grads[1].values())
    worst = max(float((grads[0][k] - g).abs().max()) for k, g in grads[1].items())
    assert worst <= 1e-3 * top


def test_fullres_step_takes_the_count_route(cuda_device):
    """``tools/fullres_demo`` at its defaults (B3 bf16, 1024x2048, b1, M=96,
    P=1024): a warm-up and one step with finite losses, K6, K3, K4 and K5
    once a step and K2 never."""
    _zero_launches()
    fullres_demo.run(fullres_demo.parse_args(["--iters", "1"]))
    assert _launches() == {name: 0 if name == "rasterize_cnt_r2" else 2 for name in TRAIN_KERNELS}


# ---------------------------------------------------------------------------
# Two ranks on the one card (gloo; NCCL refuses two ranks on one card)
# ---------------------------------------------------------------------------

def _two_ranks(tmp_path, argv) -> list:
    """``tools/multichip``'s ranks on the one card through ``multihost.spawn``
    (a rendezvous file, a timeout); their results, rank by rank."""
    multihost.spawn(multichip.spawned, 2,
                    (f"file://{tmp_path}/rendezvous", list(argv), str(tmp_path), True),
                    timeout=300.0)
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2)]


def test_two_ranks_match_one_rank_and_resume_on_the_card(cuda_device, tmp_path):
    """``multichip --check``: B0 float32 at 128x512, global batch 4, at P=64
    and P=60, the 2-rank step against the 1-rank step (its bounds), then a
    checkpoint saved by rank 0 and restored on both."""
    for r in _two_ranks(tmp_path, ["--check", "--device-type", "cuda", "--backend", "gloo"]):
        assert not r["failures"], r["failures"]
        assert [c["p"] for c in r["cases"]] == [64, 60]


def test_spatial_ranks_decode_as_one_rank_on_the_card(cuda_device, tmp_path):
    """``multichip --infer --check``: data 1 x spatial 2, B0 float32 at
    128x256: the gathered outputs and the decode against the one-rank
    forward and decode, K1 once a decoded batch, both ranks' detections
    equal, and K1 on rank 0's gathered maps equal to its CPU twin."""
    ranks = _two_ranks(tmp_path, ["--infer", "--check", "--device-type", "cuda",
                                  "--backend", "gloo"])
    for r in ranks:
        assert not r["failures"], r["failures"]
        assert r["objects"] > 0
    assert all(torch.equal(a, b) for a, b in zip(ranks[0]["dets"], ranks[1]["dets"]))
    inputs = [t.to(cuda_device) for t in ranks[0]["k1_inputs"]]
    cmp = against_cpu_twin(*affinity.affinity_assign(*inputs), inputs)
    assert cmp["bad"] == 0 and cmp["best_ok"], cmp


# ---------------------------------------------------------------------------
# The entry points, at the CPU tests' small configs
# ---------------------------------------------------------------------------

H, W = 128, 256                              # the model's input; frames 2x on Cityscapes
DECODE = {"cls_th": 0.3, "iou_th": 0.2, "kp_th": 2000, "obj_pixel_th": 2, "wh_delta": 0.1,
          "alpha_ratio": 2, "draw_flag": False}
STATIC = {"max_instances": 8, "max_vertices": 16, "max_points": 128}
TRANS = {
    "cityscapes": {"train_trans": {"trans_seq": ["resize"], "resize": {"target_size": 2}},
                   "val_trans": {"trans_seq": ["resize"], "resize": {"target_size": 2}}},
    "coco": {"train_trans": {"trans_seq": ["random_resize", "random_hflip"],
                             "random_resize": {"ratio": 0.0, "target_size": [W, H]},
                             "random_hflip": {"ratio": 0.5, "swap_pair": []}},
             "val_trans": {"trans_seq": ["random_resize"],
                           "random_resize": {"ratio": 0.0, "target_size": [W, H]}}},
}
CLASSES = {"cityscapes": 8, "coco": 80}
CKPT = "weights/efficient_weights_00000000.pth"
VAL_FRAMES = 3


@pytest.fixture(scope="module", params=["cityscapes", "coco"])
def tree(request, tmp_path_factory):
    """(dataset, its synthetic tree, a directory of configs and a seeded B0
    checkpoint): Cityscapes frames at 256x512, COCO JPEG frames at 96x128;
    4 train and 3 val frames."""
    dataset = request.param
    base = tmp_path_factory.mktemp(dataset)
    root = str(base / "data")
    if dataset == "cityscapes":
        make_synthetic_cityscapes.generate(root, splits=(("train", 4), ("val", VAL_FRAMES)),
                                           h=2 * H, w=2 * W, seed=5, instances=(2, 4))
    else:
        make_synthetic_coco.generate(root, (("train", 4), ("val", VAL_FRAMES)), 96, 128, seed=4)
    (base / "trans.json").write_text(json.dumps(TRANS[dataset]))
    model = seeded_model(0, CLASSES[dataset], torch.device("cpu"))
    # saved as before epoch 0, so that the evaluate CLI writes 0_dets.json
    (base / "weights").mkdir()
    torch.save({"model": model.state_dict(), "epoch": -1, "best_ap": 0.0}, base / CKPT)
    return dataset, root, base


def _run(main, cfg: dict, path, device: torch.device) -> None:
    path.write_text(yaml_text(cfg))
    main(["--cfg_path", str(path), "--device", device.type])


def test_evaluate_and_test_clis_on_the_card(cuda_device, tree, tmp_path):
    """The evaluate CLI at b2 (COCO: affinity and kmeans grouping) writes
    detections for every frame, at least one, and launches K1 once a batch;
    K1 on its first batch equals its CPU twin. The test CLI writes an
    overlay of each frame's shape (COCO: a JPEG and three debug PNGs with
    ``draw_flag``), K1 once a batch."""
    dataset, root, base = tree
    batches = math.ceil(VAL_FRAMES / 2)
    common = {"seed": 1, "compound_coef": 0, "trans_cfg_path": str(base / "trans.json"),
              "weights_path": str(base / CKPT), "static": STATIC}
    for mode in (("affinity",) if dataset == "cityscapes" else ("affinity", "kmeans")):
        (tmp_path / f"decode_{mode}.yaml").write_text(yaml_text({**DECODE, "group_mode": mode}))
        out = tmp_path / f"eval_{mode}"
        cfg = {**common, "decode_cfg_path": str(tmp_path / f"decode_{mode}.yaml"),
               "weights_dir": None,
               "data": {"eval_dir": root, "save_dir": str(out), "dataset": dataset,
                        "batch_size": 2, "input_size": [H, W], "num_classes": -1,
                        "subset": "val"},
               "tpu": {"compute_dtype": "float32", "input_size": [H, W]}}
        affinity.launches = 0
        with multichip.first_k1_inputs() as grouped:
            _run(evaluate_cli.main, cfg, tmp_path / f"eval_{mode}.yaml", cuda_device)
        assert affinity.launches == batches, mode
        dets = json.loads((out / "0_dets.json").read_text())
        assert len(dets) == VAL_FRAMES and sum(len(d) for d in dets) >= 1, mode
        if dataset == "coco":
            results = json.loads((out / "0_coco_results.json").read_text())
            assert len(results) == sum(len(d) for d in dets)
        cmp = against_cpu_twin(*affinity.affinity_assign(*grouped), grouped)
        assert cmp["bad"] == 0 and cmp["best_ok"], cmp

    (tmp_path / "decode_draw.yaml").write_text(yaml_text({**DECODE, "draw_flag": True}))
    out = tmp_path / "test_out"
    frames_dir = (os.path.join(root, "leftImg8bit", "val") if dataset == "cityscapes"
                  else os.path.join(root, "val"))
    cfg = {**common, "decode_cfg_path": str(tmp_path / "decode_draw.yaml"),
           "data": {"test_dir": frames_dir, "test_image": None, "save_dir": str(out),
                    "dataset": "dir", "batch_size": 2, "input_size": [H, W],
                    "num_classes": CLASSES[dataset]}}
    affinity.launches = 0
    _run(test_cli.main, cfg, tmp_path / "test.yaml", cuda_device)
    assert affinity.launches == batches
    read, suffix = (png.read_png, ".png") if dataset == "cityscapes" else (jpeg.read_jpeg, ".jpg")
    for dirpath, _, names in os.walk(frames_dir):
        for name in sorted(n for n in names if n.endswith(suffix)):
            shape = read(os.path.join(dirpath, name)).shape
            assert read(str(out / name)).shape == shape
            for kind in ("box", "candid", "instances"):
                assert png.read_png(str(out / f"{name[:-4]}_{kind}.png")).shape == shape


def test_train_cli_on_the_card(cuda_device, tree, tmp_path, monkeypatch):
    """The train CLI, B0 float32 at 128x256, b2 from 2 data workers, one
    epoch of 2 steps with finite losses, then the in-loop eval: K2-K5 once a
    step, K6 never, K1 once an eval batch; the epoch's checkpoint (COCO: and
    its results file)."""
    dataset, root, base = tree
    stats, real = [], train_step.Trainer.step

    def step(self, *args):
        out = real(self, *args)
        stats.append({k: float(v) for k, v in out.items()})
        return out
    monkeypatch.setattr(train_step.Trainer, "step", step)
    (tmp_path / "decode.yaml").write_text(yaml_text(DECODE))
    save = tmp_path / "train"
    cfg = {"data": {"train_dir": root, "eval_dir": root, "save_dir": str(save),
                    "dataset": dataset, "batch_size": 2, "num_classes": -1, "num_workers": 2},
           "optimizer": {"lr": "2e-5", "type": "Adam", "momentum": 0.9},
           "max_iter": 2, "num_epochs": 1, "save_span": 1000, "seed": 1, "compound_coef": 0,
           "anchors_scales": "[2 ** 0, 2 ** (1.0 / 3.0), 2 ** (2.0 / 3.0)]",
           "anchors_ratios": "[(1.0, 1.0), (1.4, 0.7), (0.7, 1.4)]",
           "pretrained_path": None, "decode_cfg_path": str(tmp_path / "decode.yaml"),
           "trans_cfg_path": str(base / "trans.json"), "start_eval_epoch": 0,
           "tpu": {"compute_dtype": "float32", "remat": False, "input_size": [H, W]},
           "static": STATIC}
    _zero_launches()
    _run(train_cli.main, cfg, tmp_path / "train.yaml", cuda_device)
    assert len(stats) == 2 and all(math.isfinite(v) for s in stats for v in s.values()), stats
    assert _launches() == {name: 0 if name == "minr2_from_cnt" else 2 for name in TRAIN_KERNELS}
    assert affinity.launches == math.ceil(VAL_FRAMES / 2)
    assert (save / "efficient_weights_00000000.pth").exists()
    assert (save / ("0_coco_results.json" if dataset == "coco" else "0_dets.json")).exists()


@pytest.mark.parametrize("tree", ["cityscapes"], indirect=True)
def test_iou_matrix_on_the_card_equals_the_cpu(cuda_device, tree):
    """The seeded B0's decode of a b2 Cityscapes val batch against its
    ground truth: the IoUs within 1e-6 of the CPU's, the masks equal."""
    dataset, root, base = tree
    model = seeded_model(0, 8, cuda_device)
    model.load_state_dict(torch.load(base / CKPT, weights_only=True)["model"])
    loader = get_dataloader(2, dataset, root, "val", max_instances=8, max_verts=16,
                            transforms=CommonTransforms(load_trans_config(
                                str(base / "trans.json")), "val"))
    images, packed, _ = next(iter(loader))
    anchors = torch.tensor(generate_anchors(H, W, pyramid_levels=model.cfg.pyramid_levels,
                                            anchor_scale=model.cfg.anchor_scale),
                           device=cuda_device)
    with torch.inference_mode():
        dets = decode.forward_and_decode(model, torch.from_numpy(images).to(cuda_device),
                                         anchors, 2 * H, 2 * W, 2.0,
                                         DecodeConfig(kp_th=DECODE["kp_th"]))
    gt_polys, gt_cls = (torch.from_numpy(a) for a in (packed.polys, packed.cls_ids))
    card = device_iou.iou_matrix(dets, gt_polys.to(cuda_device), gt_cls.to(cuda_device),
                                 2 * H, 2 * W)
    cpu = device_iou.iou_matrix(_cpu(dets), gt_polys, gt_cls, 2 * H, 2 * W)
    assert float((card[0].cpu() - cpu[0]).abs().max()) <= 1e-6
    assert all(torch.equal(a.cpu(), b) for a, b in zip(card[1:], cpu[1:]))
    assert float(cpu[0].max()) > 0


def test_exported_program_equals_the_live_model_and_the_predictor(cuda_device, tmp_path):
    """``tools/export_model`` at B0 bf16 128x256 b1 on the card: saved,
    loaded, equal to the live model and to a ``Predictor`` on the same
    seeded weights; K1 once a call of the program."""
    program, live, example = export_model.build_export(0, (H, W), 1, 8, device=cuda_device)
    torch.export.save(program, str(tmp_path / "b0.pt2"))
    loaded = export_model.load(str(tmp_path / "b0.pt2"))
    export_model.verify(loaded, live, example)
    before = affinity.launches
    with torch.no_grad():
        got = loaded.module()(example)
    torch.cuda.synchronize()
    assert affinity.launches == before + 1
    pred = Predictor(EfficientSegConfig(num_classes=8, compound_coef=0,
                                        compute_dtype=torch.bfloat16),
                     DecodeConfig(), torch.Generator().manual_seed(0), cuda_device,
                     orig_hw=(2 * H, 2 * W), scale=2.0)
    dets = pred.predict(example)
    want = (dets.classes, dets.scores, dets.centers, dets.polygons, dets.poly_len,
            dets.obj_valid)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_roofline_eval_joins_the_device_time_and_the_decode_kernels(cuda_device):
    """``tools/roofline --eval`` (B3 bf16 512x1024 b8, forward and decode),
    in a process of its own: at least 90% of the device's kernel time joined
    to counted operations; K1, the NMS kernel and the batch-norm kernel
    launched, with the bytes ``kernels/bounds.py`` gives them, the last once
    a batch norm or gate of the forward."""
    out = subprocess.run(
        [sys.executable, "-m", "instance_segmentation_torch.tools.roofline", "--eval",
         "--batch", "8", "--by", "block", "--iters", "5", "--top", "5"],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["matched_share"] is not None and rec["matched_share"] >= 0.9, rec["matched_share"]
    for name in ("affinity_assign", "nms_keep", "bn_act"):
        k = rec["kernels"].get(name)
        assert (k is not None and k["launches"] > 0 and k["calls"] > 0
                and len(k["bytes"]) == k["calls"] and min(k["bytes"]) > 0), (name, k)
    assert rec["kernels"]["bn_act"]["launches"] == rec["kernels"]["bn_act"]["calls"] == 181 + 26
    assert all(rec[key] is not None for key in ("model_flops", "mfu", "bound_ms", "busy_ms"))


# ---------------------------------------------------------------------------
# Host helpers built on this machine
# ---------------------------------------------------------------------------

def test_host_helpers_built_here_equal_their_twins(cuda_device):
    """The C helpers of the data path, built by this machine's compiler:
    the PNG row unfilter equal to its numpy twin on streams of all five
    filter types at 1-4 bytes a pixel; the affine warp equal to its numpy
    twin on a 512x1024x3 frame; the JPEG codec's bytes and pixels equal to
    the committed digests of OpenCV's."""
    rng = np.random.default_rng(13)
    for bpp in (1, 2, 3, 4):
        h, w = 67, 129
        y, x = np.mgrid[0:h, 0:w * bpp]
        img = ((x * 3 + y * 5) % 256 + rng.integers(0, 16, (h, w * bpp))).astype(np.uint8)
        types = rng.integers(0, 5, h)
        types[:5] = np.arange(5)
        stream = png.filter_rows(img, bpp, types).reshape(-1)
        native = png.unfilter_native(stream, h, w * bpp, bpp)
        assert np.array_equal(native, png.unfilter_numpy(stream, h, w * bpp, bpp))
        assert np.array_equal(native, img)
    frame = rng.integers(0, 256, (512, 1024, 3), dtype=np.uint8)
    mat = image_utils.rotation_matrix_2d((512.0, 256.0), 5.0, 1.0)
    assert np.array_equal(image_utils.warp_affine_linear(frame, mat, (1024, 512), (104, 117, 123)),
                          image_utils.warp_affine_linear_numpy(frame, mat, (1024, 512),
                                                               (104, 117, 123)))
    bad = [r["case"] for r in jpeg_digests.check() if not (r["bytes_ok"] and r["pixels_ok"])]
    assert not bad
