"""The port's MaxViT backbone (``models/maxvit.py``) against the plain
reference of ``benchmark/reference/maxvit.py`` and ``efficientseg_maxvit.py``
on the CPU, with the seeded tree of ``benchmark/reference/weights_maxvit.py``:

* a tiny MaxViT (head dim 8, P = 4, one block a stage, 128x256 frames: P
  divides the last stage's 4x8 map) standing in for MaxViT-B's table in the
  port and the reference alike: the backbone's snapshots, the five eval
  heads and the detections, in float32 and bfloat16, and every gradient of
  a train-mode loss;
* each partition's round trip, the grid grouping and the bias gather equal
  to their definitions;
* MaxViT-B's parameter count on the meta device against the configuration
  file's and the paper's;
* the ``backbone: maxvit-b`` key through the YAML layer; the int8 path, the
  spatial mesh and a frame P does not divide raising; the spans.

The port and the reference run the same operations in the same order, so
they agree bit for bit; ``REL`` (1e-6 of the largest magnitude) allows only
for a reduction summed in another order.
"""

import functools
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import compare
from benchmark.reference import decode as ref_decode
from benchmark.reference import efficientseg_maxvit as ref_seg
from benchmark.reference import maxvit as ref_maxvit
from benchmark.reference.losses import LossConfig as RefLossConfig, compose_loss as ref_loss
from benchmark.reference.targets import generate_targets as ref_targets
from benchmark.reference.weights_maxvit import load_flax_variables as ref_load, seeded_tree

from instance_segmentation_torch.configs import Config
from instance_segmentation_torch.evaluate import seeded_model
from instance_segmentation_torch.losses import LossConfig, compose_loss
from instance_segmentation_torch.models import EfficientSeg, EfficientSegConfig, generate_anchors
from instance_segmentation_torch.models import maxvit
from instance_segmentation_torch.ops.decode import DecodeConfig, decode_output
from instance_segmentation_torch.ops.targets import generate_targets
from instance_segmentation_torch.parallel import spatial
from instance_segmentation_torch.parallel.mesh import Mesh
from instance_segmentation_torch.training.synthetic import bench_train_batch
from instance_segmentation_torch.weights import (
    export_flax_variables, init_random, load_flax_variables,
)

CPU = torch.device("cpu")
REL = 1e-6
H, W = 128, 256
TINY = dict(stem=16, depths=(1, 1, 1, 1), channels=(16, 32, 48, 64), head_dim=8, partition=4)
CONFIG = Path(__file__).resolve().parents[1] / "benchmark/configs/effseg-maxvitb-cityscapes.json"
DECODE = dict(kp_th=2000)


@pytest.fixture(autouse=True)
def tiny_tables(monkeypatch):
    """The tiny MaxViT in MaxViT-B's place, in the port and the reference."""
    monkeypatch.setitem(maxvit.TABLES, "maxvit-b", maxvit.MaxViTArgs(**TINY))
    monkeypatch.setitem(ref_maxvit.TABLES, "maxvit-b", ref_maxvit.MaxViTArgs(**TINY))


def _close(got: torch.Tensor, want: torch.Tensor, rel: float = REL) -> None:
    assert got.shape == want.shape and got.dtype == want.dtype
    torch.testing.assert_close(got, want, rtol=0, atol=rel * float(want.abs().max()))


def _frames(batch: int = 1, seed: int = 0) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 255, (batch, H, W, 3), dtype=np.uint8))


@functools.lru_cache(maxsize=None)
def _tree():
    with torch.device("meta"):
        shape = ref_seg.EfficientSeg(ref_seg.EfficientSegConfig(num_classes=8, compound_coef=0))
    return seeded_tree(shape, 2 ** 36 + 11, CPU)


def _pair(dtype=torch.float32, param_dtype=None):
    """(port, reference) of the tiny EfficientSeg (B0 neck) on the seeded tree."""
    tree = _tree()
    ref = ref_seg.EfficientSeg(ref_seg.EfficientSegConfig(num_classes=8, compound_coef=0,
                                                          compute_dtype=dtype), param_dtype)
    port = EfficientSeg(EfficientSegConfig(num_classes=8, compound_coef=0, compute_dtype=dtype,
                                           backbone="maxvit-b"), param_dtype)
    assert load_flax_variables(port, tree) == ref_load(ref, tree)
    return port, ref


def test_backbone_snapshots_equal_the_reference():
    port, ref = _pair()
    x = port.input_tensor(_frames(2))
    with torch.no_grad():
        got, want = port.backbone_net["model"](x), ref.backbone_net["model"](x)
    assert [t.shape[1] for t in got] == [16, 16, 32, 48, 64]
    assert [t.shape[-1] for t in got] == [W // 2, W // 4, W // 8, W // 16, W // 32]
    for g, r in zip(got, want):
        _close(g, r)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_eval_heads_and_detections_equal_the_reference(dtype):
    port, ref = _pair(dtype)
    frames = _frames(1, seed=3)
    with torch.no_grad():
        heads, ref_heads = port(frames), ref(frames)
    for g, r in zip(heads, ref_heads):
        _close(g, r)
    anchors = generate_anchors(H, W, pyramid_levels=port.cfg.pyramid_levels)
    dets = decode_output(heads, torch.tensor(anchors), 2 * H, 2 * W, 2.0, DecodeConfig(**DECODE))
    want = ref_decode.decode_output(ref_heads, torch.tensor(anchors), 2 * H, 2 * W, 2.0,
                                    ref_decode.DecodeConfig(**DECODE))
    assert int(dets.det_valid.sum()) > 0
    assert compare.dets_mismatch(dets, want) == 0


def test_training_gradients_equal_the_reference():
    """A training forward (batch statistics, drop-connect on all five residual
    branches from equally seeded generators), the port's loss and the
    reference's, and every parameter's gradient (bias tables included)."""
    port, ref = _pair(param_dtype=torch.float32)
    frames, (polys, n_verts, cls_ids) = bench_train_batch(2, 8, H, W, seed=2 ** 31 + 3,
                                                          n_real=3)
    anchors = torch.tensor(generate_anchors(H, W, pyramid_levels=port.cfg.pyramid_levels))
    polys, n_verts, cls_ids = (torch.as_tensor(polys), torch.as_tensor(n_verts),
                               torch.as_tensor(cls_ids))
    losses = []
    for net, targets_fn, loss_fn, loss_cfg in (
            (port, generate_targets, compose_loss, LossConfig()),
            (ref, ref_targets, ref_loss, RefLossConfig())):
        net.train()
        net.backbone_net["model"].generator = torch.Generator().manual_seed(13)
        targets = targets_fn(polys, n_verts, cls_ids, H, W, max_points=64, dense_kp=False)
        total, _ = loss_fn(net(torch.as_tensor(frames)), targets, anchors, loss_cfg)
        total.backward()
        losses.append(float(total.detach()))
    assert losses[0] == pytest.approx(losses[1], rel=1e-6)
    ref_params = dict(ref.named_parameters())
    tables = 0
    for name, p in port.named_parameters():
        _close(p.grad, ref_params[name].grad, rel=1e-5)
        tables += name.endswith("rel_bias") and float(p.grad.abs().max()) > 0
    assert tables == 8


@pytest.mark.parametrize("kind", ["block", "grid"])
def test_partitions_round_trip_and_group_as_defined(kind):
    b, h, w, c, p = 2, 8, 12, 3, 4
    x = torch.arange(b * h * w * c, dtype=torch.float32).reshape(b, h, w, c)
    split, merge = maxvit.PARTITIONS[kind]
    t = split(x, p)
    assert t.shape == (b * (h // p) * (w // p), p * p, c)
    assert torch.equal(merge(t, b, h, w, p), x)
    assert torch.equal(t, ref_maxvit.group_tokens(x, p, kind))
    for n in range(b):
        for a in range(h // p):
            for bb in range(w // p):
                group = t[(n * (h // p) + a) * (w // p) + bb]
                for i in range(p):
                    for j in range(p):
                        row, col = ((a * p + i, bb * p + j) if kind == "block"
                                    else (i * (h // p) + a, j * (w // p) + bb))
                        assert torch.equal(group[i * p + j], x[n, row, col])


def test_bias_gather_equals_the_tables_definition():
    p, heads = 3, 2
    attn = maxvit.RelativeAttention(16, 8, p, "block")
    init_random(attn, torch.Generator().manual_seed(4))
    table = attn.rel_bias.detach()
    got = attn.bias(torch.float32).detach()
    assert got.shape == (heads, p * p, p * p)
    for y1 in range(p):
        for x1 in range(p):
            for y2 in range(p):
                for x2 in range(p):
                    want = table[:, y1 - y2 + p - 1, x1 - x2 + p - 1]
                    assert torch.equal(got[:, y1 * p + x1, y2 * p + x2], want)
    assert torch.equal(got, ref_maxvit.relative_bias(table))


def test_maxvit_b_parameter_count(monkeypatch):
    """MaxViT-B at its published widths: the configuration file's count, and
    within 2% of the paper's 120M less the classifier head (layer norm,
    768 x 768 pre-logits, 768 x 1000)."""
    monkeypatch.undo()
    config = json.loads(CONFIG.read_text())
    with torch.device("meta"):
        net = maxvit.MaxViTFeatures("maxvit-b")
        seg = EfficientSeg(EfficientSegConfig(num_classes=8, compound_coef=3,
                                              backbone="maxvit-b"))
    count = sum(p.numel() for p in net.parameters())
    assert count == config["backbone_parameters"]
    assert sum(p.numel() for p in seg.parameters()) == config["parameters"]
    head = 2 * 768 + 768 * 768 + 768 + 768 * 1000 + 1000
    assert abs(count - (120e6 - head)) < 0.02 * (120e6 - head)
    assert [len([b for b in net._blocks if b.block_attn.heads == c // 32])
            for c in (96, 192, 384, 768)] == [2, 6, 14, 2]


def test_seeded_tree_loads_into_both_and_init_random_covers_the_transformer():
    port, ref = _pair()
    fresh = EfficientSeg(port.cfg)
    init_random(fresh, torch.Generator().manual_seed(3))
    block = fresh.backbone_net["model"]._blocks[0]
    assert float(block.block_attn.qkv.weight.detach().std()) > 0
    assert float(block.grid_attn.rel_bias.detach().std()) > 0.5
    assert torch.equal(block.block_mlp.norm.weight, torch.ones(16))
    tree = export_flax_variables(fresh)
    assert tree["params"]["backbone"]["block0"]["grid_attn"]["qkv"]["kernel"].shape == (16, 48)
    assert ref_load(ref, tree) == load_flax_variables(port, tree)
    with torch.no_grad():
        for g, r in zip(port(_frames()), ref(_frames())):
            _close(g, r)


def test_config_and_forward_raise_where_maxvit_has_no_path():
    with pytest.raises(ValueError, match="no int8 path"):
        EfficientSegConfig(backbone="maxvit-b", quant="int8")
    with pytest.raises(ValueError, match="unknown backbone 'maxvit-l'.*maxvit-b"):
        EfficientSegConfig(backbone="maxvit-l")
    port, _ = _pair()
    with pytest.raises(ValueError, match="multiples of 128"):
        port.backbone_net["model"](torch.zeros(1, 3, 128, 192))
    mesh = Mesh(1, 2, 0, 0, None, None, CPU)
    with torch.no_grad(), spatial.sharded(mesh), pytest.raises(ValueError, match="spatial mesh"):
        port.backbone_net["model"](torch.zeros(1, 3, H, W // 2))


def test_spans_mark_the_sub_blocks():
    from torch.profiler import ProfilerActivity, profile
    port, _ = _pair()
    with profile(activities=[ProfilerActivity.CPU]) as prof, torch.no_grad():
        port.backbone_net["model"](port.input_tensor(_frames()))
    names = [e.name for e in prof.events()]
    assert {s: names.count(s) for s in ("backbone.mbconv", "backbone.block_attn",
                                        "backbone.grid_attn", "backbone.mlp")} == {
        "backbone.mbconv": 4, "backbone.block_attn": 4, "backbone.grid_attn": 4,
        "backbone.mlp": 8}


def test_backbone_key_through_yaml(tmp_path):
    (tmp_path / "cfg.yaml").write_text(
        "seed: 3\ncompound_coef: 0\nbackbone: maxvit-b\n"
        f"data:\n  save_dir: {tmp_path}\n  dataset: cityscapes\n  num_classes: -1\n"
        "tpu:\n  input_size: [128, 256]\n")
    model = seeded_model(Config(str(tmp_path / "cfg.yaml")), 8, CPU)
    assert model.cfg.backbone_name == "maxvit-b"
    assert isinstance(model.backbone_net["model"], maxvit.MaxViTFeatures)
    assert model.backbone_net["model"]._blocks[0].block_attn.qkv.weight.dtype == torch.bfloat16
    assert model.backbone_net["model"]._blocks[0].block_attn.rel_bias.dtype == torch.float32
    with torch.no_grad():
        heads = model(_frames())
    assert all(bool(torch.isfinite(t).all()) for t in heads)


def test_predictor_serves_the_reference_detections():
    """``serve.Predictor`` (the serving entry point; eager on the CPU) on the
    seeded tree: the reference's decode of the reference's bf16 heads."""
    from instance_segmentation_torch.serve import Predictor
    cfg = EfficientSegConfig(num_classes=8, compound_coef=0, compute_dtype=torch.bfloat16,
                             backbone="maxvit-b")
    pred = Predictor(cfg, DecodeConfig(**DECODE), _tree(), CPU, (2 * H, 2 * W), 2.0)
    _, ref = _pair(torch.bfloat16)
    frames = _frames(1, seed=6)
    with torch.no_grad():
        want = ref_decode.decode_output(ref(frames), pred.anchors, 2 * H, 2 * W, 2.0,
                                        ref_decode.DecodeConfig(**DECODE))
    dets = pred.predict(frames.numpy())
    assert int(dets.det_valid.sum()) > 0
    assert compare.dets_mismatch(dets, want) == 0
