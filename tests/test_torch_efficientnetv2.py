"""The port's EfficientNetV2 backbones (``models/efficientnet.py``: the V2-S/M/L
stage tables, ``FusedMBConv``) against the plain reference of
``benchmark/reference/efficientnetv2.py`` and ``efficientseg_backbone.py``
on the CPU in float32, with the seeded weights the benchmark makes:

* the tables' parameter counts against the published ones;
* every backbone snapshot, the five eval heads and the training loss's
  gradients against the reference;
* the seeded tree into both with no unmapped leaf, and ``init_random``
  covering the fused blocks;
* the ``backbone:`` key through the YAML config layer and the train and
  evaluate entry points, an unknown name raising;
* the ``backbone.fused`` / ``backbone.mbconv`` spans;
* the int8 path (the fused blocks' 1x1 project convs quantized) near the
  float forward, and the spatial (W-split) path on two gloo ranks equal to
  the one-rank forward.

The port and the reference run the same float32 operations in the same
order (the reference's layers are frozen copies of the port's), so they
agree bit for bit here; the tolerances below allow only for a reduction
summed in another order (``REL``: 1e-6 of the largest magnitude).
"""

import functools
import os

import numpy as np
import pytest
import torch

from benchmark.reference import efficientseg_backbone as ref_seg
from benchmark.reference.losses import LossConfig as RefLossConfig, compose_loss as ref_loss
from benchmark.reference.targets import generate_targets as ref_targets
from benchmark.reference.weights import load_flax_variables as ref_load, seeded_tree

from instance_segmentation_torch.configs import Config, load_trans_config
from instance_segmentation_torch.evaluate import seeded_model
from instance_segmentation_torch.losses import LossConfig, compose_loss
from instance_segmentation_torch.models import EfficientSeg, EfficientSegConfig, generate_anchors
from instance_segmentation_torch.models import efficientnet as effnet
from instance_segmentation_torch.ops.targets import generate_targets
from instance_segmentation_torch.parallel import multihost, spatial
from instance_segmentation_torch.parallel.mesh import MeshSpec, batch_shard, make_mesh
from instance_segmentation_torch.tools import multichip
from instance_segmentation_torch.training.synthetic import bench_train_batch
from instance_segmentation_torch.utils.checkpoint import load_pretrained_file
from instance_segmentation_torch.weights import (
    export_flax_variables, init_random, load_flax_variables,
)

CPU = torch.device("cpu")
REL = 1e-6
H, W = 128, 256
# timm's tf_efficientnetv2_{s,m,l}: the feature backbone, a 1x1 conv to 1280
# with batch norm, and a 1000-way classifier
PUBLISHED = {"efficientnetv2-s": 21_458_488, "efficientnetv2-m": 54_139_356,
             "efficientnetv2-l": 118_515_272}


def _close(got: torch.Tensor, want: torch.Tensor, rel: float = REL) -> None:
    assert got.shape == want.shape and got.dtype == want.dtype
    torch.testing.assert_close(got, want, rtol=0, atol=rel * float(want.abs().max()))


def _frames(batch: int = 1, seed: int = 0) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 255, (batch, H, W, 3), dtype=np.uint8))


@functools.lru_cache(maxsize=None)
def _pair(backbone: str):
    """(port, reference, tree) of EfficientSeg on the V2 backbone with the B0
    neck (compound_coef 0), float32, the benchmark's seeded tree."""
    cfg = ref_seg.EfficientSegConfig(num_classes=8, compound_coef=0, backbone=backbone)
    with torch.device("meta"):
        shape = ref_seg.EfficientSeg(cfg)
    tree = seeded_tree(shape, 2 ** 36 + 7, CPU)
    ref = ref_seg.EfficientSeg(cfg)
    ref_load(ref, tree)
    port = EfficientSeg(EfficientSegConfig(num_classes=8, compound_coef=0, backbone=backbone))
    load_flax_variables(port, tree)
    return port, ref, tree


@pytest.fixture(params=["efficientnetv2-s", "efficientnetv2-l"])
def pair(request):
    return _pair(request.param)


@pytest.fixture
def small():
    """V2-S, for the cases that run more than a forward."""
    return _pair("efficientnetv2-s")


@pytest.mark.parametrize("backbone", sorted(PUBLISHED))
def test_tables_count_the_published_parameters(backbone):
    with torch.device("meta"):
        net = effnet.EfficientNetFeatures(backbone)
    last = effnet.feature_channels(backbone)[-1]
    head = last * 1280 + 2 * 1280 + 1280 * 1000 + 1000
    assert sum(p.numel() for p in net.parameters()) + head == PUBLISHED[backbone]


def test_v2l_feature_backbone_parameters():
    with torch.device("meta"):
        net = effnet.EfficientNetFeatures("efficientnetv2-l")
    assert sum(p.numel() for p in net.parameters() if p.requires_grad) == 116_412_512
    assert effnet.feature_channels("efficientnetv2-l") == [32, 64, 96, 224, 640]
    kinds = [type(b).__name__ for b in net._blocks]
    assert kinds == ["FusedMBConv"] * 18 + ["MBConv"] * 61


def test_backbone_snapshots_equal_the_reference(pair):
    port, ref, _ = pair
    x = port.input_tensor(_frames(2))
    with torch.no_grad():
        got, want = port.backbone_net["model"](x), ref.backbone_net["model"](x)
    assert [t.shape[1] for t in got] == effnet.feature_channels(port.cfg.backbone_name)
    for g, r in zip(got, want):
        _close(g, r)


def test_eval_heads_equal_the_reference(pair):
    port, ref, _ = pair
    frames = _frames(1, seed=3)
    with torch.no_grad():
        for g, r in zip(port(frames), ref(frames)):
            _close(g, r)


def test_training_gradients_equal_the_reference(small):
    """A training forward (batch statistics, drop-connect from equally seeded
    generators), the port's loss and the reference's, and every parameter's
    gradient."""
    port, _, tree = small
    cfg = ref_seg.EfficientSegConfig(num_classes=8, compound_coef=0, backbone=port.cfg.backbone)
    port, ref = EfficientSeg(port.cfg, param_dtype=torch.float32), ref_seg.EfficientSeg(cfg)
    load_flax_variables(port, tree)
    ref_load(ref, tree)
    frames, (polys, n_verts, cls_ids) = bench_train_batch(2, 8, H, W, seed=2 ** 31 + 1,
                                                          n_real=3)
    anchors = torch.tensor(generate_anchors(H, W, pyramid_levels=port.cfg.pyramid_levels,
                                            anchor_scale=port.cfg.anchor_scale,
                                            scales=port.cfg.scales, ratios=port.cfg.ratios))
    polys, n_verts, cls_ids = (torch.as_tensor(polys), torch.as_tensor(n_verts),
                               torch.as_tensor(cls_ids))
    losses = []
    for net, targets_fn, loss_fn, loss_cfg in (
            (port, generate_targets, compose_loss, LossConfig()),
            (ref, ref_targets, ref_loss, RefLossConfig())):
        net.train()
        net.backbone_net["model"].generator = torch.Generator().manual_seed(11)
        targets = targets_fn(polys, n_verts, cls_ids, H, W, max_points=64, dense_kp=False)
        net.zero_grad(set_to_none=True)
        total, _ = loss_fn(net(torch.as_tensor(frames)), targets, anchors, loss_cfg)
        total.backward()
        losses.append(float(total.detach()))
        net.eval()
    assert losses[0] == pytest.approx(losses[1], rel=1e-6)
    ref_params = dict(ref.named_parameters())
    fused = 0
    for name, p in port.named_parameters():
        _close(p.grad, ref_params[name].grad, rel=1e-5)
        fused += "_blocks.0." in name
    assert fused > 0


def _leaves(tree) -> int:
    return sum(_leaves(v) if isinstance(v, dict) else 1 for v in tree.values())


def test_seeded_tree_loads_into_both_and_init_random_covers_the_fused_blocks(pair):
    port, ref, tree = pair
    assert load_flax_variables(port, tree) == ref_load(ref, tree) == _leaves(tree)
    fresh = EfficientSeg(port.cfg)
    init_random(fresh, torch.Generator().manual_seed(3))
    block = fresh.backbone_net["model"]._blocks[0]
    assert isinstance(block, effnet.FusedMBConv)
    assert float(block._project_conv.conv.weight.detach().std()) > 0
    assert ref_load(ref, export_flax_variables(fresh)) == _leaves(tree)
    ref_load(ref, tree)


def test_fused_block_names_and_residual():
    one = effnet.FusedMBConv(effnet.BlockArgs(3, 1, 8, 8, 1, 1, 0.0), drop_rate=0.5)
    four = effnet.FusedMBConv(effnet.BlockArgs(3, 1, 8, 16, 4, 2, 0.0))
    assert sorted(n for n, _ in one.named_children()) == ["_bn2", "_project_conv"]
    assert sorted(n for n, _ in four.named_children()) == [
        "_bn0", "_bn2", "_expand_conv", "_project_conv"]
    assert four._expand_conv.conv.kernel_size == (3, 3) and four._expand_conv.conv.stride == (2, 2)
    assert four._project_conv.conv.kernel_size == (1, 1)
    x = torch.randn(4, 8, 6, 10, generator=torch.Generator().manual_seed(0))
    assert four(x).shape == (4, 16, 3, 5)
    one.eval()
    with torch.no_grad():
        plain = torch.nn.functional.silu(one._bn2(one._project_conv(x)))
        torch.testing.assert_close(one(x), plain + x)             # eval: the skip, no drop
        one.train()
        y = one(x, torch.Generator().manual_seed(1))
    dropped = [torch.equal(y[i], x[i]) for i in range(4)]       # a dropped sample keeps x
    assert any(dropped) and not all(dropped)


def test_spans_mark_the_fused_and_mbconv_stages():
    from torch.profiler import ProfilerActivity, profile
    counts = {}
    for backbone in ("efficientnetv2-s", "efficientnet-b0"):
        net = effnet.EfficientNetFeatures(backbone)
        with profile(activities=[ProfilerActivity.CPU]) as prof, torch.no_grad():
            net(torch.zeros(1, 3, 32, 64))
        names = [e.name for e in prof.events()]
        counts[backbone] = {s: names.count(s) for s in ("backbone.fused", "backbone.mbconv")}
    assert counts == {"efficientnetv2-s": {"backbone.fused": 1, "backbone.mbconv": 1},
                      "efficientnet-b0": {"backbone.fused": 0, "backbone.mbconv": 1}}


def test_unknown_backbone_raises():
    with pytest.raises(ValueError, match="unknown backbone 'efficientnetv3-l'.*efficientnetv2-l"):
        EfficientSegConfig(backbone="efficientnetv3-l")
    assert EfficientSegConfig(compound_coef=3).backbone_name == "efficientnet-b3"
    assert EfficientSegConfig(compound_coef=3, backbone="efficientnet-b5").backbone_name == (
        "efficientnet-b5")


def _yaml(path, backbone):
    path.write_text(
        "seed: 3\ncompound_coef: 0\n"
        f"backbone: {backbone}\n"
        "anchors_scales: '[2 ** 0, 2 ** (1.0 / 3.0), 2 ** (2.0 / 3.0)]'\n"
        "anchors_ratios: '[(1.0, 1.0), (1.4, 0.7), (0.7, 1.4)]'\n"
        "optimizer:\n  type: Adam\n  lr: '2e-5'\n"
        f"data:\n  train_dir: {path.parent}\n  save_dir: {path.parent / 'save'}\n"
        "  dataset: cityscapes\n  batch_size: 2\n  num_classes: -1\n"
        "tpu:\n  compute_dtype: float32\n  input_size: [128, 256]\n")
    return Config(str(path))


def test_backbone_key_through_yaml_and_entry_points(tmp_path):
    from instance_segmentation_torch.training.trainer import Trainer
    cfg = _yaml(tmp_path / "cfg.yaml", "efficientnetv2-s")
    model = seeded_model(cfg, 8, CPU)
    assert model.cfg.backbone_name == "efficientnetv2-s"
    assert isinstance(model.backbone_net["model"]._blocks[0], effnet.FusedMBConv)
    trainer = Trainer(cfg, Config({}), load_trans_config(), device=CPU)
    assert trainer.model_cfg.backbone == "efficientnetv2-s"
    net = trainer.step_trainer.model
    assert sum(isinstance(m, effnet.FusedMBConv) for m in net.modules()) == 10
    frames, labels = bench_train_batch(2, 8, H, W, seed=7, n_real=3)
    before = net.backbone_net["model"]._blocks[0]._project_conv.conv.weight.detach().clone()
    stats = trainer.step_trainer.step(frames, *labels)           # the train CLI's step
    assert np.isfinite(float(stats["total_loss"]))
    assert not torch.equal(net.backbone_net["model"]._blocks[0]._project_conv.conv.weight, before)
    with pytest.raises(ValueError, match="unknown backbone"):
        seeded_model(_yaml(tmp_path / "bad.yaml", "efficientnetv2-xl"), 8, CPU)


def test_warm_start_from_a_v2_state_dict(small, tmp_path):
    """A port checkpoint's ``state_dict`` of a V2 model (fused blocks: no
    depthwise conv) converts and loads in full."""
    port, _, _ = small
    path = tmp_path / "sd.pt"
    torch.save(port.state_dict(), path)
    fresh = EfficientSeg(port.cfg)
    n_match, n_total = load_pretrained_file(str(path), fresh)
    assert n_match == n_total
    for (name, a), b in zip(fresh.state_dict().items(), port.state_dict().values()):
        assert torch.equal(a, b), name


def test_int8_is_near_the_float_forward(small):
    """The int8 path quantizes the MBConv 1x1s and the fused blocks' 1x1
    project convs (not the fused k x k convs); its heads stay near the float
    forward's, as B0's do (2-6% of rel. L2 at this size: the activations' int8 rounding)."""
    port, _, tree = small
    q = EfficientSeg(EfficientSegConfig(num_classes=8, compound_coef=0, quant="int8",
                                        backbone=port.cfg.backbone))
    load_flax_variables(q, tree)
    blocks = q.backbone_net["model"]._blocks
    fused = [b for b in blocks if isinstance(b, effnet.FusedMBConv)]
    assert all(b._project_conv.conv.quant == (b.args.expand_ratio != 1) for b in fused)
    assert not any(b._expand_conv.conv.quant for b in fused if b.args.expand_ratio != 1)
    frames = _frames(1, seed=5)
    with torch.no_grad():
        for g, r in zip(q(frames)[:3], port(frames)[:3]):
            rel = float(torch.linalg.vector_norm(g - r) / torch.linalg.vector_norm(r))
            assert 0 < rel < 0.1


def _spatial_rank(rank, world, init_method, tree, backbone, out_dir):
    torch.set_num_threads(1)
    multihost.maybe_initialize("cpu", init_method=init_method, rank=rank, world_size=world)
    try:
        mesh = make_mesh(MeshSpec(data=1, spatial=world), device_type="cpu")
        model = EfficientSeg(EfficientSegConfig(num_classes=8, compound_coef=0, backbone=backbone))
        load_flax_variables(model, tree)
        with torch.inference_mode(), spatial.sharded(mesh):
            out = model(batch_shard(_frames(1, seed=9), mesh))
        torch.save([t.clone() for t in out], os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def test_spatial_forward_matches_one_rank(small, tmp_path):
    """Data 1 x spatial 2 over gloo: the fused k x k convs exchange halos as
    the stem's and depthwise convs do; every rank returns the whole outputs,
    within ``multichip.HEADS_REL_F32`` of max|.| of the one-rank forward."""
    port, _, tree = small
    multihost.spawn(_spatial_rank, 2, (f"file://{tmp_path}/rendezvous", tree,
                                       port.cfg.backbone, str(tmp_path)), timeout=300)
    with torch.no_grad():
        want = port(_frames(1, seed=9))
    for rank in range(2):
        got = torch.load(tmp_path / f"rank{rank}.pt")
        for g, r in zip(got, want):
            _close(g, r, rel=multichip.HEADS_REL_F32)
