"""The frozen reference and counts held to the port on the CPU: B0 at
128x256 in float32 (forward, decode, one training step) and the D3 count at
512x1024 (on the meta device: shapes only)."""

import numpy as np
import pytest
import torch

from benchmark import data, model
from benchmark.counts import flops as bench_flops
from benchmark.reference import decode as ref_decode, kernels as ref_kernels
from benchmark.reference.train import Trainer as RefTrainer
from benchmark.reference.weights import load_flax_variables as ref_load
from benchmark.tests import tiny

from instance_segmentation_torch.kernels import ae_terms, affinity, minr2, rasterize
from instance_segmentation_torch.models import EfficientSeg
from instance_segmentation_torch.ops.decode import DecodeConfig, decode_output
from instance_segmentation_torch.training.train_step import Trainer
from instance_segmentation_torch.utils import flops as port_flops
from instance_segmentation_torch.weights import load_flax_variables

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def small():
    config = tiny.config("small")
    return config, model.weight_tree(config, 2 ** 40 + 3, CPU)


def test_forward_and_decode_equal_the_port(small):
    config, tree = small
    port = EfficientSeg(model.program_config(config))
    load_flax_variables(port, tree)
    ref = model.ref.EfficientSeg(model.reference_config(config))
    ref_load(ref, tree)
    frames = torch.as_tensor(data.frames(2, 128, 256, 11, CPU))
    with torch.no_grad():
        heads, ref_heads = port(frames), ref(frames)
    for h, g in zip(heads, ref_heads):
        assert torch.equal(h, g)
    anchors = model.anchors(config, CPU)
    dets = decode_output(heads, anchors, 256, 512, 2.0, DecodeConfig(kp_th=2000))
    ref_dets = ref_decode.decode_output(heads, anchors, 256, 512, 2.0,
                                        ref_decode.DecodeConfig(kp_th=2000))
    assert int(dets.det_valid.sum()) > 0 and int(dets.obj_valid.sum()) > 0
    for a, b in zip(dets, ref_dets):
        assert torch.equal(a, b)


def test_train_step_equals_the_port(small):
    config, tree = small
    frames, labels = data.bench_train_batch(2, 8, 128, 256, seed=2 ** 35, n_real=3)
    port = Trainer(model.program_config(config), tree, (128, 256), max_points=64, lr=2e-5,
                   device=CPU, drop_seed=5)
    ref = RefTrainer(model.reference_config(config), tree, (128, 256), 64, 2e-5, CPU, 5)
    ref_params = dict(ref.model.named_parameters())
    for step in range(2):
        stats = port.step(frames, *labels)
        ref_stats = ref.step(frames, *labels)
        assert float(stats["total_loss"]) == pytest.approx(float(ref_stats["total_loss"]),
                                                           rel=1e-5)
        if step:
            continue            # Adam's sign of a near-zero gradient element may flip
        for name, p in port.model.named_parameters():
            torch.testing.assert_close(p, ref_params[name], rtol=0, atol=1e-6)
            m = port.optimizer.state[p]["exp_avg"]      # the first gradient, as Adam holds it
            ref_m = ref.optimizer.state[ref_params[name]]["exp_avg"]
            torch.testing.assert_close(m, ref_m, rtol=0, atol=1e-4 * float(ref_m.abs().max()))


def test_plain_kernels_equal_the_port_twins():
    gen = torch.Generator().manual_seed(2 ** 33)
    b, k, d, m, p, h, w = 2, 300, 12, 5, 40, 32, 64
    kp_rc = torch.randint(0, 32, (b, k, 2), generator=gen).float()
    emb, sig = torch.rand((b, k, 2), generator=gen), torch.rand((b, k, 2), generator=gen)
    c_emb = torch.rand((b, d, 2), generator=gen)
    boxes = torch.sort(torch.randint(0, 40, (b, d, 4), generator=gen).float(), dim=-1).values
    valid = torch.rand((b, d), generator=gen) > 0.3
    for a, r in zip(affinity.affinity_assign(kp_rc, emb, sig, c_emb, boxes, valid),
                    ref_kernels.affinity_assign(kp_rc, emb, sig, c_emb, boxes, valid)):
        assert torch.equal(a, r)
    points = torch.randint(-3, 70, (b, m, p, 2), generator=gen, dtype=torch.int32)
    pt_valid = torch.rand((b, m, p), generator=gen) > 0.2
    normals = torch.randn((b, m, p, 2), generator=gen)
    for a, r in zip(rasterize.rasterize_cnt_r2(points, pt_valid, h, w),
                    ref_kernels.rasterize_cnt_r2(points, pt_valid, h, w)):
        assert torch.equal(a.view(torch.uint8), r.view(torch.uint8))
    for a, r in zip(rasterize.rasterize_nmap(points, pt_valid, normals, h, w),
                    ref_kernels.rasterize_nmap(points, pt_valid, normals, h, w)):
        assert torch.equal(a, r)
    cnt = rasterize.rasterize_cnt_r2(points, pt_valid, h, w)[0]
    has = pt_valid.any(dim=2)
    assert torch.equal(minr2.minr2_from_cnt(cnt, has), ref_kernels.minr2_from_cnt(cnt, has))
    assert torch.equal(ae_terms.tile_presence(points, pt_valid, h, w),
                       ref_kernels.tile_presence(points, pt_valid, h, w))


def test_frozen_count_equals_the_port_count():
    config = dict(tiny.config("d3"), compound_coef=3, backbone="efficientnet-b3",
                  fpn_filters=160, fpn_repeats=6, box_class_repeats=4, compute_dtype="bfloat16")
    with torch.device("meta"):
        ref = model.ref.EfficientSeg(model.reference_config(config))
        port = EfficientSeg(model.program_config(config))
        frames = torch.empty((1, 512, 1024, 3), dtype=torch.uint8)
        _, ref_ops = bench_flops.count(lambda: ref(frames))
        _, port_ops = port_flops.count(lambda: port(frames))
    assert bench_flops.total_flops(ref_ops) == port_flops.total_flops(port_ops) == 62_003_191_936
    assert sum(p.numel() for p in port.parameters()) == 14_450_109


def test_stated_widths_are_checked():
    config = dict(tiny.config("wrong"), fpn_filters=65)
    with pytest.raises(ValueError, match="fpn_filters"):
        model.reference_config(config)


def test_seeded_tree_is_a_function_of_the_seed(small):
    config, tree = small
    again = model.weight_tree(config, 2 ** 40 + 3, CPU)
    other = model.weight_tree(config, 2 ** 40 + 4, CPU)
    leaf = lambda t: t["params"]["backbone"]["stem_conv"]["Conv_0"]["kernel"]
    assert np.array_equal(leaf(tree), leaf(again))
    assert not np.array_equal(leaf(tree), leaf(other))
