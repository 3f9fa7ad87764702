"""The MaxViT serving cell as new files: a tiny MaxViT (head dim 8, P = 4,
one block a stage) in MaxViT-B's place under the B0 neck at 128x256,
float32, run through ``traffic/serve_closed_maxvit.py`` on the CPU, correct
against ``reference/efficientseg_maxvit.py``; its control (the
whole forward in float8) not correct; its traced segment's eager forwards with the port's
attention spans; the attention readers and counts; the stated widths
checked; and no file of the harness changed by a run."""

import json

import pytest
import torch

from benchmark import cell as cells, model_maxvit
from benchmark.counts import flops, maxvit_attn
from benchmark.reference import maxvit as ref_maxvit
from benchmark.tests import tiny
from benchmark.tests.test_extend import _digests

CPU = torch.device("cpu")
TINY = dict(stem=16, depths=(1, 1, 1, 1), channels=(16, 32, 48, 64), head_dim=8, partition=4)


@pytest.fixture(autouse=True)
def tiny_tables(monkeypatch):
    from instance_segmentation_torch.models import maxvit
    monkeypatch.setitem(maxvit.TABLES, "maxvit-b", maxvit.MaxViTArgs(**TINY))
    monkeypatch.setitem(ref_maxvit.TABLES, "maxvit-b", ref_maxvit.MaxViTArgs(**TINY))


def mx_config(name: str) -> dict:
    return dict(tiny.config(name), backbone="maxvit-b", stem=16, depths=[1, 1, 1, 1],
                channels=[16, 32, 48, 64], head_dim=8, partition=4, expand=4, se_ratio=0.25,
                mlp_ratio=4, feature_channels=[16, 16, 32, 48, 64])


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tiny.make_root(tmp_path_factory.mktemp("root"))
    base = root / "benchmark"
    (base / "configs/tiny-mx.json").write_text(json.dumps(mx_config("tiny-mx")))
    (base / "traffic/tiny-mx.json").write_text(json.dumps(
        {"kind": "serve_closed_maxvit", "batch": 1, "pool": 2, "warmup": 1, "checked": 2,
         "traced": 2}))
    (base / "workloads/tiny-mx.json").write_text(
        (tiny.REPO / "benchmark/workloads/maxvitb-serve-b1.json").read_text())
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-mx", "source": "tiny",
                             "file": "benchmark/configs/tiny-mx.json", "reduced": [],
                             "why": "CPU rehearsal"})
    bench["workloads"].append({"name": "tiny-mx", "config": "tiny-mx", "traffic": "tiny-mx",
                               "chips": 1, "why": "CPU rehearsal"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "maxvitb-serve-b1" in m.get("workloads", ()):
            m["workloads"].append("tiny-mx")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def test_maxvit_cell_is_correct_its_control_is_not_and_no_file_changes(root):
    before = _digests(root / "benchmark")
    timed = tiny.run(root, "tiny-mx", seconds=0.5)
    assert set(timed["metrics"]) == {"serve_ms_p95", "serve_img_per_s", "setup_s"}
    assert timed["correct"], timed["compared"]
    assert timed["compared"]["dets_mismatch"]["value"] == 0.0
    control = tiny.run(root, "tiny-mx", seconds=0.2, control=True)
    assert not control["correct"]
    assert control["compared"]["dets_mismatch"]["value"] > 0
    from instance_segmentation_torch.models import layers, maxvit
    assert maxvit.attention.__name__ == "attention"        # the control's patches are undone
    assert layers.F is torch.nn.functional
    assert _digests(root / "benchmark") == before


def test_traced_segment_holds_the_attention_spans(root):
    cell = cells.load(root, "tiny-mx")
    assert {"attn_ms.serve", "attn_launches.serve", "attn_roofline.serve"} <= {
        m["name"] for m in cell.per_layer}
    session = cells.driver(cell).setup(cell, CPU, 2 ** 33 + 5)
    session.window(0.2)
    summary = session.trace()
    session.free()
    segment = summary["backbone"]
    assert segment["units"] == 2 and segment["images_per_unit"] == 1
    for span, n in (("backbone.mbconv", 4), ("backbone.block_attn", 4),
                    ("backbone.grid_attn", 4), ("backbone.mlp", 8)):
        assert segment["span_count"][span] == 2 * n
    work = maxvit_attn.sub_blocks("maxvit-b", 1, 128, 256)
    assert segment["bound_s"]["attn"] == pytest.approx(2 * maxvit_attn.least_seconds(work))
    # the CPU launches no device kernels: the readers have nothing to read
    for name in ("attn_ms.serve", "attn_launches.serve", "attn_roofline.serve"):
        assert cells.metric_reader(cell, name).read(summary) is None
        assert cells.metric_reader(cell, name).read({}) is None


def test_attention_readers_on_a_synthetic_summary(root):
    cell = cells.load(root, "tiny-mx")
    segment = {"units": 4, "images_per_unit": 2,
               "span_device_s": {"backbone.block_attn": 0.02, "backbone.grid_attn": 0.02},
               "span_kernels": {"backbone.block_attn": 400, "backbone.grid_attn": 400},
               "bound_s": {"attn": 0.002}}
    summary = {"backbone": segment}
    read = lambda name: cells.metric_reader(cell, name).read(summary)
    assert read("attn_ms.serve") == pytest.approx(5.0)
    assert read("attn_launches.serve") == pytest.approx(100.0)
    assert read("attn_roofline.serve") == pytest.approx(5.0)


def test_attention_count_equals_the_frozen_counter_on_each_stage():
    """Each stage's attention sub-block: the count's FLOPs equal the frozen
    FLOP counter's over the reference module at the stage's shape."""
    a = ref_maxvit.TABLES["maxvit-b"]
    works = maxvit_attn.sub_blocks("maxvit-b", 2, 128, 256)
    h, w = 32, 64
    for stage, c in enumerate(a.channels):
        attn = ref_maxvit.RelativeAttention(c, a.head_dim, a.partition, "grid")
        with torch.no_grad():
            _, ops = flops.count(lambda: attn(torch.zeros(2, h, w, c)))
        assert flops.total_flops(ops) == works[2 * stage].ops
        h, w = h // 2, w // 2


def test_maxvit_b_attention_count(monkeypatch):
    monkeypatch.undo()
    works = maxvit_attn.sub_blocks("maxvit-b", 1, 512, 1024)
    assert len(works) == 48
    assert sum(w.ops for w in works) == 172_335_562_752
    assert all(w.ops / 989e12 > w.bytes / 3.35e12 for w in works)      # FLOP-bound


@pytest.mark.parametrize("key,value", [("partition", 8), ("head_dim", 64),
                                       ("channels", [16, 32, 48, 65])])
def test_stated_widths_are_checked(key, value):
    with pytest.raises(ValueError, match=key):
        model_maxvit.reference_config(dict(mx_config("wrong"), **{key: value}))


def test_the_maxvitb_configuration_is_what_the_reference_builds(monkeypatch):
    monkeypatch.undo()
    config = json.loads(
        (tiny.REPO / "benchmark/configs/effseg-maxvitb-cityscapes.json").read_text())
    assert model_maxvit.widths(config)["feature_channels"] == [64, 96, 192, 384, 768]
    with torch.device("meta"):
        net = model_maxvit.ref.EfficientSeg(model_maxvit.reference_config(config))
    assert sum(p.numel() for p in net.parameters()) == config["parameters"]
    assert sum(p.numel() for p in net.backbone_net.parameters()) == config["backbone_parameters"]
