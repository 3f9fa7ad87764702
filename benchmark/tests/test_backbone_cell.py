"""The V2 backbone's serving cell as new files: a tiny EfficientNetV2-S
configuration (the B0 neck at 128x256, float32) run through
``traffic/serve_closed_backbone.py`` on the CPU, correct against the
reference of ``reference/efficientseg_backbone.py``; its traced segment's
eager forwards with the port's ``backbone.fused`` spans; the readers of
``fused_ms.serve`` and ``fused_roofline.serve``; the stated widths checked;
and no file of the harness changed by the run."""

import json

import pytest
import torch

from benchmark import cell as cells, model_backbone
from benchmark.counts import fused_mbconv
from benchmark.reference.efficientnetv2 import TABLES, feature_channels
from benchmark.tests import tiny
from benchmark.tests.test_extend import _digests

CPU = torch.device("cpu")
V2 = "efficientnetv2-s"


def v2_config(name: str) -> dict:
    stem, table = TABLES[V2]
    keys = model_backbone.STAGE_KEYS
    return dict(tiny.config(name), backbone=V2, stem=stem,
                stages=[dict(zip(keys, s)) for s in table],
                feature_channels=feature_channels(V2))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tiny.make_root(tmp_path_factory.mktemp("root"))
    base = root / "benchmark"
    (base / "configs/tiny-v2.json").write_text(json.dumps(v2_config("tiny-v2")))
    (base / "traffic/tiny-v2.json").write_text(json.dumps(
        {"kind": "serve_closed_backbone", "batch": 1, "pool": 2, "warmup": 1, "checked": 2,
         "traced": 2}))
    (base / "workloads/tiny-v2.json").write_text(
        (tiny.REPO / "benchmark/workloads/v2l-serve-b1.json").read_text())
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-v2", "source": "tiny",
                             "file": "benchmark/configs/tiny-v2.json", "reduced": [],
                             "why": "CPU rehearsal"})
    bench["workloads"].append({"name": "tiny-v2", "config": "tiny-v2", "traffic": "tiny-v2",
                               "chips": 1, "why": "CPU rehearsal"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "v2l-serve-b1" in m.get("workloads", ()):
            m["workloads"].append("tiny-v2")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def test_v2_cell_is_correct_and_changes_no_file(root):
    before = _digests(root / "benchmark")
    timed = tiny.run(root, "tiny-v2", seconds=0.5)
    assert set(timed["metrics"]) == {"serve_ms_p95", "serve_img_per_s", "setup_s"}
    assert timed["correct"], timed["compared"]
    assert timed["compared"]["dets_mismatch"]["value"] == 0.0
    assert _digests(root / "benchmark") == before


def test_traced_segment_holds_the_fused_spans(root):
    cell = cells.load(root, "tiny-v2")
    session = cells.driver(cell).setup(cell, CPU, 2 ** 33 + 5)
    session.window(0.2)
    summary = session.trace()
    session.free()
    segment = summary["backbone"]
    assert segment["units"] == 2
    assert segment["span_count"]["backbone.fused"] == 2
    assert segment["span_count"]["backbone.mbconv"] == 2
    work = fused_mbconv.fused_stages(V2, 1, 128, 256)
    assert segment["bound_s"]["fused"] == pytest.approx(2 * fused_mbconv.least_seconds(work))
    # the CPU launches no device kernels: the readers have nothing to read
    for name in ("fused_ms.serve", "fused_roofline.serve"):
        assert cells.metric_reader(cell, name).read(summary) is None
        assert cells.metric_reader(cell, name).read({}) is None


def test_fused_readers_on_a_synthetic_summary(root):
    cell = cells.load(root, "tiny-v2")
    segment = {"units": 4, "span_device_s": {"backbone.fused": 0.02},
               "span_kernels": {"backbone.fused": 400}, "bound_s": {"fused": 0.001}}
    summary = {"backbone": segment}
    assert cells.metric_reader(cell, "fused_ms.serve").read(summary) == pytest.approx(5.0)
    assert cells.metric_reader(cell, "fused_roofline.serve").read(summary) == pytest.approx(5.0)


def test_fused_count_of_the_v2l_frame():
    """V2-L's fused stages at 512x1024: the benchmark's FLOP counter's 116.1
    GFLOP, FLOP-bound on the H100."""
    work = fused_mbconv.fused_stages("efficientnetv2-l", 1, 512, 1024)
    assert work.ops == 116_098_334_720
    assert fused_mbconv.least_seconds(work) == pytest.approx(work.ops / 989e12)


@pytest.mark.parametrize("key,value", [("stem", 40), ("fpn_filters", 65),
                                       ("feature_channels", [1, 2, 3, 4, 5])])
def test_stated_widths_are_checked(key, value):
    with pytest.raises(ValueError, match=key):
        model_backbone.reference_config(dict(v2_config("wrong"), **{key: value}))


def test_the_v2l_configuration_is_what_the_reference_builds():
    config = json.loads((tiny.REPO / "benchmark/configs/effseg-v2l-cityscapes.json").read_text())
    built = model_backbone.widths(config)
    assert built["feature_channels"] == [32, 64, 96, 224, 640]
    with torch.device("meta"):
        net = model_backbone.ref.EfficientSeg(model_backbone.reference_config(config))
    assert sum(p.numel() for p in net.parameters()) == config["parameters"]
    assert sum(p.numel() for p in net.backbone_net.parameters()) == config["backbone_parameters"]
