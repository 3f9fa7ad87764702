"""The port's profilers (instance_segmentation_torch/tools/profile_*.py and
bench_train_data.py) on the CPU at a test's size: EfficientSeg-B0 at
128x256, one or two iterations, ``bench_train_data`` on 4 synthetic
256x512 frames, 2 steps of batch 2. Each prints its stage names and a JSON
record that parses; ``profile_decode``'s staged decode equals
``decode_output``'s bit for bit in both top-k modes; ``bench_train_data``'s
loader gives the train CLI's first batch; without ``--device cpu`` each
tool wants the card and raises here; the trace summary's arithmetic."""

import json

import numpy as np
import pytest
import torch

from instance_segmentation_torch.configs import Config, Configer
from instance_segmentation_torch.ops import decode
from instance_segmentation_torch.tools import (
    bench_train_data, preprocess_cityscapes, profile_blocks, profile_decode, profile_infer,
    profile_infer_blocks,
)
from instance_segmentation_torch.training import Trainer
from instance_segmentation_torch.utils import profiling

torch.set_num_threads(2)
SMALL = ["--compound", "0", "--hw", "128", "256", "--device", "cpu"]


def _record(capsys) -> tuple:
    """(the printed lines but the last, the last line's JSON record)."""
    lines = capsys.readouterr().out.strip().splitlines()
    return lines[:-1], json.loads(lines[-1])


def test_profile_infer_prints_each_stage_and_a_record(capsys, tmp_path):
    profile_infer.main(["--batches", "1", "2", "--iters", "2", "--trace", str(tmp_path),
                        "--top", "3", *SMALL])
    lines, rec = _record(capsys)
    assert rec["tool"] == "profile_infer" and rec["device"] == "cpu"
    assert set(rec["batches"]) == {"1", "2"}
    for b in ("1", "2"):
        r = rec["batches"][b]
        for stage in ("forward", "decode", "composed"):
            assert r[stage]["n"] == 2 and r[stage]["median"] > 0 and "p75" not in r[stage]
        assert r["k1_per_decode"] == 0          # no kernel runs on the CPU
        assert r["launches"] is None and r["idle_share"] is None
        assert (tmp_path / f"profile_infer_b{b}_none_exact.json").is_file()
    stage_lines = [line for line in lines if line.startswith("B=")]
    assert len(stage_lines) == 2
    assert all(f"{s} " in stage_lines[0] for s in ("forward", "decode", "composed"))
    assert any(line.startswith("trace B=1") for line in lines)


@pytest.mark.parametrize("topk,group", [("exact", "affinity"), ("approx", "affinity"),
                                        ("approx", "kmeans")])
def test_profile_decode_stages_compose_to_the_full_decode(capsys, topk, group):
    """The tool raises unless the staged Detections equal decode_output's
    bit for bit; each stage prints a line."""
    profile_decode.main(["--batch", "2", "--iters", "1", "--topk", topk, "--group", group,
                         *SMALL])
    lines, rec = _record(capsys)
    assert rec["staged_equal"] and rec["topk"] == topk and rec["group"] == group
    assert list(rec["stages"]) == ["forward", "boxes+nms", "peak_topk", "group", "assembly",
                                   "full"]
    assert [line.split()[0] for line in lines[:6]] == list(rec["stages"])
    assert rec["nms_host_reads"] >= 2 and rec["detections"] > 0 and rec["objects"] > 0


def test_profile_decode_check_catches_a_difference():
    full = decode.Detections(*(torch.zeros(2, 3) for _ in range(8)))
    profile_decode.check_equal(full, full)
    changed = full._replace(polygons=full.polygons.clone().index_fill_(1, torch.tensor([1]), 1.0))
    with pytest.raises(AssertionError, match="polygons"):
        profile_decode.check_equal(changed, full)
    with pytest.raises(AssertionError, match="classes"):
        profile_decode.check_equal(full._replace(classes=full.classes.int()), full)


def test_profile_infer_blocks_prints_each_block(capsys):
    profile_infer_blocks.main(["--batch", "2", "--iters", "1", *SMALL])
    lines, rec = _record(capsys)
    names = ["backbone", "bifpn", "regressor", "classifier", "unet", "forward"]
    assert list(rec["blocks"]) == names
    assert [line.split()[0] for line in lines[:6]] == names
    assert rec["sum_ms"] > 0


def test_profile_blocks_only_and_trace(capsys, tmp_path):
    profile_blocks.main(["--batch", "2", "--iters", "1", "--only", "unet,bifpn", "--trace",
                         str(tmp_path), *SMALL])
    lines, rec = _record(capsys)
    assert list(rec["blocks"]) == ["unet", "bifpn"]
    assert lines[0].startswith("unet") and "fwd+bwd" in lines[0]
    assert (tmp_path / "profile_blocks_bifpn.json").is_file()
    with pytest.raises(ValueError, match="unknown blocks"):
        profile_blocks.run(only=["head"], device="cpu")


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """The tool's set (4 frames of 256x512), written once, packed too."""
    out = str(tmp_path_factory.mktemp("dbench"))
    return out, bench_train_data.prepare("packed", out, 4, (256, 512), procs=2)


@pytest.mark.parametrize("mode", ["packed", "json"])
def test_bench_train_data_prints_its_record(capsys, data_root, mode):
    out, _ = data_root
    bench_train_data.main(["--mode", mode, "--images", "4", "--steps", "2", "--batch", "2",
                           "--compound", "0", "--frame_hw", "256", "512", "--out", out,
                           "--device", "cpu"])
    _, rec = _record(capsys)
    for key in ("from_disk_imgs_per_sec", "device_resident_imgs_per_sec", "data_stall_frac"):
        assert rec[key] >= 0
    assert rec["batch"] == 2 and rec["steps"] == 2 and rec["mode"] == mode
    assert rec["launches"] == {"rasterize_cnt_r2": 0, "rasterize_nmap": 0, "ae_terms_fwd": 0,
                               "ae_terms_bwd": 0}
    assert np.isfinite(rec["total_loss"])
    bench_train_data.main(["--mode", mode, "--images", "4", "--steps", "3", "--batch", "2",
                           "--frame_hw", "256", "512", "--out", out, "--data_only",
                           "--device", "cpu"])
    _, rec = _record(capsys)
    assert rec["data_only"] and rec["images_seen"] == 6 and rec["host_loader_imgs_per_sec"] > 0


@pytest.mark.parametrize("mode", ["packed", "json"])
def test_bench_train_data_loader_gives_the_train_clis_first_batch(data_root, tmp_path, mode):
    """The tool's loader against the one the epoch trainer builds from a
    train config on the same tree, transforms and seed."""
    _, root = data_root
    if mode == "packed":        # the trainer's eval loader reads packed/val
        preprocess_cityscapes.preprocess(root, "train", f"{root}/packed/val", target_size=2)
    cfg = {"data": {"train_dir": root, "save_dir": str(tmp_path),
                    "dataset": "cityscapes_packed" if mode == "packed" else "cityscapes",
                    "batch_size": 2, "num_classes": 8, "num_workers": 0},
           "optimizer": {"lr": "2e-5", "type": "Adam", "momentum": 0.9},
           "max_iter": 2, "num_epochs": 1, "save_span": 1000, "seed": 0, "compound_coef": 0,
           "anchors_scales": "[2 ** 0, 2 ** (1.0 / 3.0), 2 ** (2.0 / 3.0)]",
           "anchors_ratios": "[(1.0, 1.0), (1.4, 0.7), (0.7, 1.4)]",
           "pretrained_path": None, "decode_cfg_path": None, "trans_cfg_path": None,
           "start_eval_epoch": 1000,
           "tpu": {"compute_dtype": "float32", "remat": False, "input_size": [128, 256]},
           "static": {"max_instances": bench_train_data.M, "max_vertices": bench_train_data.V,
                      "max_points": bench_train_data.P}}
    trainer = Trainer(Config(cfg), Config({}), Configer(bench_train_data.TRANS),
                      device=torch.device("cpu"))
    want_images, want_packed, _ = next(iter(trainer.make_loaders()[0]))
    got_images, got_packed, _ = next(iter(bench_train_data.make_loader(mode, root, 2, 0)))
    assert got_images.shape == (2, 128, 256, 3)
    np.testing.assert_array_equal(got_images, want_images)
    for g, w in zip(got_packed, want_packed):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("tool", [profile_infer, profile_decode, profile_infer_blocks,
                                  profile_blocks, bench_train_data])
def test_tools_default_to_the_card(tool):
    """Without ``--device cpu`` a tool takes the card or raises: no fallback."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(["--compound", "0"])


def test_summarize_trace_merges_device_intervals(tmp_path):
    events = [{"ph": "X", "cat": "kernel", "name": "a", "ts": 0.0, "dur": 2000.0},
              {"ph": "X", "cat": "kernel", "name": "b", "ts": 1000.0, "dur": 2000.0},
              {"ph": "X", "cat": "kernel", "name": "a", "ts": 5000.0, "dur": 500.0},
              {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 8000.0, "dur": 1000.0},
              {"ph": "X", "cat": "gpu_user_annotation", "name": "span", "ts": 0.0, "dur": 9e3},
              {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 0.0, "dur": 9e3}]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    s = profiling.summarize_trace(str(path), window_ms=10.0, top=1)
    assert s["launches"] == 3 and s["kernels"] == 2
    assert s["busy_ms"] == pytest.approx(4.5) and s["idle_share"] == pytest.approx(0.55)
    assert s["top"] == [{"name": "a", "ms": 2.5, "launches": 2, "share": 0.25}]
    path.write_text(json.dumps({"traceEvents": events[-2:]}))
    assert profiling.summarize_trace(str(path), 10.0)["idle_share"] is None


def test_top_percentile_is_the_highest_the_sample_supports():
    assert [profiling.top_percentile(n) for n in (1, 3, 4, 9, 10, 19, 20, 99, 100)] == \
        [50, 50, 75, 75, 90, 90, 95, 95, 99]
    s = profiling.spread([3.0, 1.0, 2.0, 4.0])
    assert s["median"] == 2.5 and "p75" in s and s["n"] == 4
