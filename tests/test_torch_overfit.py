"""The port's learning capstone (tools/overfit_demo.py) on the CPU at a small
size: B0 at 128x256 (frames generated at 256x512), 20 steps. The loss falls
(the mean of the last five logged steps below that of the first five), the
AP JSON comes back with every key (the int8 and kmeans ones too), the saved
weights restore with ``--steps 0`` to the same scores, and the synthetic
tree's labels are the JAX tool's byte for byte (same generator seed and
protocol)."""

import importlib.util
import json
import os

import pytest
import torch

from instance_segmentation_torch.tools import overfit_demo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = {"AP", "AP50", "AP_kmeans", "AP50_kmeans", "AP_int8", "AP50_int8", "dAP_int8"}
GEN_HW = (256, 512)


@pytest.fixture(scope="module")
def capstone(tmp_path_factory):
    torch.set_num_threads(2)
    out = tmp_path_factory.mktemp("overfit")
    result = overfit_demo.run(steps=20, out=str(out), quant_ab=True, gen_hw=GEN_HW,
                              device=torch.device("cpu"), log_every=1)
    return out, result


def test_loss_falls_and_every_ap_key_comes_back(capstone, capsys):
    out, result = capstone
    losses = [loss for _, loss in result["losses"]]
    assert [s for s, _ in result["losses"]] == list(range(20))
    assert all(map(lambda v: v == v and abs(v) < float("inf"), losses))
    assert sum(losses[-5:]) < sum(losses[:5])
    ap = result["ap"]
    assert set(ap) == KEYS
    assert all(0.0 <= ap[k] <= 1.0 for k in KEYS - {"dAP_int8"})
    assert ap["dAP_int8"] == ap["AP_int8"] - ap["AP"]
    for sub in ("eval", "eval_kmeans", "eval_int8"):
        assert (out / sub / "0_dets.json").exists()
    assert len(list((out / "ckpt").glob("efficient_weights_*.pth"))) == 1


def test_steps_0_restores_the_saved_weights(capstone, capsys):
    out, result = capstone
    again = overfit_demo.main(["--steps", "0", "--out", str(out), "--quant_ab",
                               "--gen_hw", *map(str, GEN_HW), "--device", "cpu"])
    text = capsys.readouterr().out
    assert "restored " in text
    assert json.loads(text.strip().splitlines()[-1]) == again["ap"] == result["ap"]
    assert again["losses"] == []


def test_synthetic_tree_is_the_jax_tools(capstone, tmp_path):
    out, _ = capstone
    spec = importlib.util.spec_from_file_location(
        "jax_make_synthetic", os.path.join(REPO, "tools", "make_synthetic_cityscapes.py"))
    jax_gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_gen)
    jax_gen.generate(str(tmp_path), splits=(("train", 4),), h=GEN_HW[0], w=GEN_HW[1],
                     seed=21, instances=(2, 4))
    for split in ("train", "val"):
        got = sorted((out / "data" / "gtFine" / split / "synth").glob("*.json"))
        want = sorted((tmp_path / "gtFine" / "train" / "synth").glob("*.json"))
        assert [p.name for p in got] == [p.name for p in want] and len(got) == 4
        for g, w in zip(got, want):
            assert g.read_bytes() == w.read_bytes()
