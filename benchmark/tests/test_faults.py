"""The comparison that decides ``correct`` catches a broken timed path: CPU
rehearsals at a tiny size, held to the committed limits of the serving and
training cells, with one fault planted in the port each."""

import json

import pytest

from benchmark import faults
from benchmark.tests import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    limits = {kind: json.loads((tiny.REPO / f"benchmark/workloads/{cell}.json").read_text())
              ["limits"] for kind, cell in (("serve", "d3-serve-b1"), ("train", "d3-train-b8"))}
    return tiny.make_root(tmp_path_factory.mktemp("root"), limits=limits)


def test_sound_runs_are_correct(root):
    assert tiny.run(root, "tiny-serve", seconds=1.0)["correct"]
    assert tiny.run(root, "tiny-train", seconds=0.3)["correct"]


@pytest.mark.parametrize("fault,workload", [
    ("altered_detection", "tiny-serve"), ("unchanged", "tiny-train"),
    ("half_batch", "tiny-train"), ("altered_loss", "tiny-train"), ("lr_off", "tiny-train")])
def test_a_fault_is_caught(root, fault, workload):
    with faults.FAULTS[fault]():
        result = tiny.run(root, workload, seconds=1.0 if workload == "tiny-serve" else 0.3)
    assert not result["correct"], result["compared"]
