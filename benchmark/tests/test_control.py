"""The lower-precision control, on the card at each cell's own size: the
port's int8 path in the serving cells, the reference in float8 in the
training cell. Each must come out not correct under the committed limits.
``python3 -m pytest -m cuda benchmark/tests/test_control.py`` on the card."""

import time
from pathlib import Path

import pytest

from benchmark import cell as cells, harness

REPO = Path(__file__).resolve().parents[2]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["d3-serve-b1", "d3-train-b8", "d7x-serve-b1"])
def test_the_control_is_not_correct(workload, cuda_device):
    cell = cells.load(REPO, workload)
    result = harness.run(cell, 2 ** 34 + 1, 5.0, False, cuda_device, time.perf_counter(),
                         control=True)
    assert not result["correct"], result["compared"]
