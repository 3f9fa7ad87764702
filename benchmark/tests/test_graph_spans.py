"""The readers of the serving forward's CUDA graph spans
(``graph_replays_per_req.serve``, ``forward_host_ms.serve``): each is reported
by a traced tiny run; ``graph_replays_per_req.serve`` reads 0, not None, where
the forward ran and no replay did; each reads None on a program without the
spans."""

from pathlib import Path

import pytest

from benchmark import cell as cells
from benchmark.tests import tiny

NEW = ("graph_replays_per_req.serve", "forward_host_ms.serve")


def _reader(name: str):
    return cells.load_module(Path(tiny.REPO) / "benchmark" / "metrics" / f"{name}.py")


def _summary(spans: dict, units: int = 2) -> dict:
    """A segment's summary holding ``spans`` ({name: (count, host s, kernels)})."""
    return {"units": units, "span_count": {n: c for n, (c, _, _) in spans.items()},
            "span_host_s": {n: s for n, (_, s, _) in spans.items()},
            "span_kernels": {n: k for n, (_, _, k) in spans.items()}}


def test_a_traced_tiny_run_reports_each_new_metric(tmp_path):
    root = tiny.make_root(tmp_path)
    traced = tiny.run(root, "tiny-serve", seconds=0.5, trace=True)
    metrics = {name: traced["metrics"][name]["value"] for name in NEW}
    # a CPU run: the forward runs eagerly, so nothing is replayed
    assert metrics["graph_replays_per_req.serve"] == 0
    assert metrics["forward_host_ms.serve"] > 0
    assert traced["correct"]


def test_an_eager_forward_reads_zero_replays():
    summary = _summary({"serve.predict": (2, 0.1, 900), "forward": (2, 0.07, 600),
                        "decode": (2, 0.02, 300)})
    assert _reader("graph_replays_per_req.serve").read(summary) == 0
    assert _reader("forward_host_ms.serve").read(summary) == pytest.approx(35.0)


def test_replays_are_counted_and_the_forward_timed():
    summary = _summary({"forward": (4, 0.006, 2400), "graph:replay": (4, 0.004, 2400),
                        "graph:capture": (1, 0.5, 0), "decode": (4, 0.04, 600)})
    assert _reader("graph_replays_per_req.serve").read(summary) == 2
    assert _reader("forward_host_ms.serve").read(summary) == pytest.approx(3.0)


@pytest.mark.parametrize("name", NEW)
def test_a_program_without_the_spans_reads_none(name):
    summary = _summary({"serve.predict": (2, 0.1, 900), "model.forward": (2, 0.05, 600)})
    assert _reader(name).read(summary) is None
