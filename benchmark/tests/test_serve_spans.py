"""The readers of the port's serving spans (``syncs_per_req.serve``,
``sync_wait_ms.serve``, ``upload_ms.serve``, ``decode_launches_per_req.serve``):
each is reported by a traced tiny run; ``syncs_per_req.serve`` reads 0, not
None, where the decode ran and no wait did; each reads None on a program
without the spans."""

from pathlib import Path

import pytest

from benchmark import cell as cells
from benchmark.tests import tiny

NEW = ("syncs_per_req.serve", "sync_wait_ms.serve", "upload_ms.serve",
       "decode_launches_per_req.serve")


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
    # a CPU run: the frames are not copied, the decode's reads of NMS's condition
    # are the only waits, and no device kernel is launched
    assert metrics["syncs_per_req.serve"] >= 2
    assert metrics["sync_wait_ms.serve"] > 0 and metrics["upload_ms.serve"] > 0
    assert metrics["decode_launches_per_req.serve"] == 0
    assert traced["correct"]


def test_no_wait_reads_zero():
    summary = _summary({"serve.predict": (2, 0.1, 900), "upload": (2, 0.002, 0),
                        "decode": (2, 0.02, 300), "decode.boxes": (2, 0.004, 60)})
    assert _reader("syncs_per_req.serve").read(summary) == 0
    assert _reader("sync_wait_ms.serve").read(summary) == 0
    assert _reader("upload_ms.serve").read(summary) == pytest.approx(1.0)
    assert _reader("decode_launches_per_req.serve").read(summary) == 150


def test_waits_are_counted_and_timed():
    summary = _summary({"upload": (2, 0.004, 0), "sync:upload": (2, 0.003, 0),
                        "decode": (2, 0.02, 300), "sync:nms": (8, 0.005, 0)})
    assert _reader("syncs_per_req.serve").read(summary) == 5
    assert _reader("sync_wait_ms.serve").read(summary) == pytest.approx(4.0)


@pytest.mark.parametrize("name", NEW)
def test_a_program_without_the_spans_reads_none(name):
    summary = _summary({"serve.predict": (2, 0.1, 900), "model.forward": (2, 0.05, 600)})
    assert _reader(name).read(summary) is None
