"""A cell, a traffic kind and a per-layer metric added as new files plus
``BENCHMARK.json`` entries, with no file of the harness edited."""

import hashlib
import json
from pathlib import Path

from benchmark.tests import tiny

DRIVER = '''"""A throwaway traffic kind: closed-loop serving under another name."""
from pathlib import Path
from benchmark import cell
_base = cell.load_module(Path(__file__).with_name("serve_closed.py"))
def setup(c, device, seed, control=False):
    return _base.setup(c, device, seed, control)
'''
METRIC = '''"""Benchmark spans a request in the traced segment (throwaway)."""
def read(summary):
    return summary["span_count"].get("serve.predict", 0) / summary["units"] or None
'''


def _digests(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_cell_kind_and_metric_need_no_edit(tmp_path):
    root = tiny.make_root(tmp_path)
    before = _digests(root / "benchmark")
    base = root / "benchmark"
    (base / "traffic/serve_twice.py").write_text(DRIVER)
    (base / "traffic/tiny-new.json").write_text(json.dumps(
        {"kind": "serve_twice", "batch": 2, "pool": 2, "warmup": 1, "checked": 1, "traced": 2}))
    (base / "workloads/tiny-new.json").write_text(
        (base / "workloads/tiny-serve.json").read_text())
    (base / "metrics/spans_per_req.serve.py").write_text(METRIC)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tiny-new", "config": "tiny", "traffic": "tiny-new",
                               "chips": 1, "why": "throwaway"})
    bench["per_layer"].append({"name": "spans_per_req.serve", "unit": "count", "better": "lower",
                               "source": "device_trace", "layer": "serving", "moves": "serve_ms_p95",
                               "workloads": ["tiny-new"]})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "tiny-serve" in m.get("workloads", ()):
            m["workloads"].append("tiny-new")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    timed = tiny.run(root, "tiny-new", seconds=0.5)
    assert set(timed["metrics"]) == {"serve_ms_p95", "serve_img_per_s", "setup_s"}
    assert timed["attempted"] >= 1 and timed["correct"]
    traced = tiny.run(root, "tiny-new", seconds=0.5, trace=True)
    assert traced["metrics"]["spans_per_req.serve"]["value"] == 1.0
    after = _digests(root / "benchmark")
    assert {k: after[k] for k in before} == before
