"""What a run loads: no JAX and no JAX package in a run's process; nothing
of the port in the reference or the counts."""

import json
import subprocess
import sys
from pathlib import Path

from benchmark import harness

REPO = Path(__file__).resolve().parents[2]
RUN = """
import json, sys
from pathlib import Path
from benchmark import harness
from benchmark.tests import tiny
root = tiny.make_root(Path(sys.argv[1]))
for name in ("tiny-serve", "tiny-train"):
    tiny.run(root, name, seconds=0.3, trace=name == "tiny-serve")
print(json.dumps(harness.forbidden_modules()))
"""
YARDSTICK = """
import importlib, json, pkgutil, sys
import benchmark.reference, benchmark.counts
for pkg in (benchmark.reference, benchmark.counts):
    for m in pkgutil.iter_modules(pkg.__path__):
        importlib.import_module(f"{pkg.__name__}.{m.name}")
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _last_json(code, *args):
    out = subprocess.run([sys.executable, "-c", code, *map(str, args)], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax(tmp_path):
    assert _last_json(RUN, tmp_path) == []


def test_reference_and_counts_load_nothing_of_the_port():
    loaded = set(_last_json(YARDSTICK))
    assert not loaded & {"instance_segmentation_torch", "instance_segmentation_tpu", "jax",
                         "jaxlib"}
    assert "benchmark" in loaded


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "instance_segmentation_torch_extra", sys)
    monkeypatch.setitem(sys.modules, "jaxlib_like", sys)
    found = [m for m in harness.forbidden_modules() if m in ("instance_segmentation_torch_extra",
                                                              "jaxlib_like")]
    assert found == []
    monkeypatch.setitem(sys.modules, "instance_segmentation_tpu.models", sys)
    assert "instance_segmentation_tpu.models" in harness.forbidden_modules()
