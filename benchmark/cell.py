"""A cell of the benchmark, read from data files by name.

``BENCHMARK.json`` (at the root of the checkout) names each cell's
configuration and traffic mix; every other piece sits in a file of its own
under ``benchmark/``, found by the name:

* ``configs/<config>.json``: the model configuration as it is run;
* ``traffic/<traffic>.json``: the traffic mix, whose ``kind`` names the
  driver ``traffic/<kind>.py`` that runs it;
* ``workloads/<cell>.json``: the cell's comparison limits (``limits``);
* ``metrics/<metric>.py``: the reader of a per-layer metric.

A new cell, mix, driver or metric is a new file plus an entry in
``BENCHMARK.json``: no file here names one.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Mapping

PACKAGE = "benchmark"


@dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: Mapping            # configs/<config>.json
    mix: Mapping               # traffic/<traffic>.json
    limits: Mapping[str, float]
    end_to_end: List[Mapping]  # the end-to-end metrics this cell reports
    per_layer: List[Mapping]   # the per-layer metrics this cell reports
    root: Path


def _read(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path) -> ModuleType:
    """The Python file ``path`` as a module of its own (its name may hold
    dots and dashes, as the names of metrics and mixes do)."""
    spec = importlib.util.spec_from_file_location(f"_bench_{path.stem.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _reported(metric: Mapping, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(root: Path, name: str) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files."""
    bench = _read(root / "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (has {sorted(entries)})")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _read(root / configs[entry["config"]]["file"])
    base = root / PACKAGE
    mix = _read(base / "traffic" / f"{entry['traffic']}.json")
    limits = _read(base / "workloads" / f"{name}.json")["limits"]
    e2e = [m for m in bench["end_to_end"] if _reported(m, name)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if m["moves"] in reported and _reported(m, name)]
    return Cell(name, int(entry["chips"]), config, mix, limits, e2e, layer, root)


def driver(cell: Cell) -> ModuleType:
    """The traffic driver ``traffic/<kind>.py`` of the cell's mix."""
    return load_module(cell.root / PACKAGE / "traffic" / f"{cell.mix['kind']}.py")


def metric_reader(cell: Cell, name: str) -> ModuleType:
    """The reader ``metrics/<name>.py`` of a per-layer metric."""
    return load_module(cell.root / PACKAGE / "metrics" / f"{name}.py")
