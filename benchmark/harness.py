"""One run of one cell: set-up, the measured window, the traced segment
(``--trace 1``), the comparison with the reference, and the result line.

A traffic driver (``traffic/<kind>.py``) exposes ``setup(cell, device,
seed, control=False)``, which builds the program, makes the inputs from the
seed, warms up every shape the window uses and returns a session with:

* ``window(seconds)``: the measured window, returning the end-to-end
  metrics by name, ``attempted`` and ``failed``;
* ``trace()``: the per-layer summary (``trace.py``'s, with the driver's own
  counts added) of a short segment run after the window;
* ``free()``: drop the program's state, keeping what the comparison needs;
* ``check()``: the numbers compared with the reference, by name.

The driver's ``SOURCES`` name the port's kernel sources (``csrc/``) its
timed path runs: the harness builds them before set-up, all at once, and
prints the seconds apart (``build_s``, part of ``setup_s``; 0 once a run of
the checkout built them).

Each per-layer metric's reader (``metrics/<name>.py``) has ``read(summary)``
returning the number, or None where the segment held nothing to read.
"""

from __future__ import annotations

import gc
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

from benchmark import cell as cells
from benchmark import compare

FORBIDDEN = ("jax", "jaxlib", "flax", "instance_segmentation_tpu")


def sub_seeds(seed: int, n: int) -> list:
    """``n`` 63-bit seeds drawn from the run's ``--seed``."""
    state = np.random.SeedSequence(seed).generate_state(2 * n, np.uint32)
    return [int(state[2 * i]) << 31 | int(state[2 * i + 1]) >> 1 for i in range(n)]


def forbidden_modules() -> list:
    """The modules loaded in this process whose top-level name is JAX's, its
    libraries' or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def device_record(device: torch.device, chips: int, memory_peak: int) -> Dict:
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    return {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": kind,
            "count": chips, "memory_peak_bytes": memory_peak}


def build_kernels(sources) -> float:
    """Seconds to build the port's ``csrc/`` sources the driver names, all
    at once, before set-up: 0 where a run of this checkout built them."""
    from instance_segmentation_torch.kernels import build
    t0 = time.perf_counter()
    build.build_all(sources)
    return time.perf_counter() - t0


def run(cell: cells.Cell, seed: int, seconds: float, trace: bool, device: torch.device,
        t_start: float, control: bool = False, numbers: Optional[Dict] = None) -> Dict:
    """The result line of one run (see the module docstring). ``control``
    runs the driver's lower-precision control in the program's place;
    ``numbers``, if given, receives every number the comparison computed."""
    driver = cells.driver(cell)
    build_s = 0.0
    if device.type == "cuda":
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
        build_s = build_kernels(getattr(driver, "SOURCES", ()))
    session = driver.setup(cell, device, seed, control=control)
    setup_s = time.perf_counter() - t_start
    measured = session.window(seconds)
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    print(f"samples {measured['attempted']} ({measured['unit']}), memory_peak_bytes "
          f"{memory_peak}, window_s {measured['window_s']}, setup_s {setup_s} "
          f"(of it build_s {build_s})", flush=True)
    result = {"correct": False, "attempted": measured["attempted"],
              "failed": measured["failed"]}
    metrics: Dict[str, Dict] = {}
    record = device_record(device, cell.chips, memory_peak)
    if trace:
        summary = session.trace()
        for m in cell.per_layer:
            value = cells.metric_reader(cell, m["name"]).read(summary)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        record.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        result["breakdown"] = summary["breakdown"]
    else:
        values = dict(measured["metrics"], setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    session.free()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checked = session.check()
    if numbers is not None:
        numbers.update(checked)
    compared = compare.verdict(checked, cell.limits)
    result.update(correct=compare.within(compared), metrics=metrics, device=record,
                  compared=compared)
    return result
