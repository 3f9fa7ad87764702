"""The readings that the limits of ``correct`` are set from: runs of one cell
on many seeds in one process, the program's and the lower-precision
control's, each at the cell's own size with a short window.

    python3 -m benchmark.readings --workload NAME --seeds 12 --control-seeds 3 \
        --seconds 5 [--first-seed N] [--out FILE]

One JSON line per run (``kind`` "program", "control" or the planted
``--fault``, the seed, the
numbers compared, the end-to-end metrics, the set-up seconds); the control
is the port's int8 path for serving and the reference in float8 for
training (see ``traffic/*.py``). Needs a CUDA card, as the benchmark does.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

from benchmark import faults


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, default=12)
    parser.add_argument("--control-seeds", type=int, default=3,
                        help="runs of the lower-precision control after the program's")
    parser.add_argument("--seconds", type=float, default=5.0)
    parser.add_argument("--first-seed", type=int, default=3_000_000_000)
    parser.add_argument("--fault", choices=sorted(faults.FAULTS), default=None,
                        help="plant this fault in the port for the program's runs")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)

    import torch
    from benchmark import cell as cells, harness

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    cell = cells.load(Path.cwd(), args.workload)
    device = torch.device("cuda", 0)
    out = open(args.out, "a") if args.out else None
    runs = [("program", args.first_seed + i) for i in range(args.seeds)]
    runs += [("control", args.first_seed + 1000 + i) for i in range(args.control_seeds)]
    for kind, seed in runs:
        planted = (faults.FAULTS[args.fault]() if args.fault and kind == "program"
                   else contextlib.nullcontext())
        numbers = {}
        with planted:
            result = harness.run(cell, seed, args.seconds, False, device, time.perf_counter(),
                                 control=kind == "control", numbers=numbers)
        kind = args.fault if args.fault and kind == "program" else kind
        line = json.dumps({"workload": args.workload, "kind": kind, "seed": seed,
                           "numbers": numbers, "correct": result["correct"],
                           "metrics": {k: v["value"] for k, v in result["metrics"].items()},
                           "attempted": result["attempted"],
                           "memory_peak_bytes": result["device"]["memory_peak_bytes"]})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
