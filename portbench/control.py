#!/usr/bin/env python3
"""Readings that the output check's limits are set from: runs of one cell
in one process, one a seed, each printed as a JSON line with its compared
numbers.  ``--dtype f64`` is the program as the configuration states it
(the lower readings); ``--dtype f32`` is the control, the program's own
float32 path in its place, and ``--fault NAME`` a fault of
``pb/faults.py`` planted under the timed path, acting on the window's
epochs alone: both have to come out not correct (the upper readings).
The benchmark's own runs never run this.

    python3 portbench/control.py --workload <name> --seeds 1,2,3 \\
        --seconds <s> --dtype f64|f32 [--fault NAME]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))

from pb import cell as pb_cell  # noqa: E402
from pb import faults, spec  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--dtype", choices=("f64", "f32"), default="f64")
    ap.add_argument("--fault", choices=faults.NAMES)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        pb_cell.log("no CUDA card visible")
        return 2
    cell = spec.cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        with (faults.planted(args.fault) if args.fault
              else contextlib.nullcontext()):
            r = pb_cell.run(cell, seed, args.seconds, False, "cuda:0",
                            time.perf_counter(), dtype=args.dtype)
        print(json.dumps({"seed": seed, "dtype": args.dtype,
                          "fault": args.fault,
                          "correct": r["correct"], "check": r["check"],
                          "window": r["window"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
