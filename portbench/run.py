#!/usr/bin/env python3
"""The benchmark of hpnn_tpu_torch, the PyTorch and CUDA port: one run of
one cell on the card this process sees.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout.  ``--trace 0`` prints the cell's
end-to-end metrics (``train_iters_per_s`` over the window's whole epochs,
``setup_s`` from this process's start to the window's), ``--trace 1`` its
per-layer metrics from a profiled window.  Every run then checks what the
window's training produced against the plain reference and prints each
compared number beside its limit, on standard error and under ``check``
in the result, which is the last line of standard output.

Exits non-zero with no result when no CUDA card is visible, when the
program is missing or fails, or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))

from pb import cell as pb_cell  # noqa: E402
from pb import spec  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        pb_cell.log("no CUDA card visible: nothing measured")
        return 2
    result = pb_cell.run(cell, args.seed, args.seconds, bool(args.trace),
                         "cuda:0", T_START)
    found = pb_cell.banned_modules()
    if found:
        pb_cell.log(f"JAX or the JAX package was loaded: {found}")
        return 3
    for name, v in result["check"].items():
        pb_cell.log(f"check {name} {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
