"""A toy cell for the CPU tests: the harness's whole run on the program's
CPU path at a size a test holds."""

from __future__ import annotations

import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
sys.path.insert(0, BENCH)
sys.path.insert(1, os.path.dirname(BENCH))

from pb import cell as pb_cell  # noqa: E402
from pb import spec  # noqa: E402


def toy_cell(cache_dir: str, train: str = "BP", samples: int = 8,
             rows: int = 1) -> spec.Cell:
    config = {
        "name": "toy", "type": "ANN", "input": 16, "hidden": [8],
        "output": 2, "train": train, "dtype": "f64",
        "corpus": {"generator": "toy_blobs", "samples": samples,
                   "width": 16, "classes": 2, "scale": 60.0,
                   "data_seed": 3},
        "check": {"warmup_rows": rows, "replay_first_iterations": 4000,
                  "replay_last_epochs": 2, "replay_epoch_iterations": 4000,
                  "limits": {"order_errors": 0, "row_mismatch": 0,
                             "err_gap": 1e-8, "w_gap": 1e-9,
                             "epoch_w_gap": 1e-9, "unreplayed": 0}},
    }
    traffic = {"name": "toy", "kernel": "b1", "verbosity": 3}
    bench = spec.load_json(os.path.join(os.path.dirname(BENCH),
                                        "BENCHMARK.json"))
    return spec.Cell(name="toy", config=config, traffic=traffic,
                     end_to_end=bench["end_to_end"],
                     per_layer=[m for m in bench["per_layer"]
                                if "workloads" not in m],
                     cache_dir=cache_dir)


def run(cell, seed: int = 5, seconds: float = 3.0, trace: bool = False,
        dtype: str | None = None) -> dict:
    return pb_cell.run(cell, seed, seconds, trace, "cpu",
                       time.perf_counter(), dtype=dtype)
