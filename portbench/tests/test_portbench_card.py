"""On a card: the XRD cell through the benchmark's command, for
``run_seconds``: a shorter window ends before the short epochs that the
check replays whole, and reads not correct.
Run there with ``python -m pytest portbench/tests -m card``."""

import json
import os
import subprocess
import sys

import pytest

from toy import BENCH


@pytest.mark.card
def test_portbench_cell_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card visible: the benchmark runs only on one")
    root = os.path.dirname(BENCH)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        seconds = json.load(f)["run_seconds"]
    out = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload",
         "xrd_ann_bpm.per_sample", "--seed", "4242", "--seconds",
         str(seconds), "--trace", "0"], cwd=root, capture_output=True,
        text=True, timeout=1500)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["check"]
    assert result["metrics"]["train_iters_per_s"]["value"] > 0
