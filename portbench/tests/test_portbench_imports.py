"""Neither the plain reference nor the harness loads JAX or the JAX
package; the reference loads nothing of the program either."""

import subprocess
import sys

from toy import BENCH
from pb import cell as pb_cell

SCRIPT = f"""
import sys
sys.path.insert(0, {BENCH!r})
import numpy as np
from pb import check, data, glibc, lines, reference
tr = reference.Trainer([np.full((2, 3), 0.1), np.full((2, 2), -0.2)],
                       True, "cpu")
tr.run(np.ones((2, 3)), np.array([[1.0, -1.0], [-1.0, 1.0]]))
glibc.shuffle(glibc.Random(5), 10)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "hpnn_tpu",
                                    "hpnn_tpu_torch"))
print(bad)
"""


def test_portbench_reference_loads_nothing_of_the_program():
    out = subprocess.run([sys.executable, "-c", SCRIPT], capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_portbench_guard_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "hpnn_tpu_torch_fake", sys)
    assert "hpnn_tpu_torch_fake" not in pb_cell.banned_modules()
    monkeypatch.setitem(sys.modules, "hpnn_tpu.fake", sys)
    assert "hpnn_tpu.fake" in pb_cell.banned_modules()
