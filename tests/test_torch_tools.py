"""The port's data tools (``hpnn_tpu_torch.tools``) against the JAX
package's (``hpnn_tpu.tools``): the same synthetic idx and DIF inputs as
``tests/test_tools.py`` through both, and the written trees, stdout,
stderr and exit codes compared byte for byte."""

import os
import struct
import subprocess
import sys

import pytest

from hpnn_tpu.tools import pdif as jax_pdif
from hpnn_tpu.tools import pmnist as jax_pmnist
from hpnn_tpu.tools import sg_table as jax_sg
from hpnn_tpu_torch.tools import pdif, pmnist, sg_table

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DIF_TEXT = """Quartz
Sample: powder, T = 25 C
CELL PARAMETERS: 4.913 4.913 5.405 90.0 90.0 120.0
SPACE GROUP: P3_221
X-RAY WAVELENGTH: 1.541838
        2-THETA      INTENSITY
        20.85         55.00
        26.63        100.00
"""

RAW_TEXT = """##RRUFF raw header
4.00 1.0
10.0 2.0
20.0 10.0
50.0 4.0
89.0 1.0
"""

# each pdif case: the DIF text of R001 (R002 always the plain one)
DIF_CASES = {
    "sample": DIF_TEXT,
    "unknown_space_group": DIF_TEXT.replace("P3_221", "Zz_99"),
    "kelvin": DIF_TEXT.replace("T = 25 C", "T = 100 K"),
    "mo_wavelength": DIF_TEXT.replace("1.541838", "0.710730"),
    "no_peaks": DIF_TEXT.split("        2-THETA")[0],
}


def _write_idx(root, stem, images, labels, rows=2, cols=2):
    with open(root / f"{stem}_labels", "wb") as fp:
        fp.write(struct.pack(">II", 0x801, len(labels)))
        fp.write(bytes(labels))
    with open(root / f"{stem}_images", "wb") as fp:
        fp.write(struct.pack(">IIII", 0x803, len(images), rows, cols))
        for img in images:
            fp.write(bytes(img))


def _mnist_root(root):
    root.mkdir()
    _write_idx(root, "train",
               [[0, 128, 255, 7], [1, 2, 3, 4], [9, 8, 7, 6]], [3, 0, 9])
    _write_idx(root, "test", [[5, 5, 5, 5], [250, 0, 0, 1]], [1, 2])
    (root / "samples").mkdir()
    (root / "tests").mkdir()
    return root


def _rruff_root(root, dif_text):
    (root / "rruff" / "dif").mkdir(parents=True)
    (root / "rruff" / "raw").mkdir()
    (root / "samples").mkdir()
    (root / "rruff" / "dif" / "R001.txt").write_text(dif_text)
    (root / "rruff" / "raw" / "R001.txt").write_text(RAW_TEXT)
    (root / "rruff" / "dif" / "R002.txt").write_text(DIF_TEXT)
    (root / "rruff" / "raw" / "R002.txt").write_text(RAW_TEXT)
    return root


def _tree(root, sub):
    out = {}
    base = root / sub
    for dirpath, _, files in os.walk(base):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fp:
                out[os.path.relpath(p, base)] = fp.read()
    return out


def _run(main, root, argv, monkeypatch, capsys):
    monkeypatch.chdir(root)
    capsys.readouterr()
    rc = main(list(argv))
    io_ = capsys.readouterr()
    return rc, io_.out, io_.err


@pytest.mark.parametrize("quirks", [False, True])
def test_pmnist_trees_equal(tmp_path, monkeypatch, capsys, quirks):
    argv = (["--reference-quirks"] if quirks else []) + ["samples", "tests"]
    a = _mnist_root(tmp_path / "jax")
    b = _mnist_root(tmp_path / "port")
    ra = _run(jax_pmnist.main, a, argv, monkeypatch, capsys)
    rb = _run(pmnist.main, b, argv, monkeypatch, capsys)
    assert ra == rb and ra[0] == 0
    for sub in ("samples", "tests"):
        ta, tb = _tree(a, sub), _tree(b, sub)
        assert ta and ta == tb


@pytest.mark.parametrize("case", list(DIF_CASES))
def test_pdif_trees_equal(tmp_path, monkeypatch, capsys, case):
    argv = ["rruff", "-i", "10", "-o", "230"]
    a = _rruff_root(tmp_path / "jax", DIF_CASES[case])
    b = _rruff_root(tmp_path / "port", DIF_CASES[case])
    ra = _run(jax_pdif.main, a, argv, monkeypatch, capsys)
    rb = _run(pdif.main, b, argv, monkeypatch, capsys)
    assert ra == rb and ra[0] == 0
    ta, tb = _tree(a, "samples"), _tree(b, "samples")
    assert "R002.txt" in ta and ta == tb


@pytest.mark.parametrize("argv", [["-h"], ["rruff", "-i", "x"], []])
def test_pdif_usage_and_errors_equal(tmp_path, monkeypatch, capsys, argv):
    a = _rruff_root(tmp_path / "jax", DIF_TEXT)
    b = _rruff_root(tmp_path / "port", DIF_TEXT)
    assert _run(jax_pdif.main, a, argv, monkeypatch, capsys) == \
        _run(pdif.main, b, argv, monkeypatch, capsys)


def test_space_groups_equal():
    assert sg_table.SPACE_GROUPS == jax_sg.SPACE_GROUPS
    assert len(sg_table.SPACE_GROUPS) >= 230


def test_tools_run_as_modules(tmp_path):
    """``python -m hpnn_tpu_torch.tools.pmnist`` and ``...pdif`` in fresh
    interpreters write the same trees as the JAX package's modules; the
    port's tools load neither torch nor jax nor the JAX package."""
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    for pkg in ("hpnn_tpu", "hpnn_tpu_torch"):
        root = _mnist_root(tmp_path / pkg)
        _rruff_root(root / "x", DIF_TEXT)
        for mod, args, cwd in (
                ("pmnist", ["--reference-quirks", "samples", "tests"], root),
                ("pdif", ["rruff", "-i", "10", "-o", "230"], root / "x")):
            r = subprocess.run([sys.executable, "-m", f"{pkg}.tools.{mod}",
                                *args], cwd=cwd, capture_output=True,
                               text=True, env=env, timeout=120)
            assert r.returncode == 0, r.stderr
    a, b = tmp_path / "hpnn_tpu", tmp_path / "hpnn_tpu_torch"
    assert _tree(a, "tests") and _tree(a, "tests") == _tree(b, "tests")
    assert _tree(a / "x", "samples") == _tree(b / "x", "samples")
    probe = ("import sys\n"
             "from hpnn_tpu_torch.tools import pdif, pmnist, sg_table\n"
             "bad = [m for m in sys.modules if m == 'torch' or m == "
             "'hpnn_tpu' or m.startswith(('jax', 'hpnn_tpu.', 'torch.'))]\n"
             "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", probe], cwd=tmp_path,
                       capture_output=True, text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr
