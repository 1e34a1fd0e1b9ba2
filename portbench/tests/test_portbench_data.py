"""The corpus generators repeat themselves byte for byte; the frozen XRD
conversion is the program's pdif; the kernel file and the conf read back
in the program as written."""

import hashlib
import os

import numpy as np
import pytest

from toy import spec, toy_cell
from pb import data

SPECS = {
    "rruff_synthetic": {"groups": 2, "per_group": 2, "data_seed": 55},
    "toy_blobs": {"samples": 4, "width": 16, "classes": 2, "scale": 60.0,
                  "data_seed": 3},
}


def _digest(root):
    h = hashlib.sha256()
    for name in sorted(os.listdir(root)):
        h.update(name.encode())
        with open(os.path.join(root, name), "rb") as f:
            h.update(f.read())
    return h.hexdigest()


@pytest.mark.parametrize("gen", sorted(SPECS))
def test_portbench_generator_byte_stable(gen, tmp_path):
    mod = spec.load_module("corpora", gen)
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir()
    b.mkdir()
    mod.generate(str(a), SPECS[gen])
    mod.generate(str(b), SPECS[gen])
    assert _digest(a) == _digest(b)
    x, t = data.read_sample(os.path.join(a, sorted(os.listdir(a))[0]))
    assert np.isfinite(x).all() and sorted(set(t.tolist())) == [-1.0, 1.0]


def test_portbench_rruff_conversion_is_pdif(tmp_path):
    """A DIF and raw pair as the repository's XRD artifact writes them,
    converted by the program's pdif, gives the generator's bytes."""
    from hpnn_tpu_torch.tools import pdif

    rr = spec.load_module("corpora", "rruff_synthetic")
    gen = tmp_path / "gen"
    gen.mkdir()
    rr.generate(str(gen), {"groups": 1, "per_group": 1, "data_seed": 9})
    rng = np.random.default_rng(9)
    peaks = [(float(rng.uniform(8, 85)), float(rng.uniform(300, 900)))
             for _ in range(5)]
    peaks += [(float(rng.uniform(8, 85)), float(rng.uniform(80, 400)))
              for _ in range(3)]
    t = np.arange(5.0, 90.0, 0.1)
    inten = np.zeros_like(t)
    for p, i in peaks:
        inten = inten + i * np.exp(-((t - p) ** 2) / 0.05)
    inten = inten + rng.uniform(0, 3, t.size)
    (tmp_path / "dif").mkdir()
    (tmp_path / "raw").mkdir()
    (tmp_path / "dif" / "R000000").write_text(
        "R000000 synthetic\nSample at T = 25 C\n"
        "CELL PARAMETERS: 5.4 5.4 5.4 90.0 90.0 90.0\nSPACE GROUP: P1\n"
        "WAVELENGTH: 1.541838\n2-THETA INTENSITY\n"
        + "".join(f"{a:.2f} {b:.2f}\n" for a, b in peaks) + "END\n")
    (tmp_path / "raw" / "R000000").write_text(
        "### synthetic XY spectrum\n"
        + "".join(f"{a:.3f} {b:.4f}\n" for a, b in zip(t, inten))
        + "# end\n")
    out = tmp_path / "out"
    out.mkdir()
    assert pdif.main([str(tmp_path), "-i", "850", "-o", "230", "-s",
                      str(out)]) == 0
    assert (out / "R000000").read_bytes() == (gen / "R000000").read_bytes()


def test_portbench_kernel_and_conf_read_back(tmp_path):
    from hpnn_tpu_torch.io import conf as conf_io, kernel_io

    cell = toy_cell(str(tmp_path / "cache"))
    w = data.draw_weights(cell.config, 2**31 + 12345, "cpu")
    kpath = tmp_path / "k.init"
    kpath.write_text(data.kernel_text(cell.config, w))
    got = kernel_io.load_kernel(str(kpath))
    assert all(np.array_equal(a, b) for a, b in zip(got.weights, w))
    cpath = tmp_path / "nn.conf"
    cpath.write_text(data.conf_text(cell, str(kpath), "/x", 2**31 + 12345))
    conf = conf_io.load_conf(str(cpath))
    assert conf.seed == data.conf_seed(2**31 + 12345) and conf.tile == 0
    assert conf.train == "BP" and conf.n_inputs == 16
