"""The port's jax-free modules (conf, sample and kernel I/O, the glibc
stream, weight carry-over) against the JAX package's, on the same inputs.
Everything here is exact: the two sides must agree bit for bit."""

import numpy as np
import pytest
import torch

from hpnn_tpu.io import conf as jax_conf
from hpnn_tpu.io import kernel_io as jax_kio
from hpnn_tpu.io import samples as jax_samples
from hpnn_tpu.models import kernel as jax_kernel
from hpnn_tpu.utils import glibc_random as jax_rng
from hpnn_tpu_torch.io import conf as t_conf
from hpnn_tpu_torch.io import kernel_io as t_kio
from hpnn_tpu_torch.io import samples as t_samples
from hpnn_tpu_torch.models import kernel as t_kernel
from hpnn_tpu_torch.utils import glibc_random as t_rng

CONFS = {
    "mnist": ("[name] MNIST\n[type] ANN\n[init] generate\n[seed] 10958\n"
              "[input] 784\n[hidden] 300\n[output] 10\n[train] BP\n"
              "[sample_dir] ./samples\n[test_dir] ./tests\n"),
    "quirky": ("# comment [name] ignored?\n[name]   xrd#tail\n[type] SNN\n"
               "[init] kernel.opt extra\n[seed] 12abc\n[hidden] 4 5 x 6\n"
               "[train] BPM\n[dtype] bf16\n[tile] auto\n[test_dir] t \n"),
    "lnn": ("[name] R\n[type] LNN\n[lnn] native\n[trainer] cg\n"
            "[init] generate\n[input] 3\n[hidden] 2\n[output] 1\n"),
    "malformed": "[name] x\n[init] generate\n",
}

KERNELS = {
    # short line zero-fills, junk reads one 0.0 per char
    "strtod": ("[name] t\n[param] 3 2 2\n[input] 3\n[hidden 1] 2\n"
               "[neuron 1] 3\n 0.1 0.2\n[neuron 2] 3\n 0.1 zz 0.1\n"
               "[output] 2\n[neuron 1] 2\n 0.3 0.1\n[neuron 2] 2\n"
               " -0.1 0.2\n"),
    # a neuron declaring fewer inputs: per-neuron stride layout
    "stride": ("[name] t\n[param] 3 2 2\n[input] 3\n[hidden 1] 2\n"
               "[neuron 1] 2\n 0.1 0.2\n[neuron 2] 3\n 0.1 0.2 0.1\n"
               "[output] 2\n[neuron 1] 2\n 0.3 0.1\n[neuron 2] 2\n"
               " -0.1 0.2\n"),
    # no [output] section: a zero output layer, the load succeeds
    "no-output": ("[name] t\n[param] 3 2 2\n[input] 3\n[hidden 1] 2\n"
                  "[neuron 1] 3\n 0.1 0.2 0.3\n[neuron 2] 3\n 1 2 3\n"),
    # a missing neuron: the reference's error lines, no kernel
    "missing-neuron": ("[name] t\n[param] 3 2 2\n[input] 3\n"
                       "[hidden 1] 2\n[neuron 1] 3\n 0.1 0.2 0.3\n"),
}


@pytest.mark.parametrize("name", sorted(CONFS))
def test_conf_parse_matches(tmp_path, capsys, name):
    p = tmp_path / "nn.conf"
    p.write_text(CONFS[name])
    a = jax_conf.load_conf(str(p))
    a_io = capsys.readouterr()
    b = t_conf.load_conf(str(p))
    b_io = capsys.readouterr()
    assert (a is None) == (b is None)
    if a is not None:
        assert vars(a) == vars(b)
    assert a_io == b_io


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_load_kernel_matches(tmp_path, capsys, name):
    p = tmp_path / "k.opt"
    p.write_text(KERNELS[name])
    a = jax_kio.load_kernel(str(p))
    a_err = capsys.readouterr().err
    b = t_kio.load_kernel(str(p))
    b_err = capsys.readouterr().err
    assert a_err == b_err
    assert (a is None) == (b is None)
    if a is not None:
        assert a.name == b.name
        assert len(a.weights) == len(b.weights)
        for x, y in zip(a.weights, b.weights):
            assert np.array_equal(x, y)


@pytest.mark.parametrize("seed,n_in,hiddens,n_out",
                         [(10958, 19, [16, 8], 5), (1, 4, [3], 2),
                          (4294967295, 7, [1, 1, 1], 3)])
def test_generate_and_dump_match(tmp_path, seed, n_in, hiddens, n_out):
    """generate_kernel draws the same glibc stream; dumps_kernel writes the
    same bytes; dump -> load round-trips through both packages alike."""
    ka, sa = jax_kernel.generate_kernel(seed, n_in, hiddens, n_out)
    kb, sb = t_kernel.generate_kernel(seed, n_in, hiddens, n_out)
    assert sa == sb
    for x, y in zip(ka.weights, kb.weights):
        assert np.array_equal(x, y)
    text = t_kio.dumps_kernel(kb)
    assert text == jax_kio.dumps_kernel(ka)
    p = tmp_path / "kernel.opt"
    t_kio.dump_kernel_to_path(kb, str(p))
    assert p.read_bytes() == text.encode("latin-1")
    back = jax_kio.load_kernel(str(p))
    for x, y in zip(back.weights, t_kio.load_kernel(str(p)).weights):
        assert np.array_equal(x, y)


@pytest.mark.parametrize("body", [
    "[input] 4\n1 2 3 4\n[output] 2\n1.0 -1.0\n",
    "[input] 5\n1 2 3\n[output] 2  #1\n-1.0 1.0\n",      # stale buffer
    "[input] 3\n0x1p3 nan zz\n[output] 1\ninf\n",        # strtod forms
    "[input] 0\n1\n[output] 1\n1\n",                     # zero count
    "[output] 2\n1 1\n[input] 2\n0.5 0.25",              # no final newline
])
def test_read_sample_matches(tmp_path, capsys, body):
    p = tmp_path / "s.txt"
    p.write_text(body)
    a = jax_samples.read_sample(str(p))
    a_err = capsys.readouterr().err
    b = t_samples.read_sample(str(p))
    assert capsys.readouterr().err == a_err
    for x, y in zip(a, b):
        assert (x is None) == (y is None)
        if x is not None:
            np.testing.assert_array_equal(x, y)


def test_glibc_stream_and_shuffle_match():
    for seed in (1, 10958, 2**31 + 5):
        assert np.array_equal(jax_rng.GlibcRandom(seed).randoms(100),
                              t_rng.GlibcRandom(seed).randoms(100))
        assert (jax_rng.shuffled_indices(seed, 37)
                == t_rng.shuffled_indices(seed, 37))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16])
def test_weights_to_torch_round_trip(dtype):
    """float64 -> torch -> float64 is exact at float64, and at lower
    precision equals the values rounded once to the dtype (a second trip
    changes nothing)."""
    kern, _ = t_kernel.generate_kernel(77, 9, [6, 4], 3)
    ts = t_kernel.weights_to_torch(kern.weights, dtype, "cpu")
    assert all(t.dtype == dtype and t.is_contiguous() for t in ts)
    back = t_kernel.weights_to_numpy(ts)
    if dtype == torch.float64:
        for w, b in zip(kern.weights, back):
            assert np.array_equal(w, b)
    again = t_kernel.weights_to_numpy(
        t_kernel.weights_to_torch(back, dtype, "cpu"))
    for b, c in zip(back, again):
        assert b.dtype == np.float64 and np.array_equal(b, c)
    mlp = t_kernel.MLP.from_kernel(kern, dtype, "cpu", "SNN")
    assert [tuple(w.shape) for w in mlp.weights] == [(6, 9), (4, 6), (3, 4)]
    out = mlp(torch.zeros((2, 9), dtype=dtype))
    assert out.shape == (2, 3) and out.dtype == dtype


@pytest.mark.parametrize("value", [None, "", "42", "-3", "nope", "4.5",
                                   "0", "3", "99", " 7 "])
def test_env_knobs_match_jax(value, monkeypatch):
    """The port's tolerant env-knob parsers (``utils/env.py``, a verbatim
    copy) answer as the JAX package's do for set, empty, malformed,
    negative and over-asking values, clamps included."""
    from hpnn_tpu.utils import env as jax_env
    from hpnn_tpu_torch.utils import env as t_env

    if value is None:
        monkeypatch.delenv("HPNN_TEST_KNOB", raising=False)
    else:
        monkeypatch.setenv("HPNN_TEST_KNOB", value)
    for kw in ({}, {"lo": 1}, {"hi": 8}, {"lo": 2, "hi": 16}):
        assert (t_env.env_int("HPNN_TEST_KNOB", 7, **kw)
                == jax_env.env_int("HPNN_TEST_KNOB", 7, **kw))
        assert (t_env.env_float("HPNN_TEST_KNOB", 1.5, **kw)
                == jax_env.env_float("HPNN_TEST_KNOB", 1.5, **kw))
    for default in (None, 1, 20):
        assert (t_env.env_device_cap("HPNN_TEST_KNOB", 8, default)
                == jax_env.env_device_cap("HPNN_TEST_KNOB", 8, default))


def test_cg_state_carries_across_the_packages():
    """The CG carry the JAX package writes (``run_cg_epoch``'s
    ``trainer_state``) goes into the port's padded device layout and back
    to the same bundle payload, bit for bit; a mismatched size is None."""
    import jax.numpy as jnp

    from hpnn_tpu.train.cg import run_cg_epoch
    from hpnn_tpu_torch.models.kernel import (trainer_state_to_numpy,
                                              trainer_state_to_torch)

    class NN:
        pass

    nn = NN()
    nn.conf = type("C", (), {"batch": 0, "seed": 1})()
    nn.trainer_state = None
    rng = np.random.default_rng(2)
    ws = (rng.normal(size=(4, 5)), rng.normal(size=(3, 4)))
    run_cg_epoch(nn, ws, rng.normal(size=(6, 5)), rng.normal(size=(6, 3)),
                 "LNN", jnp.float64)
    st = nn.trainer_state
    total = 4 * 5 + 3 * 4
    d, g, have, restarts = trainer_state_to_torch(st, total, 3,
                                                  torch.float64, "cpu")
    assert d.shape == (total + (-total) % 3,) and have is True
    back = trainer_state_to_numpy(d, g, total, restarts,
                                  int(st["cg_meta"][2]))
    for k in ("cg_d", "cg_g", "cg_meta"):
        assert back[k].dtype == st[k].dtype
        assert np.array_equal(back[k], st[k])
    assert trainer_state_to_torch(st, total + 1, 1, torch.float64,
                                  "cpu") is None
