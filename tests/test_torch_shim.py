"""The port's C API on the CPU: ``csrc/hpnn_shim.c`` built by gcc through
``hpnn_tpu_torch.ops.build``, the JAX package's C programs of the public
API (``native/train_nn.c``, ``native/run_nn.c``) compiled unmodified
against the port's headers and library and run with ``HPNN_DEVICE=cpu``,
held against ``hpnn_tpu.cli`` in process: the ``-v -v`` stream and
``kernel.tmp`` byte-identical, ``kernel.opt`` within 5e-12.  The port's
``apitest`` walks the whole ``_NN`` surface; ``hpnn_tpu_torch.shim`` gives
``hpnn_tpu.shim``'s tuples, weights and ``dump_conf`` bytes; and the
library driven in process through ``ctypes.PyDLL`` trains and runs a
kernel with the port's epoch and forward.
"""

import contextlib
import ctypes
import io
import os
import shutil
import subprocess

import numpy as np
import pytest

from test_reference_parity import _corpus

N_IN, N_HID, N_OUT, N_SAMP = 64, 3, 2, 9

pytestmark = pytest.mark.skipif(shutil.which("gcc") is None
                                and shutil.which("cc") is None,
                                reason="needs a host C compiler")


@pytest.fixture(scope="module")
def built():
    from hpnn_tpu_torch.ops import build

    return {"lib": build.shim_library(),
            **{n: build.c_program(n) for n in build.C_PROGRAMS}}


def _conf_text(init):
    return (f"[name] shim\n[type] ANN\n[init] {init}\n[seed] 4321\n"
            f"[input] {N_IN}\n[hidden] {N_HID}\n[output] {N_OUT}\n"
            "[train] BPM\n[sample_dir] ./samples\n[test_dir] ./tests\n")


def _write_corpus(dirpath, rng):
    os.makedirs(dirpath)
    for i in range(N_SAMP):
        cls = i % N_OUT
        x = rng.uniform(0, 0.01, N_IN)
        x[cls] += 1.0
        t = np.full(N_OUT, -1.0)
        t[cls] = 1.0
        with open(os.path.join(dirpath, f"s{i:03d}"), "w") as fp:
            fp.write(f"[input] {N_IN}\n" + " ".join(f"{v:7.5f}" for v in x)
                     + f"\n[output] {N_OUT}\n"
                     + " ".join(f"{v:.1f}" for v in t) + "\n")
    with open(os.path.join(dirpath, "short_dim"), "w") as fp:
        fp.write(f"[input] 2\n1 2\n[output] {N_OUT}\n1 0\n")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Nine separable rows and a skip-class file, and a kernel the JAX
    package trained 2 epochs from a generated one (from it an epoch takes
    a few hundred iterations of the port's eager CPU loop)."""
    from hpnn_tpu.cli import train_nn_main
    from hpnn_tpu.io import samples as jax_samples

    root = tmp_path_factory.mktemp("shim")
    rng = np.random.default_rng(11)
    _write_corpus(str(root / "samples"), rng)
    _write_corpus(str(root / "tests"), rng)
    (root / "nn.conf").write_text(_conf_text("generate"))
    cwd, warned = os.getcwd(), jax_samples._native_warned
    jax_samples._native_warned = True
    os.chdir(root)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            assert train_nn_main(["--epochs", "2", "nn.conf"]) == 0
    finally:
        os.chdir(cwd)
        jax_samples._native_warned = warned
    os.rename(root / "kernel.opt", root / "pre.opt")
    (root / "nn.conf").write_text(_conf_text("pre.opt"))
    (root / "cont.conf").write_text(_conf_text("kernel.opt"))
    return root


def _copy(corpus, dest):
    shutil.copytree(corpus, dest)
    for f in ("kernel.tmp", "kernel.opt"):
        if os.path.exists(dest / f):
            os.unlink(dest / f)
    return dest


def _run_c(binary, args, cwd, device="cpu"):
    env = dict(os.environ, HPNN_DEVICE=device)
    env.pop("HPNN_PYROOT", None)
    return subprocess.run([binary, *args], cwd=cwd, capture_output=True,
                          text=True, timeout=300, env=env)


def _jax_cli(fn, argv, cwd, monkeypatch):
    from hpnn_tpu.io import samples as jax_samples

    monkeypatch.chdir(cwd)
    monkeypatch.setattr(jax_samples, "_native_warned", True)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = fn(argv)
    return rc, out.getvalue(), err.getvalue()


def _weights(path):
    from hpnn_tpu.io.kernel_io import load_kernel

    return load_kernel(str(path)).weights


def test_c_train_and_run_match_the_jax_cli(tmp_path, built, corpus,
                                           monkeypatch):
    import hpnn_tpu.api as jax_api
    from hpnn_tpu.cli import run_nn_main, train_nn_main

    c_dir = _copy(corpus, tmp_path / "c")
    j_dir = _copy(corpus, tmp_path / "jax")
    mine = _run_c(built["train_nn"], ["-v", "-v", "nn.conf"], c_dir)
    assert mine.returncode == 0, mine.stderr
    jrc, jout, jerr = _jax_cli(train_nn_main, ["-v", "-v", "nn.conf"],
                               j_dir, monkeypatch)
    if jax_api._prefetch_thread is not None:
        jax_api._prefetch_thread.join()
    assert jrc == 0
    assert mine.stdout == jout and mine.stderr == jerr
    assert mine.stdout.count("TRAINING FILE:") == N_SAMP + 1
    assert (c_dir / "kernel.tmp").read_bytes() == \
        (j_dir / "kernel.tmp").read_bytes()
    for a, b in zip(_weights(c_dir / "kernel.opt"),
                    _weights(j_dir / "kernel.opt")):
        assert np.abs(a - b).max() <= 5e-12
    # run_nn of each one's kernel.opt
    mine = _run_c(built["run_nn"], ["-v", "-v", "cont.conf"], c_dir)
    assert mine.returncode == 0, mine.stderr
    jrc, jout, jerr = _jax_cli(run_nn_main, ["-v", "-v", "cont.conf"], j_dir,
                               monkeypatch)
    assert jrc == 0
    assert mine.stdout == jout and mine.stderr == jerr
    assert mine.stdout.count("[PASS]") >= N_SAMP - 1


def test_c_programs_usage_and_missing_gpu(tmp_path, built, corpus):
    c_dir = _copy(corpus, tmp_path / "c")
    out = _run_c(built["train_nn"], ["-h"], c_dir)
    assert out.returncode == 0 and "usage:  train_nn" in out.stdout
    out = _run_c(built["train_nn"], ["missing.conf"], c_dir)
    assert out.returncode != 0
    assert "FAILED to read NN configuration file" in out.stderr
    # the default device is the card: without one, init_all's NN(ERR)
    # line and no training
    out = _run_c(built["train_nn"], ["nn.conf"], c_dir, device="cuda")
    assert out.returncode != 0
    assert "NN(ERR): CUDA device requested but no GPU is visible" in \
        out.stderr
    assert "FAILED to train kernel!" in out.stderr
    assert not (c_dir / "kernel.opt").exists()


def test_apitest_walks_the_whole_surface(tmp_path, built):
    _corpus(tmp_path, n=1, kind="ANN", train="BP", seed=4242)
    out = _run_c(built["apitest"], [], tmp_path)
    assert out.returncode == 0, (out.stdout[-800:], out.stderr[-800:])
    assert out.stdout.endswith("APITEST PASS\n")
    # its dumps through the C FILE* path are the reference text formats
    from hpnn_tpu_torch.io.kernel_io import load_kernel

    k = load_kernel(str(tmp_path / "apitest.kernel"))
    assert k is not None and k.hiddens == [4, 5]
    assert "[name] apitest" in (tmp_path / "apitest.conf.out").read_text()


def test_shim_functions_match_jax(tmp_path, corpus):
    """The same calls through ``hpnn_tpu.shim`` and the port's: enum
    mapping, the mirror tuple, conf_set, generate_kernel_dims (weights and
    the written-back seed), load_kernel_file, the dump_kernel and
    dump_conf bytes, the hidden-layer queries and read_sample_lists."""
    import hpnn_tpu.shim as jshim

    import hpnn_tpu_torch.shim as pshim

    assert pshim._TYPE_TO_INT == jshim._TYPE_TO_INT
    assert pshim._TRAIN_TO_INT == jshim._TRAIN_TO_INT
    out = {}
    for tag, mod in (("jax", jshim), ("port", pshim)):
        nn = mod.new_nndef()
        for key, value in (("name", "x"), ("type", 2), ("need_init", 1),
                           ("seed", 77), ("train", 1),
                           ("samples", "./samples"), ("tests", "./tests")):
            mod.conf_set(nn, key, value)
        rec = [mod.conf_as_tuple(nn)]
        with contextlib.redirect_stdout(io.StringIO()):
            rec.append(mod.generate_kernel_dims(nn, 6, 3, [4, 5]))
        rec += [mod.conf_as_tuple(nn), mod.get_n_hiddens(nn),
                [mod.get_h_neurons(nn, i) for i in range(3)],
                nn.n_inputs, nn.n_outputs]
        buf = io.StringIO()
        rec.append(mod.dump_kernel_to(nn, buf))
        rec.append(buf.getvalue())
        buf = io.StringIO()
        mod.dump_conf_to(nn, buf)
        rec.append(buf.getvalue())
        rec.append([np.asarray(w).tolist() for w in nn.kernel.weights])
        mod.conf_set(nn, "type", 0)
        mod.conf_set(nn, "f_kernel", str(corpus / "pre.opt"))
        with contextlib.redirect_stdout(io.StringIO()):
            rec.append(mod.load_kernel_file(nn))
        rec.append([np.asarray(w).tolist() for w in nn.kernel.weights])
        mod.free_kernel(nn)
        rec += [nn.kernel, mod.dump_kernel_to(nn, io.StringIO()),
                mod.get_n_hiddens(nn),
                mod.read_sample_lists(str(corpus / "samples" / "s000")),
                mod.read_sample_lists(str(tmp_path / "missing"))]
        with pytest.raises(KeyError):
            mod.conf_set(nn, "bogus", 1)
        out[tag] = rec
    assert out["jax"] == out["port"]


def test_in_process_through_pydll(tmp_path, corpus, built, monkeypatch):
    """``ctypes.PyDLL`` (the interpreter lock held across each call) in
    this process: _NN(init,all), _NN(load,conf), _NN(train,kernel) and
    _NN(run,kernel) go through the port's epoch and forward (counted by
    wrapping the selectors) on the CPU."""
    from hpnn_tpu_torch import ops
    from hpnn_tpu_torch.utils import nn_log

    calls = {"train": 0, "run": 0}

    def counting(select, key):
        def sel(*a, **k):
            fn, name = select(*a, **k)

            def run(*fa, **fk):
                calls[key] += 1
                return fn(*fa, **fk)
            return run, name
        return sel

    monkeypatch.setattr(ops, "select_train_epoch",
                        counting(ops.select_train_epoch, "train"))
    monkeypatch.setattr(ops, "select_run_batch",
                        counting(ops.select_run_batch, "run"))
    c_dir = _copy(corpus, tmp_path / "c")
    monkeypatch.chdir(c_dir)
    monkeypatch.setenv("HPNN_DEVICE", "cpu")
    lib = ctypes.PyDLL(built["lib"])
    lib.nn_load_conf.restype = ctypes.c_void_p
    lib.nn_load_conf.argtypes = [ctypes.c_char_p]
    for fn in ("nn_train_kernel", "nn_run_kernel", "nn_free_conf"):
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    try:
        assert lib.nn_init_all(0) == 0
        assert lib.nn_return_capabilities() & (1 << 8)
        conf = lib.nn_load_conf(b"nn.conf")
        assert conf
        with contextlib.redirect_stdout(io.StringIO()):
            assert lib.nn_train_kernel(conf) == 1
            lib.nn_run_kernel(conf)
        lib.nn_free_conf(conf)
    finally:
        lib.nn_deinit_all()
        nn_log.set_verbosity(0)
    assert calls == {"train": 1, "run": 1}
