"""run_nn of the PyTorch port against the JAX package's run_nn, on the CPU.

A seeded corpus of 24 sample files (plus two malformed ones that take the
reference's skip paths) at 19-16-8-5 goes through
``hpnn_tpu.cli.run_nn_main`` and ``hpnn_tpu_torch.cli.run_nn_main(...,
"--device", "cpu")``.  At float64 the ``-v -v`` stdout and the stderr
diagnostics must be byte-identical (ANN, SNN, native LNN); at float32 the
verdicts must match and the outputs agree within 1e-5.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_IN, HIDDENS, N_OUT = 19, [16, 8], 5


def _write_corpus(dirpath, n=24, seed=20260101, regression=False):
    rng = np.random.default_rng(seed)
    os.makedirs(dirpath, exist_ok=True)
    for i in range(n):
        x = rng.uniform(0.0, 255.0, N_IN)
        if regression:
            t = rng.uniform(-1.0, 1.0, N_OUT)
            tline = " ".join(f"{v:7.5f}" for v in t)
        else:
            label = int(rng.integers(N_OUT))
            tline = " ".join("1.0" if j == label else "-1.0"
                             for j in range(N_OUT))
        with open(os.path.join(dirpath, f"s{i:05d}.txt"), "w") as fp:
            fp.write(f"[input] {N_IN}\n")
            fp.write(" ".join(f"{v:7.5f}" for v in x) + "\n")
            fp.write(f"[output] {N_OUT}  #0\n{tline}\n")
    # the reference's two skip paths: a zero count and a short section
    with open(os.path.join(dirpath, "bad_count.txt"), "w") as fp:
        fp.write("[input] 0\n1 2 3\n[output] 5\n1 -1 -1 -1 -1\n")
    with open(os.path.join(dirpath, "short.txt"), "w") as fp:
        fp.write("[input] 3\n1 2 3\n[output] 5\n1 -1 -1 -1 -1\n")


def _write_case(tmp_path, kind="ANN", dtype="f64", lnn=False):
    """Kernel (dumped by the JAX package's writer), conf and test dir."""
    from hpnn_tpu.io.kernel_io import dump_kernel_to_path
    from hpnn_tpu.models.kernel import generate_kernel

    kern, _ = generate_kernel(4242, N_IN, HIDDENS, N_OUT)
    kpath = tmp_path / "kernel.opt"
    dump_kernel_to_path(kern, str(kpath))
    tests = tmp_path / "tests"
    _write_corpus(str(tests), regression=lnn)
    conf = tmp_path / "nn.conf"
    text = (f"[name] T\n[type] {kind}\n[init] {kpath}\n[seed] 10958\n"
            f"[input] {N_IN}\n[hidden] {' '.join(map(str, HIDDENS))}\n"
            f"[output] {N_OUT}\n[train] BP\n[test_dir] {tests}\n"
            f"[dtype] {dtype}\n")
    if lnn:
        text += "[lnn] native\n"
    conf.write_text(text)
    return str(conf)


def _run_both(conf, capsys):
    from hpnn_tpu.cli import run_nn_main as jax_run_nn
    from hpnn_tpu_torch.cli import run_nn

    assert jax_run_nn(["-v", "-v", conf]) == 0
    jax_io = capsys.readouterr()
    rc, outs = run_nn(["-v", "-v", "--device", "cpu", conf])
    assert rc == 0
    port_io = capsys.readouterr()
    return jax_io, port_io, outs


@pytest.mark.parametrize("kind,lnn", [("ANN", False), ("SNN", False),
                                      ("LNN", True)])
def test_run_nn_f64_stream_byte_identical(tmp_path, monkeypatch, capsys,
                                          kind, lnn):
    monkeypatch.chdir(tmp_path)
    conf = _write_case(tmp_path, kind=kind, lnn=lnn)
    jax_io, port_io, outs = _run_both(conf, capsys)
    assert port_io.out == jax_io.out
    assert port_io.err == jax_io.err
    assert "TESTING FILE:" in port_io.out
    assert "input read failed" in port_io.err
    assert "dimension mismatch" in port_io.err
    assert outs.shape == (24, N_OUT)
    marker = " MSE=" if lnn else "[PASS]" if kind == "ANN" else "BEST CLASS"
    assert marker in port_io.out


@pytest.mark.parametrize("kind", ["ANN", "SNN"])
def test_run_nn_f32_verdicts_and_outputs(tmp_path, monkeypatch, capsys,
                                         kind):
    """float32: per-file verdicts identical, outputs within 1e-5 of the
    JAX package's float32 evaluation (reduction order differs between
    XLA's per-row GEMV and torch's matmul)."""
    from hpnn_tpu import ops as jax_ops
    from hpnn_tpu.io.kernel_io import load_kernel
    import jax.numpy as jnp

    monkeypatch.chdir(tmp_path)
    conf = _write_case(tmp_path, kind=kind, dtype="f32")
    jax_io, port_io, outs = _run_both(conf, capsys)

    def verdicts(text):
        return [ln.split("\t", 1)[1].split(" P=")[0]
                .replace(" BEST CLASS", "")
                for ln in text.splitlines() if "TESTING FILE" in ln]

    assert verdicts(port_io.out) == verdicts(jax_io.out)
    from hpnn_tpu_torch.api import configure, load_tests

    nn = configure(conf)
    _, xs, _ = load_tests(nn)
    w = tuple(jnp.asarray(a, dtype=jnp.float32)
              for a in load_kernel(str(tmp_path / "kernel.opt")).weights)
    want = np.asarray(jax_ops.run_batch(w, jnp.asarray(xs, jnp.float32),
                                        kind), np.float64)
    np.testing.assert_allclose(outs, want, atol=1e-5, rtol=0)


def test_run_nn_cuda_without_gpu_exits_nonzero(tmp_path, monkeypatch,
                                               capsys):
    """--device cuda (the default) on a host with no GPU: non-zero exit,
    an error naming the cause, and nothing evaluated on the CPU."""
    from hpnn_tpu_torch.cli import run_nn

    monkeypatch.chdir(tmp_path)
    conf = _write_case(tmp_path)
    for argv in (["-v", "-v", "--device", "cuda", conf], ["-v", "-v", conf]):
        rc, outs = run_nn(argv)
        io = capsys.readouterr()
        assert rc != 0 and outs is None
        assert "TESTING FILE" not in io.out
        assert "no GPU is visible" in io.err


def test_run_nn_unported_option_exits_nonzero(tmp_path, capsys):
    from hpnn_tpu_torch.cli import run_nn_main

    with pytest.raises(SystemExit) as exc:
        run_nn_main(["--compile-cache", str(tmp_path), "nn.conf"])
    assert exc.value.code != 0
    # the JAX package's XLA cache has no counterpart: a line of its own
    assert capsys.readouterr().err == (
        "run_nn: --compile-cache names the JAX package's XLA compilation "
        "cache; the port compiles no XLA programs (refused)\n")


def test_run_nn_subprocess_imports_no_jax(tmp_path):
    """A fresh interpreter runs the port's train_nn (one epoch, then
    ``--epochs 2`` through the trainer and the resident pipeline with
    checkpoints and a replica) and run_nn on the CPU, then run_nn with
    ``--corpus-cache`` cold and warm (the warm load from the pack, through
    the native loader), then ``python -m hpnn_tpu_torch.obs.tool`` over a
    span spool, imports the serve mesh (its standby and autoscaler too),
    the SLO tracker, the C API's shim and the data tools, and then proves
    that neither jax nor any hpnn_tpu module was imported."""
    conf = _write_case(tmp_path, kind="SNN")
    train_conf = tmp_path / "train.conf"
    train_conf.write_text(
        open(conf).read().replace(f"[init] {tmp_path / 'kernel.opt'}",
                                  "[init] generate")
        + f"[sample_dir] {tmp_path / 'tests'}\n")
    code = (
        "import sys\n"
        "import os\n"
        "from hpnn_tpu_torch.cli import run_nn, train_nn_main\n"
        "os.mkdir('train')\n"
        "os.chdir('train')\n"
        f"rc = train_nn_main(['-v', '-v', '--device', 'cpu', "
        f"{str(train_conf)!r}])\n"
        "assert rc == 0, rc\n"
        f"rc = train_nn_main(['-v', '-v', '--device', 'cpu', '--epochs', "
        f"'2', '--ckpt-every', '1', '--ckpt-dir', 'ck', '--replicate-to', "
        f"'rep', {str(train_conf)!r}])\n"
        "assert rc == 0, rc\n"
        "from hpnn_tpu_torch import api\n"
        "assert api.EPOCH_METRICS['mode'] == 'resident', api.EPOCH_METRICS\n"
        "assert 'hpnn_tpu_torch.ckpt.trainer' in sys.modules\n"
        "assert os.path.isdir(os.path.join('ck', 'ep00000002'))\n"
        "os.chdir('..')\n"
        f"rc, outs = run_nn(['-v', '-v', '--device', 'cpu', {conf!r}])\n"
        "assert rc == 0 and outs.shape == (24, 5), rc\n"
        "for v in (['-v', '-v'], ['-v', '-v', '-v']):\n"
        f"    rc, again = run_nn([*v, '--device', 'cpu', '--corpus-cache', "
        f"'cc', {conf!r}])\n"
        "    assert rc == 0 and (again == outs).all(), rc\n"
        "assert len(os.listdir('cc')) == 2, os.listdir('cc')\n"
        "import runpy\n"
        "from hpnn_tpu_torch.obs.export import SpanExporter\n"
        "exp = SpanExporter('sd')\n"
        "exp.offer({'name': 'serve.request', 'trace': 't1', 'span': 's',\n"
        "           'parent': None, 'ts': 1.0, 'dur_s': 0.5})\n"
        "exp.close()\n"
        "for cmd in ('index', 'search', 'critical', 'timeline'):\n"
        "    sys.argv = ['tool', cmd, '--span-dir', 'sd']\n"
        "    try:\n"
        "        runpy.run_module('hpnn_tpu_torch.obs.tool',\n"
        "                         run_name='__main__')\n"
        "    except SystemExit as exc:\n"
        "        assert exc.code == 0, (cmd, exc.code)\n"
        "import hpnn_tpu_torch.obs.slo\n"
        "import hpnn_tpu_torch.serve.mesh\n"
        "import hpnn_tpu_torch.serve.mesh.standby\n"
        "import hpnn_tpu_torch.serve.mesh.autoscale\n"
        "import hpnn_tpu_torch.shim\n"
        "import hpnn_tpu_torch.tools.pmnist, hpnn_tpu_torch.tools.pdif\n"
        "import hpnn_tpu_torch.tools.sg_table\n"
        "assert 'hpnn_tpu_torch.serve.mesh.router' in sys.modules\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith('jax.') or m == 'hpnn_tpu'\n"
        "             or m.startswith('hpnn_tpu.'))\n"
        "assert not bad, bad\n"
        "print('NOJAX-OK')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert "NOJAX-OK" in res.stdout
    assert "BEST CLASS" in res.stdout
    assert re.search(r"\nNN\(DBG\): load: \d+ file\(s\), 24 row\(s\) in "
                     r"[0-9.]+s \(pack; native_io: on\)\n", res.stdout)
    assert res.stdout.count("N_ITER=") == 3 * 24
    assert res.stdout.count("EPOCH        2/       2") == 1
    assert (tmp_path / "train" / "kernel.opt").exists()


def test_train_nn_tile_subprocess_imports_no_jax(tmp_path):
    """A fresh interpreter runs the port's train_nn with --tile 4 and with
    --tile auto (the autotuner's heuristic) on the CPU, and proves that
    neither jax nor any hpnn_tpu module was imported."""
    conf = _write_case(tmp_path, kind="SNN")
    train_conf = tmp_path / "train.conf"
    train_conf.write_text(
        open(conf).read().replace(f"[init] {tmp_path / 'kernel.opt'}",
                                  "[init] generate")
        + f"[sample_dir] {tmp_path / 'tests'}\n")
    code = (
        "import sys\n"
        "from hpnn_tpu_torch.cli import train_nn_main\n"
        "for tile in ('4', 'auto'):\n"
        "    rc = train_nn_main(['-v', '-v', '--device', 'cpu', '--tile',\n"
        f"                        tile, {str(train_conf)!r}])\n"
        "    assert rc == 0, rc\n"
        "assert 'hpnn_tpu_torch.ops.autotune' in sys.modules\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith('jax.') or m == 'hpnn_tpu'\n"
        "             or m.startswith('hpnn_tpu.'))\n"
        "assert not bad, bad\n"
        "print('NOJAX-OK')\n")
    env = dict(os.environ, PYTHONPATH=REPO, HPNN_NO_AUTOTUNE="1")
    env.pop("HPNN_TILE", None)
    res = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert "NOJAX-OK" in res.stdout
    assert res.stdout.count("N_ITER=") == 48
    assert (tmp_path / "kernel.opt").exists()
