"""``train_nn --epochs N`` of the PyTorch port against the JAX package, on
the CPU.

The same seeded corpus (8-6-3, nine files plus one of each replayable skip
class, as tests/test_epoch_pipeline.py writes it) goes through
``hpnn_tpu.cli.train_nn_main`` and the port's ``train_nn_main`` with
``--device cpu``:

* ``-v -v --epochs 3`` for ANN BP and BPM, SNN BP and BPM, the native LNN,
  and ANN BP and BPM at ``--tile 4``: stdout and stderr byte-identical,
  ``kernel.tmp`` byte-identical, ``kernel.opt`` within 5e-12 at float64
  plus 6e-15 an iteration on SNN (the drift model tests/test_parity_fuzz.py
  holds hpnn_tpu to against the C reference);
* the port's resident route against its ``HPNN_NO_EPOCH_PIPELINE=1``
  restaging route: identical bytes, and ``EPOCH_METRICS`` showing one
  int32 permutation uploaded an epoch;
* ``HPNN_CKPT_KILL_AT_EPOCH=2`` with ``--epochs 3`` against the JAX
  package;
* a corpus whose diagnostics cannot be replayed restages with the same
  bytes; ``--epochs 1`` is the plain run; ``--replicate-to`` a mesh
  router still exits with the port's not-ported message.
"""

import contextlib
import io
import os
import re

import numpy as np
import pytest
import torch

N_IN, N_HID, N_OUT = 8, 6, 3
N_SAMP = 9
EPOCHS = 3

# variant -> (conf [type], [train], extra conf lines, extra CLI arguments)
VARIANTS = {
    "ANN-BP": ("ANN", "BP", "", ()),
    "ANN-BPM": ("ANN", "BPM", "", ()),
    "SNN-BP": ("SNN", "BP", "", ()),
    "SNN-BPM": ("SNN", "BPM", "", ()),
    "LNN-native": ("LNN", "BP", "[lnn] native\n", ()),
    "ANN-BP-tile4": ("ANN", "BP", "", ("--tile", "4")),
    "ANN-BPM-tile4": ("ANN", "BPM", "", ("--tile", "4")),
}


@pytest.fixture(autouse=True)
def _one_thread():
    """The eager loop is dispatch-bound; one intra-op thread keeps it from
    contending with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write(path, text):
    with open(path, "w") as fp:
        fp.write(text)


def _write_corpus(dirpath, rng, kind):
    """Nine separable samples (class i % 3 gets +2 on input i % 3) and one
    file of each replayable skip class: a zero input count (input read
    failed) and a short input section (dimension mismatch).  SNN and LNN
    targets are 0/1, ANN targets -1/1."""
    os.makedirs(dirpath)
    low = -1.0 if kind == "ANN" else 0.0
    for i in range(N_SAMP):
        cls = i % N_OUT
        x = rng.uniform(-1, 1, N_IN)
        x[cls] += 2.0
        t = np.full(N_OUT, low)
        t[cls] = 1.0
        _write(os.path.join(dirpath, f"s{i:03d}"),
               f"[input] {N_IN}\n" + " ".join(f"{v:7.5f}" for v in x)
               + f"\n[output] {N_OUT}\n"
               + " ".join(f"{v:.1f}" for v in t) + "\n")
    _write(os.path.join(dirpath, "bad_zero"),
           "[input] 0\n\n[output] 3\n1 0 0\n")
    _write(os.path.join(dirpath, "short_dim"),
           "[input] 2\n1 2\n[output] 3\n1 0 0\n")


def _setup(tmp_path, monkeypatch, variant="ANN-BP"):
    from hpnn_tpu.io import samples as jax_samples

    kind, train, extra, _ = VARIANTS[variant]
    rng = np.random.default_rng(7)
    _write_corpus(str(tmp_path / "samples"), rng, kind)
    _write_corpus(str(tmp_path / "tests"), rng, kind)
    (tmp_path / "nn.conf").write_text(
        f"[name] tiny\n[type] {kind}\n[init] generate\n[seed] 1234\n"
        f"[input] {N_IN}\n[hidden] {N_HID}\n[output] {N_OUT}\n"
        f"[train] {train}\n[sample_dir] ./samples\n[test_dir] ./tests\n"
        + extra)
    monkeypatch.chdir(tmp_path)
    # the JAX package's one-time native-IO warning must not enter the
    # compared streams (tests/test_epoch_pipeline.py's idiom)
    monkeypatch.setattr(jax_samples, "_native_warned", True)


def _run(fn, argv, env=None):
    """One train_nn run in the cwd: (rc, stdout, stderr, kernel.tmp text,
    kernel.opt text), with ``env`` set for the call only."""
    from hpnn_tpu_torch.utils import nn_log

    for f in ("kernel.tmp", "kernel.opt"):
        if os.path.exists(f):
            os.unlink(f)
    old = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    out, err = io.StringIO(), io.StringIO()
    try:
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            rc = fn(argv)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        nn_log.set_verbosity(0)
    texts = []
    for f in ("kernel.tmp", "kernel.opt"):
        texts.append(open(f).read() if os.path.exists(f) else None)
    return (rc, out.getvalue(), err.getvalue(), *texts)


def _jax(argv, env=None):
    import hpnn_tpu.api as jax_api
    from hpnn_tpu.cli import train_nn_main

    res = _run(train_nn_main, argv, env)
    if jax_api._prefetch_thread is not None:
        jax_api._prefetch_thread.join()
    return res


def _port(argv, env=None):
    import hpnn_tpu_torch.api as api
    from hpnn_tpu_torch.cli import train_nn_main

    res = _run(train_nn_main, [*argv[:-1], "--device", "cpu", argv[-1]],
               env)
    # the test-dir prefetch resolves the conf's relative test dir: it must
    # end before the test leaves its working directory
    if api._prefetch_thread is not None:
        api._prefetch_thread.join()
    return res


def _weights(text):
    from hpnn_tpu.io.kernel_io import load_kernel

    with open("_cmp.opt", "w") as fp:
        fp.write(text)
    return load_kernel("_cmp.opt").weights


def _assert_parity(jres, pres, kind):
    jrc, jout, jerr, jtmp, jopt = jres
    prc, pout, perr, ptmp, popt = pres
    assert jrc == prc == 0
    assert pout == jout
    assert perr == jerr
    assert ptmp == jtmp
    iters = sum(int(m) for m in re.findall(r"N_ITER=\s*(\d+)", jout))
    tol = 5e-12 + (iters * 6e-15 if kind == "SNN" else 0.0)
    werr = max(float(np.abs(a - b).max())
               for a, b in zip(_weights(jopt), _weights(popt)))
    assert werr < tol, (werr, tol, iters)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_epochs_byte_parity_with_jax(tmp_path, monkeypatch, variant):
    _setup(tmp_path, monkeypatch, variant)
    kind, _, _, extra = VARIANTS[variant]
    argv = ["-v", "-v", "--epochs", str(EPOCHS), *extra, "nn.conf"]
    jres = _jax(argv)
    pres = _port(argv)
    _assert_parity(jres, pres, kind)
    out = pres[1]
    for e in range(1, EPOCHS + 1):
        assert f"NN: EPOCH {e:8d}/{EPOCHS:8d}\n" in out
    assert out.count("TRAINING FILE:") == EPOCHS * (N_SAMP + 2)
    assert out.count("N_ITER=") == EPOCHS * N_SAMP
    assert pres[2].count("input read failed") == EPOCHS
    assert pres[2].count("dimension mismatch") == EPOCHS


@pytest.mark.parametrize("variant", ["SNN-BPM", "LNN-native",
                                     "ANN-BP-tile4"])
def test_resident_route_equals_restaging_route(tmp_path, monkeypatch,
                                               variant):
    """The same run through the resident pipeline and through
    HPNN_NO_EPOCH_PIPELINE=1: identical stdout, stderr, kernel.tmp and
    kernel.opt; the resident route uploads one int32 permutation an epoch
    and the corpus and the weights once."""
    import hpnn_tpu_torch.api as api

    _setup(tmp_path, monkeypatch, variant)
    extra = VARIANTS[variant][3]
    argv = ["-v", "-v", "--epochs", str(EPOCHS), *extra, "nn.conf"]
    api.reset_epoch_metrics()
    restage = _port(argv, {"HPNN_NO_EPOCH_PIPELINE": "1"})
    off = dict(api.EPOCH_METRICS)
    api.reset_epoch_metrics()
    resident = _port(argv)
    on = dict(api.EPOCH_METRICS)
    assert restage[0] == 0 and resident == restage
    assert off["mode"] == "restage" and off["epochs"] == EPOCHS
    assert on["mode"] == "resident" and on["epochs"] == EPOCHS
    assert on["h2d_bytes"] == EPOCHS * 4 * N_SAMP
    rows = N_SAMP * (N_IN + N_OUT) * 8
    weights = (N_HID * N_IN + N_OUT * N_HID) * 8
    assert on["setup_h2d_bytes"] == rows + weights
    assert off["setup_h2d_bytes"] == 0
    assert off["h2d_bytes"] == EPOCHS * (rows + weights)


def test_kill_hook_matches_jax(tmp_path, monkeypatch):
    """HPNN_CKPT_KILL_AT_EPOCH=2 of 3: the run stops after epoch 2 with the
    interruption line, as the JAX package's, and the same kernel.opt."""
    _setup(tmp_path, monkeypatch, "SNN-BPM")
    argv = ["-v", "-v", "--epochs", str(EPOCHS), "nn.conf"]
    env = {"HPNN_CKPT_KILL_AT_EPOCH": "2"}
    jres = _jax(argv, env)
    pres = _port(argv, env)
    _assert_parity(jres, pres, "SNN")
    out = pres[1]
    assert out.endswith("NN: CKPT: interrupted at epoch 2/3 (checkpointing "
                        "off; partial state only in kernel.opt)\n")
    assert "EPOCH        3/" not in out
    assert out.count("N_ITER=") == 2 * N_SAMP


def test_non_replayable_corpus_restages(tmp_path, monkeypatch):
    """A file whose read leaves a diagnostic the resident corpus cannot
    replay (here a warning beside a loaded sample) keeps the run on the
    restaging route, with the bytes of HPNN_NO_EPOCH_PIPELINE=1."""
    import hpnn_tpu_torch.api as api
    from hpnn_tpu_torch.io import corpus
    from hpnn_tpu_torch.utils.nn_log import nn_warn

    _setup(tmp_path, monkeypatch, "SNN-BP")
    real = corpus.read_sample_fast

    def noisy(path, n_in, n_out):
        got = real(path, n_in, n_out)
        if path.endswith("s004"):
            nn_warn(f"sample {path} read twice\n")
        return got

    monkeypatch.setattr(corpus, "read_sample_fast", noisy)
    argv = ["-v", "-v", "--epochs", str(EPOCHS), "nn.conf"]
    base = _port(argv, {"HPNN_NO_EPOCH_PIPELINE": "1"})
    api.reset_epoch_metrics()
    got = _port(argv)
    assert base[0] == 0 and got == base
    assert api.EPOCH_METRICS["mode"] == "restage"
    assert got[1].count("read twice") == EPOCHS


def test_one_epoch_is_the_plain_run(tmp_path, monkeypatch):
    _setup(tmp_path, monkeypatch, "SNN-BPM")
    plain = _port(["-v", "-v", "nn.conf"])
    one = _port(["-v", "-v", "--epochs", "1", "nn.conf"])
    assert plain[0] == 0 and one == plain
    assert "EPOCH" not in one[1]


@pytest.mark.parametrize("value", ["0", "x"])
def test_bad_epochs_value_is_a_syntax_error(tmp_path, monkeypatch, capsys,
                                            value):
    from hpnn_tpu_torch.cli import train_nn_main

    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as exc:
        train_nn_main(["--epochs", value, "--device", "cpu", "nn.conf"])
    assert exc.value.code != 0
    assert "bad --epochs parameter" in capsys.readouterr().err


@pytest.mark.parametrize("opt", ["--replicate-to"])
def test_checkpoint_options_still_exit_later(tmp_path, monkeypatch, capsys,
                                             opt):
    """Replication to a mesh router (``--replicate-to http://HOST:PORT``),
    once refused, is taken: with no router listening each bundle costs a
    warning, never the run (tests/test_torch_mesh_transport.py ships to a
    live one)."""
    from hpnn_tpu_torch.cli import train_nn_main

    _setup(tmp_path, monkeypatch)
    monkeypatch.setenv("HPNN_REPLICATE_ATTEMPTS", "1")
    rc = train_nn_main(["-v", "--epochs", "2", "--ckpt-every", "1", opt,
                        "http://127.0.0.1:1", "--device", "cpu", "nn.conf"])
    io_ = capsys.readouterr()
    assert rc == 0 and "later slice" not in io_.err
    assert io_.out.count("CKPT: replication of ") == 2
    assert (tmp_path / "kernel.opt").exists()


def test_epochs_on_cuda_without_gpu_exits_nonzero(tmp_path, monkeypatch,
                                                  capsys):
    from hpnn_tpu_torch.cli import train_nn_main

    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: this holds the CPU-only host's exit")
    _setup(tmp_path, monkeypatch)
    assert train_nn_main(["-v", "-v", "--epochs", "3", "nn.conf"]) != 0
    io_ = capsys.readouterr()
    assert "no GPU is visible" in io_.err and "TRAINING FILE" not in io_.out
    assert not (tmp_path / "kernel.opt").exists()


def test_resident_corpus_matches_jax(tmp_path, monkeypatch, capsys):
    """io.corpus.load_resident and ResidentCorpus.epoch_events against the
    JAX package's: the same rows in listing order, and for a shuffle order
    the same header events, gather indices and skip diagnostics."""
    from hpnn_tpu.io import corpus as jax_corpus
    from hpnn_tpu_torch.io import corpus
    from hpnn_tpu_torch.io.samples import list_sample_dir
    from hpnn_tpu_torch.utils.glibc_random import (GlibcRandom,
                                                   shuffled_indices)

    _setup(tmp_path, monkeypatch)
    monkeypatch.setenv("HPNN_NO_CORPUS_CACHE", "1")
    names = list_sample_dir("samples")
    jrc = jax_corpus.load_resident("samples", names, N_IN, N_OUT)
    prc = corpus.load_resident("samples", names, N_IN, N_OUT)
    assert prc.n_rows == jrc.n_rows == N_SAMP and prc.status == jrc.status
    np.testing.assert_array_equal(prc.X, jrc.X)
    np.testing.assert_array_equal(prc.T, jrc.T)
    capsys.readouterr()
    rng = GlibcRandom(1234)
    for _ in range(2):   # two epochs of one continuing stream
        order = shuffled_indices(rng, len(names))
        jev, jsel = jrc.epoch_events(order)
        jerr = capsys.readouterr().err
        pev, psel = prc.epoch_events(order)
        assert pev == jev and capsys.readouterr().err == jerr
        np.testing.assert_array_equal(psel, jsel)
        assert psel.dtype == np.int32
    assert "input read failed" in jerr and "dimension mismatch" in jerr
