"""The host-streamed shard mode of the port's epoch pipeline against the
JAX package's, on the CPU.

``HPNN_EPOCH_SHARD_ROWS`` (forced) or a corpus over
``HPNN_EPOCH_DEVICE_BUDGET_MB`` keeps the corpus on the host and uploads
each epoch's shuffled rows a shard at a time: the same seeded corpus goes
through ``hpnn_tpu.cli.train_nn_main`` and the port's under the same
environment, and the stdout, stderr and kernel.tmp must be byte-identical
and kernel.opt within the parity bound of ``test_torch_epochs.py``; per
sample the sharded run must also equal the port's resident run byte for
byte.  A ``[batch]`` corpus over the budget restages.
"""

import contextlib
import io
import os
import shutil

import numpy as np
import pytest
import torch

from test_torch_epochs import _assert_parity, _jax, _port

N_IN, N_HID, N_OUT, N_SAMP = 64, 3, 2, 9
EPOCHS = 3
ROW_BYTES = (N_IN + N_OUT) * 8


def _conf_text(init, train="BP", extra=""):
    return (f"[name] shard\n[type] ANN\n[init] {init}\n[seed] 1234\n"
            f"[input] {N_IN}\n[hidden] {N_HID}\n[output] {N_OUT}\n"
            f"[train] {train}\n[sample_dir] ./samples\n[test_dir] ./tests\n"
            + extra)


def _corpus(dirpath, rng):
    """Nine separable rows (class i % 2 at 1 on input i % 2, the rest in
    [0, 0.01)) and one file of each replayable skip class."""
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
    with open(os.path.join(dirpath, "bad_zero"), "w") as fp:
        fp.write(f"[input] 0\n\n[output] {N_OUT}\n1 0\n")
    with open(os.path.join(dirpath, "short_dim"), "w") as fp:
        fp.write(f"[input] 2\n1 2\n[output] {N_OUT}\n1 0\n")


@pytest.fixture(scope="module")
def pretrained(tmp_path_factory):
    """The corpus and a kernel the JAX package trained 2 epochs from a
    generated one: from it an epoch takes a few hundred iterations, where
    a generated kernel's takes tens of thousands in the port's eager CPU
    loop."""
    from hpnn_tpu import api as jax_api
    from hpnn_tpu.cli import train_nn_main
    from hpnn_tpu.io import samples as jax_samples

    root = tmp_path_factory.mktemp("shard")
    rng = np.random.default_rng(5)
    _corpus(str(root / "samples"), rng)
    _corpus(str(root / "tests"), rng)
    (root / "nn.conf").write_text(_conf_text("generate"))
    cwd = os.getcwd()
    warned = jax_samples._native_warned
    jax_samples._native_warned = True
    os.chdir(root)
    try:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert train_nn_main(["--epochs", "2", "nn.conf"]) == 0
        if jax_api._prefetch_thread is not None:
            jax_api._prefetch_thread.join()
    finally:
        os.chdir(cwd)
        jax_samples._native_warned = warned
    os.rename(root / "kernel.opt", root / "pre.opt")
    os.unlink(root / "kernel.tmp")
    return root


def _setup(tmp_path, monkeypatch, pretrained, train="BP", extra=""):
    from hpnn_tpu.io import samples as jax_samples

    for d in ("samples", "tests"):
        shutil.copytree(pretrained / d, tmp_path / d)
    shutil.copy(pretrained / "pre.opt", tmp_path / "pre.opt")
    (tmp_path / "nn.conf").write_text(_conf_text("pre.opt", train, extra))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(jax_samples, "_native_warned", True)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def launches(monkeypatch):
    """Counts the epoch function's calls and their rows (one call a shard
    on the CPU, where a card launches ``train_epoch`` or ``train_tile``
    once a shard)."""
    from hpnn_tpu_torch import ops

    calls = []
    select = ops.select_train_epoch

    def counted(*a, **k):
        fn, name = select(*a, **k)

        def run(*fa, **fk):
            calls.append(int(fa[1].shape[0]))
            return fn(*fa, **fk)
        return run, name

    monkeypatch.setattr(ops, "select_train_epoch", counted)
    return calls


def _shards(k):
    """An epoch's shard sizes at k rows a shard."""
    return [k] * (N_SAMP // k) + ([N_SAMP % k] if N_SAMP % k else [])


def _metrics():
    import hpnn_tpu_torch.api as api

    return dict(api.EPOCH_METRICS)


def _reset():
    import hpnn_tpu_torch.api as api

    api.reset_epoch_metrics()


@pytest.mark.parametrize("train,rows", [("BPM", "1"), ("BP", "2"),
                                        ("BPM", "4"), ("BP", "3")])
def test_forced_shard_rows_per_sample(tmp_path, monkeypatch, pretrained,
                                      launches, train, rows):
    """Shards of 1, 2 and 4 rows (neither divides the 9 rows) and 3: the
    JAX package's stream and kernels under the same environment, and the
    port's resident run's bytes; one epoch-function call a shard, the
    epoch's rows uploaded each epoch and the corpus never at setup."""
    _setup(tmp_path, monkeypatch, pretrained, train)
    argv = ["-v", "-v", "--epochs", str(EPOCHS), "nn.conf"]
    env = {"HPNN_EPOCH_SHARD_ROWS": rows}
    jres = _jax(argv, env)
    _reset()
    pres = _port(argv, env)
    m = _metrics()
    _assert_parity(jres, pres, "ANN")
    assert pres[1].count("TRAINING FILE:") == EPOCHS * (N_SAMP + 2)
    assert m["mode"] == "sharded" and m["epochs"] == EPOCHS
    assert launches == _shards(int(rows)) * EPOCHS
    assert m["h2d_bytes"] == EPOCHS * N_SAMP * ROW_BYTES
    assert m["setup_h2d_bytes"] == (N_HID * N_IN + N_OUT * N_HID) * 8
    del launches[:]
    resident = _port(argv)
    assert _metrics()["mode"] == "resident" and launches == [N_SAMP] * 3
    assert resident == pres


@pytest.mark.parametrize("value", ["128", "9", "0", "x"])
def test_out_of_range_shard_rows_is_resident(tmp_path, monkeypatch,
                                             pretrained, launches, value):
    """A set ``HPNN_EPOCH_SHARD_ROWS`` that is not below the row count (or
    is not a count) forces the resident upload and turns the budget check
    off, even under a budget the corpus exceeds; the bytes equal the JAX
    package's under the same environment."""
    _setup(tmp_path, monkeypatch, pretrained)
    argv = ["-v", "-v", "--epochs", "2", "nn.conf"]
    env = {"HPNN_EPOCH_SHARD_ROWS": value,
           "HPNN_EPOCH_DEVICE_BUDGET_MB": "0"}
    jres = _jax(argv, env)
    _reset()
    pres = _port(argv, env)
    _assert_parity(jres, pres, "ANN")
    assert _metrics()["mode"] == "resident" and launches == [N_SAMP] * 2


@pytest.mark.parametrize("train,rows", [("BP", "4"), ("BPM", "5")])
def test_forced_shard_rows_at_tile(tmp_path, monkeypatch, pretrained,
                                   launches, train, rows):
    """At ``--tile 4`` each shard is one batched-tile call whose groups
    start at the shard's first row, as in the JAX package: its bytes under
    the same environment."""
    _setup(tmp_path, monkeypatch, pretrained, train)
    argv = ["-v", "-v", "--epochs", str(EPOCHS), "--tile", "4", "nn.conf"]
    env = {"HPNN_EPOCH_SHARD_ROWS": rows}
    jres = _jax(argv, env)
    _reset()
    pres = _port(argv, env)
    _assert_parity(jres, pres, "ANN")
    assert _metrics()["mode"] == "sharded"
    assert launches == _shards(int(rows)) * EPOCHS


def test_shard_rows_from_the_budget():
    """The budget's arithmetic, as the JAX package's (api.py's build):
    over the budget, shards of budget // row_bytes // 2 rows; a set
    HPNN_EPOCH_SHARD_ROWS decides alone; a budget of 0 never shards."""
    import hpnn_tpu_torch.api as api

    cpu = torch.device("cpu")
    env = dict(os.environ)
    try:
        for k in ("HPNN_EPOCH_SHARD_ROWS", "HPNN_EPOCH_DEVICE_BUDGET_MB"):
            os.environ.pop(k, None)
        # the CPU default is the JAX package's 4096 MB
        assert api._shard_rows(512, 6352, 1, cpu) == 0
        assert api._shard_rows(700_000, 6352, 1, cpu) == \
            (4096 << 20) // 6352 // 2
        os.environ["HPNN_EPOCH_DEVICE_BUDGET_MB"] = "1"
        assert api._shard_rows(512, 6352, 1, cpu) == 82   # 7 shards of 512
        assert -(-512 // api._shard_rows(512, 6352, 1, cpu)) == 7
        assert api._shard_rows(165, 6352, 1, cpu) == 0     # under 1 MiB
        assert api._shard_rows(512, 6352, 4, cpu) == 0     # a quarter each
        assert api._shard_rows(512, 3 << 20, 1, cpu) == 1  # at least one
        os.environ["HPNN_EPOCH_DEVICE_BUDGET_MB"] = "0"
        assert api._shard_rows(700_000, 6352, 1, cpu) == 0
        os.environ["HPNN_EPOCH_SHARD_ROWS"] = "128"
        assert api._shard_rows(512, 6352, 1, cpu) == 128
        assert api._shard_rows(128, 6352, 1, cpu) == 0
    finally:
        os.environ.clear()
        os.environ.update(env)


def _wide_corpus(root, n, n_in, seed):
    rng = np.random.default_rng(seed)
    os.makedirs(root)
    for i in range(n):
        cls = i % 2
        x = rng.uniform(0, 0.01, n_in)
        x[cls] += 1.0
        t = [-1.0, -1.0]
        t[cls] = 1.0
        with open(os.path.join(root, f"w{i:03d}"), "w") as fp:
            fp.write(f"[input] {n_in}\n"
                     + " ".join(f"{v:7.5f}" for v in x)
                     + f"\n[output] 2\n{t[0]:.1f} {t[1]:.1f}\n")


def test_budget_trigger_matches_jax(tmp_path, monkeypatch, launches):
    """A corpus over ``HPNN_EPOCH_DEVICE_BUDGET_MB=1`` (40 rows of 4096
    inputs, 32,784 bytes a row: 1.25 MiB) trains in shards of 1 MiB /
    32,784 / 2 = 15 rows, 3 a epoch: the JAX package's bytes under the
    same environment, and per sample the resident run's."""
    from hpnn_tpu.io import samples as jax_samples

    n, n_in = 40, 4096
    _wide_corpus(str(tmp_path / "samples"), n, n_in, 3)
    _wide_corpus(str(tmp_path / "tests"), 4, n_in, 4)
    (tmp_path / "nn.conf").write_text(
        f"[name] wide\n[type] ANN\n[init] generate\n[seed] 77\n"
        f"[input] {n_in}\n[hidden] 3\n[output] 2\n[train] BP\n"
        "[sample_dir] ./samples\n[test_dir] ./tests\n")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(jax_samples, "_native_warned", True)
    argv = ["-v", "-v", "--epochs", "2", "nn.conf"]
    env = {"HPNN_EPOCH_DEVICE_BUDGET_MB": "1"}
    jres = _jax(argv, env)
    _reset()
    pres = _port(argv, env)
    _assert_parity(jres, pres, "ANN")
    assert _metrics()["mode"] == "sharded"
    assert launches == [15, 15, 10] * 2
    del launches[:]
    assert _port(argv) == pres
    assert _metrics()["mode"] == "resident" and launches == [n, n]


def test_batch_over_budget_restages(tmp_path, monkeypatch, pretrained):
    """A ``[batch]`` corpus over the budget leaves the pipeline with the
    JAX package's debug line and restages, with the bytes of the
    ``HPNN_NO_EPOCH_PIPELINE=1`` run."""
    _setup(tmp_path, monkeypatch, pretrained, extra="[batch] 4\n")
    argv = ["-v", "-v", "--epochs", "2", "nn.conf"]
    line = ("NN(DBG): epoch pipeline: [batch]/[model] corpus over the "
            "per-device budget (host-stream sharding is single-device "
            "machinery); restaging\n")
    env = {"HPNN_EPOCH_SHARD_ROWS": "3"}
    assert _port(["-v", *argv], env)[1].count(line) == 1
    _reset()
    forced = _port(argv, env)
    assert _metrics()["mode"] == "dp-restage"
    restage = _port(argv, {"HPNN_NO_EPOCH_PIPELINE": "1"})
    assert forced[0] == 0 and forced == restage
