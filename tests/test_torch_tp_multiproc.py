"""``[model]`` row sharding of the PyTorch port over gloo ranks on the CPU,
against the JAX package's row sharding on its 8-device CPU mesh.

Each rank is its own ``python -m hpnn_tpu_torch.cli`` process
(``tests/test_torch_multiproc.py``'s ``_rank_env``: ``HPNN_DISTRIBUTED``,
a coordinator on a free port, a 120 s limit a process and
``HPNN_DIST_TIMEOUT_S``), so a rank that waits forever fails one test.
The corpus is ``tests/test_torch_epochs.py``'s (8-6-3, nine samples and
two replayable skip files); its kernel is the generated one trained for
twelve epochs by the JAX package first (a second), so an epoch here is a
few hundred iterations (about ten thousand for the native LNN), not a
hundred thousand: a gloo collective costs a few hundred microseconds.

* ``[model] k`` per sample at k = 2, 3 and 4 ranks (k = 3 row-shards the
  3-row head; k = 4 pads the 6-row hidden layer to 8) for ANN, SNN and
  the native LNN, BP and BPM: stdout equal to the JAX package's
  ``[model] k`` run, kernel.opt within 1e-12 (``tests/test_parallel.py``'s
  bound for the sharded trajectory);
* ``--model-parallel 2`` and ``-S 2`` on a conf without ``[model]``;
* ``[batch] 4`` x ``[model] 2`` at world 4 against the JAX package's 2x2
  grid (``HPNN_DP_DEVICES=4``): stdout equal, kernel.opt within 1e-11
  (the data axis's all-reduce order, as ``[batch]`` alone);
* ``--epochs 3`` through the epoch pipeline (``tp-resident``,
  ``dp-tp-resident``) against ``HPNN_NO_EPOCH_PIPELINE=1``: byte for
  byte; a TP run killed at epoch 1 and resumed: the uninterrupted run's
  kernel.opt byte for byte; ``HPNN_NO_TP_OVERLAP=1`` against the ring;
* ``run_nn`` of a ``[model] 2`` conf on 2 ranks: stdout equal to the JAX
  package's ``[model] 2`` evaluation.
"""

import os
import re
import shutil
import sys

import pytest

from test_torch_epochs import _jax, _setup
from test_torch_multiproc import _lines, _spawn, _train_ranks, _werr


def _pretrained(tmp_path, monkeypatch, variant, extra=""):
    """The variant's corpus and conf whose kernel is the generated one
    after twelve JAX-package epochs (``[init] pre.opt``), plus ``extra``
    conf lines."""
    _setup(tmp_path, monkeypatch, variant)
    j = _jax(["--epochs", "12", "nn.conf"], {"HPNN_DP_DEVICES": "1"})
    assert j[0] == 0
    shutil.copy(tmp_path / "kernel.opt", tmp_path / "pre.opt")
    conf = (tmp_path / "nn.conf").read_text()
    (tmp_path / "nn.conf").write_text(
        conf.replace("[init] generate", "[init] pre.opt") + extra)
    for f in ("kernel.opt", "kernel.tmp"):
        os.unlink(tmp_path / f)


def _opt(tmp_path):
    with open(tmp_path / "kernel.opt") as fp:
        return fp.read()


def _strip_dbg(out):
    return "".join(ln for ln in out.splitlines(True)
                   if not ln.startswith("NN(DBG):"))


def _ok(ranks):
    for rc, _, err in ranks:
        assert rc == 0, err[-2000:]
    # rank 0 alone prints (a third -v's "verbosity set" line comes from
    # the parser, before the rank is known)
    assert all(_strip_dbg(o) == "" for _, o, _ in ranks[1:])
    return ranks[0][1]


PER_SAMPLE = [("ANN-BP", 2), ("ANN-BPM", 2), ("SNN-BP", 2), ("SNN-BPM", 2),
              ("LNN-native", 2), ("ANN-BP", 3), ("SNN-BPM", 3),
              ("ANN-BPM", 4), ("LNN-native", 4)]


@pytest.mark.parametrize("variant,k", PER_SAMPLE,
                         ids=[f"{v}-{k}" for v, k in PER_SAMPLE])
def test_model_k_ranks_match_jax(tmp_path, monkeypatch, variant, k):
    _pretrained(tmp_path, monkeypatch, variant, f"[model] {k}\n")
    argv = ["-v", "-v"]
    j = _jax([*argv, "nn.conf"])
    assert j[0] == 0 and "N_ITER=" in j[1]
    out0 = _ok(_train_ranks(k, argv, str(tmp_path)))
    assert "visible device" not in out0
    assert out0 == j[1]
    assert _werr(j[4], _opt(tmp_path)) < 1e-12


@pytest.mark.parametrize("flag", [["--model-parallel", "2"], ["-S", "2"]],
                         ids=["model-parallel", "dash-S"])
def test_cli_degree_ranks_match_jax(tmp_path, monkeypatch, flag):
    """``--model-parallel 2`` and ``-S 2`` shard a conf that has no
    ``[model]`` over 2 ranks, as ``[model] 2`` does in the JAX package."""
    _pretrained(tmp_path, monkeypatch, "ANN-BPM")
    argv = ["-v", "-v", *flag]
    j = _jax([*argv, "nn.conf"])
    assert j[0] == 0
    out0 = _ok(_train_ranks(2, argv, str(tmp_path)))
    assert out0 == j[1] and "N_ITER=" in out0
    assert _werr(j[4], _opt(tmp_path)) < 1e-12


@pytest.mark.parametrize("variant", ["ANN-BP", "SNN-BPM"])
def test_hybrid_grid_matches_jax_2x2(tmp_path, monkeypatch, variant):
    _pretrained(tmp_path, monkeypatch, variant, "[batch] 4\n[model] 2\n")
    argv = ["-v", "-v", "--epochs", "2"]
    j = _jax([*argv, "nn.conf"], {"HPNN_DP_DEVICES": "4"})
    assert j[0] == 0
    out0 = _ok(_train_ranks(4, argv, str(tmp_path)))
    assert "DP: hybrid mesh 2x2" in out0
    assert _lines(out0, "TRAINING BATCH") == _lines(j[1], "TRAINING BATCH")
    assert out0 == j[1]
    assert _werr(j[4], _opt(tmp_path)) < 1e-11


PIPE = {"tp-resident": (2, "ANN-BPM", "[model] 2\n"),
        "dp-tp-resident": (4, "SNN-BP", "[batch] 3\n[model] 2\n")}


@pytest.mark.parametrize("mode", list(PIPE))
def test_epochs_pipeline_equals_restage(tmp_path, monkeypatch, mode):
    world, variant, extra = PIPE[mode]
    _pretrained(tmp_path, monkeypatch, variant, extra)
    argv = ["-v", "-v", "-v", "--epochs", "3"]
    on = _ok(_train_ranks(world, argv, str(tmp_path)))
    opt_on = _opt(tmp_path)
    off = _ok(_train_ranks(world, argv, str(tmp_path),
                           {"HPNN_NO_EPOCH_PIPELINE": "1"}))
    assert f"epoch pipeline: {mode}," in on
    assert "epoch pipeline" not in off
    assert _strip_dbg(on) == _strip_dbg(off) and on.count("EPOCH") >= 3
    assert opt_on == _opt(tmp_path)


def test_kill_and_resume_is_byte_identical(tmp_path, monkeypatch):
    """A 2-rank ``[model] 2`` run killed after epoch 1 and resumed by 2
    ranks ends on the uninterrupted run's kernel.opt byte for byte (the
    row blocks are gathered into the bundle and re-sharded from it)."""
    _pretrained(tmp_path, monkeypatch, "SNN-BPM", "[model] 2\n")
    ck = ["-v", "-v", "--epochs", "3", "--ckpt-every", "1", "--ckpt-dir"]
    _ok(_train_ranks(2, [*ck, "ck_full"], str(tmp_path)))
    full = _opt(tmp_path)
    killed = _train_ranks(2, [*ck, "ck"], str(tmp_path),
                          {"HPNN_CKPT_KILL_AT_EPOCH": "1"})
    assert "CKPT: interrupted" in killed[0][1]
    os.unlink(tmp_path / "kernel.opt")
    out = _ok(_train_ranks(2, ["-v", "-v", "--epochs", "3", "--resume",
                                "--ckpt-dir", "ck"], str(tmp_path)))
    assert "EPOCH" in out
    assert _opt(tmp_path) == full


def test_no_tp_overlap_matches_the_ring(tmp_path, monkeypatch):
    """The all-gather schedule (``HPNN_NO_TP_OVERLAP=1``) against the
    ring on the 2x2 grid: the same TRAINING BATCH lines, and kernel.opt
    bit for bit at these widths (the ring's head sums two 3-wide partial
    products where the gather takes one 6-wide product)."""
    _pretrained(tmp_path, monkeypatch, "ANN-BPM", "[batch] 4\n[model] 2\n")
    argv = ["-v", "-v", "--epochs", "2"]
    ring = _ok(_train_ranks(4, argv, str(tmp_path)))
    opt_ring = _opt(tmp_path)
    gath = _ok(_train_ranks(4, argv, str(tmp_path),
                            {"HPNN_NO_TP_OVERLAP": "1"}))
    assert _lines(ring, "TRAINING BATCH") == _lines(gath, "TRAINING BATCH")
    assert opt_ring == _opt(tmp_path)


_ENGINES = r"""
import json, sys
import numpy as np, torch
from hpnn_tpu_torch import runtime
from hpnn_tpu_torch.parallel import LocalMesh, make_mesh, tp
assert runtime.init_all("cpu") == 0
rank = int(sys.argv[2])
mesh = make_mesh(1, 2) if sys.argv[3] == "ranks" else LocalMesh(["cpu"] * 2)
rng = np.random.default_rng(5)
ws = [rng.uniform(-1, 1, sh) for sh in ((6, 8), (5, 6), (3, 5))]
xs = rng.uniform(-1, 1, (7, 8))
ts = -np.ones((7, 3)); ts[np.arange(7), rng.integers(0, 3, 7)] = 1.0
got = {}
for name, dt in (("f64", torch.float64), ("bf16", torch.bfloat16)):
    w = [torch.as_tensor(v).to(dt) for v in ws]
    x = torch.as_tensor(xs).to(dt)
    for ov in (True, False):
        got[f"eval {name} {ov}"] = tp.tp_eval_batch(
            w, x, "SNN", mesh, overlap=ov).double().tolist()
    wm = [torch.as_tensor(v).to(torch.float32 if name == "bf16" else dt)
          for v in ws]
    c, _, errs = tp.tp_dp_train_epoch(
        tp.tp_dp_resident_carry(wm, mesh), x.view(1, 7, 8),
        torch.as_tensor(ts).to(dt).view(1, 7, 3), torch.ones(1, 7), "ANN",
        True, 0.01, 0.2, mesh=mesh)
    got[f"hybrid {name}"] = [a.tolist() for a in tp.tp_export_weights(c, mesh)]
    c, st = tp.tp_train_epoch_resident(
        tp.tp_resident_carry(wm, mesh), x[:2], torch.as_tensor(ts[:2]).to(dt),
        "ANN", False, mesh, delta=1e-3)
    got[f"sample {name}"] = [st.tolist()] + [
        a.tolist() for a in tp.tp_export_weights(c, mesh)]
json.dump(got, open(sys.argv[1] + f".{rank}", "w"))
runtime.deinit_all()
"""


def test_rank_engines_equal_the_local_mesh(tmp_path):
    """The three engines over 2 gloo ranks (all-gathers, all-reduces and
    the ring's point-to-point steps, f64 and bf16) give, bit for bit, what
    they give on a LocalMesh of 2 shards in one process: the same products
    in the same order."""
    import json

    out = str(tmp_path / "r")
    res = _spawn(2, [[sys.executable, "-c", _ENGINES, out, str(r), "ranks"]
                     for r in range(2)], str(tmp_path))
    for rc, _, err in res:
        assert rc == 0, err[-2000:]
    ranks = [json.load(open(f"{out}.{r}")) for r in range(2)]
    local = _spawn(1, [[sys.executable, "-c", _ENGINES, out + "l", "0",
                        "local"]], str(tmp_path), {"HPNN_DISTRIBUTED": ""})
    assert local[0][0] == 0, local[0][2][-2000:]
    want = json.load(open(f"{out}l.0"))
    assert ranks[0] == ranks[1] == want
    assert len(want) == 8


def test_run_nn_model_2_ranks_match_jax(tmp_path, monkeypatch):
    from hpnn_tpu.cli import run_nn_main

    from test_torch_epochs import _run

    _pretrained(tmp_path, monkeypatch, "SNN-BP", "[model] 2\n")
    conf = (tmp_path / "nn.conf").read_text()
    j = _run(run_nn_main, ["-v", "-v", "nn.conf"])
    assert j[0] == 0 and "TESTING FILE" in j[1]
    cmd = [sys.executable, "-m", "hpnn_tpu_torch.cli", "run_nn", "-v", "-v",
           "--device", "cpu", "nn.conf"]
    ranks = _spawn(2, [cmd, cmd], str(tmp_path))
    out0 = _ok(ranks)
    assert re.findall(r"TESTING FILE[^\n]*\n", out0) \
        == re.findall(r"TESTING FILE[^\n]*\n", j[1]) != []
    assert out0 == j[1]
    assert "[model]" in conf
