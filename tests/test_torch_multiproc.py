"""Multi-process data parallelism of the PyTorch port: N gloo ranks on the
CPU against one process of the JAX package.

Each rank is its own ``python -m hpnn_tpu_torch.cli train_nn --device cpu``
process with ``HPNN_DISTRIBUTED=1``, ``HPNN_COORDINATOR`` (a port chosen
free at run time), ``HPNN_NUM_PROCESSES`` and ``HPNN_PROCESS_ID``; every
process has a 120 s limit and ``HPNN_DIST_TIMEOUT_S`` bounds each
collective, so a hung rendezvous fails one test.  Only rank 0 prints, as
in the JAX package.

* 2 and 4 ranks of ``[batch]`` BP/BPM (restaged and resident) and of CG
  under ``[batch]`` against the JAX package's single-process run on the
  same corpus (``HPNN_DP_DEVICES=1``): every ``TRAINING BATCH`` /
  ``TRAINING CG`` line equal, kernel.opt within 1e-11 ([batch]) and 1e-9
  (CG) -- the ranks' partial sums are all-reduced, so only the summation
  order differs;
* the module-level ``dp_epoch`` at 2 ranks against one process, and the
  BPM momentum held as a 1/N slice a rank (measured);
* the agreement gate: a rank whose sample dir is missing ends every rank
  non-zero, with the bailout named;
* the snapshot barrier: a 2-rank checkpointed run writes one bundle an
  epoch stamped ``world_size`` 2; stopped by a signal and resumed by 2 ranks
  it ends on the uninterrupted run's kernel.opt byte for byte; one process
  refuses the bundle.
"""

import json
import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest

from test_torch_epochs import _jax, _setup, VARIANTS, _weights

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIMIT_S = 120


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_env(world, rank, port, extra=None):
    env = dict(os.environ)
    env.update({"HPNN_DISTRIBUTED": "1",
                "HPNN_COORDINATOR": f"127.0.0.1:{port}",
                "HPNN_NUM_PROCESSES": str(world),
                "HPNN_PROCESS_ID": str(rank),
                "HPNN_DIST_TIMEOUT_S": "60",
                "OMP_NUM_THREADS": "1",
                "PYTHONPATH": REPO + os.pathsep + env.get("PYTHONPATH", "")})
    env.update(extra or {})
    return env


def _spawn(world, cmds, cwd, extra=None):
    """Start one process a rank (``cmds[rank]`` its argv) and wait for all:
    a list of (rc, stdout, stderr).  A rank past the limit kills them
    all and fails the test."""
    port = _free_port()
    procs = [subprocess.Popen(cmds[r], cwd=cwd, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              env=_rank_env(world, r, port, extra))
             for r in range(world)]
    out = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=LIMIT_S)
            out.append((p.returncode, o, e))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"a rank passed {LIMIT_S} s")
    return out


def _train_ranks(world, argv, cwd, extra=None, confs=None):
    cmds = [[sys.executable, "-m", "hpnn_tpu_torch.cli", "train_nn", *argv,
             "--device", "cpu", (confs[r] if confs else "nn.conf")]
            for r in range(world)]
    return _spawn(world, cmds, cwd, extra)


def _setup_with(tmp_path, monkeypatch, variant, extra):
    kind, train, conf_extra, _ = VARIANTS[variant]
    VARIANTS["_mp"] = (kind, train, conf_extra + extra, ())
    try:
        _setup(tmp_path, monkeypatch, "_mp")
    finally:
        VARIANTS.pop("_mp")


def _lines(out, tag):
    return re.findall(rf"{tag}[^\n]*\n", out)


def _werr(a, b):
    return max(float(np.abs(x - y).max())
               for x, y in zip(_weights(a), _weights(b)))


CASES = {
    "bpm-resident": ("ANN-BPM", "[batch] 4\n", ["--epochs", "3"], {}),
    "snn-restage": ("SNN-BP", "[batch] 3\n", ["--epochs", "2"],
                    {"HPNN_NO_EPOCH_PIPELINE": "1"}),
    "cg-batch": ("SNN-BP", "[batch] 4\n", ["--epochs", "2", "--trainer",
                                           "cg"], {}),
}


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_ranks_match_one_jax_process(tmp_path, monkeypatch, case, world):
    variant, extra, flags, env = CASES[case]
    _setup_with(tmp_path, monkeypatch, variant, extra)
    argv = ["-v", "-v", *flags]
    j = _jax([*argv, "nn.conf"], {"HPNN_DP_DEVICES": "1", **env})
    assert j[0] == 0
    ranks = _train_ranks(world, argv, str(tmp_path), env)
    for rc, _, err in ranks:
        assert rc == 0, err[-2000:]
    out0 = ranks[0][1]
    assert all(o == "" for _, o, _ in ranks[1:])  # rank 0 alone prints
    tag = "TRAINING CG" if case.startswith("cg") else "TRAINING BATCH"
    assert _lines(out0, tag) == _lines(j[1], tag) != []
    if not case.startswith("cg"):
        assert "one device visible" not in out0
        assert "over 1 data-shard" not in out0
    with open(tmp_path / "kernel.opt") as fp:
        opt = fp.read()
    assert _werr(j[4], opt) < (1e-9 if case.startswith("cg") else 1e-11)


_DP_EPOCH = r"""
import json, sys
import numpy as np, torch
from hpnn_tpu_torch import runtime
from hpnn_tpu_torch.parallel import coord, dp, mesh
assert runtime.init_all("cpu") == 0
world, rank = coord.world_size(), coord.process_index()
rng = np.random.default_rng(5)
shapes = ((5, 7), (3, 5))
ws = [torch.as_tensor(rng.uniform(-1, 1, sh)) for sh in shapes]
xb = torch.as_tensor(rng.uniform(-1, 1, (4, 6, 7)))
tb = torch.as_tensor(np.where(rng.uniform(size=(4, 6, 3)) > .5, 1., 0.))
mb = torch.ones(4, 6, dtype=torch.float64)
mb[3, 4:] = 0
lo, hi = mesh.shard_bounds(6, world, rank)
w, dw, errs = dp.dp_epoch(dp.dp_resident_carry(ws, world), xb[:, lo:hi],
                          tb[:, lo:hi], mb[:, lo:hi], "SNN", True, 0.01, 0.2,
                          shapes, world, rank)
json.dump({"w": w.tolist(), "errs": errs.tolist(), "dw": dw.numel()},
          open(sys.argv[1] + f".{rank}", "w"))
runtime.deinit_all()
"""


def test_dp_epoch_two_ranks_equal_one_process(tmp_path):
    """``dp_epoch`` over 2 gloo ranks (each its 3 slots of 6) equals the
    one-process epoch within summation-order ULPs, and each rank holds
    half of the padded BPM momentum."""
    import torch

    from hpnn_tpu_torch.parallel import dp

    out = str(tmp_path / "r")
    res = _spawn(2, [[sys.executable, "-c", _DP_EPOCH, out]] * 2,
                 str(tmp_path))
    for rc, _, err in res:
        assert rc == 0, err[-2000:]
    got = [json.load(open(f"{out}.{r}")) for r in range(2)]
    rng = np.random.default_rng(5)
    shapes = ((5, 7), (3, 5))
    ws = [torch.as_tensor(rng.uniform(-1, 1, sh)) for sh in shapes]
    xb = torch.as_tensor(rng.uniform(-1, 1, (4, 6, 7)))
    tb = torch.as_tensor(np.where(rng.uniform(size=(4, 6, 3)) > .5, 1., 0.))
    mb = torch.ones(4, 6, dtype=torch.float64)
    mb[3, 4:] = 0
    w, dw, errs = dp.dp_epoch(dp.dp_resident_carry(ws), xb, tb, mb, "SNN",
                              True, 0.01, 0.2, shapes)
    total = 5 * 7 + 3 * 5
    assert dw.numel() == total
    for g in got:
        assert g["dw"] == total // 2           # 50 weights, 25 a rank
        assert g["w"] == got[0]["w"]           # every rank the same carry
        assert np.abs(np.asarray(g["w"]) - w.numpy()).max() < 1e-15
        assert np.abs(np.asarray(g["errs"]) - errs.numpy()).max() < 1e-15


def test_missing_sample_dir_on_one_rank_ends_every_rank(tmp_path,
                                                        monkeypatch):
    """Rank 1's conf names a sample dir that does not exist: both ranks
    meet the agreement gate and exit non-zero within the limit, rank 0
    naming the bailout; nothing is trained."""
    _setup_with(tmp_path, monkeypatch, "ANN-BP", "[batch] 4\n")
    conf = (tmp_path / "nn.conf").read_text()
    (tmp_path / "bad.conf").write_text(
        conf.replace("./samples", "./no_such_dir"))
    for flags in ([], ["--epochs", "2"]):
        ranks = _train_ranks(2, ["-v", "-v", *flags], str(tmp_path),
                             confs=["nn.conf", "bad.conf"])
        assert all(rc != 0 for rc, _, _ in ranks), ranks
        assert "coordinated bailout" in ranks[0][2]
        assert "FAILED to train kernel!" in ranks[1][2]


def test_snapshot_barrier_bundles_and_resume(tmp_path, monkeypatch):
    """Two ranks with ``--ckpt-every 1``: one bundle an epoch, stamped
    world_size 2 with its barrier epoch; stopped by a signal and resumed by
    two ranks, the run ends on the uninterrupted run's kernel.opt byte for
    byte; one process refuses the 2-rank bundle."""
    _setup_with(tmp_path, monkeypatch, "ANN-BPM", "[batch] 4\n")
    full, part = tmp_path / "full", tmp_path / "part"
    for d in (full, part):
        d.mkdir()
    argv = ["-v", "-v", "--epochs", "3", "--ckpt-every", "1",
            "--ckpt-dir", "ck"]
    conf = str(tmp_path / "nn.conf")
    text = open(conf).read().replace("./", str(tmp_path) + "/")
    with open(conf, "w") as fp:
        fp.write(text)
    r_full = _train_ranks(2, argv, str(full), confs=[conf, conf])
    assert all(rc == 0 for rc, _, _ in r_full), r_full[0][2]
    tags = sorted(os.listdir(full / "ck"))
    bundles = [t for t in tags if t.startswith("ep")]
    assert bundles == ["ep00000001", "ep00000002", "ep00000003"]
    for t in bundles:
        meta = json.loads((full / "ck" / t / "snapshot.json").read_text())
        assert meta["world_size"] == 2 and meta["barrier_epoch"] == int(t[2:])
    kill = {"HPNN_CKPT_KILL_AT_EPOCH": "1"}
    r_kill = _train_ranks(2, argv, str(part), kill, confs=[conf, conf])
    assert all(rc == 0 for rc, _, _ in r_kill)
    # the kill hook's signal lands after epoch 1's stop agreement, so the
    # ranks agree on it at the next boundary (as in the JAX package)
    assert "interrupted at epoch 2/3" in r_kill[0][1]
    resume = ["-v", "-v", "--epochs", "3", "--resume", "--ckpt-dir", "ck"]
    r_res = _train_ranks(2, resume, str(part), confs=[conf, conf])
    assert all(rc == 0 for rc, _, _ in r_res), r_res[0][2]
    assert (part / "kernel.opt").read_bytes() == \
        (full / "kernel.opt").read_bytes()
    mark = "NN: EPOCH        3/       3\n"
    assert r_res[0][1][r_res[0][1].index(mark):] == \
        r_full[0][1][r_full[0][1].index(mark):]
    one = subprocess.run(
        [sys.executable, "-m", "hpnn_tpu_torch.cli", "train_nn", *resume,
         "--device", "cpu", conf], cwd=str(part), text=True,
        capture_output=True, timeout=LIMIT_S,
        env={**os.environ, "PYTHONPATH": REPO})
    assert one.returncode != 0
    assert "written by a 2-process run, but this run has 1" in one.stderr


def test_dp_devices_below_the_world_is_refused(tmp_path, monkeypatch):
    """``HPNN_DP_DEVICES=1`` in a 2-rank run asks ranks to sit out, which
    the port cannot express: every rank refuses it by name and exits
    non-zero before any collective."""
    _setup_with(tmp_path, monkeypatch, "ANN-BP", "[batch] 4\n")
    ranks = _train_ranks(2, ["-v", "-v"], str(tmp_path),
                         {"HPNN_DP_DEVICES": "1"})
    assert all(rc != 0 for rc, _, _ in ranks)
    assert "HPNN_DP_DEVICES=1 < 2 processes" in ranks[0][2]
    assert "FAILED to train kernel!" in ranks[1][2]
