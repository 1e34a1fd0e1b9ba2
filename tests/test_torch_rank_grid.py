"""Ranks that hold several devices: the PyTorch port's (data x model) grid
over every rank's devices against the JAX package's global mesh, on the
CPU.

Two gloo ranks (``HPNN_DISTRIBUTED``, a coordinator on a free port) hold
two CPU shards each (``api.device_slice(["cpu"] * 2)`` in the rank's
worker), against the JAX package's own multi-process run: two processes
of two XLA CPU devices each (``tests/test_multihost.py``'s launch with
``--xla_force_host_platform_device_count=2``), and against one JAX process
of four devices (``HPNN_DP_DEVICES=4`` on ``tests/conftest.py``'s eight).
Each side runs every case in one launch a rank (one process group, one
``jax.distributed`` service), the case's CLI in its own directory.  The
corpus is tests/test_torch_epochs.py's (8-6-3, nine files and two skip
files); the per-sample cases start from its kernel trained for twelve
epochs by the JAX package.

* ``[batch] 4`` BP (restaged) and BPM (``--epochs 2``, resident), the 2x2
  ``[batch] 4`` x ``[model] 2`` grid (each model group within a rank),
  ``[model] 2`` per sample (a group within a rank, a replica on each),
  ``[model] 4`` per sample (the group across the ranks), ``[batch] 4`` CG
  and ``run_nn`` of a ``[model] 2`` and a ``[model] 4`` conf (the ring's
  steps within a rank and across the ranks): the ``TRAINING`` / ``TESTING``
  lines byte-identical, kernel.opt within 1e-11 (``[batch]``, grid),
  1e-12 (per sample) and 1e-9 (CG), as PERF.md section 2 states.
* ``[batch]`` + ``[tile]`` across the ranks: the JAX package's warning,
  minibatch DP, its two processes' lines.
* Where the JAX package's two processes fail (its flat ``[batch]`` BPM and
  CG state is fetched from devices the process does not address; its
  second process holds no shard of a ``[model] 2`` axis), the test shows
  the failure and holds the port to the one 4-device process.
* An explicit card: the shard devices chosen for ``cuda``, ``cuda:1`` and a
  slice, with ``torch.cuda.device_count`` patched; the rank-card rule of
  ``runtime`` (torchrun's split, a refused split, two ranks of one host
  claiming a card); ranks of unequal device counts end every rank.
"""

import contextlib
import io
import json
import os
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (the JAX package's runs share this process)

from test_torch_epochs import VARIANTS, _jax, _run, _write_corpus

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIMIT_S = 240
EPS_BATCH, EPS_SAMPLE, EPS_CG = 1e-11, 1e-12, 1e-9

# case -> (variant, conf lines, argv before the conf, tool, pretrained)
CASES = {
    "batch-bp": ("ANN-BP", "[batch] 4\n", ["-v", "-v"], "train_nn", False),
    "batch-bpm": ("ANN-BPM", "[batch] 4\n", ["-v", "-v", "--epochs", "2"],
                  "train_nn", False),
    "grid-2x2": ("SNN-BPM", "[batch] 4\n[model] 2\n",
                 ["-v", "-v", "--epochs", "2"], "train_nn", False),
    "model-2": ("SNN-BPM", "[model] 2\n", ["-v", "-v"], "train_nn", True),
    "model-4": ("ANN-BP", "[model] 4\n", ["-v", "-v"], "train_nn", True),
    "cg": ("CG", "[batch] 4\n", ["-v", "-v", "--trainer", "cg", "--epochs",
                                 "2"], "train_nn", False),
    "run-model-2": ("SNN-BP", "[model] 2\n", ["-v", "-v"], "run_nn", True),
    "run-model-4": ("ANN-BP", "[model] 4\n", ["-v", "-v"], "run_nn", True),
    # [tile] across processes: the JAX package's warning, minibatch DP
    "tile": ("ANN-BP", "[batch] 4\n[tile] 2\n", ["-v", "-v", "--epochs", "2"],
             "train_nn", False),
}
# cases whose one-process run takes another route (the tile engine)
MULTI_ONLY = {"tile"}
EPS = {"batch-bp": EPS_BATCH, "batch-bpm": EPS_BATCH, "grid-2x2": EPS_BATCH,
       "model-2": EPS_SAMPLE, "model-4": EPS_SAMPLE, "cg": EPS_CG,
       "tile": EPS_BATCH}
# the JAX package's two processes of two devices: the cases where a
# process fails (a JAX package fault the port does not share)
JAX_FAILS = {"batch-bpm": (1, 1), "cg": (1, 1), "model-2": (0, 1),
             "run-model-2": (0, 1)}
# the last port case: rank 0 holds 2 shards, rank 1 one
UNEQUAL = "unequal"

JAX_WORKER = r"""
import contextlib, io, json, os, sys, traceback
sys.path.insert(0, sys.argv[1])
import jax
_init, _done = jax.distributed.initialize, []


def _once(**kw):
    # every CLI call inits the runtime; the service is joined once
    if not _done:
        _init(**kw)
        _done.append(1)


jax.distributed.initialize = _once
import hpnn_tpu.api as japi
from hpnn_tpu import cli
from hpnn_tpu.io import samples
samples._native_warned = True
rank = os.environ["HPNN_PROCESS_ID"]
for name, tool, argv in json.loads(sys.argv[3]):
    os.chdir(os.path.join(sys.argv[2], name, "jax2"))
    out, err = io.StringIO(), io.StringIO()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = getattr(cli, tool + "_main")(argv)
    except Exception:
        rc = -99
        err.write(traceback.format_exc())
    if japi._prefetch_thread is not None:
        japi._prefetch_thread.join()
    with open(f"rank{rank}.json", "w") as fp:
        json.dump({"rc": rc, "out": out.getvalue(), "err": err.getvalue()},
                  fp)
"""

PORT_WORKER = r"""
import contextlib, io, json, os, sys
sys.path.insert(0, sys.argv[1])
import torch
import torch.distributed as dist
from hpnn_tpu_torch import api, cli
from hpnn_tpu_torch.parallel import mesh
# the process group lives across the cases (each CLI call inits and
# deinits the runtime)
destroy, dist.destroy_process_group = dist.destroy_process_group, \
    lambda *a, **k: None
mesh.forget_meshes = lambda: None
rank = int(os.environ["HPNN_PROCESS_ID"])
torch.set_num_threads(1)
for name, tool, argv in json.loads(sys.argv[3]):
    os.chdir(os.path.join(sys.argv[2], name, "port"))
    shards = 2 if name != "unequal" or rank == 0 else 1
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err), \
            api.device_slice([torch.device("cpu")] * shards):
        if tool == "run_nn":
            rc = cli.run_nn_main([*argv[:-1], "--device", "cpu", argv[-1]])
        else:
            rc = cli.train_nn_main([*argv[:-1], "--device", "cpu",
                                    argv[-1]])
    if api._prefetch_thread is not None:
        api._prefetch_thread.join()
    with open(f"rank{rank}.json", "w") as fp:
        json.dump({"rc": rc, "out": out.getvalue(), "err": err.getvalue()},
                  fp)
destroy()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(code, root, cases, env):
    """Two ranks of ``code`` over ``cases``, started at once."""
    port = _free_port()
    procs = []
    for rank in range(2):
        e = dict(os.environ)
        e.update({"HPNN_DISTRIBUTED": "1",
                  "HPNN_COORDINATOR": f"127.0.0.1:{port}",
                  "HPNN_NUM_PROCESSES": "2", "HPNN_PROCESS_ID": str(rank),
                  "HPNN_DIST_TIMEOUT_S": "60", "OMP_NUM_THREADS": "1",
                  "HPNN_CG_ITERS": "3",
                  "PYTHONPATH": REPO + os.pathsep + e.get("PYTHONPATH", "")})
        e.update(env)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code, REPO, root, json.dumps(cases)],
            env=e, cwd=root, text=True, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE))
    return procs


def _wait(procs):
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


def _conf(variant, extra, init):
    kind, train, conf_extra, _ = (("SNN", "CG", "", ()) if variant == "CG"
                                  else VARIANTS[variant])
    return (f"[name] tiny\n[type] {kind}\n[init] {init}\n[seed] 1234\n"
            "[input] 8\n[hidden] 6\n[output] 3\n"
            f"[train] {train}\n[sample_dir] ./samples\n[test_dir] ./tests\n"
            + conf_extra + extra)


def _setup_case(root, name):
    """The case's corpus and conf in ``jax1``, ``jax2`` and ``port``, the
    same bytes each (a pretrained kernel as ``pre.opt``)."""
    variant, extra, _, _, pre = CASES[name]
    kind = "SNN" if variant == "CG" else VARIANTS[variant][0]
    base = os.path.join(root, name, "jax1")
    rng = np.random.default_rng(7)
    _write_corpus(os.path.join(base, "samples"), rng, kind)
    _write_corpus(os.path.join(base, "tests"), rng, kind)
    here = os.getcwd()
    os.chdir(base)
    try:
        if pre:
            with open("nn.conf", "w") as fp:
                fp.write(_conf(variant, "", "generate"))
            assert _jax(["--epochs", "12", "nn.conf"],
                        {"HPNN_DP_DEVICES": "1"})[0] == 0
            shutil.copy("kernel.opt", "pre.opt")
            for f in ("kernel.opt", "kernel.tmp"):
                os.unlink(f)
        with open("nn.conf", "w") as fp:
            fp.write(_conf(variant, extra, "pre.opt" if pre else "generate"))
    finally:
        os.chdir(here)
    for copy in ("jax2", "port"):
        shutil.copytree(base, os.path.join(root, name, copy))


def _jax_one(root, name):
    """The JAX package's one process of four devices."""
    from hpnn_tpu.cli import run_nn_main

    _, _, argv, tool, _ = CASES[name]
    here = os.getcwd()
    os.chdir(os.path.join(root, name, "jax1"))
    try:
        if tool == "run_nn":
            res = _run(run_nn_main, [*argv, "nn.conf"])
        else:
            res = _jax([*argv, "nn.conf"], {"HPNN_DP_DEVICES": "4",
                                            "HPNN_CG_ITERS": "3"})
        return {"rc": res[0], "out": res[1], "err": res[2], "opt": res[4]}
    finally:
        os.chdir(here)


def _read(root, name, side):
    got = []
    for r in range(2):
        with open(os.path.join(root, name, side, f"rank{r}.json")) as fp:
            got.append(json.load(fp))
    path = os.path.join(root, name, side, "kernel.opt")
    opt = open(path).read() if os.path.exists(path) else None
    return got, opt


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from hpnn_tpu.io import samples as jax_samples

    jax_samples._native_warned = True
    root = str(tmp_path_factory.mktemp("rank_grid"))
    for name in CASES:
        _setup_case(root, name)
    os.makedirs(os.path.join(root, UNEQUAL))
    shutil.copytree(os.path.join(root, "batch-bp", "jax1"),
                    os.path.join(root, UNEQUAL, "port"))
    cases = [(n, CASES[n][3], [*CASES[n][2], "nn.conf"]) for n in CASES]
    jax_env = {"JAX_PLATFORMS": "cpu",
               "XLA_FLAGS": "--xla_force_host_platform_device_count=2"}
    jprocs = _launch(JAX_WORKER, root, cases, jax_env)
    pprocs = _launch(PORT_WORKER, root, cases + [
        (UNEQUAL, "train_nn", ["-v", "-v", "nn.conf"])], {})
    one = {n: _jax_one(root, n) for n in CASES if n not in MULTI_ONLY}
    for rc, _, err in _wait(jprocs) + _wait(pprocs):
        assert rc == 0, err[-3000:]
    return root, one


def _lines(out, tool):
    tag = "TESTING" if tool == "run_nn" else "TRAINING"
    return [ln for ln in out.splitlines(True) if tag in ln]


def _werr(a, b):
    from hpnn_tpu.io.kernel_io import load_kernel

    ws = []
    for i, text in enumerate((a, b)):
        with open(f"_cmp{i}.opt", "w") as fp:
            fp.write(text)
        ws.append(load_kernel(f"_cmp{i}.opt").weights)
    return max(float(np.abs(np.asarray(x) - np.asarray(y)).max())
               for x, y in zip(*ws))


@pytest.mark.parametrize("name", [n for n in CASES if n not in MULTI_ONLY])
def test_two_ranks_of_two_shards_match_jax(runs, name, tmp_path,
                                           monkeypatch):
    """The port's 2 ranks x 2 shards against the JAX package's 2 processes
    x 2 devices and its one 4-device process: the lines byte-identical,
    kernel.opt within the case's bound; rank 0 alone prints, and rank 0
    alone writes kernel.opt."""
    root, one = runs
    monkeypatch.chdir(tmp_path)
    tool = CASES[name][3]
    port, popt = _read(root, name, "port")
    jax2, jopt = _read(root, name, "jax2")
    assert [r["rc"] for r in port] == [0, 0], port[0]["err"][-2000:]
    assert port[1]["out"] == ""
    want = _lines(one[name]["out"], tool)
    assert one[name]["rc"] == 0 and want != []
    assert _lines(port[0]["out"], tool) == want
    if tool == "train_nn":
        assert _werr(popt, one[name]["opt"]) < EPS[name]
    if name.startswith("batch") or name == "grid-2x2":
        assert "over 4 data-shard(s)" in port[0]["out"] \
            or "hybrid mesh 2x2" in port[0]["out"]
    if name == "grid-2x2":
        assert "DP: hybrid mesh 2x2" in port[0]["out"]
    if name not in JAX_FAILS:
        assert [r["rc"] for r in jax2] == [0, 0], jax2[1]["err"][-2000:]
        assert _lines(port[0]["out"], tool) == _lines(jax2[0]["out"], tool)
        if tool == "train_nn":
            assert _werr(popt, jopt) < EPS[name]


@pytest.mark.parametrize("name", sorted(JAX_FAILS))
def test_where_the_jax_processes_fail(runs, name):
    """The JAX package's two processes of two devices fail where the port's
    ranks do not: its ``[batch]`` BPM and CG runs fetch a flat state that
    spans devices the process does not address, and its second process
    holds no shard of a ``[model] 2`` axis over the first two devices
    (the port gives every rank a replica of the model group).  The first
    process's lines, where it ran to its end, equal the port's."""
    root, _ = runs
    port, _ = _read(root, name, "port")
    jax2, _ = _read(root, name, "jax2")
    fails = tuple(int(r["rc"] != 0) for r in jax2)
    assert fails == JAX_FAILS[name]
    assert all("addressable" in r["err"] for r, f in zip(jax2, fails) if f)
    assert [r["rc"] for r in port] == [0, 0]
    if not fails[0]:
        tool = CASES[name][3]
        assert _lines(port[0]["out"], tool) == _lines(jax2[0]["out"], tool)


def test_tile_across_ranks_keeps_minibatch_dp(runs, tmp_path, monkeypatch):
    """``[batch]`` + ``[tile]`` on 2 ranks x 2 shards: the JAX package's
    warning once, the minibatch route (``TRAINING BATCH`` lines over the 4
    data shards), its 2 processes' lines and kernel.opt within 1e-11."""
    root, _ = runs
    monkeypatch.chdir(tmp_path)
    port, popt = _read(root, "tile", "port")
    jax2, jopt = _read(root, "tile", "jax2")
    assert [r["rc"] for r in port] == [0, 0] == [r["rc"] for r in jax2]
    warn = ("[tile] engine is single-controller; multi-process [batch] "
            "runs keep minibatch DP")
    for out in (port[0]["out"], jax2[0]["out"]):
        assert out.count(warn) == 1
    assert "over 4 data-shard(s)" in port[0]["out"]
    lines = _lines(port[0]["out"], "train_nn")
    assert lines == _lines(jax2[0]["out"], "train_nn")
    assert lines and all("TRAINING BATCH" in ln for ln in lines)
    assert _werr(popt, jopt) < EPS_BATCH


def test_unequal_device_counts_end_every_rank(runs):
    """Rank 0 holds two shards and rank 1 one: the agreement gate ends both
    ranks non-zero before any grid collective, rank 0 (the one that
    prints) naming the counts."""
    root, _ = runs
    got, opt = _read(root, UNEQUAL, "port")
    assert all(r["rc"] != 0 for r in got)
    assert "NN(ERR): aborting: processes hold unequal device counts " \
           "([2, 1] by rank)" in got[0]["err"]
    assert all("FAILED to train kernel!" in r["err"] for r in got)
    assert opt is None


# --- the devices a run takes, without a card --------------------------------

@pytest.fixture
def four_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)


def test_an_explicit_card_keeps_its_run(four_cards, monkeypatch):
    """``cuda`` takes every card; ``cuda:1`` the cards from 1 (never card
    0); a thread's slice wins.  The [batch] grid, the [model] axis and the
    pipeline's row devices (the grid's data devices) follow the list."""
    from hpnn_tpu_torch import api

    cuda = [torch.device("cuda", i) for i in range(4)]
    assert api._local_devices("cuda") == cuda
    assert api._local_devices("cuda:0") == cuda
    assert api._local_devices("cuda:1") == cuda[1:]
    assert api._dp_device_count("cuda:1") == 3
    mesh = api._dp_mesh(2, 1, "cuda:1")
    assert mesh.devices == tuple(cuda[1:3])
    assert mesh.data_devices() == tuple(cuda[1:3])
    grid = api._dp_mesh(1, 2, "cuda:2")
    assert grid.devices == tuple(cuda[2:])
    axis, k, warn = api._model_axis(4, "cuda:1")
    assert (k, warn) == (3, "[model] 4 > 3 visible device(s); using 3\n")
    assert axis.devices == tuple(cuda[1:])
    monkeypatch.setattr(api, "slice_devices", lambda: [cuda[3], cuda[0]])
    assert api._local_devices("cuda:1") == [cuda[3], cuda[0]]
    assert api._dp_mesh(2, 1, "cuda:1").devices == (cuda[3], cuda[0])


class _Store:
    """The rendezvous store's set/get, in one process."""

    def __init__(self, posts=()):
        self.kv = dict(posts)

    def set(self, key, value):
        self.kv[key] = value

    def get(self, key):
        return self.kv[key].encode() if isinstance(self.kv[key], str) \
            else self.kv[key]


class _Props:
    def __init__(self, uuid):
        self.uuid = uuid


def _claims(monkeypatch, uuids, env):
    from hpnn_tpu_torch import runtime

    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: _Props(uuids[i]))
    for k in ("LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    return runtime._rank_cards


@pytest.mark.parametrize("w,l,want", [(2, 0, [0, 1]), (2, 1, [2, 3]),
                                      (4, 3, [3]), (1, 0, [0, 1, 2, 3])])
def test_torchrun_ranks_split_the_host_cards(four_cards, monkeypatch, w, l,
                                             want):
    """Under torchrun local rank l of w holds cards [l*c/w, (l+1)*c/w)."""
    rank_cards = _claims(monkeypatch, ["a", "b", "c", "d"],
                         {"LOCAL_RANK": str(l), "LOCAL_WORLD_SIZE": str(w)})
    assert rank_cards(_Store(), 0, 1) == want


def test_rank_card_rule_refusals(four_cards, monkeypatch):
    """A card count the host's ranks do not divide is refused; two ranks of
    one host that claim a card are refused (the peer posted the same
    UUIDs); ranks whose launcher gave each its own cards hold them all."""
    import json as _json
    import socket as _socket

    host = _socket.gethostname()
    rank_cards = _claims(monkeypatch, ["a", "b", "c", "d"],
                         {"LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "3"})
    with pytest.raises(RuntimeError, match="do not split evenly"):
        rank_cards(_Store(), 0, 1)
    rank_cards = _claims(monkeypatch, ["a", "b", "c", "d"], {})
    peer = {"hpnn_cards/1": _json.dumps([host, ["c", "d", "e", "f"]])}
    with pytest.raises(RuntimeError, match="both claim card c"):
        rank_cards(_Store(peer), 0, 2)
    peer = {"hpnn_cards/1": _json.dumps([host, ["e", "f", "g", "h"]])}
    assert rank_cards(_Store(peer), 0, 2) == [0, 1, 2, 3]
    peer = {"hpnn_cards/1": _json.dumps(["other", ["a", "b", "c", "d"]])}
    assert rank_cards(_Store(peer), 0, 2) == [0, 1, 2, 3]


def test_a_refused_split_fails_init_with_an_error_line(four_cards,
                                                       monkeypatch):
    """``init_all`` under ``HPNN_DISTRIBUTED`` with a split torchrun cannot
    make: -1 and an ``NN(ERR)`` line naming it."""
    from hpnn_tpu_torch import runtime

    monkeypatch.setattr(runtime, "resolve_device",
                        lambda name: torch.device("cuda", 0))
    _claims(monkeypatch, ["a", "b", "c", "d"],
            {"LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "3",
             "HPNN_DISTRIBUTED": "1",
             "HPNN_COORDINATOR": f"127.0.0.1:{_free_port()}",
             "HPNN_NUM_PROCESSES": "1", "HPNN_PROCESS_ID": "0"})
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert runtime.init_all("cuda") == -1
    assert "NN(ERR): device runtime init failed: 4 visible card(s) do not " \
           "split evenly over the 3 ranks of this host" in err.getvalue()
