"""Training over the devices of one process: the PyTorch port on a local
grid against the JAX package's single-process mesh, on the CPU.

The port takes its data and model axes from the devices one process sees
(``hpnn_tpu_torch.api.device_slice``, every card of a ``cuda`` run, else
the CPU); here ``device_slice(["cpu"] * k)``, a grid of the CPU repeated k
times.  The JAX package runs pinned to ``hpnn_tpu.api.device_slice(
jax.devices()[:k])`` of ``tests/conftest.py``'s 8-device CPU mesh.  The
corpus is tests/test_torch_epochs.py's (8-6-3, nine files and two skip
files).

* ``train_nn -v -v`` with ``[batch] 4`` at k = 2 and 4 (the ``over k
  data-shard(s)`` banners): ANN/SNN/LNN, BP/BPM, 1 and 3 epochs, resident
  and restage; ``[model] 2``, ``-S 2`` and ``--model-parallel 2`` per
  sample at k = 2; ``[batch] 4`` + ``[model] 2`` on a 2x2 grid and
  ``[model] 3`` at k = 4 (the clamp); ``[batch] 4`` + ``[tile] 2`` at k = 4
  (``mesh=4``); ``--trainer cg`` under ``[batch] 4`` at k = 4;
  ``HPNN_DP_DEVICES`` below and above the slice.  Streams byte-identical;
  kernel.opt within 1e-11 (``[batch]``: the sum over shards runs in
  another order than XLA's all-reduce), 1e-12 per sample, 1e-9 CG;
  ``[dtype] bf16`` within the 1e-5 of tests/test_torch_dp.py.
* ``run_nn`` of a ``[model] 2`` conf at k = 2: outputs within 1e-12.
* Kill at epoch 1 of 3 and ``--resume`` on a 4-shard grid: byte-identical
  to the uninterrupted run; bundles resume across the packages both ways.
* A jobs server over four CPU devices: a ``[batch]`` job with
  ``dp_devices: 2`` gives the kernel.opt of the offline 2-shard run.
* The grid's collectives and the engines' shard layout, against their
  plain (one-device) versions.
"""

import contextlib
import os
import re
import shutil

import numpy as np
import pytest
import torch

import jax

from test_torch_epochs import N_SAMP, VARIANTS, _jax, _port, _run, _weights

EPS_BATCH, EPS_SAMPLE, EPS_CG, EPS_BF16 = 1e-11, 1e-12, 1e-9, 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_caps(monkeypatch):
    """Each test sees the env-cap warnings afresh, in both packages."""
    from hpnn_tpu.utils import env as jenv
    from hpnn_tpu_torch.utils import env as penv

    monkeypatch.setattr(penv, "_warned_device_caps", set())
    monkeypatch.setattr(jenv, "_warned_device_caps", set())


def _setup(tmp_path, monkeypatch, variant, extra=""):
    from test_torch_epochs import _setup as setup

    kind, train, conf_extra, _ = VARIANTS[variant]
    VARIANTS["_grid"] = (kind, train, conf_extra + extra, ())
    try:
        setup(tmp_path, monkeypatch, "_grid")
    finally:
        VARIANTS.pop("_grid")


@contextlib.contextmanager
def _jax_slice(k):
    from hpnn_tpu import api as japi

    with japi.device_slice(jax.devices()[:k]):
        yield


@contextlib.contextmanager
def _port_slice(k):
    from hpnn_tpu_torch import api

    with api.device_slice([torch.device("cpu")] * k):
        yield


def _both(argv, k, env=None, port_env=None):
    """The JAX package's and the port's ``train_nn`` over k devices."""
    with _jax_slice(k):
        j = _jax(argv, env)
    with _port_slice(k):
        p = _port(argv, env if port_env is None else port_env)
    return j, p


def _werr(a, b):
    return max(float(np.abs(x - y).max())
               for x, y in zip(_weights(a), _weights(b)))


def _assert_same(j, p, eps):
    assert j[0] == p[0] == 0, p[2][-2000:]
    assert p[1] == j[1]
    assert p[2] == j[2]
    assert _werr(j[4], p[4]) < eps


# --- [batch] over k devices --------------------------------------------------

DP_VARIANTS = ["ANN-BP", "ANN-BPM", "SNN-BP", "SNN-BPM", "LNN-native"]


@pytest.mark.parametrize("route", ["resident", "restage"])
@pytest.mark.parametrize("epochs", [1, 3])
@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("variant", DP_VARIANTS)
def test_batch_over_k_devices_matches_jax(tmp_path, monkeypatch, variant, k,
                                          epochs, route):
    import hpnn_tpu_torch.api as api

    _setup(tmp_path, monkeypatch, variant, "[batch] 4\n")
    argv = ["-v", "-v", "--epochs", str(epochs), "nn.conf"]
    env = {"HPNN_NO_EPOCH_PIPELINE": "1"} if route == "restage" else {}
    api.reset_epoch_metrics()
    j, p = _both(argv, k, env)
    _assert_same(j, p, EPS_BATCH)
    assert p[1].count(f"DP: padding 3 masked row(s) (S=9, batch=4 -> 4 "
                      f"over {k} data-shard(s))") == epochs
    assert "one device visible" not in p[1]
    assert api.EPOCH_METRICS["dp_devices"] == k
    # one epoch restages whatever the route (no pipeline for one epoch)
    assert api.EPOCH_METRICS["mode"] == (
        "dp-resident" if route == "resident" and epochs > 1
        else "dp-restage")


def test_batch_bf16_over_two_devices_within_envelope(tmp_path, monkeypatch):
    """``[dtype] bf16`` (f32 masters) over 2 devices: each batch's error and
    the weights within 1e-5 of the JAX package's on its 2-device mesh."""
    _setup(tmp_path, monkeypatch, "SNN-BPM", "[batch] 5\n[dtype] bf16\n")
    j, p = _both(["-v", "-v", "--epochs", "3", "nn.conf"], 2)
    assert j[0] == p[0] == 0, p[2]
    ej = [float(v) for v in re.findall(r"err=\s*([-\d.]+)", j[1])]
    ep = [float(v) for v in re.findall(r"err=\s*([-\d.]+)", p[1])]
    assert len(ep) == len(ej) == 6
    assert np.allclose(ep, ej, rtol=EPS_BF16, atol=1e-9)
    assert _werr(j[4], p[4]) < EPS_BF16
    assert "over 2 data-shard(s)" in p[1]


@pytest.mark.parametrize("cap", ["1", "8"])
def test_slice_wins_over_dp_devices_cap(tmp_path, monkeypatch, cap):
    """``HPNN_DP_DEVICES`` below and above a pinned slice of 2: the slice
    is the grid in both packages, with no cap warning."""
    _setup(tmp_path, monkeypatch, "ANN-BPM", "[batch] 3\n")
    argv = ["-v", "-v", "nn.conf"]
    j, p = _both(argv, 2, {"HPNN_DP_DEVICES": cap})
    _assert_same(j, p, EPS_BATCH)
    assert "HPNN_DP_DEVICES" not in p[1] + p[2]
    with _port_slice(2):
        q = _port(argv)
    assert q == p
    assert "(S=9, batch=3 -> 4 over 2 data-shard(s))" in p[1]


def test_dp_devices_cap_below_the_visible_devices(tmp_path, monkeypatch):
    """Without a slice ``HPNN_DP_DEVICES`` caps the visible devices, as in
    the JAX package; the port's CPU run sees one device, so its cap of 1
    is the one-device run, and on a card it takes the first cards (the
    devices list here stands in for four cards)."""
    from hpnn_tpu_torch import api

    monkeypatch.setattr(api, "_local_devices",
                        lambda device: [torch.device("cpu")] * 4)
    monkeypatch.setenv("HPNN_DP_DEVICES", "2")
    assert api._dp_device_count("cpu") == 2
    mesh = api._dp_mesh(2, 1, "cpu")
    assert (mesh.n_data, mesh.n_model) == (2, 1)
    monkeypatch.setenv("HPNN_DP_DEVICES", "1")
    assert api._dp_device_count("cpu") == 1 and api._dp_mesh(1, 1, "cpu") \
        is None


@pytest.mark.parametrize("extra", ["[batch] 4\n", "[batch] 4\n[tile] 2\n"])
def test_dp_devices_1_brings_back_the_one_device_route(tmp_path, monkeypatch,
                                                       extra):
    """An unpinned process of four devices (the list stands in for four
    cards) shards ``[batch]`` over them; ``HPNN_DP_DEVICES=1`` gives the
    one-device run's bytes and route back (``train_tile`` with
    ``[tile]``)."""
    from hpnn_tpu_torch import api
    from hpnn_tpu_torch.ops import convergence_tile_kernel as ctk

    _pretrained(tmp_path, monkeypatch, "ANN-BP", extra)
    argv = ["-v", "-v", "--epochs", "2", "nn.conf"]
    calls = []
    real = ctk.train_tile

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(ctk, "train_tile", spy)
    one = _port(argv)
    n_one, calls[:] = len(calls), []
    monkeypatch.setattr(api, "_local_devices",
                        lambda device: [torch.device("cpu")] * 4)
    assert _port(argv, {"HPNN_DP_DEVICES": "1"}) == one
    assert len(calls) == n_one and (n_one > 0) == ("[tile]" in extra)
    calls[:] = []
    wide = _port(argv)
    assert wide[0] == 0 and calls == []
    assert ("mesh=4" if "[tile]" in extra else "over 4 data-shard(s)") \
        in wide[1]
    assert _werr(one[4], wide[4]) < EPS_BATCH


# --- [model] over k devices ---------------------------------------------------

def _pretrained(tmp_path, monkeypatch, variant, extra=""):
    """The variant's corpus with a kernel the JAX package pre-trained (a
    generated kernel costs ~100k eager iterations an epoch per sample)."""
    from test_torch_tp import _pretrained as pretrained

    pretrained(tmp_path, monkeypatch, variant, extra)


@pytest.mark.parametrize("how", ["conf", "S", "model-parallel", "epochs"])
def test_model_2_per_sample_over_two_devices_matches_jax(tmp_path,
                                                         monkeypatch, how):
    """``[model] 2`` (and ``-S 2``, ``--model-parallel 2``) per sample over
    2 devices: no clamp warning, the stream byte-identical, kernel.opt
    within 1e-12; ``--epochs 3`` rides the ``tp-resident`` pipeline on the
    2-shard model axis."""
    import hpnn_tpu_torch.api as api

    _pretrained(tmp_path, monkeypatch, "SNN-BPM",
                "[model] 2\n" if how in ("conf", "epochs") else "")
    flags = {"conf": [], "S": ["-S", "2"],
             "model-parallel": ["--model-parallel", "2"],
             "epochs": ["--epochs", "3"]}[how]
    api.reset_epoch_metrics()
    j, p = _both(["-v", "-v", *flags, "nn.conf"], 2)
    _assert_same(j, p, EPS_SAMPLE)
    assert "visible device" not in p[1]
    assert p[1].count("N_ITER=") == (3 if how == "epochs" else 1) * N_SAMP
    assert api.EPOCH_METRICS["tp_devices"] == 2
    assert api.EPOCH_METRICS["mode"] == ("tp-resident" if how == "epochs"
                                         else "tp-restage")


@pytest.mark.parametrize("route", ["resident", "restage"])
@pytest.mark.parametrize("model", [2, 3])
def test_batch_by_model_grid_matches_jax(tmp_path, monkeypatch, model,
                                         route):
    """``[batch] 4`` beside ``[model] 2`` on 4 devices: the 2x2 grid's
    banner and stream; ``[model] 3`` clamps to 2 with the JAX package's
    warning (the model axis must divide the 4 devices)."""
    import hpnn_tpu_torch.api as api

    _setup(tmp_path, monkeypatch, "ANN-BPM",
           f"[batch] 4\n[model] {model}\n")
    env = {"HPNN_NO_EPOCH_PIPELINE": "1"} if route == "restage" else {}
    api.reset_epoch_metrics()
    j, p = _both(["-v", "-v", "--epochs", "3", "nn.conf"], 4, env)
    _assert_same(j, p, EPS_BATCH)
    assert p[1].count("DP: hybrid mesh 2x2 (batch rows over data, weight "
                      "rows over model)") == 3
    warn = "NN(WARN): [model] 3 clamped to 2 (device count 4)\n"
    assert p[1].count(warn) == (3 if model == 3 else 0)
    assert api.EPOCH_METRICS["mode"] == ("dp-tp-resident"
                                         if route == "resident"
                                         else "dp-restage")
    assert (api.EPOCH_METRICS["dp_devices"],
            api.EPOCH_METRICS["tp_devices"]) == (2, 2)


def test_model_3_clamps_to_the_visible_devices(tmp_path, monkeypatch):
    """``[model] 3`` per sample over 2 devices: the clamp warning counts
    the slice's devices, then the 2-shard run."""
    _pretrained(tmp_path, monkeypatch, "ANN-BP", "[model] 3\n")
    j, p = _both(["-v", "-v", "nn.conf"], 2)
    _assert_same(j, p, EPS_SAMPLE)
    warn = "NN(WARN): [model] 3 > 2 visible device(s); using 2\n"
    assert p[1].count(warn) == 1
    assert p[1].index(warn) < p[1].index("TRAINING FILE")


def test_run_nn_model_2_over_two_devices_matches_jax(tmp_path, monkeypatch):
    """``run_nn`` of a ``[model] 2`` conf over 2 devices: the ring engine
    over both (no clamp warning), the verdict stream byte-identical to
    the JAX package's over 2 devices and the outputs within 1e-12 of its
    ring engine on the same rows."""
    import jax.numpy as jnp

    from hpnn_tpu.cli import run_nn_main as jrun
    from hpnn_tpu.parallel import make_mesh as jmesh
    from hpnn_tpu.parallel import tp_eval_batch as jeval
    from hpnn_tpu_torch import api, ops
    from hpnn_tpu_torch.cli import run_nn_main

    _pretrained(tmp_path, monkeypatch, "SNN-BP", "[model] 2\n")
    argv = ["-v", "-v", "nn.conf"]
    meshes = []
    real = ops.select_run_batch

    def spy(*a, **kw):
        meshes.append(kw.get("model_mesh"))
        return real(*a, **kw)

    monkeypatch.setattr(ops, "select_run_batch", spy)
    with _jax_slice(2):
        j = _run(jrun, argv)
    with _port_slice(2):
        p = _run(run_nn_main, [*argv[:-1], "--device", "cpu", argv[-1]])
        nn = api.configure("nn.conf")
        outs = api.run_kernel(nn, device="cpu")
    assert j[0] == p[0] == 0
    assert p[1] == j[1] and p[2] == j[2]
    assert "visible device" not in p[1] and "[PASS]" in p[1]
    assert meshes[-1] is not None and meshes[-1].n_model == 2
    assert meshes[-1].devices == (torch.device("cpu"),) * 2
    _, xs, _ = api.load_tests(api.configure("nn.conf"))
    want = jeval(tuple(jnp.asarray(w) for w in nn.kernel.weights),
                 jnp.asarray(xs), "SNN", jmesh(n_data=1, n_model=2))
    assert np.abs(outs - np.asarray(want)).max() < EPS_SAMPLE


# --- [batch] + [tile], CG ---------------------------------------------------

@pytest.mark.parametrize("k,batch,banner", [
    (4, 4, "(group=4, mesh=4)"),
    (2, 3, "(group=3 -> 4 over 2 data-shard(s), mesh=2)")])
@pytest.mark.parametrize("variant", ["ANN-BP", "SNN-BPM"])
def test_batch_tile_over_k_devices_matches_jax(tmp_path, monkeypatch,
                                               variant, k, batch, banner):
    """``[batch]`` + ``[tile] 2`` over k devices: each group's lanes
    sharded over the data mesh (the group padded to a multiple of k with
    masked lanes), the ``mesh=k`` banner, the per-sample lines and 1e-11;
    the resident and restaging routes give the same bytes; no
    ``train_tile`` launch (the JAX package's mesh leaves its Pallas
    kernel too)."""
    import hpnn_tpu_torch.api as api
    from hpnn_tpu_torch.ops import convergence_tile_kernel as ctk

    _pretrained(tmp_path, monkeypatch, variant,
                f"[batch] {batch}\n[tile] 2\n")
    argv = ["-v", "-v", "--epochs", "2", "nn.conf"]
    calls = []
    real = ctk.train_tile

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(ctk, "train_tile", spy)
    api.reset_epoch_metrics()
    j, p = _both(argv, k)
    _assert_same(j, p, EPS_BATCH)
    assert api.EPOCH_METRICS["mode"] == "dp-tiled-resident"
    assert api.EPOCH_METRICS["dp_devices"] == k
    with _port_slice(k):
        q = _port(argv, {"HPNN_NO_EPOCH_PIPELINE": "1"})
    assert q == p
    assert p[1].count("DP: batched-tile convergence engine " + banner) == 2
    assert p[1].count("N_ITER=") == 2 * N_SAMP
    assert calls == []


def _cg_setup(tmp_path, monkeypatch):
    VARIANTS["_cg"] = ("SNN", "CG", "[batch] 4\n", ())
    try:
        _setup(tmp_path, monkeypatch, "_cg")
    finally:
        VARIANTS.pop("_cg")


def test_cg_batch_over_four_devices_matches_jax(tmp_path, monkeypatch):
    """``--trainer cg`` under ``[batch] 4`` over 4 devices: the flat CG
    state in 4 slices; ``TRAINING CG`` lines equal, kernel.opt within
    1e-9 of the JAX package's (its state sharded over its 4-device
    mesh)."""
    _cg_setup(tmp_path, monkeypatch)
    argv = ["-v", "-v", "--trainer", "cg", "--epochs", "2", "nn.conf"]
    j, p = _both(argv, 4, {"HPNN_CG_ITERS": "3"})
    _assert_same(j, p, EPS_CG)
    assert p[1].count("TRAINING CG") == 2


def test_cg_sharded_state_equals_one_device(monkeypatch):
    """``cg_epoch`` with its vectors in 3 slices (a 3 x 1 grid) against
    the same epoch on one vector: 1e-12, the same restarts; the slices
    stay on their shards' devices."""
    from hpnn_tpu_torch.parallel.mesh import flatten_state
    from hpnn_tpu_torch.train import cg

    rng = np.random.default_rng(3)
    ws = [torch.as_tensor(rng.uniform(-1, 1, (5, 7))),
          torch.as_tensor(rng.uniform(-1, 1, (3, 5)))]
    xs = torch.as_tensor(rng.uniform(0, 1, (11, 7)))
    ts = torch.as_tensor(np.eye(3)[rng.integers(0, 3, 11)])
    shapes = tuple(tuple(w.shape) for w in ws)
    flat = flatten_state(ws, 3)
    z = torch.zeros_like(flat)
    have = torch.tensor(False)
    r0 = torch.tensor(0, dtype=torch.int32)
    one = cg.cg_epoch(flat, z, z.clone(), have, r0, xs, ts, "SNN", shapes, 4)
    c = flat.shape[0] // 3
    parts = [flat[i * c:(i + 1) * c] for i in range(3)]
    zs = [torch.zeros(c, dtype=flat.dtype) for _ in range(3)]
    got = cg.cg_epoch(parts, zs, [v.clone() for v in zs], have, r0, xs, ts,
                      "SNN", shapes, 4)
    assert len(got[0]) == 3 and all(v.shape == (c,) for v in got[0])
    for a, b in zip(got[:3], one[:3]):
        assert float((torch.cat(a) - b).abs().max()) < EPS_SAMPLE
    for a, b in zip(got[3:6], one[3:6]):
        assert abs(float(a) - float(b)) < EPS_SAMPLE
    assert int(got[6]) == int(one[6])


# --- kill + --resume on a 4-shard grid, bundles across the packages ---------

@pytest.mark.parametrize("case", ["dp-bpm", "grid-cg"])
def test_kill_resume_on_a_four_device_grid(tmp_path, monkeypatch, case):
    """Kill at epoch 1 of 3 and ``--resume`` over 4 devices: the port's
    kernel.opt is its uninterrupted run's byte for byte, the bundle
    stamped ``world_size`` 1; a JAX bundle resumes in the port and a port
    bundle in the JAX package, each to the other's stream (1e-11
    ``[batch]``, 1e-9 CG)."""
    import json

    import test_torch_dp as tdp
    from hpnn_tpu.io import samples as jax_samples

    monkeypatch.setattr(jax_samples, "_native_warned", True)
    monkeypatch.setitem(tdp.RESUME_CASES, "grid-cg",
                        ("SNN", "CG", "[batch] 4\n", ("--trainer", "cg")))
    monkeypatch.setenv("HPNN_CG_ITERS", "3")
    monkeypatch.chdir(tmp_path)
    with _jax_slice(4), _port_slice(4):
        runs = tdp._resume_runs(tmp_path, case)
    for name, r in runs.items():
        assert r["rc"] == 0, (name, r["err"])
    tol = EPS_CG if case == "grid-cg" else EPS_BATCH
    assert runs["ppart"]["opt"] == runs["pfull"]["opt"]
    assert tdp._tail(runs["ppart"]["out"]) == tdp._tail(runs["pfull"]["out"])
    assert runs["pfull"]["out"] == runs["jfull"]["out"]
    assert tdp._tail(runs["xp"]["out"]) == tdp._tail(runs["jfull"]["out"])
    assert tdp._tail(runs["xj"]["out"]) == tdp._tail(runs["pfull"]["out"])
    for a, b in (("xp", "jfull"), ("xj", "pfull"), ("pfull", "jfull")):
        assert tdp._werr(runs[a]["opt"], runs[b]["opt"]) < tol
    if case == "dp-bpm":
        assert "over 4 data-shard(s)" in runs["pfull"]["out"]
    manifest = os.path.join(str(tmp_path), "ppart", "ck", "manifest.json")
    with open(manifest) as fp:
        snaps = json.load(fp)["snapshots"]
    assert snaps and all(s.get("world_size", 1) == 1 for s in snaps)


# --- a jobs server over four CPU devices ------------------------------------

def test_job_slice_is_its_grid(tmp_path, monkeypatch):
    """A ``[batch]`` job asking ``dp_devices: 2`` on a server over four CPU
    devices trains on a 2-shard grid (every epoch's ``dp_epoch`` gets a
    2 x 1 grid): its kernel.opt is the offline ``train_nn`` of its conf
    over 2 devices, byte for byte."""
    from test_torch_jobs import (enable_jobs, http, make_app, serve,
                                 serve_conf, stop, wait_terminal,
                                 write_corpus)

    from hpnn_tpu_torch.cli import train_nn_main
    from hpnn_tpu_torch.parallel import dp

    grids = []
    real = dp.dp_epoch

    def spy(*a, **kw):
        mesh = kw.get("mesh")
        grids.append(None if mesh is None else (mesh.n_data, mesh.n_model))
        return real(*a, **kw)

    monkeypatch.setattr(dp, "dp_epoch", spy)

    corpus = write_corpus(tmp_path / "samples", 7, 12)
    conf = serve_conf(tmp_path, kind="SNN")
    app = make_app("port", conf, max_batch=8)
    enable_jobs("port", app, tmp_path / "jobs", capacity=2,
                devices=[torch.device("cpu")] * 4)
    httpd, base = serve("port", app)
    try:
        st, job, _ = http(base, "/v1/kernels/tiny/train", {
            "seed": 32, "train": "BPM", "type": "SNN", "ckpt_every": 1,
            "epochs": 2, "batch": 3, "dp_devices": 2, "samples": corpus})
        assert st == 202, job
        snap = wait_terminal(base, job["job_id"])
    finally:
        stop(httpd, app)
    assert snap["status"] == "done", snap
    assert snap["slice"]["size"] == 2
    assert grids == [(2, 1)] * 2
    with open(os.path.join(snap["path"], "kernel.opt"), "rb") as fp:
        got = fp.read()
    job_conf = next(os.path.join(snap["path"], f)
                    for f in os.listdir(snap["path"]) if f.endswith(".conf"))
    cwd = tmp_path / "offline"
    cwd.mkdir()
    shutil.copy(job_conf, cwd / "nn.conf")
    here = os.getcwd()
    os.chdir(cwd)
    try:
        with _port_slice(2):
            res = _run(train_nn_main, ["-v", "-v", "--epochs", "2",
                                       "--ckpt-every", "1", "--ckpt-dir",
                                       "ck", "--device", "cpu", "nn.conf"])
    finally:
        os.chdir(here)
    assert res[0] == 0, res[2]
    assert "over 2 data-shard(s)" in res[1]
    assert got == res[4].encode()


# --- the grid and the engines against their one-device versions -------------

def test_local_grid_collectives():
    """A 2 x 3 grid of the CPU: shard (d, m) is position d * 3 + m;
    ``gather``, ``psum`` and ``shift`` act within each model group,
    ``psum_data`` over the data shards of a model index in shard order;
    ``LocalMesh`` and ``DataMesh`` are its one-axis cases; ``make_mesh``
    at world 1 builds the grid on the devices named, or refuses."""
    from hpnn_tpu_torch.parallel.mesh import (DataMesh, LocalGrid,
                                              LocalMesh, make_mesh)

    g = LocalGrid(2, 3, ["cpu"] * 6)
    assert g.local == (0, 1, 2, 0, 1, 2) and g.local_data == (0, 0, 0,
                                                              1, 1, 1)
    assert g.data_devices() == (torch.device("cpu"),) * 2
    assert g.distinct() == (torch.device("cpu"),)
    parts = [torch.full((2,), float(p + 1), dtype=torch.float64)
             for p in range(6)]
    got = g.gather(parts)
    assert torch.equal(got[1], torch.cat(parts[:3]))
    assert torch.equal(got[4], torch.cat(parts[3:]))
    assert [torch.equal(a, b) for a, b in zip(g.gather(parts, only=(3,)),
                                              [got[3]])] == [True]
    assert [float(t[0]) for t in g.psum(parts)] == [6.0] * 3 + [15.0] * 3
    assert [float(t[0]) for t in g.psum_data(parts)] == [5.0, 7.0, 9.0] * 2
    assert [float(t[0]) for t in g.shift(parts).wait()] == [2.0, 3.0, 1.0,
                                                            5.0, 6.0, 4.0]
    assert torch.equal(g.gather_rows([p[None] for p in parts]),
                       torch.stack(parts[:3]))
    lm, dm = LocalMesh(["cpu"] * 3), DataMesh(["cpu"] * 4)
    assert isinstance(lm, LocalGrid) and (lm.n_data, lm.n_model) == (1, 3)
    assert isinstance(dm, LocalGrid) and (dm.n_data, dm.n_model) == (4, 1)
    m = make_mesh(2, 2, devices=["cpu"] * 5)
    assert isinstance(m, LocalGrid) and len(m.devices) == 4
    assert make_mesh(1, 1, device="cpu").devices == (torch.device("cpu"),)
    for bad in (dict(n_data=2, n_model=1),
                dict(n_data=2, n_model=2, devices=["cpu"] * 3)):
        with pytest.raises(ValueError, match="grid needs"):
            make_mesh(**bad)
    with pytest.raises(ValueError, match="grid needs"):
        LocalGrid(2, 2, ["cpu"] * 3)


def _dp_problem(seed=9, s=12, dims=(7, 5, 3)):
    rng = np.random.default_rng(seed)
    ws = [torch.as_tensor(rng.uniform(-1, 1, (dims[i + 1], dims[i])))
          for i in range(len(dims) - 1)]
    xs = torch.as_tensor(rng.uniform(-1, 1, (s, dims[0])))
    ts = torch.as_tensor(np.where(rng.uniform(size=(s, dims[-1])) > 0.5,
                                  1.0, 0.0))
    return ws, xs, ts


@pytest.mark.parametrize("momentum", [False, True], ids=["bp", "bpm"])
@pytest.mark.parametrize("n", [2, 3])
def test_dp_epoch_on_a_grid_equals_one_device(n, momentum):
    """``dp_epoch`` over an N x 1 grid (each shard's slots on its device,
    partial sums added in shard order, each shard updating its 1/N slice)
    against the one-device epoch on the same padded batches: 1e-13; the
    momentum lives as N slices of the flat padded state."""
    from hpnn_tpu_torch.parallel import DataMesh, dp
    from hpnn_tpu_torch.parallel.mesh import shard_bounds

    ws, xs, ts = _dp_problem()
    shapes = tuple(tuple(w.shape) for w in ws)
    nb, bsz = 3, 4 * n
    xb = torch.zeros(nb, bsz, xs.shape[1], dtype=xs.dtype)
    tb = torch.zeros(nb, bsz, ts.shape[1], dtype=ts.dtype)
    mb = torch.zeros(nb, bsz, dtype=xs.dtype)
    for i in range(nb):
        xb[i, :4], tb[i, :4], mb[i, :4] = xs[i * 4:(i + 1) * 4], \
            ts[i * 4:(i + 1) * 4], 1.0
    one = dp.dp_epoch(dp.dp_resident_carry(ws), xb, tb, mb, "SNN",
                      momentum, 0.01, 0.2, shapes)
    total = one[0].shape[0]
    mesh = DataMesh(["cpu"] * n)
    sl = [shard_bounds(bsz, n, d) for d in range(n)]
    got = dp.dp_epoch(dp.dp_resident_carry(ws, n),
                      [xb[:, lo:hi] for lo, hi in sl],
                      [tb[:, lo:hi] for lo, hi in sl],
                      [mb[:, lo:hi] for lo, hi in sl], "SNN", momentum,
                      0.01, 0.2, shapes, mesh=mesh)
    assert got[0].shape[0] % n == 0
    assert float((got[0][:total] - one[0]).abs().max()) < 1e-13
    assert float((got[2] - one[2]).abs().max()) < 1e-13
    if momentum:
        assert len(got[1]) == n
        assert float((torch.cat(got[1])[:total] - one[1]).abs().max()) \
            < 1e-13
    else:
        assert got[1] is None


@pytest.mark.parametrize("storage", [None, "f32"])
@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("kind,momentum", [("ANN", False), ("SNN", True)])
def test_tiled_mesh_route_equals_plain(kind, momentum, n, storage):
    """``train_epoch_tiled_mesh`` over N shards (the lanes of each group of
    5 split 3/2 or 2/2/1, the tail group's lanes masked) against
    ``train_epoch_tiled_plain`` at the same tile: the same iteration
    counts and verdicts, weights and errors within 1e-12."""
    from hpnn_tpu_torch.ops.convergence_tile import (train_epoch_tiled_mesh,
                                                     train_epoch_tiled_plain)
    from hpnn_tpu_torch.parallel import DataMesh

    ws, xs, ts = _dp_problem(seed=4, s=13, dims=(6, 5, 3))
    if kind == "ANN":
        ts = ts * 2.0 - 1.0
    kw = dict(tile=5, delta=1e-3, max_iter=400, storage=storage)
    wp, sp = train_epoch_tiled_plain(ws, xs, ts, kind, momentum, **kw)
    wm, sm = train_epoch_tiled_mesh(ws, xs, ts, kind, momentum,
                                    DataMesh(["cpu"] * n), **kw)
    assert torch.equal(sm[:, [1, 2, 4]], sp[:, [1, 2, 4]])
    assert float((sm - sp).abs().max()) < 1e-12
    for a, b in zip(wm, wp):
        assert a.dtype == b.dtype
        assert float((a.double() - b.double()).abs().max()) < 1e-12


@pytest.mark.parametrize("momentum", [False, True], ids=["bp", "bpm"])
def test_hybrid_epoch_on_a_2x2_grid_equals_the_model_axis(momentum):
    """``tp_dp_train_epoch`` on a 2 x 2 grid (each data shard its half of
    every batch's slots) against the 1 x 2 model axis with the whole
    batch: 1e-13; every data shard's copy of a row block identical."""
    from hpnn_tpu_torch.parallel import (LocalGrid, LocalMesh,
                                         tp_dp_resident_carry,
                                         tp_dp_train_epoch, tp_export_weights)

    ws, xs, ts = _dp_problem(seed=5, s=12, dims=(7, 6, 4, 3))
    xb, tb = xs.view(3, 4, -1), ts.view(3, 4, -1)
    mb = torch.ones(3, 4, dtype=xs.dtype)
    lm = LocalMesh(["cpu"] * 2)
    c1, _, e1 = tp_dp_train_epoch(tp_dp_resident_carry(ws, lm), xb, tb, mb,
                                  "ANN", momentum, 0.05, 0.2, mesh=lm)
    grid = LocalGrid(2, 2, ["cpu"] * 4)
    c2, dw, e2 = tp_dp_train_epoch(
        tp_dp_resident_carry(ws, grid), [xb[:, :2], xb[:, 2:]],
        [tb[:, :2], tb[:, 2:]], [mb[:, :2], mb[:, 2:]], "ANN", momentum,
        0.05, 0.2, mesh=grid)
    assert len(c2.shards) == 4 and (dw is not None) == momentum
    assert float((e1 - e2).abs().max()) < 1e-13
    for a, b in zip(tp_export_weights(c1, lm), tp_export_weights(c2, grid)):
        assert np.abs(a - b).max() < 1e-13
    for m in range(2):
        for a, b in zip(c2.shards[m], c2.shards[2 + m]):
            assert torch.equal(a, b)
