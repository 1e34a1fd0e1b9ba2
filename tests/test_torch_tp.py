"""``[model]`` row sharding of the PyTorch port against the JAX package, on
the CPU, in one process.

The port's model axis is the ``torch.distributed`` world (one rank a
device) or, for the serving tier, a ``LocalMesh`` of K devices of one
process; here the LocalMesh repeats the CPU device.  The JAX side runs on
``tests/conftest.py``'s 8-device CPU mesh.

* ``pad_topology``/``unpad_topology`` bit for bit against
  ``hpnn_tpu.parallel.mesh``;
* the ring engine and its all-gather schedule (``tp_eval_batch``) against
  the JAX package's ``tp_eval_batch`` at k = 2, 4 and 8, ANN, SNN and the
  native LNN, f64 (within 1e-12) and bf16 (within 2^-6: every product
  rounds to bf16 in both packages, but the port's first layer applies its
  activation in float32 before rounding, XLA after; 2^-6 is the JAX
  package's own ring-vs-replicated envelope, tests/test_tp_engine.py);
* the per-sample row-sharded epoch and the hybrid minibatch epoch on a
  LocalMesh against the JAX package's engines (1e-12), and the rest of
  the public API (``tp_forward``, ``tp_forward_explicit``, the
  column-sharded first layer) within 1e-14;
* ``select_run_batch``'s route names; the ``tp@4`` serving tier against
  the strict tier (1e-12 f64), its ``route="tp@4"`` label, the per-model
  budget gate, a swap under it, and pinned dispatch;
* the three repairs: ``train_nn -S 2``, ``run_nn`` of a ``[model] 2`` conf
  and the help text, with the port's streams (one process: one shard, the
  JAX warning) byte-identical to the JAX package pinned to one device
  with ``hpnn_tpu.api.device_slice``; ``--epochs 3`` through the
  ``tp-resident`` pipeline against its restaging route and the JAX
  package; ``[batch]`` and ``[tile]`` beside ``[model]`` in one process.
"""

import contextlib
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_epochs import _jax, _port, _run, _setup, _weights

N_IN, N_HID, N_OUT = 8, 6, 3


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kernel(seed, dims):
    from hpnn_tpu_torch.models.kernel import generate_kernel

    kern, _ = generate_kernel(seed, dims[0], dims[1:-1], dims[-1])
    return kern.weights


def _problem(seed, kind, s=12, dims=(N_IN, N_HID, N_OUT)):
    ws = _kernel(seed, dims)
    rng = np.random.default_rng(seed)
    xs = rng.uniform(-1, 1, (s, dims[0]))
    if kind == "LNN":
        ts = rng.uniform(-1, 1, (s, dims[-1]))
    else:
        ts = -np.ones((s, dims[-1]))
        ts[np.arange(s), rng.integers(0, dims[-1], s)] = 1.0
    return ws, xs, ts


def _mesh(k):
    from hpnn_tpu_torch.parallel import LocalMesh

    return LocalMesh(["cpu"] * k)


# --- padding -----------------------------------------------------------------

@pytest.mark.parametrize("k", [2, 3, 4, 8])
def test_pad_and_unpad_match_jax_bitwise(k):
    from hpnn_tpu.parallel.mesh import pad_topology as jpad
    from hpnn_tpu.parallel.mesh import unpad_topology as junpad
    from hpnn_tpu_torch.parallel import pad_topology, unpad_topology

    ws = _kernel(3, (20, 230, 7, 5))   # 230 rows pad to 232 at k=4 (XRD)
    got, orig = pad_topology(tuple(torch.as_tensor(w) for w in ws), k)
    want, jorig = jpad(tuple(jnp.asarray(w) for w in ws), k)
    assert orig == list(jorig)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert got[-1].shape[0] == 5                 # the head is never padded
    back = unpad_topology(got, orig)
    jback = junpad(want, jorig)
    for b, jb, w in zip(back, jback, ws):
        assert np.array_equal(b.numpy(), w)
        assert np.array_equal(b.numpy(), np.asarray(jb))


def test_padding_stays_zero_under_training():
    """BPM on row blocks at k=4 (6 rows pad to 8): the padded rows, the
    next layer's padded columns and the momentum on them stay zero."""
    from hpnn_tpu_torch.parallel import tp

    ws, xs, ts = _problem(5, "LNN", s=3)
    mesh = _mesh(4)
    carry = tp.tp_resident_carry([torch.as_tensor(w) for w in ws], mesh)
    # a loose delta: the native LNN head stops past the minimum iterations
    carry, st = tp.tp_train_epoch_resident(carry, torch.as_tensor(xs),
                                           torch.as_tensor(ts), "LNN", True,
                                           mesh, delta=1.0)
    assert st[:, 2].tolist() == [16.0, 16.0, 16.0]
    last = carry.shards[-1]                      # shard 3: rows 6-7 padded
    assert torch.all(last[0][-2:] == 0)
    for s in carry.shards:
        assert torch.all(s[1][:, 6:] == 0)


# --- the ring eval engine ----------------------------------------------------

DT = {"f64": (torch.float64, jnp.float64, 1e-12),
      "bf16": (torch.bfloat16, jnp.bfloat16, 2.0 ** -6)}


@pytest.mark.parametrize("dtype", list(DT))
@pytest.mark.parametrize("kind", ["ANN", "SNN", "LNN"])
@pytest.mark.parametrize("k", [2, 4, 8])
def test_eval_engines_match_jax(kind, dtype, k):
    from hpnn_tpu.parallel import make_mesh as jmesh
    from hpnn_tpu.parallel import tp_eval_batch as jeval
    from hpnn_tpu_torch.parallel import tp_engine_carry, tp_eval_batch

    tdt, jdt, atol = DT[dtype]
    ws, xs, _ = _problem(11, kind, dims=(N_IN, N_HID, 5, N_OUT))
    jws = tuple(jnp.asarray(w, jdt) for w in ws)
    want = np.asarray(jeval(jws, jnp.asarray(xs, jdt), kind,
                            jmesh(n_data=1, n_model=k)), np.float64)
    tws = [torch.as_tensor(w).to(tdt) for w in ws]
    x = torch.as_tensor(xs).to(tdt)
    mesh = _mesh(k)
    outs = {}
    for overlap in (True, False):
        carry = tp_engine_carry(tws, mesh, overlap=overlap)
        outs[overlap] = tp_eval_batch(carry, x, kind, mesh,
                                      overlap=overlap).double().numpy()
        np.testing.assert_allclose(outs[overlap], want, atol=atol, rtol=0)
    # the two schedules associate the sums differently: a dtype envelope
    np.testing.assert_allclose(outs[True], outs[False],
                               atol=1e-13 if dtype == "f64" else atol)
    assert outs[True].shape == (xs.shape[0], N_OUT)


def test_ring_output_is_replicated_and_blocks_match_the_full_layer():
    """Every shard's head sums its partials in canonical block order, so
    each shard's output is the same bits; a row block's first layer is the
    full layer's rows bit for bit."""
    from hpnn_tpu_torch.ops.kernels import fused_linear_act
    from hpnn_tpu_torch.parallel import tp

    # wide enough that a sum of four partials in another order moves bits
    ws, xs, _ = _problem(7, "SNN", s=64, dims=(N_IN, 64, 5))
    x = torch.as_tensor(xs)
    mesh = _mesh(4)
    carry = tp.tp_engine_carry([torch.as_tensor(w) for w in ws], mesh,
                               overlap=True)
    outs, _, _ = tp._forward_blocks(carry.shards, carry.cols,
                                    [x] * 4, "SNN", mesh, True)
    assert all(torch.equal(o, outs[0]) for o in outs)
    full = fused_linear_act(torch.as_tensor(ws[0]), x, True)
    rows = torch.cat([fused_linear_act(s[0], x, True)
                      for s in carry.shards], dim=1)
    assert torch.equal(rows, full)


def test_engine_carry_layout_and_export():
    from hpnn_tpu_torch.parallel import tp

    ws = _kernel(19, (N_IN, N_HID, N_OUT))
    mesh = _mesh(8)
    carry = tp.tp_engine_carry([torch.as_tensor(w) for w in ws], mesh)
    assert carry.rows == (True, False)
    assert all(s[0].shape == (1, N_IN) for s in carry.shards)  # 6 -> 8 / 8
    assert all(s[1].shape == (N_OUT, 8) for s in carry.shards)  # whole head
    for a, b in zip(tp.tp_export_weights(carry, mesh), ws):
        assert np.array_equal(a, b)
    # the per-sample layout row-shards a head that the axis divides
    assert tp.tp_resident_carry([torch.as_tensor(w) for w in ws],
                                _mesh(3)).rows == (True, True)


def test_select_run_batch_routes():
    from hpnn_tpu_torch import ops

    _, name = ops.select_run_batch(torch.float64, device="cpu",
                                   model_mesh=_mesh(2))
    assert name == "tp-ring"
    with _env(HPNN_NO_TP_OVERLAP="1"):
        _, name = ops.select_run_batch(torch.float64, device="cpu",
                                       model_mesh=_mesh(2))
    assert name == "tp-gather"
    _, name = ops.select_run_batch(torch.float64, device="cpu",
                                   model_mesh=_mesh(1))
    assert name == "rows"


@contextlib.contextmanager
def _env(**kw):
    old = {k: os.environ.get(k) for k in kw}
    os.environ.update(kw)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# --- the training engines on a LocalMesh -------------------------------------

@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("kind,momentum", [("ANN", False), ("SNN", True),
                                           ("LNN", False)])
def test_train_sample_matches_jax(kind, momentum, k):
    from hpnn_tpu.parallel import make_mesh as jmesh
    from hpnn_tpu.parallel import tp_train_sample as jtrain
    from hpnn_tpu_torch.parallel import tp_train_sample

    ws, xs, ts = _problem(13, kind, s=1, dims=(10, 8, 4))
    if kind != "LNN":
        ts[0] = -1.0 if kind == "ANN" else 0.0
        ts[0, 1] = 1.0
    # delta 1e-4 (the reference's 1e-6 costs ~10k iterations here)
    jw, jst = jtrain(tuple(jnp.asarray(w) for w in ws), jnp.asarray(xs[0]),
                     jnp.asarray(ts[0]), kind, momentum,
                     jmesh(n_data=1, n_model=k), delta=1e-4)
    w, row = tp_train_sample([torch.as_tensor(v) for v in ws],
                             torch.as_tensor(xs[0]), torch.as_tensor(ts[0]),
                             kind, momentum, _mesh(k), delta=1e-4)
    assert row[2] == int(jst.n_iter)
    for a, b in zip(w, jw):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-12, rtol=0)


@pytest.mark.parametrize("momentum", [False, True], ids=["bp", "bpm"])
@pytest.mark.parametrize("kind", ["ANN", "SNN", "LNN"])
def test_hybrid_epoch_matches_jax(kind, momentum):
    """The (data x model) minibatch epoch at 1 x 2 against the JAX
    package's 2-D engine on a 1 x 2 mesh (1e-12, its DP envelope)."""
    from hpnn_tpu.parallel import make_mesh as jmesh
    from hpnn_tpu.parallel import (tp_dp_resident_carry as jcarry,
                                   tp_dp_train_epoch_resident as jepoch,
                                   tp_export_weights as jexport)
    from hpnn_tpu_torch.parallel import (tp_dp_resident_carry,
                                         tp_dp_train_epoch,
                                         tp_export_weights)

    ws, xs, ts = _problem(13, kind)
    s, bsz = xs.shape[0], 5
    nb = -(-s // bsz)
    pos = np.arange(s)
    sel = np.zeros(nb * bsz, np.int32)
    sel[pos] = pos
    mask = np.zeros((nb, bsz))
    mask.reshape(-1)[pos] = 1.0
    mesh = jmesh(n_data=1, n_model=2)
    jw = tuple(jnp.asarray(w) for w in ws)
    c2, _, jerrs = jepoch(jcarry(jw, mesh), jnp.asarray(xs), jnp.asarray(ts),
                          jnp.asarray(sel), jnp.asarray(mask), kind,
                          momentum, 0.01, alpha=0.2, mesh=mesh)
    want = jexport(c2.blocks, c2.orig, mesh)
    xb = torch.as_tensor(xs[sel].reshape(nb, bsz, -1))
    tb = torch.as_tensor(ts[sel].reshape(nb, bsz, -1))
    lm = _mesh(2)
    carry = tp_dp_resident_carry([torch.as_tensor(w) for w in ws], lm)
    carry, dw, errs = tp_dp_train_epoch(carry, xb, tb,
                                        torch.as_tensor(mask), kind,
                                        momentum, 0.01, 0.2, mesh=lm)
    assert (dw is not None) == momentum
    np.testing.assert_allclose(errs.numpy(), np.asarray(jerrs), atol=1e-12)
    for a, b in zip(tp_export_weights(carry, lm), want):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-12, rtol=0)


@pytest.mark.parametrize("kind", ["ANN", "SNN"])
def test_forward_api_matches_jax(kind):
    from hpnn_tpu import ops as jops
    from hpnn_tpu.parallel import make_mesh as jmesh
    from hpnn_tpu.parallel import tp_run_batch_colsharded as jcol
    from hpnn_tpu_torch.parallel import (tp_forward, tp_forward_colsharded,
                                         tp_forward_explicit,
                                         tp_run_batch, tp_run_batch_colsharded)

    ws = _kernel(12, (19, 13, 7, 5))
    x = np.random.default_rng(5).uniform(-1, 1, 19)
    jw = tuple(jnp.asarray(w) for w in ws)
    want = jops.forward(jw, jnp.asarray(x), kind)
    tw = [torch.as_tensor(w) for w in ws]
    mesh = _mesh(8)
    for g, w in zip(tp_forward(tw, torch.as_tensor(x), kind, mesh), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-14)
    np.testing.assert_allclose(
        tp_forward_explicit(tw, torch.as_tensor(x), kind, mesh).numpy(),
        np.asarray(want[-1]), atol=1e-14)
    xs = np.random.default_rng(6).uniform(-1, 1, (7, 19))
    np.testing.assert_allclose(
        tp_run_batch(tw, torch.as_tensor(xs), kind, mesh).numpy(),
        np.asarray(jops.batched_forward(jw, jnp.asarray(xs), kind)),
        atol=1e-14)
    cw = _kernel(21, (851, 16, 5))
    cx = np.random.default_rng(7).uniform(-1, 1, (7, 851))
    ctw = [torch.as_tensor(w) for w in cw]
    np.testing.assert_allclose(
        tp_forward_colsharded(ctw, torch.as_tensor(cx[0]), kind,
                              mesh).numpy(),
        np.asarray(jops.forward(tuple(jnp.asarray(w) for w in cw),
                                jnp.asarray(cx[0]), kind)[-1]), atol=1e-14)
    for sub in (ctw, ctw[:1]):       # the single-layer branch too
        jsub = tuple(jnp.asarray(w.numpy()) for w in sub)
        np.testing.assert_allclose(
            tp_run_batch_colsharded(sub, torch.as_tensor(cx), kind,
                                    mesh).numpy(),
            np.asarray(jcol(jsub, jnp.asarray(cx), kind,
                            jmesh(n_data=1, n_model=8))), atol=1e-14)


# --- the tp@K serving tier ---------------------------------------------------

def _serve_conf(tmp_path, monkeypatch):
    _setup(tmp_path, monkeypatch, "ANN-BPM")
    return str(tmp_path / "nn.conf")


def test_tp_tier_serves_over_budget_kernels(tmp_path, monkeypatch):
    """The JAX package's acceptance drive (tests/test_tp_engine.py:346-401)
    through the port: with the per-device budget at 0 every kernel is too
    big to replicate, so the tp@4 tier serves it (a per-model decision),
    within 1e-12 of the strict tier, labelled ``route="tp@4"``; a sane
    budget keeps the strict tier."""
    from hpnn_tpu_torch.serve.registry import ModelRegistry

    conf = _serve_conf(tmp_path, monkeypatch)
    monkeypatch.setenv("HPNN_EPOCH_DEVICE_BUDGET_MB", "0")
    reg_tp = ModelRegistry(max_batch=16, device="cpu", tp_mesh=_mesh(4))
    m = reg_tp.register_conf(conf, name="tiny")
    assert reg_tp.tp_shards(m) == 4 and reg_tp.route_for(m) == "tp@4"
    reg_plain = ModelRegistry(max_batch=16, device="cpu")
    m2 = reg_plain.register_conf(conf, name="tiny")
    assert reg_plain.tp_shards(m2) == 0
    assert reg_plain.route_for(m2) == "strict"
    xs = np.random.default_rng(3).uniform(-1, 1, (5, N_IN))
    h = reg_tp.dispatch(m, xs)
    assert h.tier == "tp@4" and h.served_gen == 1
    out_tp = reg_tp.collect(h)
    out_strict = reg_plain.forward(m2, xs)
    np.testing.assert_allclose(out_tp, out_strict, rtol=0, atol=1e-12)
    assert 'route="tp@4"' in reg_tp.metrics.render_prometheus()
    monkeypatch.setenv("HPNN_EPOCH_DEVICE_BUDGET_MB", "4096")
    reg3 = ModelRegistry(max_batch=16, device="cpu", tp_mesh=_mesh(4))
    m3 = reg3.register_conf(conf, name="tiny")
    assert reg3.tp_shards(m3) == 0 and reg3.route_for(m3) == "strict"


def test_tp_tier_swap_pin_and_topology_change(tmp_path, monkeypatch):
    """A same-topology swap rebuilds the mesh's carry (the next answer is
    the new kernel's), a pinned previous generation is sharded a call,
    and a topology change drops the old-shape carry."""
    from hpnn_tpu_torch.io.kernel_io import dump_kernel_to_path
    from hpnn_tpu_torch.models.kernel import Kernel
    from hpnn_tpu_torch.serve.registry import ModelRegistry

    conf = _serve_conf(tmp_path, monkeypatch)
    monkeypatch.setenv("HPNN_EPOCH_DEVICE_BUDGET_MB", "0")
    mesh = _mesh(2)
    reg = ModelRegistry(max_batch=8, device="cpu", tp_mesh=mesh,
                        ab_fraction=0.5)
    m = reg.register_conf(conf, name="tiny")
    xs = np.random.default_rng(4).uniform(-1, 1, (3, N_IN))
    first = reg.forward(m, xs)
    assert mesh in m._tp_weights
    new = Kernel(name="tiny", weights=[w * 0.5 for w in m.nn.kernel.weights])
    dump_kernel_to_path(new, str(tmp_path / "half.opt"))
    res, why = reg.reload("tiny", str(tmp_path / "half.opt"))
    assert res is not None, why
    assert m._tp_weights[mesh][1] == 2          # rebuilt with its generation
    h = reg.dispatch(m, xs)
    assert h.served_gen == 2
    plain = ModelRegistry(max_batch=8, device="cpu")
    p = plain.register_conf(conf, name="p")
    p.swap_kernel(m.nn.kernel, None)
    np.testing.assert_allclose(reg.collect(h), plain.forward(p, xs),
                               atol=1e-12, rtol=0)
    pinned = reg.collect(reg.dispatch(m, xs, gen=1))
    np.testing.assert_allclose(pinned, first, atol=1e-12, rtol=0)
    wide = Kernel(name="tiny", weights=_kernel(9, (N_IN, 4, N_OUT)))
    m.swap_kernel(wide, None)
    assert m._tp_weights[mesh][0].orig == (4, N_OUT)


def test_serve_app_tp_devices_clamp(tmp_path, monkeypatch, capsys):
    """``HPNN_TP_DEVICES`` above the visible devices warns and builds no
    mesh (one device on ``--device cpu``), as the JAX package does on one
    device."""
    from hpnn_tpu_torch.serve.server import ServeApp
    from hpnn_tpu_torch.utils import env, nn_log

    monkeypatch.setenv("HPNN_TP_DEVICES", "4")
    monkeypatch.setattr(env, "_warned_device_caps", set())
    nn_log.set_verbosity(2)
    try:
        app = ServeApp(device="cpu")
    finally:
        nn_log.set_verbosity(0)
    assert app.registry.tp_mesh is None
    out = capsys.readouterr().out
    assert "HPNN_TP_DEVICES=4 > 1 visible device(s); using 1" in out
    assert "TP mesh" not in out
    app.close()


# --- the repairs: one process against the JAX package pinned to one device ---

def _pretrained(tmp_path, monkeypatch, variant, extra=""):
    """The variant's corpus with a kernel the JAX package trained for
    twelve epochs first (a generated kernel costs ~100k eager iterations
    an epoch on the port's CPU route)."""
    _setup(tmp_path, monkeypatch, variant)
    assert _jax(["--epochs", "12", "nn.conf"], {"HPNN_DP_DEVICES": "1"})[0] \
        == 0
    shutil.copy(tmp_path / "kernel.opt", tmp_path / "pre.opt")
    conf = (tmp_path / "nn.conf").read_text()
    (tmp_path / "nn.conf").write_text(
        conf.replace("[init] generate", "[init] pre.opt") + extra)


def _pinned(fn, argv, env=None):
    """A JAX-package CLI run pinned to one of its 8 CPU devices."""
    from hpnn_tpu import api as japi

    import hpnn_tpu.api as jax_api

    with japi.device_slice([jax.devices()[0]]):
        res = _run(fn, argv, env)
    if jax_api._prefetch_thread is not None:
        jax_api._prefetch_thread.join()
    return res


WARN = "NN(WARN): [model] 2 > 1 visible device(s); using 1\n"


@pytest.mark.parametrize("how", [["-S", "2"], ["--model-parallel", "2"],
                                 ["-S2"]], ids=["S", "model-parallel",
                                                "S-attached"])
def test_train_nn_degree_flags_match_jax_on_one_device(tmp_path,
                                                       monkeypatch, how):
    from hpnn_tpu.cli import train_nn_main as jtrain

    _pretrained(tmp_path, monkeypatch, "ANN-BP")
    j = _pinned(jtrain, ["-v", "-v", *how, "nn.conf"])
    p = _port(["-v", "-v", *how, "nn.conf"])
    assert j[0] == p[0] == 0
    assert WARN in p[1]
    assert p[1].index(WARN) < p[1].index("TRAINING FILE")
    assert p[1] == j[1] and p[2] == j[2] and p[3] == j[3]
    for a, b in zip(_weights(p[4]), _weights(j[4])):
        assert np.abs(a - b).max() < 5e-12


@pytest.mark.parametrize("how", ["conf", "S"])
def test_run_nn_model_2_matches_jax_on_one_device(tmp_path, monkeypatch,
                                                  how):
    from hpnn_tpu.cli import run_nn_main as jrun
    from hpnn_tpu_torch import ops
    from hpnn_tpu_torch.cli import run_nn_main

    _pretrained(tmp_path, monkeypatch, "SNN-BP",
                "[model] 2\n" if how == "conf" else "")
    argv = ["-v", "-v", *(["-S", "2"] if how == "S" else []), "nn.conf"]
    j = _pinned(jrun, argv)
    seen = []
    real = ops.select_run_batch

    def spy(*a, **kw):
        fn, name = real(*a, **kw)
        seen.append(name)
        return fn, name

    monkeypatch.setattr(ops, "select_run_batch", spy)
    p = _run(run_nn_main, [*argv[:-1], "--device", "cpu", argv[-1]])
    assert j[0] == p[0] == 0
    assert WARN in p[1] and "TESTING FILE" in p[1]
    assert p[1].index(WARN) < p[1].index("TESTING FILE")
    assert p[1] == j[1] and p[2] == j[2]
    assert seen == ["rows"]         # one shard: the unsharded strict route


def test_help_names_the_row_split():
    from hpnn_tpu_torch.cli import _help_text

    for name in ("train_nn", "run_nn"):
        text = _help_text(name)
        assert "ROADMAP" not in text and "accepted and ignored)" not in \
            text.split("-S")[1].split("\n")[0]
        assert "-S \tnumber of device shards" in text
    assert "--model-parallel N" in _help_text("train_nn")
    assert "--model-parallel" not in _help_text("run_nn")


def test_epochs_tp_resident_pipeline(tmp_path, monkeypatch):
    """``[model] 2 --epochs 3`` in one process: the ``tp-resident``
    pipeline (one shard: the per-sample route), the clamp warning after
    every epoch's banner, byte-identical to its restaging route and to the
    JAX package pinned to one device."""
    import hpnn_tpu_torch.api as api
    from hpnn_tpu.cli import train_nn_main as jtrain

    _pretrained(tmp_path, monkeypatch, "SNN-BPM", "[model] 2\n")
    argv = ["-v", "-v", "--epochs", "3", "nn.conf"]
    api.reset_epoch_metrics()
    on = _port(argv)
    met = dict(api.EPOCH_METRICS)
    api.reset_epoch_metrics()
    off = _port(argv, {"HPNN_NO_EPOCH_PIPELINE": "1"})
    off_met = dict(api.EPOCH_METRICS)
    j = _pinned(jtrain, argv)
    assert met["mode"] == "tp-resident" and met["tp_devices"] == 1
    assert met["epochs"] == 3 and met["weight_bytes_per_device"] > 0
    assert off_met["mode"] == "tp-restage"
    assert on[1].count(WARN) == 3
    assert on == off
    assert on[1] == j[1] and on[2] == j[2] and on[3] == j[3]


@pytest.mark.parametrize("extra", ["[batch] 4\n[model] 2\n",
                                   "[batch] 4\n[model] 2\n[tile] 4\n"],
                         ids=["batch", "batch-tile"])
def test_batch_beside_model_on_one_device_matches_jax(tmp_path, monkeypatch,
                                                      extra):
    """``[batch]`` (and ``[tile]``) beside ``[model] 2`` in one process:
    the model axis clamps to 1 with the JAX warning and minibatch DP trains
    ([tile] + [model] warns and keeps minibatch DP), as the JAX package
    does pinned to one device."""
    from hpnn_tpu.cli import train_nn_main as jtrain

    _pretrained(tmp_path, monkeypatch, "ANN-BPM", extra)
    argv = ["-v", "-v", "--epochs", "2", "nn.conf"]
    j = _pinned(jtrain, argv)
    p = _port(argv)
    assert j[0] == p[0] == 0
    assert WARN in p[1] and "TRAINING BATCH" in p[1]
    if "[tile]" in extra:
        assert "[tile] + [model] hybrid is not supported" in p[1]
    assert p[1] == j[1] and p[2] == j[2]
    for a, b in zip(_weights(p[4]), _weights(j[4])):
        assert np.abs(a - b).max() < 1e-11
