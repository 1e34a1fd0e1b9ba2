"""The port's ``fast@meshN`` serving tier and ``fused_bpm_update`` at
bfloat16 against the JAX package, on the CPU.

The JAX side runs on the conftest's 8 virtual CPU devices
(``data_mesh(None)`` is an 8-device mesh there); the port's mesh is the
CPU repeated 8 times (``parallel.DataMesh``), which its data axis allows
as the tp@K tier's model axis does.  The same seeded numpy rows and one
dumped 8-6-3 kernel go through both registries.

Bits: on a card every shard runs the hand-written ``fused_linear_act``,
whose rows do not depend on the batch, so ``chip_smoke.py`` (phase 28)
holds a ``fast@meshN`` reply bit-identical to the ``fast`` reply of the
whole bucket.  On the CPU the fast forward is a matmul (MKL) whose bits
may follow the row count, so here the sharded reply is held bit-identical
to the port's own ``fast`` tier run on each shard's row block (the split
and the gather are what is under test), and within the dtype envelope of
the ``fast`` reply of the whole bucket.
"""

import sys
import threading

import numpy as np
import pytest
import torch

import jax

from hpnn_tpu_torch.parallel.mesh import DataMesh

N_IN, N_HID, N_OUT = 8, 6, 3
MAX_BATCH = 256
# the fast tier's envelopes against the JAX package, as the port's kernel
# tests state them: f64 (tests/test_torch_kernels.py, the GEMM chain),
# f32 (batched forward at unit-scale inputs) and bf16 (chip_smoke.py's
# bfloat16 limit: one rounding of a bfloat16 output near 1 is 2^-8)
JAX_LIMIT = {"f64": 1e-12, "f32": 1e-5, "bf16": 2e-2}
# the port's sharded reply against its own whole-bucket fast reply on the
# CPU, where the matmul's bits follow the row count
SELF_LIMIT = {"f64": 1e-13, "f32": 1e-6, "bf16": 1e-2}


def _write_conf(tmp_path, name="meshy", dtype="f64", seed=1234,
                hidden=N_HID):
    from hpnn_tpu_torch.io.kernel_io import dump_kernel_to_path
    from hpnn_tpu_torch.models.kernel import generate_kernel

    kern, _ = generate_kernel(seed, N_IN, [hidden], N_OUT)
    kpath = str(tmp_path / f"{name}.opt")
    dump_kernel_to_path(kern, kpath)
    conf = tmp_path / f"{name}.conf"
    conf.write_text(f"[name] {name}\n[type] ANN\n[init] {kpath}\n"
                    f"[seed] 1\n[train] BP\n[dtype] {dtype}\n")
    return str(conf), kpath


def _port_registry(n=8, **kw):
    from hpnn_tpu_torch.serve.registry import ModelRegistry

    kw.setdefault("max_batch", MAX_BATCH)
    kw.setdefault("parity", "fast")
    kw.setdefault("fast_threshold", 64)
    mesh = DataMesh(["cpu"] * n) if n else None
    return ModelRegistry(device="cpu", mesh=mesh, **kw)


def _jax_registry(n=8, **kw):
    from hpnn_tpu.parallel.mesh import data_mesh
    from hpnn_tpu.serve.registry import ModelRegistry

    kw.setdefault("max_batch", MAX_BATCH)
    kw.setdefault("parity", "fast")
    kw.setdefault("fast_threshold", 64)
    return ModelRegistry(mesh=data_mesh(n) if n else None, **kw)


# --- the tier table ------------------------------------------------------------

@pytest.mark.parametrize("max_batch,threshold", [(256, 64), (256, 1),
                                                 (256, 300), (4, 1),
                                                 (64, 32)])
@pytest.mark.parametrize("n", [0, 2, 4, 8])
@pytest.mark.parametrize("parity", ["fast", "strict"])
def test_tier_for_matches_jax(parity, n, max_batch, threshold):
    """Every bucket's tier under each parity, mesh size and threshold
    equals the JAX registry's, ``fast@mesh8`` included, and a 4-row
    bucket that 8 does not divide stays ``fast``."""
    port = _port_registry(n, max_batch=max_batch, parity=parity,
                          fast_threshold=threshold)
    jreg = _jax_registry(n, max_batch=max_batch, parity=parity,
                         fast_threshold=threshold)
    buckets = port.buckets()
    assert [port.tier_for(b) for b in buckets] == \
        [jreg.tier_for(b) for b in buckets]
    if parity == "fast" and n == 8 and max_batch == 4:
        assert port.tier_for(4) == "fast"
    if parity == "fast" and n == 8 and (max_batch, threshold) == (256, 64):
        assert port.tier_for(64) == "fast@mesh8"


# --- data_mesh -----------------------------------------------------------------

def test_data_mesh_caps_floors_and_warns_like_jax(monkeypatch, capsys):
    """As tests/test_serve.py:238-247: 6 devices floor to 4 with the JAX
    package's warning, 1 is no mesh, 8 is 8; -1/None take every card, an
    over-ask is capped, 0 is off, and the CPU is one device."""
    from hpnn_tpu.parallel.mesh import DATA_AXIS
    from hpnn_tpu.parallel.mesh import data_mesh as jax_data_mesh
    from hpnn_tpu.utils import nn_log as jax_log
    from hpnn_tpu_torch.parallel.mesh import data_mesh
    from hpnn_tpu_torch.utils import nn_log

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    nn_log.set_verbosity(1)
    jax_log.set_verbosity(1)
    try:
        mesh = data_mesh(6, "cuda")
        port_out = capsys.readouterr().out
        jmesh = jax_data_mesh(6)
        jax_out = capsys.readouterr().out
    finally:
        nn_log.set_verbosity(0)
        jax_log.set_verbosity(0)
    assert mesh.n_data == jmesh.shape[DATA_AXIS] == 4
    assert mesh.devices == tuple(torch.device("cuda", i) for i in range(4))
    assert "floored from 6 to 4 devices" in port_out
    assert port_out == jax_out
    assert data_mesh(1, "cuda") is None and jax_data_mesh(1) is None
    assert data_mesh(8, "cuda").n_data == jax_data_mesh(8).shape[DATA_AXIS]
    assert data_mesh(-1, "cuda").n_data == 8
    assert data_mesh(None, "cuda").n_data == 8
    assert data_mesh(64, "cuda").n_data == 8
    assert data_mesh(0, "cuda") is None
    assert data_mesh(4, "cpu") is None and data_mesh(-1, "cpu") is None
    # a one-device host: the JAX package's cap gives no mesh too
    one = jax.devices()[:1]
    monkeypatch.setattr(jax, "devices", lambda *a: one)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert jax_data_mesh(4) is None and data_mesh(4, "cuda") is None


# --- replies ---------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f64", "f32", "bf16"])
def test_fast_mesh8_replies_match_jax_and_own_fast(tmp_path, dtype):
    conf, _ = _write_conf(tmp_path, dtype=dtype)
    port = _port_registry(8)
    fast = _port_registry(0)
    # the fast tier at every bucket: a shard's block is 8 or 32 rows
    blocks_reg = _port_registry(0, fast_threshold=1)
    jreg = _jax_registry(8)
    pm = port.register_conf(conf, name="s")
    fm = fast.register_conf(conf, name="f")
    bm = blocks_reg.register_conf(conf, name="b")
    jm = jreg.register_conf(conf, name="j")
    rng = np.random.default_rng(17)
    for rows in (64, 200, 256):      # exact bucket, padded bucket, cap
        xs = rng.uniform(-1, 1, (rows, N_IN))
        h = port.dispatch(pm, xs)
        got = port.collect(h)
        assert h.tier == jreg.tier_for(h.bucket) == "fast@mesh8"
        assert h.served_gen == 1
        # /metrics labels the route by the parity, as the JAX package does
        assert port.route_for(pm) == jreg.route_for(jm) == "fast"
        np.testing.assert_allclose(got, jm.infer(xs),
                                   atol=JAX_LIMIT[dtype], rtol=0)
        whole = fm.infer(xs)
        np.testing.assert_allclose(got, whole, atol=SELF_LIMIT[dtype],
                                   rtol=0)
        # the port's own fast tier on each shard's block of the padded
        # bucket, gathered in shard order: the same bits
        pad = np.zeros((h.bucket, N_IN))
        pad[:rows] = xs
        blk = h.bucket // 8
        blocks = np.concatenate([bm.infer(pad[i * blk:(i + 1) * blk])
                                 for i in range(8)])
        np.testing.assert_array_equal(got, blocks[:rows])
    assert port.cache_stats() == {"entries": 2, "hits": 1, "misses": 2}


def test_mesh_copies_one_per_distinct_device(tmp_path):
    """Shards of one device share one copy, the registry's own device
    serves its weights as they are, and the copies are placed once."""
    from hpnn_tpu_torch.serve.registry import ModelRegistry

    conf, _ = _write_conf(tmp_path)
    mesh = DataMesh(["cpu"] * 4)
    reg = ModelRegistry(max_batch=8, parity="fast", fast_threshold=4,
                        device="cpu", mesh=mesh)
    model = reg.register_conf(conf, name="c")
    copies, gen = model.mesh_weights(mesh)
    assert gen == 1 and len(copies) == 4
    assert all(c is copies[0] for c in copies)
    assert all(a is b for a, b in zip(copies[0], model.mlp.weights))
    assert model.mesh_weights(mesh)[0] is copies
    assert mesh.distinct() == (torch.device("cpu"),)


# --- swaps and pins --------------------------------------------------------------

def test_swap_under_the_mesh_same_topology_and_topology_change(tmp_path):
    from hpnn_tpu_torch.io.kernel_io import load_kernel

    conf, _ = _write_conf(tmp_path, name="sw")
    _, k2 = _write_conf(tmp_path, name="k2", seed=99)
    _, k3 = _write_conf(tmp_path, name="k3", seed=7, hidden=5)
    port = _port_registry(8)
    model = port.register_conf(conf, name="sw")
    xs = np.random.default_rng(5).uniform(-1, 1, (64, N_IN))
    port.forward(model, xs)                    # places the mesh copies
    (before,) = model._mesh_weights.values()
    res, why = port.reload("sw", k2)
    assert why == "" and res["generation"] == 2
    assert not res["topology_changed"]
    copies, gen = model.mesh_weights(port.mesh)
    assert gen == 2 and copies is not before[0]
    assert all(a is b for a, b in zip(copies[0], model.mlp.weights))
    h = port.dispatch(model, xs)
    got = port.collect(h)
    assert h.tier == "fast@mesh8" and h.served_gen == 2
    ref = _port_registry(8).register(
        "ref2", _nn_with(conf, load_kernel(k2)))
    np.testing.assert_array_equal(got, ref.infer(xs))
    # a topology change installs a fresh dict: the old entries keep theirs
    old_dict = model._mesh_weights
    res, _ = port.reload("sw", k3)
    assert res["topology_changed"] and model._mesh_weights is not old_dict
    h = port.dispatch(model, xs)
    got = port.collect(h)
    assert h.tier == "fast@mesh8" and h.served_gen == 3
    assert model.mesh_weights(port.mesh)[0][0][0].shape == (5, N_IN)
    ref = _port_registry(8).register(
        "ref3", _nn_with(conf, load_kernel(k3)))
    np.testing.assert_array_equal(got, ref.infer(xs))


def _nn_with(conf, kernel):
    from hpnn_tpu_torch.api import configure

    nn = configure(conf)
    nn.kernel = kernel
    return nn


def test_pinned_dispatch_takes_fast_like_jax(tmp_path):
    """A/B pinning: a pinned batch never shards (tier ``fast``), as in
    the JAX package (registry.py:766-768); unpinned it does."""
    conf, _ = _write_conf(tmp_path, name="pin")
    _, k2 = _write_conf(tmp_path, name="pin2", seed=99)
    port = _port_registry(8, ab_fraction=0.5)
    jreg = _jax_registry(8, ab_fraction=0.5)
    pm = port.register_conf(conf, name="pin")
    jm = jreg.register_conf(conf, name="pin")
    xs = np.random.default_rng(3).uniform(-1, 1, (64, N_IN))
    jm.infer(xs)              # a JAX model uploads at its first dispatch
    assert port.reload("pin", k2)[0]["generation"] == 2
    assert jreg.reload("pin", k2)[0]["generation"] == 2
    for gen in (1, 2, None):
        ph = port.dispatch(pm, xs, gen=gen)
        jh = jreg.dispatch(jm, xs, gen=gen)
        pout, jout = port.collect(ph), jreg.collect(jh)
        assert ph.tier == jh.tier == ("fast@mesh8" if gen is None
                                      else "fast")
        assert ph.served_gen == (gen or 2)
        np.testing.assert_allclose(pout, jout, atol=JAX_LIMIT["f64"],
                                   rtol=0)


def test_swap_under_load_labels_every_reply(tmp_path):
    """Nine client threads (more than the cores) race twelve swaps between
    two kernels with a short switch interval: every fast@mesh8 reply
    names the generation whose weights computed it."""
    conf, k1 = _write_conf(tmp_path, name="ld")
    _, k2 = _write_conf(tmp_path, name="ld2", seed=99)
    port = _port_registry(8)
    model = port.register_conf(conf, name="ld")
    xs = np.random.default_rng(9).uniform(-1, 1, (256, N_IN))
    refs = {}
    for path in (k1, k2):
        ref = _port_registry(8).register_conf(
            _conf_for(tmp_path, path), name="r")
        refs[path] = ref.infer(xs)
    assert np.abs(refs[k1] - refs[k2]).max() > 1e-3
    gens = {1: k1}
    errors, seen = [], []
    stop = threading.Event()

    def client():
        try:
            while not stop.is_set():
                h = port.dispatch(model, xs)
                seen.append((h.served_gen, port.collect(h)))
        except Exception as exc:  # reported below
            errors.append(exc)

    def swapper():
        try:
            for i in range(12):
                path = (k2, k1)[i % 2]
                res, why = port.reload("ld", path)
                assert why == ""
                gens[res["generation"]] = path
        except Exception as exc:  # reported below
            errors.append(exc)
        finally:
            stop.set()

    threads = [threading.Thread(target=client) for _ in range(9)]
    threads.append(threading.Thread(target=swapper))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors and len(seen) > 0
    for gen, out in seen:
        np.testing.assert_array_equal(out, refs[gens[gen]])
    assert len({g for g, _ in seen}) >= 2 or len(seen) < 3


def _conf_for(tmp_path, kpath):
    conf = tmp_path / (kpath.rsplit("/", 1)[1] + ".conf")
    conf.write_text(f"[name] r\n[type] ANN\n[init] {kpath}\n"
                    "[seed] 1\n[train] BP\n[dtype] f64\n")
    return str(conf)


# --- ServeApp / serve_nn -----------------------------------------------------------

def test_strict_mesh_warns_inert_like_jax(capsys):
    from hpnn_tpu.serve.server import ServeApp as JaxServeApp
    from hpnn_tpu.utils import nn_log as jax_log
    from hpnn_tpu_torch.serve.server import ServeApp
    from hpnn_tpu_torch.utils import nn_log

    nn_log.set_verbosity(1)
    jax_log.set_verbosity(1)
    try:
        app = ServeApp(max_batch=8, parity="strict", mesh_devices=2,
                       device="cpu")
        port_out = capsys.readouterr().out
        japp = JaxServeApp(max_batch=8, parity="strict", mesh_devices=2)
        jax_out = capsys.readouterr().out
    finally:
        nn_log.set_verbosity(0)
        jax_log.set_verbosity(0)
    try:
        assert app.registry.mesh is None and japp.registry.mesh is None
        line = [ln for ln in port_out.splitlines() if "inert" in ln]
        assert line == [ln for ln in jax_out.splitlines() if "inert" in ln]
        assert line == ["NN(WARN): serve: --mesh is inert under "
                        "parity=strict (the bit-parity GEMV scan never "
                        "shards); pass --parity fast to enable sharded "
                        "serving"]
    finally:
        app.close(drain=False)
        japp.close(drain=False)


def test_serve_nn_mesh_on_the_cpu_is_the_plain_fast_tier(tmp_path, capsys):
    """``serve_nn --parity fast --mesh N`` is accepted and capped to the
    one CPU device: no mesh, no warning, the 256-row bucket on ``fast``;
    ``--mesh -1`` likewise.  The warmup covers every bucket."""
    from hpnn_tpu_torch.cli import serve_app
    from hpnn_tpu_torch.utils import nn_log

    conf, _ = _write_conf(tmp_path, name="cli")
    for n in ("4", "-1"):
        app, args = serve_app(["-v", "-v", "-v", "--parity", "fast",
                               "--mesh", n, "-b", "256", "--fast-threshold",
                               "64", "--device", "cpu", "--warmup-mode",
                               "sync", conf])
        try:
            assert app is not None and args.mesh == int(n)
            assert app.registry.mesh is None
            assert app.registry.tier_for(256) == "fast"
            out = capsys.readouterr().out
            assert "floored" not in out and "inert" not in out
            assert "fast@mesh" not in out
            assert "(model=cli bucket=256 tier=fast path=gemm)" in out
            assert "warmed 9 batch bucket(s) for 'cli'" in out
        finally:
            app.close(drain=False)
            nn_log.set_verbosity(0)


def test_serve_app_warmup_covers_the_mesh_buckets(tmp_path):
    from hpnn_tpu_torch.serve.server import ServeApp

    conf, _ = _write_conf(tmp_path, name="wu")
    app = ServeApp(max_batch=256, parity="fast", fast_threshold=64,
                   device="cpu")
    try:
        app.registry.mesh = DataMesh(["cpu"] * 8)
        model = app.add_model(conf, warmup=True)
        tiers = {k[3]: k[5] for k in app.registry._cache}
        assert tiers == {b: app.registry.tier_for(b)
                         for b in app.registry.buckets()}
        assert [tiers[b] for b in (64, 128, 256)] == ["fast@mesh8"] * 3
        assert model.mesh_weights(app.registry.mesh)[1] == 1
    finally:
        app.close(drain=False)


# --- fused_bpm_update at bfloat16 ----------------------------------------------

@pytest.mark.parametrize("lr,alpha", [(0.0005, 0.2), (0.1, 0.9),
                                      (0.37, 0.5)])
@pytest.mark.parametrize("n,m", [(300, 784), (10, 300), (230, 851),
                                 (230, 230), (7, 13)])
def test_fused_bpm_update_bf16_plain_matches_pallas(n, m, lr, alpha):
    """The plain version at bfloat16 against the Pallas kernel in
    interpret mode: 0 ULPs of bfloat16 (bit-identical).  Interpret mode
    rounds every operation of the body to bfloat16 (measured: a version
    keeping float32 intermediates differs in ~2% of W' and ~30% of dw'),
    and so do the plain version's bfloat16 operations, lr and alpha
    rounded to bfloat16 first as JAX's weak-typed scalars are."""
    import jax.numpy as jnp

    from hpnn_tpu.ops.pallas_kernels import fused_bpm_update as jax_bpm
    from hpnn_tpu_torch.ops.kernels import fused_bpm_update

    rng = np.random.default_rng(5 * n + m)
    arrays = (rng.uniform(-1, 1, (n, m)) / np.sqrt(m),
              rng.uniform(-0.01, 0.01, (n, m)), rng.uniform(-1, 1, n),
              rng.uniform(-1, 1, m))
    jw, jdw = jax_bpm(*(jnp.asarray(a, jnp.bfloat16) for a in arrays),
                      lr, alpha)
    ins = tuple(torch.as_tensor(a).to(torch.bfloat16) for a in arrays)
    before = tuple(v.clone() for v in ins)
    pw, pdw = fused_bpm_update(*ins, lr, alpha)
    assert pw.dtype == pdw.dtype == torch.bfloat16
    for got, want in ((pw, jw), (pdw, jdw)):
        np.testing.assert_array_equal(
            got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    assert all(torch.equal(a, b) for a, b in zip(ins, before))
    assert fused_bpm_update.launches == 0       # the CPU launches nothing
