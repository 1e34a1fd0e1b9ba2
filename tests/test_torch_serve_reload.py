"""The port's serving generations -- hot reload, the checkpoint-manifest
watcher, ``POST /v1/kernels/<name>/reload`` with its auth token, A/B
pinning, promote and rollback -- held against the JAX package on the CPU.

Every case runs the same seeded kernels and inputs and the same sequence
of operations through ``hpnn_tpu.serve`` and ``hpnn_tpu_torch.serve``
(``device="cpu"``, a 16-8-4 float64 kernel) and compares the outcomes:
generation labels, statuses and metric counts are equal; every answer
equals the port's strict rows of the weights its generation names bit for
bit, and the JAX rows within 1e-13.  The A/B fraction is compared exactly
at 0 and 1 and within a 5-sigma binomial bound at 0.25."""

import json
import math
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax.numpy as jnp

N_IN, N_HID, N_OUT = 16, 8, 4
PKGS = ("jax", "port")
X = np.linspace(-1, 1, N_IN).reshape(1, N_IN)


def _mods(pkg):
    if pkg == "jax":
        from hpnn_tpu import ckpt
        from hpnn_tpu.serve import server
    else:
        from hpnn_tpu_torch import ckpt
        from hpnn_tpu_torch.serve import server
    return ckpt, server


def _app(pkg, **kw):
    if pkg == "port":
        kw.setdefault("device", "cpu")
    return _mods(pkg)[1].ServeApp(**kw)


def _kernel(seed, hidden=N_HID):
    from hpnn_tpu_torch.models.kernel import generate_kernel

    return generate_kernel(seed, N_IN, [hidden], N_OUT)[0]


def _dump(kern, path):
    """Write a kernel file; returns the weights as both packages load
    them back (the text format quantizes at %17.15f)."""
    from hpnn_tpu_torch.io.kernel_io import dump_kernel_to_path, load_kernel

    dump_kernel_to_path(kern, str(path))
    return load_kernel(str(path)).weights


def _setup(tmp_path, name="hot", seed=11):
    tmp_path.mkdir(parents=True, exist_ok=True)
    kpath = tmp_path / "kernel.opt"
    w1 = _dump(_kernel(seed), kpath)
    conf = tmp_path / f"{name}.conf"
    conf.write_text(
        f"[name] {name}\n[type] ANN\n[init] {kpath}\n[seed] 1\n"
        f"[input] {N_IN}\n[hidden] {N_HID}\n[output] {N_OUT}\n"
        f"[train] BP\n")
    return str(conf), str(kpath), w1


def _strict(weights, xs):
    """(port strict rows, JAX strict rows) of ``weights`` on ``xs``."""
    from hpnn_tpu import ops as jax_ops
    from hpnn_tpu_torch import ops

    port = ops.run_batch(tuple(torch.as_tensor(w) for w in weights),
                         torch.as_tensor(xs), "ANN").numpy()
    ref = np.asarray(jax_ops.run_batch(
        tuple(jnp.asarray(w) for w in weights), jnp.asarray(xs), "ANN"))
    return port, ref


def _held(pkg, got, weights, xs):
    """The port's answer equals its strict rows bit for bit; both
    packages' answers equal the JAX rows within 1e-13."""
    port, ref = _strict(weights, xs)
    if pkg == "port":
        assert np.array_equal(got, port)
    np.testing.assert_allclose(got, ref, atol=1e-13, rtol=0)


def _infer(app, name, xs, headers=None):
    body = app.handle_infer(name, json.dumps(
        {"inputs": np.asarray(xs).tolist()}).encode(),
        headers=headers or {})
    return body["generation"], np.asarray(body["outputs"])


# --- hot reload --------------------------------------------------------------

def _swap_run(pkg, tmp_path):
    conf, kpath, w1 = _setup(tmp_path / pkg)
    app = _app(pkg, max_batch=8)
    model = app.add_model(conf, warmup=True)
    gen0 = model.generation
    out1 = app.infer("hot", X)
    misses = app.registry.cache_stats()["misses"]
    w2 = _dump(_kernel(22), kpath)  # a retrain, same topology
    res = app.reload_model("hot")
    out2 = app.infer("hot", X)
    snap = app.metrics.snapshot()
    prom = app.metrics.render_prometheus()
    app.close()
    _held(pkg, out1, w1, X)
    _held(pkg, out2, w2, X)
    return (gen0, res["generation"], res["topology_changed"],
            res["retained_generations"],
            app.registry.cache_stats()["misses"] - misses,
            snap["models"]["hot"]["generation"], snap["reloads"],
            'hpnn_serve_model_generation{kernel="hot"} 2' in prom,
            "hpnn_serve_model_last_reload_timestamp_seconds" in prom)


def test_hot_reload_swaps_without_recompile_matches_jax(tmp_path):
    """A same-topology reload bumps the generation, serves the new
    weights and reuses every cached bucket (no new miss)."""
    port = _swap_run("port", tmp_path)
    assert port == _swap_run("jax", tmp_path)
    assert port == (1, 2, False, [], 0, 2, {"ok": 1, "error": 0}, True,
                    True)


def _traffic_run(pkg, tmp_path):
    """Four threads hammer unpinned requests while three reloads swap
    two kernels back and forth; every answer must carry a generation
    whose weights produced it."""
    conf, kpath, w1 = _setup(tmp_path / pkg)
    kernels = {1: w1}
    app = _app(pkg, max_batch=8)
    app.add_model(conf, warmup=True)
    stop = threading.Event()
    answers, errors = [], []

    def hammer(seed):
        rng = np.random.default_rng(seed)
        while not stop.is_set():
            xs = rng.uniform(-1, 1, (1 + int(rng.integers(3)), N_IN))
            try:
                answers.append((xs,) + _infer(app, "hot", xs))
            except Exception as exc:  # re-raised below
                errors.append(exc)

    threads = [threading.Thread(target=hammer, args=(s,)) for s in range(4)]
    for t in threads:
        t.start()
    try:
        time.sleep(0.1)
        for i, seed in enumerate((22, 33, 44)):
            w = _dump(_kernel(seed), kpath)
            res = app.reload_model("hot")
            kernels[res["generation"]] = w
            time.sleep(0.05)
    finally:
        stop.set()
        for t in threads:
            t.join()
    gen = app.metrics.snapshot()["models"]["hot"]["generation"]
    counted = sum(app.metrics.generation_requests("hot").values())
    app.close()
    assert not errors, errors[0]
    for xs, g, outs in answers:
        if pkg == "port":
            _held(pkg, outs, kernels[g], xs)
        else:
            # the JAX package reads the label after the launch, so under
            # a racing swap its label may name a neighbour of the weights
            # that ran; hold its rows to some served generation
            assert any(np.allclose(outs, _strict(w, xs)[1], atol=1e-13,
                                   rtol=0) for w in kernels.values())
    return gen, counted == len(answers), len(answers) > 0, \
        sorted(kernels)


def test_hot_reload_under_traffic_drops_nothing_matches_jax(tmp_path):
    port = _traffic_run("port", tmp_path)
    assert port == _traffic_run("jax", tmp_path)
    assert port == (4, True, True, [1, 2, 3, 4])


def _failure_run(pkg, tmp_path):
    conf, kpath, w1 = _setup(tmp_path / pkg)
    app = _app(pkg, max_batch=8)
    app.add_model(conf, warmup=False)
    out1 = app.infer("hot", X)
    raised = []
    for name, path in (("hot", str(tmp_path / "missing.opt")),
                       ("nope", None)):
        try:
            app.reload_model(name, path)
            raised.append(None)
        except (ValueError, KeyError) as exc:
            raised.append(type(exc).__name__)
    out2 = app.infer("hot", X)
    snap = app.metrics.snapshot()
    app.close()
    return raised, np.array_equal(out1, out2), snap["reloads"], \
        snap["models"]["hot"]["generation"]


def test_reload_failure_keeps_serving_old_weights_matches_jax(tmp_path):
    port = _failure_run("port", tmp_path)
    assert port == _failure_run("jax", tmp_path)
    assert port == (["ValueError", "KeyError"], True,
                    {"ok": 0, "error": 2}, 1)


def test_port_upload_failure_is_a_reported_error(tmp_path, monkeypatch):
    """An upload that fails on the device is a ValueError (HTTP 409) and
    a counted reload error; the old weights keep answering."""
    from hpnn_tpu_torch.serve import registry

    conf, kpath, w1 = _setup(tmp_path)
    app = _app("port", max_batch=8)
    app.add_model(conf, warmup=False)
    out1 = app.infer("hot", X)
    _dump(_kernel(22), kpath)

    def broken(*a, **k):
        raise RuntimeError("CUDA error: out of memory")

    monkeypatch.setattr(registry.MLP, "from_kernel", broken)
    with pytest.raises(ValueError, match="failed to upload"):
        app.reload_model("hot")
    monkeypatch.undo()
    assert np.array_equal(app.infer("hot", X), out1)
    snap = app.metrics.snapshot()
    assert snap["reloads"] == {"ok": 0, "error": 1}
    assert snap["models"]["hot"]["generation"] == 1
    app.close()


def _topology_run(pkg, tmp_path):
    conf, kpath, _ = _setup(tmp_path / pkg)
    app = _app(pkg, max_batch=4)
    model = app.add_model(conf, warmup=True)
    app.infer("hot", X)
    w2 = _dump(_kernel(22, hidden=N_HID + 2), kpath)
    res = app.reload_model("hot")
    keys = [k[1] for k in app.registry._cache if k[0] == "hot"]
    out = app.infer("hot", X)
    app.close()
    _held(pkg, out, w2, X)
    return (res["topology_changed"], res["topology"], model.topology,
            all(k == model.topology for k in keys), out.shape)


def test_topology_change_reload_purges_and_reshapes_matches_jax(tmp_path):
    port = _topology_run("port", tmp_path)
    assert port == _topology_run("jax", tmp_path)
    assert port[0] is True and port[2] == (N_IN, N_HID + 2, N_OUT)


def _watch_run(pkg, tmp_path, preexisting):
    ckpt, _ = _mods(pkg)
    conf, kpath, w1 = _setup(tmp_path / pkg)
    k2 = _kernel(22)
    ck = str(tmp_path / pkg / "ck")

    def publish(epoch):
        entry = ckpt.write_snapshot(ck, epoch, weights=k2.weights,
                                    momentum=None, rng_state=None,
                                    seed=1, errors=[0.1])
        ckpt.publish_snapshot(ck, entry, seed=1, errors=[0.1])

    if preexisting:
        publish(5)  # training finished before the server came up
    app = _app(pkg, max_batch=8)
    app.add_model(conf, warmup=False)
    out1 = app.infer("hot", X)
    app.watch_manifest("hot", ck, interval_s=0.05)
    if not preexisting:
        publish(1)
    end = time.time() + 5.0
    while time.time() < end and app.registry.get("hot").generation < 2:
        time.sleep(0.02)
    gen = app.registry.get("hot").generation
    out2 = app.infer("hot", X)
    app.close()  # stops the watcher loop
    from hpnn_tpu_torch.io.kernel_io import load_kernel

    w2 = load_kernel(f"{ck}/{ckpt.read_manifest(ck)['kernel']}").weights
    _held(pkg, out1, w1, X)
    _held(pkg, out2, w2, X)
    return gen, np.array_equal(out1, out2)


@pytest.mark.parametrize("preexisting", [False, True],
                         ids=["bump", "preexisting"])
def test_manifest_watcher_matches_jax(tmp_path, preexisting):
    """The --watch-ckpt watcher reloads on a manifest generation bump,
    and loads a manifest that existed before the watch began on its
    first poll (the baseline generation is 0)."""
    port = _watch_run("port", tmp_path, preexisting)
    assert port == _watch_run("jax", tmp_path, preexisting)
    assert port == (2, False)


def test_port_watch_failure_does_not_consume_generation(tmp_path):
    """A poll whose reload fails leaves the manifest generation
    unconsumed, so the next poll retries it."""
    from hpnn_tpu_torch import ckpt

    conf, _, _ = _setup(tmp_path)
    ck = str(tmp_path / "ck")
    entry = ckpt.write_snapshot(ck, 1, weights=_kernel(22).weights,
                                momentum=None, rng_state=None, seed=1,
                                errors=[0.1])
    ckpt.publish_snapshot(ck, entry, seed=1, errors=[0.1])
    app = _app("port", max_batch=8)
    app.add_model(conf, warmup=False)
    kfile = f"{ck}/{ckpt.read_manifest(ck)['kernel']}"
    good = open(kfile, "rb").read()
    with open(kfile, "w") as fp:
        fp.write("not a kernel\n")
    state = {"gen": 0}
    assert app.poll_ckpt_reload("hot", ck, state) is None
    assert state == {"gen": 0}
    with open(kfile, "wb") as fp:
        fp.write(good)
    res = app.poll_ckpt_reload("hot", ck, state)
    assert res["generation"] == 2 and state == {"gen": 1}
    assert app.poll_ckpt_reload("hot", ck, state) is None  # consumed
    assert app.metrics.snapshot()["reloads"] == {"ok": 1, "error": 1}
    app.close()


# --- the reload endpoint ----------------------------------------------------

def _post(base, path, payload=None, headers=None, raw=None):
    data = raw if raw is not None else (
        b"" if payload is None else json.dumps(payload).encode())
    req = urllib.request.Request(base + path, data=data,
                                 headers=headers or {}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _endpoint_run(pkg, tmp_path):
    _, server = _mods(pkg)
    conf, kpath, w1 = _setup(tmp_path / pkg)
    app = _app(pkg, max_batch=8, auth_token="s3cret")
    app.add_model(conf, warmup=False)
    if pkg == "jax":
        httpd, _ = server.serve_in_thread("127.0.0.1", 0, app)
    else:
        httpd, _ = server.serve_in_thread(app, "127.0.0.1", 0)
    base = "http://127.0.0.1:%d" % httpd.server_address[1]
    url = "/v1/kernels/hot/reload"
    w2 = _dump(_kernel(22), tmp_path / pkg / "k2.opt")
    bearer = {"Authorization": "Bearer s3cret"}
    got = []
    try:
        for payload, headers, raw in (
                (None, {}, None),                             # no token
                (None, {"Authorization": "Bearer wrong"}, None),
                (None, {"X-HPNN-Token": "s3crét"}, None),
                (None, bearer, None),                         # bare: 200
                ({"kernel": str(tmp_path / pkg / "k2.opt")},
                 {"X-HPNN-Token": "s3cret"}, None),
                ({"kernel": str(tmp_path / "missing.opt")}, bearer, None),
                (None, bearer, b"{not json"),
                ([1, 2], bearer, None),
                ({"kernel": 5}, bearer, None),
                ({"set_generation": "x"}, bearer, None),
                ({"blob": {"sha256": "ab" * 32}}, bearer, None),
                ({"blob": "x"}, bearer, None),
                ({"kernel": str(tmp_path / pkg / "k2.opt"),
                  "set_generation": 10}, bearer, None)):
            st, body, hdrs = _post(base, url, payload, headers, raw)
            got.append((st, body.get("reason", body.get("generation")),
                        hdrs.get("WWW-Authenticate")))
        st, body, _ = _post(base, "/v1/kernels/nope/reload", None, bearer)
        got.append((st, body.get("reason"), None))
        st, body, _ = _post(base, "/v1/kernels/hot/infer",
                            {"inputs": X.tolist()})
        snap = app.metrics.snapshot()
    finally:
        httpd.shutdown()
        httpd.server_close()
        app.close()
    _held(pkg, np.asarray(body["outputs"]), w2, X)
    return got, (st, body["generation"]), snap["reloads"], \
        snap["models"]["hot"]["generation"]


def test_reload_endpoint_statuses_match_jax(tmp_path):
    """401 without (or with a wrong, or a non-ASCII) token, 200 with a
    Bearer or X-HPNN-Token header, 409 for a bad path and a blob body,
    400 for malformed bodies, 404 for an unknown kernel; set_generation
    pins the generation.  Statuses, reasons and counters equal."""
    port = _endpoint_run("port", tmp_path)
    assert port == _endpoint_run("jax", tmp_path)
    got = port[0]
    assert [g[0] for g in got] == [401, 401, 401, 200, 200, 409, 400, 400,
                                   400, 400, 409, 400, 200, 404]
    assert got[0][2] == "Bearer"
    assert got[5][1] == "reload_failed" and got[10][1] == "reload_failed"
    assert port[1] == (200, 10)
    assert port[2] == {"ok": 3, "error": 2}


# --- A/B generation pinning --------------------------------------------------

def _ab_run(pkg, tmp_path):
    _, server = _mods(pkg)
    conf, kpath, w1 = _setup(tmp_path / pkg, name="ab")
    app = _app(pkg, max_batch=8, ab_fraction=1.0)
    model = app.add_model(conf, warmup=False)
    # served once first: the JAX package uploads weights at the first
    # dispatch and retains nothing from a swap before it
    app.infer("ab", X)
    w2 = _dump(_kernel(4321), kpath)
    res = app.reload_model("ab")
    out = [res["generation"], res["retained_generations"], res["ab_window"]]
    # fraction 1: all unpinned traffic stays on the previous generation
    g, o = _infer(app, "ab", X)
    _held(pkg, o, w1, X)
    out.append(g)
    # an explicit pin beats the window, both ways
    for pin, w in (("2", w2), ("1", w1)):
        g, o = _infer(app, "ab", X, {"X-HPNN-Generation": pin})
        _held(pkg, o, w, X)
        out.append(g)
    try:
        _infer(app, "ab", X, {"X-HPNN-Generation": "9"})
    except server._HTTPError as exc:
        out.append((exc.status, exc.outcome))
    out.append(app.metrics.snapshot()["generations"]["ab"])
    model.promote()
    g, o = _infer(app, "ab", X)
    _held(pkg, o, w2, X)
    out.append(g)
    out.append(model.generation_table())
    res = model.rollback(1)
    out += [res["generation"], res["rolled_back_to"], res["ab_window"]]
    g, o = _infer(app, "ab", X)
    _held(pkg, o, w1, X)
    out += [g, model.generation_table()]
    app.close()
    return out


def test_ab_pinning_promote_rollback_matches_jax(tmp_path):
    port = _ab_run("port", tmp_path)
    assert port == _ab_run("jax", tmp_path)
    assert port[:4] == [2, [1], {"prev": 1, "fraction": 1.0}, 1]
    assert port[4:7] == [2, 1, (404, "unknown_generation")]
    assert port[7] == {"1": 2, "2": 1}
    assert port[8] == 2 and port[10:13] == [3, 1, None] and port[13] == 3


def _retention_run(pkg, tmp_path, fraction, retain=None):
    conf, kpath, w1 = _setup(tmp_path / pkg / str(fraction), name="rt")
    app = _app(pkg, max_batch=4, ab_fraction=fraction)
    if retain is not None:
        # what the JAX package's jobs subsystem turns on at fraction 0
        app.registry.retain_generations = retain
    model = app.add_model(conf, warmup=False)
    app.infer("rt", X)  # see _ab_run
    tables = []
    for seed in (5, 6, 7):
        _dump(_kernel(seed), kpath)
        res = app.reload_model("rt")
        tables.append((res["generation"], res["retained_generations"],
                       res["ab_window"]))
    out = [tables, model.generation_table()]
    if retain:
        res = model.rollback()  # no window: the newest retained one
        out.append((res["rolled_back_to"], res["generation"]))
    _dump(_kernel(8, hidden=N_HID + 2), kpath)
    res = app.reload_model("rt", kpath)  # a rollback's source is no file
    out.append((res["topology_changed"], model.generation_table()))
    app.close()
    return out


@pytest.mark.parametrize("fraction,retain", [(0.0, None), (0.5, None),
                                             (0.0, True)],
                         ids=["plain", "ab", "retained-no-window"])
def test_generation_retention_matches_jax(tmp_path, fraction, retain):
    """gen_keep=2 retained generations under an A/B fraction, none on a
    plain server, rollback to the newest retained one without a window,
    and a topology change clearing every pin."""
    port = _retention_run("port", tmp_path, fraction, retain)
    assert port == _retention_run("jax", tmp_path, fraction, retain)
    assert port[-1][1] == {"current": port[-1][1]["current"],
                           "retained": [], "ab_window": None}
    if fraction == 0.5:
        assert port[1]["retained"] == [2, 3]
    if fraction == 0.0 and retain is None:
        assert port[1]["retained"] == []


def test_ab_fraction_draws(tmp_path):
    """Unpinned traffic during a swap window: exactly none at fraction 0,
    exactly all at 1, and within 5 sigma of the binomial mean at 0.25, in
    both packages (the port draws from the registry's own seeded
    generator)."""
    n = 4000
    for pkg in PKGS:
        for fraction in (0.0, 1.0, 0.25):
            conf, kpath, _ = _setup(tmp_path / pkg / str(fraction),
                                    name="fr")
            app = _app(pkg, max_batch=4, ab_fraction=fraction)
            model = app.add_model(conf, warmup=False)
            app.infer("fr", X)  # see _ab_run
            _dump(_kernel(9), kpath)
            app.reload_model("fr")
            prev = sum(model.resolve_generation() == 1 for _ in range(n))
            app.close()
            if fraction in (0.0, 1.0):
                assert prev == n * fraction, (pkg, fraction)
            else:
                sigma = math.sqrt(n * fraction * (1 - fraction))
                assert abs(prev - n * fraction) <= 5 * sigma, (pkg, prev)


def test_port_ab_draw_uses_the_registry_generator(tmp_path):
    """Two registries whose generators share a seed draw the same A/B
    sequence, whatever the module-level random does in between."""
    import random

    seqs = []
    for i in range(2):
        conf, kpath, _ = _setup(tmp_path / str(i), name="sd")
        app = _app("port", max_batch=4, ab_fraction=0.25)
        app.registry.rng = random.Random(123)
        model = app.add_model(conf, warmup=False)
        app.infer("sd", X)
        _dump(_kernel(9), kpath)
        app.reload_model("sd")
        random.seed(i)
        seqs.append([model.resolve_generation() for _ in range(64)])
        app.close()
    assert seqs[0] == seqs[1] and 1 in seqs[0] and None in seqs[0]


# --- the CLI -----------------------------------------------------------------

def test_serve_nn_new_options(tmp_path, capsys, monkeypatch):
    """--watch-ckpt / --watch-interval / --ab-fraction / --auth-token /
    HPNN_SERVE_TOKEN / --no-warmup, and the tracing options (--trace,
    --trace-sample in [0, 1], --span-dir, --profile-dir), are taken with
    the JAX package's stderr lines and exit codes; so are the mesh,
    standby, autoscale, shedding, quota and SLO options; --compile-cache
    is refused for good."""
    from hpnn_tpu_torch.cli import serve_app, serve_nn_main

    conf, _, _ = _setup(tmp_path)
    conf2, _, _ = _setup(tmp_path / "two", name="two")
    ck = str(tmp_path / "ck")
    app, args = serve_app(["-p", "0", "--device", "cpu", "--no-warmup",
                           "--watch-ckpt", f"hot={ck}", "--watch-interval",
                           "0.5", "--ab-fraction", "0.25", "--auth-token",
                           "T", conf])
    assert app is not None
    assert app.auth_token == "T" and app.registry.ab_fraction == 0.25
    assert app.warming() == [] and len(app._watchers) == 1
    assert app.metrics.snapshot()["compile_cache"]["misses"] == 0
    app.close()
    monkeypatch.setenv("HPNN_SERVE_TOKEN", "envtok")
    app, _ = serve_app(["-p", "0", "--device", "cpu", "--no-warmup",
                        "--watch-ckpt", ck, conf])
    assert app.auth_token == "envtok" and len(app._watchers) == 1
    app.close()
    capsys.readouterr()
    for argv, msg in (
            (["--ab-fraction", "1.5"], "--ab-fraction must be in [0, 1]"),
            (["--watch-ckpt", "nope=" + ck], "unknown kernel 'nope'"),
            (["--watch-ckpt", ck, conf2], "NAME= is required")):
        # serve_app: what serve_nn_main runs before it binds (a case that
        # wrongly passed would serve forever under serve_nn_main)
        app, rc = serve_app(["-p", "0", "--device", "cpu", "--no-warmup",
                             *argv, conf])
        assert app is None and rc == -1
        assert msg in capsys.readouterr().err
    from hpnn_tpu_torch.obs import trace as obs_trace

    app, _ = serve_app(["--trace", "--trace-sample", "0.5", "--span-dir",
                        str(tmp_path / "spans"), "--profile-dir",
                        str(tmp_path / "prof"), "--device", "cpu",
                        "--no-warmup", conf])
    try:
        assert app is not None and obs_trace.enabled()
        assert obs_trace.sample_stats()["rate"] == 0.5
        assert app.profile_dir == str(tmp_path / "prof")
        assert app.span_exporter.span_dir == str(tmp_path / "spans")
    finally:
        app.close(drain=False)
        obs_trace.disable()
        obs_trace.set_sample_rate(None)
    assert serve_app(["--trace-sample", "1.5", "--device", "cpu",
                      conf]) == (None, -1)
    assert "--trace-sample must be in [0, 1]: 1.5 (ABORTING)" in \
        capsys.readouterr().err
    # the standby router's and the autoscaler's options are taken, with
    # the JAX package's checks
    for opt in ("--standby", "--primary", "--takeover-after",
                "--autoscale-cooldown"):
        app, args = serve_app([opt, "1", "--device", "cpu", conf])
        assert app is not None and args.mesh_role is None
        app.close(drain=False)
    assert serve_app(["--autoscale", "1", "--device", "cpu",
                      conf]) == (None, -1)
    assert "--autoscale requires --mesh-role router (ABORTING)" in \
        capsys.readouterr().err
    assert serve_app(["--mesh-role", "standby", "--device", "cpu",
                      conf]) == (None, -1)
    assert "--mesh-role standby requires --primary HOST:PORT (ABORTING)" \
        in capsys.readouterr().err
    # the JAX data-mesh tier has a refusal of its own, never an
    # ambiguous abbreviation of --mesh-role/--mesh-health-interval
    assert serve_app(["--mesh", "1", "--device", "cpu", conf]) == (None, 2)
    err = capsys.readouterr().err
    assert err.startswith("serve_nn: --mesh shards") and "ambig" not in err
    # admission, the mesh roles and a mesh router as the replica
    # destination are ported
    app, args = serve_app(["--shed-low", "--quota-rows", "5",
                           "--quota-burst", "9", "--slo-p99-ms", "50",
                           "--slo-availability", "0.99", "--replicate-to",
                           "http://h:1", "--device", "cpu", conf])
    try:
        assert app.quota.rate == 5.0 and app.quota.burst == 9.0
        assert app.slo.p99_ms == 50.0 and app.slo.availability == 0.99
        assert app.shedder is not None and args.replicate_to == "http://h:1"
    finally:
        app.close(drain=False)
    assert serve_nn_main(["--compile-cache", "d", "--device", "cpu",
                          conf]) != 0
    err = capsys.readouterr().err
    assert "--compile-cache" in err and "not ported yet" not in err


def test_serve_nn_subprocess_imports_no_jax(tmp_path):
    """A fresh interpreter builds serve_nn with --watch-ckpt, --ab-fraction
    and --auth-token on the CPU, answers pinned and prioritised requests,
    hot-reloads from a published checkpoint and through the endpoint, and
    proves that neither jax nor any hpnn_tpu module was imported."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    conf, kpath, _ = _setup(tmp_path)
    k2 = tmp_path / "k2.opt"
    _dump(_kernel(22), k2)
    ck = str(tmp_path / "ck")
    code = f"""
import json, sys, time, urllib.request
import numpy as np
from hpnn_tpu_torch import ckpt
from hpnn_tpu_torch.cli import serve_app
from hpnn_tpu_torch.io.kernel_io import load_kernel
from hpnn_tpu_torch.serve.server import serve_in_thread

app, args = serve_app(['-p', '0', '--device', 'cpu', '--no-warmup',
                       '--watch-ckpt', 'hot={ck}', '--watch-interval', '0.05',
                       '--ab-fraction', '0.25', '--auth-token', 'T',
                       {conf!r}])
httpd, th = serve_in_thread(app)
base = 'http://127.0.0.1:%d' % httpd.server_address[1]

def post(path, payload, headers):
    req = urllib.request.Request(base + path, json.dumps(payload).encode(),
                                 headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())

x = [[0.5] * {N_IN}]
assert post('/v1/kernels/hot/infer', {{'inputs': x}},
            {{'X-HPNN-Priority': 'high'}})[0] == 200
entry = ckpt.write_snapshot({ck!r}, 1,
                            weights=load_kernel({str(k2)!r}).weights,
                            momentum=None, rng_state=None, seed=1,
                            errors=[0.1])
ckpt.publish_snapshot({ck!r}, entry, seed=1, errors=[0.1])
end = time.time() + 10
while app.registry.get('hot').generation < 2 and time.time() < end:
    time.sleep(0.02)
st, body = post('/v1/kernels/hot/infer', {{'inputs': x}},
                {{'X-HPNN-Generation': '1'}})
assert st == 200 and body['generation'] == 1, (st, body)
assert post('/v1/kernels/hot/reload', {{}}, {{}})[0] == 401
st, body = post('/v1/kernels/hot/reload', {{'kernel': {kpath!r}}},
                {{'Authorization': 'Bearer T'}})
assert st == 200 and body['generation'] == 3, body
httpd.shutdown(); httpd.server_close(); app.close()
bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')
             or m == 'hpnn_tpu' or m.startswith('hpnn_tpu.'))
assert not bad, bad
print('NOJAX-OK')
"""
    env = dict(os.environ, PYTHONPATH=repo)
    res = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert "NOJAX-OK" in res.stdout
