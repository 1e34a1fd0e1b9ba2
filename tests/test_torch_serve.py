"""The port's serve path on the CPU: a live in-process HTTP server on an
ephemeral port, answers held bit for bit against the port's own strict
batch path and to 1e-13 against the JAX package's ``run_batch``."""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax.numpy as jnp

N_IN, N_HID, N_OUT = 8, 6, 3


def _write_conf(tmp_path, name="tiny", kind="ANN", dtype="f64"):
    """Dump a kernel and a run_nn-style conf that loads it; returns the
    conf path and the RELOADED weights (the %17.15f text round trip
    quantizes, and both sides serve what they load)."""
    from hpnn_tpu_torch.io.kernel_io import dump_kernel_to_path, load_kernel
    from hpnn_tpu_torch.models.kernel import generate_kernel

    kern, _ = generate_kernel(1234, N_IN, [N_HID], N_OUT)
    kpath = str(tmp_path / f"{name}.opt")
    dump_kernel_to_path(kern, kpath)
    conf = tmp_path / f"{name}.conf"
    conf.write_text(f"[name] {name}\n[type] {kind}\n[init] {kpath}\n"
                    f"[seed] 1\n[train] BP\n[dtype] {dtype}\n")
    return str(conf), load_kernel(kpath).weights


def _post(url, payload, timeout=30):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type":
                                          "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


@pytest.fixture
def server(tmp_path):
    from hpnn_tpu_torch.cli import serve_app
    from hpnn_tpu_torch.serve.server import serve_in_thread

    conf, weights = _write_conf(tmp_path)
    app, _ = serve_app(["-p", "0", "-b", "8", "--device", "cpu",
                        "--warmup-mode", "sync", conf])
    assert app is not None
    httpd, th = serve_in_thread(app, "127.0.0.1", 0)
    host, port = httpd.server_address[:2]
    yield app, f"http://{host}:{port}", weights
    httpd.shutdown()
    httpd.server_close()
    app.close()
    th.join(timeout=10)
    assert not th.is_alive()


def test_healthz_and_metrics(server):
    app, url, _ = server
    with urllib.request.urlopen(url + "/healthz", timeout=10) as r:
        body = json.loads(r.read())
        assert r.status == 200
    assert body["status"] == "ok" and body["kernels"] == ["tiny"]
    with urllib.request.urlopen(url + "/metrics?format=json",
                                timeout=10) as r:
        snap = json.loads(r.read())
    assert "fused_linear_act" in snap["kernel_launches"]
    # warmup ran every bucket of -b 8 once: 1, 2, 4, 8
    assert snap["compile_cache"]["misses"] == 4
    with urllib.request.urlopen(url + "/metrics", timeout=10) as r:
        assert b"hpnn_kernel_launches_total" in r.read()


def test_infer_bit_identical_to_strict_batch_and_close_to_jax(server):
    """1-, 3- and 5-row requests answer exactly the port's run_batch rows
    for the same inputs (the strict contract), and the JAX package's
    run_batch to 1e-13."""
    from hpnn_tpu import ops as jax_ops
    from hpnn_tpu_torch import ops

    app, url, weights = server
    rng = np.random.default_rng(5)
    xs = rng.uniform(0, 255.0, (9, N_IN))
    wt = tuple(torch.as_tensor(w) for w in weights)
    want = ops.run_batch(wt, torch.as_tensor(xs), "ANN").numpy()
    jax_want = np.asarray(jax_ops.run_batch(
        tuple(jnp.asarray(w) for w in weights), jnp.asarray(xs), "ANN"))
    at = 0
    for rows in (1, 3, 5):
        status, body, _ = _post(url + "/v1/kernels/tiny/infer",
                                {"inputs": xs[at:at + rows].tolist()})
        assert status == 200, body
        got = np.asarray(body["outputs"], np.float64)
        assert np.array_equal(got, want[at:at + rows])
        np.testing.assert_allclose(got, jax_want[at:at + rows], atol=1e-13,
                                   rtol=0)
        assert body["argmax"] == [int(i) for i in np.argmax(got, axis=1)]
        assert body["kernel"] == "tiny" and body["generation"] == 1
        at += rows


def test_concurrent_requests_all_answer(server):
    app, url, weights = server
    rng = np.random.default_rng(6)
    xs = rng.uniform(-1, 1, (16, N_IN))
    results = [None] * 16

    def one(i):
        results[i] = _post(url + "/v1/kernels/tiny/infer",
                           {"input": xs[i].tolist()})

    threads = [threading.Thread(target=one, args=(i,)) for i in range(16)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
        assert not th.is_alive()
    from hpnn_tpu_torch import ops

    want = ops.run_batch(tuple(torch.as_tensor(w) for w in weights),
                         torch.as_tensor(xs), "ANN").numpy()
    for i, (status, body, _) in enumerate(results):
        assert status == 200
        assert np.array_equal(np.asarray(body["outputs"][0]), want[i])


def test_queue_full_is_429(tmp_path):
    """A paused batcher fills its queue; the next request is rejected at
    once with 429 + Retry-After while the admitted ones still answer."""
    from hpnn_tpu_torch.serve.server import ServeApp, serve_in_thread

    conf, _ = _write_conf(tmp_path)
    app = ServeApp(max_batch=4, max_queue_rows=4, device="cpu")
    assert app.add_model(conf, warmup=False) is not None
    b = app.batchers["tiny"]
    b.pause()
    httpd, th = serve_in_thread(app)
    url = "http://%s:%d/v1/kernels/tiny/infer" % httpd.server_address[:2]
    admitted = []
    fill = threading.Thread(target=lambda: admitted.append(
        _post(url, {"inputs": np.zeros((4, N_IN)).tolist()})))
    fill.start()
    try:
        for _ in range(200):
            if b.depth() == 4:
                break
            threading.Event().wait(0.01)
        assert b.depth() == 4
        status, body, headers = _post(url, {"input": [0.0] * N_IN})
        assert status == 429 and body["reason"] == "queue_full"
        assert "Retry-After" in headers
        b.resume()
        fill.join(timeout=30)
        assert admitted and admitted[0][0] == 200
    finally:
        b.resume()
        httpd.shutdown()
        httpd.server_close()
        app.close()
    snap = json.loads(app.metrics.render_json())
    # every outcome is listed, as in the JAX package; two were counted
    assert {k: v for k, v in snap["requests"].items() if v} == \
        {"ok": 1, "queue_full": 1}


def test_bad_requests(server):
    app, url, _ = server
    status, body, _ = _post(url + "/v1/kernels/nope/infer", {"input": [0]})
    assert status == 404
    status, body, _ = _post(url + "/v1/kernels/tiny/infer",
                            {"inputs": [[0.0] * (N_IN + 1)]})
    assert status == 400
    status, body, _ = _post(url + "/v1/kernels/tiny/infer",
                            {"inputs": np.zeros((9, N_IN)).tolist()})
    assert status == 400 and "rows" in body["error"]


def test_bucket_rows_matches_jax():
    from hpnn_tpu.serve.registry import bucket_rows as jax_bucket
    from hpnn_tpu_torch.serve.registry import bucket_rows

    for cap in (1, 8, 64, 100):
        for rows in range(1, 130):
            assert bucket_rows(rows, cap) == jax_bucket(rows, cap)


def test_serve_unported_flag_and_missing_gpu(tmp_path, capsys):
    from hpnn_tpu_torch.cli import serve_app, serve_nn_main

    conf, _ = _write_conf(tmp_path)
    # --autoscale is a router's: without the role, the JAX package's line
    assert serve_nn_main(["--autoscale", "1:2", "--device", "cpu",
                          conf]) != 0
    assert "--autoscale requires --mesh-role router (ABORTING)" in \
        capsys.readouterr().err
    # --mesh is taken as the JAX package takes it: capped to the devices
    # (one on the CPU), so no data mesh and the plain fast tier
    app, args = serve_app(["--mesh", "4", "--parity", "fast", "-b", "256",
                           "--fast-threshold", "64", "--device", "cpu",
                           "--no-warmup", conf])
    try:
        assert app is not None and args.mesh == 4
        assert app.registry.mesh is None
        assert app.registry.tier_for(256) == "fast"
    finally:
        app.close(drain=False)
    assert "--mesh" not in capsys.readouterr().err
    assert serve_nn_main(["-p", "0", conf]) != 0  # cuda by default
    assert "no GPU is visible" in capsys.readouterr().err


def test_fast_tier_and_f32_rows_are_batch_independent(tmp_path):
    """The registry's fast tier (float64 GEMM chain on the CPU) agrees
    with the strict tier to 1e-13; float32 strict on the CPU is the fused
    path's plain version."""
    from hpnn_tpu_torch.serve.registry import ModelRegistry

    conf, weights = _write_conf(tmp_path, name="fast")
    reg = ModelRegistry(max_batch=8, parity="fast", fast_threshold=4,
                        device="cpu")
    model = reg.register_conf(conf)
    xs = np.random.default_rng(7).uniform(-1, 1, (8, N_IN))
    assert reg.tier_for(2) == "strict" and reg.tier_for(8) == "fast"
    strict = np.concatenate([model.infer(xs[i:i + 1]) for i in range(8)])
    np.testing.assert_allclose(model.infer(xs), strict, atol=1e-13, rtol=0)
    conf32, _ = _write_conf(tmp_path, name="f32", dtype="f32")
    m32 = ModelRegistry(max_batch=8, device="cpu").register_conf(conf32)
    assert m32.mlp.weights[0].dtype == torch.float32
    assert m32.infer(xs).dtype == np.float64


def test_api_defaults_to_cuda_and_refuses_without_a_card(tmp_path):
    """ServeApp, ModelRegistry and select_run_batch run on the GPU unless
    the caller asks for the CPU; with no card visible the registry refuses
    at construction instead of serving on the CPU."""
    from hpnn_tpu_torch import ops
    from hpnn_tpu_torch.runtime import DeviceUnavailable
    from hpnn_tpu_torch.serve.registry import ModelRegistry
    from hpnn_tpu_torch.serve.server import ServeApp

    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the no-card refusal cannot be shown")
    with pytest.raises(DeviceUnavailable):
        ModelRegistry(max_batch=8)
    with pytest.raises(DeviceUnavailable):
        ServeApp(max_batch=8)
    assert ops.select_run_batch(torch.float64)[1] == "fused"
    assert ModelRegistry(max_batch=8, device="cpu").device.type == "cpu"
