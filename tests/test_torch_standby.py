"""The port's standby router (``hpnn_tpu_torch.serve.mesh.standby``) against
the JAX package's, on the CPU.

After ``tests/test_mesh.py``'s standby cases and
``tests/test_train_chaos.py``'s re-pairing hygiene: the passive 503 bodies
of both packages on the same requests, the mirror of a primary's worker
table, generation, blob and spill token, takeover after N transport misses
but never after error replies (the same poll sequence through both
packages' monitors), runtime re-pairing, and an in-process end to end
(primary, standby and one worker, all ``--device cpu``): the primary is
killed, one retry against the standby succeeds, and the reply's bits equal
the strict forward (the port's, within 1e-13 of the JAX package's).  Intervals are short (polls and health
0.2 s, heartbeat 0.3 s).
"""

import json
import socket
import time

import numpy as np
import pytest

from test_torch_mesh import (N_IN, _close, _get, _kill, _mk_router,
                             _mk_worker, _post, _wait_quorum, _write_conf)

from hpnn_tpu_torch.serve.server import ServeApp, serve_in_thread


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _mk_standby(conf, primary_port, takeover_after=2, poll_s=0.2, **kw):
    app = ServeApp(max_batch=16, max_queue_rows=512, device="cpu", **kw)
    app.enable_mesh_standby(f"127.0.0.1:{primary_port}",
                            required_workers=1, health_interval_s=0.2,
                            takeover_after=takeover_after,
                            poll_interval_s=poll_s)
    assert app.add_model(conf) is not None
    httpd, _ = serve_in_thread(app)
    return app, httpd, httpd.server_address[1]


def _jax_standby(conf, primary_port, **kw):
    from hpnn_tpu.serve.server import ServeApp as JaxApp
    from hpnn_tpu.serve.server import serve_in_thread as jax_thread

    app = JaxApp(max_batch=16, max_queue_rows=512, **kw)
    app.enable_mesh_standby(f"127.0.0.1:{primary_port}",
                            required_workers=1, health_interval_s=0.2,
                            takeover_after=1000, poll_interval_s=60.0)
    assert app.add_model(conf) is not None
    httpd, _ = jax_thread("127.0.0.1", 0, app)
    return app, httpd, httpd.server_address[1]


def _wait(cond, timeout_s=15.0, what="condition"):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def test_passive_503_bodies_match_jax(tmp_path):
    """A passive standby answers infer, registration, reload and bundle
    POSTs with 503 ``standby_passive`` and /healthz with 503 ``passive``:
    the same status and body as the JAX package's standby, request for
    request."""
    conf, _ = _write_conf(tmp_path)
    primary = _free_port()      # nothing listens: polls only miss
    papp, phttpd, pport = _mk_standby(conf, primary, takeover_after=1000,
                                      poll_s=60.0)
    japp, jhttpd, jport = _jax_standby(conf, primary)
    try:
        reqs = [("/v1/kernels/tiny/infer",
                 {"inputs": np.zeros((1, N_IN)).tolist()}),
                ("/v1/mesh/register", {"addr": "127.0.0.1:9"}),
                ("/v1/kernels/tiny/reload", {}),
                ("/v1/mesh/bundle?scope=s&tag=t&epoch=1", {"x": 1})]
        for path, body in reqs:
            pst, pbody, _ = _post(f"http://127.0.0.1:{pport}", path, body)
            jst, jbody, _ = _post(f"http://127.0.0.1:{jport}", path, body)
            assert pst == jst == 503, path
            assert json.loads(pbody) == json.loads(jbody), path
            assert json.loads(pbody)["reason"] == "standby_passive"
        pst, ph = _get(f"http://127.0.0.1:{pport}/healthz")
        jst, jh = _get(f"http://127.0.0.1:{jport}/healthz")
        assert pst == jst == 503 and ph["status"] == jh["status"] == "passive"
        for key in ("role", "passive", "primary", "takeover_after",
                    "takeovers_total"):
            assert ph["mesh"][key] == jh["mesh"][key], key
        assert ph["mesh"]["primary"] == f"127.0.0.1:{primary}"
    finally:
        _close((phttpd, papp), (jhttpd, japp))


def test_mirror_of_primary_state(tmp_path):
    """The standby mirrors the primary's worker table, each kernel's
    generation through the sha-checked blob pulled from the primary
    (reloaded at the same generation, the bytes in its own blob store),
    and the spill token, which an auth token guards."""
    import hashlib

    from hpnn_tpu.io.kernel_io import dump_kernel_to_path
    from hpnn_tpu.models.kernel import generate_kernel

    conf, _ = _write_conf(tmp_path)
    papp, phttpd, pport = _mk_router(conf, auth_token="T")
    wapp, whttpd, wport = _mk_worker(conf, auth_token="T")
    wapp.enable_mesh_worker(f"127.0.0.1:{pport}", f"127.0.0.1:{wport}",
                            interval_s=0.3)
    sapp, shttpd, sport = _mk_standby(conf, pport, takeover_after=1000,
                                      auth_token="T")
    try:
        _wait_quorum(pport)
        k2, _ = generate_kernel(7777, N_IN, [6], 3)
        newpath = str(tmp_path / "gen2.opt")
        dump_kernel_to_path(k2, newpath)
        sha = hashlib.sha256(open(newpath, "rb").read()).hexdigest()
        assert papp.reload_model("tiny", newpath)["generation"] == 2
        mon = sapp.mesh_standby
        _wait(lambda: sapp.registry.get("tiny").generation == 2,
              what="the mirrored generation")
        assert mon.passive and mon.mirrors_total >= 1
        assert sapp.mesh_router.blobs.get(sha) == open(newpath, "rb").read()
        assert sapp.mesh_router._blob_meta["tiny"][0] == 2
        assert f"127.0.0.1:{wport}" in sapp.mesh_router.pool.table()
        assert sapp.mesh_router.router_token == papp.mesh_router.router_token
    finally:
        _close((whttpd, wapp), (shttpd, sapp), (phttpd, papp))


def _monitor(pkg, app_cls, conf, primary, **kw):
    app = app_cls(max_batch=8, **kw)
    app.enable_mesh_router(required_workers=1, health_interval_s=3600)
    assert app.add_model(conf) is not None
    mod = __import__(f"{pkg}.serve.mesh.standby", fromlist=["x"])
    return app, mod.StandbyMonitor(app, f"127.0.0.1:{primary}",
                                   takeover_after=3, poll_interval_s=3600)


def test_takeover_after_transport_misses_not_error_replies(tmp_path):
    """The same poll sequence through both packages' monitors: a primary
    that answers errors (401 here: a wrong auth token) never counts a
    miss; 3 polls of a closed port take over on the third, once; an
    active monitor polls no more."""
    from hpnn_tpu.serve.server import ServeApp as JaxApp

    conf, _ = _write_conf(tmp_path)
    papp, phttpd, pport = _mk_router(conf, auth_token="right")
    dead = _free_port()
    mons = {}
    try:
        for pkg, cls, kw in (("hpnn_tpu", JaxApp, {}),
                             ("hpnn_tpu_torch", ServeApp,
                              {"device": "cpu"})):
            mons[pkg] = _monitor(pkg, cls, conf, pport,
                                 auth_token="wrong", **kw)
        seq = {}
        for pkg, (app, mon) in mons.items():
            steps = []
            for _ in range(5):
                steps.append((mon.poll_once(), mon.misses, mon.passive))
            mon.primary = f"127.0.0.1:{dead}"
            for _ in range(4):
                steps.append((mon.poll_once(), mon.misses, mon.passive,
                              mon.takeovers_total))
            seq[pkg] = steps
            assert app.standby_passive() is False
        assert seq["hpnn_tpu"] == seq["hpnn_tpu_torch"]
        port = seq["hpnn_tpu_torch"]
        assert port[:5] == [(True, 0, True)] * 5
        assert port[5:] == [(False, 1, True, 0), (False, 2, True, 0),
                            (False, 3, False, 1), (True, 3, False, 1)]
    finally:
        for app, _ in mons.values():
            app.close(drain=False)
        _close((phttpd, papp))


def test_runtime_repairing(tmp_path, monkeypatch):
    """A standby's polls announce it (``X-HPNN-Standby``): an ACTIVE
    router adopts it at run time and its next ack teaches the worker the
    new pair; a worker whose remembered standby is now the active router
    clears it (``tests/test_train_chaos.py``'s hygiene case)."""
    from hpnn_tpu_torch.serve.mesh import worker as worker_mod

    conf, _ = _write_conf(tmp_path)
    papp, phttpd, pport = _mk_router(conf)
    wapp, whttpd, wport = _mk_worker(conf, router_port=pport)
    sapp, shttpd, sport = _mk_standby(conf, pport, takeover_after=1000)
    try:
        _wait_quorum(pport)
        assert papp.mesh_router.standby_addr is None
        sapp.mesh_standby.advertise = f"127.0.0.1:{sport}"
        assert sapp.mesh_standby.poll_once()
        assert papp.mesh_router.standby_addr == f"127.0.0.1:{sport}"
        _wait(lambda: wapp.mesh_worker.standby == f"127.0.0.1:{sport}",
              what="the worker to learn the standby")
        # a passive standby adopts no announced standby itself
        status, _ = _get(f"http://127.0.0.1:{sport}/v1/mesh/state")
        assert status == 200 and sapp.mesh_router.standby_addr is None
    finally:
        _close((whttpd, wapp), (shttpd, sapp), (phttpd, papp))

    class _Reg:
        retain_generations = False

        def names(self):
            return []

    class _App:
        registry = _Reg()
        auth_token = None
        jobs = None

    agent = worker_mod.WorkerAgent(_App(), "127.0.0.1:9001",
                                   "127.0.0.1:9100", interval_s=60.0)
    agent.standby = "127.0.0.1:9002"
    agent.current = "127.0.0.1:9002"
    monkeypatch.setattr(worker_mod, "post_json",
                        lambda *a, **kw: (200, {"ok": True}, {}))
    assert agent.beat()
    assert agent.router_addr == "127.0.0.1:9002" and agent.standby is None
    monkeypatch.setattr(
        worker_mod, "post_json",
        lambda *a, **kw: (200, {"ok": True, "standby": "127.0.0.1:9003"},
                          {}))
    assert agent.beat() and agent.standby == "127.0.0.1:9003"
    agent.close(goodbye=False)


def _strict(kpath, xs):
    """The strict forward of a kernel file: the port's
    (``ops.select_run_batch``, what a worker's strict tier computes on the
    CPU) and the JAX package's (``ops.convergence.run_batch``)."""
    import torch

    from hpnn_tpu_torch import ops
    from hpnn_tpu_torch.io.kernel_io import load_kernel as port_load

    import jax
    import jax.numpy as jnp

    from hpnn_tpu.io.kernel_io import load_kernel
    from hpnn_tpu.ops.convergence import run_batch

    jax.config.update("jax_enable_x64", True)
    k = load_kernel(kpath)
    jax_out = np.asarray(run_batch(tuple(jnp.asarray(w) for w in k.weights),
                                   jnp.asarray(xs), "ANN"))
    fn, _ = ops.select_run_batch(torch.float64, "strict", kind="ANN",
                                 device="cpu")
    port_out = fn(tuple(torch.as_tensor(np.asarray(w))
                        for w in port_load(kpath).weights),
                  torch.as_tensor(xs), "ANN")
    return np.asarray(port_out), jax_out


def test_primary_killed_one_retry_on_standby_matches_jax(tmp_path):
    """Primary (``--standby``), standby and one worker in process on the
    CPU: the primary dies (listener severed, no goodbye), the standby
    takes over after 2 missed polls, a request that failed against the
    primary succeeds on one retry against the standby, the worker's
    heartbeat follows it, and every reply's bits equal the strict forward
    of the kernel (which is within 1e-13 of the JAX package's: on the CPU
    XLA's dot sums in another order than torch's)."""
    conf, kpath = _write_conf(tmp_path)
    sport = _free_port()
    papp = ServeApp(max_batch=16, max_queue_rows=512, device="cpu")
    papp.enable_mesh_router(required_workers=1, health_interval_s=0.2,
                            standby_addr=f"127.0.0.1:{sport}")
    assert papp.add_model(conf) is not None
    phttpd, _ = serve_in_thread(papp)
    pport = phttpd.server_address[1]
    sapp = ServeApp(max_batch=16, max_queue_rows=512, device="cpu")
    sapp.enable_mesh_standby(f"127.0.0.1:{pport}", health_interval_s=0.2,
                             takeover_after=2, poll_interval_s=0.2)
    assert sapp.add_model(conf) is not None
    shttpd, _ = serve_in_thread(sapp, port=sport)
    wapp, whttpd, _ = _mk_worker(conf, router_port=pport)
    agent = wapp.mesh_worker
    xs = np.random.default_rng(9).uniform(-1, 1, (3, N_IN))
    want, jax_want = _strict(kpath, xs)
    # XLA's CPU dot and torch's sum in other orders: 1 ulp apart at most
    np.testing.assert_allclose(want, jax_want, atol=1e-13, rtol=0)
    payload = {"inputs": xs.tolist()}
    try:
        _wait_quorum(pport)
        _wait(lambda: agent.standby == f"127.0.0.1:{sport}",
              what="the ack's standby")
        _wait(lambda: sapp.mesh_router.pool.live_count() >= 1,
              what="the mirrored worker table")
        st, body, _ = _post(f"http://127.0.0.1:{pport}",
                            "/v1/kernels/tiny/infer", payload)
        assert st == 200
        np.testing.assert_array_equal(np.asarray(json.loads(body)["outputs"]),
                                      want)
        _kill(phttpd, papp)
        phttpd = None
        with pytest.raises(OSError):
            _post(f"http://127.0.0.1:{pport}", "/v1/kernels/tiny/infer",
                  payload)
        _wait(lambda: not sapp.mesh_standby.passive, what="the takeover")
        assert sapp.mesh_standby.takeovers_total == 1
        _wait(lambda: _get(f"http://127.0.0.1:{sport}/healthz")[0] == 200,
              what="the survivor's readiness")
        st, body, _ = _post(f"http://127.0.0.1:{sport}",
                            "/v1/kernels/tiny/infer", payload)
        assert st == 200
        np.testing.assert_array_equal(np.asarray(json.loads(body)["outputs"]),
                                      want)
        _wait(lambda: agent.current == f"127.0.0.1:{sport}"
              and agent.registered, timeout_s=20.0,
              what="the worker's heartbeat to follow")
    finally:
        _close((whttpd, wapp), (shttpd, sapp))
        if phttpd is not None:
            _close((phttpd, papp))
