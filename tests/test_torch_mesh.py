"""The port's serve mesh over real HTTP in one process, ``--device cpu``:
a router (``hpnn_tpu_torch.serve.mesh.router``) in front of worker
servers with their heartbeat agents (``serve.mesh.worker``), held to the
port's single-process server bit for bit and to the JAX package's
``ServeApp`` within 1e-13 (the tolerance of
``tests/test_torch_serve_qos.py``) on a generated f64 kernel.

The cases are the JAX package's ``tests/test_mesh.py`` ones: a worker
shut down mid-load (zero non-200 replies), a generation-coherent reload,
a late worker catching up by heartbeat, a blob reload onto disjoint
directories, the /healthz quorum and worker table, registration behind
auth, spill protection, the deadline header end to end, spans across the
hop, heartbeat backoff against a dead router, and the CLI roles.
Intervals are short (heartbeat 0.3 s, health 0.2 s); no test waits on a
default interval.
"""

import hashlib
import json
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from hpnn_tpu_torch.serve.mesh.worker import WorkerAgent
from hpnn_tpu_torch.serve.server import ServeApp, serve_in_thread

N_IN, N_HID, N_OUT = 8, 6, 3


def _write_conf(tmp_path, name="tiny", seed=1234, sub=None):
    """A generated f64 ANN kernel and its conf (written by the JAX
    package's writer, which both packages read)."""
    from hpnn_tpu.io.kernel_io import dump_kernel_to_path
    from hpnn_tpu.models.kernel import generate_kernel

    d = tmp_path / sub if sub else tmp_path
    d.mkdir(exist_ok=True)
    kern, _ = generate_kernel(seed, N_IN, [N_HID], N_OUT)
    kpath = str(d / f"{name}.opt")
    dump_kernel_to_path(kern, kpath)
    conf = d / f"{name}.conf"
    conf.write_text(f"[name] tiny\n[type] ANN\n[init] {kpath}\n"
                    "[seed] 1\n[train] BP\n")
    return str(conf), kpath


def _post(base, path, payload, headers=None):
    """Raw-byte POST: (status, body bytes, headers)."""
    h = {"Content-Type": "application/json"}
    h.update(headers or {})
    req = urllib.request.Request(base + path,
                                 data=json.dumps(payload).encode(),
                                 headers=h)
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.read(), dict(resp.headers)
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read(), dict(exc.headers)


def _get(url, headers=None):
    req = urllib.request.Request(url, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read().decode())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read().decode())


def _mk_worker(conf, router_port=None, **kw):
    """A port worker: ServeApp + HTTP thread (+ its heartbeat agent when
    a router port is given).  Returns (app, httpd, port)."""
    app = ServeApp(max_batch=16, max_queue_rows=512, device="cpu", **kw)
    assert app.add_model(conf, warmup=False) is not None
    httpd, _ = serve_in_thread(app)
    port = httpd.server_address[1]
    if router_port is not None:
        app.enable_mesh_worker(f"127.0.0.1:{router_port}",
                               f"127.0.0.1:{port}", interval_s=0.3)
    return app, httpd, port


def _mk_router(conf, required=1, **kw):
    app = ServeApp(max_batch=16, max_queue_rows=512, device="cpu", **kw)
    app.enable_mesh_router(required_workers=required,
                           health_interval_s=0.2)
    assert app.add_model(conf) is not None
    httpd, _ = serve_in_thread(app)
    return app, httpd, httpd.server_address[1]


def _wait_quorum(port, timeout_s=15.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        status, body = _get(f"http://127.0.0.1:{port}/healthz")
        if status == 200:
            return body
        time.sleep(0.05)
    raise AssertionError(f"router on :{port} never reached quorum")


def _kill(httpd, app):
    """The in-process stand-in for a SIGKILL: no new connections, the
    established keep-alive ones severed, no goodbye."""
    httpd.shutdown()
    httpd.abort_connections()
    httpd.server_close()
    app.close(drain=False)


def _close(*pairs):
    for httpd, app in pairs:
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
            app.close(drain=True)


@pytest.fixture
def jax_serve(tmp_path):
    """The JAX package's single-process server on the same conf."""
    from hpnn_tpu.serve.server import ServeApp as JaxApp
    from hpnn_tpu.serve.server import serve_in_thread as jax_thread

    made = []

    def make(conf):
        app = JaxApp(max_batch=16, max_queue_rows=512)
        assert app.add_model(conf, warmup=False) is not None
        httpd, _ = jax_thread("127.0.0.1", 0, app)
        made.append((httpd, app))
        return f"http://127.0.0.1:{httpd.server_address[1]}"

    yield make
    _close(*made)


# --- the acceptance pins ----------------------------------------------------

def test_mesh_replies_bit_identical_to_plain_and_near_jax(tmp_path,
                                                         jax_serve):
    """A router over two workers answers with the port's single-process
    server's bytes, for sequential requests of every bucket and for 8
    concurrent clients, and within 1e-13 of the JAX ServeApp."""
    conf, _ = _write_conf(tmp_path)
    papp, phttpd, pport = _mk_worker(conf)
    rapp, rhttpd, rport = _mk_router(conf, required=2)
    w1 = _mk_worker(conf, router_port=rport)
    w2 = _mk_worker(conf, router_port=rport)
    jbase = jax_serve(conf)
    plain, mesh = f"http://127.0.0.1:{pport}", f"http://127.0.0.1:{rport}"
    try:
        _wait_quorum(rport)
        rng = np.random.default_rng(11)
        for rows in (1, 3, 5, 8, 11, 16):
            payload = {"inputs": rng.uniform(-1, 1, (rows, N_IN)).tolist()}
            st_p, body_p, _ = _post(plain, "/v1/kernels/tiny/infer",
                                    payload)
            st_m, body_m, _ = _post(mesh, "/v1/kernels/tiny/infer",
                                    payload)
            st_j, body_j, _ = _post(jbase, "/v1/kernels/tiny/infer",
                                    payload)
            assert st_p == st_m == st_j == 200
            assert body_m == body_p   # bytes, not parsed floats
            np.testing.assert_allclose(json.loads(body_m)["outputs"],
                                       json.loads(body_j)["outputs"],
                                       atol=1e-13, rtol=0)
        # 8 concurrent clients: every reply is still the plain server's
        # bytes
        xs = [rng.uniform(-1, 1, (1 + i % 3, N_IN)).tolist()
              for i in range(64)]
        want = [_post(plain, "/v1/kernels/tiny/infer", {"inputs": x})[1]
                for x in xs]
        got = [None] * len(xs)

        def client(k):
            for i in range(k, len(xs), 8):
                got[i] = _post(mesh, "/v1/kernels/tiny/infer",
                               {"inputs": xs[i]})[1]

        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert got == want
        st, tbl = _get(mesh + "/v1/mesh/workers")
        assert st == 200 and tbl["live"] == 2
        # batches, not requests: concurrent requests coalesce
        assert sum(w["routed"] for w in tbl["workers"].values()) > 6
    finally:
        _close((w1[1], w1[0]), (w2[1], w2[0]), (rhttpd, rapp),
               (phttpd, papp))


def test_worker_shutdown_mid_load_zero_non200(tmp_path):
    """Two workers, the one carrying the traffic dies under load: every
    request still answers 200 (retry once elsewhere), the corpse is
    ejected, /healthz reports it and the quorum of 2 is lost."""
    conf, _ = _write_conf(tmp_path)
    rapp, rhttpd, rport = _mk_router(conf, required=2)
    w1app, w1httpd, w1port = _mk_worker(conf, router_port=rport)
    w2app, w2httpd, _ = _mk_worker(conf, router_port=rport)
    base = f"http://127.0.0.1:{rport}"
    statuses, lock, stop = [], threading.Lock(), threading.Event()
    try:
        _wait_quorum(rport)
        xs = np.random.default_rng(5).uniform(-1, 1, (3, N_IN))

        def hammer():
            while not stop.is_set():
                st, _, _ = _post(base, "/v1/kernels/tiny/infer",
                                 {"inputs": xs.tolist(),
                                  "timeout_ms": 10000})
                with lock:
                    statuses.append(st)

        threads = [threading.Thread(target=hammer) for _ in range(4)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            with lock:
                if len(statuses) >= 20:
                    break
            time.sleep(0.01)
        tbl = rapp.mesh_router.pool.table()
        busiest = max(tbl.values(), key=lambda w: w["routed"])
        if busiest["addr"].endswith(f":{w1port}"):
            _kill(w1httpd, w1app)
            w1httpd = None
        else:
            _kill(w2httpd, w2app)
            w2httpd = None
        t_kill = time.monotonic()
        while time.monotonic() - t_kill < 10.0:
            if any(w["state"] == "dead"
                   for w in rapp.mesh_router.pool.table().values()):
                break
            time.sleep(0.01)
        time.sleep(0.5)   # keep hammering the survivor
        stop.set()
        for t in threads:
            t.join()
        assert len(statuses) >= 40
        assert set(statuses) == {200}, [s for s in statuses if s != 200]
        assert rapp.mesh_router.pool.failovers_total >= 1
        status, body = _get(base + "/healthz")
        states = {w["state"] for w in body["mesh"]["workers"].values()}
        assert "dead" in states and "live" in states
        assert status == 503 and body["status"] == "warming"
        m = _get(base + "/metrics?format=json")[1]
        assert m["mesh"]["failovers_total"] >= 1
        assert m["requests"].get("error", 0) == 0
    finally:
        stop.set()
        _close((w1httpd, w1app), (w2httpd, w2app), (rhttpd, rapp))


def test_generation_coherent_reload_across_two_workers(tmp_path,
                                                       jax_serve):
    """A checkpoint-manifest bump reloads both workers at one broadcast
    generation before the router flips; pins to the old generation still
    serve the old weights through the mesh, an unknown pin is a 404, and
    an unloadable path is refused at the router without ejecting
    anyone.  Both generations' replies are within 1e-13 of JAX's."""
    from hpnn_tpu.io.kernel_io import dump_kernel_to_path
    from hpnn_tpu.models.kernel import generate_kernel

    conf, _ = _write_conf(tmp_path)
    rapp, rhttpd, rport = _mk_router(conf, required=2)
    w1app, w1httpd, _ = _mk_worker(conf, router_port=rport)
    w2app, w2httpd, _ = _mk_worker(conf, router_port=rport)
    base = f"http://127.0.0.1:{rport}"
    try:
        _wait_quorum(rport)
        xs = {"inputs": np.linspace(-1, 1, N_IN).reshape(1, N_IN).tolist()}
        st, raw, _ = _post(base, "/v1/kernels/tiny/infer", xs)
        before = json.loads(raw)
        assert st == 200 and before["generation"] == 1
        k2, _ = generate_kernel(4321, N_IN, [N_HID], N_OUT)
        ckdir = tmp_path / "ck"
        ckdir.mkdir()
        dump_kernel_to_path(k2, str(ckdir / "kernel.opt"))
        (ckdir / "manifest.json").write_text(json.dumps(
            {"generation": 1, "kernel": "kernel.opt"}))
        state = {"gen": 0}
        result = rapp.poll_ckpt_reload("tiny", str(ckdir), state)
        assert result is not None and result["generation"] == 2
        assert sorted(result["mesh"]["workers_reloaded"]) == sorted(
            w.wid for w in rapp.mesh_router.pool.workers())
        assert result["mesh"]["workers_failed"] == []
        assert [a.registry.get("tiny").generation
                for a in (rapp, w1app, w2app)] == [2, 2, 2]
        st, raw, _ = _post(base, "/v1/kernels/tiny/infer", xs)
        after = json.loads(raw)
        assert st == 200 and after["generation"] == 2
        assert after["outputs"] != before["outputs"]
        jconf2 = tmp_path / "j2.conf"
        jconf2.write_text(f"[name] tiny\n[type] ANN\n[init] "
                          f"{ckdir / 'kernel.opt'}\n[seed] 1\n[train] BP\n")
        jraw = _post(jax_serve(str(jconf2)), "/v1/kernels/tiny/infer",
                     xs)[1]
        np.testing.assert_allclose(after["outputs"],
                                   json.loads(jraw)["outputs"],
                                   atol=1e-13, rtol=0)
        st, raw, _ = _post(base, "/v1/kernels/tiny/infer", xs,
                           {"X-HPNN-Generation": "1"})
        pinned = json.loads(raw)
        assert st == 200 and pinned["generation"] == 1
        assert pinned["outputs"] == before["outputs"]
        st, raw, _ = _post(base, "/v1/kernels/tiny/infer", xs,
                           {"X-HPNN-Generation": "9"})
        assert st == 404
        assert json.loads(raw)["reason"] == "unknown_generation"
        assert rapp.poll_ckpt_reload("tiny", str(ckdir), state) is None
        st, raw, _ = _post(base, "/v1/kernels/tiny/reload",
                           {"kernel": str(tmp_path / "missing.opt")})
        assert st == 409 and json.loads(raw)["reason"] == "reload_failed"
        assert rapp.mesh_router.pool.live_count() == 2
    finally:
        _close((w1httpd, w1app), (w2httpd, w2app), (rhttpd, rapp))


def test_late_worker_catches_up_via_heartbeat(tmp_path):
    """A worker registering after a fleet reload pulls itself up to the
    router's generation on its first heartbeat ack."""
    from hpnn_tpu.io.kernel_io import dump_kernel_to_path
    from hpnn_tpu.models.kernel import generate_kernel

    conf, kpath = _write_conf(tmp_path)
    rapp, rhttpd, rport = _mk_router(conf, required=1)
    w1app, w1httpd, _ = _mk_worker(conf, router_port=rport)
    w2app = w2httpd = None
    try:
        _wait_quorum(rport)
        k2, _ = generate_kernel(999, N_IN, [N_HID], N_OUT)
        dump_kernel_to_path(k2, kpath)
        assert rapp.reload_model("tiny")["generation"] == 2
        assert w1app.registry.get("tiny").generation == 2
        w2app, w2httpd, w2port = _mk_worker(conf)
        assert w2app.registry.get("tiny").generation == 1
        agent = WorkerAgent(w2app, f"127.0.0.1:{rport}",
                            f"127.0.0.1:{w2port}", interval_s=0.3)
        assert agent.beat()
        assert w2app.registry.get("tiny").generation == 2
        xs = {"inputs": np.zeros((1, N_IN)).tolist()}
        a = _post(f"http://127.0.0.1:{w2port}", "/v1/kernels/tiny/infer",
                  xs)[1]
        b = _post(f"http://127.0.0.1:{rport}", "/v1/kernels/tiny/infer",
                  xs)[1]
        assert json.loads(a)["outputs"] == json.loads(b)["outputs"]
    finally:
        _close((w1httpd, w1app), (w2httpd, w2app), (rhttpd, rapp))


def test_blob_reload_lands_on_disjoint_dirs(tmp_path):
    """A broadcast that carries only {sha256, size}: each worker pulls
    the bytes from the router into its own blob directory, checks the
    hash and loads them; no shared path is read."""
    from hpnn_tpu.io.kernel_io import dump_kernel_to_path
    from hpnn_tpu.models.kernel import generate_kernel

    conf, _ = _write_conf(tmp_path)
    rapp, rhttpd, rport = _mk_router(conf, required=2)
    w1app, w1httpd, w1port = _mk_worker(conf, router_port=rport)
    w2app, w2httpd, _ = _mk_worker(conf, router_port=rport)
    w1app.mesh_worker.blob_dir = str(tmp_path / "host1-blobs")
    w2app.mesh_worker.blob_dir = str(tmp_path / "host2-blobs")
    base = f"http://127.0.0.1:{rport}"
    try:
        _wait_quorum(rport)
        k2, _ = generate_kernel(7777, N_IN, [N_HID], N_OUT)
        (tmp_path / "router-only").mkdir()
        newpath = str(tmp_path / "router-only" / "kernel.opt")
        dump_kernel_to_path(k2, newpath)
        new_bytes = open(newpath, "rb").read()
        sha = hashlib.sha256(new_bytes).hexdigest()
        result = rapp.reload_model("tiny", newpath)
        assert result["generation"] == 2
        assert result["mesh"]["blob"] == {"sha256": sha,
                                          "size": len(new_bytes)}
        assert result["mesh"]["workers_failed"] == []
        for wapp, wdir in ((w1app, "host1-blobs"), (w2app, "host2-blobs")):
            model = wapp.registry.get("tiny")
            assert model.generation == 2
            assert model.source == str(tmp_path / wdir / f"{sha}.opt")
            assert open(model.source, "rb").read() == new_bytes
        xs = {"inputs": np.linspace(-1, 1, N_IN).reshape(1, N_IN).tolist()}
        via = json.loads(_post(base, "/v1/kernels/tiny/infer", xs)[1])
        direct = json.loads(_post(f"http://127.0.0.1:{w1port}",
                                  "/v1/kernels/tiny/infer", xs)[1])
        assert via["generation"] == 2
        assert direct["outputs"] == via["outputs"]
        with urllib.request.urlopen(base + f"/v1/mesh/blob/{sha}") as resp:
            assert resp.read() == new_bytes
        assert _get(base + "/v1/mesh/blob/" + "0" * 64)[0] == 404
    finally:
        _close((w1httpd, w1app), (w2httpd, w2app), (rhttpd, rapp))


def test_router_healthz_quorum_and_worker_table(tmp_path):
    """A router warms until its quorum is live, with per-worker states in
    /healthz; a worker's /healthz names its role and router; the key sets
    are the JAX package's (the port adds its device)."""
    from hpnn_tpu.serve.server import ServeApp as JaxApp

    conf, _ = _write_conf(tmp_path)
    rapp, rhttpd, rport = _mk_router(conf, required=2)
    base = f"http://127.0.0.1:{rport}"
    apps = []
    try:
        status, body = _get(base + "/healthz")
        assert status == 503 and body["status"] == "warming"
        assert body["mesh"] == {"role": "router", "required": 2,
                                "live": 0, "quorum": False, "workers": {}}
        apps.append(_mk_worker(conf, router_port=rport))
        deadline = time.monotonic() + 10
        while _get(base + "/healthz")[1]["mesh"]["live"] < 1 \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        status, body = _get(base + "/healthz")
        assert status == 503 and body["mesh"]["live"] == 1
        apps.append(_mk_worker(conf, router_port=rport))
        body = _wait_quorum(rport)
        assert body["mesh"]["quorum"] is True
        assert all(w["state"] == "live"
                   for w in body["mesh"]["workers"].values())
        status, wbody = _get(f"http://127.0.0.1:{apps[0][2]}/healthz")
        assert status == 200 and wbody["mesh"]["role"] == "worker"
        assert wbody["mesh"]["registered"] is True
        status, tbl = _get(base + "/v1/mesh/workers")
        assert status == 200 and len(tbl["workers"]) == 2
        # the JAX router's /healthz body has the same keys
        japp = JaxApp(max_batch=16)
        japp.enable_mesh_router(required_workers=2, health_interval_s=0.2)
        try:
            assert japp.add_model(conf) is not None
            from hpnn_tpu.serve.server import serve_in_thread as jthread

            jhttpd, _ = jthread("127.0.0.1", 0, japp)
            try:
                _st, jbody = _get(
                    f"http://127.0.0.1:{jhttpd.server_address[1]}/healthz")
            finally:
                jhttpd.shutdown()
                jhttpd.server_close()
        finally:
            japp.close()
        assert set(body) == set(jbody) | {"device"}
        assert set(body["mesh"]) == set(jbody["mesh"])
        # the mesh metrics section, beside the JAX router's keys
        m = _get(base + "/metrics?format=json")[1]
        assert {"role", "required", "live", "workers_by_state",
                "failovers_total", "workers", "fleet_collector", "blobs",
                "bundles", "transport", "standby"} == set(m["mesh"])
    finally:
        for app, httpd, _port in apps:
            _close((httpd, app))
        _close((rhttpd, rapp))


def test_mesh_register_auth_guarded(tmp_path):
    conf, _ = _write_conf(tmp_path)
    rapp, rhttpd, rport = _mk_router(conf, required=1, auth_token="sesame")
    base = f"http://127.0.0.1:{rport}"
    auth = {"Authorization": "Bearer sesame"}
    lapp = lhttpd = None
    try:
        assert _post(base, "/v1/mesh/register",
                     {"addr": "127.0.0.1:1"})[0] == 401
        st, raw, _ = _post(base, "/v1/mesh/register",
                           {"addr": "127.0.0.1:1"}, auth)
        assert st == 200 and json.loads(raw)["ok"] is True
        st, raw, _ = _post(base, "/v1/mesh/register", {"addr": "myhost"},
                           auth)
        assert st == 400 and "HOST:PORT" in json.loads(raw)["error"]
        assert _get(base + "/v1/mesh/state")[0] == 401
        assert _get(base + "/v1/mesh/blob/" + "0" * 64)[0] == 401
        assert _get(base + "/v1/mesh/bundles?scope=x")[0] == 401
        st, body = _get(base + "/v1/mesh/state", auth)
        assert st == 200 and body["router_token"]
        assert body["role"] == "router" and "tiny" in body["kernels"]
        # the goodbye takes a worker out of routing at once
        st, raw, _ = _post(base, "/v1/mesh/register",
                           {"addr": "127.0.0.1:1", "retiring": True}, auth)
        assert st == 200 and json.loads(raw)["retiring"] is True
        assert rapp.mesh_router.pool.table()["127.0.0.1:1"]["state"] \
            == "retiring"
        # a non-router server refuses registrations outright
        lapp, lhttpd, lport = _mk_worker(conf)
        st, raw, _ = _post(f"http://127.0.0.1:{lport}", "/v1/mesh/register",
                           {"addr": "127.0.0.1:1"})
        assert st == 503 and json.loads(raw)["reason"] == "mesh_disabled"
        assert _get(f"http://127.0.0.1:{lport}/v1/mesh/workers")[0] == 404
    finally:
        _close((lhttpd, lapp), (rhttpd, rapp))


def test_worker_spill_protection_requires_router_token(tmp_path):
    conf, _ = _write_conf(tmp_path)
    rapp, rhttpd, rport = _mk_router(conf, required=1)
    wapp, whttpd, wport = _mk_worker(conf, router_port=rport,
                                     require_router=True)
    xs = {"inputs": np.zeros((2, N_IN)).tolist()}
    try:
        _wait_quorum(rport)
        agent = wapp.mesh_worker
        deadline = time.monotonic() + 5
        while agent.router_token is None and time.monotonic() < deadline:
            time.sleep(0.05)
        wbase = f"http://127.0.0.1:{wport}"
        st, raw, _ = _post(wbase, "/v1/kernels/tiny/infer", xs)
        assert st == 403 and json.loads(raw)["reason"] == "router_only"
        assert _post(wbase, "/v1/kernels/tiny/infer", xs,
                     {"X-HPNN-Router": "nope"})[0] == 403
        assert _post(f"http://127.0.0.1:{rport}", "/v1/kernels/tiny/infer",
                     xs)[0] == 200
        assert _post(wbase, "/v1/kernels/tiny/infer", xs,
                     {"X-HPNN-Router": agent.router_token})[0] == 200
        assert _get(wbase + "/metrics?format=json")[1]["requests"][
            "router_only"] == 2
    finally:
        _close((whttpd, wapp), (rhttpd, rapp))


def test_deadline_header_end_to_end(tmp_path):
    """The deadline rides the router's RPC: an expired one is a 504 at
    admission, one that lapses while the worker's queue is held is a 504
    through the hop, and malformed headers are 400s."""
    conf, _ = _write_conf(tmp_path)
    rapp, rhttpd, rport = _mk_router(conf, required=1)
    wapp, whttpd, _ = _mk_worker(conf, router_port=rport)
    base = f"http://127.0.0.1:{rport}"
    xs = {"inputs": np.zeros((1, N_IN)).tolist()}
    try:
        _wait_quorum(rport)
        st, raw, _ = _post(base, "/v1/kernels/tiny/infer", xs,
                           {"X-HPNN-Deadline-Ms": "-10"})
        assert st == 504 and json.loads(raw)["reason"] == "deadline"
        wapp.batchers["tiny"].pause()
        t0 = time.monotonic()
        st, raw, _ = _post(base, "/v1/kernels/tiny/infer",
                           {**xs, "timeout_ms": 60000},
                           {"X-HPNN-Deadline-Ms": "300"})
        assert st == 504 and time.monotonic() - t0 < 10
        wapp.batchers["tiny"].resume()
        # the router's RPC timed out on the held worker and ejected it;
        # the health loop readmits it
        _wait_quorum(rport)
        assert _post(base, "/v1/kernels/tiny/infer", xs,
                     {"X-HPNN-Deadline-Ms": "soon"})[0] == 400
        assert _post(base, "/v1/kernels/tiny/infer", xs,
                     {"X-HPNN-Priority": "urgent"})[0] == 400
        assert _post(base, "/v1/kernels/tiny/infer", xs,
                     {"X-HPNN-Priority": "low",
                      "X-HPNN-Deadline-Ms": "5000"})[0] == 200
    finally:
        _close((whttpd, wapp), (rhttpd, rapp))


def test_trace_spans_cross_the_mesh_hop(tmp_path):
    """One traced request through the router yields the router's root,
    queue and mesh.route spans and the worker's device spans under one
    trace id; the router's merged view tags each side."""
    from hpnn_tpu_torch.obs import trace as obs_trace

    conf, _ = _write_conf(tmp_path)
    rapp = wapp = rhttpd = whttpd = None
    try:
        obs_trace.enable()
        rapp, rhttpd, rport = _mk_router(conf, required=1)
        wapp, whttpd, _wp = _mk_worker(conf, router_port=rport)
        _wait_quorum(rport)
        st, raw, _ = _post(f"http://127.0.0.1:{rport}",
                           "/v1/kernels/tiny/infer",
                           {"inputs": np.zeros((2, N_IN)).tolist()},
                           {"X-HPNN-Trace-Id": "meshtrace01"})
        assert st == 200 and json.loads(raw)["trace"] == "meshtrace01"
        spans = obs_trace.snapshot(trace_id="meshtrace01")
        names = {s["name"] for s in spans}
        assert {"serve.request", "queue_wait", "mesh.route",
                "device_launch"} <= names
        route = [s for s in spans if s["name"] == "mesh.route"]
        assert route and route[0]["retried"] == 0
        assert route[0]["remote_trace"] == "meshtrace01"
    finally:
        obs_trace.disable()
        _close((whttpd, wapp), (rhttpd, rapp))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_heartbeat_backs_off_against_dead_router(tmp_path):
    """A dead router means jittered exponential backoff (capped); the
    first acked beat against a live one resets the schedule."""
    conf, _ = _write_conf(tmp_path)
    wapp = ServeApp(max_batch=8, device="cpu")
    assert wapp.add_model(conf, warmup=False) is not None
    agent = WorkerAgent(wapp, f"127.0.0.1:{_free_port()}", "127.0.0.1:1",
                        interval_s=0.2)
    try:
        for _ in range(4):
            assert agent.beat() is False
        assert agent.registered is False
        delays = [agent.next_delay(False) for _ in range(5)]
        assert delays[0] < delays[2] < delays[4] <= 30.0 * 1.25
        rapp, rhttpd, rport = _mk_router(conf, required=1)
        agent.router_addr = agent.current = f"127.0.0.1:{rport}"
        assert agent.beat() is True
        assert agent.next_delay(False) <= 0.2 * 2 * 1.25
        _close((rhttpd, rapp))
    finally:
        wapp.close(drain=False)


def test_cli_mesh_roles(tmp_path, capsys):
    """serve_nn --mesh-role router|worker through cli.serve_app and
    cli.start_mesh_worker (what serve_nn_main runs around its bind): the
    worker registers with the router and serves through it, its trace
    role names it, and its graceful close says goodbye."""
    from hpnn_tpu_torch import cli
    from hpnn_tpu_torch.obs import trace as obs_trace

    conf, _ = _write_conf(tmp_path)
    assert cli.serve_app(["--mesh-role", "worker", "--device", "cpu",
                          conf]) == (None, -1)
    assert "--mesh-role worker requires --router" in capsys.readouterr().err
    rapp, rargs = cli.serve_app(["--mesh-role", "router", "--workers", "1",
                                 "--mesh-health-interval", "0.2",
                                 "--router-token", "rt", "--device", "cpu",
                                 "--no-warmup", conf])
    assert obs_trace.get_role() == "router"
    rhttpd, _ = serve_in_thread(rapp)
    rport = rhttpd.server_address[1]
    whttpd = None
    try:
        assert rapp.mesh_router.router_token == "rt"
        wapp, wargs = cli.serve_app([
            "--mesh-role", "worker", "--router", f"127.0.0.1:{rport}",
            "--require-router", "--device", "cpu", "--no-warmup", conf])
        assert obs_trace.get_role() == "worker"
        whttpd, _ = serve_in_thread(wapp)
        wport = whttpd.server_address[1]
        cli.start_mesh_worker(wapp, wargs, wport)
        assert f"advertising 127.0.0.1:{wport}" in capsys.readouterr().out
        _wait_quorum(rport)
        assert _post(f"http://127.0.0.1:{rport}", "/v1/kernels/tiny/infer",
                     {"inputs": np.zeros((1, N_IN)).tolist()})[0] == 200
        assert _post(f"http://127.0.0.1:{wport}", "/v1/kernels/tiny/infer",
                     {"inputs": np.zeros((1, N_IN)).tolist()})[0] == 403
        whttpd.shutdown()
        whttpd.server_close()
        wapp.close(drain=True)   # the SIGTERM drain's goodbye
        whttpd = None
        assert rapp.mesh_router.pool.table()[f"127.0.0.1:{wport}"][
            "state"] == "retiring"
    finally:
        obs_trace.set_role(None)
        if whttpd is not None:
            _close((whttpd, wapp))
        _close((rhttpd, rapp))
