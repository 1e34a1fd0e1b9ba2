"""The port's mesh transport, swarm blob fetches, durable-write fault
injection and replication to a router (``hpnn_tpu_torch/serve/mesh/
transport.py``, ``worker.py``'s swarm, ``io/atomic.io_fault_hook``,
``ckpt/replicate.py``'s router destination), held to ``hpnn_tpu``.

The transport units run the same calls through both packages against
the same stdlib peers and must give the same outcomes (status, bytes,
source, misses, pool counters).  The swarm cases run a port fleet in
process.  Replication ships the port's bundles to a port router and to
a JAX one (and the JAX package's to a port router): one spool format,
one protocol.
"""

import hashlib
import http.server
import json
import os
import shutil
import socket
import threading
import time
import urllib.request

import pytest

N_IN, N_HID, N_OUT = 8, 6, 3


def _pkg(name):
    if name == "jax":
        from hpnn_tpu.serve.mesh import chaos, transport
    else:
        from hpnn_tpu_torch.serve.mesh import chaos, transport
    return chaos, transport


@pytest.fixture(autouse=True)
def _chaos_clean():
    for name in ("jax", "port"):
        _pkg(name)[0].reset()
    yield
    for name in ("jax", "port"):
        _pkg(name)[0].reset()


class _Peer:
    """A counting stdlib server: /echo answers JSON, /v1/mesh/blob/<sha>
    serves its blobs (optionally late), keep-alive honored."""

    def __init__(self, delay_s=0.0):
        peer = self
        peer.requests = 0
        peer.blob_gets = 0
        peer.blobs = {}
        peer.conns = []
        peer.delay_s = delay_s

        class H(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def setup(self):
                super().setup()
                peer.conns.append(self.connection)

            def log_message(self, *a):
                pass

            def _send(self, status, body, ctype="application/json"):
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                peer.requests += 1
                if self.path.startswith("/v1/mesh/blob/"):
                    peer.blob_gets += 1
                    if peer.delay_s:
                        time.sleep(peer.delay_s)
                    data = peer.blobs.get(self.path.rsplit("/", 1)[1])
                    if data is None:
                        self._send(404, b'{"reason": "not_found"}')
                    else:
                        self._send(200, data, "application/octet-stream")
                    return
                self._send(200, json.dumps({"n": peer.requests}).encode())

            def do_POST(self):
                peer.requests += 1
                body = self.rfile.read(
                    int(self.headers.get("Content-Length") or 0))
                self._send(200, json.dumps(
                    {"n": peer.requests, "len": len(body)}).encode())

        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.httpd.daemon_threads = True
        self.addr = "127.0.0.1:%d" % self.httpd.server_address[1]
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


# --- keep-alive transport ---------------------------------------------------

def _pool_run(name):
    chaos, transport = _pkg(name)
    peer = _Peer()
    pool = transport.ConnectionPool(enabled=True)
    out = []
    try:
        for _ in range(3):
            st, raw, _ = transport.request(peer.addr, "GET", "/echo",
                                           timeout_s=5.0, pool=pool)
            out.append((st, json.loads(raw)))
        st, raw, _ = transport.request(peer.addr, "POST", "/echo",
                                       body=b"x" * 100, timeout_s=5.0,
                                       pool=pool)
        out.append((st, json.loads(raw)))
        out.append({k: v for k, v in pool.stats().items()
                    if isinstance(v, int)})
        # the peer closes the established socket under us: one fresh
        # retry heals it (the liveness peek blinded, as in the race)
        for sock in peer.conns:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        real = transport._sock_alive
        transport._sock_alive = lambda s: True
        try:
            st, _, _ = transport.request(peer.addr, "GET", "/echo",
                                         timeout_s=5.0, pool=pool)
        finally:
            transport._sock_alive = real
        out.append((st, {k: v for k, v in pool.stats().items()
                         if isinstance(v, int)}))
        # chaos below the transport: a fabricated 502 never reaches the
        # wire; post-send faults do
        chaos.configure("http@/echo:times=1,code=502")
        st, raw, _ = transport.request(peer.addr, "GET", "/echo",
                                       timeout_s=5.0, pool=pool)
        out.append((st, json.loads(raw)["reason"], peer.requests))
        for kind in ("reset-after", "timeout", "truncate"):
            chaos.configure(f"{kind}@/echo:times=1")
            try:
                transport.request(peer.addr, "GET", "/echo", timeout_s=5.0,
                                  pool=pool)
                out.append((kind, "no error"))
            except transport.TRANSPORT_ERRORS as exc:
                out.append((kind, type(exc).__name__, peer.requests))
        out.append(sorted(t.__name__ for t in transport.TRANSPORT_ERRORS))
    finally:
        chaos.reset()
        peer.close()
    return out


def test_keepalive_pool_stale_retry_and_chaos_match_jax():
    got = {name: _pool_run(name) for name in ("jax", "port")}
    assert got["port"] == got["jax"]
    stats = got["port"][4]
    assert stats["fresh_total"] == 1 and stats["reused_total"] == 3


def test_backoff_schedule_matches_jax():
    import random

    seqs = {}
    for name in ("jax", "port"):
        _chaos, transport = _pkg(name)
        b = transport.Backoff(base_s=0.2, cap_s=5.0, rng=random.Random(4))
        seq = [b.next_delay() for _ in range(8)]
        b.reset()
        seq.append(b.next_delay())
        seqs[name] = seq
    assert seqs["port"] == seqs["jax"]
    assert seqs["port"][-1] < 0.3 and max(seqs["port"]) <= 5.0 * 1.25


# --- verified blobs and the swarm -------------------------------------------

@pytest.mark.parametrize("name", ["port", "jax"])
def test_verify_blob_file_streaming(tmp_path, name):
    verify = _pkg(name)[1].verify_blob_file
    data = os.urandom(3 << 20)   # more than one hash chunk
    sha = hashlib.sha256(data).hexdigest()
    path = tmp_path / f"{sha}.opt"
    path.write_bytes(data)
    assert verify(str(path), sha, len(data)) and verify(str(path), sha)
    path.write_bytes(data[:-1])
    assert not verify(str(path), sha, len(data))
    path.write_bytes(b"x" * len(data))
    assert not verify(str(path), sha, len(data))
    assert not verify(str(tmp_path / "absent.opt"), sha)


def test_fetch_single_flight_thundering_herd(tmp_path):
    """Four concurrent fetches of one blob download it once a host: the
    leader fetches, the followers re-verify the landed file ("cache");
    the same outcome in both packages."""
    data = os.urandom(64 << 10)
    sha = hashlib.sha256(data).hexdigest()
    got = {}
    for name in ("jax", "port"):
        transport = _pkg(name)[1]
        srv = _Peer(delay_s=0.4)
        srv.blobs[sha] = data
        results = []
        try:
            threads = [threading.Thread(target=lambda: results.append(
                transport.fetch_blob_from(srv.addr, sha, len(data),
                                          str(tmp_path / name))))
                for _ in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
            got[name] = (srv.blob_gets,
                         sorted(s == srv.addr for _p, s, _m in results),
                         sorted(src for _p, src, _m in results
                                if src != srv.addr),
                         [m for _p, _s, m in results])
            for path, _s, _m in results:
                assert open(path, "rb").read() == data
        finally:
            srv.close()
    assert got["port"] == got["jax"]
    assert got["port"][0] == 1 and got["port"][2] == ["cache"] * 3


def test_poisoned_peer_falls_back_to_router(tmp_path):
    """A dead peer costs one bounded miss, a poisoned one (right size,
    wrong bytes) is refused by the sha, and the router serves."""
    data = os.urandom(32 << 10)
    sha = hashlib.sha256(data).hexdigest()
    got = {}
    for name in ("jax", "port"):
        transport = _pkg(name)[1]
        router, poisoned = _Peer(), _Peer()
        router.blobs[sha] = data
        poisoned.blobs[sha] = b"p" * len(data)
        try:
            path, source, misses = transport.fetch_blob_from(
                router.addr, sha, len(data), str(tmp_path / name),
                peers=["127.0.0.1:9", poisoned.addr])
            assert open(path, "rb").read() == data
            got[name] = (source == router.addr, misses)
            # a peer hit skips the router
            peer = _Peer()
            peer.blobs[sha] = data
            try:
                _p, src, m = transport.fetch_blob_from(
                    "127.0.0.1:9", sha, len(data),
                    str(tmp_path / f"{name}-hit"), peers=[peer.addr])
                got[name] += (src == peer.addr, m)
            finally:
                peer.close()
            with pytest.raises(transport.BlobError):
                transport.fetch_blob_from(
                    poisoned.addr, sha, len(data),
                    str(tmp_path / f"{name}-bad"), timeout_s=2.0)
        finally:
            router.close()
            poisoned.close()
    assert got["port"] == got["jax"] == (True, 2, True, 0)


def _write_conf(tmp_path, name="tiny", seed=1234):
    from hpnn_tpu.io.kernel_io import dump_kernel_to_path
    from hpnn_tpu.models.kernel import generate_kernel

    kern, _ = generate_kernel(seed, N_IN, [N_HID], N_OUT)
    kpath = str(tmp_path / f"{name}.opt")
    dump_kernel_to_path(kern, kpath)
    conf = tmp_path / f"{name}.conf"
    conf.write_text(f"[name] tiny\n[type] ANN\n[init] {kpath}\n"
                    "[seed] 1\n[train] BP\n")
    return str(conf), kpath


def _fleet(tmp_path, n_workers):
    """A port router and ``n_workers`` port workers with disjoint blob
    dirs; returns (router app, router port, [(app, httpd)...])."""
    from hpnn_tpu_torch.serve.server import ServeApp, serve_in_thread

    conf, _ = _write_conf(tmp_path)
    rapp = ServeApp(max_batch=16, device="cpu")
    rapp.enable_mesh_router(required_workers=n_workers,
                            health_interval_s=0.2)
    assert rapp.add_model(conf) is not None
    rhttpd, _ = serve_in_thread(rapp)
    rport = rhttpd.server_address[1]
    fleet = [(rapp, rhttpd)]
    for i in range(n_workers):
        app = ServeApp(max_batch=16, device="cpu")
        assert app.add_model(conf, warmup=False) is not None
        httpd, _ = serve_in_thread(app)
        app.enable_mesh_worker(f"127.0.0.1:{rport}",
                               f"127.0.0.1:{httpd.server_address[1]}",
                               interval_s=0.3)
        app.mesh_worker.blob_dir = str(tmp_path / f"blobs-w{i}")
        fleet.append((app, httpd))
    deadline = time.monotonic() + 15
    while time.monotonic() < deadline:
        try:
            urllib.request.urlopen(f"http://127.0.0.1:{rport}/healthz")
            break
        except urllib.error.HTTPError:
            time.sleep(0.05)
    return rapp, rport, fleet


def _close_fleet(fleet):
    for app, httpd in reversed(fleet):
        httpd.shutdown()
        httpd.server_close()
        app.close(drain=False)


def _new_kernel(tmp_path, seed):
    from hpnn_tpu.io.kernel_io import dump_kernel_to_path
    from hpnn_tpu.models.kernel import generate_kernel

    k, _ = generate_kernel(seed, N_IN, [N_HID], N_OUT)
    path = str(tmp_path / f"next{seed}.opt")
    dump_kernel_to_path(k, path)
    data = open(path, "rb").read()
    return path, data, hashlib.sha256(data).hexdigest()


def _reload(rport, path):
    req = urllib.request.Request(
        f"http://127.0.0.1:{rport}/v1/kernels/tiny/reload",
        data=json.dumps({"kernel": path}).encode())
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def test_swarm_reload_router_egress_bounded(tmp_path, monkeypatch):
    """A coherent reload seeds K workers from the router and the rest
    pull from peers: the router's blob egress is exactly K x size, every
    worker lands the generation sha-verified, and heartbeats advertise
    the new blob into the who-has index."""
    monkeypatch.setenv("HPNN_MESH_SWARM_SEEDS", "2")
    rapp, rport, fleet = _fleet(tmp_path, 4)
    try:
        path, data, sha = _new_kernel(tmp_path, 4321)
        body = _reload(rport, path)
        assert body["generation"] == 2 and body["mesh"]["workers_failed"] \
            == [] and len(body["mesh"]["workers_reloaded"]) == 4
        assert body["mesh"]["blob"]["sha256"] == sha
        assert all(a.registry.get("tiny").generation == 2 for a, _ in fleet)
        stats = rapp.mesh_router.blobs.stats()
        assert stats["serves_total"] == 2
        assert stats["egress_bytes_total"] == 2 * len(data)
        assert sum(a.mesh_worker.swarm_hits for a, _ in fleet[1:]) == 2
        assert sum(a.mesh_worker.blob_serves for a, _ in fleet[1:]) == 2
        deadline = time.monotonic() + 10
        while len(rapp.mesh_router.holders_of(sha)) < 4 \
                and time.monotonic() < deadline:
            time.sleep(0.1)
        assert len(rapp.mesh_router.holders_of(sha)) == 4
        text = fleet[1][0].metrics.render_prometheus()
        assert "hpnn_mesh_swarm_enabled 1" in text
        assert f"hpnn_mesh_blob_egress_bytes_total {2 * len(data)}" in \
            rapp.metrics.render_prometheus()
    finally:
        _close_fleet(fleet)


def test_swarm_off_is_router_only(tmp_path, monkeypatch):
    monkeypatch.setenv("HPNN_MESH_SWARM", "0")
    rapp, rport, fleet = _fleet(tmp_path, 3)
    try:
        path, data, sha = _new_kernel(tmp_path, 999)
        body = _reload(rport, path)
        assert body["generation"] == 2 and body["mesh"]["workers_failed"] \
            == [] and len(body["mesh"]["workers_reloaded"]) == 3
        stats = rapp.mesh_router.blobs.stats()
        assert stats["serves_total"] == 3
        assert stats["egress_bytes_total"] == 3 * len(data)
        for app, _h in fleet[1:]:
            snap = app.mesh_worker.swarm_snapshot()
            assert snap["enabled"] is False
            assert snap["hits"] == snap["misses"] == snap["fallbacks"] \
                == snap["blob_serves"] == 0
        assert all(not w.blobs or sha not in w.blobs
                   for w in rapp.mesh_router.pool.workers())
    finally:
        _close_fleet(fleet)


# --- durable writes under injected faults ----------------------------------

def _bundle(ckpt, ck, epochs, seed=5):
    from hpnn_tpu.models.kernel import generate_kernel

    k, _ = generate_kernel(seed, N_IN, [N_HID], N_OUT)
    for ep in range(1, epochs + 1):
        entry = ckpt.write_snapshot(ck, ep, weights=k.weights,
                                    momentum=None, rng_state=None,
                                    seed=seed, errors=[0.5 / ep] * ep)
        ckpt.publish_snapshot(ck, entry, seed=seed, errors=[0.5 / ep] * ep)
    return k


def _io_fault_run(name, tmp_path):
    if name == "jax":
        from hpnn_tpu import ckpt
        from hpnn_tpu.io.atomic import atomic_write_bytes
    else:
        from hpnn_tpu_torch import ckpt
        from hpnn_tpu_torch.io.atomic import atomic_write_bytes
    chaos = _pkg(name)[0]
    root = tmp_path / name
    root.mkdir()
    out = []
    dest = str(root / "out.bin")
    atomic_write_bytes(dest, b"good")
    chaos.configure("enospc@out.bin:times=1")
    try:
        atomic_write_bytes(dest, b"new")
        out.append("no error")
    except OSError as exc:
        out.append(type(exc).__name__)
    out.append(open(dest, "rb").read())
    atomic_write_bytes(dest, b"new")
    out.append(open(dest, "rb").read())
    # ENOSPC on a bundle file: the writer retries and the bundle verifies
    chaos.configure("enospc@state.npz:times=1")
    ck = str(root / "ck")
    k = _bundle(ckpt, ck, 2)
    out.append((chaos.stats()["injected_total"],
                ckpt.verify_bundle(os.path.join(ck, "ep00000001"))[0]))
    # every attempt torn: the write fails, nothing is published, the
    # manifest stays as it was
    man = ckpt.read_manifest(ck)
    chaos.configure("torn@state.npz")
    try:
        ckpt.write_snapshot(ck, 3, weights=k.weights, momentum=None,
                            rng_state=None, seed=5, errors=[0.1])
        out.append("published")
    except OSError:
        out.append("refused")
    chaos.reset()
    after = ckpt.read_manifest(ck)
    out.append((after["generation"] == man["generation"], after["latest"],
                sorted(t for t in os.listdir(ck) if t.startswith("ep"))))
    # a disk that flips bits on every manifest write: the retries run out
    # with the previous manifest still published
    before = open(os.path.join(ck, "manifest.json"), "rb").read()
    entry = ckpt.write_snapshot(ck, 3, weights=k.weights, momentum=None,
                                rng_state=None, seed=5, errors=[0.1] * 3)
    chaos.configure("bitflip@manifest.json")
    try:
        ckpt.publish_snapshot(ck, entry, seed=5, errors=[0.1] * 3)
        out.append("published")
    except OSError:
        out.append("refused")
    chaos.reset()
    out.append((open(os.path.join(ck, "manifest.json"), "rb").read()
                == before, any(".stage" in n for n in os.listdir(ck))))
    return out


def test_io_fault_hook_enospc_retries_and_torn_never_publishes(
        tmp_path, monkeypatch):
    monkeypatch.setenv("HPNN_CKPT_RETRY_BACKOFF_S", "0.001")
    got = {name: _io_fault_run(name, tmp_path) for name in ("jax", "port")}
    assert got["port"] == got["jax"]
    assert got["port"][:3] == ["OSError", b"good", b"new"]
    assert got["port"][3] == (1, True) and got["port"][4] == "refused"
    assert got["port"][5] == (True, "ep00000002",
                              ["ep00000001", "ep00000002"])
    assert got["port"][6:] == ["refused", (True, False)]


def test_io_fault_hook_is_a_no_import_noop_when_unarmed():
    """Unarmed, the hook returns the payload and imports nothing of the
    serve stack (checked in a fresh interpreter)."""
    import subprocess
    import sys

    code = ("import sys\n"
            "from hpnn_tpu_torch.io.atomic import io_fault_hook\n"
            "assert io_fault_hook('p', b'x') == b'x'\n"
            "assert not any(m.startswith('hpnn_tpu_torch.serve')\n"
            "               for m in sys.modules), 'serve imported'\n")
    env = {k: v for k, v in os.environ.items() if k != "HPNN_FAULT"}
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=60)
    assert res.returncode == 0, res.stderr


# --- replication to a mesh router --------------------------------------------

def _router(pkg, **kw):
    if pkg == "port":
        from hpnn_tpu_torch.serve.server import ServeApp, serve_in_thread

        app = ServeApp(max_batch=8, device="cpu", **kw)
        app.enable_mesh_router(required_workers=1)
        httpd, _ = serve_in_thread(app)
    else:
        from hpnn_tpu.serve.server import ServeApp, serve_in_thread

        app = ServeApp(max_batch=8, **kw)
        app.enable_mesh_router(required_workers=1)
        httpd, _ = serve_in_thread("127.0.0.1", 0, app)
    return app, httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def _stop(app, httpd):
    httpd.shutdown()
    httpd.server_close()
    app.close()


@pytest.mark.parametrize("shipper,router", [("port", "port"),
                                            ("port", "jax"),
                                            ("jax", "port")])
def test_router_replication_roundtrip_over_http(tmp_path, monkeypatch,
                                                shipper, router):
    """Bundles shipped to a router land in its blob store and durable
    spool; the index lists them and a restore pulls the newest back
    through GET /v1/mesh/blob/<sha> -- from a restarted router too (cold
    memory, warm spool).  Either package ships to either's router."""
    if shipper == "port":
        from hpnn_tpu_torch import ckpt
        from hpnn_tpu_torch.ckpt import replicate
    else:
        from hpnn_tpu import ckpt
        from hpnn_tpu.ckpt import replicate
    monkeypatch.setenv("HPNN_MESH_BUNDLE_DIR", str(tmp_path / "spool"))
    ck = str(tmp_path / "ck")
    _bundle(ckpt, ck, 2)
    app, httpd, dest = _router(router)
    try:
        rep = replicate.Replicator(dest, ck)
        for e in (1, 2):
            meta = rep.replicate(os.path.join(ck, f"ep0000000{e}"))
            assert meta is not None
        idx = replicate.list_replicated(dest, rep.scope)
        assert [e["tag"] for e in idx] == ["ep00000001", "ep00000002"]
        out = replicate.restore_bundle(dest, rep.scope,
                                       str(tmp_path / "recovered"))
        assert out is not None and out.endswith("ep00000002")
        assert ckpt.verify_bundle(out)[0]
        scope = rep.scope
    finally:
        _stop(app, httpd)
    app2, httpd2, dest2 = _router(router)
    try:
        idx = replicate.list_replicated(dest2, scope)
        assert [e["tag"] for e in idx] == ["ep00000001", "ep00000002"]
        out = replicate.restore_bundle(dest2, scope,
                                       str(tmp_path / "recovered2"))
        assert out is not None and ckpt.verify_bundle(out)[0]
    finally:
        _stop(app2, httpd2)


def test_router_bundle_endpoint_requires_auth_when_configured(
        tmp_path, monkeypatch):
    from hpnn_tpu_torch import ckpt
    from hpnn_tpu_torch.ckpt import replicate
    from hpnn_tpu_torch.utils import nn_log

    monkeypatch.setenv("HPNN_MESH_BUNDLE_DIR", str(tmp_path / "spool"))
    monkeypatch.delenv("HPNN_SERVE_TOKEN", raising=False)
    ck = str(tmp_path / "ck")
    _bundle(ckpt, ck, 1)
    app, httpd, dest = _router("port", auth_token="sekrit")
    try:
        bad = replicate.Replicator(dest, ck, auth_token="wrong",
                                   attempts=1)
        with nn_log.capture():
            assert bad.replicate(os.path.join(ck, "ep00000001")) is None
        good = replicate.Replicator(dest, ck, auth_token="sekrit")
        assert good.replicate(os.path.join(ck, "ep00000001")) is not None
        with pytest.raises(replicate.ReplicateError):
            replicate.list_replicated(dest, good.scope)
        assert len(replicate.list_replicated(dest, good.scope,
                                             auth_token="sekrit")) == 1
        # HPNN_SERVE_TOKEN is the default credential of both sides
        monkeypatch.setenv("HPNN_SERVE_TOKEN", "sekrit")
        assert replicate.restore_bundle(dest, good.scope,
                                        str(tmp_path / "r")) is not None
    finally:
        _stop(app, httpd)


def test_train_nn_replicate_to_router_and_resume_after_local_loss(
        tmp_path, monkeypatch):
    """``train_nn --replicate-to http://router``: every bundle lands on
    the router; with the local checkpoint dir deleted, ``--resume``
    restores the newest replica from the router and finishes with the
    kernel.opt of an uninterrupted run."""
    from test_torch_ckpt import _make_case, _train

    monkeypatch.setenv("HPNN_MESH_BUNDLE_DIR", str(tmp_path / "spool"))
    conf = _make_case(str(tmp_path / "case"), "ANN-BP")
    app, httpd, dest = _router("port")
    try:
        base = ["-v", "-v", "--ckpt-every", "1", "--ckpt-dir", "ck"]
        full = _train("port", [*base, "--epochs", "3", conf],
                      str(tmp_path / "full"))
        assert full["rc"] == 0, full["err"]
        cwd = str(tmp_path / "run")
        part = _train("port", [*base, "--epochs", "2", "--replicate-to",
                               dest, conf], cwd)
        assert part["rc"] == 0, part["err"]
        assert "replication of" not in part["out"]
        scopes = app.mesh_router.bundle_stats()
        assert scopes["scopes"] == 1 and scopes["bundles"] == 2
        shutil.rmtree(os.path.join(cwd, "ck"))
        res = _train("port", [*base, "--epochs", "3", "--resume",
                              "--replicate-to", dest, conf], cwd)
        assert res["rc"] == 0, res["err"]
        assert os.path.isdir(os.path.join(cwd, "ck", "ep00000002"))
        assert res["opt"] == full["opt"]
        assert app.mesh_router.bundle_stats()["bundles"] == 3
    finally:
        _stop(app, httpd)
