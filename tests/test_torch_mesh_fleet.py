"""Fleet observability of the port's serve mesh
(``hpnn_tpu_torch/serve/mesh/fleet.py``, ``events.py`` and the fleet
half of ``serve/metrics.py``) held to ``hpnn_tpu`` on the same inputs.

A scripted stub worker (a trace ring and a metrics snapshot over HTTP)
feeds both packages' ``FleetObserver``: the collector's cursor, its
restart rewind and ring-id restart, the merged trace after the worker
dies, and the truncation markers must come out the same.
``fleet_rollup`` and the federated Prometheus text are compared on the
same worker snapshots (hostile names, a dead worker's gap), the mesh
lifecycle lines byte for byte in text mode, and a live router's
``?fleet=1`` and merged trace end to end.
"""

import json
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
from test_obs import lint_prometheus

N_IN, N_HID, N_OUT = 8, 6, 3


def _both():
    import hpnn_tpu.obs as jobs_
    import hpnn_tpu.serve.mesh.fleet as jfleet
    import hpnn_tpu.serve.mesh.router as jrouter
    import hpnn_tpu.serve.metrics as jmetrics
    import hpnn_tpu.utils.nn_log as jlog
    import hpnn_tpu_torch.obs as pobs
    import hpnn_tpu_torch.serve.mesh.fleet as pfleet
    import hpnn_tpu_torch.serve.mesh.router as prouter
    import hpnn_tpu_torch.serve.metrics as pmetrics
    import hpnn_tpu_torch.utils.nn_log as plog

    return {"jax": types_ns(obs=jobs_, fleet=jfleet, router=jrouter,
                            metrics=jmetrics, log=jlog),
            "port": types_ns(obs=pobs, fleet=pfleet, router=prouter,
                             metrics=pmetrics, log=plog)}


def types_ns(**kw):
    import types

    return types.SimpleNamespace(**kw)


@pytest.fixture(autouse=True)
def _obs_reset():
    """Tracing off, role cleared, verbosity 0 in both packages around
    every test (their recorders and consoles are process-global)."""
    def reset():
        for ns in _both().values():
            ns.obs.disable()
            ns.obs.trace.set_role(None)
            ns.obs.trace.set_sample_rate(None)
            ns.obs.trace.set_exporter(None)
            ns.log.set_verbosity(0)

    reset()
    yield
    reset()


class _StubHandler(BaseHTTPRequestHandler):
    def log_message(self, fmt, *args):
        pass

    def do_GET(self):
        cfg = self.server.cfg
        path, _, query = self.path.partition("?")
        params = dict(kv.split("=", 1) for kv in query.split("&")
                      if "=" in kv)
        if path == "/healthz":
            self._send(200, b'{"status": "ok"}', "application/json")
            return
        if path == "/v1/debug/trace":
            since = int(params.get("since_seq", "0"))
            cfg["seen_since"].append(since)
            spans = [s for s in cfg["spans"] if s["seq"] > since]
            body = "".join(json.dumps(s) + "\n" for s in spans).encode()
            last = max((s["seq"] for s in cfg["spans"]), default=0)
            headers = {"X-HPNN-Trace-Seq": str(last)}
            if cfg.get("ring"):
                headers["X-HPNN-Trace-Ring"] = cfg["ring"]
            self._send(200, body, "application/x-ndjson", headers)
            return
        if path == "/metrics":
            self._send(200, json.dumps(cfg["metrics"]).encode(),
                       "application/json")
            return
        self._send(404, b"{}", "application/json")

    def _send(self, status, body, ctype, headers=None):
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)


def _stub_worker(spans=None, metrics=None):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _StubHandler)
    httpd.daemon_threads = True
    httpd.cfg = {"spans": spans or [], "metrics": metrics or {},
                 "seen_since": []}
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd.cfg, httpd, f"127.0.0.1:{httpd.server_address[1]}"


def _mk_span(seq, trace="t-fleet", name="device_launch", parent=None):
    return {"name": name, "trace": trace, "span": f"stub{seq:08x}",
            "parent": parent, "ts": 1000.0 + seq, "dur_s": 0.001,
            "thread": "w", "seq": seq}


def _worker_metrics(ok=10, rows=30, kernel="tiny", gen=1,
                    lat_counts=None, lat_n=0, lat_sum=0.0):
    return {
        "requests": {"ok": ok, "error": 0},
        "rows_total": rows, "batches_total": ok,
        "reloads": {"ok": 0, "error": 0},
        "queue_depth": {kernel: 0},
        "models": {kernel: {"generation": gen,
                            "last_reload_ts": 1700000000.0}},
        "latency": {"count": lat_n, "sum_seconds": lat_sum,
                    "p50_ms": 1.0, "p99_ms": 2.0,
                    "counts": lat_counts or {}},
        "device_time": {"count": 0, "sum_seconds": 0.0, "p50_ms": 0.0,
                        "p99_ms": 0.0, "counts": {}},
    }


def _collector_script(ns, mk_stub):
    """The JAX tests' collector sequence against one package's
    FleetObserver; returns the observable trace."""
    out = []
    cfg, httpd, addr = mk_stub()
    pool = ns.router.WorkerPool(eject_after=2)
    pool.register(addr)
    fleet = ns.fleet.FleetObserver(pool, poll_interval_s=3600, capacity=64)
    mask = ("host",)
    try:
        cfg["spans"][:] = [_mk_span(1), _mk_span(2)]
        cfg["seen_since"][:] = []
        out.append(fleet.drain_once())
        out.append(fleet.drain_once())
        cfg["spans"].append(_mk_span(3))
        out.append(fleet.drain_once())
        # restart: the seq rewinds below the cursor
        cfg["spans"][:] = [_mk_span(1, trace="t-new")]
        out.append(fleet.drain_once())
        # ring-id restart that already out-ran the cursor
        cfg["ring"] = "ring-aaaa"
        cfg["spans"][:] = [_mk_span(i) for i in range(1, 6)]
        out.append(fleet.drain_once())
        cfg["ring"] = "ring-bbbb"
        cfg["spans"][:] = [_mk_span(i, trace="t-post")
                           for i in range(1, 9)]
        out.append(fleet.drain_once())
        out.append(list(cfg["seen_since"]))
        out.append([{k: v for k, v in s.items() if k not in mask}
                    for s in fleet.collected_spans()])
        st = fleet.stats()
        out.append({k: v for k, v in st.items()
                    if not isinstance(v, float)})
        # a bounded store: past capacity it evicts and says so
        cfg["ring"] = "ring-cccc"
        cfg["spans"][:] = [_mk_span(i) for i in range(1, 101)]
        out.append(fleet.drain_once())
        merged = fleet.merged_spans(drain=False)
        out.append({k: v for k, v in merged[-1].items()
                    if k not in ("host", "dropped_by_host", "span",
                                 "thread")})
        out.append(list(merged[-1]["dropped_by_host"].values()))
        lim = fleet.merged_spans(drain=False, limit=4)
        out.append((len(lim), lim[-1]["name"], lim[-1]["dropped_limit"]))
        # a dead worker keeps its collected window; a removed one not
        httpd.shutdown()
        w = pool.workers()[0]
        pool.report_failure(w, ConnectionRefusedError("gone"))
        fleet.drain_once()
        out.append((fleet.stats()["workers_tracked"],
                    len(fleet.collected_spans())))
        pool.remove(addr)
        fleet.drain_once()
        out.append((fleet.stats()["workers_tracked"],
                    fleet.collected_spans()))
    finally:
        httpd.server_close()
        pool.close()
    return out


def test_fleet_collector_cursor_rewind_and_ring_restart_match_jax():
    got = {pkg: _collector_script(ns, _stub_worker)
           for pkg, ns in _both().items()}
    assert got["port"] == got["jax"]
    p = got["port"]
    # a first-seen ring id is no restart: 4 spans past the cursor of 1
    assert p[:6] == [2, 0, 1, 1, 4, 8]
    assert p[6][:3] == [0, 2, 2]
    assert p[-2] == (1, 64) and p[-1] == (0, [])


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_fleet_merged_trace_survives_dead_worker(pkg):
    """The merged view holds the router's spans (role=router) and the
    worker's (host- and role-tagged); killing the worker keeps its
    collected spans queryable."""
    ns = _both()[pkg]
    ns.obs.enable(capacity=64)
    cfg, httpd, addr = _stub_worker(spans=[
        _mk_span(1, name="serve.request"),
        _mk_span(2, name="device_launch")])
    pool = ns.router.WorkerPool(eject_after=2)
    pool.register(addr)
    fleet = ns.fleet.FleetObserver(pool, poll_interval_s=3600, capacity=64)
    try:
        t0 = time.monotonic()
        ns.obs.record("mesh.route", t0, t0 + 0.01, trace_id="t-fleet",
                      worker=addr)
        merged = fleet.merged_spans(trace_id="t-fleet")
        by_name = {s["name"]: s for s in merged}
        assert set(by_name) == {"mesh.route", "serve.request",
                                "device_launch"}
        assert by_name["mesh.route"]["role"] == "router"
        assert by_name["mesh.route"]["host"] == fleet.host
        assert by_name["device_launch"]["role"] == "worker"
        assert by_name["device_launch"]["host"] == addr
        httpd.shutdown()
        w = pool.workers()[0]
        pool.report_failure(w, ConnectionRefusedError("gone"))
        assert w.state == "dead"
        assert {s["name"] for s in fleet.merged_spans(
            trace_id="t-fleet")} == set(by_name)
        assert len(fleet.merged_dump(trace_id="t-fleet").splitlines()) == 3
    finally:
        httpd.server_close()
        pool.close()


def _workers():
    evil = 'k"er\\nal\n2'
    return {"127.0.0.1:9001": _worker_metrics(
                ok=10, rows=30, gen=2, lat_counts={"5": 8, "10": 2},
                lat_n=10, lat_sum=0.05),
            "127.0.0.1:9002": _worker_metrics(
                ok=7, rows=21, kernel=evil, gen=3,
                lat_counts={"5": 3, "20": 4}, lat_n=7, lat_sum=0.2),
            "127.0.0.1:9003": None}


def test_fleet_rollup_equals_jax():
    from hpnn_tpu.serve.metrics import LatencyHistogram as JHist
    from hpnn_tpu_torch.serve.metrics import LatencyHistogram as PHist

    got = {pkg: ns.metrics.fleet_rollup(_workers())
           for pkg, ns in _both().items()}
    assert got["port"] == got["jax"]
    roll = got["port"]
    assert roll["workers_polled"] == 3 and roll["workers_up"] == 2
    assert roll["requests"]["ok"] == 17 and roll["rows_total"] == 51
    assert roll["latency"]["counts"] == {"5": 11, "10": 2, "20": 4}
    old = {"count": 5, "sum_seconds": 0.01, "p50_ms": 1.0, "p99_ms": 2.0}
    assert PHist.merge_snapshots([old]) == JHist.merge_snapshots([old])
    assert PHist.percentile_from_counts({}, 17, 99) == 0.0


def test_federated_prometheus_lints_with_hostile_names_and_gap():
    """The federated text lints (hostile kernel names escaped, a dead
    worker contributing only its up=0 gap), and its fleet families and
    samples are the JAX package's."""
    texts = {}
    for pkg, ns in _both().items():
        m = ns.metrics.ServeMetrics()
        m.count_request("ok")
        m.latency.observe(0.01)
        texts[pkg] = m.render_fleet_prometheus(_workers())
    series = lint_prometheus(texts["port"])
    dead = [(n, labels) for n, labels in series
            if ("worker", "127.0.0.1:9003") in labels
            and n != "hpnn_fleet_worker_up"]
    assert dead == []
    assert 'hpnn_fleet_worker_up{worker="127.0.0.1:9003"} 0' in \
        texts["port"]

    def fleet_part(text):
        return text[text.index("# HELP hpnn_fleet_worker_up"):]

    assert fleet_part(texts["port"]) == fleet_part(texts["jax"])


def test_lifecycle_console_lines_byte_identical_in_text_mode(capsys):
    """Register, eject, readmit, retire and remove print the JAX
    package's console lines byte for byte in text mode; under
    HPNN_LOG_JSON=1 they are ``mesh_*`` events and, with tracing on,
    recorder spans under the ``mesh`` trace id."""
    outs = {}
    for pkg, ns in _both().items():
        ns.log.set_verbosity(2)
        pool = ns.router.WorkerPool(eject_after=1)
        try:
            w = pool.register("127.0.0.1:7002")
            pool.report_failure(w, ConnectionRefusedError("boom"))
            pool.report_ok(w)
            pool.retire("127.0.0.1:7002", via="goodbye")
            pool.remove("127.0.0.1:7002")
            outs[pkg] = capsys.readouterr().out
        finally:
            pool.close()
            ns.log.set_verbosity(0)
    assert outs["port"] == outs["jax"]
    assert "NN: mesh: worker 127.0.0.1:7002 registered\n" in outs["port"]
    assert ("NN(WARN): mesh: worker 127.0.0.1:7002 ejected "
            "(ConnectionRefusedError: boom)\n") in outs["port"]


def test_lifecycle_events_json_and_recorder(monkeypatch, capsys):
    monkeypatch.setenv("HPNN_LOG_JSON", "1")
    got = {}
    for pkg, ns in _both().items():
        ns.obs.enable(capacity=64)
        pool = ns.router.WorkerPool(eject_after=1)
        try:
            w = pool.register("127.0.0.1:7001")
            pool.report_failure(w, ConnectionRefusedError("boom"))
            pool.report_ok(w)
            spans = ns.obs.snapshot(trace_id="mesh")
            events = [json.loads(ln)
                      for ln in capsys.readouterr().out.splitlines()
                      if '"event"' in ln]
            got[pkg] = ([s["name"] for s in spans],
                        [{k: v for k, v in s.items()
                          if k in ("worker", "via", "error")}
                         for s in spans],
                        [e["event"] for e in events])
        finally:
            pool.close()
            ns.obs.disable()
    assert got["port"] == got["jax"]
    assert got["port"][0] == ["mesh.worker_registered",
                              "mesh.worker_ejected",
                              "mesh.worker_readmitted"]


def test_worker_heartbeat_advertises_jobs(tmp_path):
    """A worker with the jobs service advertises its running job and the
    job's trace id in the heartbeat; the router's worker table shows it,
    as the JAX package's does."""
    from hpnn_tpu_torch.serve.server import ServeApp, serve_in_thread

    for ns in _both().values():
        pool = ns.router.WorkerPool(eject_after=2)
        try:
            pool.register("127.0.0.1:7003", {"tiny": {"generation": 1}},
                          jobs={"running": "job-000001",
                                "trace": "job:job-000001", "queued": 0})
            assert pool.table()["127.0.0.1:7003"]["jobs"]["trace"] == \
                "job:job-000001"
        finally:
            pool.close()
    conf = _write_conf(tmp_path)
    rapp = ServeApp(max_batch=8, device="cpu")
    rapp.enable_mesh_router(required_workers=1, health_interval_s=0.2)
    assert rapp.add_model(conf) is not None
    rhttpd, _ = serve_in_thread(rapp)
    wapp = ServeApp(max_batch=8, device="cpu")
    assert wapp.add_model(conf, warmup=False) is not None
    wapp.enable_jobs(str(tmp_path / "jobs"), capacity=2)
    whttpd, _ = serve_in_thread(wapp)
    try:
        from hpnn_tpu_torch.serve.mesh.worker import WorkerAgent

        agent = WorkerAgent(wapp, f"127.0.0.1:{rhttpd.server_address[1]}",
                            f"127.0.0.1:{whttpd.server_address[1]}",
                            interval_s=0.3)
        assert agent.beat()
        row = next(iter(rapp.mesh_router.pool.table().values()))
        assert row["jobs"] == {"running": None, "trace": None,
                               "running_jobs": [], "queued": 0}
        assert wapp.jobs.active() == row["jobs"]
    finally:
        for h, a in ((whttpd, wapp), (rhttpd, rapp)):
            h.shutdown()
            h.server_close()
            a.close(drain=True)


def _write_conf(tmp_path, name="tiny", seed=1234):
    from hpnn_tpu.io.kernel_io import dump_kernel_to_path
    from hpnn_tpu.models.kernel import generate_kernel

    kern, _ = generate_kernel(seed, N_IN, [N_HID], N_OUT)
    kpath = str(tmp_path / f"{name}.opt")
    dump_kernel_to_path(kern, kpath)
    conf = tmp_path / f"{name}.conf"
    conf.write_text(f"[name] {name}\n[type] ANN\n[init] {kpath}\n"
                    "[seed] 1\n[train] BP\n")
    return str(conf)


def test_router_fleet_metrics_and_merged_trace_e2e(tmp_path):
    """A live port router over two port workers: ``?fleet=1`` JSON has a
    snapshot per worker and a rollup equal to fleet_rollup of them, the
    federated text lints, and the router's /v1/debug/trace is the merged
    route -> worker -> device tree, which outlives a killed worker."""
    from hpnn_tpu_torch.obs import trace as obs_trace
    from hpnn_tpu_torch.serve.metrics import fleet_rollup
    from hpnn_tpu_torch.serve.server import ServeApp, serve_in_thread

    conf = _write_conf(tmp_path)
    obs_trace.enable()
    rapp = ServeApp(max_batch=16, device="cpu")
    rapp.enable_mesh_router(required_workers=2, health_interval_s=0.2)
    assert rapp.add_model(conf) is not None
    rhttpd, _ = serve_in_thread(rapp)
    rport = rhttpd.server_address[1]
    base = f"http://127.0.0.1:{rport}"
    workers = []
    try:
        for _ in range(2):
            w = ServeApp(max_batch=16, device="cpu")
            assert w.add_model(conf, warmup=False) is not None
            h, _ = serve_in_thread(w)
            w.enable_mesh_worker(f"127.0.0.1:{rport}",
                                 f"127.0.0.1:{h.server_address[1]}",
                                 interval_s=0.3)
            workers.append((h, w))
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline:
            try:
                urllib.request.urlopen(base + "/healthz")
                break
            except urllib.error.HTTPError:
                time.sleep(0.05)
        for i in range(4):
            req = urllib.request.Request(
                base + "/v1/kernels/tiny/infer",
                data=json.dumps({"inputs": np.zeros(
                    (1 + i, N_IN)).tolist()}).encode(),
                headers={"X-HPNN-Trace-Id": f"fleet{i}"})
            assert urllib.request.urlopen(req).status == 200
        snap = json.loads(urllib.request.urlopen(
            base + "/metrics?fleet=1&format=json").read())
        assert set(snap) == {"router", "workers", "rollup"}
        assert len(snap["workers"]) == 2
        assert snap["rollup"] == fleet_rollup(snap["workers"])
        assert snap["rollup"]["requests"]["ok"] == 4
        text = urllib.request.urlopen(base + "/metrics?fleet=1").read()
        lint_prometheus(text.decode())
        rapp.mesh_router.fleet.drain_once()
        dump = urllib.request.urlopen(
            base + "/v1/debug/trace?trace=fleet0").read().decode()
        spans = [json.loads(ln) for ln in dump.splitlines()]
        # in one process the router's ring is also the workers', so its
        # spans come back host-tagged as collected ones
        assert {"serve.request", "mesh.route", "device_launch"} <= \
            {s["name"] for s in spans}
        assert ("device_launch", "worker") in \
            {(s["name"], s["role"]) for s in spans}
        # a worker dies: what was collected stays in the merged view
        h, w = workers.pop()
        h.shutdown()
        h.abort_connections()
        h.server_close()
        w.close(drain=False)
        dump2 = urllib.request.urlopen(
            base + "/v1/debug/trace?trace=fleet0").read().decode()
        assert len(dump2.splitlines()) == len(spans)
        local = urllib.request.urlopen(
            base + "/v1/debug/trace?trace=fleet0&local=1").read().decode()
        assert all(json.loads(ln).get("role") != "worker"
                   for ln in local.splitlines())
        search = json.loads(urllib.request.urlopen(
            base + "/v1/debug/trace/search?limit=10").read())
        assert {"fleet0", "fleet3"} <= {r["trace"]
                                        for r in search["traces"]}
    finally:
        obs_trace.disable()
        for h, w in workers:
            h.shutdown()
            h.server_close()
            w.close(drain=True)
        rhttpd.shutdown()
        rhttpd.server_close()
        rapp.close(drain=True)
