"""The port's jobs service (``hpnn_tpu_torch.jobs`` and the job endpoints
of ``hpnn_tpu_torch.serve``) held against the JAX package on the CPU:
the units.

Every case runs the same operations, on the same seeded corpora and
kernels, through ``hpnn_tpu.jobs``/``hpnn_tpu.serve`` and through the port
(``device="cpu"``) and compares what comes out: job records (ids,
statuses, params; paths and timestamps masked), HTTP statuses and error
bodies, slice placements, metrics.  The net is the JAX tests' 8-6-3; the
helpers here are shared with ``test_torch_jobs_e2e.py`` and
``test_torch_jobs_upload.py``, which train."""

import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

N_IN, N_HID, N_OUT = 8, 6, 3
PKGS = ("jax", "port")
TIMES = ("created", "started", "finished", "lease_expires")


def mods(pkg):
    """(jobs, server, metrics, placement) of one package."""
    if pkg == "jax":
        from hpnn_tpu import jobs
        from hpnn_tpu.jobs import placement
        from hpnn_tpu.serve import metrics, server
    else:
        from hpnn_tpu_torch import jobs
        from hpnn_tpu_torch.jobs import placement
        from hpnn_tpu_torch.serve import metrics, server
    return jobs, server, metrics, placement


def write_corpus(dirpath, seed, n, boost=2.0):
    """The JAX tests' separable corpus: class i % 3 gets ``boost`` on its
    input, targets +-1."""
    os.makedirs(dirpath, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        cls = i % N_OUT
        x = rng.uniform(-1, 1, N_IN)
        x[cls] += boost
        t = -np.ones(N_OUT)
        t[cls] = 1.0
        with open(os.path.join(dirpath, f"s{i:03d}"), "w") as fp:
            fp.write(f"[input] {N_IN}\n")
            fp.write(" ".join(f"{v:7.5f}" for v in x) + "\n")
            fp.write(f"[output] {N_OUT}\n")
            fp.write(" ".join(f"{v:.1f}" for v in t) + "\n")
    return str(dirpath)


def sample_text(i):
    rng = np.random.default_rng(100 + i)
    x = rng.uniform(-1, 1, N_IN)
    x[i % N_OUT] += 2.0
    t = -np.ones(N_OUT)
    t[i % N_OUT] = 1.0
    return (f"[input] {N_IN}\n" + " ".join(f"{v:7.5f}" for v in x)
            + f"\n[output] {N_OUT}\n" + " ".join(f"{v:.1f}" for v in t)
            + "\n")


def serve_conf(tmp_path, name="tiny", kind="ANN", seed=1234):
    """A conf serving a generated-then-dumped 8-6-3 kernel (jobs generate
    their own from the submit's seed); ``kind`` "LNN" is the native
    linear head."""
    from hpnn_tpu_torch.io.kernel_io import dump_kernel_to_path
    from hpnn_tpu_torch.models.kernel import generate_kernel

    kern, _ = generate_kernel(seed, N_IN, [N_HID], N_OUT)
    kpath = str(tmp_path / f"{name}.opt")
    dump_kernel_to_path(kern, kpath)
    lnn = "[lnn] native\n" if kind == "LNN" else ""
    conf = tmp_path / f"{name}.conf"
    conf.write_text(f"[name] {name}\n[type] {kind}\n{lnn}[init] {kpath}\n"
                    "[seed] 1\n[train] BP\n")
    return str(conf)


def make_app(pkg, conf, warmup=False, **kw):
    if pkg == "port":
        kw.setdefault("device", "cpu")
    app = mods(pkg)[1].ServeApp(**kw)
    assert app.add_model(conf, warmup=warmup) is not None
    return app


def enable_jobs(pkg, app, job_dir, **kw):
    """``app.enable_jobs``; the port's workers place over 8 CPU devices,
    as the JAX package's do over the 8 devices tests/conftest.py gives
    it."""
    if pkg == "port":
        import torch

        kw.setdefault("devices", [torch.device("cpu")] * 8)
    return app.enable_jobs(str(job_dir), **kw)


def serve(pkg, app):
    """Bind on an ephemeral port in a thread: (httpd, base url)."""
    server = mods(pkg)[1]
    if pkg == "jax":
        httpd, _ = server.serve_in_thread("127.0.0.1", 0, app)
    else:
        httpd, _ = server.serve_in_thread(app)
    return httpd, "http://127.0.0.1:%d" % httpd.server_address[1]


def stop(httpd, app):
    httpd.shutdown()
    httpd.server_close()
    app.close(drain=True)


def http(base, path, payload=None, headers=None, data=None):
    """(status, decoded JSON body, headers); HTTP errors decode too."""
    h = dict(headers or {})
    if payload is not None:
        data = json.dumps(payload).encode()
        h.setdefault("Content-Type", "application/json")
    req = urllib.request.Request(base + path, data=data, headers=h)
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read()), dict(exc.headers)


def mp_body(params, files, boundary="hpnnChunkBoundary"):
    """A multipart/form-data body (optional ``params`` JSON field, corpus
    file parts): (bytes, content type)."""
    chunks = []
    if params is not None:
        chunks.append(f'--{boundary}\r\nContent-Disposition: form-data; '
                      f'name="params"\r\n\r\n{json.dumps(params)}\r\n')
    for name, text in files:
        chunks.append(f'--{boundary}\r\nContent-Disposition: form-data; '
                      f'name="corpus"; filename="{name}"\r\n'
                      'Content-Type: application/octet-stream\r\n\r\n'
                      + text + "\r\n")
    chunks.append(f"--{boundary}--\r\n")
    return ("".join(chunks).encode(),
            f"multipart/form-data; boundary={boundary}")


def post_mp(base, path, params, files):
    body, ctype = mp_body(params, files)
    return http(base, path, data=body, headers={"Content-Type": ctype})


def wait_terminal(base, jid, timeout_s=120.0):
    end = time.monotonic() + timeout_s
    while time.monotonic() < end:
        snap = http(base, f"/v1/jobs/{jid}")[1]
        if snap["status"] in ("done", "failed", "cancelled",
                              "interrupted"):
            return snap
        time.sleep(0.02)
    raise AssertionError(f"job {jid} did not finish: {snap}")


def mask(rec, roots=()):
    """A job record with its timestamps zeroed and each of ``roots``
    (package-specific directories) replaced by ``<root>``, so the two
    packages' records compare equal."""
    text = json.dumps(rec, sort_keys=True)
    for root in roots:
        text = text.replace(str(root), "<root>")

    def walk(v):
        if isinstance(v, dict):
            return {k: 0.0 if k in TIMES else walk(x) for k, x in v.items()}
        if isinstance(v, list):
            return [walk(x) for x in v]
        return v
    return walk(json.loads(text))


@pytest.fixture(autouse=True)
def _quiet():
    from hpnn_tpu.utils import nn_log as jlog
    from hpnn_tpu_torch.utils import nn_log as plog

    for m in (jlog, plog):
        m.set_verbosity(0)
    yield
    for m in (jlog, plog):
        m.set_verbosity(0)


# --- store, queue, multipart ----------------------------------------------

def test_job_store_persistence_and_recovery(tmp_path):
    got = {}
    for pkg in PKGS:
        root = tmp_path / pkg
        store = mods(pkg)[0].JobStore(str(root))
        a = store.create("k", {"epochs": 2, "samples": "/x"})
        b = store.create("k", {"epochs": 1, "samples": "/y"})
        store.update(a, status="done", epoch=2, errors=[0.5, 0.25])
        store.update(b, status="running", epoch=1)
        # a fresh store (a restarted server) reports the history and
        # recovers the job that was active
        store2 = mods(pkg)[0].JobStore(str(root))
        listing = store2.list()
        recovered = store2.recover()
        c = store2.create("k", {})
        got[pkg] = (mask(listing, [root]), recovered,
                    store2.get("job-000002").status, c.job_id,
                    store2.by_status(), store2.trained_epochs(),
                    mask(store2.list(), [root]),
                    sorted(os.listdir(root / "job-000001")))
    assert got["port"] == got["jax"]
    assert got["port"][1] == ["job-000002"]
    assert got["port"][4] == {"done": 1, "interrupted": 1, "queued": 1}


def test_job_queue_bounded_fifo():
    got = {}
    for pkg in PKGS:
        jobs = mods(pkg)[0]
        q = jobs.JobQueue(capacity=2)
        js = [jobs.JobState(job_id=f"j{i}", kernel="k", params={},
                            path="/tmp") for i in range(3)]
        q.submit(js[0])
        q.submit(js[1])
        out = []
        try:
            q.submit(js[2])
        except jobs.JobQueueFull as exc:
            out.append(str(exc))
        out += [q.depth(), q.remove("j1"), q.remove("j1")]
        q.requeue_front(js[2])
        out += [q.take(timeout_s=0.0).job_id, q.take(timeout_s=0.0).job_id,
                q.take(timeout_s=0.0)]
        q.close()
        try:
            q.submit(js[1])
        except jobs.JobQueueFull as exc:
            out.append(str(exc))
        got[pkg] = out
    assert got["port"] == got["jax"]
    assert got["port"][-1] == "job queue closed (server draining)"


def test_multipart_parse_roundtrip():
    body, ctype = mp_body({"epochs": 2, "seed": 9},
                          [("s000", "SAMPLE BYTES"), ("s001", "MORE")])
    got = {pkg: mods(pkg)[1]._parse_multipart(body, ctype) for pkg in PKGS}
    assert got["port"] == got["jax"] == (
        {"epochs": 2, "seed": 9},
        [("s000", b"SAMPLE BYTES"), ("s001", b"MORE")])
    for bad in (b"no parts at all", b"--x\r\nContent-Disposition: "
                b'form-data; name="params"\r\n\r\n[1, 2]\r\n--x--\r\n'):
        errs = []
        for pkg in PKGS:
            server = mods(pkg)[1]
            with pytest.raises(server._HTTPError) as exc:
                server._parse_multipart(
                    bad, "multipart/form-data; boundary=x")
            errs.append((exc.value.status, exc.value.outcome,
                         str(exc.value)))
        assert errs[0] == errs[1]


# --- placement ---------------------------------------------------------------

def test_plan_request_sizing():
    asks = [{}, {"epochs": 3}, {"dp_devices": 4}, {"model_parallel": 2},
            {"tp_devices": 2}, {"dp_devices": 2, "tp_devices": 2},
            {"dp_devices": 64}, {"model_parallel": 16},
            {"dp_devices": 3, "model_parallel": 2}]
    got = {pkg: [mods(pkg)[3].plan_request(a, n) for a in asks
                 for n in (1, 2, 8)] for pkg in PKGS}
    assert got["port"] == got["jax"]


def _placement_script(placement, devices):
    """One sequence of grants, releases, FIFO waits and reclaims; returns
    every observable."""
    out = []
    mgr = placement.SliceManager(devices=devices, workers=2)
    out.append(mgr.default_share())
    for job, size in (("a", 2), ("b", 4)):
        p = mgr.acquire(job, size, timeout_s=0.0)
        out.append((p.start, p.size, p.describe()))
    mgr.release("a")
    for job, size in (("c", 1), ("d", 2)):
        p = mgr.acquire(job, size, timeout_s=0.0)
        out.append((p.start, p.size))
    out.append(mgr.acquire("e", 3, timeout_s=0.05))
    out.append(mgr.occupancy())
    got = []
    t = threading.Thread(
        target=lambda: got.append(mgr.acquire("f", 3, timeout_s=5.0)))
    t.start()
    end = time.monotonic() + 5
    while not mgr.occupancy()["queued_placements"] \
            and time.monotonic() < end:
        time.sleep(0.005)
    out.append(mgr.try_acquire("g", 1))      # no leapfrogging the FIFO
    mgr.release("b")
    t.join(timeout=5.0)
    out.append((got[0].start, got[0].size))
    out.append(mgr.try_acquire("g", 1).size)
    stop = threading.Event()
    stop.set()
    out.append(mgr.acquire("h", 1, stop=stop, timeout_s=5.0))
    out.append(sorted(mgr.reclaim(lambda j: j != "c")))
    out.append(mgr.occupancy())
    mgr.close()
    out.append(mgr.acquire("i", 1, timeout_s=0.0))
    return out


def test_slice_manager_best_fit_fifo_stop_and_reclaim():
    got = {pkg: _placement_script(mods(pkg)[3], list(range(8)))
           for pkg in PKGS}
    assert got["port"] == got["jax"]
    assert got["port"][3] == (0, 1) and got["port"][4] == (6, 2)


def test_slice_manager_whole_list_ask_drains():
    got = {}
    for pkg in PKGS:
        mgr = mods(pkg)[3].SliceManager(devices=list(range(4)), workers=2)
        mgr.acquire("a", 2, timeout_s=0.0)
        order = []

        def ask(job_id, size, mgr=mgr, order=order):
            placed = mgr.acquire(job_id, size, timeout_s=10.0)
            order.append((job_id, placed.size))

        t_big = threading.Thread(target=ask, args=("big", 4))
        t_big.start()
        time.sleep(0.1)
        t_small = threading.Thread(target=ask, args=("small", 1))
        t_small.start()
        time.sleep(0.2)
        waiting = list(order)     # both wait behind the held slice
        mgr.release("a")
        t_big.join(timeout=10.0)
        mgr.release("big")
        t_small.join(timeout=10.0)
        mgr.close()
        got[pkg] = (waiting, order)
    assert got["port"] == got["jax"] == ([], [("big", 4), ("small", 1)])


def test_port_slice_devices_are_torch_devices(tmp_path):
    """The port's SliceManager takes torch devices: the serve process's
    (one CPU device under --device cpu) unless a list is given; a
    placement names a card by its index and the CPU by its position; a
    worker's slice is thread-local and nests."""
    import torch

    from hpnn_tpu_torch import api
    from hpnn_tpu_torch.jobs.placement import SliceManager, process_devices

    assert process_devices("cpu") == [torch.device("cpu")]
    two = [torch.device("cpu"), torch.device("cpu")]
    with api.device_slice(two):
        with api.device_slice(two[:1]):
            assert api.slice_devices() == two[:1]
        assert api.slice_devices() == two
    assert api.slice_devices() is None
    mgr = SliceManager([torch.device("cuda", 1), torch.device("cuda", 3)])
    assert mgr.acquire("a", 2, timeout_s=0.0).describe() == \
        {"devices": [1, 3], "dp": 2, "tp": 1, "size": 2}
    conf = serve_conf(tmp_path)
    app = make_app("port", conf)
    sched = app.enable_jobs(str(tmp_path / "jobs"), capacity=1)
    try:
        assert sched.slices.devices == [torch.device("cpu")]
        assert app.registry.retain_generations is True
    finally:
        app.close()


# --- HTTP: validation, admission, auth, listing ----------------------------

def test_submit_validation_and_queue_full(tmp_path):
    corpus = write_corpus(tmp_path / "samples", 3, 3)
    conf = serve_conf(tmp_path)
    got = {}
    for pkg in PKGS:
        app = make_app(pkg, conf, max_batch=8)
        sched = enable_jobs(pkg, app, tmp_path / pkg / "jobs", capacity=1)
        sched.pause()  # jobs queue but never run: admission is the subject
        httpd, base = serve(pkg, app)
        url = "/v1/kernels/tiny/train"
        out = []
        try:
            for path, payload in (
                    ("/v1/kernels/nope/train", {"samples": corpus}),
                    (url, {}),
                    (url, {"samples": corpus, "train": "SPLX"}),
                    (url, {"samples": corpus, "lnn": "turbo"}),
                    (url, {"samples": corpus, "epochs": 0}),
                    (url, {"samples": corpus, "epochs": "x"}),
                    (url, {"samples": str(tmp_path / "missing")}),
                    (url, {"samples": corpus, "hidden": [0]}),
                    (url, {"samples": corpus, "dtype": "f16"}),
                    (url, {"samples": corpus, "type": "XNN"}),
                    (url, {"samples": corpus, "resume_job": "job-9"}),
                    (url, {"samples": corpus,
                           "test_samples": str(tmp_path / "nope")}),
                    (url, {"samples": corpus, "epochs": 2, "seed": 9}),
                    (url, {"samples": corpus})):
                st, body, hdrs = http(base, path, payload)
                out.append((st, mask(body, [tmp_path / pkg]),
                            hdrs.get("Retry-After")))
            st, body, _ = http(base, url, data=b"[1]",
                               headers={"Content-Type":
                                        "application/json"})
            out.append((st, body))
            out.append(mask(http(base, "/v1/jobs")[1],
                            [tmp_path / pkg]))
            out.append(http(base, "/v1/jobs/nope")[:2])
            with open(os.path.join(sched.store.get("job-000001").path,
                                   "nn.conf")) as fp:
                out.append(fp.read())
            out.append(http(base, "/healthz")[1]["active_jobs"])
        finally:
            stop(httpd, app)
        got[pkg] = out
    assert got["port"] == got["jax"]
    statuses = [o[0] for o in got["port"][:14]]
    assert statuses == [404] + [400] * 11 + [202, 429]
    assert got["port"][13][2] == "1"           # 429 carries Retry-After


def test_jobs_disabled_distinct_status(tmp_path):
    conf = serve_conf(tmp_path)
    got = {}
    for pkg in PKGS:
        app = make_app(pkg, conf, max_batch=8)
        httpd, base = serve(pkg, app)
        try:
            got[pkg] = [http(base, p, pl)[:2] for p, pl in (
                ("/v1/kernels/tiny/train", {"samples": "/x"}),
                ("/v1/jobs", None), ("/v1/jobs/job-000001", None),
                ("/v1/jobs/job-000001/cancel", {}))]
            got[pkg].append(http(base, "/healthz")[1]["active_jobs"])
        finally:
            stop(httpd, app)
    assert got["port"] == got["jax"]
    assert got["port"][0][0] == 503
    assert got["port"][0][1]["reason"] == "jobs_disabled"


def test_auth_guard_on_mutating_endpoints(tmp_path):
    conf = serve_conf(tmp_path)
    got = {}
    for pkg in PKGS:
        app = make_app(pkg, conf, max_batch=8, auth_token="s3cret")
        enable_jobs(pkg, app, tmp_path / pkg / "jobs", capacity=1)
        httpd, base = serve(pkg, app)
        out = []
        try:
            # read-only endpoints and infer stay open
            out += [http(base, "/healthz")[0],
                    http(base, "/v1/kernels/tiny/infer",
                         {"inputs": [[0.0] * N_IN]})[0],
                    http(base, "/v1/jobs")[0]]
            for path in ("/v1/kernels/tiny/reload", "/v1/kernels/tiny/train",
                         "/v1/kernels/tiny/train/chunked",
                         "/v1/jobs/nope/corpus", "/v1/jobs/nope/cancel",
                         "/v1/jobs/nope/promote", "/v1/jobs/nope/rollback"):
                for hdrs in ({}, {"Authorization": "Bearer wrong"},
                             {"X-HPNN-Token": "caf\xe9"}):
                    st, body, h = http(base, path, {"samples": "/x"}, hdrs)
                    out.append((st, body, h.get("WWW-Authenticate")))
            ok = {"Authorization": "Bearer s3cret"}
            out.append(http(base, "/v1/kernels/tiny/reload", {}, ok)[0])
            out.append(http(base, "/v1/jobs/nope/cancel", {},
                            {"X-HPNN-Token": "s3cret"})[:2])
        finally:
            stop(httpd, app)
        got[pkg] = out
    assert got["port"] == got["jax"]
    assert got["port"][:3] == [200, 200, 200]
    assert {o[0] for o in got["port"][3:-2]} == {401}
    assert got["port"][-2:] == [200, (404, {"error": "unknown job 'nope'",
                                            "reason": "not_found"})]


def test_job_list_state_and_limit_filters(tmp_path):
    conf = serve_conf(tmp_path, name="fl")
    got = {}
    for pkg in PKGS:
        app = make_app(pkg, conf, max_batch=4)
        sched = enable_jobs(pkg, app, tmp_path / pkg / "jobs", capacity=8)
        sched.pause()
        httpd, base = serve(pkg, app)
        try:
            for s in ("done", "done", "failed", "running", "queued"):
                j = sched.store.create("fl", {})
                if s != "queued":
                    sched.store.update(j, status=s)
            raw = urllib.request.urlopen(base + "/v1/jobs").read()
            out = [json.loads(raw) == {"jobs": sched.list()}]
            for q in ("", "?state=done", "?state=done&limit=1", "?limit=3",
                      "?state=bogus", "?limit=zero", "?limit=0",
                      "?state=queued&limit=9"):
                st, body, _ = http(base, "/v1/jobs" + q)
                out.append((st, mask(body, [tmp_path / pkg])))
        finally:
            stop(httpd, app)
        got[pkg] = out
    assert got["port"] == got["jax"]
    assert got["port"][0] is True
    assert [j["job_id"] for j in got["port"][3][1]["jobs"]] == \
        ["job-000002"]


def test_restart_reports_historical_jobs(tmp_path):
    conf = serve_conf(tmp_path)
    got = {}
    for pkg in PKGS:
        root = tmp_path / pkg / "jobs"
        store = mods(pkg)[0].JobStore(str(root))
        done = store.create("tiny", {"epochs": 2})
        store.update(done, status="done", epoch=2, errors=[0.4, 0.2])
        crashed = store.create("tiny", {"epochs": 5})
        store.update(crashed, status="running", epoch=3, start_epoch=0)
        del store
        app = make_app(pkg, conf, max_batch=8)
        enable_jobs(pkg, app, root, capacity=2)
        httpd, base = serve(pkg, app)
        try:
            listing = http(base, "/v1/jobs")[1]
            metrics = http(base, "/metrics?format=json")[1]["jobs"]
            prom = urllib.request.urlopen(base + "/metrics").read().decode()
        finally:
            stop(httpd, app)
        fams = sorted(ln for ln in prom.splitlines() if "hpnn_jobs" in ln)
        got[pkg] = (mask(listing, [tmp_path / pkg]), metrics, fams)
    assert got["port"] == got["jax"]
    assert got["port"][1]["trained_epochs_total"] == 5
    assert got["port"][1]["by_status"] == {"done": 1, "interrupted": 1}
    assert "hpnn_jobs_trained_epochs_total 5" in got["port"][2]


# --- scheduler control paths -------------------------------------------------

def test_cancel_latches_between_pop_and_install(tmp_path):
    conf = serve_conf(tmp_path, name="cl")
    got = {}
    for pkg in PKGS:
        app = make_app(pkg, conf, max_batch=4)
        sched = enable_jobs(pkg, app, tmp_path / pkg / "jobs", capacity=1)
        out = []
        try:
            # a queued job in neither the queue nor the running map IS the
            # race window, made directly
            job = sched.store.create("cl", {})
            out.append(sched.cancel(job.job_id)["status"])
            with sched._mu:
                out.append(job.job_id in sched._pending_cancel)
            sched.store.update(job, status="done")
            try:
                sched.cancel(job.job_id)
            except mods(pkg)[0].JobError as exc:
                out.append(str(exc))
            try:
                sched.cancel("job-999999")
            except KeyError as exc:
                out.append(repr(exc))
        finally:
            app.close(drain=True)
        got[pkg] = out
    assert got["port"] == got["jax"] == [
        "queued", True, "job 'job-000001' already done", "KeyError('job-999999')"]


def test_rejected_submit_leaves_no_job_record(tmp_path):
    conf = serve_conf(tmp_path, name="nr")
    got = {}
    for pkg in PKGS:
        app = make_app(pkg, conf, max_batch=4)
        sched = enable_jobs(pkg, app, tmp_path / pkg / "jobs", capacity=2)
        try:
            with pytest.raises(mods(pkg)[0].JobError) as exc:
                sched.submit("nr", {"epochs": 1},
                             corpus_files=[(".hidden", b"x")])
            got[pkg] = (str(exc.value), sched.store.list(),
                        [d for d in os.listdir(tmp_path / pkg / "jobs")
                         if d.startswith("job-")])
        finally:
            app.close(drain=True)
    assert got["port"] == got["jax"] == ("bad corpus file name '.hidden'",
                                         [], [])


def test_resume_submit_honors_explicit_samples(tmp_path):
    conf = serve_conf(tmp_path, name="rs")
    old = write_corpus(tmp_path / "old_corpus", 1, 3)
    new = write_corpus(tmp_path / "new_corpus", 2, 3)
    got = {}
    for pkg in PKGS:
        app = make_app(pkg, conf, max_batch=4)
        model = app.registry.get("rs")
        sched = enable_jobs(pkg, app, tmp_path / pkg / "jobs", capacity=2)
        try:
            prev = sched.store.create("rs", {"samples": old,
                                             "model_parallel": 2})
            os.makedirs(os.path.join(prev.path, "ckpt"), exist_ok=True)
            with open(os.path.join(prev.path, "ckpt", "manifest.json"),
                      "w") as fp:
                fp.write("{}")
            sched.store.update(prev, status="interrupted", epoch=1,
                               epochs=2)
            out = [prev.resumable]
            for params in ({"resume_job": prev.job_id, "samples": new},
                           {"resume_job": prev.job_id},
                           {"resume_job": prev.job_id, "epochs": 7}):
                out.append(mask(sched._sanitize(model, params, None),
                                [tmp_path / pkg]))
        finally:
            app.close(drain=True)
        got[pkg] = out
    assert got["port"] == got["jax"]
    assert got["port"][1]["samples"] == new
    assert got["port"][2]["samples"] == old
    assert got["port"][2]["model_parallel"] == 2


def test_scheduler_reclaims_leaked_slice_within_tick(tmp_path):
    import torch

    conf = serve_conf(tmp_path, name="lk")
    got = {}
    for pkg in PKGS:
        app = make_app(pkg, conf, max_batch=4)
        devices = (None if pkg == "jax"
                   else [torch.device("cpu"), torch.device("cpu")])
        sched = mods(pkg)[0].JobScheduler(app, str(tmp_path / pkg / "jobs"),
                                          capacity=1, devices=devices)
        try:
            # a granted slice owned by a job id that is not running
            leaked = sched.slices.try_acquire("ghost-job", 2)
            end = time.monotonic() + 5.0
            while sched.slices.occupancy()["slices_active"] \
                    and time.monotonic() < end:
                time.sleep(0.02)
            occ = sched.slices.occupancy()
            got[pkg] = (leaked.size, occ["slices_active"],
                        occ["devices_in_use"])
        finally:
            sched.drain()
            app.close()
    assert got["port"] == got["jax"] == (2, 0, 0)


def test_generations_retained_with_jobs_only(tmp_path):
    """With jobs enabled generations are retained at ab_fraction 0, and a
    bare rollback takes the newest retained one; without jobs (and no A/B
    fraction) a swap retains nothing."""
    from hpnn_tpu_torch.io.kernel_io import dump_kernel_to_path
    from hpnn_tpu_torch.models.kernel import generate_kernel

    got = {}
    for pkg in PKGS:
        out = []
        for jobs_on in (True, False):
            d = tmp_path / pkg / str(jobs_on)
            d.mkdir(parents=True)
            conf = serve_conf(d, name="rb")
            app = make_app(pkg, conf, max_batch=4)
            model = app.registry.get("rb")
            if jobs_on:
                enable_jobs(pkg, app, d / "jobs", capacity=1)
            x = np.linspace(-1, 1, N_IN).reshape(1, N_IN)
            out1 = app.infer("rb", x)
            dump_kernel_to_path(generate_kernel(4321, N_IN, [N_HID],
                                                N_OUT)[0],
                                str(d / "rb.opt"))
            res = app.reload_model("rb")
            out.append((res["ab_window"], res["retained_generations"]))
            if jobs_on:
                res = model.rollback()
                out.append((res["rolled_back_to"], res["generation"],
                            bool(np.array_equal(app.infer("rb", x),
                                                out1))))
            app.close()
        got[pkg] = out
    assert got["port"] == got["jax"] == [(None, [1]), (1, 3, True),
                                         (None, [])]


def test_generation_counter_cardinality_capped():
    got = {}
    for pkg in PKGS:
        metrics = mods(pkg)[2]
        m = metrics.ServeMetrics()
        for g in range(1, 2 * metrics.ServeMetrics.GEN_LABELS_KEPT + 1):
            m.count_generation("k", g)
            m.count_generation("k", g)
        got[pkg] = (m.snapshot()["generations"],
                    'generation="older"' in m.render_prometheus())
    assert got["port"] == got["jax"]
    assert got["port"][0]["k"]["older"] == 32


def test_submit_validates_test_samples_dir(tmp_path):
    conf = serve_conf(tmp_path)
    got = {}
    for pkg in PKGS:
        app = make_app(pkg, conf, max_batch=8)
        sched = enable_jobs(pkg, app, tmp_path / pkg / "jobs", capacity=1,
                                auto_promote=True)
        try:
            with pytest.raises(mods(pkg)[0].JobError) as exc:
                sched.submit("tiny", {"samples": str(tmp_path),
                                      "test_samples":
                                      str(tmp_path / "nope")})
            got[pkg] = str(exc.value)
        finally:
            app.close(drain=True)
    assert got["port"] == got["jax"]
    assert "test_samples" in got["port"]


# --- serve_nn's job options ---------------------------------------------------

def test_serve_nn_job_options(tmp_path, capsys, monkeypatch):
    from hpnn_tpu_torch.cli import serve_app, serve_nn_main

    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("HPNN_SERVE_TOKEN", raising=False)
    monkeypatch.delenv("HPNN_JOB_WORKERS", raising=False)
    monkeypatch.delenv("HPNN_JOB_AUTO_RESUME", raising=False)
    monkeypatch.delenv("HPNN_REPLICATE_TO", raising=False)
    conf = serve_conf(tmp_path)
    base = ["-p", "0", "--device", "cpu", "--no-warmup"]
    capsys.readouterr()
    cases = (
        (["--jobs", "3"], "SERVE: online training enabled (queue=3, "
         "job-dir=./jobs, ab-fraction=0, auth=OFF (pass --auth-token))\n"),
        (["--jobs", "2", "--job-dir", "jd", "--auth-token", "T",
          "--auto-promote", "--job-auto-resume", "--replicate-to", "rep",
          "--ab-fraction", "0.25", "--job-workers", "2"],
         "SERVE: online training enabled (queue=2, job-dir=jd, "
         "ab-fraction=0.25, auth=on, auto-promote, auto-resume, "
         "replicate-to=rep, workers=2 over 1 device(s))\n"))
    for argv, line in cases:
        app, args = serve_app([*base, *argv, conf])
        try:
            assert app is not None and app.jobs is not None
            assert capsys.readouterr().out == line
        finally:
            app.close()
    assert app.jobs.auto_promote and app.jobs.auto_resume
    assert app.jobs.workers == 2 and app.registry.retain_generations
    monkeypatch.setenv("HPNN_JOB_WORKERS", "3")
    app, _ = serve_app([*base, "--jobs", "1", conf])
    assert app.jobs.workers == 3
    app.close()
    capsys.readouterr()
    # --auto-promote alone is inert, with the JAX package's warning
    app, _ = serve_app([*base, "--auto-promote", conf])
    assert app.jobs is None
    assert capsys.readouterr().err == ("serve: --auto-promote is inert "
                                       "without --jobs N (ignored)\n")
    app.close()
    # a mesh router destination is a later slice's: refused before bind
    from hpnn_tpu_torch.ckpt.replicate import http_refusal

    for argv, dest in ((["--jobs", "1", "--replicate-to", "http://h:1"],
                        "http://h:1"),
                       (["--replicate-to", "https://h:1"], "https://h:1")):
        assert serve_app([*base, *argv, conf]) == (None, -1)
        assert capsys.readouterr().err == \
            f"serve_nn: {http_refusal(dest)}\n"
    # no card: --device cuda exits non-zero before it binds
    import torch

    if not torch.cuda.is_available():
        assert serve_nn_main(["-p", "0", "--jobs", "1", "--device", "cuda",
                              conf]) != 0
        assert "no GPU is visible" in capsys.readouterr().err
