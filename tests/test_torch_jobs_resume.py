"""The port's jobs service on the CPU: cancel, drain, resume, lease-based
auto-resume, two workers on disjoint slices, and a fresh interpreter that
serves and trains without importing JAX.

The jobs are SNN-BP on the 12-file corpus of ``test_torch_jobs_e2e.py``
(a few thousand iterations an epoch on the port's eager CPU route).  A
cancelled or drained job resumed with ``resume_job`` (or auto-resumed by a
restarted server) must end byte-identical to the same job run straight
through, as in the JAX package's tests (``tests/test_jobs.py``,
``tests/test_train_chaos.py``); where the timing of a cancel decides the
epoch, the straight run is made at the epoch the resumed one ends on."""

import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from test_torch_jobs import (N_IN, enable_jobs, http, make_app, serve,
                             serve_conf, stop, wait_terminal, write_corpus)

JOB = {"seed": 32, "train": "BP", "type": "SNN", "ckpt_every": 1}


@pytest.fixture()
def corpus(tmp_path):
    return write_corpus(tmp_path / "samples", 7, 12)


def _port_app(tmp_path, workers=1, devices=None, **kw):
    conf = serve_conf(tmp_path, kind="SNN")
    app = make_app("port", conf, max_batch=8)
    enable_jobs("port", app, tmp_path / "jobs", capacity=4,
                job_workers=workers, devices=devices, **kw)
    return app


def _wait_epoch(base, jid, epoch, timeout_s=120.0):
    end = time.monotonic() + timeout_s
    while time.monotonic() < end:
        snap = http(base, f"/v1/jobs/{jid}")[1]
        if snap["epoch"] >= epoch:
            return snap
        time.sleep(0.01)
    raise AssertionError(f"job {jid} never reached epoch {epoch}")


def _opt(snap):
    with open(os.path.join(snap["path"], "kernel.opt"), "rb") as fp:
        return fp.read()


def _submit(base, params):
    st, job, _ = http(base, "/v1/kernels/tiny/train", params)
    assert st == 202, job
    return job["job_id"]


@pytest.mark.parametrize("ask", [{}, {"dp_devices": 2}])
def test_cancel_then_resume_is_byte_exact(tmp_path, corpus, ask):
    """Cancel latches the stop: the epoch finishes, a final snapshot lands,
    the job is ``cancelled`` and resumable, a second cancel is a 409; a
    ``resume_job`` submit (inheriting the slice ask: an equal-size slice)
    continues it to the byte-identical kernel of a straight run."""
    app = _port_app(tmp_path, devices=[torch.device("cpu")] * 4)
    httpd, base = serve("port", app)
    try:
        jid = _submit(base, dict(JOB, epochs=500, samples=corpus, **ask))
        _wait_epoch(base, jid, 1)
        st, snap, _ = http(base, f"/v1/jobs/{jid}/cancel", {})
        assert st == 200
        snap = wait_terminal(base, jid)
        assert snap["status"] == "cancelled" and snap["resumable"] is True
        assert 1 <= snap["epoch"] < 500
        st, body, _ = http(base, f"/v1/jobs/{jid}/cancel", {})
        assert (st, body["reason"]) == (409, "conflict")
        target = snap["epoch"] + 2
        rid = _submit(base, {"resume_job": jid, "epochs": target})
        resumed = wait_terminal(base, rid)
        assert resumed["status"] == "done" and resumed["epoch"] == target
        assert resumed["resumed_from"] == jid
        assert resumed["params"].get("dp_devices") == ask.get("dp_devices")
        assert resumed["slice"]["size"] == (2 if ask else 4)
        assert resumed["errors"][:snap["epoch"]] == snap["errors"]
        straight = wait_terminal(base, _submit(
            base, dict(JOB, epochs=target, samples=corpus, **ask)))
        assert straight["status"] == "done"
        assert _opt(resumed) == _opt(straight)
        assert resumed["errors"] == straight["errors"]
    finally:
        stop(httpd, app)


def test_close_drains_running_job_interrupted(tmp_path, corpus):
    from hpnn_tpu_torch import ckpt

    app = _port_app(tmp_path)
    httpd, base = serve("port", app)
    jid = _submit(base, dict(JOB, epochs=500, samples=corpus))
    _wait_epoch(base, jid, 1)
    stop(httpd, app)              # the scheduler drains first
    snap = app.jobs.get(jid)
    assert snap["status"] == "interrupted" and snap["resumable"] is True
    assert 1 <= snap["epoch"] < 500
    bundle = ckpt.load_snapshot(os.path.join(snap["path"], "ckpt"))
    assert bundle is not None and bundle.epoch == snap["epoch"]


def _offline_opt(tmp_path, conf, epochs):
    from hpnn_tpu_torch import cli

    run = tmp_path / f"offline{epochs}"
    run.mkdir()
    cwd = os.getcwd()
    os.chdir(run)
    try:
        assert cli.train_nn_main(["--device", "cpu", f"--epochs={epochs}",
                                  "--ckpt-every=1", "--ckpt-dir=ck",
                                  conf]) == 0
    finally:
        os.chdir(cwd)
    return (run / "kernel.opt").read_bytes()


def _wait_status(store, jid, want, timeout_s=120.0):
    end = time.monotonic() + timeout_s
    while time.monotonic() < end:
        snap = store.snapshot(jid)
        if snap and snap["status"] in want:
            return snap
        time.sleep(0.02)
    raise AssertionError(f"job {jid} never reached {want}: "
                         f"{store.snapshot(jid)}")


@pytest.mark.parametrize("lost", [False, True])
def test_interrupted_job_auto_resumes_to_done(tmp_path, corpus, lost):
    """A drained job is re-queued by a restarted server with auto-resume
    from its newest verified bundle -- from the replica directory when the
    local checkpoint history is lost -- and ends byte-identical to the
    offline ``train_nn`` of its conf."""
    rep = str(tmp_path / "rep")
    app = _port_app(tmp_path, replicate_to=rep)
    job = app.jobs.submit("tiny", dict(JOB, epochs=4, samples=corpus))
    end = time.monotonic() + 60
    while app.jobs.store.get(job.job_id).epoch < 1 \
            and time.monotonic() < end:
        time.sleep(0.01)
    app.close()
    snap = app.jobs.get(job.job_id)
    assert snap["status"] == "interrupted" and snap["epoch"] >= 1
    if lost:
        shutil.rmtree(os.path.join(snap["path"], "ckpt"))
    # the restarted server, on the same job dir
    app2 = _port_app(tmp_path, auto_resume=True, replicate_to=rep)
    try:
        done = _wait_status(app2.jobs.store, job.job_id, ("done",))
        assert done["epoch"] == 4 and done["retries"] >= 1
        assert app2.jobs.auto_resumes_total >= 1
        if lost:   # the restore landed replica bundles back on disk
            assert any(t.startswith("ep") for t in os.listdir(
                os.path.join(done["path"], "ckpt")))
        assert _opt(done) == _offline_opt(
            tmp_path, os.path.join(done["path"], "nn.conf"), 4)
    finally:
        app2.close()


@pytest.mark.parametrize("forge", ["budget", "lease"])
def test_auto_resume_budget_and_expired_lease(tmp_path, corpus, forge):
    """An interrupted record whose retry budget is spent lands ``failed``
    with the reason; an active record with an expired lease (its owner
    died) is recovered and auto-resumed to ``done``."""
    app = _port_app(tmp_path)
    job = app.jobs.submit("tiny", dict(JOB, epochs=2, samples=corpus))
    _wait_status(app.jobs.store, job.job_id, ("done",))
    app.close()
    store = app.jobs.store
    if forge == "budget":
        store.update(store.get(job.job_id), status="interrupted",
                     retries=99)
    else:
        store.update(store.get(job.job_id), status="running",
                     lease_expires=time.time() - 10.0)
    app2 = _port_app(tmp_path, auto_resume=True)
    try:
        if forge == "budget":
            snap = _wait_status(app2.jobs.store, job.job_id, ("failed",))
            assert "retry budget exhausted" in snap["error"]
        else:
            snap = _wait_status(app2.jobs.store, job.job_id, ("done",))
            assert snap["retries"] >= 1
    finally:
        app2.close()


def test_training_failure_fails_the_job(tmp_path, corpus, monkeypatch):
    """An exception out of the epoch (a kernel that fails to launch) ends
    the job ``failed`` with its message; the worker goes on to the next
    job."""
    from hpnn_tpu_torch import api

    real = api.train_kernel
    calls = []

    def broken(nn, device="cuda"):
        calls.append(device)
        if len(calls) == 1:
            raise RuntimeError("train_epoch: launch failed")
        return real(nn, device=device)

    monkeypatch.setattr(api, "train_kernel", broken)
    app = _port_app(tmp_path)
    httpd, base = serve("port", app)
    try:
        failed = wait_terminal(base, _submit(base, dict(
            JOB, epochs=2, samples=corpus)))
        assert failed["status"] == "failed"
        assert failed["error"] == "RuntimeError: train_epoch: launch failed"
        done = wait_terminal(base, _submit(base, dict(
            JOB, epochs=1, samples=corpus)))
        assert done["status"] == "done"
    finally:
        stop(httpd, app)


def test_two_workers_train_on_disjoint_slices(tmp_path, corpus):
    """Two workers over two CPU devices: two jobs run at once on disjoint
    slices (their running intervals overlap), /healthz and /metrics show
    the occupancy, and each kernel is byte-identical to its serial run."""
    app = _port_app(tmp_path, workers=2,
                    devices=[torch.device("cpu"), torch.device("cpu")])
    httpd, base = serve("port", app)
    try:
        params = [dict(JOB, epochs=4, samples=corpus, seed=s)
                  for s in (32, 33)]
        serial = [wait_terminal(base, _submit(base, p)) for p in params]
        jids = [_submit(base, p) for p in params]
        end = time.monotonic() + 60
        while time.monotonic() < end:
            hz = http(base, "/healthz")[1]
            if hz["job_slices"]["slices_active"] == 2:
                break
            time.sleep(0.005)
        assert hz["active_jobs"] == 2
        assert hz["job_slices"]["devices_in_use"] == 2
        conc = [wait_terminal(base, j) for j in jids]
        assert [s["status"] for s in conc] == ["done", "done"]
        a, b = conc
        assert a["started"] < b["finished"] and b["started"] < a["finished"]
        assert a["slice"]["devices"] != b["slice"]["devices"]
        assert a["slice"]["size"] == b["slice"]["size"] == 1
        for s, c in zip(serial, conc):
            assert _opt(s) == _opt(c) and s["errors"] == c["errors"]
    finally:
        stop(httpd, app)


def test_serve_nn_jobs_subprocess_imports_no_jax(tmp_path, corpus):
    """A fresh interpreter builds ``serve_nn --jobs 1 --device cpu``,
    a submitted job trains to ``done`` while a request is answered, and
    neither jax nor any hpnn_tpu module was imported."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    conf = serve_conf(tmp_path, kind="SNN")
    code = f"""
import json, sys, time, urllib.request
from hpnn_tpu_torch.cli import serve_app
from hpnn_tpu_torch.serve.server import serve_in_thread

app, args = serve_app(['-p', '0', '--device', 'cpu', '--no-warmup',
                       '--jobs', '1', '--job-dir', 'jobs', {conf!r}])
httpd, th = serve_in_thread(app)
base = 'http://127.0.0.1:%d' % httpd.server_address[1]

def post(path, payload):
    req = urllib.request.Request(base + path, json.dumps(payload).encode())
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, json.loads(r.read())

st, job = post('/v1/kernels/tiny/train',
               {{'epochs': 2, 'seed': 32, 'samples': {corpus!r}}})
assert st == 202, job
assert post('/v1/kernels/tiny/infer', {{'inputs': [[0.5] * {N_IN}]}})[0] == 200
end = time.time() + 60
while time.time() < end:
    snap = json.loads(urllib.request.urlopen(
        base + '/v1/jobs/' + job['job_id']).read())
    if snap['status'] == 'done':
        break
    time.sleep(0.05)
assert snap['status'] == 'done' and len(snap['generations']) >= 2, snap
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
    assert "SERVE: online training enabled (queue=1, job-dir=jobs" \
        in res.stdout
