"""The port's jobs service on the CPU, held against the JAX package:
corpus uploads (multipart, chunked, the upload wait and the body cap) and
eval-driven auto-promotion.

Each case runs the same submits on the same corpus through both packages'
servers and compares statuses, error bodies, upload replies and the
decision records; the jobs are SNN-BP (and CG on a native-LNN kernel for
the MSE objective), which converge in few iterations on the port's eager
CPU route.  The chunked upload's pack is held byte for byte against the
JAX package's ``ChunkedPackWriter`` fed the same chunks, and its job
against a single-shot submit of the same files."""

import os
import shutil
import time
import urllib.request

import numpy as np
import pytest

from test_torch_jobs import (PKGS, enable_jobs, http, make_app, mask,
                             post_mp, sample_text, serve, serve_conf, stop,
                             wait_terminal, write_corpus)

PARAMS = {"epochs": 2, "seed": 32, "train": "BP", "type": "SNN",
          "ckpt_every": 1}


def _files(tmp_path):
    """The uploaded corpus: the 12 files of test_torch_jobs_e2e.py's SNN
    corpus, whose stream both packages reproduce line for line."""
    d = write_corpus(tmp_path / "upload_src", 7, 12)
    return [(n, open(os.path.join(d, n)).read())
            for n in sorted(os.listdir(d))]


def _weights(path):
    from hpnn_tpu_torch.io.kernel_io import load_kernel

    return load_kernel(str(path)).weights


def _close_weights(a, b, tol=1e-12):
    return max(float(np.abs(x - y).max())
               for x, y in zip(_weights(a), _weights(b))) < tol


def test_multipart_corpus_upload_trains(tmp_path):
    conf = serve_conf(tmp_path, kind="SNN")
    files = _files(tmp_path)
    got = {}
    for pkg in PKGS:
        app = make_app(pkg, conf, max_batch=8)
        enable_jobs(pkg, app, tmp_path / pkg / "jobs", capacity=1)
        httpd, base = serve(pkg, app)
        try:
            st, job, _ = post_mp(base, "/v1/kernels/tiny/train", PARAMS,
                                 files)
            assert st == 202, job
            snap = wait_terminal(base, job["job_id"])
        finally:
            stop(httpd, app)
        cdir = os.path.join(snap["path"], "corpus")
        got[pkg] = (mask(job, [tmp_path / pkg]),
                    sorted(os.listdir(cdir)), snap["params"]["samples"] == cdir,
                    snap["status"], snap["errors"],
                    os.path.join(snap["path"], "kernel.opt"))
    port, jax = got["port"], got["jax"]
    assert port[:4] == jax[:4]
    assert port[1] == [n for n, _ in files] and port[2]
    assert port[3] == "done"
    np.testing.assert_allclose(port[4], jax[4], rtol=0, atol=1e-12)
    assert _close_weights(port[5], jax[5])


def _jax_chunked_pack(cdir, chunks):
    """The pack the JAX package's ChunkedPackWriter assembles from the same
    chunks of the same files."""
    from hpnn_tpu.io.corpus import ChunkedPackWriter, pack_path

    writer = ChunkedPackWriter(cdir, 8, 3)
    for names in chunks:
        writer.add_sample_files(names)
    assert writer.finalize()
    with open(pack_path(cdir), "rb") as fp:
        return fp.read()


def test_chunked_upload_end_to_end(tmp_path):
    """Submit on chunk 1, append a chunk, close bare with ?final=1: the job
    trains on the whole corpus from the incremental pack, whose bytes are
    the JAX writer's; a single-shot submit of the same files gives the
    same kernel; the chunk counter reaches /metrics; closed and unknown
    uploads are refused as the JAX package refuses them."""
    conf = serve_conf(tmp_path, kind="SNN")
    files = _files(tmp_path)
    got = {}
    for pkg in PKGS:
        app = make_app(pkg, conf, max_batch=8)
        enable_jobs(pkg, app, tmp_path / pkg / "jobs", capacity=2)
        httpd, base = serve(pkg, app)
        out = []
        try:
            st, job, _ = post_mp(base, "/v1/kernels/tiny/train/chunked",
                                 PARAMS, files[:6])
            assert st == 202, (pkg, job)
            jid = job["job_id"]
            out.append((st, job["upload"], job["status"]))
            out.append(post_mp(base, f"/v1/jobs/{jid}/corpus", None,
                               files[6:])[:2])
            out.append(post_mp(base, f"/v1/jobs/{jid}/corpus?final=1",
                               None, [])[:2])
            snap = wait_terminal(base, jid)
            pack = os.path.join(snap["path"], ".corpus.hpnn.pack")
            with open(pack, "rb") as fp:
                pack_bytes = fp.read()
            out.append((snap["status"],
                        sorted(os.listdir(os.path.join(snap["path"],
                                                       "corpus"))),
                        sorted(n for n in os.listdir(snap["path"])
                               if n.startswith(".")),
                        snap["errors"]))
            st, job2, _ = post_mp(base, "/v1/kernels/tiny/train", PARAMS,
                                  files)
            snap2 = wait_terminal(base, job2["job_id"])
            same = (open(os.path.join(snap["path"], "kernel.opt"),
                         "rb").read()
                    == open(os.path.join(snap2["path"], "kernel.opt"),
                            "rb").read())
            out.append((snap2["status"], same))
            prom = urllib.request.urlopen(base + "/metrics").read().decode()
            out.append("hpnn_jobs_upload_chunks_total 3" in prom)
            for path, chunk in ((f"/v1/jobs/{jid}/corpus?final=1", []),
                                ("/v1/jobs/nope/corpus", files[:1]),
                                (f"/v1/jobs/{jid}/corpus", [])):
                out.append(post_mp(base, path, None, chunk)[:2])
            out.append(post_mp(base, "/v1/kernels/tiny/train/chunked",
                               PARAMS, [])[:2])
        finally:
            stop(httpd, app)
        got[pkg] = (out, pack_bytes, os.path.join(snap["path"], "corpus"))
    (port, pbytes, pdir), (jax, _, _) = got["port"], got["jax"]
    assert [o for i, o in enumerate(port) if i != 3] == \
        [o for i, o in enumerate(jax) if i != 3]
    assert port[3][:3] == jax[3][:3]
    np.testing.assert_allclose(port[3][3], jax[3][3], rtol=0, atol=1e-12)
    assert port[0] == (202, {"endpoint": "/v1/jobs/job-000001/corpus",
                             "chunks": 1, "complete": False}, "queued")
    assert port[1] == (200, {"job": "job-000001", "chunks": 2,
                             "complete": False})
    assert port[2] == (200, {"job": "job-000001", "chunks": 3,
                             "complete": True})
    assert port[3][0] == "done" and port[3][2] == [".corpus.hpnn.pack"]
    assert port[4] == ("done", True) and port[5] is True
    assert [o[0] for o in port[6:]] == [409, 404, 400, 400]
    # the pack: the JAX writer's bytes for the same dir and chunks
    os.unlink(os.path.join(os.path.dirname(pdir), ".corpus.hpnn.pack"))
    assert _jax_chunked_pack(pdir, [[n for n, _ in files[:6]],
                                    [n for n, _ in files[6:]]]) == pbytes


def test_chunked_upload_timeout_fails_job(tmp_path, monkeypatch):
    monkeypatch.setenv("HPNN_JOBS_UPLOAD_WAIT_S", "1")
    conf = serve_conf(tmp_path, kind="SNN")
    files = _files(tmp_path)
    got = {}
    for pkg in PKGS:
        app = make_app(pkg, conf, max_batch=8)
        enable_jobs(pkg, app, tmp_path / pkg / "jobs", capacity=1)
        httpd, base = serve(pkg, app)
        try:
            st, job, _ = post_mp(base, "/v1/kernels/tiny/train/chunked",
                                 PARAMS, files[:6])
            snap = wait_terminal(base, job["job_id"], timeout_s=30.0)
            late = post_mp(base, f"/v1/jobs/{job['job_id']}/corpus?final=1",
                           None, [])[:2]
            leftovers = sorted(n for n in os.listdir(snap["path"])
                               if n.startswith("."))
        finally:
            stop(httpd, app)
        got[pkg] = (st, snap["status"], snap["error"], late, leftovers)
    assert got["port"] == got["jax"]
    assert got["port"][1:3] == ("failed",
                                "corpus upload incomplete after 1s")


def test_oversized_submit_413_points_at_chunked(tmp_path, monkeypatch):
    monkeypatch.setenv("HPNN_JOBS_MAX_BODY_MB", "1")
    conf = serve_conf(tmp_path, kind="SNN")
    files = _files(tmp_path)
    got = {}
    for pkg in PKGS:
        app = make_app(pkg, conf, max_batch=8)
        enable_jobs(pkg, app, tmp_path / pkg / "jobs", capacity=1)
        httpd, base = serve(pkg, app)
        try:
            big = [("s000", sample_text(0) + "#" * (1 << 20) + "\n")]
            st, out, hdrs = post_mp(base, "/v1/kernels/tiny/train", PARAMS,
                                    big)
            chunk = post_mp(base, "/v1/jobs/job-000001/corpus", None, big)
            # an in-cap submit on a fresh connection still trains
            st2, job, _ = post_mp(base, "/v1/kernels/tiny/train", PARAMS,
                                  files)
            snap = wait_terminal(base, job["job_id"])
            metrics = http(base, "/metrics?format=json")[1]["requests"]
        finally:
            stop(httpd, app)
        got[pkg] = (st, out, hdrs.get("X-HPNN-Chunked-Endpoint"),
                    chunk[:2], chunk[2].get("X-HPNN-Chunked-Endpoint"),
                    st2, snap["status"], metrics.get("too_large"))
    assert got["port"] == got["jax"]
    assert got["port"][0] == 413
    assert got["port"][2] == "/v1/kernels/tiny/train/chunked"
    assert got["port"][6] == "done"


# --- eval-driven auto-promotion -------------------------------------------

def _promote_run(pkg, tmp_path, conf, params, auto=True):
    app = make_app(pkg, conf, max_batch=8)
    enable_jobs(pkg, app, tmp_path / pkg / "jobs", capacity=1,
                auto_promote=auto)
    name = app.registry.names()[0]
    httpd, base = serve(pkg, app)
    try:
        st, job, _ = http(base, f"/v1/kernels/{name}/train", params)
        assert st == 202, job
        with open(os.path.join(app.jobs.store.get(job["job_id"]).path,
                               "nn.conf")) as fp:
            conf_text = fp.read()
        snap = wait_terminal(base, job["job_id"])
        if auto:
            # the decision lands after the terminal record: poll for it
            for _ in range(600):
                snap = http(base, f"/v1/jobs/{job['job_id']}")[1]
                if snap["auto_promote"] is not None:
                    break
                time.sleep(0.02)
        table = app.registry.get(name).generation_table()
        gens = http(base, "/metrics?format=json")[1]["generations"]
    finally:
        stop(httpd, app)
    return snap, table, gens, conf_text


@pytest.mark.parametrize("kind", ["SNN", "LNN"])
def test_auto_promote_decides_from_test_dir_error(tmp_path, kind):
    """A finished job's candidate is evaluated against the pre-job baseline
    on the held-out test dir through pinned batcher submits: accuracy for
    a classifier, MSE for a native LNN (trained with CG there, and its
    conf carries the [lnn]/[trainer] keywords).  The record -- action,
    objective, rows, generations, both errors, the eval request count and
    the canary counters -- equals the JAX package's."""
    corpus = write_corpus(tmp_path / "corpus", 7, 12)
    tests = write_corpus(tmp_path / "tests", 12, 6)
    conf = serve_conf(tmp_path, name="tiny", kind=kind)
    params = {"samples": corpus, "test_samples": tests, "epochs": 3,
              "seed": 32, "ckpt_every": 0,
              "train": "CG" if kind == "LNN" else "BP"}
    got = {pkg: _promote_run(pkg, tmp_path, conf, params) for pkg in PKGS}
    (ps, pt, pg, pc), (js, jt, jg, jc) = got["port"], got["jax"]
    assert ps["status"] == js["status"] == "done"
    assert ps["baseline_generation"] == js["baseline_generation"] == 1
    rec = ps["auto_promote"]
    assert rec["objective"] == ("mse" if kind == "LNN" else "accuracy")
    assert mask(rec, [tmp_path / "port"]) == \
        mask(js["auto_promote"], [tmp_path / "jax"])
    assert ps["finalized"] == js["finalized"] == rec["action"]
    assert rec["action"] == ("auto_promoted"
                             if rec["candidate_err"] <= rec["baseline_err"]
                             else "auto_rolled_back")
    assert rec["test_rows"] == 6 and rec["eval_requests"] == 2
    assert pt == jt and pt["ab_window"] is None
    assert pg == jg
    assert pc == jc
    if kind == "LNN":
        assert "[lnn] native" in pc and "[trainer] cg" in pc


def test_auto_promote_skips_without_test_dir_and_is_off_by_default(
        tmp_path):
    corpus = write_corpus(tmp_path / "corpus", 7, 12)
    conf = serve_conf(tmp_path, kind="SNN")
    params = {"samples": corpus, "epochs": 1, "seed": 32, "ckpt_every": 0}
    for auto in (True, False):
        got = {}
        for pkg in PKGS:
            snap = _promote_run(pkg, tmp_path, conf, params, auto=auto)[0]
            got[pkg] = (snap["status"], snap["auto_promote"],
                        snap["finalized"], snap["baseline_generation"])
            shutil.rmtree(tmp_path / pkg)
        assert got["port"] == got["jax"]
        if auto:
            assert got["port"][1]["action"] == "skipped"
            assert "test dir" in got["port"][1]["reason"]
        else:
            assert got["port"] == ("done", None, None, None)


def _held_until_dequeued(sched, fn):
    """Wrap a scheduler submit so it returns only once a worker has taken
    the job out of ``queued``: the reply is then rendered after the worker
    won the race it describes."""
    def wrapped(*args, **kw):
        out = fn(*args, **kw)
        jid = out[0].job_id if isinstance(out, tuple) else out["job_id"]
        deadline = time.monotonic() + 60.0
        while sched.store.get(jid).status == "queued":
            assert time.monotonic() < deadline, "no worker took the job"
            time.sleep(0.01)
        return out
    return wrapped


def test_submit_reply_is_the_admitted_record(tmp_path):
    """A worker idle on the queue dequeues the job (a chunked job enters
    the upload hold as ``running``) before the handler renders its 202:
    the reply still carries the record as admitted, ``queued``, while
    /v1/jobs/<id> shows the worker's ``running`` and its lease."""
    conf = serve_conf(tmp_path, kind="SNN")
    files = _files(tmp_path)
    app = make_app("port", conf, max_batch=8)
    sched = enable_jobs("port", app, tmp_path / "jobs", capacity=2)
    sched.submit_chunked = _held_until_dequeued(sched, sched.submit_chunked)
    sched.admit = _held_until_dequeued(sched, sched.admit)
    httpd, base = serve("port", app)
    try:
        st, job, _ = post_mp(base, "/v1/kernels/tiny/train/chunked",
                             PARAMS, files[:6])
        assert (st, job["status"], job["upload"]) == (
            202, "queued", {"endpoint": "/v1/jobs/job-000001/corpus",
                            "chunks": 1, "complete": False})
        st, live, _ = http(base, "/v1/jobs/job-000001")
        assert (st, live["status"]) == (200, "running")
        assert live["lease_expires"] > time.time()
        assert post_mp(base, "/v1/jobs/job-000001/corpus?final=1", None,
                       files[6:])[0] == 200
        assert wait_terminal(base, "job-000001")["status"] == "done"
        st, job2, _ = post_mp(base, "/v1/kernels/tiny/train", PARAMS, files)
        assert (st, job2["status"], job2["job_id"]) == (202, "queued",
                                                        "job-000002")
        assert wait_terminal(base, "job-000002")["status"] == "done"
    finally:
        stop(httpd, app)
