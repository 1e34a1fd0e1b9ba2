"""The port's jobs service end to end on the CPU, held against the JAX
package: a job submitted over HTTP trains while three clients send
``/infer`` requests, and every epoch's snapshot hot-reloads into serving.

For ANN-BP, ANN-BPM and SNN-BP at f64 (3 epochs, ``ckpt_every`` 1, the
JAX tests' 8-6-3 net on a 12-file corpus): the port job's kernel.opt is
byte-identical to the port's offline ``train_nn --epochs 3 --ckpt-every
1`` of the job's own conf, and within 5e-12 of the JAX job's (plus 6e-15
an iteration for SNN, the bound of ``tests/test_torch_epochs.py``); the
console.log equals the JAX job's (the resident-corpus dbg line's elapsed
time masked, and the load mode the port adds to it removed); the error
trajectories agree within 1e-12 and equal the port's manifest; no request
failed; at least 3 swaps landed; A/B pinning and promote answer as the JAX
package's do; the jobs metrics have the JAX keys.  The job records a
worker writes (status, epoch, errors, generations) follow the JAX
package's sequence at ``ckpt_every`` 1 and 2 (the pipelined epochs' joins
land at the same boundaries).

The corpora and seeds were picked so a generated kernel converges in few
iterations (46k, 57k and 5k over the 3 epochs: the port's CPU route is an
eager loop) on a stream both packages reproduce line for line, and each
client pauses 200 ms between requests."""

import json
import os
import re
import shutil
import threading
import urllib.request

import numpy as np
import pytest

from test_torch_jobs import (N_HID, N_IN, PKGS, enable_jobs, http,
                             make_app, mask, serve, serve_conf, stop,
                             wait_terminal, write_corpus)

EPOCHS = 3
# variant -> (type, train, corpus seed, corpus boost, the job's seed)
VARIANTS = {"ANN-BP": ("ANN", "BP", 6, 50.0, 7),
            "ANN-BPM": ("ANN", "BPM", 6, 50.0, 7),
            "SNN-BP": ("SNN", "BP", 7, 2.0, 32)}
# a client's pause between requests: the port's CPU route is an eager
# loop, and clients that never pause take the CPU it needs (a 3-epoch ANN
# job then takes minutes)
THINK_S = 0.2
_RESIDENT = re.compile(r"(resident corpus: .* staged once in )[0-9.]+s"
                       r"(?: \([a-z]+; native_io: [a-z]+\))?")


def _console(text):
    """A console.log with the resident-corpus line's timing masked and
    the port's load-mode suffix dropped."""
    return _RESIDENT.sub(r"\1<t>s", text)


def _weights(path):
    from hpnn_tpu_torch.io.kernel_io import load_kernel

    return load_kernel(str(path)).weights


def _record_updates(sched, seq):
    """Append (status, epoch, len(errors), generations) after every store
    write of one of the scheduler's jobs."""
    real = sched.store.update

    def update(job, **fields):
        real(job, **fields)
        seq.append((job.status, job.epoch, len(job.errors),
                    list(job.generations)))

    sched.store.update = update


def _job_under_traffic(pkg, tmp_path, conf, params):
    """One package's job at ``tmp_path/jobs`` under 3 hammering clients;
    returns what the acceptance compares."""
    app = make_app(pkg, conf, warmup=True, max_batch=8, max_queue_rows=512,
                   ab_fraction=1.0)
    sched = enable_jobs(pkg, app, tmp_path / "jobs", capacity=2)
    seq = []
    _record_updates(sched, seq)
    httpd, base = serve(pkg, app)
    name = app.registry.names()[0]
    x = np.linspace(-1, 1, N_IN).reshape(1, N_IN).tolist()
    halt = threading.Event()
    failures, oks, events = [], [0], []

    def hammer():
        while not halt.is_set():
            st, body, _ = http(base, f"/v1/kernels/{name}/infer",
                               {"inputs": x})
            if st != 200:
                failures.append((st, body))
            else:
                oks[0] += 1
            halt.wait(THINK_S)

    def read_events(jid):
        with urllib.request.urlopen(base + f"/v1/jobs/{jid}/events",
                                    timeout=300) as resp:
            events.append(resp.headers.get("Content-Type"))
            events.extend(json.loads(line) for line in resp)

    threads = [threading.Thread(target=hammer) for _ in range(3)]
    for t in threads:
        t.start()
    try:
        st, job, _ = http(base, f"/v1/kernels/{name}/train", params)
        assert st == 202, job
        ev = threading.Thread(target=read_events, args=(job["job_id"],))
        ev.start()
        snap = wait_terminal(base, job["job_id"], timeout_s=300)
        ev.join(timeout=60)
    finally:
        halt.set()
        for t in threads:
            t.join()
    try:
        model = app.registry.get(name)
        gen = model.generation
        ab = [http(base, f"/v1/kernels/{name}/infer", {"inputs": x})[1],
              http(base, f"/v1/kernels/{name}/infer", {"inputs": x},
                   {"X-HPNN-Generation": str(gen)})[1]]
        st, res, _ = http(base, f"/v1/jobs/{snap['job_id']}/promote", {})
        ab.append((st, res["job"]["finalized"], res["generation"],
                   res["ab_window"]))
        ab.append(http(base, f"/v1/kernels/{name}/infer", {"inputs": x})[1])
        metrics = http(base, "/metrics?format=json")[1]
    finally:
        stop(httpd, app)
    path = snap["path"]
    with open(os.path.join(path, "console.log")) as fp:
        console = fp.read()
    with open(os.path.join(path, "kernel.opt"), "rb") as fp:
        opt = fp.read()
    return {"snap": snap, "opt": opt, "console": console, "seq": seq,
            "failures": failures, "oks": oks[0], "events": events,
            "gen": gen, "ab": ab, "metrics": metrics,
            "conf": os.path.join(path, "nn.conf"),
            "ckpt": os.path.join(path, "ckpt")}


def _offline(tmp_path, conf):
    """The port's ``train_nn -v -v --epochs 3 --ckpt-every 1`` of a job's
    conf: (kernel.opt bytes, iterations)."""
    import contextlib
    import io

    from hpnn_tpu_torch import cli

    run = tmp_path / "offline"
    run.mkdir()
    cwd = os.getcwd()
    os.chdir(run)
    try:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli.train_nn_main(["-v", "-v", "--device", "cpu",
                                    f"--epochs={EPOCHS}", "--ckpt-every=1",
                                    "--ckpt-dir=ck", conf])
    finally:
        os.chdir(cwd)
    assert rc == 0
    iters = sum(int(v) for v in re.findall(r"N_ITER=\s*(\d+)",
                                           out.getvalue()))
    return (run / "kernel.opt").read_bytes(), iters


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_train_job_e2e_parity_under_traffic(tmp_path, variant):
    from hpnn_tpu_torch import ckpt

    kind, train, cseed, boost, seed = VARIANTS[variant]
    corpus = write_corpus(tmp_path / "samples", cseed, 12, boost=boost)
    conf = serve_conf(tmp_path, kind=kind)
    params = {"epochs": EPOCHS, "seed": seed, "train": train,
              "samples": corpus, "ckpt_every": 1, "hidden": [N_HID]}
    res = {}
    for pkg in PKGS:
        # the same job dir path for both, so the console's paths agree
        res[pkg] = _job_under_traffic(pkg, tmp_path, conf, params)
        os.rename(tmp_path / "jobs", tmp_path / f"jobs-{pkg}")
    port, jax = res["port"], res["jax"]
    snap = port["snap"]
    assert snap["status"] == jax["snap"]["status"] == "done", snap
    assert snap["epoch"] == EPOCHS
    # byte parity with the port's offline CLI run of the job's conf
    off_opt, iters = _offline(tmp_path, port["conf"].replace(
        str(tmp_path / "jobs"), str(tmp_path / "jobs-port")))
    assert port["opt"] == off_opt
    # the JAX job's kernel within the train_nn parity bound
    tol = 5e-12 + (iters * 6e-15 if kind == "SNN" else 0.0)
    werr = max(float(np.abs(a - b).max()) for a, b in zip(
        _weights(tmp_path / "jobs-jax/job-000001/kernel.opt"),
        _weights(tmp_path / "jobs-port/job-000001/kernel.opt")))
    assert werr < tol, (werr, tol)
    assert _console(port["console"]) == _console(jax["console"])
    assert "EPOCH        3/       3" in port["console"]
    # the error trajectory: the JAX job's within 1e-12, the manifest's
    manifest = ckpt.read_manifest(tmp_path / "jobs-port/job-000001/ckpt")
    assert snap["errors"] == manifest["errors"]
    np.testing.assert_allclose(snap["errors"], jax["snap"]["errors"],
                               rtol=0, atol=1e-12)
    # served throughout: every request 200, >= 3 swaps landed
    assert port["failures"] == [] and port["oks"] > 0
    assert len(snap["generations"]) >= 3
    assert snap["generations"] == jax["snap"]["generations"]
    assert port["gen"] == 1 + len(snap["generations"])
    # the worker's record sequence and the events feed
    assert port["seq"] == jax["seq"]
    assert port["events"][0] == "application/x-ndjson"
    assert port["events"][-1]["status"] == "done"
    assert port["events"][-1]["errors"] == snap["errors"]
    assert any(e["status"] in ("running", "snapshotting")
               for e in port["events"][1:])
    # A/B pinning (fraction 1: unpinned traffic stays on the previous
    # generation), pin, promote, then the new weights for everyone
    for a, b in zip(port["ab"], jax["ab"]):
        if isinstance(a, dict):
            assert a["generation"] == b["generation"]
            np.testing.assert_allclose(a["outputs"], b["outputs"], rtol=0,
                                       atol=1e-12)
        else:
            assert a == b
    assert port["ab"][0]["generation"] == port["gen"] - 1
    assert port["ab"][2][:2] == (200, "promoted")
    assert port["ab"][3]["outputs"] == port["ab"][1]["outputs"]
    # the jobs metrics: the JAX keys, the same counts
    pj, jj = port["metrics"]["jobs"], jax["metrics"]["jobs"]
    assert set(pj) == set(jj)
    assert mask(pj) == mask(jj)
    assert pj["trained_epochs_total"] == EPOCHS
    assert pj["by_status"] == {"done": 1}


@pytest.mark.parametrize("every", [1, 2])
def test_job_record_sequence_matches_jax(tmp_path, every):
    """No traffic, 3 epochs of SNN-BP: the worker's writes (snapshotting
    at due boundaries, the joins of pipelined epochs) and the final
    record equal the JAX package's at ckpt_every 1 and 2."""
    corpus = write_corpus(tmp_path / "samples", 7, 12)
    conf = serve_conf(tmp_path, kind="SNN")
    got = {}
    for pkg in PKGS:
        app = make_app(pkg, conf, max_batch=8)
        sched = enable_jobs(pkg, app, tmp_path / pkg / "jobs", capacity=1)
        seq = []
        _record_updates(sched, seq)
        httpd, base = serve(pkg, app)
        try:
            st, job, _ = http(base, "/v1/kernels/tiny/train",
                              {"epochs": EPOCHS, "seed": 32, "type": "SNN",
                               "samples": corpus, "ckpt_every": every})
            assert st == 202, job
            snap = wait_terminal(base, job["job_id"])
        finally:
            stop(httpd, app)
        ck = os.path.join(snap["path"], "ckpt")
        got[pkg] = (seq, mask(snap, [tmp_path / pkg]),
                    sorted(d for d in os.listdir(ck) if d.startswith("ep")))
        shutil.rmtree(tmp_path / pkg)
    port, jax = got["port"], got["jax"]
    assert [s[:2] + s[3:] for s in port[0]] == \
        [s[:2] + s[3:] for s in jax[0]]
    assert [s[2] for s in port[0]] == [s[2] for s in jax[0]]
    assert port[2] == jax[2]
    for rec in (port[1], jax[1]):
        rec.pop("errors")
    assert port[1] == jax[1]
    assert port[1]["status"] == "done"
