"""The port's span tracing, flight recorder, span spool and profiler
against the JAX package, on the CPU.

* span/ring semantics: nesting, the bounded ring, explicit context,
  ``since_seq`` paging and the ring id; the off path allocates nothing;
* seeded head sampling makes the JAX package's decisions and counts;
* the same span dicts through both packages' ``SpanExporter`` give
  byte-identical segments; the spool reads back past a torn tail;
  ``dump_to_dir`` reuses the spool;
* span-name trees (names, parentage, attributes other than ids, times
  and thread names) of one traced infer request, one
  ``train_nn --epochs 2`` and one training job equal the JAX package's,
  less the port's own spans (``PORT_ONLY``), which the JAX package does
  not record;
* ``/v1/debug/*`` status codes with tracing off and with auth required,
  and ``POST /v1/debug/profile`` on the CPU's ``torch.profiler``.
"""

import contextlib
import io
import json
import os
import time
import tracemalloc
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from hpnn_tpu.obs import trace as jax_trace
from hpnn_tpu_torch import obs
from hpnn_tpu_torch.obs import trace as obs_trace

N_IN, N_HID, N_OUT = 8, 6, 3
VOLATILE = {"trace", "span", "parent", "ts", "dur_s", "thread", "seq"}
# leaf spans the port records and the JAX package does not: the kernel
# file's parse and the join's parts (api's module docstring)
PORT_ONLY = {"kernel_parse", "stats_wait", "epoch_render", "weights_export"}


def _reset():
    for mod in (obs_trace, jax_trace):
        mod.disable()
        mod.set_sample_rate(None)
        mod.set_exporter(None)
        mod.set_role(None)


@pytest.fixture(autouse=True)
def _obs_reset(monkeypatch):
    """Tracing off, no sampler, no exporter in both packages, before and
    after every test; one intra-op thread for the eager loop."""
    for k in ("HPNN_TRACE", "HPNN_TRACE_SAMPLE", "HPNN_TRACE_SAMPLE_SEED",
              "HPNN_SPAN_DIR", "HPNN_PROFILE", "HPNN_DBG_TRACE"):
        monkeypatch.delenv(k, raising=False)
    _reset()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    _reset()


def forest(spans, root_dir=None):
    """Canonical span forest: every root with its subtree, as nested
    (name, attrs, children) tuples; ids, times and threads dropped and
    siblings sorted, so two runs compare by structure alone.  A path
    under ``root_dir`` (each package's own directory) reads as
    ``<root>``."""
    kids: dict = {}
    ids = {s["span"] for s in spans}
    for s in spans:
        parent = s["parent"] if s["parent"] in ids else None
        kids.setdefault(parent, []).append(s)

    def node(s):
        attrs = tuple(sorted(
            (k, repr(v).replace(root_dir, "<root>") if root_dir
             else repr(v))
            for k, v in s.items() if k not in VOLATILE and k != "name"))
        children = tuple(sorted(node(c) for c in kids.get(s["span"], [])))
        return (s["name"], attrs, children)

    return sorted(node(s) for s in kids.get(None, []))


def _http(base, path, payload=None, headers=None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(base + path, data=data,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            raw = r.read()
            return r.status, raw, dict(r.headers)
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read(), dict(exc.headers)


# --- span and ring semantics ------------------------------------------------

def test_span_nesting_ring_and_since_seq():
    obs.enable(capacity=16)
    rid = obs.ring_id()
    assert len(rid) == 16 and obs.last_seq() == 0
    with obs.span("outer", k=1) as outer:
        assert obs.current_ctx() == (outer.trace_id, outer.span_id)
        with obs.span("inner") as inner:
            inner.annotate(x=2)
    spans = obs.snapshot()
    assert [s["name"] for s in spans] == ["inner", "outer"]
    assert spans[0]["parent"] == spans[1]["span"]
    assert spans[0]["trace"] == spans[1]["trace"] == outer.trace_id
    assert spans[0]["x"] == 2 and spans[1]["k"] == 1
    assert obs.current_ctx() is None
    sid = obs.record("explicit", 1.0, 2.0, trace_id="t-x",
                     parent_id="p-1", rows=3)
    got = obs.snapshot(trace_id="t-x")
    assert got[0]["span"] == sid and got[0]["parent"] == "p-1"
    assert got[0]["dur_s"] == 1.0 and got[0]["rows"] == 3
    assert [s["seq"] for s in obs.snapshot(since_seq=2)] == [3]
    assert obs.snapshot(limit=0) == []
    for i in range(40):
        obs.record("w", 0.0, 0.0, trace_id="ring", i=i)
    ring = obs.snapshot()
    assert len(ring) == 16 and ring[-1]["i"] == 39 and ring[0]["i"] == 24
    assert obs.last_seq() == 43 and obs.ring_id() == rid
    with pytest.raises(ValueError):
        with obs.span("boom"):
            raise ValueError("bad")
    assert obs.snapshot(limit=1)[0]["error"] == "ValueError: bad"
    obs.enable(capacity=32)          # a new ring: a new identity
    assert obs.ring_id() != rid and obs.last_seq() == 0


def test_render_ndjson_matches_jax_package():
    spans = [{"name": "a", "trace": "t", "span": "s1", "parent": None,
              "ts": 1.5, "dur_s": 0.25, "thread": "m", "seq": 1, "z": 1},
             {"name": "b", "trace": "t", "span": "s2", "parent": "s1",
              "ts": 1.6, "dur_s": 0.0, "thread": "m", "seq": 2}]
    assert obs.render_ndjson(spans) == jax_trace.render_ndjson(spans)
    assert obs.render_ndjson([]) == ""


def test_disabled_is_zero_allocation_noop():
    assert not obs.enabled()
    assert obs.span("x") is obs.span("y", a=1)   # the shared no-op
    assert obs.record("x", 0.0, 1.0) == ""
    tracemalloc.start()
    try:
        snap0 = tracemalloc.take_snapshot()
        for _ in range(2000):
            with obs.span("hot"):
                pass
            obs.record("hot", 0.0, 0.0)
        snap1 = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    here = [d for d in snap1.compare_to(snap0, "filename")
            if "obs/trace.py" in str(d.traceback) and d.size_diff > 0]
    assert here == []
    assert obs.snapshot() == [] and obs.last_seq() == 0


def test_serveapp_trace_false_wins_over_env(tmp_path, monkeypatch):
    from test_torch_jobs import make_app, serve_conf

    monkeypatch.setenv("HPNN_TRACE", "1")
    app = make_app("port", serve_conf(tmp_path), trace=False)
    try:
        assert not obs.enabled()
    finally:
        app.close()
    app = make_app("port", serve_conf(tmp_path, name="t2"))
    try:
        assert obs.enabled()   # None defers to the env
    finally:
        app.close()


# --- head sampling -----------------------------------------------------------

def test_seeded_sampling_matches_jax_package(monkeypatch):
    pattern = [i % 7 == 0 for i in range(200)]
    got = {}
    for name, mod in (("jax", jax_trace), ("port", obs_trace)):
        mod.set_sample_rate(0.3, seed=1234)
        dec = [mod.sample_trace(force=f) for f in pattern]
        got[name] = (dec, mod.sample_stats())
        monkeypatch.setenv("HPNN_TRACE_SAMPLE_SEED", "99")
        monkeypatch.setenv("HPNN_TRACE_SAMPLE", "0.5")
        mod.set_sample_rate_from_env()
        got[name] += ([mod.sample_trace() for _ in range(64)],
                      mod.sample_stats())
        monkeypatch.delenv("HPNN_TRACE_SAMPLE_SEED")
        monkeypatch.delenv("HPNN_TRACE_SAMPLE")
        mod.set_sample_rate(None)
        assert mod.sample_stats() is None and mod.sample_trace()
    assert got["port"] == got["jax"]
    dec, st = got["port"][:2]
    assert True in dec and False in dec
    assert st["forced_total"] == sum(pattern)
    assert st["sampled_total"] + st["dropped_total"] == len(pattern)


# --- the durable spool -------------------------------------------------------

def _spans(n, t0=1000.0):
    out = []
    for i in range(n):
        tid = f"t{i % 5:02d}"
        root = f"{tid}-r{i}"
        out.append({"name": "serve.request", "trace": tid, "span": root,
                    "parent": None, "ts": t0 + i * 0.01, "dur_s": 0.004,
                    "thread": "h", "seq": 2 * i + 1, "kernel": "tiny",
                    "outcome": "ok"})
        out.append({"name": "device_launch", "trace": tid,
                    "span": f"{root}-d", "parent": root,
                    "ts": t0 + i * 0.01 + 0.001, "dur_s": 0.002,
                    "thread": "b", "seq": 2 * i + 2, "bucket": 4})
    return out


def _segment_bytes(span_dir, segment_cls, listing, spans):
    exp = segment_cls(span_dir, segment_bytes=1024, segment_age_s=3600.0,
                      max_dir_bytes=1 << 20, queue_spans=4096)
    try:
        for s in spans:
            exp.offer(s)
        exp.flush()
        stats = exp.stats()
    finally:
        exp.close()
    segs = listing(span_dir)
    body = [open(p, "rb").read() for p in segs]
    side = []
    for p in segs:
        with open(p + ".idx.json") as fp:
            idx = json.load(fp)
        idx.pop("segment")      # the file name carries the wall second
        side.append(json.dumps(idx, sort_keys=True))
    keep = ("exported_total", "dropped_total", "rotations_total",
            "segments", "index_builds_total")
    return body, side, {k: stats.get(k) for k in keep}


def test_exporter_segments_byte_identical_to_jax(tmp_path):
    from hpnn_tpu.obs import export as jax_export
    from hpnn_tpu_torch.obs import export as port_export

    spans = _spans(60)
    jx = _segment_bytes(str(tmp_path / "j"), jax_export.SpanExporter,
                        jax_export.list_segments, spans)
    pt = _segment_bytes(str(tmp_path / "p"), port_export.SpanExporter,
                        port_export.list_segments, spans)
    assert pt == jx
    assert len(pt[0]) >= 3 and pt[2]["exported_total"] == 120
    assert port_export.read_spool(str(tmp_path / "p")) == \
        jax_export.read_spool(str(tmp_path / "j"))


def test_spool_read_back_torn_tail_and_dump(tmp_path):
    from hpnn_tpu_torch.obs.export import SpanExporter, read_spool

    d = tmp_path / "torn"
    d.mkdir()
    good = {"name": "w", "trace": "t1", "span": "a", "ts": 1.0}
    (d / "spans-1-100-000001.ndjson").write_text(
        json.dumps(good) + "\n" + '{"name": "w", "trace": "t1", "sp')
    assert read_spool(str(d)) == [good]
    spool = str(tmp_path / "spool")
    exp = SpanExporter(spool, segment_age_s=3600.0)
    try:
        obs_trace.set_exporter(exp)
        obs.enable(capacity=64)
        with obs.span("pre-crash", trace_id="t-dump"):
            pass
        path = obs.dump_to_dir(str(tmp_path / "elsewhere"), reason="fault")
        assert path is not None and path.startswith(spool)
        assert not (tmp_path / "elsewhere").exists()
        assert [s["name"] for s in read_spool(spool, trace_id="t-dump")] \
            == ["pre-crash"]
    finally:
        obs_trace.set_exporter(None)
        exp.close()
    # without a spool: the ring into <dir>/trace-<reason>-<role>-<pid>
    obs.set_role("local")
    path = obs.dump_to_dir(str(tmp_path / "dump"), reason="shutdown")
    assert os.path.basename(path) == \
        f"trace-shutdown-local-{os.getpid()}.ndjson"
    assert json.loads(open(path).readline())["name"] == "pre-crash"


# --- span trees against the JAX package --------------------------------------

def _serve_pair(tmp_path, pkg, **kw):
    from test_torch_jobs import make_app, serve, serve_conf

    app = make_app(pkg, serve_conf(tmp_path / pkg, kind="SNN"), **kw)
    httpd, base = serve(pkg, app)
    return app, httpd, base


def _wait_tree(mod, trace_id, n, timeout_s=10.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        spans = mod.snapshot(trace_id=trace_id)
        if len(spans) >= n:
            return spans
        time.sleep(0.01)
    raise AssertionError(f"{trace_id}: {len(spans)} of {n} spans")


def test_infer_request_span_tree_matches_jax(tmp_path):
    from test_torch_jobs import stop

    xs = np.random.default_rng(3).uniform(-1, 1, (3, N_IN)).tolist()
    got = {}
    for pkg, mod in (("jax", jax_trace), ("port", obs_trace)):
        (tmp_path / pkg).mkdir()
        app, httpd, base = _serve_pair(tmp_path, pkg, trace=True,
                                       warmup=True)
        try:
            st, raw, hdrs = _http(base, "/v1/kernels/tiny/infer",
                                  {"inputs": xs},
                                  {"X-HPNN-Trace-Id": "req-42"})
            assert st == 200 and hdrs["X-HPNN-Trace-Id"] == "req-42"
            assert json.loads(raw)["trace"] == "req-42"
            spans = _wait_tree(mod, "req-42", 8)
            st, dump, hdrs = _http(base, "/v1/debug/trace?trace=req-42")
            assert st == 200 and hdrs["X-HPNN-Trace-Ring"] == mod.ring_id()
            assert [json.loads(ln)["name"] for ln in
                    dump.decode().splitlines()] == [s["name"] for s in spans]
        finally:
            stop(httpd, app)
        got[pkg] = forest(spans)
    assert got["port"] == got["jax"]
    (root,) = got["port"]
    assert root[0] == "serve.request"
    assert sorted(c[0] for c in root[2]) == sorted(
        ["parse", "queue_wait", "batch_assembly", "pad_h2d",
         "device_launch", "d2h", "respond"])


def _write_corpus(dirpath, rng, n=6):
    os.makedirs(dirpath)
    for i in range(n):
        cls = i % N_OUT
        x = rng.uniform(-1, 1, N_IN)
        x[cls] += 2.0
        t = np.zeros(N_OUT)
        t[cls] = 1.0
        with open(os.path.join(dirpath, f"s{i:03d}"), "w") as fp:
            fp.write(f"[input] {N_IN}\n" + " ".join(f"{v:7.5f}" for v in x)
                     + f"\n[output] {N_OUT}\n"
                     + " ".join(f"{v:.1f}" for v in t) + "\n")


def test_train_nn_epochs_span_tree_matches_jax(tmp_path, monkeypatch):
    from hpnn_tpu import cli as jax_cli
    from hpnn_tpu.io import samples as jax_samples
    from hpnn_tpu_torch import cli as port_cli

    rng = np.random.default_rng(7)
    _write_corpus(str(tmp_path / "samples"), rng)
    _write_corpus(str(tmp_path / "tests"), rng)
    (tmp_path / "nn.conf").write_text(
        "[name] tiny\n[type] SNN\n[init] generate\n[seed] 1234\n"
        f"[input] {N_IN}\n[hidden] {N_HID}\n[output] {N_OUT}\n"
        "[train] BPM\n[sample_dir] ./samples\n[test_dir] ./tests\n")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(jax_samples, "_native_warned", True)
    monkeypatch.setenv("HPNN_TRACE", "1")
    got = {}
    for pkg, mod, fn in (("jax", jax_trace, jax_cli.train_nn_main),
                         ("port", obs_trace, port_cli.train_nn_main)):
        argv = ["--epochs", "2", "--ckpt-every", "1", "--ckpt-dir",
                f"ck-{pkg}", "nn.conf"]
        if pkg == "port":
            argv = ["--device", "cpu"] + argv
        with contextlib.redirect_stdout(io.StringIO()):
            assert fn(argv) == 0
        spans = mod.snapshot()
        if pkg == "port":
            drains = [s["span"] for s in spans if s["name"] == "stats_drain"]
            # every drain exports the weights; one with an epoch renders it
            assert {(s["name"], s["parent"] in drains) for s in spans
                    if s["name"] in PORT_ONLY} == {("epoch_render", True),
                                                   ("weights_export", True)}
            spans = [s for s in spans if s["name"] not in PORT_ONLY]
        got[pkg] = forest(spans)
        mod.disable()
    assert got["port"] == got["jax"]
    names = [r[0] for r in got["port"]]
    assert names == ["configure", "train_kernel"]
    epochs = [e for e in got["port"][1][2] if e[0] == "train.epoch"]
    assert len(epochs) == 2
    assert {c[0] for c in epochs[0][2]} == {
        "corpus_load", "train_epoch", "stats_drain", "ckpt.snapshot_write"}
    assert {c[0] for c in epochs[0][2][-1][2]} == {"corpus_gather",
                                                   "device_launch"}


def test_job_span_tree_matches_jax(tmp_path):
    from test_torch_jobs import (enable_jobs, make_app, post_mp, serve,
                                 serve_conf, stop, wait_terminal,
                                 write_corpus)

    params = {"epochs": 2, "seed": 32, "train": "BP", "type": "SNN",
              "ckpt_every": 1}
    got = {}
    for pkg, mod in (("jax", jax_trace), ("port", obs_trace)):
        (tmp_path / pkg).mkdir()
        conf = serve_conf(tmp_path / pkg, kind="SNN")
        d = write_corpus(tmp_path / pkg / "src", 7, 12)
        files = [(n, open(os.path.join(d, n)).read())
                 for n in sorted(os.listdir(d))]
        app = make_app(pkg, conf, max_batch=8, trace=True)
        enable_jobs(pkg, app, tmp_path / pkg / "jobs", capacity=2)
        httpd, base = serve(pkg, app)
        try:
            st, job, _ = post_mp(base, "/v1/kernels/tiny/train", params,
                                 files)
            assert st == 202, job
            assert wait_terminal(base, job["job_id"])["status"] == "done"
            spans = [s for s in mod.snapshot(trace_id=f"job:{job['job_id']}")
                     if s["name"] not in PORT_ONLY]
            st, tl, _ = _http(base, "/v1/debug/trace?timeline=1")
            assert st == 200
            states = [(e["detail"]["previous"], e["detail"]["status"])
                      for e in map(json.loads, tl.decode().splitlines())
                      if e["name"] == "job.state"]
        finally:
            stop(httpd, app)
        got[pkg] = (forest(spans, str(tmp_path / pkg)), states)
        mod.disable()
    assert got["port"] == got["jax"]
    trees, states = got["port"]
    assert states == [("", "queued"), ("queued", "running"),
                      ("running", "snapshotting"),
                      ("snapshotting", "running"),
                      ("running", "snapshotting"),
                      ("snapshotting", "running"), ("running", "done")]
    run = next(t for t in trees if t[0] == "jobs.run")
    epochs = [c for c in run[2] if c[0] == "train.epoch"]
    assert len(epochs) == 2
    for ep in epochs:
        assert {"ckpt.snapshot_write", "serve.hot_swap"} <= \
            {c[0] for c in ep[2]}


# --- the debug endpoints -----------------------------------------------------

def test_debug_endpoints_off_and_auth(tmp_path):
    from test_torch_jobs import stop

    got = {}
    for pkg in ("jax", "port"):
        (tmp_path / pkg).mkdir()
        app, httpd, base = _serve_pair(tmp_path, pkg, auth_token="s3cret")
        auth = {"Authorization": "Bearer s3cret"}
        try:
            codes = [_http(base, p)[0] for p in (
                "/v1/debug/trace", "/v1/debug/trace?spool=1",
                "/v1/debug/trace?timeline=1", "/v1/debug/trace/search",
                "/v1/debug/trace/critical")]
            codes.append(_http(base, "/v1/debug/profile",
                               {"seconds": 1})[0])
            for body in ({"seconds": "x"}, {"seconds": -2},
                         {"seconds": 301}, [1]):
                codes.append(_http(base, "/v1/debug/profile", body,
                                   auth)[0])
            reasons = [json.loads(_http(base, p)[1])["reason"] for p in (
                "/v1/debug/trace", "/v1/debug/trace?spool=1")]
        finally:
            stop(httpd, app)
        got[pkg] = (codes, reasons)
    assert got["port"] == got["jax"]
    assert got["port"][0] == [404] * 5 + [401] + [400] * 4


def test_profile_endpoint_on_cpu_torch_profiler(tmp_path):
    from hpnn_tpu_torch.obs import profiler
    from test_torch_jobs import stop

    (tmp_path / "port").mkdir()
    app, httpd, base = _serve_pair(tmp_path, "port",
                                   profile_dir=str(tmp_path / "prof"))
    xs = {"inputs": [[0.5] * N_IN]}
    try:
        st, raw, _ = _http(base, "/v1/debug/profile", {"seconds": 0.3})
        assert st == 200, raw
        rec = json.loads(raw)
        assert rec["dir"] == str(tmp_path / "prof")
        assert rec["requested_seconds"] == 0.3 and rec["seconds"] >= 0.3
        assert rec["trace_file"].endswith(".pt.trace.json")
        with open(rec["trace_file"]) as fp:
            events = json.load(fp)["traceEvents"]
        assert isinstance(events, list)
        assert profiler.active() is None
        # one capture at a time: a running profile makes the endpoint 409
        profiler.start(str(tmp_path / "other"))
        try:
            assert _http(base, "/v1/debug/profile", {"seconds": 0.1})[0] \
                == 409
            with profiler.profile_run(str(tmp_path / "cli")):
                pass   # a CLI run warns and runs unprofiled
        finally:
            rec2 = profiler.stop()
        assert os.path.isfile(rec2["trace_file"])
        assert _http(base, "/v1/kernels/tiny/infer", xs)[0] == 200
        with pytest.raises(profiler.ProfilerUnavailable):
            profiler.stop()
    finally:
        stop(httpd, app)


def test_live_capture_holds_other_threads_host_operators(tmp_path):
    """A capture started on one thread (the debug endpoint's handler)
    records the host operators of every other thread (the batchers, the
    router's RPC threads): cpu_op rows from a second thread's id."""
    import threading

    from hpnn_tpu_torch.obs import profiler

    stop_ev = threading.Event()
    tid = {}

    def work():
        tid["id"] = threading.get_native_id()
        a = torch.randn(64, 64)
        while not stop_ev.is_set():
            a = a @ a
            a = a / a.norm()

    profiler.start(str(tmp_path / "prof"))
    t = threading.Thread(target=work)
    try:
        t.start()
        time.sleep(0.3)
    finally:
        stop_ev.set()
        t.join()
        rec = profiler.stop()
    with open(rec["trace_file"]) as fp:
        events = json.load(fp)["traceEvents"]
    ops = [e for e in events
           if e.get("cat") == "cpu_op" and e.get("tid") == tid["id"]]
    assert {"aten::mm", "aten::div"} <= {e["name"] for e in ops}
    assert rec["threads"] == "all"


def test_metrics_families_with_sampler_and_spool(tmp_path):
    from test_torch_jobs import stop

    got = {}
    for pkg in ("jax", "port"):
        (tmp_path / pkg).mkdir()
        app, httpd, base = _serve_pair(
            tmp_path, pkg, trace=True, trace_sample=0.0,
            span_dir=str(tmp_path / pkg / "spool"))
        xs = {"inputs": [[0.0] * N_IN]}
        try:
            assert _http(base, "/v1/kernels/tiny/infer", xs)[0] == 200
            st, raw, hdrs = _http(base, "/v1/kernels/tiny/infer", xs,
                                  {"X-HPNN-Priority": "high"})
            assert st == 200 and json.loads(raw)["trace"] \
                == hdrs["X-HPNN-Trace-Id"]
            snap = app.metrics.snapshot()
            text = app.metrics.render_prometheus()
        finally:
            stop(httpd, app)
        fams = sorted({ln.split()[2] for ln in text.splitlines()
                       if ln.startswith("# TYPE hpnn_trace")
                       or ln.startswith("# TYPE hpnn_span_export")})
        got[pkg] = (snap["trace_sampling"], fams,
                    'hpnn_trace_decisions_total{outcome="dropped"} 1'
                    in text)
    assert got["port"] == got["jax"]
    assert got["port"][0]["forced_total"] == 1


def test_serve_shutdown_dump_into_the_dump_dir(tmp_path):
    """serve_nn's post-mortem on a drain: the ring as
    ``trace-shutdown-local-<pid>.ndjson`` in the dump dir (the job dir, or
    the cwd without jobs) when no spool is set; with ``--span-dir`` the
    spool's last rotated segment instead, and no second file."""
    from hpnn_tpu_torch.cli import _shutdown_dump
    from test_torch_jobs import make_app, serve_conf

    obs.set_role("local")
    app = make_app("port", serve_conf(tmp_path), trace=True)
    try:
        with obs.span("before-drain", trace_id="t-d"):
            pass
    finally:
        app.close()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        _shutdown_dump(app, str(tmp_path / "jobs"))
    path = tmp_path / "jobs" / f"trace-shutdown-local-{os.getpid()}.ndjson"
    assert out.getvalue() == f"SERVE: flight recorder dumped to {path}\n"
    # the served kernel's configure parsed its file under tracing
    assert [json.loads(ln)["name"] for ln in path.read_text().splitlines()] \
        == ["kernel_parse", "before-drain"]
    app = make_app("port", serve_conf(tmp_path, name="t2"), trace=True,
                   span_dir=str(tmp_path / "spans"))
    with obs.span("spooled", trace_id="t-s"):
        pass
    app.close()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        _shutdown_dump(app, str(tmp_path / "elsewhere"))
    (seg,) = [n for n in os.listdir(tmp_path / "spans")
              if n.endswith(".ndjson")]
    assert out.getvalue() == ("SERVE: flight recorder dumped to "
                              f"{tmp_path / 'spans' / seg}\n")
    assert not (tmp_path / "elsewhere").exists()
