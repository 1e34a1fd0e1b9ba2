"""The port's trace analytics against the JAX package, on the CPU: the
span spool's sidecar indexes, critical-path reports, the incident
timeline and the offline tool.

* the same span dicts through both packages' ``index``, ``analyze`` and
  ``render_timeline`` give byte-identical sidecars, search answers,
  critical reports and timelines;
* ``python -m hpnn_tpu.obs.tool`` and ``python -m hpnn_tpu_torch.obs.tool``
  print the same stdout over one span dir, and take the same exit codes;
* a live port server's ``/v1/debug/trace/search``, ``/critical`` and
  ``?timeline=1`` bodies equal the port tool's stdout over its spool;
* ``nn_event`` mirrors events into the ``events`` trace and job status
  changes land as ``job.state`` spans, as in the JAX package;
* every event name the port emits is declared in ``obs.EVENT_NAMES``.
"""

import contextlib
import io
import json
import os
import re
import time

import numpy as np
import pytest

from hpnn_tpu.obs import analyze as jax_analyze
from hpnn_tpu.obs import index as jax_index
from hpnn_tpu.obs import trace as jax_trace
from hpnn_tpu.obs import export as jax_export
from hpnn_tpu.obs import tool as jax_tool
from hpnn_tpu_torch import obs
from hpnn_tpu_torch.obs import analyze, export, tool
from hpnn_tpu_torch.obs import index as trace_index
from hpnn_tpu_torch.obs import trace as obs_trace
from hpnn_tpu_torch.utils import nn_log

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_IN = 8


@pytest.fixture(autouse=True)
def _obs_reset(monkeypatch):
    for k in ("HPNN_TRACE", "HPNN_TRACE_SAMPLE", "HPNN_SPAN_DIR",
              "HPNN_TRACE_INDEX", "HPNN_TRACE_SEARCH_LIMIT"):
        monkeypatch.delenv(k, raising=False)
    for mod in (obs_trace, jax_trace):
        mod.disable()
        mod.set_exporter(None)
    nn_log.set_verbosity(0)
    yield
    for mod in (obs_trace, jax_trace):
        mod.disable()
        mod.set_exporter(None)
    nn_log.set_verbosity(0)


def _mk(trace, name, t0, dur, parent=None, span=None, **attrs):
    rec = {"name": name, "trace": trace,
           "span": span or f"{trace}-{name}-{t0:.6f}", "parent": parent,
           "ts": round(t0, 6), "dur_s": round(dur, 9), "thread": "t"}
    rec.update(attrs)
    return rec


def _corpus_spans(base=1.7e9):
    """Request trees of two kernels with varied phases and outcomes, job
    transitions, events and a remote half: what a live server spools."""
    spans = []
    rng = np.random.default_rng(11)
    for i in range(24):
        tid = f"r{i:03d}"
        t0 = base + i * 0.05
        kernel = "tiny" if i % 3 else "wide"
        q = float(rng.uniform(0.0005, 0.006))
        dev = float(rng.uniform(0.001, 0.004))
        total = 0.001 + q + dev + 0.0008
        root = f"{tid}-root"
        outcome = "ok" if i % 7 else "deadline"
        spans += [
            _mk(tid, "serve.request", t0, total, span=root, kernel=kernel,
                outcome=outcome, **({} if outcome == "ok"
                                    else {"status": 504})),
            _mk(tid, "parse", t0, 0.0004, parent=root, rows=1 + i % 4),
            _mk(tid, "queue_wait", t0 + 0.0004, q, parent=root),
            _mk(tid, "device_launch", t0 + 0.0004 + q, dev, parent=root,
                bucket=4, tier="strict"),
            _mk(tid, "d2h", t0 + 0.0004 + q + dev, 0.0003, parent=root),
            _mk(tid, "respond", t0 + total, 0.0002, parent=root),
        ]
    spans += [
        _mk("job:job-000001", "job.state", base + 0.3, 0.0,
            job="job-000001", status="running", previous="queued",
            epoch=0),
        _mk("events", "event.ckpt_fallback", base + 0.4, 0.0,
            bundle="ep00000001", reason="torn"),
        _mk("events", "event.slow_request", base + 0.5, 0.0,
            kernel="tiny", event_trace="r009"),
        _mk("mesh", "mesh.shed_engaged", base + 0.6, 0.0, lane="low"),
    ]
    return spans


def _spool(span_dir, mod, spans):
    exp = mod.SpanExporter(span_dir, segment_bytes=4096,
                           segment_age_s=3600.0, queue_spans=8192)
    try:
        for s in spans:
            exp.offer(s)
        exp.flush()
    finally:
        exp.close()
    return mod.list_segments(span_dir)


def _sidecars(segs):
    out = []
    for p in segs:
        with open(p + ".idx.json") as fp:
            idx = json.load(fp)
        idx["segment"] = os.path.basename(p).split("-")[-1]
        out.append(idx)
    return out


def test_index_search_and_fetch_byte_identical(tmp_path):
    spans = _corpus_spans()
    j_dir, p_dir = str(tmp_path / "j"), str(tmp_path / "p")
    j_segs = _spool(j_dir, jax_export, spans)
    p_segs = _spool(p_dir, export, spans)
    assert len(p_segs) >= 3
    assert _sidecars(p_segs) == _sidecars(j_segs)
    for q in ({}, {"kernel": "tiny"}, {"kernel": "wide", "min_ms": "4"},
              {"status": "deadline"}, {"trace": "r005"}, {"limit": "3"},
              {"since": f"{1.7e9 + 0.4}", "until": f"{1.7e9 + 0.9}"}):
        assert json.dumps(trace_index.search(p_dir, dict(q))) == \
            json.dumps(jax_index.search(j_dir, dict(q))), q
        assert json.dumps(trace_index.search_spans(spans, dict(q))) == \
            json.dumps(jax_index.search_spans(spans, dict(q))), q
    for tid in ("r000", "r013", "events", "nope"):
        assert trace_index.fetch_trace(p_dir, tid) == \
            jax_index.fetch_trace(j_dir, tid)
    assert trace_index.fetch_traces(p_dir, ["r001", "r002"]) == \
        jax_index.fetch_traces(j_dir, ["r001", "r002"])
    for bad in ({"min_ms": "soon"}, {"limit": "x"}):
        with pytest.raises((TypeError, ValueError)):
            trace_index.search(p_dir, bad)


def test_critical_and_timeline_byte_identical(tmp_path):
    spans = _corpus_spans()
    j_dir, p_dir = str(tmp_path / "j"), str(tmp_path / "p")
    _spool(j_dir, jax_export, spans)
    _spool(p_dir, export, spans)
    one = [s for s in spans if s["trace"] == "r004"]
    assert [(s["name"], t) for s, t in analyze.critical_path(one)] == \
        [(s["name"], t) for s, t in jax_analyze.critical_path(one)]
    assert analyze.phase_self_times(one) == \
        jax_analyze.phase_self_times(one)
    for kw in ({}, {"kernel": "tiny"}, {"kernel": "wide", "limit": 3}):
        assert json.dumps(analyze.critical_from_dir(p_dir, **kw)) == \
            json.dumps(jax_analyze.critical_from_dir(j_dir, **kw)), kw
        assert json.dumps(analyze.critical_from_spans(spans, **kw)) == \
            json.dumps(jax_analyze.critical_from_spans(spans, **kw)), kw
    for kw in ({}, {"since": 1.7e9 + 0.3}, {"until": 1.7e9 + 0.5},
               {"limit": 5}):
        text = analyze.render_timeline(analyze.build_timeline(
            export.read_spool(p_dir), **kw))
        assert text == jax_analyze.render_timeline(
            jax_analyze.build_timeline(jax_export.read_spool(j_dir), **kw))
    kinds = {e["name"]: e["kind"] for e in analyze.build_timeline(spans)}
    assert kinds["event.ckpt_fallback"] == "ckpt"
    assert kinds["job.state"] == "jobs" and kinds["serve.request"] == "span"
    roots, _children = analyze.build_tree(one)
    assert [r["name"] for r in roots] == ["serve.request"]


def _tool_out(main, argv):
    out = io.StringIO()
    err = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = main(argv)
        except SystemExit as exc:   # argparse's usage errors
            rc = exc.code
    return rc, out.getvalue()


def test_both_tools_print_the_same_stdout(tmp_path):
    spans = _corpus_spans()
    d = str(tmp_path / "spool")
    segs = _spool(d, export, spans)
    runs = [["index"], ["search"], ["search", "--kernel", "tiny"],
            ["search", "--min-ms", "4", "--limit", "2"],
            ["critical"], ["critical", "--kernel", "wide"],
            ["timeline"], ["timeline", "--limit", "4"],
            ["search", "--min-ms", "soon"], ["critical", "--window", "x"]]
    for argv in runs:
        outs = []
        for main in (tool.main, jax_tool.main):
            for p in segs[:2]:   # each tool finds the same missing ones
                with contextlib.suppress(FileNotFoundError):
                    os.unlink(trace_index.index_path(p))
            outs.append(_tool_out(main, argv[:1] + ["--span-dir", d]
                                  + argv[1:]))
        assert outs[0] == outs[1], argv
    assert json.loads(_tool_out(tool.main, ["index", "--span-dir", d])[1])[
        "segments"] == len(segs)
    assert _tool_out(tool.main, ["search", "--span-dir",
                                 str(tmp_path / "none")]) == (1, "")
    assert _tool_out(tool.main, ["search", "--span-dir", d,
                                 "--limit", "x"])[0] == 2


def test_endpoints_equal_the_port_tool(tmp_path):
    from test_torch_jobs import make_app, serve, serve_conf, stop

    spool = str(tmp_path / "spool")
    app = make_app("port", serve_conf(tmp_path, kind="SNN"), max_batch=16,
                   trace=True, span_dir=spool)
    httpd, base = serve("port", app)

    def get(path):
        import urllib.error
        import urllib.request

        try:
            with urllib.request.urlopen(base + path, timeout=60) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as exc:
            return exc.code, exc.read()

    try:
        xs = np.random.default_rng(5).uniform(-1, 1, (3, N_IN)).tolist()
        import urllib.request

        for i in range(6):
            req = urllib.request.Request(
                base + "/v1/kernels/tiny/infer",
                data=json.dumps({"inputs": xs}).encode(),
                headers={"X-HPNN-Trace-Id": f"reqtrace{i:02d}"})
            with urllib.request.urlopen(req, timeout=60) as r:
                assert r.status == 200
        prev, deadline = None, time.monotonic() + 10
        while time.monotonic() < deadline:   # the last respond span lands
            cur = get("/v1/debug/trace/search?kernel=tiny")
            if cur == prev:
                break
            prev = cur
            time.sleep(0.2)
        st, body = get("/v1/debug/trace/search?kernel=tiny")
        body = json.loads(body)
        assert st == 200 and body["count"] == 6
        assert all(r["root"] == "serve.request" and r["status"] == "ok"
                   for r in body["traces"])
        st, crit = get("/v1/debug/trace/critical?kernel=tiny")
        assert st == 200 and json.loads(crit)["traces_analyzed"] == 6
        assert get("/v1/debug/trace/search?min_ms=soon")[0] == 400
        assert get("/v1/debug/trace/critical?window=x")[0] == 400
        st, spooled = get("/v1/debug/trace?spool=1&trace=reqtrace03")
        assert st == 200 and {json.loads(ln)["name"] for ln in
                              spooled.decode().splitlines()} >= {
            "serve.request", "device_launch", "respond"}
        live = [get("/v1/debug/trace/search?kernel=tiny&min_ms=0")[1],
                get("/v1/debug/trace/critical?kernel=tiny")[1],
                get("/v1/debug/trace?timeline=1")[1]]
    finally:
        stop(httpd, app)
    offline = [_tool_out(tool.main, ["search", "--span-dir", spool,
                                     "--kernel", "tiny", "--min-ms", "0"]),
               _tool_out(tool.main, ["critical", "--span-dir", spool,
                                     "--kernel", "tiny"]),
               _tool_out(tool.main, ["timeline", "--span-dir", spool])]
    assert [o[1].encode() for o in offline] == live


def test_search_without_spool_answers_from_ring_and_404_off(tmp_path):
    from test_torch_jobs import http, make_app, serve, serve_conf, stop

    app = make_app("port", serve_conf(tmp_path, kind="SNN"))
    httpd, base = serve("port", app)
    try:
        assert http(base, "/v1/debug/trace/search")[0] == 404
        obs.enable()
        st, _, _ = http(base, "/v1/kernels/tiny/infer",
                        {"inputs": [[0.0] * N_IN]},
                        headers={"X-HPNN-Trace-Id": "ringtrace"})
        assert st == 200
        st, body, _ = http(base, "/v1/debug/trace/search?trace=ringtrace")
        assert st == 200 and [r["trace"] for r in body["traces"]] == [
            "ringtrace"]
    finally:
        stop(httpd, app)


def test_nn_event_records_event_span_when_tracing(capsys):
    nn_log.set_verbosity(1)
    nn_log.nn_event("ckpt_fallback", bundle="b-1", reason="torn")
    assert obs_trace.snapshot() == []
    obs_trace.enable(256)
    nn_log.nn_event("ckpt_fallback", bundle="b-2", reason="torn")
    nn_log.nn_event("slow_request", kernel="tiny", trace="req123",
                    seconds=0.5, ts=123.0, blob=[1])
    spans = obs_trace.snapshot(trace_id=nn_log.EVENTS_TRACE_ID)
    assert [s["name"] for s in spans] == ["event.ckpt_fallback",
                                          "event.slow_request"]
    assert spans[0]["bundle"] == "b-2" and spans[0]["dur_s"] == 0.0
    assert spans[1]["event_trace"] == "req123"
    assert spans[1]["event_ts"] == 123.0 and "blob" not in spans[1]
    assert obs_trace.snapshot(trace_id="req123") == []
    out = capsys.readouterr().out
    assert out.count("ckpt_fallback:") == 2


def test_job_store_transitions_match_jax(tmp_path):
    from hpnn_tpu.jobs.state import JobStore as JaxStore
    from hpnn_tpu_torch.jobs.state import JobStore

    got = {}
    for pkg, mod, store_cls in (("jax", jax_trace, JaxStore),
                                ("port", obs_trace, JobStore)):
        mod.enable(256)
        store = store_cls(str(tmp_path / pkg))
        job = store.create("tiny", {})
        store.update(job, status="running", started=time.time())
        store.update(job, epoch=1)   # no status change: no span
        store.update(job, status="done")
        got[pkg] = [{k: v for k, v in s.items()
                     if k not in ("span", "ts", "thread", "seq")}
                    for s in mod.snapshot(trace_id=f"job:{job.job_id}")]
    assert got["port"] == got["jax"]
    assert [(s["previous"], s["status"]) for s in got["port"]] == [
        ("", "queued"), ("queued", "running"), ("running", "done")]


_EVENT_CALL_RE = re.compile(
    r"\b(nn_event|mesh_event|nn_log\.nn_event)\(\s*(.)", re.S)
_EVENT_NAME_RE = re.compile(r'^"([a-zA-Z0-9_]+)"')


def test_every_emitted_event_name_is_declared():
    """Source scan over hpnn_tpu_torch/: every nn_event and mesh_event
    call passes a literal name declared in obs.EVENT_NAMES (the
    timeline's category table; mesh_event names with their ``mesh_``
    prefix), and the table is the JAX package's, whole.  The relay in
    serve/mesh/events.py is the one non-literal site."""
    from hpnn_tpu import obs as jax_obs

    offenders, found = [], set()
    root = os.path.join(REPO, "hpnn_tpu_torch")
    for dirpath, _dirs, files in sorted(os.walk(root)):
        for fname in sorted(f for f in files if f.endswith(".py")):
            path = os.path.join(dirpath, fname)
            rel = os.path.relpath(path, root)
            if rel == os.path.join("utils", "nn_log.py"):
                continue   # the emitter itself
            src = open(path).read()
            for m in _EVENT_CALL_RE.finditer(src):
                if "def " in src[max(0, m.start() - 4):m.start()]:
                    continue
                tail = src[m.start(2):m.start(2) + 80]
                if rel == os.path.join("serve", "mesh", "events.py") \
                        and 'f"mesh_{event}"' in tail:
                    continue  # the relay: its callers name the events
                name_m = _EVENT_NAME_RE.match(tail)
                lineno = src[:m.start()].count("\n") + 1
                if name_m is None:
                    offenders.append(f"{rel}:{lineno}: non-literal name")
                    continue
                name = name_m.group(1)
                if m.group(1) == "mesh_event":
                    name = "mesh_" + name
                if name not in obs.EVENT_NAMES:
                    offenders.append(f"{rel}:{lineno}: {name}")
                else:
                    found.add(name)
    assert offenders == []
    assert found >= {"slow_request", "ckpt_fallback", "auto_promote",
                     "job_slice_granted", "slo_burn",
                     "mesh_worker_registered", "mesh_reload_broadcast"}
    assert obs.EVENT_NAMES == jax_obs.EVENT_NAMES
