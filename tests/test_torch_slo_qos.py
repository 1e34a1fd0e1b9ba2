"""Admission control of the port (``hpnn_tpu_torch/obs/slo.py``,
``hpnn_tpu_torch/serve/mesh/qos.py``, ``serve/mesh/chaos.py``,
``serve/mesh/router.WorkerPool``) held to ``hpnn_tpu`` step for step,
and admission over HTTP against the JAX ``ServeApp``.

The policy objects run under one fake clock (each package's module
``time`` swapped for it) and one sequence of events through both
packages; every step's observable state must be identical.  The HTTP
cases drive a port server and a JAX server with the same requests:
quotas, low-lane shedding with hysteresis, brownout, the SLO under
injected failures, and the /healthz and /metrics key sets.
"""

import json
import os
import random
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

N_IN, N_HID, N_OUT = 8, 6, 3


class _Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def monotonic(self):
        return self.t


def _clocked(monkeypatch, clock, *modules):
    fake = types.SimpleNamespace(monotonic=clock.monotonic, time=time.time,
                                 sleep=time.sleep)
    for mod in modules:
        monkeypatch.setattr(mod, "time", fake)


def _pkgs():
    import hpnn_tpu.obs.slo as jslo
    import hpnn_tpu.serve.mesh.qos as jqos
    import hpnn_tpu_torch.obs.slo as pslo
    import hpnn_tpu_torch.serve.mesh.qos as pqos

    return {"jax": (jslo, jqos), "port": (pslo, pqos)}


@pytest.fixture(autouse=True)
def _quiet():
    """Both packages' consoles at verbosity 0 and chaos disarmed around
    every test (chaos rules and verbosity are process-global)."""
    from hpnn_tpu.serve.mesh import chaos as jchaos
    from hpnn_tpu.utils import nn_log as jlog
    from hpnn_tpu_torch.serve.mesh import chaos as pchaos
    from hpnn_tpu_torch.utils import nn_log as plog

    for m in (jlog, plog):
        m.set_verbosity(0)
    for c in (jchaos, pchaos):
        c.reset()
    yield
    for c in (jchaos, pchaos):
        c.reset()
    for m in (jlog, plog):
        m.set_verbosity(0)


# --- SloTracker -------------------------------------------------------------

def _slo_script(name):
    """(tracker kwargs, steps); a step is (dt, op, *args)."""
    if name == "exact_threshold":
        steps = [(0.0, "ok", "k")] * 9 + [(0.0, "bad", "k"),
                                          (0.0, "snap")]
        steps += [(0.0, "bad", "k"), (0.0, "snap"), (0.0, "bad", "k"),
                  (0.0, "snap"), (0.0, "snap")]
        return dict(availability=0.9, fast_s=10.0, slow_s=10.0,
                    burn_threshold=2.0), steps
    if name == "multiwindow_rearm":
        steps = [(0.01, "bad", "k")] * 4 + [(0.0, "snap"),
                                            (0.5, "ok", "k"),
                                            (0.0, "snap")]
        steps += [(0.01, "bad", "k")] * 4 + [(0.0, "snap")]
        return dict(availability=0.9, fast_s=0.2, slow_s=0.4,
                    burn_threshold=2.0), steps
    if name == "latency":
        steps = [(0.0, "lat", "tiny", 0.001)] * 8 + [
            (0.0, "lat", "tiny", 0.2), (0.0, "snap")]
        return dict(p99_ms=50.0, fast_s=10.0, slow_s=10.0,
                    burn_threshold=10.0), steps
    # a seeded random walk over three kernels and both objectives
    rng = random.Random(11)
    steps = []
    for i in range(400):
        k = rng.choice(["a", "b", "c"])
        r = rng.random()
        if r < 0.45:
            steps.append((rng.uniform(0, 0.02), "ok", k))
        elif r < 0.6:
            steps.append((rng.uniform(0, 0.02), "bad", k))
        elif r < 0.9:
            steps.append((rng.uniform(0, 0.02), "lat", k,
                          rng.choice([0.001, 0.02, 0.08])))
        elif r < 0.95:
            steps.append((rng.uniform(0, 0.5), "eval"))
        else:
            steps.append((0.0, "snap"))
    return dict(availability=0.95, p99_ms=50.0, fast_s=0.5, slow_s=1.5,
                burn_threshold=3.0), steps


@pytest.mark.parametrize("script", ["exact_threshold", "multiwindow_rearm",
                                    "latency", "random_walk"])
def test_slo_tracker_steps_match_jax(monkeypatch, script):
    kw, steps = _slo_script(script)
    traces = {}
    for pkg, (slo, _qos) in _pkgs().items():
        clock = _Clock()
        _clocked(monkeypatch, clock, slo)
        tr = slo.SloTracker(**kw)
        trace = []
        for dt, op, *args in steps:
            clock.t += dt
            if op == "ok":
                tr.record_outcome(args[0], True)
            elif op == "bad":
                tr.record_outcome(args[0], False)
            elif op == "lat":
                tr.record_latency(args[0], args[1])
            elif op == "eval":
                trace.append(("eval", tr.evaluate_now()))
            else:
                trace.append(("snap", tr.snapshot()))
            trace.append((tr.any_burning(), tr.burning_count,
                          tr.alerts_total))
        traces[pkg] = trace
    assert traces["port"] == traces["jax"]
    snaps = [s for tag, *s in traces["port"] if tag == "snap"]
    if script == "exact_threshold":
        # 1/10, 2/11 bad stay under 2x the 10% budget; 3/12 trips it
        burning = [s[0]["kernels"]["k"]["availability"]["burning"]
                   for s in snaps]
        assert burning == [False, False, True, True]
        assert snaps[-1][0]["alerts_total"] == 1
    if script == "multiwindow_rearm":
        assert snaps[-1][0]["alerts_total"] == 2
    if script == "random_walk":
        assert any(s[0]["alerts_total"] for s in snaps)


def test_slo_env_windows_match_jax(monkeypatch):
    monkeypatch.setenv("HPNN_SLO_FAST_S", "7")
    monkeypatch.setenv("HPNN_SLO_SLOW_S", "3")   # clamped up to fast
    monkeypatch.setenv("HPNN_SLO_BURN", "5.5")
    got = {pkg: (t.fast_s, t.slow_s, t.burn_threshold, t.eval_interval_s)
           for pkg, (slo, _q) in _pkgs().items()
           for t in [slo.SloTracker(availability=0.99)]}
    assert got["port"] == got["jax"] == (7.0, 7.0, 5.5, 0.7)


# --- token buckets, quotas, client keys ------------------------------------

def test_token_bucket_and_quota_steps_match_jax(monkeypatch):
    rng = random.Random(5)
    ops = []
    for _ in range(300):
        r = rng.random()
        dt = rng.choice([0.0, 0.0, 0.01, 0.1, 0.7])
        key = rng.choice(["a", "b", "c", "d", "e"])
        cost = rng.choice([1.0, 3.0, 8.0, 40.0, 130.0])
        ops.append((dt, "refund" if r < 0.15 else "allow", key, cost))
    traces = {}
    for pkg, (_slo, qos) in _pkgs().items():
        clock = _Clock()
        _clocked(monkeypatch, clock, qos)
        bucket = qos.TokenBucket(rate=20.0, burst=50.0)
        table = qos.QuotaTable(20.0, 50.0, max_clients=3)
        trace = []
        for dt, op, key, cost in ops:
            clock.t += dt
            if op == "allow":
                trace.append(("b", bucket.allow(cost, now=clock.t),
                              round(bucket.tokens, 12)))
                trace.append(("q", table.allow(key, cost)))
            else:
                bucket.refund(cost)
                table.refund(key, cost)
                trace.append(("r", round(bucket.tokens, 12)))
            trace.append(table.snapshot())
        traces[pkg] = trace
    assert traces["port"] == traces["jax"]
    denied = [t for t in traces["port"]
              if isinstance(t, tuple) and t[0] == "q" and not t[1][0]]
    assert denied and all(t[1][1] > 0 for t in denied)
    # the default burst and the refused rate
    for _slo, qos in _pkgs().values():
        assert qos.QuotaTable(10.0).burst == 64.0
        assert qos.QuotaTable(100.0).burst == 200.0
        with pytest.raises(ValueError):
            qos.QuotaTable(0.0)


@pytest.mark.parametrize("headers,peer", [
    ({"X-HPNN-Client": " alice "}, "10.0.0.1"),
    ({"X-HPNN-Client": "bob", "Authorization": "Bearer t"}, None),
    ({"Authorization": "Bearer tok "}, "10.0.0.2"),
    ({"X-HPNN-Token": "xt"}, "10.0.0.3"),
    ({"X-HPNN-Client": ""}, "10.0.0.4"),
    ({}, "10.0.0.5"), ({}, None), (None, None)])
def test_client_key_precedence_matches_jax(headers, peer):
    keys = {pkg: qos.client_key(headers, peer)
            for pkg, (_s, qos) in _pkgs().items()}
    assert keys["port"] == keys["jax"]


# --- the load shedder -------------------------------------------------------

class _Tracker:
    """A scripted SLO tracker: ``burning`` is set by the test; the
    shedder's forced re-evaluations are counted."""

    def __init__(self):
        self.burning = False
        self.evals = 0

    def any_burning(self):
        return self.burning

    def evaluate_now(self):
        self.evals += 1
        return self.burning


def test_load_shedder_steps_match_jax(monkeypatch):
    # burn on for a stretch, off, a blip shorter than the hysteresis,
    # then off for good; stale serves and sheds counted on the way
    burn = ([False] * 10 + [True] * 30 + [False] * 10 + [True] * 3
            + [False] * 60)
    traces = {}
    for pkg, (_slo, qos) in _pkgs().items():
        clock = _Clock()
        _clocked(monkeypatch, clock, qos)
        tracker = _Tracker()
        shed = qos.LoadShedder(tracker, clear_after_s=0.5)
        trace = [shed.retry_after_s()]
        r = random.Random(3)
        for b in burn:
            clock.t += r.choice([0.01, 0.02, 0.05])
            tracker.burning = b
            gates = [shed.gate_engaged(lane) for lane in (0, 1, 2)]
            if gates[2] and r.random() < 0.5:
                shed.count_stale()
            elif r.random() < 0.3:
                gates.append(shed.should_shed(2))
            trace.append((gates, shed.active, tracker.evals,
                          shed.snapshot()))
        traces[pkg] = trace
    assert traces["port"] == traces["jax"]
    actives = [t[1] for t in traces["port"][1:]]
    # engaged while burning, held through the blip, cleared at the end
    assert actives[15] and not actives[-1]
    assert traces["port"][-1][3]["engaged_total"] == 1


@pytest.mark.parametrize("queued", [0, 1, 37, 500, 100000])
def test_desired_workers_grid_matches_jax(monkeypatch, queued):
    monkeypatch.setenv("HPNN_MESH_MAX_WORKERS", "40")
    for rate in (0.0, 0.5, 40.0, 1000.0):
        for live in (0, 1, 2, 7):
            for target in (None, 0.25, 3.0):
                got = {pkg: qos.desired_workers(queued, rate, live,
                                                target_drain_s=target)
                       for pkg, (_s, qos) in _pkgs().items()}
                assert got["port"] == got["jax"]


# --- chaos schedules --------------------------------------------------------

_SPECS = [
    "reset@/infer:after=2,every=3,times=2;latency:ms=50,p=0.5,seed=7;"
    "http:code=502",
    "http:p=0.4,seed=123",
    "truncate@/v1/mesh/blob:side=server,every=2",
    "enospc@state.npz:times=1;bitflip:domain=io;torn@manifest:after=1",
    "latency:domain=io,ms=3,every=4",
    "reset-after@register:times=3;timeout@/healthz:every=5",
    "", "explode", "reset:every=0", "latency:p=2", "reset:bogus=1",
    "reset:every", "enospc:domain=bogus", "http:code=x",
]


@pytest.mark.parametrize("spec", _SPECS)
def test_chaos_parse_spec_matches_jax(spec):
    from hpnn_tpu.serve.mesh import chaos as jchaos
    from hpnn_tpu_torch.serve.mesh import chaos as pchaos

    def parse(chaos):
        try:
            return [{k: getattr(r, k) for k in r.__slots__
                     if not k.startswith("_") and k != "rng"
                     and hasattr(r, k)}
                    for r in chaos.parse_spec(spec)]
        except ValueError as exc:
            return ("ValueError", type(exc).__name__)

    assert parse(pchaos) == parse(jchaos)


@pytest.mark.parametrize("spec", _SPECS[:6])
def test_chaos_pick_schedules_match_jax(spec):
    from hpnn_tpu.serve.mesh import chaos as jchaos
    from hpnn_tpu_torch.serve.mesh import chaos as pchaos

    paths = ["/v1/kernels/k/infer", "/healthz", "/v1/mesh/blob/ab",
             "/v1/mesh/register", "/x"]
    files = ["ck/state.npz", "ck/manifest.json", "kernel.opt"]
    got = {}
    for name, chaos in (("jax", jchaos), ("port", pchaos)):
        chaos.configure(spec)
        seq = []
        for i in range(60):
            for side in ("client", "server"):
                r = chaos.pick(paths[i % len(paths)], side=side)
                seq.append(None if r is None else r.kind)
            r = chaos.pick_io(files[i % len(files)])
            seq.append(None if r is None else r.kind)
        st = chaos.stats()
        got[name] = (seq, {k: v for k, v in st.items()
                           if k != "rules"})
        chaos.reset()
    assert got["port"] == got["jax"]
    assert any(k is not None for k in got["port"][0])


def test_chaos_env_arming_matches_jax(monkeypatch):
    from hpnn_tpu.serve.mesh import chaos as jchaos
    from hpnn_tpu_torch.serve.mesh import chaos as pchaos

    for spec in ("not-a-kind:wat", "http:code=503,every=2"):
        monkeypatch.setenv("HPNN_FAULT", spec)
        seqs = []
        for chaos in (jchaos, pchaos):
            chaos.reset()
            seqs.append(([chaos.pick("/a") is not None for _ in range(6)],
                         chaos.stats()["armed"]))
        assert seqs[0] == seqs[1]


# --- worker pool placement --------------------------------------------------

def _pool_script(router):
    """The JAX tests' placement, ejection and retire sequences as one
    trace of observable outcomes."""
    out = []
    pool = router.WorkerPool(eject_after=2)
    try:
        a = pool.register("127.0.0.1:1001")
        b = pool.register("127.0.0.1:1002")
        first = pool.pick("k", 8)
        out.append([pool.pick("k", 8).wid for _ in range(5)])
        pool.note_dispatch(first)
        out.append(pool.pick("k", 8).wid)
        pool.note_done(first)
        out.append(pool.pick("k", 8, exclude={a.wid}).wid)
        out.append(pool.pick("k", 8, exclude={b.wid}).wid)
        try:
            pool.pick("k", 8, exclude={a.wid, b.wid})
        except Exception as exc:
            out.append(type(exc).__name__)
        a.kernels = {"k": {"generation": 1}}
        b.kernels = {"other": {"generation": 1}}
        out.append([pool.pick("k", 8).wid for _ in range(4)])
        out.append(pool.pick("other", 8).wid)
        # buckets rotate and keep their affinity
        a.kernels = b.kernels = {}
        out.append([pool.pick("k", bk).wid for bk in (1, 2, 4, 8, 1, 2)])
    finally:
        pool.close()
    pool = router.WorkerPool(eject_after=2)
    try:
        a = pool.register("127.0.0.1:2001", {"k": {"generation": 2}})
        b = pool.register("127.0.0.1:2002", {"k": {"generation": 1}})
        out.append([pool.pick("k", 4, want_gen=2).wid for _ in range(4)])
        pool.report_failure(a, ConnectionRefusedError("gone"))
        out.append((a.state, pool.pick("k", 4, want_gen=2).wid))
        pool.register("127.0.0.1:2001", {"k": {"generation": 2}})
        out.append(a.state)
        a.state = "warming"
        pool.register("127.0.0.1:2001", {"k": {"generation": 2}})
        out.append(a.state)
        pool.report_ok(a)
        out.append((a.state, pool.live_count(), pool.failovers_total))
        pool.report_failure(b, TimeoutError("slow"))
        out.append((b.state, pool.failovers_total, pool.live_count()))
    finally:
        pool.close()
    pool = router.WorkerPool(eject_after=2)
    try:
        w1 = pool.register("127.0.0.1:9001")
        pool.register("127.0.0.1:9002")
        out.append((pool.retire("127.0.0.1:9001"), w1.state))
        out.append([pool.pick("tiny", 4).addr for _ in range(8)])
        pool.report_ok(w1)
        pool.register("127.0.0.1:9001")
        out.append((w1.state, pool.live_count()))
        out.append((pool.remove("127.0.0.1:9001"),
                    "127.0.0.1:9001" in pool.table(),
                    pool.remove("127.0.0.1:9001")))
        out.append(pool.register("127.0.0.1:9001").state)
        out.append(pool.retire("127.0.0.1:9999"))
        out.append({wid: {k: v for k, v in w.items()
                          if not isinstance(v, float)}
                    for wid, w in pool.table().items()})
    finally:
        pool.close()
    return out


def test_pool_placement_ejection_and_retire_match_jax():
    from hpnn_tpu.serve.mesh import router as jrouter
    from hpnn_tpu_torch.serve.mesh import router as prouter

    got = {"jax": _pool_script(jrouter), "port": _pool_script(prouter)}
    assert got["port"] == got["jax"]
    assert got["port"][4] == "NoLiveWorker"


# --- admission over HTTP ----------------------------------------------------

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


def _serve(pkg, conf, **kw):
    """A port or JAX ServeApp on a background HTTP thread: (app, base)."""
    if pkg == "port":
        from hpnn_tpu_torch.serve.server import ServeApp, serve_in_thread

        app = ServeApp(max_batch=8, device="cpu", **kw)
        assert app.add_model(conf, warmup=False) is not None
        httpd, _ = serve_in_thread(app)
    else:
        from hpnn_tpu.serve.server import ServeApp, serve_in_thread

        app = ServeApp(max_batch=8, **kw)
        assert app.add_model(conf, warmup=False) is not None
        httpd, _ = serve_in_thread("127.0.0.1", 0, app)
    app._test_httpd = httpd
    return app, f"http://127.0.0.1:{httpd.server_address[1]}"


def _stop(app):
    app._test_httpd.shutdown()
    app._test_httpd.server_close()
    app.close(drain=True)


def _req(url, payload=None, headers=None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return (resp.status, json.loads(resp.read().decode()),
                    dict(resp.headers))
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read().decode()), dict(exc.headers)


class _DeadBackend:
    def pipeline_depth(self):
        return 1

    def dispatch(self, *a, **k):
        raise RuntimeError("injected device failure")

    def collect(self, handle):  # pragma: no cover - never dispatched
        raise RuntimeError("unreachable")


def _burst_500(app, base, xs, n=6):
    """Server-caused failures: the batcher's backend dies at dispatch."""
    b = app.batchers["tiny"]
    orig, b.backend = b.backend, _DeadBackend()
    try:
        return [_req(base + "/v1/kernels/tiny/infer", xs)[0]
                for _ in range(n)]
    finally:
        b.backend = orig


def test_quota_429_and_retry_after_match_jax(tmp_path):
    """Per-row charges before the queue: a 2-row request from a key
    with 3 rows of burst passes once, the next is a 429 whose Retry-After
    comes from the bucket's refill; other keys are unaffected; a
    queue-full 429 refunds its charge."""
    conf = _write_conf(tmp_path)
    xs = {"inputs": np.zeros((2, N_IN)).tolist()}
    got = {}
    for pkg in ("jax", "port"):
        app, base = _serve(pkg, conf, quota_rows=0.5, quota_burst=3.0)
        try:
            seq = []
            for key in ("a", "a", "b", "a"):
                st, body, hdrs = _req(base + "/v1/kernels/tiny/infer", xs,
                                      {"X-HPNN-Client": key})
                seq.append((st, body.get("reason"),
                            hdrs.get("Retry-After")))
            # the auth token and the peer address key the buckets too
            seq.append(_req(base + "/v1/kernels/tiny/infer", xs,
                            {"Authorization": "Bearer t1"})[0])
            seq.append(_req(base + "/v1/kernels/tiny/infer", xs)[0])
            # queue full: the charge is refunded (a fresh key passes
            # twice after two refunded 429s)
            b = app.batchers["tiny"]
            b.pause()
            app.max_queue_rows = b.max_queue_rows = 0
            seq.append([_req(base + "/v1/kernels/tiny/infer", xs,
                             {"X-HPNN-Client": "c"})[1]["reason"]
                        for _ in range(2)])
            b.max_queue_rows = 256
            b.resume()
            seq.append(_req(base + "/v1/kernels/tiny/infer", xs,
                            {"X-HPNN-Client": "c"})[0])
            snap = app.metrics.snapshot()
            seq.append((snap["quota"], snap["requests"]["quota_exceeded"],
                        sorted(snap["autoscale"])))
            got[pkg] = seq
        finally:
            _stop(app)
    assert got["port"] == got["jax"]
    assert got["port"][1][:2] == (429, "quota_exceeded")
    assert got["port"][1][2] == "2"   # 1 missing row at 0.5 rows/s
    assert got["port"][2][0] == 200 and got["port"][3][0] == 429


def _shed_app(pkg, conf, shed_low=True):
    app, base = _serve(pkg, conf, slo_availability=0.9, shed_low=shed_low)
    app.slo.fast_s = 0.4
    app.slo.slow_s = 0.8
    app.slo.burn_threshold = 2.0
    app.slo.eval_interval_s = 0.0
    if app.shedder is not None:
        app.shedder.clear_after_s = 0.5
        app.shedder._eval_every = 0.01
    return app, base


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_shed_low_lane_only_with_hysteresis(tmp_path, pkg):
    """A 5xx burst burns the budget: only the low lane is shed (429 with
    Retry-After; the shed itself spends no budget), high and normal keep
    serving, and the gate clears with hysteresis once the burn is out --
    the same outcomes in both packages."""
    conf = _write_conf(tmp_path)
    xs = {"inputs": np.zeros((2, N_IN)).tolist()}
    low = {"X-HPNN-Priority": "low"}
    app, base = _shed_app(pkg, conf)
    try:
        assert _req(base + "/v1/kernels/tiny/infer", xs, low)[0] == 200
        assert _burst_500(app, base, xs) == [500] * 6
        assert app.slo.any_burning()
        st, body, hdrs = _req(base + "/v1/kernels/tiny/infer", xs, low)
        assert st == 429 and body["reason"] == "shed"
        assert float(hdrs["Retry-After"]) >= 1.0
        for hi in ({"X-HPNN-Priority": "high"}, {}):
            assert _req(base + "/v1/kernels/tiny/infer", xs, hi)[0] == 200
        snap = app.metrics.snapshot()
        assert snap["shed"]["active"] is True
        assert snap["shed"]["engaged_total"] == 1
        assert snap["shed"]["shed_total"] >= 1
        st, hz, _ = _req(base + "/healthz")
        assert hz["shed_engaged"] is True and hz["slo_burning"] >= 1
        text = urllib.request.urlopen(base + "/metrics").read().decode()
        assert "hpnn_shed_active 1" in text
        deadline = time.monotonic() + 15
        st = 429
        while st == 429 and time.monotonic() < deadline:
            time.sleep(0.1)
            st = _req(base + "/v1/kernels/tiny/infer", xs, low)[0]
        assert st == 200, "shedding never cleared"
        assert app.metrics.snapshot()["shed"]["active"] is False
    finally:
        _stop(app)


def test_brownout_serves_stale_before_shedding(tmp_path):
    """With a retained older generation, an engaged shedder serves the
    low lane from it (X-HPNN-Served-Stale: 1) instead of a 429; an
    explicit pin is still shed.  Outputs of the stale and the fresh
    generation are within 1e-13 of the JAX server's."""
    conf = _write_conf(tmp_path)
    _write_conf(tmp_path, name="tiny2", seed=4321)
    k2path = str(tmp_path / "tiny2.opt")
    xs = {"inputs": np.linspace(-1, 1, 2 * N_IN).reshape(2, N_IN).tolist()}
    low = {"X-HPNN-Priority": "low"}
    got = {}
    for pkg in ("jax", "port"):
        app, base = _shed_app(pkg, conf)
        app.registry.retain_generations = True
        try:
            seq = [_req(base + "/v1/kernels/tiny/infer", xs, low)[:2]]
            app.reload_model("tiny", k2path)
            st, fresh, hdrs = _req(base + "/v1/kernels/tiny/infer", xs, low)
            seq.append((st, fresh, "X-HPNN-Served-Stale" in hdrs))
            assert _burst_500(app, base, xs) == [500] * 6
            st, stale, hdrs = _req(base + "/v1/kernels/tiny/infer", xs, low)
            seq.append((st, stale, hdrs.get("X-HPNN-Served-Stale")))
            st, normal, hdrs = _req(base + "/v1/kernels/tiny/infer", xs)
            seq.append((st, normal, "X-HPNN-Served-Stale" in hdrs))
            st, pinned, _ = _req(base + "/v1/kernels/tiny/infer", xs,
                                 {**low, "X-HPNN-Generation": "2"})
            seq.append((st, pinned["reason"]))
            sh = app.metrics.snapshot()["shed"]
            seq.append((sh["stale_served_total"], sh["shed_total"]))
            got[pkg] = seq
        finally:
            _stop(app)
    p, j = got["port"], got["jax"]
    assert [s[0] for s in p[:4]] == [s[0] for s in j[:4]] == [200] * 4
    assert p[2][2] == j[2][2] == "1" and p[4] == j[4] == (429, "shed")
    assert p[5] == j[5] == (1, 1)
    for (_, bp, *_), (_, bj, *_) in zip(p[:4], j[:4]):
        assert bp["generation"] == bj["generation"]
        np.testing.assert_allclose(bp["outputs"], bj["outputs"],
                                   atol=1e-13, rtol=0)
    assert [s[1]["generation"] for s in p[:4]] == [1, 2, 1, 2]
    assert p[2][1]["outputs"] == p[0][1]["outputs"]


def test_no_shedding_without_the_flag(tmp_path):
    """--slo-* alone gives gauges and events, no actuation."""
    conf = _write_conf(tmp_path)
    for pkg in ("jax", "port"):
        app, base = _shed_app(pkg, conf, shed_low=False)
        try:
            assert app.shedder is None
            for _ in range(4):
                app.slo.record_outcome("tiny", False)
            assert app.slo.any_burning()
            st, out, _ = _req(base + "/v1/kernels/tiny/infer",
                              {"inputs": np.zeros((1, N_IN)).tolist()},
                              {"X-HPNN-Priority": "low"})
            assert st == 200 and out["kernel"] == "tiny"
            assert "shed" not in app.metrics.snapshot()
            assert "hpnn_shed_active" not in \
                app.metrics.render_prometheus()
        finally:
            _stop(app)


def test_slo_under_injected_failures_matches_jax(tmp_path):
    """Server-caused 5xx burn the availability budget; client 4xx and
    unknown-kernel 404s do not (no objective is minted for a junk
    name).  The burn gauges and the families agree with JAX's."""
    conf = _write_conf(tmp_path)
    xs = {"inputs": np.zeros((2, N_IN)).tolist()}
    got = {}
    for pkg in ("jax", "port"):
        app, base = _serve(pkg, conf, slo_availability=0.9,
                           slo_p99_ms=10000.0)
        app.slo.fast_s = app.slo.slow_s = 10.0
        app.slo.burn_threshold = 2.0
        try:
            seq = [_req(base + "/v1/kernels/tiny/infer", xs)[0]
                   for _ in range(6)]
            seq.append(_req(base + "/v1/kernels/tiny/infer",
                            {"inputs": [[1.0]]})[0])
            avail = app.slo.snapshot()["kernels"]["tiny"]["availability"]
            seq.append(avail["fast_burn"])
            seq += [_req(base + f"/v1/kernels/junk{i}/infer", xs)[0]
                    for i in range(3)]
            seq.append(sorted(app.slo.snapshot()["kernels"]))
            seq += _burst_500(app, base, xs, n=4)
            snap = app.slo.snapshot()
            seq.append({k: {o: {f: v for f, v in d.items()}
                            for o, d in objs.items()}
                        for k, objs in snap["kernels"].items()})
            text = urllib.request.urlopen(base + "/metrics").read().decode()
            seq.append(sorted(ln for ln in text.splitlines()
                              if ln.startswith(("hpnn_slo_burning",
                                                "hpnn_slo_alerts"))))
            got[pkg] = seq
        finally:
            _stop(app)
    assert got["port"] == got["jax"]
    assert got["port"][-2]["tiny"]["availability"]["burning"] is True
    assert got["port"][-2]["tiny"]["latency"]["burning"] is False


def test_healthz_and_metrics_keys_match_jax(tmp_path):
    """/healthz and /metrics?format=json carry the JAX server's key sets
    with admission on (the port adds its device and kernel launch
    counts), and the quota, shed, SLO and autoscale sections' keys."""
    conf = _write_conf(tmp_path)
    keys = {}
    for pkg in ("jax", "port"):
        app, base = _serve(pkg, conf, quota_rows=50.0, slo_p99_ms=50.0,
                           slo_availability=0.99, shed_low=True)
        try:
            _req(base + "/v1/kernels/tiny/infer",
                 {"inputs": np.zeros((1, N_IN)).tolist()})
            _st, hz, _ = _req(base + "/healthz")
            _st, m, _ = _req(base + "/metrics?format=json")
            keys[pkg] = (set(hz), set(m),
                         {k: set(m[k]) for k in ("quota", "shed", "slo",
                                                 "autoscale")})
        finally:
            _stop(app)
    hp, mp, sp = keys["port"]
    hj, mj, sj = keys["jax"]
    assert hp == hj | {"device"}
    assert mp == mj | {"kernel_launches"}
    assert sp == sj
    assert {"slo_burning", "shed_engaged"} <= hp
    assert sp["autoscale"] == {"queued_rows", "drain_rows_per_s",
                               "live_workers", "desired_workers"}


def test_queue_full_retry_after_under_quota_is_the_drain_rate(tmp_path):
    """A queue-full 429 answers with the batcher's drain-rate Retry-After
    even when a quota is configured (the charge is refunded)."""
    conf = _write_conf(tmp_path)
    app, base = _serve("port", conf, quota_rows=100.0)
    try:
        b = app.batchers["tiny"]
        b.pause()
        b.max_queue_rows = 1
        errs = []

        def fill():
            errs.append(_req(base + "/v1/kernels/tiny/infer",
                             {"inputs": np.zeros((1, N_IN)).tolist()}))

        t = threading.Thread(target=fill)
        t.start()
        deadline = time.monotonic() + 5
        while b.depth() < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        st, body, hdrs = _req(base + "/v1/kernels/tiny/infer",
                              {"inputs": np.zeros((1, N_IN)).tolist()},
                              {"X-HPNN-Client": "q"})
        assert st == 429 and body["reason"] == "queue_full"
        assert hdrs["Retry-After"] == "1"
        b.resume()
        t.join(timeout=10)
        assert errs[0][0] == 200
        # the refunded key still holds its whole burst
        bucket = app.quota._buckets["client:q"]
        assert bucket.tokens == pytest.approx(app.quota.burst, abs=1e-3)
    finally:
        _stop(app)


def test_slo_off_is_absent(tmp_path):
    """Without --slo-* nothing SLO-shaped exists: no tracker, no snapshot
    key, no series -- and no quota or shed sections."""
    conf = _write_conf(tmp_path)
    app, base = _serve("port", conf)
    try:
        assert app.slo is None and app.metrics.slo is None
        assert app.quota is None and app.shedder is None
        _req(base + "/v1/kernels/tiny/infer",
             {"inputs": np.zeros((1, N_IN)).tolist()})
        snap = app.metrics.snapshot()
        assert not {"slo", "quota", "shed", "mesh"} & set(snap)
        assert "hpnn_slo" not in app.metrics.render_prometheus()
        assert os.environ.get("HPNN_SHED") != "1"
    finally:
        _stop(app)
