"""The port's QoS lanes, deadlines, micro-batcher, metrics and the three
serving repairs, held against the JAX package on the CPU.

Every case runs the same seeded inputs and the same sequence of
operations through ``hpnn_tpu.serve`` and ``hpnn_tpu_torch.serve``
(``device="cpu"``) and compares the outcomes: dispatch order, statuses,
generation labels and metric counts are equal; float64 answers equal the
port's own strict rows bit for bit and the JAX rows within 1e-13.  The
batcher cases drive both packages' ``MicroBatcher`` through one stand-in
model whose registry records each dispatched batch (the JAX package's own
tests, ``tests/test_serve.py`` and ``tests/test_mesh.py``, use the same
stand-ins)."""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax.numpy as jnp

N_IN, N_HID, N_OUT = 16, 8, 4
PKGS = ("jax", "port")


def _serve(pkg):
    if pkg == "jax":
        import hpnn_tpu.serve as s
        from hpnn_tpu.serve import batcher, metrics, registry, server
        from hpnn_tpu.serve.mesh import qos
    else:
        import hpnn_tpu_torch.serve as s
        from hpnn_tpu_torch.serve import (batcher, metrics, qos, registry,
                                          server)
    return s, batcher, metrics, registry, server, qos


def _app(pkg, **kw):
    server = _serve(pkg)[4]
    if pkg == "port":
        kw.setdefault("device", "cpu")
    return server.ServeApp(**kw)


def _write_conf(tmp_path, name="tiny", seed=1234, hidden=N_HID):
    """A 16-8-4 f64 kernel dumped to text and a run_nn conf loading it;
    returns the conf path and the reloaded weights (both packages serve
    what they load)."""
    from hpnn_tpu_torch.io.kernel_io import dump_kernel_to_path, load_kernel
    from hpnn_tpu_torch.models.kernel import generate_kernel

    kern, _ = generate_kernel(seed, N_IN, [hidden], N_OUT)
    kpath = str(tmp_path / f"{name}.opt")
    dump_kernel_to_path(kern, kpath)
    conf = tmp_path / f"{name}.conf"
    conf.write_text(f"[name] {name}\n[type] ANN\n[init] {kpath}\n"
                    "[seed] 1\n[train] BP\n")
    return str(conf), load_kernel(kpath).weights


def _strict_rows(weights, xs):
    """The port's strict rows and the JAX package's for the same
    weights."""
    from hpnn_tpu import ops as jax_ops
    from hpnn_tpu_torch import ops

    port = ops.run_batch(tuple(torch.as_tensor(w) for w in weights),
                         torch.as_tensor(xs), "ANN").numpy()
    ref = np.asarray(jax_ops.run_batch(
        tuple(jnp.asarray(w) for w in weights), jnp.asarray(xs), "ANN"))
    return port, ref


def _wait(pred, timeout=5.0):
    end = time.monotonic() + timeout
    while not pred() and time.monotonic() < end:
        time.sleep(0.005)
    assert pred()


class _StandIn:
    """A registry-free model for one package's MicroBatcher: dispatch
    records the batch's first feature value and rows, collect (the fake
    device wait) pays ``delay_s`` and returns row sums."""

    class _Handle:
        def __init__(self, out, rows, bucket):
            self.out, self.rows, self.bucket = out, rows, bucket

    class _Reg:
        def __init__(self, model, max_batch, metrics, bucket_rows):
            self.model, self.max_batch = model, max_batch
            self.metrics = metrics
            self._bucket_rows = bucket_rows

        def dispatch(self, model, xs, gen=None):
            model.order.append(float(xs[0, 0]))
            model.batches.append(xs.shape[0])
            model.gens.append(gen)
            h = _StandIn._Handle(xs.sum(axis=1, keepdims=True),
                                 xs.shape[0],
                                 self._bucket_rows(xs.shape[0],
                                                   self.max_batch))
            h.served_gen = gen
            return h

        def collect(self, handle):
            time.sleep(self.model.delay_s)
            return handle.out

    def __init__(self, pkg, max_batch=2, delay_s=0.0):
        _, _, metrics, registry, _, _ = _serve(pkg)
        self.name = "order"
        self.generation = 1
        self.registry = self._Reg(self, max_batch, metrics.ServeMetrics(),
                                  registry.bucket_rows)
        self.delay_s = delay_s
        self.order: list[float] = []
        self.batches: list[int] = []
        self.gens: list = []


def _batcher(pkg, model, **kw):
    b = _serve(pkg)[1]
    return b.MicroBatcher(model, metrics=model.registry.metrics, **kw)


# --- qos parsing ------------------------------------------------------------

@pytest.mark.parametrize("value", [None, "", "high", " Normal ", "low",
                                   "LOW", "0", "1", "2", "urgent", "3",
                                   "-1", "hi"])
def test_parse_priority_matches_jax(value):
    from hpnn_tpu.serve.mesh import qos as jq
    from hpnn_tpu_torch.serve import qos as pq

    def outcome(q):
        try:
            return q.parse_priority(value)
        except ValueError:
            return "ValueError"

    assert outcome(pq) == outcome(jq)
    assert pq.LANES == jq.LANES and pq.LANE_NAMES == jq.LANE_NAMES


@pytest.mark.parametrize("value", ["1500", "-5", "0", " 80 ", "1e3",
                                   "soon", "nan", "inf", ""])
def test_parse_deadline_ms_matches_jax(value):
    from hpnn_tpu.serve.mesh import qos as jq
    from hpnn_tpu_torch.serve import qos as pq

    def outcome(q):
        try:
            return q.parse_deadline_ms(value)
        except ValueError:
            return "ValueError"

    assert outcome(pq) == outcome(jq)


# --- the batcher: lanes, EDF, expiry ---------------------------------------

def _edf_run(pkg):
    model = _StandIn(pkg, max_batch=2)
    b = _batcher(pkg, model, max_queue_rows=64)
    b.pause()
    # submit order: low, normal late deadline, normal early deadline,
    # high; max_batch=2 rows = one request a batch, so dispatch order is
    # dequeue order
    specs = [(1.0, 30.0, 2), (2.0, 30.0, 1), (3.0, 10.0, 1),
             (4.0, 30.0, 0)]
    threads = []
    for val, t_s, lane in specs:
        t = threading.Thread(target=b.submit,
                             args=(np.full((2, 4), val), t_s),
                             kwargs={"lane": lane})
        t.start()
        threads.append(t)
        _wait(lambda n=len(threads): b.depth() == 2 * n)
    lanes = b.lane_depths()
    depth = b.depth()
    b.resume()
    for t in threads:
        t.join()
    b.close()
    return model.order, lanes, depth


def test_edf_lane_ordering_matches_jax():
    """High first, earliest deadline first within a lane, low last --
    the same dispatch order and lane gauges in both packages."""
    jax_out, port_out = _edf_run("jax"), _edf_run("port")
    assert port_out == jax_out
    assert port_out[0] == [4.0, 3.0, 2.0, 1.0]
    assert port_out[1] == {"high": 2, "normal": 4, "low": 2}


def _reap_run(pkg):
    _, batcher, *_ = _serve(pkg)
    model = _StandIn(pkg, max_batch=2)
    b = _batcher(pkg, model, max_queue_rows=8)
    b.pause()
    results = {}

    def client(key, val, timeout_s, lane):
        try:
            results[key] = b.submit(np.full((2, 4), val), timeout_s,
                                    lane=lane).tolist()
        except batcher.DeadlineExceeded:
            results[key] = "deadline"

    ts = [threading.Thread(target=client, args=("low", 1.0, 0.1, 2)),
          threading.Thread(target=client, args=("high", 2.0, 30.0, 0))]
    for t in ts:
        t.start()
    _wait(lambda: b.depth() == 4)
    time.sleep(0.25)  # the low lane's deadline lapses while queued
    b.resume()
    for t in ts:
        t.join()
    out = (results, model.order, b.depth(), b.lane_depths())
    b.close()
    return out


def test_expired_low_lane_rows_reaped_matches_jax():
    """Whole-queue expiry: the expired low-lane request fails, never
    dispatches, and its rows are reclaimed."""
    jax_out, port_out = _reap_run("jax"), _reap_run("port")
    assert port_out == jax_out
    assert port_out[0]["low"] == "deadline" and port_out[1] == [2.0]
    assert port_out[2] == 0


def _admission_run(pkg):
    _, batcher, *_ = _serve(pkg)
    model = _StandIn(pkg)
    b = _batcher(pkg, model)
    try:
        b.submit(np.zeros((1, 4)), timeout_s=-0.5)
        got = "ok"
    except batcher.DeadlineExceeded:
        got = "deadline"
    b.close()
    return got, model.order


def test_admission_rejects_expired_deadline_matches_jax():
    assert _admission_run("port") == _admission_run("jax") == \
        ("deadline", [])


def _generous_run(pkg):
    _, batcher, *_ = _serve(pkg)
    seen = {}

    class _Recording(batcher.LocalBackend):
        def dispatch(self, xs, gen=None, deadline=None, lane=None,
                     **kw):
            seen["deadline"] = deadline
            return super().dispatch(xs, gen=gen)

    model = _StandIn(pkg, max_batch=4)
    b = batcher.MicroBatcher(model, metrics=model.registry.metrics,
                             backend=_Recording(model))
    b.pause()
    ts = [threading.Thread(target=b.submit, args=(np.ones((2, 4)), t_s))
          for t_s in (5.0, 30.0)]
    for t in ts:
        t.start()
        time.sleep(0.02)
    _wait(lambda: b.depth() == 4)
    t_before = time.monotonic()
    b.resume()
    for t in ts:
        t.join()
    b.close()
    return model.order, seen["deadline"] - t_before > 20.0


def test_batch_deadline_forwarded_is_most_generous_matches_jax():
    assert _generous_run("port") == _generous_run("jax") == ([1.0], True)


def _pinned_run(pkg):
    """Requests pinned to generations 1, 1, 2, None, None: a batch never
    mixes generations, and dequeue order is kept."""
    model = _StandIn(pkg, max_batch=8)
    b = _batcher(pkg, model, max_queue_rows=64)
    b.pause()
    out = {}
    ts = []
    for i, gen in enumerate((1, 1, 2, None, None)):
        t = threading.Thread(target=lambda i=i, gen=gen: out.__setitem__(
            i, b.submit(np.full((1, 4), float(i)), 30.0, gen=gen,
                        return_gen=True)[1]))
        t.start()
        ts.append(t)
        _wait(lambda n=i + 1: b.depth() == n)
    b.resume()
    for t in ts:
        t.join()
    b.close()
    return model.batches, model.gens, [out[i] for i in range(5)]


def test_batches_never_mix_pinned_generations_matches_jax():
    port = _pinned_run("port")
    assert port == _pinned_run("jax")
    assert port == ([2, 1, 2], [1, 2, None], [1, 1, 2, 1, 1])


def _retry_run(pkg):
    _, batcher, *_ = _serve(pkg)
    model = _StandIn(pkg, max_batch=2, delay_s=0.01)
    b = _batcher(pkg, model, max_queue_rows=4)
    before = b.retry_after_s()
    for _ in range(6):   # some completions feed the drain-rate EWMA
        b.submit(np.ones((2, 4)), 5.0)
    rate = b.drain_rate()
    b.pause()
    holders = [threading.Thread(target=b.submit,
                                args=(np.ones((2, 4)), 5.0))
               for _ in range(2)]
    for t in holders:
        t.start()
    _wait(lambda: b.depth() == 4)
    try:
        b.submit(np.ones((2, 4)), 5.0)
        exc = None
    except batcher.QueueFull as e:
        exc = e
    b.resume()
    for t in holders:
        t.join()
    b.close()
    return before, rate > 0, exc is not None, \
        1.0 <= getattr(exc, "retry_after_s", 0) <= 60.0


def test_queue_full_carries_drain_rate_retry_after_matches_jax():
    assert _retry_run("port") == _retry_run("jax") == (1.0, True, True,
                                                        True)


# --- the batcher: coalescing, pipelining, drain ----------------------------

def _coalesce_run(pkg):
    model = _StandIn(pkg, max_batch=8, delay_s=0.02)
    b = _batcher(pkg, model, max_queue_rows=64)
    b.pause()
    outs = {}
    ts = [threading.Thread(target=lambda i=i: outs.__setitem__(
        i, b.submit(np.full((1, 4), float(i)), 10.0).tolist()))
        for i in range(6)]
    for t in ts:
        t.start()
    _wait(lambda: b.depth() == 6)
    b.resume()
    for t in ts:
        t.join()
    b.close()
    return model.batches, [outs[i] for i in range(6)]


def test_batcher_coalesces_concurrent_requests_matches_jax():
    port = _coalesce_run("port")
    assert port == _coalesce_run("jax")
    assert port[0] == [6]


def _pipeline_run(pkg):
    model = _StandIn(pkg, max_batch=4, delay_s=0.002)
    b = _batcher(pkg, model, max_queue_rows=1024)
    outs = {}

    def client(i):
        outs[i] = b.submit(np.full((1 + i % 3, 4), float(i)), 30.0)

    ts = [threading.Thread(target=client, args=(i,)) for i in range(48)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    b.close()
    ok = all(np.array_equal(outs[i], np.full((1 + i % 3, 1), 4.0 * i))
             for i in range(48))
    return ok, len(model.batches) >= 2, sum(model.batches)


def test_batcher_pipelining_never_reorders_responses_matches_jax():
    """The depth-1 pipeline delivers every client its own rows, over
    several launches, in both packages."""
    port = _pipeline_run("port")
    assert port == _pipeline_run("jax")
    assert port == (True, True, sum(1 + i % 3 for i in range(48)))


def _expiry_run(pkg):
    _, batcher, *_ = _serve(pkg)
    model = _StandIn(pkg, max_batch=4)
    b = _batcher(pkg, model, max_queue_rows=16)
    b.pause()
    res = []

    def client():
        try:
            b.submit(np.zeros((1, 2)), timeout_s=0.05)
            res.append("ok")
        except batcher.DeadlineExceeded:
            res.append("deadline")

    t = threading.Thread(target=client)
    t.start()
    time.sleep(0.3)
    b.resume()
    t.join()
    b.close()
    return res, model.batches


def test_batcher_deadline_expires_without_compute_matches_jax():
    assert _expiry_run("port") == _expiry_run("jax") == (["deadline"], [])


def _drain_run(pkg):
    _, batcher, *_ = _serve(pkg)
    model = _StandIn(pkg, max_batch=2, delay_s=0.02)
    b = _batcher(pkg, model, max_queue_rows=64)
    b.pause()
    outs = []
    ts = [threading.Thread(
        target=lambda: outs.append(b.submit(np.ones((1, 2)), 10.0)))
        for _ in range(6)]
    for t in ts:
        t.start()
    _wait(lambda: b.depth() == 6)
    b.resume()
    b.close(drain=True)
    for t in ts:
        t.join()
    try:
        b.submit(np.ones((1, 2)), 1.0)
        closed = False
    except batcher.ServeClosed:
        closed = True
    return len(outs), closed, model.batches


def test_batcher_graceful_drain_matches_jax():
    assert _drain_run("port") == _drain_run("jax") == (6, True, [2, 2, 2])


def test_port_pipeline_overlaps_dispatch_with_collect(tmp_path):
    """With the real registry, the port's worker dispatches batch N+1
    before it collects batch N (the pipeline), and every answer equals
    the strict rows of its own inputs bit for bit."""
    from hpnn_tpu_torch.serve.server import ServeApp

    conf, weights = _write_conf(tmp_path)
    app = ServeApp(max_batch=4, max_queue_rows=1024, device="cpu")
    app.add_model(conf, warmup=False)
    b = app.batchers["tiny"]
    reg = app.registry
    events = []
    real_dispatch, real_collect = reg.dispatch, reg.collect

    def dispatch(model, xs, gen=None):
        events.append("d")
        return real_dispatch(model, xs, gen=gen)

    def collect(handle):
        events.append("c")
        time.sleep(0.002)  # a slow device keeps the next batch queued
        return real_collect(handle)

    reg.dispatch, reg.collect = dispatch, collect
    rng = np.random.default_rng(3)
    xs = rng.uniform(-1, 1, (40, N_IN))
    outs = {}
    ts = [threading.Thread(target=lambda i=i: outs.__setitem__(
        i, b.submit(xs[i:i + 1], 30.0))) for i in range(40)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    app.close()
    port, ref = _strict_rows(weights, xs)
    for i in range(40):
        assert np.array_equal(outs[i][0], port[i])
        np.testing.assert_allclose(outs[i][0], ref[i], atol=1e-13, rtol=0)
    # some dispatch happened while a batch was still in flight
    assert "dd" in "".join(events)


# --- the three repairs -------------------------------------------------------

def test_non_pow2_max_batch_rounds_up_like_jax(tmp_path, capsys):
    """serve_nn -b 48: both registries round the cap to 64 with the same
    warning, warm 7 buckets, and a 64-row request is a 200 in both."""
    conf, weights = _write_conf(tmp_path)
    rows = np.random.default_rng(11).uniform(-1, 1, (64, N_IN))
    from hpnn_tpu.utils import nn_log as jax_log
    from hpnn_tpu_torch.utils import nn_log as port_log

    got = {}
    for pkg in PKGS:
        registry = _serve(pkg)[3]
        kw = {"device": "cpu"} if pkg == "port" else {}
        log = jax_log if pkg == "jax" else port_log
        log.set_verbosity(1)  # the warning is a NN(WARN) line on stdout
        capsys.readouterr()
        try:
            reg = registry.ModelRegistry(max_batch=48, **kw)
        finally:
            log.set_verbosity(0)
        err = capsys.readouterr().out
        model = reg.register_conf(conf)
        app = _app(pkg, max_batch=48)
        app.add_model(conf, warmup=False)
        capsys.readouterr()
        body = app.handle_infer("tiny", json.dumps(
            {"inputs": rows.tolist()}).encode(), headers={})
        app.close()
        got[pkg] = (reg.max_batch, err, model.warmup(),
                    registry.bucket_rows(40, reg.max_batch),
                    body["generation"], np.asarray(body["outputs"]))
    assert got["port"][:5] == got["jax"][:5]
    assert got["port"][0] == 64 and got["port"][2] == 7
    assert "rounded up to the power-of-two bucket 64" in got["port"][1]
    port, ref = _strict_rows(weights, rows)
    assert np.array_equal(got["port"][5], port)
    np.testing.assert_allclose(got["port"][5], ref, atol=1e-13, rtol=0)


def test_name_collision_is_refused_like_jax(tmp_path, capsys):
    conf, _ = _write_conf(tmp_path)
    got = {}
    for pkg in PKGS:
        app = _app(pkg, max_batch=8)
        first = app.add_model(conf, warmup=False)
        capsys.readouterr()
        second = app.add_model(conf, warmup=False)
        err = capsys.readouterr().err
        got[pkg] = (first is not None, second, err,
                    app.registry.get("tiny") is first)
        app.close()
    assert got["port"] == got["jax"]
    assert got["port"][1] is None
    assert "kernel name 'tiny' already registered!" in got["port"][2]


def test_batch_fill_ratio_is_the_mean_of_each_batch_like_jax():
    """Batches (1 row, bucket 1) and (32 rows, bucket 64): 0.75 in both
    packages (the total-rows ratio would read 0.508)."""
    got = {}
    for pkg in PKGS:
        m = _serve(pkg)[2].ServeMetrics()
        m.count_batch(1, 1)
        m.count_batch(32, 64)
        snap = m.snapshot()
        got[pkg] = (snap["batch_fill_ratio"], snap["batches_total"],
                    snap["rows_total"], m.batch_fill_ratio())
    assert got["port"] == got["jax"]
    assert got["port"][0] == 0.75


# --- the histogram and the snapshot -----------------------------------------

def test_latency_histogram_snapshot_matches_jax():
    from hpnn_tpu.serve.metrics import LatencyHistogram as JH
    from hpnn_tpu_torch.serve.metrics import LatencyHistogram as PH

    rng = np.random.default_rng(17)
    obs = np.concatenate([[0.0, 1e-4, 1e-4 * 1.0000001, 200.0],
                          10.0 ** rng.uniform(-5, 2.5, 500)])
    hj, hp = JH(), PH()
    for s in obs:
        hj.observe(float(s))
        hp.observe(float(s))
    assert hp.snapshot() == hj.snapshot()
    for p in (0, 1, 50, 90, 99, 99.9, 100):
        assert hp.percentile(p) == hj.percentile(p)
    assert hp.count == hj.count and hp.total == hj.total
    snaps = [hp.snapshot(), PH().snapshot(), {"count": 3}]
    assert PH.merge_snapshots(snaps) == JH.merge_snapshots(snaps)
    assert PH.percentile_from_counts({"3": 2, "9": 1}, 3, 99) == \
        JH.percentile_from_counts({"3": 2, "9": 1}, 3, 99)
    # the exemplar slot: the slowest traced observation
    hp.observe(0.5, trace_id="t1")
    hp.observe(0.1, trace_id="t2")
    assert hp.exemplar()["trace_id"] == "t1"


def test_generation_counter_cap_matches_jax():
    got = {}
    for pkg in PKGS:
        metrics = _serve(pkg)[2]
        m = metrics.ServeMetrics()
        for g in range(1, 2 * m.GEN_LABELS_KEPT + 1):
            m.count_generation("k", g)
            m.count_generation("k", g)
        got[pkg] = (m.snapshot()["generations"],
                    'generation="older"' in m.render_prometheus())
    assert got["port"] == got["jax"]
    assert got["port"][0]["k"]["older"] == 32


def test_metrics_snapshot_keys_match_jax():
    """The JSON snapshot carries every key of the JAX snapshot (``jobs``
    included), plus ``kernel_launches``."""
    keys = {}
    for pkg in PKGS:
        keys[pkg] = set(_serve(pkg)[2].ServeMetrics().snapshot())
    assert keys["port"] == keys["jax"] | {"kernel_launches"}


def _prom_families(text):
    return {ln.split()[2] for ln in text.splitlines()
            if ln.startswith("# TYPE")}


def _traffic_run(pkg, tmp_path, conf, xs):
    """One app: 1-, 3- and 4-row requests, a bad row count, an unknown
    kernel, an expired deadline and a bad priority; returns what each
    package's metrics say."""
    app = _app(pkg, max_batch=4)
    app.add_model(conf, warmup=True)
    server = _serve(pkg)[4]
    statuses, outs = [], []
    cases = [(xs[:1], {}), (xs[1:4], {"X-HPNN-Priority": "high"}),
             (xs[4:8], {"X-HPNN-Priority": "low"}), (xs[:5], {}),
             (xs[:1], {"X-HPNN-Deadline-Ms": "-1"}),
             (xs[:1], {"X-HPNN-Priority": "urgent"}),
             (xs[:1], {"X-HPNN-Deadline-Ms": "soon"})]
    for rows, headers in cases:
        try:
            body = app.handle_infer("tiny", json.dumps(
                {"inputs": rows.tolist()}).encode(), headers=headers)
            statuses.append(200)
            outs.append(np.asarray(body["outputs"]))
            app.metrics.count_request("ok")
        except server._HTTPError as exc:
            statuses.append((exc.status, exc.outcome))
            app.metrics.count_request(exc.outcome)
    try:
        app.handle_infer("nope", b"{}", headers={})
    except server._HTTPError as exc:
        statuses.append((exc.status, exc.outcome))
    snap = app.metrics.snapshot()
    prom = app.metrics.render_prometheus()
    app.close()
    return statuses, outs, snap, prom


def test_metrics_after_traffic_match_jax(tmp_path):
    """The same requests through both apps: equal statuses, request
    counters, batch and row totals, bucket accounting, phase counts,
    per-(kernel, bucket) counts, generation counters, lane gauges and
    Prometheus families (less the families the port does not have)."""
    conf, weights = _write_conf(tmp_path)
    xs = np.random.default_rng(19).uniform(-1, 1, (8, N_IN))
    sj, oj, snj, pj = _traffic_run("jax", tmp_path, conf, xs)
    sp, op, snp, pp = _traffic_run("port", tmp_path, conf, xs)
    assert sp == sj
    assert sp[:3] == [200, 200, 200] and sp[3] == (400, "bad_request")
    assert sp[4] == (504, "deadline") and sp[-1] == (404, "not_found")
    port, ref = _strict_rows(weights, xs)
    for got, lo, hi in zip(op, (0, 1, 4), (1, 4, 8)):
        assert np.array_equal(got, port[lo:hi])
        np.testing.assert_allclose(got, ref[lo:hi], atol=1e-13, rtol=0)
    for key in ("requests", "rows_total", "batches_total", "batch_fill_ratio",
                "compile_cache", "reloads", "generations", "queue_depth",
                "lanes"):
        assert snp[key] == snj[key], key
    assert {b: (v["batches"], v["rows"]) for b, v in snp["buckets"].items()} \
        == {b: (v["batches"], v["rows"]) for b, v in snj["buckets"].items()}
    assert {p: h["count"] for p, h in snp["phases"].items()} == \
        {p: h["count"] for p, h in snj["phases"].items()}
    assert {k: {b: h["count"] for b, h in v.items()}
            for k, v in snp["latency_by_bucket"].items()} == \
        {k: {b: h["count"] for b, h in v.items()}
         for k, v in snj["latency_by_bucket"].items()}
    for key in ("latency", "queue_latency", "device_time"):
        assert snp[key]["count"] == snj[key]["count"]
    info = {k: v for k, v in snp["models"]["tiny"].items()
            if k != "last_reload_ts"}
    assert info == {k: v for k, v in snj["models"]["tiny"].items()
                    if k != "last_reload_ts"}
    assert info == {"generation": 1, "kind": "ANN", "trainer": "bp",
                    "route": "strict"}
    # the JAX package's autoscale and trace-sampling families wait for the
    # serve mesh and tracing; the port adds its kernel launch count
    jfam = _prom_families(pj) - {"hpnn_serve_desired_workers",
                                 "hpnn_serve_drain_rows_per_sec"}
    assert _prom_families(pp) == jfam | {"hpnn_kernel_launches_total"}


def _http(base, path, payload=None, headers=None):
    h = {"Content-Type": "application/json"}
    h.update(headers or {})
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(base + path, data=data, headers=h)
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _deadline_http_run(pkg, conf):
    server = _serve(pkg)[4]
    app = _app(pkg, max_batch=4)
    app.add_model(conf, warmup=False)
    if pkg == "jax":
        httpd, _ = server.serve_in_thread("127.0.0.1", 0, app)
    else:
        httpd, _ = server.serve_in_thread(app, "127.0.0.1", 0)
    base = "http://127.0.0.1:%d" % httpd.server_address[1]
    xs = np.zeros((1, N_IN)).tolist()
    url = "/v1/kernels/tiny/infer"
    b = app.batchers["tiny"]
    got = []
    try:
        st, body, _ = _http(base, url, {"inputs": xs},
                            {"X-HPNN-Deadline-Ms": "-10"})
        got.append((st, body["reason"]))
        b.pause()   # expires while the queue is held: 504 at dispatch
        st, body, _ = _http(base, url, {"inputs": xs},
                            {"X-HPNN-Deadline-Ms": "80"})
        got.append((st, body["reason"]))
        # the header wins over a generous body timeout_ms
        st, body, _ = _http(base, url, {"inputs": xs, "timeout_ms": 60000},
                            {"X-HPNN-Deadline-Ms": "80"})
        got.append((st, body["reason"]))
        b.resume()
        for hdr in ({"X-HPNN-Deadline-Ms": "soon"},
                    {"X-HPNN-Priority": "urgent"},
                    {"X-HPNN-Generation": "x"},
                    {"X-HPNN-Generation": "7"},
                    {"X-HPNN-Priority": "low",
                     "X-HPNN-Deadline-Ms": "5000"}):
            st, body, _ = _http(base, url, {"inputs": xs}, hdr)
            got.append((st, body.get("reason", body.get("generation"))))
        got.append(_http(base, "/v1/nope", {"inputs": xs})[0])
        got.append(_http(base, "/nope")[0])
        st, body, _ = _http(base, "/healthz")
        got.append((st, body["status"], body["kernels"], body["parity"],
                    body["kernel_types"], body["queue_depth"]))
        requests = _http(base, "/metrics?format=json")[1]["requests"]
    finally:
        b.resume()
        httpd.shutdown()
        httpd.server_close()
        app.close()
    return got, requests


def test_qos_headers_over_http_match_jax(tmp_path):
    conf, _ = _write_conf(tmp_path)
    port = _deadline_http_run("port", conf)
    assert port == _deadline_http_run("jax", conf)
    got = port[0]
    assert got[:3] == [(504, "deadline")] * 3
    assert got[3:7] == [(400, "bad_request")] * 3 + \
        [(404, "unknown_generation")]
    assert got[7] == (200, 1) and got[8:10] == [404, 404]
