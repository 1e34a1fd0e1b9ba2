"""What the training path records of itself: the join's spans and
counters (``stats_wait``, ``epoch_render``, ``weights_export``,
``EPOCH_METRICS["render_s"]``), a stopped run's ``train.stop``, the card's
gap between epochs
(``boundary_ms``), B1's phase cycles (``b1_cycles``), the kernel file's
parse (``kernel_parse``), and spans as ``torch.profiler`` ranges while a
capture runs.

The tests marked ``card`` need a CUDA card and skip without one; on the
GPU host: ``python -m pytest --noconftest -p no:cacheprovider -m card
tests/test_torch_obs_pipeline.py``.  This file imports no JAX."""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from hpnn_tpu_torch import api
from hpnn_tpu_torch.ckpt.trainer import train_loop
from hpnn_tpu_torch.io.kernel_io import dump_kernel
from hpnn_tpu_torch.models.kernel import generate_kernel
from hpnn_tpu_torch.obs import profiler
from hpnn_tpu_torch.obs import trace as obs_trace
from hpnn_tpu_torch.utils import nn_log

N_IN, N_HID, N_OUT = 8, 6, 3
NEW_KEYS = ("render_s", "boundary_ms", "b1_cycles")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in ("HPNN_TRACE", "HPNN_PROFILE", "HPNN_DBG_TRACE",
              "HPNN_NO_EPOCH_PIPELINE"):
        monkeypatch.delenv(k, raising=False)
    obs_trace.disable()
    api.reset_epoch_metrics()
    verbosity = nn_log.get_verbosity()
    nn_log.set_verbosity(2)
    yield
    nn_log.set_verbosity(verbosity)
    obs_trace.disable()
    api.reset_epoch_metrics()


def _net(tmp_path, n_in=N_IN, hidden=N_HID, n_out=N_OUT, n=6, seed=7):
    """A toy corpus and an SNN BPM conf (few iterations a sample) that
    loads its kernel from a file."""
    rng = np.random.default_rng(seed)
    samples = tmp_path / "samples"
    samples.mkdir()
    for i in range(n):
        cls = i % n_out
        x = rng.uniform(-1, 1, n_in)
        x[cls] += 2.0
        t = np.zeros(n_out)
        t[cls] = 1.0
        (samples / f"s{i:03d}").write_text(
            f"[input] {n_in}\n" + " ".join(f"{v:7.5f}" for v in x)
            + f"\n[output] {n_out}\n" + " ".join(f"{v:.1f}" for v in t)
            + "\n")
    kernel, _ = generate_kernel(1234, n_in, [hidden], n_out, name="toy")
    with open(tmp_path / "kernel.init", "w") as fp:
        dump_kernel(kernel, fp)
    conf = tmp_path / "nn.conf"
    conf.write_text(
        f"[name] toy\n[type] SNN\n[init] {tmp_path / 'kernel.init'}\n"
        f"[seed] 99\n[input] {n_in}\n[hidden] {hidden}\n[output] {n_out}\n"
        f"[train] BPM\n[sample_dir] {samples}\n")
    return str(conf)


def _train(conf, epochs, device="cpu"):
    with contextlib.redirect_stdout(io.StringIO()):
        nn = api.configure(conf)
        ok, _ = train_loop(nn, epochs, device=device)
    assert ok
    return nn


def test_reset_clears_the_join_counters():
    api.EPOCH_METRICS["render_s"] = 1.5
    api.EPOCH_METRICS["boundary_ms"].append(0.01)
    api.EPOCH_METRICS["b1_cycles"]["barrier"] = 10
    api.reset_epoch_metrics()
    assert (api.EPOCH_METRICS["render_s"], api.EPOCH_METRICS["boundary_ms"],
            api.EPOCH_METRICS["b1_cycles"]) == (0.0, [], {})


def test_cpu_train_loop_fills_render_s_only(tmp_path):
    """Three epochs through the pipeline on the CPU: the join's render is
    timed; the CPU has no events, so no boundary, and its route is not
    B1, so no cycles."""
    _train(_net(tmp_path), 3)
    em = api.EPOCH_METRICS
    assert em["epochs"] == 3 and em["mode"] == "resident"
    assert em["render_s"] > 0
    assert em["boundary_ms"] == [] and em["b1_cycles"] == {}


@pytest.mark.parametrize("traced", [True, False])
def test_configure_records_one_kernel_parse(tmp_path, traced):
    conf = _net(tmp_path)
    if traced:
        obs_trace.enable()
    with contextlib.redirect_stdout(io.StringIO()):
        assert api.configure(conf) is not None
    names = [s["name"] for s in obs_trace.snapshot()]
    assert names == (["kernel_parse"] if traced else [])


def test_join_spans_under_stats_drain(tmp_path):
    conf = _net(tmp_path)
    obs_trace.enable()
    _train(conf, 2)
    spans = obs_trace.snapshot()
    by_id = {s["span"]: s for s in spans}
    for name in ("epoch_render", "weights_export"):
        mine = [s for s in spans if s["name"] == name]
        assert mine and all(by_id[s["parent"]]["name"] == "stats_drain"
                            for s in mine)
    # each epoch is rendered once; the CPU waits on no card
    assert sum(s["name"] == "epoch_render" for s in spans) == 2
    assert not any(s["name"] == "stats_wait" for s in spans)


def test_stop_path_has_its_span(tmp_path):
    """A run stopped at an epoch boundary joins, snapshots and reports
    inside ``train.stop``; the final join after it stays outside."""
    import threading

    conf = _net(tmp_path)
    obs_trace.enable()
    stop = threading.Event()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        nn = api.configure(conf)
        ok, interrupted = train_loop(nn, 3, stop=stop, device="cpu",
                                     on_epoch=lambda e, m: stop.set())
    assert ok and interrupted
    assert "CKPT: interrupted at epoch 1/3" in out.getvalue()
    spans = obs_trace.snapshot()
    (stop_span,) = [s for s in spans if s["name"] == "train.stop"]
    assert stop_span["epoch"] == 1 and stop_span["parent"] is None
    drains = [s for s in spans if s["name"] == "stats_drain"]
    assert [d["parent"] == stop_span["span"] for d in drains] == [True, False]


def _ranges(trace_file):
    with open(trace_file) as fp:
        events = json.load(fp)["traceEvents"]
    out = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            out[e["name"]] = out.get(e["name"], 0) + 1
    return out


def test_spans_are_profiler_ranges_during_a_capture(tmp_path):
    """Every span recorded while the capture runs stands in its Chrome
    trace as a range of its name."""
    conf = _net(tmp_path)
    # from trained weights, so the profiled epochs are a few iterations a
    # sample (the CPU capture records every operation)
    trained = _train(conf, 2).kernel
    with open(tmp_path / "kernel.init", "w") as fp:
        dump_kernel(trained, fp)
    api.reset_epoch_metrics()
    obs_trace.enable()
    profiler.start(str(tmp_path / "prof"))
    try:
        _train(conf, 2)
    finally:
        rec = profiler.stop()
    counts = {}
    for s in obs_trace.snapshot():
        counts[s["name"]] = counts.get(s["name"], 0) + 1
    assert {"train.epoch", "stats_drain", "epoch_render", "kernel_parse",
            "weights_export", "corpus_gather", "device_launch"} <= set(counts)
    ranges = _ranges(rec["trace_file"])
    assert {k: ranges.get(k, 0) for k in counts} == counts


def test_no_range_without_a_capture(tmp_path, monkeypatch):
    """With tracing on and no capture running a span opens no
    ``record_function``; a capture's spans open one each."""
    opened = []

    class Counting(torch.profiler.record_function):
        def __init__(self, name, *a, **k):
            opened.append(name)
            super().__init__(name, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    obs_trace.enable()
    with obs_trace.span("outside"):
        pass
    assert opened == []
    profiler.start(str(tmp_path / "prof"))
    try:
        with obs_trace.span("inside"):
            pass
    finally:
        profiler.stop()
    with obs_trace.span("after"):
        pass
    assert opened == ["inside"]


def test_tracing_off_span_is_the_noop_singleton(tmp_path):
    assert obs_trace.span("x") is obs_trace._NOOP
    profiler.start(str(tmp_path / "prof"))
    try:
        assert obs_trace.span("y") is obs_trace._NOOP
    finally:
        profiler.stop()


# --- on the card ----------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card visible: B1 and its events run only there")
    return torch.device("cuda:0")


def _xrd_epoch(dev, rows=6, seed=3):
    """XRD's widths (851-230-230 ANN): weights as hpnn draws them, rows of
    peaks in [0, 1] and one-hot +-1 targets."""
    gen = torch.Generator().manual_seed(seed)
    widths = (851, 230, 230)
    ws = [((torch.rand(n, m, generator=gen, dtype=torch.float64) - 0.5)
           * 2 / m ** 0.5).to(dev) for m, n in zip(widths, widths[1:])]
    xs = torch.rand(rows, 851, generator=gen, dtype=torch.float64) ** 8
    ts = -torch.ones(rows, 230, dtype=torch.float64)
    ts[torch.arange(rows), torch.arange(rows) * 37 % 230] = 1.0
    return ws, xs.to(dev), ts.to(dev)


@pytest.mark.card
def test_card_instrumented_b1_is_the_plain_b1():
    from hpnn_tpu_torch.ops import convergence_kernel as ck

    dev = _card()
    ws, xs, ts = _xrd_epoch(dev)
    w0, st0 = ck.train_epoch_kernel(ws, xs, ts, "ANN", True)
    syncs0 = ck.train_epoch_kernel.syncs.tolist()
    assert ck.train_epoch_kernel.phases is None
    w1, st1 = ck.train_epoch_kernel(ws, xs, ts, "ANN", True, phases=True)
    syncs1 = ck.train_epoch_kernel.syncs.tolist()
    phases = ck.train_epoch_kernel.phases.cpu()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(w0, w1))
    assert torch.equal(st0, st1)
    assert syncs0 == syncs1
    in_iters, _, iters = syncs1
    assert iters == int(st1[:, 2].sum()) and in_iters == (2 * 2 - 2) * iters
    assert phases.shape == (ck.train_epoch_kernel.plan["blocks"],
                            ck.PHASE_WORDS)
    assert bool((phases >= 0).all()) and bool((phases[:, -1] > 0).all())
    assert torch.equal(phases[:, :-1].sum(1), phases[:, -1])


@pytest.mark.card
def test_card_pipeline_records_cycles_and_boundaries(tmp_path):
    """Three epochs queued back to back: two boundaries, and with tracing
    on each epoch's B1 cycles by phase."""
    dev = _card()
    conf = _net(tmp_path, 851, 230, 230, n=12)
    obs_trace.enable()
    _train(conf, 3, device=str(dev))
    em = api.EPOCH_METRICS
    assert len(em["device_ms"]) == 3 and len(em["boundary_ms"]) == 2
    assert all(g >= 0 for g in em["boundary_ms"])
    assert set(em["b1_cycles"]) == {"barrier", "head", "rows", "other"}
    assert em["b1_cycles"]["barrier"] > 0 and em["render_s"] > 0
    assert sum(s["name"] == "stats_wait" for s in obs_trace.snapshot()) == 3
