#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (hpnn_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--json PATH]

Run from the root of a checkout.  It drives the port's main path on the
card at full width and fails (non-zero exit, no result line) on any
fault; no phase catches its own failure.

1. Device: the ``nvidia-smi`` name and power limit, torch's CUDA version.
2. Build: every hand-written kernel from ``hpnn_tpu_torch/csrc`` (one
   ``nvcc`` per source, all started together), with the build time and the
   compiler's register/spill report.
3. Each kernel against its plain torch version on the card, at the
   slice's shapes (784->300 with the activation, 300->10 without, 851->230
   and 230->230 with; B in {1, 3, 64, 512, 4096}; a ragged 13x37 at B=5)
   in float32, bfloat16 and float64, inputs from a seeded numpy generator
   in [-1, 1] and, for the MNIST input layer, at pixel scale [0, 255].
   Limits: float32 1e-5 ([-1, 1]) and 1e-4 (pixel scale), bfloat16 2e-2,
   float64 1e-12.
4. ``run_nn`` through the port's CLI on a seeded synthetic test dir in the
   reference's sample format: MNIST 784-300-10 ANN and SNN at float64,
   float32 and bfloat16, and XRD 851-230-230 ANN at float32, each with a
   kernel from ``generate_kernel(seed)`` dumped to a kernel file.  Each
   run must launch the kernel and match the plain path on the card within
   the limits of phase 3.
5. ``serve_nn`` on 127.0.0.1 (port 0, strict tier) with the MNIST ANN and
   SNN kernels at float32 and float64: requests of 1, 3 and 64 rows, then
   8 concurrent ones; every answer 200 and bit-identical to the rows run_nn
   computed (for SNN that covers the softmax after the kernel too).
6. Device times with CUDA events (median of 20 back-to-back runs of 10
   calls, host dispatch hidden behind a GPU spin) of the kernel, its plain
   version and ``torch.matmul`` + activation (the library yardstick the
   port never calls), beside the bound: the larger of the operations over
   the card's peak for the type and the bytes over 3.35 TB/s.
7. The training epoch kernel (``train_epoch``) against its plain torch
   version on the card at full width, on a seeded separable corpus (one
   bar per class): MNIST 784-300-10 ANN and SNN x BP and BPM x f64, f32 and
   bf16, XRD 851-230-230 ANN BPM at f64 and f32, native LNN 784-300-10 at
   f64; 4-8 samples a run (ANN and LNN samples from two classes: the first
   sample of each class is the one that takes thousands of iterations,
   and the plain loop pays a host round trip per iteration; SNN from four:
   past about five classes at pixel scale, float32's exp range runs out in
   the softmax without max-subtraction and a sample runs to MAX_ITER with
   NaN weights, in the plain loop as in the kernel).  Limits: f64
   identical n_iter/first_ok/success, init_err and final dEp within 1e-12,
   weights within 1e-10; f32 identical first_ok/success, |dn_iter| <=
   max(4, 2%), weights within 5e-3; bf16 the f32 limits (both versions
   round every operation to bf16; only the order of the float32 sums
   differs).
8. The resume contract: the f64 MNIST ANN BP epoch as launches under an
   iteration budget of 100 equals one launch bit for bit, in more than one
   launch.
9. ``train_nn`` end to end (``cli.train_nn_main``, the MNIST tutorial conf
   at the default f64, 512 training files), then ``run_nn`` of the trained
   ``kernel.opt`` on 512 test files: at least 80% PASS.  The epoch is then
   run again through the kernel alone for its device time.
10. One JSON line of every kernel (launches on its main path, the largest
   kernel-vs-plain error over every cell and dtype, times and bound), then
   the result line.

Main paths: ``fused_linear_act``'s is phases 4-5 and ``train_epoch``'s
phase 9 (train_nn, then run_nn of its kernel, which launches
``fused_linear_act`` too); every count is set to 0 just before a path and
read just after it.  ``--json PATH`` also writes every cell's numbers to
PATH.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK = {"f32": 67e12, "f64": 67e12, "bf16": 989e12}   # H100 SXM, dense
HBM_BYTES_PER_S = 3.35e12
LIMIT = {"f32": 1e-5, "f32-pixel": 1e-4, "bf16": 2e-2, "f64": 1e-12}
BATCHES = (1, 3, 64, 512, 4096)
TIMED_BATCHES = (1, 64, 512, 4096)
SPIN_CYCLES = 10_000_000    # ~5 ms of GPU clock: covers one run's enqueue
# (label, N, M, act, input scale) -- the layers of the main path
LAYERS = (("784->300", 300, 784, True, "pixel"),
          ("300->10", 10, 300, False, "unit"),
          ("851->230", 230, 851, True, "unit"),
          ("230->230", 230, 230, True, "unit"))
N_FILES = 4096
MNIST = (784, [300], 10)
XRD = (851, [230], 230)
TRAIN_FILES = 512          # phase 9: training files, and as many test files
# phase 7 runs: (tag, topology, kind, momentum, dtype, classes, samples)
TRAIN_RUNS = (
    [("mnist", MNIST, k, m, d, (0, 1) if k == "ANN" else (0, 1, 2, 3), 8)
     for k in ("ANN", "SNN") for m in (False, True)
     for d in ("f64", "f32", "bf16")]
    + [("xrd", XRD, "ANN", True, d, (0, 1), 4) for d in ("f64", "f32")]
    + [("mnist", MNIST, "LNN", False, "f64", (0, 1), 8)])
# kernel vs plain, per dtype: (n_iter slack: absolute, relative; weights).
# f32: the envelope of tests/test_pallas_convergence.py:35-57, with 2%
# where it has 1%: an XRD ANN BPM sample runs 20-37k iterations and its
# stop (dEp <= 1e-6) falls where the f32 error moves by a few ULPs an
# iteration, so the two sum orders stopped 1.08% apart on one sample (on
# the H100).  bf16 rounds every operation to bf16 in both versions, so
# only the order of the float32 sums differs, as at f32: it is held to the
# f32 limits (measured: identical n_iter and weights in all six runs).
TRAIN_LIMIT = {"f64": (0, 0.0, 1e-10), "f32": (4, 0.02, 5e-3),
               "bf16": (4, 0.02, 5e-3)}


def log(msg: str) -> None:
    print(msg, flush=True)


def _dtypes():
    import torch

    return {"f32": torch.float32, "bf16": torch.bfloat16,
            "f64": torch.float64}


def _limit(dtype: str, scale: str) -> float:
    if dtype == "f32" and scale == "pixel":
        return LIMIT["f32-pixel"]
    return LIMIT[dtype]


def _inputs(rng, b, m, scale):
    if scale == "pixel":
        return rng.integers(0, 256, (b, m)).astype(np.float64)
    return rng.uniform(-1.0, 1.0, (b, m))


def _to_card(a, dtype):
    import torch

    return torch.as_tensor(a, dtype=torch.float64).cuda().to(dtype)


# --- phase 1-2 --------------------------------------------------------------

def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"device: torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} visible")
    return card


def phase_build():
    from hpnn_tpu_torch.ops import build

    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"build: {len(libs)} kernel(s) in "
        f"{time.perf_counter() - t0:.2f} s into {build.BUILD_DIR}")
    for name in libs:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"build: {name}: {line.strip()}")


# --- phase 3 ----------------------------------------------------------------

def phase_kernel_vs_plain():
    import torch

    from hpnn_tpu_torch.ops.kernels import (fused_linear_act,
                                            fused_linear_act_plain)

    rng = np.random.default_rng(20260101)
    errs = {}
    cases = [(label, n, m, act, scale, b) for label, n, m, act, scale
             in LAYERS for b in BATCHES]
    cases += [("784->300", 300, 784, True, "unit", b) for b in BATCHES]
    cases.append(("37->13", 13, 37, True, "unit", 5))
    for label, n, m, act, scale, b in cases:
        w = rng.uniform(-1.0, 1.0, (n, m)) / np.sqrt(m)
        x = _inputs(rng, b, m, scale)
        for dname, dt in _dtypes().items():
            wt, xt = _to_card(w, dt), _to_card(x, dt)
            got = fused_linear_act(wt, xt, act=act)
            want = fused_linear_act_plain(wt, xt, act=act)
            torch.cuda.synchronize()
            err = (got.double() - want.double()).abs().max().item()
            lim = _limit(dname, scale)
            errs[(label, scale, dname, b)] = err
            if not err <= lim:
                raise AssertionError(
                    f"fused_linear_act {label} {dname} B={b} ({scale}): "
                    f"max |kernel - plain| = {err:.3e} > {lim:g}")
    worst = {d: max(e for k, e in errs.items() if k[2] == d)
             for d in _dtypes()}
    log(f"kernel vs plain: {len(errs)} cells within limits; worst "
        + ", ".join(f"{d} {e:.3e}" for d, e in worst.items()))
    return errs


# --- phase 4 ----------------------------------------------------------------

def _write_corpus(dirpath, n_in, n_out, scale, seed):
    rng = np.random.default_rng(seed)
    os.makedirs(dirpath)
    for i in range(N_FILES):
        x = _inputs(rng, 1, n_in, scale)[0]
        label = int(rng.integers(n_out))
        with open(os.path.join(dirpath, f"s{i:05d}.txt"), "w") as fp:
            fp.write(f"[input] {n_in}\n")
            fp.write(" ".join(f"{v:7.5f}" for v in x) + "\n")
            fp.write(f"[output] {n_out}  #{label}\n")
            fp.write(" ".join("1.0" if j == label else "-1.0"
                              for j in range(n_out)) + "\n")


def _setup_runs(tmp):
    from hpnn_tpu_torch.io.kernel_io import dump_kernel_to_path
    from hpnn_tpu_torch.models.kernel import generate_kernel

    runs = []
    for tag, (n_in, hid, n_out), scale, seed in (
            ("mnist", MNIST, "pixel", 10958), ("xrd", XRD, "unit", 851)):
        tests = os.path.join(tmp, f"{tag}_tests")
        _write_corpus(tests, n_in, n_out, scale, seed)
        kern, _ = generate_kernel(seed, n_in, hid, n_out)
        kpath = os.path.join(tmp, f"{tag}_kernel.opt")
        dump_kernel_to_path(kern, kpath)
        combos = ([(k, d) for k in ("ANN", "SNN") for d in
                   ("f64", "f32", "bf16")] if tag == "mnist"
                  else [("ANN", "f32")])
        for kind, dtype in combos:
            name = f"{tag}_{kind.lower()}_{dtype}"
            conf = os.path.join(tmp, f"{name}.conf")
            with open(conf, "w") as fp:
                fp.write(f"[name] {name}\n[type] {kind}\n[init] {kpath}\n"
                         f"[seed] 10958\n[input] {n_in}\n"
                         f"[hidden] {' '.join(map(str, hid))}\n"
                         f"[output] {n_out}\n[train] BP\n"
                         f"[test_dir] {tests}\n[dtype] {dtype}\n")
            runs.append((name, conf, kind, dtype, scale))
    return runs


def phase_run_nn(runs):
    import torch

    from hpnn_tpu_torch import cli
    from hpnn_tpu_torch.api import configure, dtype_of, load_tests
    from hpnn_tpu_torch.models.kernel import weights_to_torch
    from hpnn_tpu_torch.ops.kernels import (batched_forward_plain,
                                            fused_linear_act)

    results, rows_cache = {}, {}
    for name, conf, kind, dtype, scale in runs:
        before = fused_linear_act.launches
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc, outs = cli.run_nn(["-v", "-v", "--device", "cuda", conf])
        wall = time.perf_counter() - t0
        text = out.getvalue()
        launched = fused_linear_act.launches - before
        if rc != 0 or outs is None:
            raise AssertionError(f"run_nn {name}: rc={rc}")
        if launched <= 0:
            raise AssertionError(f"run_nn {name}: no kernel launch")
        n_tested = text.count("TESTING FILE:")
        if n_tested != N_FILES or outs.shape[0] != N_FILES:
            raise AssertionError(f"run_nn {name}: {n_tested} files tested")
        if not np.all(np.isfinite(outs)):
            raise AssertionError(f"run_nn {name}: non-finite outputs")
        nn = configure(conf)
        key = nn.conf.tests
        if key not in rows_cache:
            t0 = time.perf_counter()
            rows_cache[key] = load_tests(nn)[1]
            log(f"corpus {os.path.basename(key)}: {N_FILES} files parsed "
                f"on the host in {time.perf_counter() - t0:.2f} s")
        xs = rows_cache[key]
        dt = dtype_of(nn.conf)
        weights = weights_to_torch(nn.kernel.weights, dt, "cuda")
        plain = batched_forward_plain(
            weights, torch.as_tensor(xs).cuda().to(dt), kind)
        err = float(np.max(np.abs(
            outs - plain.double().cpu().numpy())))
        lim = _limit(dtype, scale)
        if not err <= lim:
            raise AssertionError(f"run_nn {name}: max |kernel - plain| = "
                                 f"{err:.3e} > {lim:g}")
        log(f"run_nn {name}: {n_tested} files, PASS={text.count('[PASS]')}"
            f", launches={launched}, max |kernel - plain| = {err:.3e} "
            f"(limit {lim:g}), {wall:.2f} s")
        results[name] = (outs, xs)
    return results


# --- phase 5 ----------------------------------------------------------------

def _post(url, rows):
    body = json.dumps({"inputs": rows.tolist()}).encode()
    req = urllib.request.Request(url, data=body, headers={
        "Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, json.loads(r.read())


def phase_serve(runs, results):
    from hpnn_tpu_torch import cli
    from hpnn_tpu_torch.ops.kernels import fused_linear_act
    from hpnn_tpu_torch.serve.server import serve_in_thread

    confs = {name: conf for name, conf, *_ in runs}
    served = ("mnist_ann_f32", "mnist_ann_f64",
              "mnist_snn_f32", "mnist_snn_f64")
    before = fused_linear_act.launches
    app, _ = cli.serve_app(["-p", "0", "--device", "cuda",
                            "--warmup-mode", "sync",
                            *(confs[n] for n in served)])
    if app is None:
        raise AssertionError("serve_nn: no app")
    httpd, th = serve_in_thread(app, "127.0.0.1", 0)
    base = "http://%s:%d" % httpd.server_address[:2]
    n_req = 0
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            if r.status != 200:
                raise AssertionError(f"healthz {r.status}")
        for name in served:
            outs, xs = results[name]
            url = f"{base}/v1/kernels/{name}/infer"

            def check(lo, hi, url=url, outs=outs, xs=xs, name=name):
                status, body = _post(url, xs[lo:hi])
                got = np.asarray(body["outputs"], np.float64)
                if status != 200 or not np.array_equal(got, outs[lo:hi]):
                    raise AssertionError(
                        f"serve {name} rows {lo}:{hi}: status {status}, "
                        "answer not bit-identical to run_nn")

            for lo, hi in ((0, 1), (1, 4), (4, 68)):
                check(lo, hi)
                n_req += 1
            spans = [(100 + 9 * i, 100 + 9 * i + 1 + i) for i in range(8)]
            errors = []

            def one(lo, hi):
                try:
                    check(lo, hi)
                except Exception as exc:  # re-raised below, on this thread
                    errors.append(exc)

            threads = [threading.Thread(target=one, args=s) for s in spans]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
                if t.is_alive():
                    raise AssertionError("serve: a request never returned")
            if errors:
                raise errors[0]
            n_req += len(spans)
        with urllib.request.urlopen(base + "/metrics?format=json",
                                    timeout=60) as r:
            snap = json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        app.close(drain=True)
        th.join(timeout=60)
    launched = fused_linear_act.launches - before
    if launched <= 0:
        raise AssertionError("serve: no kernel launch")
    log(f"serve_nn: {n_req} requests over {len(served)} kernels, all 200 "
        f"and bit-identical to run_nn; launches={launched}; batches="
        f"{snap['batches']}; cache={snap['compile_cache']}")


# --- phase 6 ----------------------------------------------------------------

def _device_ms(fn, launches=10, runs=20):
    """Device time of one call of ``fn``: the median over ``runs`` of a
    back-to-back run of ``launches`` calls between two CUDA events.  A GPU
    spin (``torch.cuda._sleep``) is queued first, so the host has enqueued
    the whole run before the first call starts and host overhead does not
    enter the measurement."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def _bound(b, n, m, dtype):
    item = {"f32": 4, "bf16": 2, "f64": 8}[dtype]
    t_ops = 2.0 * b * n * m / PEAK[dtype]
    t_bytes = (b * m + n * m + b * n) * item / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def phase_times():
    from hpnn_tpu_torch.ops.activations import ann_act
    from hpnn_tpu_torch.ops.kernels import (fused_linear_act,
                                            fused_linear_act_plain)

    import torch

    rng = np.random.default_rng(7)
    cells = []
    for label, n, m, act, scale in LAYERS:
        w = rng.uniform(-1.0, 1.0, (n, m)) / np.sqrt(m)
        for b in TIMED_BATCHES:
            x = _inputs(rng, b, m, scale)
            for dname, dt in _dtypes().items():
                wt, xt = _to_card(w, dt), _to_card(x, dt)

                def library(wt=wt, xt=xt, act=act):
                    z = torch.matmul(xt, wt.T)
                    return ann_act(z) if act else z

                def kernel(wt=wt, xt=xt, act=act):
                    return fused_linear_act(wt, xt, act=act)

                def plain(wt=wt, xt=xt, act=act):
                    return fused_linear_act_plain(wt, xt, act=act)

                ms = _device_ms(kernel)
                plain_ms = _device_ms(plain)
                library_ms = _device_ms(library)
                bound_ms, bound_by = _bound(b, n, m, dname)
                cells.append({"layer": label, "dtype": dname, "B": b,
                              "ms": ms, "plain_ms": plain_ms,
                              "library_ms": library_ms,
                              "bound_ms": bound_ms, "bound_by": bound_by})
                log(f"time fused_linear_act {label} {dname} B={b}: "
                    f"ms={ms:.5f} plain_ms={plain_ms:.5f} "
                    f"library_ms={library_ms:.5f} "
                    f"bound_ms={bound_ms:.5f} ({bound_by})")
    return cells


# --- phase 7-9: the training epoch kernel ----------------------------------

def _bar_corpus(n, topology, classes, seed):
    """A separable corpus: class c lights one bar (60 pixels at 250 on the
    MNIST width, 3 inputs at 1.0 on the XRD width), plus one random input
    (tests/test_tutorials.py:26-31).  Returns (xs, ts, labels)."""
    n_in, _, n_out = topology
    mnist = n_in == 784
    width, value = (60, 250.0) if mnist else (3, 1.0)
    rng = np.random.default_rng(seed)
    xs = np.zeros((n, n_in))
    ts = -np.ones((n, n_out))
    labels = [classes[i % len(classes)] for i in range(n)]
    for i, c in enumerate(labels):
        xs[i, c * width:(c + 1) * width] = value
        xs[i, rng.integers(0, n_in)] = (rng.integers(0, 256) if mnist
                                        else rng.uniform(0.0, 1.0))
        ts[i, c] = 1.0
    return xs, ts, labels


def _train_inputs(topology, dtype, classes, samples, seed=31):
    import torch

    from hpnn_tpu_torch.models.kernel import generate_kernel

    n_in, hid, n_out = topology
    xs, ts, _ = _bar_corpus(samples, topology, classes, seed)
    kern, _ = generate_kernel(10958, n_in, hid, n_out)
    dt = _dtypes()[dtype]
    wdt = torch.float32 if dt == torch.bfloat16 else dt
    return (tuple(_to_card(w, wdt) for w in kern.weights),
            _to_card(xs, dt), _to_card(ts, dt))


def _params(weights):
    return sum(w.shape[0] * w.shape[1] for w in weights)


def _train_bound(weights, momentum, iters, dtype, n_samples):
    """The least time of an epoch of ``iters`` iterations: the operations
    the kernel does per iteration (the update fused into the forward:
    BP 3 flops a weight, BPM 5, the forward's multiply-add 2; the hidden
    deltas 2 a weight of every layer but the first) over the card's peak,
    against the bytes of the epoch's inputs and outputs read and written
    once (weights in and out, samples, targets, stats; the weights stay on
    the chip between iterations) over 3.35 TB/s.  Returns (bound_ms,
    bound_by, flops_per_iteration)."""
    p = _params(weights)
    p_hidden = p - weights[0].shape[0] * weights[0].shape[1]
    flops_it = (7 if momentum else 5) * p + 2 * p_hidden
    item = {"f32": 4, "bf16": 2, "f64": 8}[dtype]
    witem = 4 if dtype == "bf16" else item
    n_in, n_out = weights[0].shape[1], weights[-1].shape[0]
    nbytes = 2 * p * witem + n_samples * (n_in + n_out) * item \
        + n_samples * 5 * 8
    t_ops = iters * flops_it / PEAK[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops_it)


def _check_train(tag, dtype, sk, sp, wk, wp):
    """Kernel stats/weights against the plain version's; raises above the
    dtype's limits.  Returns (max weight diff, max |dn_iter|)."""
    k, p = sk.cpu().numpy(), sp.cpu().numpy()
    slack, rel, wlim = TRAIN_LIMIT[dtype]
    werr = max(float((a.double() - b.double()).abs().max())
               for a, b in zip(wk, wp))
    dn = np.abs(k[:, 2] - p[:, 2])
    bad = []
    if not np.array_equal(k[:, [1, 4]], p[:, [1, 4]]):
        bad.append("first_ok/success differ")
    if not np.all(dn <= np.maximum(slack, rel * p[:, 2])):
        bad.append(f"n_iter {k[:, 2].tolist()} vs {p[:, 2].tolist()}")
    if dtype == "f64":
        eerr = float(np.abs(k[:, [0, 3]] - p[:, [0, 3]]).max())
        if not eerr <= 1e-12:
            bad.append(f"init_err/final_dep differ by {eerr:.3e}")
    if not werr <= wlim:
        bad.append(f"weights differ by {werr:.3e} > {wlim:g}")
    if bad:
        raise AssertionError(f"train_epoch {tag}: " + "; ".join(bad))
    return werr, float(dn.max())


def phase_train_vs_plain():
    import torch

    from hpnn_tpu_torch.ops.convergence_kernel import (train_epoch_kernel,
                                                       train_epoch_plain)

    results = []
    for name, topo, kind, momentum, dtype, classes, n in TRAIN_RUNS:
        w, x, t = _train_inputs(topo, dtype, classes, n)
        tag = (f"{name} {kind} {'BPM' if momentum else 'BP'} {dtype} "
               f"({n} samples)")
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        wk, sk = train_epoch_kernel(w, x, t, kind, momentum)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end)
        t0 = time.perf_counter()
        wp, sp = train_epoch_plain(w, x, t, kind, momentum)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        werr, dn = _check_train(tag, dtype, sk, sp, wk, wp)
        k, p = sk.cpu().numpy(), sp.cpu().numpy()
        iters, p_iters = int(k[:, 2].sum()), int(p[:, 2].sum())
        bound_ms, bound_by, flops_it = _train_bound(w, momentum, iters,
                                                    dtype, n)
        same = int(np.sum((k[:, 1] == p[:, 1]) & (k[:, 4] == p[:, 4])))
        results.append({"run": tag, "dtype": dtype, "kind": kind,
                        "momentum": momentum, "samples": n,
                        "iters": iters, "plain_iters": p_iters,
                        "max_dn_iter": dn, "max_abs_err": werr,
                        "verdicts_equal": same, "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "flops_per_iter": flops_it,
                        "grid": train_epoch_kernel.grid,
                        "n_iter": k[:, 2].astype(int).tolist(),
                        "plain_n_iter": p[:, 2].astype(int).tolist()})
        log(f"train_epoch {tag}: iterations {iters} (plain {p_iters}), "
            f"max |dn_iter| {dn:g}, verdicts equal {same}/{n}, max |kernel - "
            f"plain| weights {werr:.3e}; kernel {ms:.2f} ms = "
            f"{ms * 1e3 / iters:.2f} us/iter on {train_epoch_kernel.grid} "
            f"blocks, plain {plain_ms * 1e3 / p_iters:.1f} us/iter, bound "
            f"{bound_ms * 1e6 / iters:.4f} ns/iter ({bound_by})")
    worst = {d: max((r["max_abs_err"] for r in results if r["dtype"] == d),
                    default=0.0) for d in _dtypes()}
    log("train_epoch vs plain: all runs within limits; worst weight error "
        + ", ".join(f"{d} {e:.3e}" for d, e in worst.items()))
    return results


def phase_resume():
    import torch

    from hpnn_tpu_torch.ops.convergence_kernel import (train_epoch_cuda,
                                                       train_epoch_kernel)

    w, x, t = _train_inputs(MNIST, "f64", (0, 1), 8)
    before = train_epoch_kernel.launches
    w1, s1 = train_epoch_cuda(w, x, t, "ANN", False)
    one = train_epoch_kernel.launches - before
    w2, s2 = train_epoch_cuda(w, x, t, "ANN", False, iter_budget=100)
    many = train_epoch_kernel.launches - before - one
    torch.cuda.synchronize()
    if one != 1 or many <= 1:
        raise AssertionError(f"resume: {one} launch(es) unbudgeted, {many} "
                             "budgeted")
    equal = all(np.array_equal(a.cpu().numpy(), b.cpu().numpy())
                for a, b in zip(w1, w2)) and all(
        np.array_equal(getattr(s1, f).numpy(), getattr(s2, f).numpy())
        for f in s1._fields)
    if not equal:
        raise AssertionError("resume: budgeted launches differ from one "
                             "launch")
    log(f"resume: f64 MNIST ANN BP epoch ({int(s1.n_iter.sum())} "
        f"iterations) in {many} launches at a budget of 100 iterations is "
        "bit-identical to 1 launch")
    return many


def _write_samples(dirpath, xs, ts, labels):
    os.makedirs(dirpath)
    for i, (x, t, c) in enumerate(zip(xs, ts, labels)):
        with open(os.path.join(dirpath, f"s{i:05d}.txt"), "w") as fp:
            fp.write(f"[input] {x.shape[0]}\n")
            fp.write(" ".join(f"{v:.1f}" for v in x) + "\n")
            fp.write(f"[output] {t.shape[0]}  #{c}\n")
            fp.write(" ".join(f"{v:.1f}" for v in t) + "\n")


def phase_train_nn(tmp):
    """train_nn on the MNIST tutorial conf (tutorials/mnist/tutorial.bash:
    36-48: ANN, BP, [init] generate, [seed] 10958, 784-300-10, f64), then
    run_nn of its kernel.opt."""
    from hpnn_tpu_torch import cli

    root = os.path.join(tmp, "train_nn")
    classes = tuple(range(10))
    for sub, seed in (("samples", 5), ("tests", 6)):
        xs, ts, labels = _bar_corpus(TRAIN_FILES, MNIST, classes, seed)
        _write_samples(os.path.join(root, sub), xs, ts, labels)
    conf = ("[name] mnist\n[type] ANN\n[init] generate\n[seed] 10958\n"
            "[input] 784\n[hidden] 300\n[output] 10\n[train] BP\n"
            "[sample_dir] ./samples\n[test_dir] ./tests\n")
    with open(os.path.join(root, "nn.conf"), "w") as fp:
        fp.write(conf)
    with open(os.path.join(root, "run.conf"), "w") as fp:
        fp.write(conf.replace("[init] generate", "[init] kernel.opt"))
    cwd = os.getcwd()
    os.chdir(root)
    try:
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.train_nn_main(["-v", "-v", "--device", "cuda",
                                    "nn.conf"])
        wall = time.perf_counter() - t0
        text = out.getvalue()
        lines = [ln for ln in text.splitlines() if "TRAINING FILE:" in ln]
        iters = [int(m) for m in re.findall(r"N_ITER=\s*(\d+)", text)]
        if rc != 0 or len(lines) != TRAIN_FILES or len(iters) != TRAIN_FILES:
            raise AssertionError(f"train_nn: rc={rc}, {len(lines)} lines, "
                                 f"{len(iters)} with N_ITER")
        for f in ("kernel.tmp", "kernel.opt"):
            if not os.path.isfile(f):
                raise AssertionError(f"train_nn: {f} was not written")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc, outs = cli.run_nn(["-v", "-v", "--device", "cuda",
                                   "run.conf"])
        n_pass = out.getvalue().count("[PASS]")
        if rc != 0 or outs is None or not np.all(np.isfinite(outs)):
            raise AssertionError(f"run_nn of the trained kernel: rc={rc}")
        if n_pass < 0.8 * TRAIN_FILES:
            raise AssertionError(f"run_nn of the trained kernel: PASS "
                                 f"{n_pass}/{TRAIN_FILES} < 80%")
    finally:
        os.chdir(cwd)
    n_ok = text.count("SUCCESS!")
    log(f"train_nn: {TRAIN_FILES} files, {sum(iters)} iterations, "
        f"SUCCESS {n_ok}, wall {wall:.2f} s; run_nn of kernel.opt: PASS "
        f"{n_pass}/{TRAIN_FILES}")
    return {"root": root, "iters": sum(iters), "wall_s": wall,
            "success": n_ok, "pass": n_pass}


def phase_train_time(e2e):
    """Device time of phase 9's epoch: the same conf, shuffle and samples
    through the kernel alone, between two CUDA events."""
    import torch

    from hpnn_tpu_torch.api import configure, shuffle_order
    from hpnn_tpu_torch.io.corpus import load_ordered
    from hpnn_tpu_torch.io.samples import list_sample_dir
    from hpnn_tpu_torch.models.kernel import weights_to_torch
    from hpnn_tpu_torch.ops.convergence_kernel import train_epoch_cuda

    cwd = os.getcwd()
    os.chdir(e2e["root"])
    try:
        nn = configure("nn.conf")
        names = list_sample_dir(nn.conf.samples)
        _, xs, ts = load_ordered(nn.conf.samples, names,
                                 shuffle_order(nn.conf, len(names)),
                                 "TRAINING", 784, 10)
    finally:
        os.chdir(cwd)
    w = weights_to_torch(nn.kernel.weights, torch.float64, "cuda")
    x, t = _to_card(xs, torch.float64), _to_card(ts, torch.float64)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    _, st = train_epoch_cuda(w, x, t, "ANN", False)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end)
    iters = int(st.n_iter.sum())
    if iters != e2e["iters"]:
        raise AssertionError(f"train_nn epoch replay: {iters} iterations, "
                             f"train_nn printed {e2e['iters']}")
    bound_ms, bound_by, flops_it = _train_bound(w, False, iters, "f64",
                                                xs.shape[0])
    log(f"train_nn epoch on the card: {ms:.1f} ms device time, {iters} "
        f"iterations = {ms * 1e3 / iters:.2f} us/iter "
        f"({iters / ms * 1e3:.0f} iterations/s); bound {bound_ms:.4f} ms "
        f"({bound_by}, {flops_it} flops an iteration)")
    return {"ms": ms, "iters": iters, "us_per_iter": ms * 1e3 / iters,
            "bound_ms": bound_ms, "bound_by": bound_by}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="also write every cell's numbers to PATH")
    json_path = ap.parse_args(argv).json
    try:
        import torch
    except ImportError:
        sys.stderr.write("chip_smoke: torch is not installed\n")
        return 1
    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: no CUDA device is visible "
                         "(torch.cuda.is_available() is False)\n")
        return 1
    if not os.path.isdir(os.path.join(ROOT, "hpnn_tpu_torch")):
        sys.stderr.write("chip_smoke: run it from a checkout of the repo "
                         "(hpnn_tpu_torch/ is missing)\n")
        return 1
    sys.path.insert(0, ROOT)
    from hpnn_tpu_torch import runtime
    from hpnn_tpu_torch.ops.convergence_kernel import train_epoch_kernel
    from hpnn_tpu_torch.ops.kernels import fused_linear_act

    def reset_counts():
        fused_linear_act.launches = 0
        train_epoch_kernel.launches = 0

    t_start = time.perf_counter()
    runtime.pin_full_float32()
    card = phase_device()
    phase_build()
    errs = phase_kernel_vs_plain()
    train = phase_train_vs_plain()
    resume_launches = phase_resume()
    with tempfile.TemporaryDirectory(prefix="hpnn_chip_smoke_") as tmp:
        runs = _setup_runs(tmp)
        reset_counts()                         # fused_linear_act's path
        results = phase_run_nn(runs)
        phase_serve(runs, results)
        launches = fused_linear_act.launches
        reset_counts()                         # train_epoch's path
        e2e = phase_train_nn(tmp)
        train_launches = train_epoch_kernel.launches
        train_path_fused = fused_linear_act.launches
        if train_launches <= 0 or train_path_fused <= 0:
            raise AssertionError(
                f"train_nn + run_nn: train_epoch launched "
                f"{train_launches} times, fused_linear_act "
                f"{train_path_fused}")
        log(f"train path launches: train_epoch {train_launches}, "
            f"fused_linear_act {train_path_fused}")
        epoch = phase_train_time(e2e)
    cells = phase_times()
    rep = next(c for c in cells if c["layer"] == "784->300"
               and c["dtype"] == "f32" and c["B"] == 4096)
    cell = next(r for r in train if r["run"].startswith("mnist ANN BP f64"))
    kernels = {"kernels": [{
        "name": "fused_linear_act", "route": "cuda",
        "source": "hpnn_tpu_torch/csrc/fused_linear_act.cu",
        "replaces": "hpnn_tpu/ops/pallas_kernels.py:84",
        "launches": launches,
        "max_abs_err": max(errs.values()),
        "max_abs_err_by_dtype": {d: max(e for k, e in errs.items()
                                        if k[2] == d) for d in _dtypes()},
        "ms": rep["ms"], "plain_ms": rep["plain_ms"],
        "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
        "library_ms": rep["library_ms"],
        "timed_cell": "784->300 f32 B=4096 (the run_nn MNIST input "
                      "layer)"}, {
        "name": "train_epoch", "route": "cuda",
        "source": "hpnn_tpu_torch/csrc/train_epoch.cu",
        "replaces": "hpnn_tpu/ops/convergence_pallas.py:208",
        "launches": train_launches,
        "max_abs_err": max(r["max_abs_err"] for r in train),
        "max_abs_err_by_dtype": {d: max(r["max_abs_err"] for r in train
                                        if r["dtype"] == d)
                                 for d in _dtypes()},
        "ms": cell["ms"], "plain_ms": cell["plain_ms"],
        "bound_ms": cell["bound_ms"], "bound_by": cell["bound_by"],
        "library_ms": None,
        "us_per_iter": cell["ms"] * 1e3 / cell["iters"],
        "plain_us_per_iter": cell["plain_ms"] * 1e3 / cell["plain_iters"],
        "bound_us_per_iter": cell["bound_ms"] * 1e3 / cell["iters"],
        "timed_cell": f"{cell['run']}, one epoch of {cell['iters']} "
                      "iterations",
        "train_nn_epoch_ms": epoch["ms"],
        "train_nn_us_per_iter": epoch["us_per_iter"],
        "train_nn_iters": epoch["iters"],
        "budgeted_launches": resume_launches}]}
    if json_path:
        os.makedirs(os.path.dirname(os.path.abspath(json_path)),
                    exist_ok=True)
        with open(json_path, "w") as fp:
            json.dump({"card": card, "kernels": kernels["kernels"],
                       "cells": cells, "train_runs": train,
                       "train_nn": {**e2e, "epoch": epoch},
                       "errors": [{"layer": k[0], "scale": k[1],
                                   "dtype": k[2], "B": k[3],
                                   "max_abs_err": v}
                                  for k, v in errs.items()]}, fp, indent=1)
    log(f"chip_smoke: all phases passed in "
        f"{time.perf_counter() - t_start:.1f} s")
    log(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
