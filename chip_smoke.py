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
7. One JSON line of every kernel (launches on the main path, the largest
   kernel-vs-plain error of phase 3 over every cell and dtype, and the
   times and bound of the MNIST input layer at f32, B=4096), then the
   result line.

The launch counts are set to 0 just before phase 4 and read just after
phase 5.  ``--json PATH`` also writes every cell's numbers to PATH.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
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
    from hpnn_tpu_torch.ops.kernels import fused_linear_act

    t_start = time.perf_counter()
    runtime.pin_full_float32()
    card = phase_device()
    phase_build()
    errs = phase_kernel_vs_plain()
    with tempfile.TemporaryDirectory(prefix="hpnn_chip_smoke_") as tmp:
        runs = _setup_runs(tmp)
        fused_linear_act.launches = 0          # the main path starts here
        results = phase_run_nn(runs)
        phase_serve(runs, results)
        launches = fused_linear_act.launches   # ... and ends here
    cells = phase_times()
    rep = next(c for c in cells if c["layer"] == "784->300"
               and c["dtype"] == "f32" and c["B"] == 4096)
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
                      "layer)"}]}
    if json_path:
        os.makedirs(os.path.dirname(os.path.abspath(json_path)),
                    exist_ok=True)
        with open(json_path, "w") as fp:
            json.dump({"card": card, "kernels": kernels["kernels"],
                       "cells": cells,
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
