#!/usr/bin/env python3
"""Measure the port's ``fused_linear_act`` on the card: every launch plan
at the cells ``chip_smoke.py`` times, and the bits and times of an earlier
build of the kernel.

    python3 scripts/torch_compare_linear.py [--sweep] [--previous CU]
        [--batches 512,4096] [--json PATH]

``--sweep`` runs, at each of ``chip_smoke.py``'s layers, timed batch sizes
(or ``--batches``) and dtypes, every plan the kernel can take (each staged
tile with its stages in one group or split in 2, 4 or 8, and the direct
plan) in place of the one ``ops/kernels.py`` ``_plan`` picks, holds each
plan's output bit for bit against the planner's, and prints its device
time beside the planner's.  ``--previous`` builds an earlier
``fused_linear_act.cu`` that has the first port's C interface (``xs, w,
out, B, N, M, act, device, stream``; for example ``git show
<commit>:hpnn_tpu_torch/csrc/fused_linear_act.cu``) with the same ``nvcc``
flags, holds the current kernel's float32 and float64 outputs against it
bit for bit (the layers, a ragged 37->13, B in {1, 3, 5, 64, 100, 512,
4096}) and times both, bfloat16 too, beside ``torch.matmul`` +
activation at ``chip_smoke.py``'s timed cells.  Needs one
CUDA device; inputs come from a seeded numpy generator.  Exits non-zero
if a bit differs.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from hpnn_tpu_torch.ops import build  # noqa: E402
from hpnn_tpu_torch.ops import kernels as K  # noqa: E402
from hpnn_tpu_torch.ops.activations import ann_act  # noqa: E402

RAGGED = ("37->13", 13, 37, True, "unit")
CHECK_BATCHES = (1, 3, 5, 64, 100, 512, 4096)


def _bits(t):
    return t.contiguous().view(torch.uint8)


def _library(w, xs, act):
    z = torch.matmul(xs, w.T)
    return ann_act(z) if act else z


@contextlib.contextmanager
def _forced(plan):
    """``fused_linear_act`` launches ``plan`` whatever the shapes."""
    chosen = K._plan
    K._plan = lambda b, n, m, dtype: plan
    try:
        yield
    finally:
        K._plan = chosen


def _plans(b, n, m, dtype):
    """Every plan the kernel takes at one cell."""
    stages = max(1, -(-m // K.STAGE))
    tiles = K.MMA_TILES if dtype == torch.bfloat16 else K.SIMT_TILES
    for tile, (bm, bn) in enumerate(tiles):
        for per_group in sorted({-(-stages // g) for g in (1, 2, 4, 8)
                                 if g <= stages}, reverse=True):
            groups = -(-stages // per_group)
            yield K.Plan(tile, bm, bn, stages, per_group, groups,
                         -(-b // bm), -(-n // bn),
                         stages * b * n if groups > 1 else 0)
    if stages <= K.DIRECT_MAX_STAGES:
        bm, bn = ((16, 8) if dtype == torch.bfloat16
                  else (32 // K.DIRECT_COLS, K.DIRECT_COLS))
        yield K.Plan(K.DIRECT, bm, bn, stages, stages, 1, -(-b // bm),
                     -(-n // bn), 0)


def sweep(batches, seed=7):
    """Device ms of every plan at each cell, fastest first; raises if a
    plan's output differs in one bit from the planner's."""
    rng = np.random.default_rng(seed)
    rows = []
    for label, n, m, act, scale in cs.LAYERS:
        w = rng.uniform(-1.0, 1.0, (n, m)) / np.sqrt(m)
        for b in batches:
            x = cs._inputs(rng, b, m, scale)
            for name, dt in cs._dtypes().items():
                wt, xt = cs._to_card(w, dt), cs._to_card(x, dt)
                run = lambda: K.fused_linear_act(wt, xt, act=act)  # noqa
                want = _bits(run())
                row = {"layer": label, "dtype": name, "B": b,
                       "plan": list(K._plan(b, n, m, dt)),
                       "ms": cs._device_ms(run, runs=5),
                       "library_ms": cs._device_ms(
                           lambda: _library(wt, xt, act), runs=5),
                       "plans": []}
                for plan in _plans(b, n, m, dt):
                    with _forced(plan):
                        if not torch.equal(_bits(run()), want):
                            raise AssertionError(
                                f"{label} {name} B={b}: plan {tuple(plan)} "
                                "differs in its bits from the planner's")
                        row["plans"].append((cs._device_ms(run, runs=5),
                                             list(plan)))
                row["plans"].sort()
                best = row["plans"][0]
                print(f"{label} {name} B={b}: planner {row['ms']:.5f} ms "
                      f"{tuple(row['plan'][:5])}, best {best[0]:.5f} "
                      f"{tuple(best[1][:5])}, library "
                      f"{row['library_ms']:.5f}", flush=True)
                rows.append(row)
    return rows


def load_previous(source):
    """Build an earlier ``fused_linear_act.cu`` (first-port C interface)
    and return its entries by dtype name."""
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(build.BUILD_DIR, "fused_linear_act_previous.so")
    proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", lib_path,
                           source], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source}:\n{proc.stdout}"
                           f"{proc.stderr}")
    lib = ctypes.CDLL(lib_path)
    fns = {}
    for name in ("f32", "f64", "bf16"):
        fn = getattr(lib, f"hpnn_fused_linear_act_{name}")
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def _previous(fn, w, xs, act):
    b, m = xs.shape
    out = torch.empty((b, w.shape[0]), dtype=xs.dtype, device=xs.device)
    rc = fn(xs.data_ptr(), w.data_ptr(), out.data_ptr(), b, w.shape[0], m,
            int(act), xs.device.index,
            torch.cuda.current_stream(xs.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"previous kernel launch failed ({rc})")
    return out


def against_previous(prev, seed=5):
    """float32 and float64 bits against the earlier build at every checked
    cell (bfloat16 left the earlier build's arithmetic for the tensor
    cores), then device times of both at the timed cells, every dtype."""
    rng = np.random.default_rng(seed)
    checked, differ = 0, []
    for label, n, m, act, scale in cs.LAYERS + (RAGGED,):
        w = rng.uniform(-1.0, 1.0, (n, m)) / np.sqrt(m)
        for b in CHECK_BATCHES:
            x = cs._inputs(rng, b, m, scale)
            for name in ("f32", "f64"):
                dt = cs._dtypes()[name]
                wt, xt = cs._to_card(w, dt), cs._to_card(x, dt)
                got = K.fused_linear_act(wt, xt, act=act)
                want = _previous(prev[name], wt, xt, act)
                torch.cuda.synchronize()
                checked += 1
                if not torch.equal(_bits(got), _bits(want)):
                    differ.append(f"{label} {name} B={b}")
    print(f"bitwise against the earlier build: {checked} cells, "
          f"{len(differ)} differ {differ}", flush=True)
    cells = []
    for label, n, m, act, scale in cs.LAYERS:
        w = rng.uniform(-1.0, 1.0, (n, m)) / np.sqrt(m)
        for b in cs.TIMED_BATCHES:
            x = cs._inputs(rng, b, m, scale)
            for name in prev:
                dt = cs._dtypes()[name]
                wt, xt = cs._to_card(w, dt), cs._to_card(x, dt)
                cell = {"layer": label, "dtype": name, "B": b,
                        "ms": cs._device_ms(
                            lambda: K.fused_linear_act(wt, xt, act=act)),
                        "previous_ms": cs._device_ms(
                            lambda: _previous(prev[name], wt, xt, act)),
                        "library_ms": cs._device_ms(
                            lambda: _library(wt, xt, act))}
                print(json.dumps(cell), flush=True)
                cells.append(cell)
    return {"checked": checked, "differ": differ, "cells": cells}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sweep", action="store_true",
                    help="time every launch plan at each cell")
    ap.add_argument("--batches", default=None,
                    help="comma-separated batch sizes for --sweep "
                         "(default: chip_smoke.py's timed ones)")
    ap.add_argument("--previous", metavar="CU", default=None,
                    help="an earlier fused_linear_act.cu to hold the "
                         "kernel against, bit for bit and in time")
    ap.add_argument("--json", metavar="PATH", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.stderr.write("torch_compare_linear: no CUDA device is visible\n")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--id=0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    result = {"card": smi.stdout.strip()}
    print(result["card"], flush=True)
    if args.sweep:
        batches = (tuple(int(v) for v in args.batches.split(","))
                   if args.batches else cs.TIMED_BATCHES)
        result["sweep"] = sweep(batches)
    if args.previous:
        result["previous"] = against_previous(load_previous(args.previous))
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as fp:
            json.dump(result, fp, indent=1)
    return 1 if result.get("previous", {}).get("differ") else 0


if __name__ == "__main__":
    raise SystemExit(main())
