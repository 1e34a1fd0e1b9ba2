#!/usr/bin/env python3
"""Hold the port's ``train_tile`` against an earlier build of its kernel on
the card: bits and times.

    python3 scripts/torch_compare_tile.py --previous CU [--json PATH]

``--previous`` is an earlier ``train_tile.cu`` with the first port's C
interface (``w, dw, n, m, layers, xs, ts, stats, scratch, lanes, S, n_in,
n_out, kind, momentum, tile, lr, alpha, delta, min_iter, max_iter,
start_group, group_budget, device, stream, grid``; for example ``git show
3a4f428:hpnn_tpu_torch/csrc/train_tile.cu``), built with ``ops/build.py``'s
``nvcc`` flags into a library of its own.  Each run goes through it and
through ``train_tile`` in the order previous, current, current, previous
(device time from CUDA events behind a GPU spin); weights and stats are
compared byte for byte, and the current kernel's own count of its grid
barriers must be 2L - 2 a lockstep iteration.  The runs: every
``chip_smoke.py`` phase-10 run (784-2304-10 also through every forced
plan); 784-4096-10 ANN BP f64 at tile 512, whose block scratch goes to the
workspace (3 iterations at most); the tiles ``--tile auto`` tries at MNIST
ANN BP and BPM and XRD ANN BPM f64 (64-iteration probes over two groups);
phase 11's tile=1 runs and ragged tails (these and the probes: previous,
then current); and phase 12's epoch (``train_nn --tile 32`` on
phase 9's files and conf) and XRD ANN BPM f64 at tile 4.  Prints the
sha256 of both sources and the card's name and power limit.  Needs one
CUDA device; exits non-zero if a bit differs.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from hpnn_tpu_torch import runtime  # noqa: E402
from hpnn_tpu_torch.models.kernel import weights_to_torch  # noqa: E402
from hpnn_tpu_torch.ops import build  # noqa: E402
from hpnn_tpu_torch.ops.convergence_tile import (  # noqa: E402
    _accum_dtype, _stats_init, resident_weights, resolve_hyper,
    storage_wdtype)
from hpnn_tpu_torch.ops.convergence_tile_kernel import (  # noqa: E402
    _ENTRY, _KIND, train_tile)

PROBE_TILES = (8, 32, 128, 512)   # ops/autotune.py _DEFAULT_TILES
PROBE_ITER = 64                   # ops/autotune.py _PROBE_MAX_ITER
FORCED = ({"resident": False}, {"x_lanes": 2, "head": False},
          {"scratch": False})


def _sha(path):
    with open(path, "rb") as fp:
        return hashlib.sha256(fp.read()).hexdigest()


def _build_previous(src):
    out = os.path.join(tempfile.mkdtemp(prefix="hpnn_prev_"), "prev.so")
    r = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", out, src],
                       capture_output=True, text=True)
    if r.returncode:
        sys.stderr.write(r.stdout[-3000:] + r.stderr[-3000:])
        raise SystemExit(f"previous kernel: nvcc exit {r.returncode}")
    return ctypes.CDLL(out)


def _previous(lib, weights, xs, ts, kind, momentum, tile, storage=None,
              max_iter=None):
    """One launch of the earlier kernel through its C interface, as its
    wrapper made it; returns (weights, stats)."""
    add_dt = _accum_dtype(storage)
    fn = getattr(lib, _ENTRY[(xs.dtype, storage_wdtype(xs.dtype, storage),
                              add_dt)])
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    fn.argtypes = [p, p, p, p, i, p, p, p, p, p, i, i, i, i, i, i, d, d, d,
                   i, i, i, i, i, p, p]
    fn.restype = ctypes.c_int
    lr, delta, min_iter, max_iter = resolve_hyper(kind, momentum, None, -1.0,
                                                  max_iter)
    w = resident_weights(weights, xs.dtype, storage)
    stats = _stats_init(None, xs.shape[0], xs.device)
    dw = (tuple(torch.empty(v.shape, dtype=add_dt or v.dtype,
                            device=xs.device) for v in w)
          if momentum else w)
    xk, tk = ((xs.float(), ts.float()) if xs.dtype == torch.bfloat16
              else (xs, ts))
    n = [v.shape[0] for v in w]
    scratch = torch.empty(3 * tile * sum(n) + tile * ts.shape[1] + 3 * tile,
                          dtype=xk.dtype, device=xs.device)
    lanes = torch.zeros(6 * tile + 1, dtype=torch.int32, device=xs.device)
    layers = len(w)
    grid = ctypes.c_int(0)
    rc = fn((p * layers)(*(v.data_ptr() for v in w)),
            (p * layers)(*(v.data_ptr() for v in dw)),
            (i * layers)(*n), (i * layers)(*(v.shape[1] for v in w)), layers,
            xk.data_ptr(), tk.data_ptr(), stats.data_ptr(),
            scratch.data_ptr(), lanes.data_ptr(), xs.shape[0], xs.shape[1],
            ts.shape[1], _KIND[kind], int(momentum), tile, float(lr), 0.2,
            float(delta), min_iter, max_iter, 0, 2**31 - 1, xs.device.index,
            torch.cuda.current_stream().cuda_stream, ctypes.byref(grid))
    if rc:
        raise RuntimeError(f"previous kernel: launch failed ({rc})")
    return w, stats


def _timed(fn):
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(cs.SPIN_CYCLES)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


def compare(lib, tag, w, x, t, kind, momentum, tile, storage=None,
            max_iter=None, order=("prev", "cur", "cur", "prev"), forced=()):
    """One run through both kernels; prints and returns its row."""
    ms = {"prev": [], "cur": []}
    res = {}
    for who in order:
        if who == "prev":
            dt, res[who] = _timed(lambda: _previous(
                lib, w, x, t, kind, momentum, tile, storage, max_iter))
        else:
            dt, res[who] = _timed(lambda: train_tile(
                w, x, t, kind, momentum, tile=tile, storage=storage,
                max_iter=max_iter))
            plan, syncs = dict(train_tile.plan), train_tile.syncs.tolist()
        ms[who].append(dt)
    (wp, sp), (wc, sc) = res["prev"], res["cur"]
    equal = cs._bitwise(tuple(wp), tuple(wc)) and cs._bitwise(sp, sc)
    lock = cs._lockstep(sp[:, 2].cpu().numpy(), tile)
    want = 2 * len(w) - 2 if len(w) > 1 else 1
    barriers = syncs[2] == lock and syncs[0] == want * lock
    others = []
    for force in forced:
        wo, so = train_tile(w, x, t, kind, momentum, tile=tile,
                            storage=storage, max_iter=max_iter, _plan=force)
        others.append((force, cs._bitwise(tuple(wp), tuple(wo))
                       and cs._bitwise(sp, so)))
    print(f"{tag}: bits {'equal' if equal else 'DIFFER'}; {lock} lockstep "
          "iterations; previous "
          + "/".join(f"{v * 1e3 / lock:.2f}" for v in ms["prev"])
          + " us, current " + "/".join(f"{v * 1e3 / lock:.2f}"
                                       for v in ms["cur"])
          + f" us a lockstep iteration; barriers {syncs} "
          f"({'2L-2 a lockstep iteration' if barriers else 'WRONG'}); plan "
          f"{plan['blocks']}x{plan['warps']}, scratch on chip "
          f"{plan['scratch_on_chip']}, resident {plan['resident']}, x_lanes "
          f"{plan['x_lanes']}/{plan['lanes']}, {plan['smem_bytes']} shared "
          f"bytes, {plan['ws_bytes']} workspace bytes"
          + "".join(f"; forced {f}: {'equal' if e else 'DIFFER'}"
                    for f, e in others), flush=True)
    return {"run": tag, "equal": equal and all(e for _, e in others),
            "lockstep": lock, "prev_ms": ms["prev"], "ms": ms["cur"],
            "syncs": syncs, "barriers_ok": barriers, "plan": plan,
            "forced": [{"force": f, "equal": e} for f, e in others]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--previous", required=True, metavar="CU")
    ap.add_argument("--json", metavar="PATH")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.stderr.write("torch_compare_tile: no CUDA device\n")
        return 1
    runtime.pin_full_float32()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    current = os.path.join(build.CSRC, build.SOURCES["train_tile"])
    print(f"previous {args.previous} sha256 {_sha(args.previous)}; current "
          f"{os.path.relpath(current, ROOT)} sha256 {_sha(current)}",
          flush=True)
    build.build_all(["train_tile", "train_epoch"])
    lib = _build_previous(args.previous)
    rows = []
    for name, topo, kind, mom, dt, classes, n, tile, storage in cs.TILE_RUNS:
        w, x, t = cs._train_inputs(topo, dt, classes, n)
        tag = (f"{name} {kind} {'BPM' if mom else 'BP'} {dt} tile {tile}"
               + (f" storage {storage}" if storage else "") + f" ({n})")
        rows.append(compare(lib, tag, w, x, t, kind, mom, tile, storage,
                            forced=FORCED if name == "wide" else ()))
    # phase 11's runs: tile=1 (MNIST, 8 samples) and ragged tails (tile 4
    # over 6 samples)
    for kind, dtypes in (("ANN", ("f64", "f32", "bf16")),
                         ("LNN", ("f64", "f32", "bf16")),
                         ("SNN", ("f32", "bf16"))):
        classes = (0, 1, 2, 3) if kind == "SNN" else (0, 1)
        for dt in dtypes:
            for mom in (False, True):
                w, x, t = cs._train_inputs(cs.MNIST, dt, classes, 8)
                rows.append(compare(
                    lib, f"tile=1 mnist {kind} {'BPM' if mom else 'BP'} "
                    f"{dt} (8)", w, x, t, kind, mom, 1, order=("prev", "cur")))
    for kind, mom, dt in (("ANN", False, "f64"), ("SNN", True, "f32")):
        classes = (0, 1, 2, 3) if kind == "SNN" else (0, 1)
        w, x, t = cs._train_inputs(cs.MNIST, dt, classes, 6)
        rows.append(compare(lib, f"ragged mnist {kind} "
                            f"{'BPM' if mom else 'BP'} {dt} tile 4 (6)", w,
                            x, t, kind, mom, 4, order=("prev", "cur")))
    topo, tile, max_iter = cs.WIDE_SCRATCH
    w, x, t = cs._train_inputs(topo, "f64", (0, 1), tile)
    rows.append(compare(lib, f"784-4096-10 ANN BP f64 tile {tile} ({tile}, "
                        f"max_iter {max_iter})", w, x, t, "ANN", False, tile,
                        max_iter=max_iter))
    for topo, name, moms in ((cs.MNIST, "mnist", (False, True)),
                             (cs.XRD, "xrd", (True,))):
        for mom in moms:
            for tile in PROBE_TILES:
                w, x, t = cs._train_inputs(topo, "f64", (0, 1), 2 * tile)
                rows.append(compare(
                    lib, f"{name} ANN {'BPM' if mom else 'BP'} f64 tile "
                    f"{tile} ({2 * tile}, max_iter {PROBE_ITER})", w, x, t,
                    "ANN", mom, tile, max_iter=PROBE_ITER,
                    order=("prev", "cur")))
    with tempfile.TemporaryDirectory(prefix="hpnn_compare_tile_") as tmp:
        e2e = cs.phase_train_nn(tmp)
        nn, xs, ts = cs._epoch_inputs(e2e["root"])
    w = weights_to_torch(nn.kernel.weights, torch.float64, "cuda")
    x, t = cs._to_card(xs, torch.float64), cs._to_card(ts, torch.float64)
    rows.append(compare(lib, f"phase 12 epoch MNIST ANN BP f64 tile "
                        f"{cs.TRAIN_TILE} ({xs.shape[0]})", w, x, t, "ANN",
                        False, cs.TRAIN_TILE))
    w, x, t = cs._train_inputs(cs.XRD, "f64", (0, 1), 4)
    rows.append(compare(lib, "xrd ANN BPM f64 tile 4 (4), again", w, x, t,
                        "ANN", True, 4))
    bad = [r["run"] for r in rows if not (r["equal"] and r["barriers_ok"])]
    print(f"{len(rows) - len(bad)} of {len(rows)} runs bit-identical to the "
          "previous kernel with 2L-2 grid barriers a lockstep iteration"
          + (f"; NOT: {bad}" if bad else ""), flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as fp:
            json.dump(rows, fp, indent=1)
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
