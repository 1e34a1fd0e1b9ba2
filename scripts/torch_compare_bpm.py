#!/usr/bin/env python3
"""Hold the port's ``fused_bpm_update`` against an earlier build of its kernel
on the card: bits and times.

    python3 scripts/torch_compare_bpm.py --previous CU [--plans]
        [--json PATH]

``--previous`` is an earlier ``fused_bpm_update.cu`` with the first port's C
interface (``w, dw, d, h, w_out, dw_out, n, m, lr, alpha, device, stream``;
for example ``git show 63a3601:hpnn_tpu_torch/csrc/fused_bpm_update.cu``),
built with ``ops/build.py``'s ``nvcc`` flags into a library of its own.  At
each of ``chip_smoke.py`` phase 13's shapes and at float64 and float32, both
kernels' outputs must equal the plain version's bit for bit, and each is
timed warm (back-to-back calls on the same buffers) and cold (calls
rotating over copies of the inputs that span twice the L2) in the order
previous, current, current, previous, beside an empty kernel's floor in the
same loop and the byte bound.  ``--plans`` also times the current kernel
under the other grids it differs from, bits checked too: one wave of the
SMs (132 x 2048 threads), each thread then walking several rows, and one
row of blocks (one block at 10x300) taking every row; ``fused_bpm_plan``
takes a thread a row.  Prints the sha256 of both sources and the card's name and power
limit.  Needs one CUDA device; exits non-zero if a bit differs.
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
from hpnn_tpu_torch.ops import build  # noqa: E402
from hpnn_tpu_torch.ops.kernels import (  # noqa: E402
    _BPM_ENTRY, _bpm_fns, _bpm_lib, empty_launch, fused_bpm_plan,
    fused_bpm_update, fused_bpm_update_plain)

LR, ALPHA = 0.0005, 0.2
WAVE_THREADS = 132 * 2048   # the H100's SMs x the threads each holds


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
    lib = ctypes.CDLL(out)
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for name in _BPM_ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [p, p, p, p, p, p, i, i, d, d, i, p]
        fn.restype = i
    return lib


def _previous(lib, w, dw, d, h):
    """One launch of the earlier kernel through its C interface, as its
    wrapper made it; returns (w', dw')."""
    w_out, dw_out = torch.empty_like(w), torch.empty_like(dw)
    rc = getattr(lib, _BPM_ENTRY[w.dtype])(
        w.data_ptr(), dw.data_ptr(), d.data_ptr(), h.data_ptr(),
        w_out.data_ptr(), dw_out.data_ptr(), w.shape[0], w.shape[1], LR,
        ALPHA, w.device.index, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"previous kernel: launch failed ({rc})")
    return w_out, dw_out


def _other_plans(n, m, item):
    """The grids ``--plans`` times beside the chosen one, where they differ
    from it: one wave of blocks, and (up to 2**20 weights) one row of
    blocks taking every row."""
    plan = fused_bpm_plan(n, m, item)
    wave = max(1, WAVE_THREADS // (plan.tx * plan.ty) // plan.gx)
    others = {"one wave": plan._replace(gy=min(plan.gy, wave))}
    if n * m <= 1 << 20:
        others["one row of blocks"] = plan._replace(gy=1)
    return {k: v for k, v in others.items() if v != plan}


def _with_plan(plan, w, dw, d, h):
    """The current kernel launched on ``plan`` instead of its own."""
    _bpm_lib()
    w_out, dw_out = torch.empty_like(w), torch.empty_like(dw)
    rc = _bpm_fns[w.dtype](
        w.data_ptr(), dw.data_ptr(), d.data_ptr(), h.data_ptr(),
        w_out.data_ptr(), dw_out.data_ptr(), w.shape[0], w.shape[1], LR,
        ALPHA, *plan, w.device.index, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"current kernel on {tuple(plan)}: launch failed "
                           f"({rc})")
    return w_out, dw_out


def _times(fn, first, sets):
    """(warm ms, cold ms) of one kernel: ``fn(w, dw, d, h)``."""
    warm = cs._device_ms(lambda: fn(*first))
    cold = cs._rotating_ms([lambda v=v: fn(*v) for v in sets])
    return warm, cold


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--previous", required=True, metavar="CU",
                    help="an earlier fused_bpm_update.cu (PR 3's interface)")
    ap.add_argument("--plans", action="store_true",
                    help="also time the current kernel on two other grids")
    ap.add_argument("--json", metavar="PATH", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.stderr.write("torch_compare_bpm: no CUDA device is visible\n")
        return 1
    runtime.pin_full_float32()
    card = cs.phase_device()
    current_src = os.path.join(build.CSRC, build.SOURCES["fused_bpm_update"])
    print(f"previous {args.previous} sha256 {_sha(args.previous)}")
    print(f"current {current_src} sha256 {_sha(current_src)}")
    prev = _build_previous(args.previous)
    build.build_all(["fused_bpm_update"])

    def previous(*v):
        return _previous(prev, *v)

    def current(*v):
        return fused_bpm_update(*v, LR, ALPHA)

    import numpy as np

    rng = np.random.default_rng(13)
    floor_ms = cs._device_ms(lambda: empty_launch("cuda"))
    cells = []
    for n, m in cs.BPM_SHAPES:
        arrays = cs._bpm_arrays(rng, n, m)
        for dname, dt in (("f64", torch.float64), ("f32", torch.float32)):
            item = 8 if dname == "f64" else 4
            first = tuple(cs._to_card(a, dt) for a in arrays)
            want = fused_bpm_update_plain(*first, LR, ALPHA)
            for tag, fn in (("previous", previous), ("current", current)):
                if not cs._bitwise(fn(*first), want):
                    raise SystemExit(f"{tag} kernel {n}x{m} {dname}: not "
                                     "bit-identical to the plain version")
            sets = cs._bpm_sets(first, n, m, item)
            order = (("previous", previous), ("current", current),
                     ("current", current), ("previous", previous))
            times = {"previous": [], "current": []}
            for tag, fn in order:
                times[tag].append(_times(fn, first, sets))
            plans = _other_plans(n, m, item) if args.plans else {}
            for tag, plan in plans.items():
                def fn(*v, plan=plan):
                    return _with_plan(plan, *v)
                if not cs._bitwise(fn(*first), want):
                    raise SystemExit(f"current kernel on {tag} {n}x{m} "
                                     f"{dname}: not bit-identical")
                times[tag] = [_times(fn, first, sets)]
            del sets, want
            bound = cs._bpm_bound_ms(n, m, item)
            cell = {"shape": f"{n}x{m}", "dtype": dname, "bound_ms": bound,
                    "floor_ms": floor_ms,
                    "plans": {"current": list(fused_bpm_plan(n, m, item)),
                              **{k: list(v) for k, v in plans.items()}},
                    **{f"{tag}_{kind}_ms": [t[k] for t in times[tag]]
                       for tag in times
                       for k, kind in enumerate(("warm", "cold"))}}
            cells.append(cell)
            print(f"{n}x{m} {dname}: bits equal (previous, current, plain); "
                  f"warm previous {cell['previous_warm_ms']} current "
                  f"{cell['current_warm_ms']}; cold previous "
                  f"{cell['previous_cold_ms']} current "
                  f"{cell['current_cold_ms']}; "
                  + "".join(f"{tag} {tuple(plans[tag])} warm "
                            f"{cell[f'{tag}_warm_ms']} cold "
                            f"{cell[f'{tag}_cold_ms']}; " for tag in plans)
                  + f"floor {floor_ms:.5f} bound {bound:.5f} ms", flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as fp:
            json.dump({"card": card, "previous": args.previous,
                       "previous_sha256": _sha(args.previous),
                       "current_sha256": _sha(current_src), "cells": cells},
                      fp, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
