"""Measured autotuner for the batched-tile epoch: the tile half of the JAX
package's ``ops/autotune.py``.

``decide_tile(shapes, dtype, kind, momentum, device)`` picks {tile size,
weight storage} for ``train_nn --tile auto``.  At the first use of a given
(card, topology, dtype, kind) the candidates -- tiles (8, 32, 128, 512) x
storage (None, "bf16") -- are timed on a small seeded synthetic corpus at a
bounded trajectory (every lane stops after ``_PROBE_MAX_ITER`` iterations,
so a cell measures the iteration rate, not convergence luck), and the
winner is cached as JSON, so a second run is a cache hit with no
measurement.  Keys lead with the device's name (``torch.cuda.
get_device_name`` or "cpu"), so a cache shared between a CPU host and a
card never mixes their decisions; a card's keys then name the tile
kernel's library (a digest of its source and build flags), so a decision
measured on another version of the kernel is measured again.  There is
one route per device: the ``train_tile`` kernel on CUDA ("kernel"), its
plain version on the CPU ("loop").

Knobs:

* ``HPNN_AUTOTUNE_CACHE=DIR`` -- cache location (default
  ``~/.cache/hpnn_tpu_torch``);
* ``HPNN_NO_AUTOTUNE=1`` -- never measure, never read the cache: the
  heuristic (tile 32, storage None);
* ``HPNN_AUTOTUNE=1`` -- measure on the CPU too (tests; by default only a
  CUDA device measures).

The JAX package's other half, the per-sample budgeted-vs-plain decision, is
not ported: the port's per-sample epoch is always one launch.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

_MEM_CACHE: dict = {}          # per-process memo over the JSON file
_DEFAULT_TILES = (8, 32, 128, 512)
_DEFAULT_TILE = 32             # heuristic when measurement is disabled
_PROBE_SAMPLES = 8
# the probe corpus holds >= 2 full groups of the largest candidate tile, or
# every tile above the sample count trains the same few live lanes and the
# measurement elects a small tile; each lane is capped at _PROBE_MAX_ITER
# iterations, so a cell measures the rate of the math
_PROBE_MAX_ITER = 64
_PROBE_MAX_SAMPLES = 4096


def _cuda(device) -> bool:
    return torch.device(device).type == "cuda"


def enabled(device="cuda") -> bool:
    """Measurement policy (see module docstring)."""
    if os.environ.get("HPNN_NO_AUTOTUNE"):
        return False
    if os.environ.get("HPNN_AUTOTUNE"):
        return True
    return _cuda(device)


def cache_dir() -> str:
    return os.environ.get("HPNN_AUTOTUNE_CACHE") or os.path.join(
        os.path.expanduser("~"), ".cache", "hpnn_tpu_torch")


def _cache_path() -> str:
    return os.path.join(cache_dir(), "autotune.json")


def _device_name(device) -> str:
    dev = torch.device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _kernel_id(device) -> str | None:
    """The tile kernel a decision on ``device`` is measured on: its
    library's name, ``train_tile-<digest of source and flags>``; None on
    the CPU, whose route is the plain loop."""
    if not _cuda(device):
        return None
    from . import build

    return os.path.splitext(os.path.basename(
        build.library_path("train_tile")))[0]


def _key(knob: str, shapes, kind: str, momentum: bool, dtype,
         device) -> str:
    topo = "x".join(f"{int(n)}.{int(m)}" for n, m in shapes)
    dt = str(dtype).replace("torch.", "")
    kernel = _kernel_id(device)
    return (f"{_device_name(device)}|{kernel + '|' if kernel else ''}"
            f"{knob}|{kind}|{'BPM' if momentum else 'BP'}|{dt}|{topo}")


def _load() -> dict:
    try:
        with open(_cache_path()) as fp:
            return json.load(fp)
    except (OSError, ValueError):
        return {}


def _store(key: str, entry: dict) -> None:
    """Merge one decision into the JSON cache (atomic replace; racing
    processes re-measure at worst, they never corrupt the file)."""
    from ..io.atomic import atomic_write_bytes

    try:
        os.makedirs(cache_dir(), exist_ok=True)
        data = _load()
        data[key] = entry
        atomic_write_bytes(_cache_path(),
                           (json.dumps(data, indent=1) + "\n").encode())
    except OSError as exc:  # the cache is an optimization, never fatal
        from ..utils.nn_log import nn_warn

        nn_warn(f"autotune cache not writable ({exc}); decision will be "
                "re-measured next run\n")


def _lookup(key: str):
    if key in _MEM_CACHE:
        return _MEM_CACHE[key]
    entry = _load().get(key)
    if entry is not None:
        _MEM_CACHE[key] = entry
    return entry


def clear_memo() -> None:
    """Drop the in-process memo (tests simulate a fresh process)."""
    _MEM_CACHE.clear()


def _probe_problem(shapes, dtype, device, n=_PROBE_SAMPLES):
    """A small synthetic corpus shaped like the topology (seeded: every
    candidate measures the identical workload)."""
    n_in, n_out = int(shapes[0][1]), int(shapes[-1][0])
    rng = np.random.default_rng(20260803)
    wdt = torch.float32 if dtype == torch.bfloat16 else dtype

    def put(a, dt):
        return torch.as_tensor(a, dtype=torch.float64).to(device).to(dt)

    weights = tuple(put(rng.uniform(-0.1, 0.1, (int(r), int(m))), wdt)
                    for r, m in shapes)
    xs = put(rng.uniform(0, 1, (n, n_in)), dtype)
    ts = -np.ones((n, n_out))
    ts[np.arange(n), rng.integers(0, n_out, n)] = 1.0
    return weights, xs, put(ts, dtype)


def _time_epoch(fn, weights, xs, ts, kind, momentum) -> float:
    """Lane-iterations per second of one epoch after one warm-up epoch;
    CUDA events on the card, the host clock on the CPU."""
    fn(weights, xs, ts, kind, momentum)
    if xs.device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        _, st = fn(weights, xs, ts, kind, momentum)
        end.record()
        end.synchronize()
        dt = start.elapsed_time(end) / 1e3
    else:
        t0 = time.perf_counter()
        _, st = fn(weights, xs, ts, kind, momentum)
        dt = time.perf_counter() - t0
    return float(st.n_iter.to(torch.int64).sum()) / max(dt, 1e-9)


def decide_tile(shapes, dtype, kind: str, momentum: bool, device="cuda",
                tiles=None, storages=(None, "bf16")) -> dict:
    """Pick {tile, storage} for the batched-tile epoch on this (device,
    topology, dtype).  Returns::

        {"tile": int, "route": "kernel"|"loop", "storage": None|"bf16",
         "source": "heuristic"|"cache"|"measured",
         "cells": {label: lane_iterations_per_s, ...}}   # measured only

    The winner maximizes the measured lane-iterations per second on the
    probe corpus.  With measurement off the heuristic comes back (tile 32,
    storage None)."""
    route = "kernel" if _cuda(device) else "loop"
    if not enabled(device):
        return {"tile": _DEFAULT_TILE, "route": route, "storage": None,
                "source": "heuristic"}
    key = _key("tile", shapes, kind, momentum, dtype, device)
    entry = _lookup(key)
    if entry is not None:
        return {**entry, "source": "cache"}
    entry = _measure_tile(shapes, dtype, kind, momentum, device,
                          tiles or _DEFAULT_TILES, storages, route)
    _MEM_CACHE[key] = entry
    _store(key, entry)
    return {**entry, "source": "measured"}


def _measure_tile(shapes, dtype, kind, momentum, device, tiles, storages,
                  route):
    import functools

    from .convergence_tile import train_epoch_tiled

    n = min(max(2 * max(tiles), _PROBE_SAMPLES), _PROBE_MAX_SAMPLES)
    weights, xs, ts = _probe_problem(shapes, dtype, device, n)
    cells = {}
    best = (-1.0, _DEFAULT_TILE, None)
    for tile in tiles:
        for storage in storages:
            if storage == "bf16" and dtype == torch.float64:
                continue  # bf16 storage under the f64 parity dtype
            fn = functools.partial(train_epoch_tiled, tile=int(tile),
                                   storage=storage,
                                   max_iter=_PROBE_MAX_ITER)
            rate = _time_epoch(fn, weights, xs, ts, kind, momentum)
            cells[f"tile{tile}-{storage or 'native'}-{route}"] = round(rate,
                                                                       1)
            best = max(best, (rate, int(tile), storage),
                       key=lambda b: b[0])
    _, tile, storage = best
    return {"tile": tile, "route": route, "storage": storage,
            "cells": cells}


def describe_tile(shapes, dtype, kind: str, momentum: bool,
                  device="cuda") -> dict:
    """The cached {tile, route, storage} decision WITHOUT triggering a
    measurement (for reports that must not perturb the routing)."""
    if not enabled(device):
        return {"source": "off" if os.environ.get("HPNN_NO_AUTOTUNE")
                else "heuristic",
                "tile": _DEFAULT_TILE, "storage": None}
    entry = _lookup(_key("tile", shapes, kind, momentum, dtype, device))
    if entry is None:
        return {"source": "unmeasured"}
    return {"source": "cache",
            **{k: entry[k] for k in ("tile", "route", "storage")}}
