"""The batched-tile training epoch on Hopper: ``train_tile``.

Source note (what the CUDA kernel is and why):

* **Replaces** the Pallas TPU kernel ``hpnn_tpu/ops/convergence_tile.py``
  ``_kernel_tile`` (body ``_group_loop``), launched by
  ``_tiled_epoch_pallas_impl`` for ``train_epoch_tiled(route="pallas")``.
  Its ``(start_group, group_budget)`` pair is what the host resume loop
  ``ops.convergence_tile.train_epoch_tiled`` splits an epoch with.
* **Computes** one epoch of batched-tile train-to-convergence: groups of
  ``tile`` samples, each trained in lockstep with per-lane liveness, one
  update per layer summed over the live lanes, momentum zeroed at group
  entry, each lane's stats frozen at its exit -- exactly
  :func:`ops.convergence_tile.train_epoch_tiled_plain`.  ANN, SNN and the
  native LNN, BP and BPM, float64, float32 and bfloat16 activations, and
  the weight storage modes None, "bf16" (float32/bfloat16 activations) and
  "f32" (float32/float64 activations).  Weights and momentum are updated in
  place on device; one float64 stats row per sample.
* **Bound on the H100**: per lockstep iteration with S live lanes the net
  does about 4SP + 2SP_hidden + 2P flops for BP (BPM about 3P more), half a
  microsecond at MNIST width, S = 32 and the float64 peak; the iterations
  are sequential, so the kernel is bound by the latency of its 2L+1 grid
  barriers per iteration and the L2 traffic of the lane products between
  them (PERF.md has the measurement).
* **Design**: one cooperative launch; hidden deltas and the forward split
  over warps by (row or column, lane chunk), the update one thread per
  weight; block 0 keeps the ascending list of live lanes and decides each
  iteration's stop tests.  Fixed summation orders and no atomics: tile=1
  equals ``train_epoch`` bit for bit, masked lanes are inert, and launches
  of a few groups equal one launch.  The header of ``csrc/train_tile.cu``
  has the details.

:func:`train_tile` takes its plain version only for tensors on the CPU; a
CUDA tensor launches the kernel or raises.  ``train_tile.launches`` counts
launches.
"""

from __future__ import annotations

import ctypes

import torch

from .convergence_tile import (INT32_MAX, _accum_dtype, _stats_init,
                               n_groups, resident_weights, resolve_hyper,
                               storage_wdtype, train_epoch_tiled_plain)
from .steps import ANN, LNN, SNN

MAX_LAYERS = 8  # csrc/train_tile.cu MAX_LAYERS
# (activation dtype, resident weight dtype, dtype of the add) -> entry point
# (csrc/train_tile.cu header)
_ENTRY = {(torch.float64, torch.float64, None): "hpnn_train_tile_f64",
          (torch.float64, torch.float32, torch.float64):
              "hpnn_train_tile_f64_w32",
          (torch.float32, torch.float32, None): "hpnn_train_tile_f32",
          (torch.float32, torch.bfloat16, torch.float32):
              "hpnn_train_tile_f32_wbf16",
          (torch.float32, torch.float32, torch.float64):
              "hpnn_train_tile_f32_w32",
          (torch.bfloat16, torch.float32, None): "hpnn_train_tile_bf16",
          (torch.bfloat16, torch.bfloat16, torch.float32):
              "hpnn_train_tile_bf16_wbf16"}
_KIND = {ANN: 0, SNN: 1, LNN: 2}
_fns: dict[str, object] = {}


def _kernel_fn(entry: str):
    fn = _fns.get(entry)
    if fn is None:
        from . import build

        lib = build.load("train_tile")
        lib.hpnn_train_tile_error_string.argtypes = [ctypes.c_int]
        lib.hpnn_train_tile_error_string.restype = ctypes.c_char_p
        fn = getattr(lib, entry)
        p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        fn.argtypes = [p, p, p, p, i, p, p, p, p, p, i, i, i, i, i, i, d, d,
                       d, i, i, i, i, i, p, p]
        fn.restype = ctypes.c_int
        fn.error_string = lib.hpnn_train_tile_error_string
        _fns[entry] = fn
    return fn


def _check(weights, xs, ts, kind, tile, storage, stats_prev):
    if not all(isinstance(v, torch.Tensor) for v in (*weights, xs, ts)):
        raise TypeError("train_tile takes torch tensors")
    if xs.dtype not in (torch.float64, torch.float32, torch.bfloat16) \
            or ts.dtype != xs.dtype:
        raise TypeError(f"train_tile: xs/ts must share one dtype of float64, "
                        f"float32 or bfloat16; got {xs.dtype}, {ts.dtype}")
    if any(not w.is_floating_point() for w in weights):
        raise TypeError("train_tile: weights must be floating point")
    storage_wdtype(xs.dtype, storage)  # raises on an unknown mode
    if kind not in _KIND:
        raise ValueError(f"train_tile: unknown kind {kind!r}")
    if int(tile) < 1:
        raise ValueError(f"train_tile: tile must be >= 1, got {tile}")
    if not 1 <= len(weights) <= MAX_LAYERS:
        raise ValueError(f"train_tile: 1 to {MAX_LAYERS} layers, got "
                         f"{len(weights)}")
    if xs.dim() != 2 or ts.dim() != 2 or xs.shape[0] != ts.shape[0]:
        raise ValueError(f"train_tile: need xs (S, n_in) and ts (S, n_out); "
                         f"got {tuple(xs.shape)}, {tuple(ts.shape)}")
    width = xs.shape[1]
    for w in weights:
        if w.dim() != 2 or w.shape[1] != width:
            raise ValueError("train_tile: layer shapes do not chain: "
                             f"{[tuple(v.shape) for v in weights]} from "
                             f"n_in={xs.shape[1]}")
        width = w.shape[0]
    if width != ts.shape[1]:
        raise ValueError(f"train_tile: last layer gives {width} outputs, ts "
                         f"has {ts.shape[1]}")
    if any(v.device != xs.device for v in (*weights, ts)):
        raise ValueError("train_tile: all tensors on one device")
    if not all(v.is_contiguous() for v in (*weights, xs, ts)):
        raise ValueError("train_tile: tensors must be contiguous")
    if stats_prev is not None and (
            stats_prev.shape != (xs.shape[0], 5)
            or stats_prev.dtype != torch.float64
            or stats_prev.device != xs.device):
        raise ValueError("train_tile: stats_prev must be (S, 5) float64 on "
                         "the tensors' device")
    big = max(xs.numel(), ts.numel(), *(w.numel() for w in weights),
              3 * int(tile) * (sum(w.shape[0] for w in weights) + 1))
    if big > INT32_MAX or int(tile) > INT32_MAX:
        raise ValueError("train_tile: sizes must fit in int32")


def train_tile(weights, xs, ts, kind: str, momentum: bool, alpha=0.2,
               delta=-1.0, lr=None, tile: int = 8, storage: str | None = None,
               max_iter=None, start_group=0, group_budget=INT32_MAX,
               stats_prev=None):
    """One launch of the batched-tile epoch kernel over groups
    start_group .. start_group + group_budget - 1; same contract as
    :func:`ops.convergence_tile.train_epoch_tiled_plain`.

    CPU tensors take the plain version; CUDA tensors launch the
    hand-written kernel on the current stream (no synchronisation) or
    raise.  The input weights are not modified."""
    _check(weights, xs, ts, kind, tile, storage, stats_prev)
    if xs.device.type == "cpu":
        return train_epoch_tiled_plain(
            weights, xs, ts, kind, momentum, alpha=alpha, delta=delta, lr=lr,
            tile=tile, storage=storage, max_iter=max_iter,
            start_group=start_group, group_budget=group_budget,
            stats_prev=stats_prev)
    if xs.device.type != "cuda":
        raise ValueError(f"train_tile: no kernel for device {xs.device}")
    add_dt = _accum_dtype(storage)
    key = (xs.dtype, storage_wdtype(xs.dtype, storage), add_dt)
    if key not in _ENTRY:
        raise ValueError(f"train_tile: no kernel for {xs.dtype} activations "
                         f"with storage {storage!r}")
    lr, delta, min_iter, max_iter = resolve_hyper(kind, momentum, lr, delta,
                                                  max_iter)
    tile = int(tile)
    w = resident_weights(weights, xs.dtype, storage)
    stats = _stats_init(stats_prev, xs.shape[0], xs.device)
    if start_group >= n_groups(xs.shape[0], tile) or group_budget <= 0:
        return w, stats
    dw = (tuple(torch.empty(v.shape, dtype=add_dt or v.dtype,
                            device=xs.device) for v in w)
          if momentum else w)
    # bfloat16 samples go to the kernel as float32 holding the same values
    xk, tk = ((xs.float(), ts.float()) if xs.dtype == torch.bfloat16
              else (xs, ts))
    n = [v.shape[0] for v in w]
    adt = xk.dtype
    scratch = torch.empty(3 * tile * sum(n) + tile * ts.shape[1] + 3 * tile,
                          dtype=adt, device=xs.device)
    lanes = torch.zeros(6 * tile + 1, dtype=torch.int32, device=xs.device)
    layers = len(w)
    ptrs = (ctypes.c_void_p * layers)(*(v.data_ptr() for v in w))
    dptrs = (ctypes.c_void_p * layers)(*(v.data_ptr() for v in dw))
    ns = (ctypes.c_int * layers)(*n)
    ms = (ctypes.c_int * layers)(*(v.shape[1] for v in w))
    grid = ctypes.c_int(0)
    fn = _kernel_fn(_ENTRY[key])
    rc = fn(ptrs, dptrs, ns, ms, layers, xk.data_ptr(), tk.data_ptr(),
            stats.data_ptr(), scratch.data_ptr(), lanes.data_ptr(),
            xs.shape[0], xs.shape[1], ts.shape[1], _KIND[kind],
            int(momentum), tile, float(lr), float(alpha), float(delta),
            min_iter, max_iter, int(start_group),
            int(min(group_budget, INT32_MAX)), xs.device.index,
            torch.cuda.current_stream(xs.device).cuda_stream,
            ctypes.byref(grid))
    if rc != 0:
        msg = fn.error_string(rc).decode()
        raise RuntimeError(f"train_tile launch failed: {msg} ({rc})")
    train_tile.launches += 1
    train_tile.grid = grid.value
    return w, stats


train_tile.launches = 0
train_tile.grid = 0
