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
  microsecond at MNIST width, S = 32 and the float64 peak; the iterations,
  and the layers within one, are sequential, so the kernel is bound by its
  grid barriers (about 1.2 us each), the L2 round trips after them, and in
  the layer-0 phase by the SM's shared-memory bandwidth and FP64 pipe
  (each block reads every live lane's input twice an iteration).  PERF.md
  has the measurements and the phase split.
* **Design** (``train_epoch``'s carried to a lane axis): one cooperative
  launch of one block an SM, row i of layer l owned by block i mod blocks;
  2L - 2 grid barriers a lockstep iteration (L >= 2 layers): the update is
  fused into the row owner's forward, layer 0's delta is formed by the
  owner of its row of W_0 from W_1's column, and every block computes the
  head, the stop tests and the next live list itself.  The plan
  (:func:`tile_plan`, a pure function of the shapes, the types and the
  card's limits, passed to the kernel) keeps the lane state, W_0's rows
  and the group's inputs and targets in shared memory where they fit, the
  rest in a device workspace or in place; refused (ValueError) only where
  not even one lane's input fits.  Fixed summation orders and no atomics:
  the bits equal the first kernel's, tile=1 equals ``train_epoch``, masked
  lanes are inert, launches of a few groups equal one launch, and every
  plan gives the same bits.  ``_plan`` forces
  parts of the plan.  The header of ``csrc/train_tile.cu`` has the
  details.

:func:`train_tile` takes its plain version only for tensors on the CPU; a
CUDA tensor launches the kernel or raises.  ``train_tile.launches`` counts
launches, ``train_tile.plan`` is the plan launched and ``train_tile.syncs``
the kernel's own count of its grid barriers.
"""

from __future__ import annotations

import ctypes
from collections import namedtuple

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
_limits_cache: dict[int, tuple[int, int]] = {}

# --- the launch plan ----------------------------------------------------------
# The kernel's data regions (csrc/train_tile.cu ``Region``), in the order of
# the plan's (on chip, offset) pairs.
REGIONS = ("state_at", "state_int", "dd", "own", "col", "ho", "hdl", "t", "w0",
           "x", "dw0")
# the block's scratch: the lane state, the rows' deltas, the block's a_0 and
# W_1's columns of its rows of W_0; in shared memory together, or together
# in the block's workspace slice where they and one lane's input do not fit
SCRATCH = ("state_at", "state_int", "dd", "own", "col")
MAX_THREADS = 256  # csrc/train_tile.cu MAX_THREADS: warps a block <= 8
STATIC_SMEM = 64   # the kernel's static shared memory, rounded up
H100 = (132, 232_448)  # SMs, shared bytes a block can opt in to
_FORCE = ("scratch", "resident", "head", "x_lanes")

Plan = namedtuple("Plan", "blocks warps lanes x_lanes rows rp smem_bytes "
                          "ws_bytes on_chip offsets refused")
Plan.__doc__ = """A launch plan of :func:`train_tile`: ``blocks`` blocks of
``warps`` warps (row i of layer l belongs to block i mod blocks, so a block
owns up to ``rows[l]`` rows of layer l); ``lanes`` lane slots (min(tile,
samples)); ``x_lanes`` lanes of the group's inputs in shared memory
(== lanes: staged once a group; fewer: staged in chunks for each forward);
``rp`` the row pitch of a lane's deltas (the most rows a block owns in any
layer, rounded up to 4); ``smem_bytes`` of dynamic shared memory and
``ws_bytes`` of device workspace a block; per region of ``REGIONS`` whether
it is on chip and its byte offset there or in the workspace (the targets
and W_0's and dw_0's rows off chip are read in place).  ``refused``: one
lane's input needs ``smem_bytes``, more than a block has."""


def _align(nbytes: int) -> int:
    return -(-int(nbytes) // 16) * 16


def tile_plan(shapes, samples: int, tile: int, act_bytes: int,
              weight_bytes: int, add_bytes: int, momentum: bool,
              sms: int = H100[0], smem: int = H100[1], force=None) -> Plan:
    """The launch plan of the tile kernel for layers ``shapes`` ((n, m)
    each) on a card of ``sms`` SMs and ``smem`` shared bytes a block: a pure
    function of the shapes, the types' sizes and the card's limits.

    * One block an SM, at most one a row of the widest layer; 8 warps.
    * Shared memory, in order while it fits beside one lane's input: the
      block's scratch (``SCRATCH``: all of it, else none); the head's
      outputs and output deltas; the group's targets; W_0's rows of the
      block (the resident plan); the group's inputs (all lanes, else as
      many lanes as fit, at least one); dw_0's rows under BPM.  The
      scratch and the head's vectors that are not on chip go to the
      block's workspace slice; the targets and W_0's and dw_0's rows stay
      in place.
    * Refused only when one lane's input does not fit.

    ``force`` (a dict of ``_FORCE`` keys) overrides a choice (``scratch``
    can only take the scratch off chip): the card checks hold one plan
    against another with it."""
    force = dict(force or {})
    unknown = set(force) - set(_FORCE)
    if unknown:
        raise ValueError(f"tile_plan: unknown plan keys {sorted(unknown)}")
    n = [int(r) for r, _ in shapes]
    n_in, n_out, layers = int(shapes[0][1]), n[-1], len(n)
    lanes = max(1, min(int(tile), int(samples)))
    blocks = min(int(sms), max(n))
    warps = MAX_THREADS // 32
    rows = tuple(-(-r // blocks) for r in n)
    r0, rp = rows[0], -(-max(rows) // 4) * 4
    n1 = n[1] if layers >= 2 else 0
    at = int(act_bytes)
    budget = int(smem) - STATIC_SMEM
    size = {"state_at": 5 * lanes * at, "state_int": (8 * lanes + 1) * 4,
            "dd": lanes * rp * at,
            "own": r0 * lanes * at if layers >= 2 else 0,
            "col": r0 * n1 * at, "ho": lanes * n_out * at,
            "hdl": lanes * n_out * at, "t": lanes * n_out * at,
            "w0": r0 * n_in * int(weight_bytes), "x": 0,
            "dw0": r0 * n_in * int(add_bytes) if momentum else 0}
    one = _align(n_in * at)   # one lane's input
    chip = dict.fromkeys(REGIONS, False)
    chip["x"] = True
    if one > budget:
        return Plan(blocks, warps, lanes, 0, rows, rp, one, 0,
                    tuple(chip[k] for k in REGIONS), (0,) * len(REGIONS),
                    True)
    scratch = sum(_align(size[k]) for k in SCRATCH)
    on = scratch + one <= budget and bool(force.get("scratch", True))
    chip.update(dict.fromkeys(SCRATCH, on))
    used = scratch if on else 0
    for name, key in (("ho", "head"), ("hdl", "head"), ("t", "head"),
                      ("w0", "resident")):
        fits = used + _align(size[name]) + one <= budget
        chip[name] = bool(force.get(key, fits))
        if chip[name]:
            used += _align(size[name])
    x_lanes = int(force.get("x_lanes", (budget - used) // (n_in * at)))
    x_lanes = max(1, min(lanes, x_lanes))
    while x_lanes > 1 and used + _align(x_lanes * n_in * at) > budget:
        x_lanes -= 1
    size["x"] = x_lanes * n_in * at
    used += _align(size["x"])
    chip["dw0"] = bool(momentum) and used + _align(size["dw0"]) <= budget
    used += _align(size["dw0"]) if chip["dw0"] else 0
    offsets, at_chip, at_ws = [], 0, 0
    for name in REGIONS:
        if chip[name]:
            offsets.append(at_chip)
            at_chip += _align(size[name])
        elif name in (*SCRATCH, "ho", "hdl"):
            offsets.append(at_ws)
            at_ws += _align(size[name])
        else:
            offsets.append(0)
    return Plan(blocks, warps, lanes, x_lanes, rows, rp, at_chip, at_ws,
                tuple(chip[k] for k in REGIONS), tuple(offsets), False)


def _plan_array(plan: Plan):
    vals = [plan.blocks, plan.warps, plan.lanes, plan.x_lanes, plan.rp,
            plan.smem_bytes, plan.ws_bytes]
    for chip, off in zip(plan.on_chip, plan.offsets):
        vals += [int(chip), off]
    return (ctypes.c_longlong * len(vals))(*vals)


def _kernel_fn(entry: str):
    fn = _fns.get(entry)
    if fn is None:
        lib = _library()
        fn = getattr(lib, entry)
        p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        fn.argtypes = [p, p, p, p, i, p, p, p, p, p, p, i, i, i, i, i, i, d,
                       d, d, i, i, i, i, p, i, p, p]
        fn.restype = ctypes.c_int
        fn.error_string = lib.hpnn_train_tile_error_string
        _fns[entry] = fn
    return fn


def _library():
    from . import build

    lib = build.load("train_tile")
    lib.hpnn_train_tile_error_string.argtypes = [ctypes.c_int]
    lib.hpnn_train_tile_error_string.restype = ctypes.c_char_p
    lib.hpnn_train_tile_limits.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.hpnn_train_tile_limits.restype = ctypes.c_int
    return lib


def card_limits(device: int) -> tuple[int, int]:
    """(SMs, shared bytes a block can opt in to) of CUDA device ``device``."""
    lim = _limits_cache.get(device)
    if lim is None:
        out = (ctypes.c_int * 3)()
        rc = _library().hpnn_train_tile_limits(device, out)
        if rc != 0 or not out[2]:
            raise RuntimeError(f"train_tile: device {device} gives no "
                               f"cooperative launch (rc {rc})")
        lim = _limits_cache[device] = (out[0], out[1])
    return lim


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


def launch_plan(weights, xs, tile: int, storage, momentum: bool, limits,
                force=None) -> Plan:
    """The plan :func:`train_tile` launches for these tensors on a card of
    ``limits`` (SMs, shared bytes a block); ValueError when one lane's
    input needs more shared memory a block than the card has."""
    wdt = storage_wdtype(xs.dtype, storage)
    add_dt = _accum_dtype(storage)
    # bfloat16 samples go to the kernel as float32 holding the same values
    adt = torch.float32 if xs.dtype == torch.bfloat16 else xs.dtype
    shapes = [tuple(v.shape) for v in weights]
    plan = tile_plan(shapes, xs.shape[0], int(tile), adt.itemsize,
                     wdt.itemsize, (add_dt or wdt).itemsize, momentum,
                     *limits, force=force)
    if plan.refused:
        raise ValueError(f"train_tile: one lane's input of n_in="
                         f"{xs.shape[1]} needs {plan.smem_bytes} bytes of "
                         "shared memory a block, more than the card has")
    return plan


def train_tile(weights, xs, ts, kind: str, momentum: bool, alpha=0.2,
               delta=-1.0, lr=None, tile: int = 8, storage: str | None = None,
               max_iter=None, start_group=0, group_budget=INT32_MAX,
               stats_prev=None, _plan=None):
    """One launch of the batched-tile epoch kernel over groups
    start_group .. start_group + group_budget - 1; same contract as
    :func:`ops.convergence_tile.train_epoch_tiled_plain`.

    CPU tensors take the plain version; CUDA tensors launch the
    hand-written kernel on the current stream (no synchronisation) or
    raise.  The input weights are not modified.  ``_plan`` (a dict of
    :func:`tile_plan`'s ``force`` keys) forces parts of the launch plan the
    wrapper otherwise picks by shape, so the card checks can hold one plan
    against another; the plan launched is left in ``train_tile.plan``, and
    in ``train_tile.syncs`` an int64 tensor on the card that the launch
    fills with the grid barriers its kernel took inside lockstep
    iterations, all the grid barriers it took, and its lockstep
    iterations.  An input layer so wide that one lane's input does not fit
    in a block's shared memory raises ValueError."""
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
    wdt = storage_wdtype(xs.dtype, storage)
    key = (xs.dtype, wdt, add_dt)
    if key not in _ENTRY:
        raise ValueError(f"train_tile: no kernel for {xs.dtype} activations "
                         f"with storage {storage!r}")
    lr, delta, min_iter, max_iter = resolve_hyper(kind, momentum, lr, delta,
                                                  max_iter)
    tile = int(tile)
    plan = launch_plan(weights, xs, tile, storage, momentum,
                       card_limits(xs.device.index), _plan)
    adt = torch.float32 if xs.dtype == torch.bfloat16 else xs.dtype
    w = resident_weights(weights, xs.dtype, storage)
    stats = _stats_init(stats_prev, xs.shape[0], xs.device)
    if start_group >= n_groups(xs.shape[0], tile) or group_budget <= 0:
        return w, stats
    dw = (tuple(torch.empty(v.shape, dtype=add_dt or v.dtype,
                            device=xs.device) for v in w)
          if momentum else w)
    xk, tk = ((xs.float(), ts.float()) if xs.dtype == torch.bfloat16
              else (xs, ts))
    n = [v.shape[0] for v in w]
    scratch = torch.empty(3 * plan.lanes * sum(n), dtype=adt,
                          device=xs.device)
    ws = torch.empty(max(1, plan.blocks * plan.ws_bytes), dtype=torch.uint8,
                     device=xs.device)
    syncs = torch.zeros(3, dtype=torch.int64, device=xs.device)
    layers = len(w)
    ptrs = (ctypes.c_void_p * layers)(*(v.data_ptr() for v in w))
    dptrs = (ctypes.c_void_p * layers)(*(v.data_ptr() for v in dw))
    ns = (ctypes.c_int * layers)(*n)
    ms = (ctypes.c_int * layers)(*(v.shape[1] for v in w))
    out = (ctypes.c_int * 1)()
    fn = _kernel_fn(_ENTRY[key])
    rc = fn(ptrs, dptrs, ns, ms, layers, xk.data_ptr(), tk.data_ptr(),
            stats.data_ptr(), scratch.data_ptr(), ws.data_ptr(),
            syncs.data_ptr(), xs.shape[0], xs.shape[1], ts.shape[1],
            _KIND[kind], int(momentum), tile, float(lr), float(alpha),
            float(delta), min_iter, max_iter, int(start_group),
            int(min(group_budget, INT32_MAX)), _plan_array(plan),
            xs.device.index, torch.cuda.current_stream(xs.device).cuda_stream,
            out)
    if rc != 0:
        msg = fn.error_string(rc).decode()
        raise RuntimeError(f"train_tile launch failed: {msg} ({rc}); plan "
                           f"{plan}, {out[0]} block(s) an SM fit")
    train_tile.launches += 1
    train_tile.syncs = syncs
    chip = dict(zip(REGIONS, plan.on_chip))
    train_tile.plan = {"blocks": plan.blocks, "warps": plan.warps,
                       "scratch_on_chip": chip["dd"], "resident": chip["w0"], "head_on_chip": chip["ho"],
                       "x_lanes": plan.x_lanes, "lanes": plan.lanes,
                       "rows0": plan.rows[0], "smem_bytes": plan.smem_bytes,
                       "ws_bytes": plan.ws_bytes, "blocks_per_sm": out[0]}
    return w, stats


train_tile.launches = 0
train_tile.plan = {}
train_tile.syncs = None
