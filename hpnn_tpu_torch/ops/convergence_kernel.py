"""The per-sample training epoch on Hopper: ``train_epoch_kernel`` and the
host resume loop ``train_epoch_cuda`` around it.

Source note (what the CUDA kernel is and why):

* **Replaces** the Pallas TPU kernel ``hpnn_tpu/ops/convergence_pallas.py``
  ``_train_one``, as both of its callers ran it: ``_kernel_plain`` (one
  launch per epoch) and the iteration-budgeted ``_kernel``, whose
  ``(start_idx, iter_budget)`` control pair and copied-through stats rows
  are two arguments of this one kernel here.
* **Computes** one epoch of per-sample train-to-convergence in sample
  order, BP or BPM, for ANN, SNN and the native LNN, at float64, float32
  and bfloat16 (float32 master weights), exactly the loop of
  :func:`ops.convergence.train_sample`.  Weights and the BPM momentum are
  written in place on device; one float64 stats row per sample.
* **Bound on the H100**: the iteration is one sample wide and depends on
  the previous one, so the flops per iteration (about 9P for BP, 11P for
  BPM, P the weight count) take a few hundredths of a microsecond at peak;
  the kernel is bound by latency instead: its grid barriers (about 1.1 us
  each), the L2 round trips between them and the head's serial folds
  (PERF.md has the phase split).
* **Design**: one cooperative launch, rows split over warps, the update
  fused into the forward, fixed summation orders and no atomics (so every
  bit repeats and budgeted launches equal one launch bit for bit).  2L - 2
  grid barriers an iteration (L >= 2 layers): the delta of layer 0 is
  formed by the warp that owns its row of W_0, and every block computes
  the head and the stop test itself, so no block waits for another's
  decision.  In the resident plan each warp's rows of W_0 (and of dw_0
  under BPM) stay in its block's shared memory for the whole launch, W_0
  written back at the end; the layers l >= 1 stay in device memory, since
  other SMs read their columns.  Where W_0's rows do not fit, the staged
  plan reads them through L2 too, and wider still is refused.  Where a
  layer has more rows than the card holds warps at once, each warp takes
  several.  The plan is chosen by shape; ``_plan`` forces it.  The header of
  ``csrc/train_epoch.cu`` has the details.

:func:`train_epoch_kernel` takes its plain version
(:func:`train_epoch_plain`, the eager loop of ``ops.convergence`` with the
same budget contract) only for tensors on the CPU; a CUDA tensor launches
the kernel or raises.  ``train_epoch_kernel.launches`` counts launches.
"""

from __future__ import annotations

import ctypes

import torch

from .convergence import (master_weights, schedule, stats_record,
                          train_sample)
from .steps import ANN, LNN, SNN

INT32_MAX = 2**31 - 1
MAX_LAYERS = 8  # csrc/train_epoch.cu MAX_LAYERS
_ENTRY = {torch.float64: "hpnn_train_epoch_plan_f64",
          torch.float32: "hpnn_train_epoch_plan_f32",
          torch.bfloat16: "hpnn_train_epoch_plan_bf16"}
_KIND = {ANN: 0, SNN: 1, LNN: 2}
_fns: dict[torch.dtype, object] = {}


def _kernel_fn(dtype: torch.dtype):
    fn = _fns.get(dtype)
    if fn is None:
        from . import build

        lib = build.load("train_epoch")
        lib.hpnn_train_error_string.argtypes = [ctypes.c_int]
        lib.hpnn_train_error_string.restype = ctypes.c_char_p
        fn = getattr(lib, _ENTRY[dtype])
        p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        fn.argtypes = [p, p, p, p, i, p, p, p, p, i, i, i, i, i, d, d, d,
                       i, i, i, i, i, p, i, p, p]
        fn.restype = ctypes.c_int
        fn.error_string = lib.hpnn_train_error_string
        _fns[dtype] = fn
    return fn


def _check(weights, xs, ts, kind, stats_prev):
    if not all(isinstance(v, torch.Tensor) for v in (*weights, xs, ts)):
        raise TypeError("train_epoch_kernel takes torch tensors")
    if xs.dtype not in _ENTRY or ts.dtype != xs.dtype:
        raise TypeError(f"train_epoch_kernel: xs/ts must share one dtype of "
                        f"float64, float32 or bfloat16; got {xs.dtype}, "
                        f"{ts.dtype}")
    wdt = torch.float32 if xs.dtype == torch.bfloat16 else xs.dtype
    if any(w.dtype not in (xs.dtype, wdt) for w in weights):
        raise TypeError(f"train_epoch_kernel: weights must be {xs.dtype}"
                        + (" or float32 masters" if wdt != xs.dtype else ""))
    if kind not in _KIND:
        raise ValueError(f"train_epoch_kernel: unknown kind {kind!r}")
    if not 1 <= len(weights) <= MAX_LAYERS:
        raise ValueError(f"train_epoch_kernel: 1 to {MAX_LAYERS} layers, "
                         f"got {len(weights)}")
    if xs.dim() != 2 or ts.dim() != 2 or xs.shape[0] != ts.shape[0]:
        raise ValueError(f"train_epoch_kernel: need xs (S, n_in) and ts "
                         f"(S, n_out); got {tuple(xs.shape)}, "
                         f"{tuple(ts.shape)}")
    width = xs.shape[1]
    for w in weights:
        if w.dim() != 2 or w.shape[1] != width:
            raise ValueError("train_epoch_kernel: layer shapes do not chain: "
                             f"{[tuple(v.shape) for v in weights]} from "
                             f"n_in={xs.shape[1]}")
        width = w.shape[0]
    if width != ts.shape[1]:
        raise ValueError(f"train_epoch_kernel: last layer gives {width} "
                         f"outputs, ts has {ts.shape[1]}")
    if any(v.device != xs.device for v in (*weights, ts)):
        raise ValueError("train_epoch_kernel: all tensors on one device")
    if not all(v.is_contiguous() for v in (*weights, xs, ts)):
        raise ValueError("train_epoch_kernel: tensors must be contiguous")
    if stats_prev is not None and (
            stats_prev.shape != (xs.shape[0], 5)
            or stats_prev.dtype != torch.float64
            or stats_prev.device != xs.device):
        raise ValueError("train_epoch_kernel: stats_prev must be (S, 5) "
                         "float64 on the tensors' device")
    if max(xs.numel(), ts.numel(), *(w.numel() for w in weights)) \
            > INT32_MAX:
        raise ValueError("train_epoch_kernel: sizes must fit in int32")


def _stats_init(stats_prev, s: int, device) -> torch.Tensor:
    """The record the launch starts from: the previous launch's rows, or
    all rows untrained (n_iter = -1)."""
    if stats_prev is not None:
        return stats_prev.clone()
    st = torch.zeros((s, 5), dtype=torch.float64, device=device)
    st[:, 2] = -1.0
    return st


@torch.inference_mode()
def train_epoch_plain(weights, xs, ts, kind: str, momentum: bool,
                      alpha=0.2, delta=-1.0, lr=None, start_idx=0,
                      iter_budget=INT32_MAX, stats_prev=None):
    """The kernel's plain version, on any device: the eager per-sample loop
    of ``ops.convergence`` over samples start_idx.., stopping before a new
    sample once ``iter_budget`` iterations were spent (the first sample
    always runs).  Returns (weights, stats (S, 5) float64: init_err,
    first_ok, n_iter, final_dep, success; untrained rows as given)."""
    w = master_weights(weights, xs.dtype)
    stats = _stats_init(stats_prev, xs.shape[0], xs.device)
    used = 0
    for s in range(start_idx, xs.shape[0]):
        if s > start_idx and used >= iter_budget:
            break
        w, row = train_sample(w, xs[s], ts[s], kind, momentum, lr=lr,
                              alpha=alpha, delta=delta)
        stats[s] = torch.tensor([float(v) for v in row], dtype=torch.float64)
        used += row[2]
    return w, stats


def train_epoch_kernel(weights, xs, ts, kind: str, momentum: bool,
                       alpha=0.2, delta=-1.0, lr=None, start_idx=0,
                       iter_budget=INT32_MAX, stats_prev=None, _plan=None):
    """One launch of the epoch kernel from sample ``start_idx`` under an
    iteration budget; same contract as :func:`train_epoch_plain`.

    CPU tensors take the plain version; CUDA tensors launch the
    hand-written kernel on the current stream (no synchronisation) or
    raise.  The input weights are not modified.  ``_plan`` (0: W_0 in
    device memory, 1: resident in shared memory) forces the launch plan the
    kernel otherwise picks by shape, so the card checks can hold one plan
    against the other; the plan launched is left in
    ``train_epoch_kernel.plan``, and in ``train_epoch_kernel.syncs`` an
    int64 tensor on the card that the launch fills with the grid barriers
    its kernel took inside its iterations, all the grid barriers it took,
    and its iterations.  Widths whose staged vectors do not fit in a
    block's shared memory raise ValueError."""
    _check(weights, xs, ts, kind, stats_prev)
    if xs.device.type == "cpu":
        return train_epoch_plain(weights, xs, ts, kind, momentum,
                                 alpha=alpha, delta=delta, lr=lr,
                                 start_idx=start_idx,
                                 iter_budget=iter_budget,
                                 stats_prev=stats_prev)
    if xs.device.type != "cuda":
        raise ValueError(f"train_epoch_kernel: no kernel for device "
                         f"{xs.device}")
    lr, min_iter, max_iter, delta = schedule(kind, momentum, lr, delta)
    w = master_weights(weights, xs.dtype)
    stats = _stats_init(stats_prev, xs.shape[0], xs.device)
    if start_idx >= xs.shape[0]:
        return w, stats
    dw = tuple(torch.zeros_like(v) for v in w) if momentum else w
    # bfloat16 samples go to the kernel as float32 holding the same values
    xk, tk = ((xs.float(), ts.float()) if xs.dtype == torch.bfloat16
              else (xs, ts))
    n = [v.shape[0] for v in w]
    scratch = torch.empty(3 * sum(n), dtype=w[0].dtype, device=xs.device)
    layers = len(w)
    ptrs = (ctypes.c_void_p * layers)(*(v.data_ptr() for v in w))
    dptrs = (ctypes.c_void_p * layers)(*(v.data_ptr() for v in dw))
    ns = (ctypes.c_int * layers)(*n)
    ms = (ctypes.c_int * layers)(*(v.shape[1] for v in w))
    plan = (ctypes.c_int * 5)()
    syncs = torch.zeros(3, dtype=torch.int64, device=xs.device)
    fn = _kernel_fn(xs.dtype)
    rc = fn(ptrs, dptrs, ns, ms, layers, xk.data_ptr(), tk.data_ptr(),
            stats.data_ptr(), scratch.data_ptr(),
            xs.shape[0], xs.shape[1], ts.shape[1], _KIND[kind],
            int(momentum), float(lr), float(alpha), float(delta), min_iter,
            max_iter, int(start_idx), int(iter_budget), xs.device.index,
            torch.cuda.current_stream(xs.device).cuda_stream,
            -1 if _plan is None else int(_plan), plan, syncs.data_ptr())
    if rc != 0 and plan[1] == -1:
        raise ValueError(f"train_epoch_kernel: layer widths {n} from "
                         f"n_in={xs.shape[1]} need {plan[2]} bytes of shared "
                         "memory a block, more than the card has")
    if rc != 0:
        msg = fn.error_string(rc).decode()
        raise RuntimeError(f"train_epoch_kernel launch failed: {msg} ({rc})")
    train_epoch_kernel.launches += 1
    train_epoch_kernel.syncs = syncs
    train_epoch_kernel.plan = {"blocks": plan[0], "warps": plan[4],
                               "resident": bool(plan[1]),
                               "smem_bytes": plan[2], "rows0": plan[3]}
    return w, stats


train_epoch_kernel.launches = 0
train_epoch_kernel.plan = {}
train_epoch_kernel.syncs = None


def train_epoch_cuda(weights, xs, ts, kind: str, momentum: bool, alpha=0.2,
                     delta=-1.0, lr=None, iter_budget=INT32_MAX,
                     defer_stats=False):
    """The epoch on the card: launches of :func:`train_epoch_kernel`
    resumed from the first untrained sample until every row has
    n_iter >= 0 (one launch at the default budget).  Call-compatible with
    ``ops.convergence.train_epoch``; returns (weights, SampleStats).

    ``defer_stats`` returns the (S, 5) float64 record on the card instead
    of SampleStats.  When one launch is sure to train every sample (the
    budget exceeds what S - 1 samples can spend), it is that one launch,
    with no host synchronisation, so the caller can queue the next epoch
    before reading this one's stats."""
    s = xs.shape[0]
    if defer_stats:
        max_iter = schedule(kind, momentum, lr, delta)[2]
        if (s - 1) * (max_iter + 1) < iter_budget:
            return train_epoch_kernel(weights, xs, ts, kind, momentum,
                                      alpha=alpha, delta=delta, lr=lr,
                                      iter_budget=iter_budget)
    w, st, start = weights, None, 0
    while start < s or st is None:
        w, st = train_epoch_kernel(w, xs, ts, kind, momentum, alpha=alpha,
                                   delta=delta, lr=lr, start_idx=start,
                                   iter_budget=iter_budget, stats_prev=st)
        trained = int(torch.count_nonzero(st[:, 2] >= 0.0))
        if trained <= start and start < s:
            raise RuntimeError("train_epoch_cuda: a launch trained nothing")
        start = trained
    return w, st if defer_stats else stats_record(st, xs.dtype)
