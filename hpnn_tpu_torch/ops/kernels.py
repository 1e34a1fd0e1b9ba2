"""The fused layer forward on Hopper: ``fused_linear_act`` and the
whole-net ``batched_forward_fused`` built from it.

Source note (what the CUDA kernel is and why):

* **Replaces** the Pallas TPU kernel ``hpnn_tpu/ops/pallas_kernels.py``
  ``fused_linear_act`` (body ``_fused_linear_act_kernel``), which
  ``batched_forward_pallas`` composes per layer for run_nn and serving.
* **Computes** ``act(xs @ W.T)`` for W (N, M) and xs (B, M), both
  contiguous along M: float32 and bfloat16 accumulate in float32, float64
  in float64, the activation is applied once in the epilogue and the
  output is written once in the operand dtype.
* **Bound on the H100**: at the slice's shapes (784->300, 300->10,
  851->230, 230->230) the operands are at most a few MB.  By the roofline,
  B >= 64 at float32 and float64 is bound by the FMA rate (784->300 at
  B=4096: 1.93 GFLOP, 29 us at 67 TFLOP/s), smaller batches and bfloat16
  (against the tensor-core peak) by the bytes.  Measured, the kernel is
  bound by memory latency instead: few blocks at small B, each walking
  its K stages in series (PERF.md has the times).
* **Design**: 64x64 output tiles per block, a 4x4 register tile per
  thread, the reduction as a loop over K tiles of 32 through shared memory
  inside the block (next tile prefetched into registers; no split-K, no
  atomics), masked ragged edges.  Each
  output element is summed by one thread in a fixed order (ascending m
  within a K tile, each tile's partial sum added to the running sum), so
  its bits do not depend on the batch size, padding or row position: the
  strict serving tier stays bit-identical to run_nn on the card.  The
  ``csrc/fused_linear_act.cu`` header has the details.

The wrapper takes the plain torch version only for tensors on the CPU; for
a CUDA tensor it launches the kernel or raises.  ``fused_linear_act.launches``
counts kernel launches, so a run can show its main path went through the
kernel.
"""

from __future__ import annotations

import ctypes

import torch

from .activations import ann_act, snn_softmax
from .steps import LNN, SNN

_ENTRY = {torch.float32: "hpnn_fused_linear_act_f32",
          torch.bfloat16: "hpnn_fused_linear_act_bf16",
          torch.float64: "hpnn_fused_linear_act_f64"}
_fns: dict[torch.dtype, object] = {}
_INT32_MAX = 2**31 - 1


def _kernel_fn(dtype: torch.dtype):
    fn = _fns.get(dtype)
    if fn is None:
        from . import build

        lib = build.load("fused_linear_act")
        lib.hpnn_cuda_error_string.argtypes = [ctypes.c_int]
        lib.hpnn_cuda_error_string.restype = ctypes.c_char_p
        fn = getattr(lib, _ENTRY[dtype])
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn.error_string = lib.hpnn_cuda_error_string
        _fns[dtype] = fn
    return fn


def _check(w: torch.Tensor, xs: torch.Tensor) -> None:
    if not (isinstance(w, torch.Tensor) and isinstance(xs, torch.Tensor)):
        raise TypeError("fused_linear_act takes torch tensors")
    if w.dtype != xs.dtype:
        raise TypeError(f"fused_linear_act: w is {w.dtype} but xs is "
                        f"{xs.dtype}; cast both to one dtype")
    if xs.dtype not in _ENTRY:
        raise TypeError(f"fused_linear_act: unsupported dtype {xs.dtype} "
                        "(float32, bfloat16 or float64)")
    if w.device != xs.device:
        raise ValueError(f"fused_linear_act: w on {w.device}, xs on "
                         f"{xs.device}")
    if w.dim() != 2 or xs.dim() != 2 or w.shape[1] != xs.shape[1]:
        raise ValueError(f"fused_linear_act: need w (N, M) and xs (B, M); "
                         f"got {tuple(w.shape)} and {tuple(xs.shape)}")
    if not (w.is_contiguous() and xs.is_contiguous()):
        raise ValueError("fused_linear_act: w and xs must be contiguous")
    if max(xs.shape[0], w.shape[0], w.shape[1]) > _INT32_MAX:
        raise ValueError("fused_linear_act: dimensions must fit in int32")


def fused_linear_act_plain(w: torch.Tensor, xs: torch.Tensor,
                           act: bool = True) -> torch.Tensor:
    """The plain torch version of the kernel: bfloat16 upcast to float32,
    ``xs @ w.T``, the activation, cast back to the operand dtype."""
    compute = torch.float32 if xs.dtype == torch.bfloat16 else xs.dtype
    z = xs.to(compute) @ w.to(compute).T
    if act:
        z = ann_act(z)
    return z.to(xs.dtype)


def fused_linear_act(w: torch.Tensor, xs: torch.Tensor,
                     act: bool = True) -> torch.Tensor:
    """act(xs @ w.T): w (N, M), xs (B, M) -> (B, N) in the operand dtype.

    CPU tensors take :func:`fused_linear_act_plain`; CUDA tensors launch
    the hand-written kernel on the current stream (no synchronisation) or
    raise."""
    _check(w, xs)
    if xs.device.type == "cpu":
        return fused_linear_act_plain(w, xs, act)
    if xs.device.type != "cuda":
        raise ValueError(f"fused_linear_act: no kernel for device "
                         f"{xs.device}")
    b, m = xs.shape
    n = w.shape[0]
    out = torch.empty((b, n), dtype=xs.dtype, device=xs.device)
    if b == 0:
        return out
    fn = _kernel_fn(xs.dtype)
    rc = fn(xs.data_ptr(), w.data_ptr(), out.data_ptr(), b, n, m, int(act),
            xs.device.index, torch.cuda.current_stream(xs.device).cuda_stream)
    if rc != 0:
        msg = fn.error_string(rc).decode()
        raise RuntimeError(f"fused_linear_act launch failed: {msg} ({rc})")
    fused_linear_act.launches += 1
    return out


fused_linear_act.launches = 0


def _forward_layers(weights, xs: torch.Tensor, kind: str, layer):
    """Whole-net forward with ``layer(w, v, act)`` per layer: hidden and
    ANN output layers activate in the layer; the SNN output layer is raw
    and takes softmax(x-1) in plain torch (as in the JAX package, where the
    softmax is XLA outside the Pallas kernel); the LNN output stays
    linear."""
    v = xs
    last = len(weights) - 1
    for i, w in enumerate(weights):
        if i == last and kind in (SNN, LNN):
            v = layer(w, v, False)
            if kind == SNN:
                v = snn_softmax(v)
        else:
            v = layer(w, v, True)
    return v


def batched_forward_fused(weights, xs: torch.Tensor,
                          kind: str) -> torch.Tensor:
    """xs (B, n_in) -> (B, n_out) with every layer product in
    :func:`fused_linear_act`."""
    return _forward_layers(weights, xs, kind, fused_linear_act)


def batched_forward_plain(weights, xs: torch.Tensor,
                          kind: str) -> torch.Tensor:
    """The same net with every layer in :func:`fused_linear_act_plain`, on
    any device: what the kernel path is checked against."""
    return _forward_layers(weights, xs, kind, fused_linear_act_plain)


# --- fused_bpm_update --------------------------------------------------------
# Source note: replaces the Pallas TPU kernel
# ``hpnn_tpu/ops/pallas_kernels.py`` ``fused_bpm_update`` (body
# ``_fused_bpm_kernel``), the reference's one-layer momentum step.  It
# computes step = dw + (lr*d[i])*h[j]; W' = W + step; dw' = alpha*step in
# the Pallas body's association, at float64 and float32.  Bound on the H100
# by device memory (4 flops against 4 values moved a weight); one thread a
# weight, coalesced along rows (``csrc/fused_bpm_update.cu``).  Like the JAX
# package, no training route calls it: the epoch kernels fuse this step.

_BPM_ENTRY = {torch.float64: "hpnn_fused_bpm_update_f64",
              torch.float32: "hpnn_fused_bpm_update_f32"}
_bpm_fns: dict[torch.dtype, object] = {}


def _bpm_fn(dtype: torch.dtype):
    fn = _bpm_fns.get(dtype)
    if fn is None:
        from . import build

        lib = build.load("fused_bpm_update")
        lib.hpnn_bpm_error_string.argtypes = [ctypes.c_int]
        lib.hpnn_bpm_error_string.restype = ctypes.c_char_p
        fn = getattr(lib, _BPM_ENTRY[dtype])
        p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        fn.argtypes = [p, p, p, p, p, p, i, i, d, d, i, p]
        fn.restype = ctypes.c_int
        fn.error_string = lib.hpnn_bpm_error_string
        _bpm_fns[dtype] = fn
    return fn


def _check_bpm(w, dw, d, h) -> None:
    if not all(isinstance(v, torch.Tensor) for v in (w, dw, d, h)):
        raise TypeError("fused_bpm_update takes torch tensors")
    if w.dtype not in _BPM_ENTRY or any(v.dtype != w.dtype
                                        for v in (dw, d, h)):
        raise TypeError(f"fused_bpm_update: w, dw, d and h must share one "
                        f"dtype of float64 or float32; got {w.dtype}, "
                        f"{dw.dtype}, {d.dtype}, {h.dtype}")
    if any(v.device != w.device for v in (dw, d, h)):
        raise ValueError("fused_bpm_update: all tensors on one device")
    if w.dim() != 2 or dw.shape != w.shape or d.shape != (w.shape[0],) \
            or h.shape != (w.shape[1],):
        raise ValueError(f"fused_bpm_update: need w, dw (N, M), d (N,), h "
                         f"(M,); got {tuple(w.shape)}, {tuple(dw.shape)}, "
                         f"{tuple(d.shape)}, {tuple(h.shape)}")
    if not all(v.is_contiguous() for v in (w, dw, d, h)):
        raise ValueError("fused_bpm_update: tensors must be contiguous")
    if max(w.shape) > _INT32_MAX:
        raise ValueError("fused_bpm_update: dimensions must fit in int32")


def fused_bpm_update_plain(w, dw, d, h, lr, alpha):
    """The plain torch version: step = dw + (lr*d)[:, None] * h; returns
    (w + step, alpha * step)."""
    step = dw + (lr * d)[:, None] * h[None, :]
    return w + step, alpha * step


def fused_bpm_update(w, dw, d, h, lr, alpha):
    """One BPM update of a layer: w, dw (N, M); d (N,); h (M,).  Returns
    (w', dw') and leaves the inputs untouched.

    CPU tensors take :func:`fused_bpm_update_plain`; CUDA tensors launch
    the hand-written kernel on the current stream (no synchronisation) or
    raise."""
    _check_bpm(w, dw, d, h)
    if w.device.type == "cpu":
        return fused_bpm_update_plain(w, dw, d, h, lr, alpha)
    if w.device.type != "cuda":
        raise ValueError(f"fused_bpm_update: no kernel for device "
                         f"{w.device}")
    w_out, dw_out = torch.empty_like(w), torch.empty_like(dw)
    fn = _bpm_fn(w.dtype)
    rc = fn(w.data_ptr(), dw.data_ptr(), d.data_ptr(), h.data_ptr(),
            w_out.data_ptr(), dw_out.data_ptr(), w.shape[0], w.shape[1],
            float(lr), float(alpha), w.device.index,
            torch.cuda.current_stream(w.device).cuda_stream)
    if rc != 0:
        msg = fn.error_string(rc).decode()
        raise RuntimeError(f"fused_bpm_update launch failed: {msg} ({rc})")
    fused_bpm_update.launches += 1
    return w_out, dw_out


fused_bpm_update.launches = 0
