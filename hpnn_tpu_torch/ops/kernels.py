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
