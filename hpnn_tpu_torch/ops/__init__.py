import torch

from .activations import TINY, ann_act, ann_dact, snn_softmax
from .convergence import run_batch, run_batch_gemm
from .kernels import (batched_forward_fused, batched_forward_plain,
                      fused_linear_act, fused_linear_act_plain)
from .steps import ANN, LNN, SNN, batched_forward, forward


def select_run_batch(dtype=torch.float64, parity="strict", kind=None,
                     device="cuda"):
    """Pick the batched-inference implementation (run_kernel's and the
    serving registry's eval path).  Returns ``(fn, name)`` with fn
    call-compatible with ``run_batch(weights, xs, kind)``.

    * On CUDA, both tiers, every dtype and every kind go through the
      hand-written ``fused_linear_act`` kernel (``batched_forward_fused``),
      except fast-tier float64: that is a ``torch.matmul`` chain, the
      counterpart of the JAX package's XLA ``run_batch_gemm`` outside any
      Pallas kernel.
    * On the CPU: float32 and bfloat16 take ``batched_forward_fused`` on
      its plain path; float64 strict takes the per-row ``run_batch`` (row
      results independent of batch composition) and float64 fast the GEMM
      chain ``run_batch_gemm``.
    """
    if parity not in ("strict", "fast"):
        raise ValueError(f"parity must be 'strict' or 'fast': {parity!r}")
    dev = torch.device(device)
    if dev.type == "cuda":
        if parity == "fast" and dtype == torch.float64:
            return run_batch_gemm, "gemm"
        return batched_forward_fused, "fused"
    if dtype in (torch.float32, torch.bfloat16):
        return batched_forward_fused, "fused"
    if parity == "fast":
        return run_batch_gemm, "gemm"
    return run_batch, "rows"


__all__ = [
    "TINY", "ann_act", "ann_dact", "snn_softmax",
    "ANN", "SNN", "LNN", "forward", "batched_forward",
    "run_batch", "run_batch_gemm", "select_run_batch",
    "fused_linear_act", "fused_linear_act_plain",
    "batched_forward_fused", "batched_forward_plain",
]
