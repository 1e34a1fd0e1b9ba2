import torch

from .activations import TINY, ann_act, ann_dact, snn_softmax
from .convergence import (SampleStats, run_batch, run_batch_gemm,
                          train_epoch, train_sample)
from .convergence_kernel import (train_epoch_cuda, train_epoch_kernel,
                                 train_epoch_plain)
from .kernels import (batched_forward_fused, batched_forward_plain,
                      fused_linear_act, fused_linear_act_plain)
from .steps import (ANN, BP_LEARN_RATE, BPM_LEARN_RATE, DELTA_BP, DELTA_BPM,
                    LNN, MAX_BP_ITER, MAX_BPM_ITER, MIN_BP_ITER,
                    MIN_BPM_ITER, SNN, SNN_LEARN_RATE, batched_forward,
                    bp_learn_rate, bpm_learn_rate, deltas, error, forward,
                    train_step, train_step_momentum)


def select_train_epoch(dtype=torch.float64, kind=ANN, device="cuda"):
    """Pick the per-sample training epoch (train_kernel's route).  Returns
    ``(fn, name)`` with fn call-compatible with ``train_epoch(weights, xs,
    ts, kind, momentum, alpha=..., delta=...)``.

    * On CUDA, every dtype (float64, float32, bfloat16) and every kind
      (ANN, SNN, native LNN) runs in the hand-written epoch kernel
      (``train_epoch_cuda``: one launch per epoch, resumed by the host only
      under an iteration budget).
    * On the CPU, the eager per-sample loop ``train_epoch``.
    """
    if torch.device(device).type == "cuda":
        return train_epoch_cuda, "kernel"
    return train_epoch, "loop"


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
    "BP_LEARN_RATE", "SNN_LEARN_RATE", "BPM_LEARN_RATE",
    "DELTA_BP", "DELTA_BPM",
    "MIN_BP_ITER", "MAX_BP_ITER", "MIN_BPM_ITER", "MAX_BPM_ITER",
    "bp_learn_rate", "bpm_learn_rate", "error", "deltas",
    "train_step", "train_step_momentum",
    "SampleStats", "train_sample", "train_epoch", "select_train_epoch",
    "train_epoch_kernel", "train_epoch_plain", "train_epoch_cuda",
    "run_batch", "run_batch_gemm", "select_run_batch",
    "fused_linear_act", "fused_linear_act_plain",
    "batched_forward_fused", "batched_forward_plain",
]
