"""Activation functions and per-model-family output heads.

The reference has exactly two nonlinearities:

* ``ann_act(x) = 2/(1+exp(-x)) - 1`` (``src/ann.c:883-885``), a
  [-1,1]-scaled sigmoid, mathematically ``tanh(x/2)``.  float64 (the parity
  path) evaluates the reference's literal expression -- the tanh form
  rounds differently on about half of all inputs; float32/bfloat16
  (throughput modes) use ``tanh(x*0.5)``.
* the SNN softmax head ``o_i = exp(x_i - 1) / (TINY + sum_j exp(x_j - 1))``
  (``src/snn.c:296-334``): a softmax of (x-1) **without** max-subtraction
  and with the denominator seeded at TINY=1e-14 (``dv=TINY`` before
  accumulation; TINY from ``include/libhpnn/common.h:79``).  Both quirks
  are preserved for parity; inputs are activation-bounded so the missing
  max-subtraction cannot overflow.  float64 additionally accumulates the
  denominator in the reference's serial order (see ``snn_softmax``).

``ann_dact(y) = -0.5*(y*y - 1)`` (``ann.c:886-888``) is the derivative of
ann_act expressed in terms of the *output* y.

The CUDA kernel (``csrc/fused_linear_act.cu``) applies the same ``ann_act``
split in its epilogue: the literal expression at float64, ``tanhf(0.5*x)``
at float32/bfloat16.
"""

from __future__ import annotations

import torch

TINY = 1e-14  # include/libhpnn/common.h:79


def ann_act(x: torch.Tensor) -> torch.Tensor:
    """2/(1+e^-x)-1 == tanh(x/2) (ann.c:883-885); the literal expression
    at float64, ``tanh(x*0.5)`` otherwise."""
    if x.dtype == torch.float64:
        if x.requires_grad:
            # the same expression out of place, for autograd (the CG
            # trainer's gradient)
            return 2.0 / (1.0 + torch.exp(-x)) - 1.0
        # 2.0/(1.0+exp(-1.0*x))-1.0, with in-place steps (fewer
        # allocations in the per-sample training loop): -x is -1.0*x
        # exactly, and torch evaluates 2.0/y as (1/y)*2, which scaling by
        # two leaves exactly rounded
        y = torch.exp(-x)
        return y.add_(1.0).reciprocal_().mul_(2.0).sub_(1.0)
    return torch.tanh(x * 0.5)


def ann_dact(y: torch.Tensor) -> torch.Tensor:
    """Derivative of ann_act as a function of its output (ann.c:886-888)."""
    return -0.5 * (y * y - 1.0)


def snn_softmax(x: torch.Tensor) -> torch.Tensor:
    """Softmax(x-1) with TINY-seeded denominator (snn.c:296-334), over the
    last axis so the same code serves single vectors and batches.

    float64 accumulates the denominator in the reference's exact serial
    order -- ``dv = TINY; for j: dv += e[j]`` -- as an explicit left fold,
    so a row's result never depends on how a library would split the sum.
    float32/bfloat16 keep the vector sum (throughput modes)."""
    e = torch.exp(x - 1.0)
    if e.dtype == torch.float64:
        dv = torch.full(e.shape[:-1], TINY, dtype=e.dtype, device=e.device)
        for j in range(e.shape[-1]):
            dv = dv + e[..., j]
        return e / dv.unsqueeze(-1)
    dv = TINY + torch.sum(e, dim=-1, keepdim=True)
    return e / dv
