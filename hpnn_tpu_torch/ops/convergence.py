"""Batched inference with per-row determinism: the port of the JAX
package's ``ops/convergence.py`` ``run_batch`` and ``run_batch_gemm``.
Training to convergence comes with the training slice."""

from __future__ import annotations

import torch

from .steps import batched_forward, forward


def run_batch(weights, xs: torch.Tensor, kind: str) -> torch.Tensor:
    """Batched inference as one matrix-vector chain per row.

    The reference evaluates one GEMV chain per test FILE
    (``libhpnn.c:1426``), so each sample's result is independent of every
    other sample.  A batched matrix product loses that: the library picks
    its reduction split per shape, so a row's float64 result can shift at
    the ULP level with the batch size.  Looping rows keeps every row's
    reduction order identical across ANY batch size, padding or position,
    which is what lets the serving micro-batcher coalesce and pad
    requests freely and still answer bit-identically to ``run_nn``.  This
    is the CPU strict tier; on the card the fused kernel gives each output
    a fixed reduction order itself."""
    if xs.shape[0] == 0:
        n_out = weights[-1].shape[0]
        return xs.new_empty((0, n_out))
    return torch.stack([forward(weights, x, kind)[-1] for x in xs])


def run_batch_gemm(weights, xs: torch.Tensor, kind: str) -> torch.Tensor:
    """The GEMM-chain sibling of :func:`run_batch` (the fast tier): correct
    to dtype accuracy but not bit-stable across batch shapes."""
    return batched_forward(weights, xs, kind)
