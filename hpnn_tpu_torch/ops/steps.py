"""Forward passes of the three model families, in plain torch.

The port of the JAX package's ``ops/steps.py`` forward half: ``forward``
for one sample and ``batched_forward`` for a stacked set.  The training
steps (error, deltas, BP/BPM updates) come with the training slice.
"""

from __future__ import annotations

import torch

from .activations import ann_act, snn_softmax

ANN = "ANN"
SNN = "SNN"
LNN = "LNN"  # declared in the reference, unimplemented (libhpnn.c:975-978)


def _head(z: torch.Tensor, kind: str, last: bool) -> torch.Tensor:
    """ANN: ann_act on every layer (``ann.c:892-1242``).  SNN: ann_act on
    hidden layers, softmax(x-1) on the output (``snn.c:79-443``).  LNN:
    ann_act on hidden layers, a linear output (the regression head)."""
    if last and kind == SNN:
        return snn_softmax(z)
    if last and kind == LNN:
        return z
    return ann_act(z)


def forward(weights, x: torch.Tensor, kind: str):
    """All layer activations for one sample x (n_in,); acts[-1] is the
    output vector.  Each layer is one matrix-vector product, as the
    reference's GEMV per layer (``libhpnn.c:1426``)."""
    acts = []
    v = x
    last = len(weights) - 1
    for i, w in enumerate(weights):
        v = _head(torch.mv(w, v), kind, i == last)
        acts.append(v)
    return tuple(acts)


def batched_forward(weights, xs: torch.Tensor, kind: str) -> torch.Tensor:
    """Batched forward: xs (S, n_in) -> outputs (S, n_out), one
    (S, M) @ (M, N) product per layer."""
    v = xs
    last = len(weights) - 1
    for i, w in enumerate(weights):
        v = _head(v @ w.T, kind, i == last)
    return v
