"""The MLP "kernel" -- the reference's single model data structure.

The reference's ``kernel_ann`` (``include/libhpnn/ann.h:35-55``) is a stack
of dense layers without biases: each layer is a row-major weight matrix W of
shape (n_neurons, n_inputs) and an activation vector.  The same structure
backs all three model families (ANN sigmoid output, SNN softmax output, LNN
linear output -- the latter declared but unimplemented in the reference,
``src/libhpnn.c:975-978``).

The host-side kernel is a plain container of float64 numpy arrays, the same
parameters the JAX package keeps; :func:`weights_to_torch` casts them once to
the compute dtype on the compute device, and :class:`MLP` holds that cast
copy as module buffers.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import numpy as np
import torch

from ..utils.glibc_random import GlibcRandom


def output_head(kind: str) -> str:
    """The output-layer nonlinearity of a model family: ANN sigmoid,
    SNN softmax, LNN linear (the regression head)."""
    return {"SNN": "softmax", "LNN": "linear"}.get(kind, "sigmoid")


def is_regression(kind: str) -> bool:
    """Regression families score on MSE, not argmax-class error; drives
    run_kernel's output grammar."""
    return output_head(kind) == "linear"


@dataclasses.dataclass
class Kernel:
    """Host-side MLP parameter container.

    weights[l] has shape (N_l, M_l) with M_0 == n_inputs and
    N_{last} == n_outputs; layer l computes act(W_l @ v_{l-1}).
    """

    name: str
    weights: list[np.ndarray]
    momentum: list[np.ndarray] | None = None

    def momentum_init(self) -> None:
        """Allocate + zero dw buffers (ann_momentum_init, ann.c:1876-1890)
        and print the reference's accounting line (ann.c:1904): the dw
        pointer array (8 bytes per layer) plus each dw matrix at 8 bytes
        per weight."""
        from ..utils.nn_log import nn_out

        self.momentum = [np.zeros_like(w) for w in self.weights]
        n_bytes = 8 * len(self.weights) + 8 * sum(
            int(w.size) for w in self.weights)
        nn_out(f"[CPU] MOMENTUM ALLOC: {n_bytes} (bytes)\n")

    def momentum_free(self) -> None:
        self.momentum = None

    @property
    def n_inputs(self) -> int:
        return int(self.weights[0].shape[1])

    @property
    def n_outputs(self) -> int:
        return int(self.weights[-1].shape[0])

    @property
    def hiddens(self) -> list[int]:
        return [int(w.shape[0]) for w in self.weights[:-1]]

    @property
    def n_hiddens(self) -> int:
        return len(self.weights) - 1

    @property
    def params(self) -> list[int]:
        """The `[param]` line: n_inputs, hidden sizes..., n_outputs."""
        return [self.n_inputs, *self.hiddens, self.n_outputs]

    @property
    def allocation_bytes(self) -> int:
        """The byte count ann_kernel_allocate reports (ann.c:113-200):
        n_hiddens * sizeof(layer_ann)=24, the max_index scratch, the input
        vector, and every layer's weights+activation vector at 8 bytes
        each."""
        n_hiddens = self.n_hiddens
        max_index = max(self.n_inputs, self.n_outputs, *self.hiddens)
        doubles = max_index + self.n_inputs + sum(
            w.shape[0] * w.shape[1] + w.shape[0] for w in self.weights)
        return 24 * n_hiddens + 8 * doubles


def generate_kernel(
    seed: int,
    n_inputs: int,
    hiddens: Sequence[int],
    n_outputs: int,
    name: str = "noname",
) -> tuple[Kernel, int]:
    """Random kernel with the reference's exact init stream.

    Reproduces ``ann_generate`` (``src/ann.c:632-766``): ``srandom(seed)``
    (seed 0 replaced by time()), then each layer's weights filled row-major
    with ``2*(random()/RAND_MAX - 0.5)/sqrt(M)`` -- hidden layers first in
    order, output layer last.

    Returns (kernel, effective_seed) since the reference writes back the
    time()-derived seed into the conf when seed==0 (ann.c:653).
    """
    seed = int(seed)
    if seed == 0:
        seed = int(time.time())
    rng = GlibcRandom(seed)
    dims = [int(n_inputs), *[int(h) for h in hiddens], int(n_outputs)]
    weights: list[np.ndarray] = []
    for m, n in zip(dims[:-1], dims[1:]):
        u = rng.uniform_array(n * m).reshape(n, m)
        weights.append(2.0 * (u - 0.5) / np.sqrt(float(m)))
    return Kernel(name=name, weights=weights), seed


# --- weights carried across the two packages --------------------------------

def weights_to_torch(weights: Sequence[np.ndarray], dtype: torch.dtype,
                     device) -> tuple[torch.Tensor, ...]:
    """The kernel's float64 layer matrices cast ONCE to ``dtype`` on
    ``device``, contiguous -- the counterpart of the JAX package's
    ``jnp.asarray(w, dtype=dtype)`` per layer.  The cast happens from
    float64 in one step, so every consumer of one kernel (run_nn, the
    serving registry) sees the same rounded values."""
    return tuple(
        torch.as_tensor(np.ascontiguousarray(w, dtype=np.float64))
        .to(device=device).to(dtype).contiguous()
        for w in weights)


def weights_to_numpy(weights: Sequence[torch.Tensor]) -> list[np.ndarray]:
    """Inverse of :func:`weights_to_torch`: float64 host arrays (exact for
    every dtype the port computes in)."""
    return [w.detach().to(device="cpu", dtype=torch.float64).numpy().copy()
            for w in weights]


def trainer_state_to_torch(state: dict, total: int, pad_to: int,
                           dtype: torch.dtype, device):
    """A CG carry in the bundle layout both packages write (``cg_d`` and
    ``cg_g`` unpadded float64 vectors of ``total`` values, ``cg_meta`` =
    [have, restarts, iters]) as ``(d, g, have, restarts)``: the vectors in
    ``dtype`` on ``device``, zero-padded to a multiple of ``pad_to`` (the
    world, the JAX package's data-axis layout).  None when the vectors'
    size is not ``total``."""
    d = np.asarray(state.get("cg_d", ()), np.float64).reshape(-1)
    g = np.asarray(state.get("cg_g", ()), np.float64).reshape(-1)
    meta = np.asarray(state.get("cg_meta", (0, 0, 0)), np.int64).reshape(-1)
    if d.size != total or g.size != total:
        return None
    pad = (-total) % max(1, int(pad_to))

    def up(v):
        return torch.as_tensor(np.concatenate([v, np.zeros(pad)])).to(
            device=device).to(dtype)

    return (up(d), up(g), bool(meta[0]) if meta.size else False,
            int(meta[1]) if meta.size > 1 else 0)


def trainer_state_to_numpy(d: torch.Tensor, g: torch.Tensor, total: int,
                           restarts: int, iters: int) -> dict:
    """Inverse of :func:`trainer_state_to_torch`: the unpadded float64
    bundle payload."""
    def host(v):
        return v[:total].detach().to(device="cpu",
                                     dtype=torch.float64).numpy().copy()

    return {"cg_d": host(d), "cg_g": host(g),
            "cg_meta": np.asarray([1, int(restarts), int(iters)], np.int64)}


class MLP(torch.nn.Module):
    """A kernel's layer weights as module buffers in the compute dtype on
    the compute device, evaluated through the fused forward.  Buffers, not
    parameters: training never goes through autograd -- the epoch updates
    the weights in its own kernel (``ops.convergence_kernel``)."""

    def __init__(self, weights: Sequence[torch.Tensor], kind: str):
        super().__init__()
        self.kind = kind
        self.n_layers = len(weights)
        for i, w in enumerate(weights):
            self.register_buffer(f"w{i}", w)

    @classmethod
    def from_kernel(cls, kernel: Kernel, dtype: torch.dtype, device,
                    kind: str = "ANN") -> "MLP":
        return cls(weights_to_torch(kernel.weights, dtype, device), kind)

    @property
    def weights(self) -> tuple[torch.Tensor, ...]:
        return tuple(getattr(self, f"w{i}") for i in range(self.n_layers))

    def forward(self, xs: torch.Tensor) -> torch.Tensor:
        from ..ops.kernels import batched_forward_fused

        return batched_forward_fused(self.weights, xs, self.kind)
