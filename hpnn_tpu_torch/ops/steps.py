"""Single-sample step functions of the three model families, in plain torch.

The port of the JAX package's ``ops/steps.py``: ``forward`` for one sample
and ``batched_forward`` for a stacked set, then the training half -- the
error, the deltas and the BP/BPM updates.  Deltas are written out, not
taken from autograd, because the update rules carry reference quirks a
textbook loss gradient would not reproduce:

* the ANN output delta includes dact: d_L = (t - o) * ann_dact(o)
  (``ann.c:1308-1310``); SNN and the native LNN use d_L = (t - o)
  (``snn.c:510-512``; the linear head has no dact);
* learning rates differ per family: BP 0.001 for ANN/LNN
  (``include/libhpnn.h:67``) but 0.01 for SNN (``snn.c:799``); BPM 0.0005
  for ANN/LNN (``libhpnn.h:71``) and 0.01 for SNN, whose momentum dger uses
  LEARN_RATE (``snn.c:1117-1135``);
* BPM adds the step before the decay: dw += lr*outer(d,h); W += dw;
  dw *= alpha (``ann.c:1996-1999``);
* the update is ``w + lr * outer(d, h)``: the product d_i*h_j is rounded
  before lr multiplies it.

bfloat16 follows the TPU kernel's mixed-precision rule: weights are float32
masters, matrix-vector operands are bfloat16 with a float32 sum rounded to
bfloat16, the outer product and the update are float32, activations and
deltas are bfloat16, errors are float32.  float64 and float32 compute in
their own type throughout.
"""

from __future__ import annotations

import torch

from .activations import TINY, ann_act, ann_dact, snn_softmax

ANN = "ANN"
SNN = "SNN"
LNN = "LNN"  # declared in the reference, unimplemented (libhpnn.c:975-978)

# Training hyper-parameters (include/libhpnn.h:67-74, snn.c:799)
BP_LEARN_RATE = 0.001      # ANN BP (libhpnn.h:67)
SNN_LEARN_RATE = 0.01      # SNN BP (snn.c:799)
BPM_LEARN_RATE = 0.0005    # ANN BPM (libhpnn.h:71)
MIN_BP_ITER = 31           # libhpnn.h:68
MAX_BP_ITER = 102399       # libhpnn.h:69
DELTA_BP = 1e-6            # libhpnn.h:70
MIN_BPM_ITER = 15          # libhpnn.h:72
MAX_BPM_ITER = 102399      # libhpnn.h:73
DELTA_BPM = 1e-6           # libhpnn.h:74


def bp_learn_rate(kind: str) -> float:
    return SNN_LEARN_RATE if kind == SNN else BP_LEARN_RATE


def bpm_learn_rate(kind: str) -> float:
    """SNN's momentum update feeds dw with LEARN_RATE=0.01 (the dger at
    ``snn.c:1117-1135`` uses LEARN_RATE, not BPM_LEARN_RATE); ANN and LNN
    BPM use BPM_LEARN_RATE=0.0005 (``ann.c:1996``)."""
    return SNN_LEARN_RATE if kind == SNN else BPM_LEARN_RATE


def _bf16(v: torch.Tensor) -> bool:
    return v.dtype == torch.bfloat16


def matvec(w: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """W @ v.  bfloat16 v: the (float32 master) W rounded to bfloat16, the
    products summed in float32, the sum rounded to bfloat16."""
    if _bf16(v):
        return torch.mv(w.to(torch.bfloat16).float(), v.float()).to(
            torch.bfloat16)
    return torch.mv(w, v)


def matvec_t(w: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """W^T @ d, with :func:`matvec`'s bfloat16 rule."""
    if _bf16(d):
        return torch.mv(w.to(torch.bfloat16).float().T, d.float()).to(
            torch.bfloat16)
    return torch.mv(w.T, d)


def outer(d: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """d_i * h_j; float32 for bfloat16 operands (the products are exact)."""
    if _bf16(d):
        return torch.outer(d.float(), h.float())
    return torch.outer(d, h)


def _softmax_head(z: torch.Tensor) -> torch.Tensor:
    """softmax(x-1); bfloat16 rounds exp(z-1) to bfloat16 and normalises in
    float32 (denominator sum + TINY), as the TPU kernel's head does."""
    if _bf16(z):
        e = torch.exp(z - 1.0).float()
        return (e / (torch.sum(e, dim=-1, keepdim=True) + TINY)).to(
            torch.bfloat16)
    return snn_softmax(z)


def _head(z: torch.Tensor, kind: str, last: bool) -> torch.Tensor:
    """ANN: ann_act on every layer (``ann.c:892-1242``).  SNN: ann_act on
    hidden layers, softmax(x-1) on the output (``snn.c:79-443``).  LNN:
    ann_act on hidden layers, a linear output (the regression head)."""
    if last and kind == SNN:
        return _softmax_head(z)
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
        v = _head(matvec(w, v), kind, i == last)
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


def error(out: torch.Tensor, t: torch.Tensor, kind: str) -> torch.Tensor:
    """Training error of one sample (a 0-d tensor; float32 for bfloat16).

    ANN/LNN: 0.5 * sum((t-o)^2)                    (``ann.c:1246-1275``)
    SNN: -(1/N) * sum_{o>0} t*log(o + TINY)        (``snn.c:447-477``)
    """
    if _bf16(out):
        out, t = out.float(), t.float()
    if kind == SNN:
        n = out.shape[-1]
        terms = torch.where(out > 0.0, t * torch.log(out + TINY),
                            torch.zeros_like(out))
        return -torch.sum(terms, dim=-1) / n
    d = t - out
    return 0.5 * torch.sum(d * d, dim=-1)


def deltas(weights, acts, t: torch.Tensor, kind: str):
    """Back-propagated error terms per layer (``ann.c:1279-1592``,
    ``snn.c:481-796``).

    Output layer: ANN d=(t-o)*dact(o); SNN and LNN d=(t-o).
    Hidden l:     d_l = (W_{l+1}^T @ d_{l+1}) * dact(h_l).
    """
    out = acts[-1]
    if kind in (SNN, LNN):
        d = t - out
    else:
        d = (t - out) * ann_dact(out)
    ds = [d]
    for l in range(len(weights) - 1, 0, -1):
        d = matvec_t(weights[l], ds[0]) * ann_dact(acts[l - 1])
        ds.insert(0, d)
    return tuple(ds)


def _inputs_per_layer(acts, x):
    """v_{l-1} for each layer l: the sample for layer 0, else acts[l-1]."""
    return (x, *acts[:-1])


def iterate(weights, dw, acts, x, t, kind: str, lr, alpha=None, ep=None):
    """One BP (``dw=None``) or BPM iteration given the current activations,
    the body of :func:`train_step` and :func:`train_step_momentum`.
    ``ep`` is the error of ``acts`` when the caller already has it (the
    previous iteration's fresh error; recomputing it gives the same bits).
    Returns (new_weights, new_dw, new_acts, ep, epr)."""
    if ep is None:
        ep = error(acts[-1], t, kind)
    ds = deltas(weights, acts, t, kind)
    hs = _inputs_per_layer(acts, x)
    if dw is None:
        new_weights = tuple(w + lr * outer(d, h)
                            for w, d, h in zip(weights, ds, hs))
        new_dw = None
    else:
        # dw += lr*outer; W += dw; dw *= alpha (ann.c:1996-1999)
        stepped = tuple(b + lr * outer(d, h) for b, d, h in zip(dw, ds, hs))
        new_weights = tuple(w + b for w, b in zip(weights, stepped))
        new_dw = tuple(alpha * b for b in stepped)
    new_acts = forward(new_weights, x, kind)
    return new_weights, new_dw, new_acts, ep, error(new_acts[-1], t, kind)


def train_step(weights, acts, x, t, kind: str, lr):
    """One BP iteration given current activations; the reference's
    ``ann_kernel_train`` (``ann.c:1596-1872``) / ``snn_kernel_train``
    (``snn.c:798-1077``): error(acts) -> deltas -> W_l += lr * outer(d_l,
    v_{l-1}) -> fresh forward -> error.  Returns (new_weights, new_acts,
    Ep - Epr)."""
    w, _, acts, ep, epr = iterate(weights, None, acts, x, t, kind, lr)
    return w, acts, ep - epr


def train_step_momentum(weights, dw, acts, x, t, kind: str, lr, alpha):
    """One BPM iteration (``ann.c:1943-2277``, ``snn.c:1078-1416``):
    dw_l += lr * outer(d_l, v_{l-1}); W_l += dw_l; dw_l *= alpha.
    Returns (new_weights, new_dw, new_acts, Ep - Epr)."""
    w, dw, acts, ep, epr = iterate(weights, dw, acts, x, t, kind, lr, alpha)
    return w, dw, acts, ep - epr
