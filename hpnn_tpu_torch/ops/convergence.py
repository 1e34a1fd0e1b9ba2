"""Per-sample train-to-convergence and batched inference with per-row
determinism: the port of the JAX package's ``ops/convergence.py``.

The reference's defining training behavior is *online, per-sample training
to convergence*: each sample is BP-iterated until the error improvement
drops below delta AND the output argmax matches the target class, bounded
by MIN/MAX iteration counts (``src/ann.c:2281-2372``,
``src/snn.c:1417-1595``).  Exact loop semantics (ann.c:2322-2362):

    iter=0
    do { iter++
         dEp = train()                     # update + fresh forward + error
         is_ok = argmax(out) == p_trg      # p_trg: LAST idx with t==1.0, else 0
         if iter==1: record first-try OK/NO
         if iter > MAX: break              # update already applied
         is_ok &= iter > MIN
    } while (dEp > delta || !is_ok)

* the loop body always runs at least once (do/while);
* the MAX break happens AFTER the update, so iteration MAX+1's weight
  update is applied;
* argmax takes the FIRST maximal index; the native LNN head has no class,
  so its is_ok is always true and only dEp <= delta (past MIN) stops it;
* SUCCESS is ``is_ok && iter > MIN``;
* BPM momentum is zeroed at every sample's entry (``ann_raz_momentum``,
  ``ann.c:2391``).

Here the loop is eager torch with one host read of the stop test per
iteration: the CPU route of ``train_nn`` and the plain version the CUDA
epoch kernel (``ops/convergence_kernel.py``) is checked against.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .steps import (DELTA_BP, DELTA_BPM, LNN, MAX_BP_ITER, MAX_BPM_ITER,
                    MIN_BP_ITER, MIN_BPM_ITER, batched_forward, bp_learn_rate,
                    bpm_learn_rate, error, forward, iterate)


class SampleStats(NamedTuple):
    """Per-sample training record, enough to reprint the reference's line
    (each field has a leading sample axis in an epoch's record)."""

    init_err: torch.Tensor   # error after the initial forward ("init=")
    first_ok: torch.Tensor   # bool: argmax correct after iteration 1
    n_iter: torch.Tensor     # int32: iterations executed ("N_ITER=")
    final_dep: torch.Tensor  # last Ep-Epr ("final=")
    success: torch.Tensor    # bool: SUCCESS!/FAIL!


def schedule(kind: str, momentum: bool, lr=None, delta=-1.0):
    """(lr, min_iter, max_iter, delta) of BP or BPM; lr=None takes the
    family's rate and delta<=0 the reference default (ann.c:2323)."""
    if lr is None:
        lr = bpm_learn_rate(kind) if momentum else bp_learn_rate(kind)
    if momentum:
        return lr, MIN_BPM_ITER, MAX_BPM_ITER, (DELTA_BPM if delta <= 0.0
                                                else delta)
    return lr, MIN_BP_ITER, MAX_BP_ITER, (DELTA_BP if delta <= 0.0
                                          else delta)


def _p_trg(t: torch.Tensor) -> int:
    """Index of the target class: LAST idx with t==1.0, default 0.  The
    compare is in t's own dtype, as the reference's is in double: an f64
    target a few ULPs below 1 is not the class."""
    hits = torch.nonzero(t == 1.0)
    return int(hits[-1]) if hits.numel() else 0


def train_sample(weights, x, t, kind: str, momentum: bool, lr=None,
                 alpha=0.2, delta=-1.0):
    """Train one sample to convergence; returns (weights, row) with row =
    (init_err, first_ok, n_iter, final_dep, success) as Python scalars
    (the errors exact in double).

    ``momentum=False`` follows ann_train_BP / snn_train_BP, ``True``
    ann_train_BPM / snn_train_BPM with the dw buffers zeroed at entry."""
    lr, min_iter, max_iter, delta = schedule(kind, momentum, lr, delta)
    acts = forward(weights, x, kind)
    ep = error(acts[-1], t, kind)
    init_err = float(ep)
    p_trg = _p_trg(t)
    dw = tuple(torch.zeros_like(w) for w in weights) if momentum else None
    it, first_ok = 0, False
    while True:
        it += 1
        # train_step / train_step_momentum, keeping the fresh error as the
        # next iteration's ep
        weights, dw, acts, ep, epr = iterate(weights, dw, acts, x, t, kind,
                                             lr, alpha, ep)
        dep, ep = ep - epr, epr
        # one host read per iteration: dEp and the argmax together
        dep_v, guess = torch.stack(
            [dep.double(), torch.argmax(acts[-1]).double()]).tolist()
        is_ok = True if kind == LNN else int(guess) == p_trg
        if it == 1:
            first_ok = is_ok
        if not (it <= max_iter
                and (dep_v > delta or not (is_ok and it > min_iter))):
            break
    return weights, (init_err, first_ok, it, dep_v, is_ok and it > min_iter)


def stats_record(stats: torch.Tensor, dtype: torch.dtype) -> SampleStats:
    """SampleStats (on the CPU) from an epoch's (S, 5) float64 record
    (init_err, first_ok, n_iter, final_dep, success); the errors in the
    training error type (float32 for bfloat16)."""
    edt = torch.float32 if dtype == torch.bfloat16 else dtype
    st = stats.cpu()
    return SampleStats(init_err=st[:, 0].to(edt), first_ok=st[:, 1] > 0.5,
                       n_iter=st[:, 2].to(torch.int32),
                       final_dep=st[:, 3].to(edt), success=st[:, 4] > 0.5)


def master_weights(weights, dtype: torch.dtype):
    """The weights the epoch updates: float32 masters under bfloat16 (pure
    bfloat16 storage rounds BPM-sized updates away), the compute dtype
    otherwise; always fresh contiguous copies."""
    wdt = torch.float32 if dtype == torch.bfloat16 else dtype
    return tuple(w.to(wdt).clone().contiguous() for w in weights)


@torch.inference_mode()
def train_epoch(weights, xs, ts, kind: str, momentum: bool, alpha=0.2,
                delta=-1.0, lr=None, defer_stats=False):
    """One epoch over pre-shuffled sample rows xs (S, n_in), ts (S, n_out):
    :func:`train_sample` per row in order.  Returns (weights, SampleStats),
    or with ``defer_stats`` (weights, the (S, 5) float64 record
    :func:`stats_record` reads); the weights are float32 masters under
    bfloat16."""
    w = master_weights(weights, xs.dtype)
    rows = []
    for x, t in zip(xs, ts):
        w, row = train_sample(w, x, t, kind, momentum, lr=lr, alpha=alpha,
                              delta=delta)
        rows.append([float(v) for v in row])
    stats = torch.tensor(rows, dtype=torch.float64).reshape(-1, 5)
    return w, stats if defer_stats else stats_record(stats, xs.dtype)


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
