"""Data parallelism: sample-batched training with summed gradients.

The port of the JAX package's ``parallel/dp.py``.  The reference trains
one sample at a time, each to convergence; a ``[batch] B`` conf instead
does minibatch gradient descent with the same per-family update rules and
learning rates:

    grad_l = (1/B) * sum_b outer(delta_l[b], h_{l-1}[b])   = d^T h / B
    BP:  W_l += lr * grad_l
    BPM: dw_l += lr * grad_l ; W_l += dw_l ; dw_l *= alpha

The per-sample deltas are the reference's explicit ones (``ops.steps``:
the ANN dact output factor, the SNN t-o shortcut), batched as one
(B, M) @ (M, N) product a layer; the batch contraction d^T h is one
matmul.  Products here are plain torch: the JAX package computes them
with XLA, outside any Pallas kernel.

Over N data shards -- a :class:`~.mesh.Grid` of the devices of one
process (the JAX package's single-process mesh) or of every rank's
devices (``HPNN_DISTRIBUTED``, its global mesh) -- each shard takes its
contiguous share of every batch's slots and sums d^T h over its rows
together with its error sum and its real row count in one buffer, and
the buffers are summed over the shards in shard order (``psum_data``).
The update state -- the weights and the BPM momentum -- is a flat vector
padded to N (``parallel.mesh``), of which each shard updates its 1/N
slice; the slices are gathered (``gather_data``) to re-form the weights
the next batch's products read.  A sharded run equals the one-device run
up to the summation order of the sum over shards, whatever the ranks.

``[dtype] bf16`` follows the JAX package's promotion: the f32 master
weights times the bf16 samples compute in f32 (XLA promotes a mixed
product; torch refuses one, so the casts are explicit here), and the row
count and error sums accumulate in at least f32, so the mean stays exact
past 256 rows.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import steps
from ..ops.activations import ann_dact
from . import coord
from .mesh import flatten_state, shard_bounds, unflatten_state


def _acc(dtype: torch.dtype) -> torch.dtype:
    """At-least-f32 accumulation dtype (f64 stays f64)."""
    return torch.promote_types(dtype, torch.float32)


def _deltas_and_inputs(weights, xs, ts, kind: str, mask=None):
    """Per-sample forward, errors and deltas for a batch: (ds, hs, errs)
    in the compute dtype (the promotion of the weights' and the samples'
    dtypes), masked rows' deltas zeroed."""
    cdt = torch.promote_types(weights[0].dtype, xs.dtype)
    x, t = xs.to(cdt), ts.to(cdt)
    acts, v = [], x
    last = len(weights) - 1
    for i, w in enumerate(weights):
        v = steps._head(v @ w.T, kind, i == last)
        acts.append(v)
    errs = steps.error(acts[-1], t, kind)
    out = acts[-1]
    d = t - out if kind in (steps.SNN, steps.LNN) else (t - out) * ann_dact(out)
    ds = [d]
    for l in range(last, 0, -1):
        ds.insert(0, (ds[0] @ weights[l]) * ann_dact(acts[l - 1]))
    if mask is not None:
        m = mask.to(cdt)[:, None]
        ds = [d * m for d in ds]
    return ds, (x, *acts[:-1]), errs


def batched_grads(weights, xs, ts, kind: str, mask=None):
    """Mean gradient per layer via the reference's explicit deltas, and
    the mean error, over one batch in one process.

    ``mask`` (B,) of 0/1 marks the real rows of a padded batch: a masked
    row contributes nothing and the mean divides by the real count (the
    SNN head makes a zero row non-neutral without this).  Returns (grads,
    mean_error)."""
    ds, hs, errs = _deltas_and_inputs(weights, xs, ts, kind, mask)
    acc = _acc(errs.dtype)
    if mask is None:
        denom = torch.tensor(float(xs.shape[0]), dtype=acc, device=xs.device)
        err = torch.sum(errs.to(acc)) / denom
    else:
        m = mask.to(acc)
        denom = torch.clamp_min(torch.sum(m), 1.0)
        err = torch.sum(errs.to(acc) * m) / denom
    grads = tuple(((d.T @ h).to(acc) / denom).to(d.dtype)
                  for d, h in zip(ds, hs))
    return grads, err.to(errs.dtype)


def dp_train_step(weights, xs, ts, kind: str, lr, mask=None):
    """One minibatch BP step; returns (weights, mean_error)."""
    grads, err = batched_grads(weights, xs, ts, kind, mask)
    return tuple(w + lr * g for w, g in zip(weights, grads)), err


def dp_train_step_momentum(weights, dw, xs, ts, kind: str, lr, alpha,
                           mask=None):
    """One minibatch BPM step in the reference order dw += lr*g; W += dw;
    dw *= alpha (ann.c:1996-1999); returns (weights, dw, mean_error)."""
    grads, err = batched_grads(weights, xs, ts, kind, mask)
    dw = tuple(b + lr * g for b, g in zip(dw, grads))
    weights = tuple(w + b for w, b in zip(weights, dw))
    dw = tuple(alpha * b for b in dw)
    return weights, dw, err


def dp_resident_carry(weights, world: int = 1) -> torch.Tensor:
    """The epoch-to-epoch weight carry: the master weights as one flat
    vector padded to the world."""
    return flatten_state(tuple(weights), world)


def dp_export_weights(w_flat: torch.Tensor, shapes) -> list[np.ndarray]:
    """Flat carry -> per-layer float64 numpy (what snapshots and the
    ``kernel.opt`` dump read)."""
    flat = w_flat.detach().to(device="cpu", dtype=torch.float64).numpy()
    out, lo = [], 0
    for sh in shapes:
        n = int(np.prod(sh))
        out.append(flat[lo:lo + n].reshape(sh).copy())
        lo += n
    return out


def _partial_sums(ws, x, t, m, kind: str, n: int):
    """One data shard's share of a batch as one buffer in the accumulation
    dtype, ``[sum_l d^T h | pad | error sum, real rows]`` (``n`` is the
    padded flat length), with the error's and the deltas' dtypes."""
    ds, hs, e = _deltas_and_inputs(ws, x, t, kind, m)
    acc = _acc(e.dtype)
    mf = m.to(acc)
    buf = torch.zeros(n + 2, dtype=acc, device=x.device)
    off = 0
    for d, h in zip(ds, hs):
        k = d.shape[1] * h.shape[1]
        buf[off:off + k] = (d.T @ h).to(acc).reshape(-1)
        off += k
    buf[n] = torch.sum(e.to(acc) * mf)
    buf[n + 1] = torch.sum(mf)
    return buf, e.dtype, ds[0].dtype


def dp_epoch(w_flat, xb, tb, mb, kind: str, momentum: bool, lr, alpha,
             shapes, world: int = 1, rank: int = 0, mesh=None):
    """One minibatch epoch over this process's slots of pre-batched
    tensors: xb (n_batches, slots, n_in), tb (n_batches, slots, n_out), mb
    (n_batches, slots) 0/1.  With ``mesh``, an N x 1 :class:`~.mesh.Grid`,
    xb, tb and mb are lists with one such tensor for each of this rank's
    data shards, on its device (``slots`` that shard's share of every
    batch).  Without one, one tensor: the whole batches on one device at
    world 1, or across ``world`` processes this ``rank``'s share, on a
    grid of one device a rank.  ``w_flat`` is :func:`dp_resident_carry`'s
    vector; the BPM momentum starts at zero each epoch, as the JAX
    package's scan starts it, and lives as each shard's 1/N slice only.

    No host read happens inside: the per-batch mean errors stay on the
    device.  Returns (w_flat, dw or None, errs (n_batches,)); dw is the
    list of this rank's shards' slices on a grid, else one tensor."""
    if mesh is None and world > 1:
        from .mesh import make_mesh

        if coord._dist() is None:
            raise ValueError(f"dp_epoch: world {world} without a process "
                             "group")
        mesh = make_mesh(world, 1, devices=[w_flat.device])
        w, dw, errs = _dp_epoch_grid(w_flat, [xb], [tb], [mb], kind,
                                     momentum, lr, alpha, shapes, mesh)
        return w, (dw[0] if momentum else None), errs
    if mesh is not None and mesh.n_data > 1:
        return _dp_epoch_grid(w_flat, xb, tb, mb, kind, momentum, lr, alpha,
                              shapes, mesh)
    dw = torch.zeros_like(w_flat) if momentum else None
    errs = []
    for i in range(xb.shape[0]):
        grads, err = batched_grads(unflatten_state(w_flat, shapes), xb[i],
                                   tb[i], kind, mb[i])
        g = flatten_state(grads, 1)
        if momentum:
            dw = dw + lr * g
            w_flat = w_flat + dw
            dw = alpha * dw
        else:
            w_flat = w_flat + lr * g
        errs.append(err)
    return w_flat, dw, torch.stack(errs)


def _dp_epoch_grid(w_flat, xb, tb, mb, kind: str, momentum: bool, lr,
                   alpha, shapes, mesh):
    """:func:`dp_epoch` over the N data shards of a grid: each of this
    rank's shards forms its partial sums on its own device from its
    slots, the sums are added in shard order over every rank
    (``mesh.psum_data``), each shard updates its 1/N slice of the flat
    weights and of the momentum on its device, and the slices are
    gathered (``mesh.gather_data``) onto every distinct device before the
    next batch."""
    devs = mesh.data_devices()
    n = w_flat.shape[0]
    cuts = [shard_bounds(n, mesh.n_data, d) for d in mesh.data_ids]
    home = devs[0]
    on = {d: w_flat.to(d) for d in dict.fromkeys(devs)}
    dw = ([torch.zeros(hi - lo, dtype=w_flat.dtype, device=d)
           for (lo, hi), d in zip(cuts, devs)] if momentum else None)
    errs = []
    for i in range(xb[0].shape[0]):
        bufs = []
        for d, dev in enumerate(devs):
            ws = unflatten_state(on[dev], shapes)
            buf, edt, gdt = _partial_sums(ws, xb[d][i], tb[d][i], mb[d][i],
                                          kind, n)
            bufs.append(buf)
        tot = mesh.psum_data(bufs)
        parts = []
        for d, (dev, (lo, hi)) in enumerate(zip(devs, cuts)):
            denom = torch.clamp_min(tot[d][n + 1], 1.0)
            g = (tot[d][lo:hi] / denom).to(gdt)
            w_old = on[dev][lo:hi]
            if momentum:
                dw[d] = dw[d] + lr * g
                parts.append(w_old + dw[d])
                dw[d] = alpha * dw[d]
            else:
                parts.append(w_old + lr * g)
            if d == 0:
                errs.append((tot[0][n] / denom).to(edt))
        (w_home,) = mesh.gather_data(parts, only=(0,))
        on = {dev: w_home.to(dev) for dev in on}
    return on[home], dw, torch.stack(errs)


def dp_tiled_epoch(weights, xs, ts, kind: str, momentum: bool, group: int,
                   lr=None, alpha=0.2, launch_groups: int = 0, storage=None,
                   defer_stats=False, mesh=None):
    """``[batch]`` + ``[tile]``: every ``group``-sized set of samples trains
    TO CONVERGENCE in lockstep with per-lane masking
    (``ops.convergence_tile``, the ``train_tile`` kernel on a card) instead
    of taking one minibatch step, so per-sample iteration counts and the
    per-sample grammar apply again.  ``launch_groups`` is execution
    granularity only: the weights carry launch to launch, and the stats
    and weights are identical for any value.

    With ``mesh``, an N x 1 local grid of N > 1 devices, each group's lanes
    split over the data shards (``ops.convergence_tile.
    train_epoch_tiled_mesh``, torch code, as the JAX package's mesh demotes
    its engine from Pallas to XLA): the group is padded to a multiple of N
    with masked lanes that never train."""
    from ..ops.convergence_tile import (stats_record, train_epoch_tiled,
                                        train_epoch_tiled_mesh)

    if mesh is not None and mesh.n_data > 1:
        w, stats = train_epoch_tiled_mesh(weights, xs, ts, kind, momentum,
                                          mesh, alpha=alpha, lr=lr,
                                          tile=max(1, int(group)),
                                          storage=storage)
        return w, stats if defer_stats else stats_record(stats, xs.dtype)
    return train_epoch_tiled(weights, xs, ts, kind, momentum, alpha=alpha,
                             lr=lr, tile=max(1, int(group)),
                             storage=storage, launch_groups=launch_groups,
                             defer_stats=defer_stats)


def dp_eval_batch(copies, xs: torch.Tensor, kind: str, mesh,
                  forward) -> torch.Tensor:
    """Sharded batched inference, the ``fast@meshN`` tier: xs (B, n_in)
    -> (B, n_out) on xs's device, B a multiple of the mesh's N.

    The rows split into N contiguous blocks; block i goes to
    ``mesh.devices[i]`` and runs the single-device fast forward there on
    ``copies[i]``, that device's replicated weights: ``forward``, the
    caller's ``ops.select_run_batch(..., parity="fast")`` choice (the
    hand-written ``fused_linear_act`` a layer at float32/bfloat16, the
    ``torch.matmul`` chain at float64; every device of a mesh has one
    type).  The outputs come back in shard order.  No collective: the
    weights are replicated.

    Nothing waits on the host.  Every block's copy is enqueued before any
    shard's forward, so that no shard's input queues behind another
    shard's work on xs's stream, and each forward runs on its device's
    current stream.  PyTorch orders a copy between two cards after both
    cards' streams and orders the destination's stream after the copy, so
    work enqueued on xs's stream after this call (the registry's timing
    event, the copy out) waits for every shard.  On four distinct H100s
    the gathered rows are bit-identical to one card's; whether the cards'
    work overlaps is not measured: there the launches, one Python thread
    for every shard, take longer than each shard's kernels."""
    n = mesh.n_data
    if xs.shape[0] % n:
        raise ValueError(f"dp_eval_batch: {xs.shape[0]} rows do not split "
                         f"over {n} shards")
    rows = xs.shape[0] // n
    blocks = [xs[i * rows:(i + 1) * rows].to(dev, non_blocking=True)
              for i, dev in enumerate(mesh.devices)]
    outs = []
    for dev, w, block in zip(mesh.devices, copies, blocks):
        if dev.type == "cuda":
            # the kernel's launch selects the shard's card; the guard
            # restores this thread's device after it
            with torch.cuda.device(dev):
                outs.append(forward(w, block, kind))
        else:
            outs.append(forward(w, block, kind))
    return torch.cat([o.to(xs.device, non_blocking=True) for o in outs])


__all__ = ["batched_grads", "dp_epoch", "dp_eval_batch",
           "dp_export_weights", "dp_resident_carry", "dp_tiled_epoch",
           "dp_train_step", "dp_train_step_momentum"]
