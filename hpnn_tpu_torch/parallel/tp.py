"""Tensor parallelism: neuron-row sharding (``[model] N``).

The port of the JAX package's ``parallel/tp.py``.  The reference's only
distributed strategy splits every weight matrix's rows in contiguous
blocks over MPI ranks, each rank computes its row block of every layer,
and the full activation vector is re-assembled after each layer with an
all-gather (``ann.c:913-936``).  Hidden layers are zero-padded to a
multiple of the axis (``mesh.pad_topology``) where the reference computed
its remainder rows on every rank.

The model axis is a :class:`~.mesh.Grid`: the devices of one process (a
1 x K ``LocalMesh`` for the serving tier and ``[model] K``, an N x K grid
beside ``[batch]``) or of every rank (``torch.distributed``: gloo on the
CPU, NCCL across cards), a model group within one rank or across ranks.
Every engine here holds, for each shard the process runs, its padded row
block of every hidden layer; the collectives are the grid's.

* **Per-sample epoch** (:func:`tp_train_epoch_resident`): each sample
  trained to convergence as ``ops.convergence.train_sample`` does it, on
  row blocks.  An iteration: the row-block forward and an all-gather of
  each layer's activations (the output layer is row-sharded only where
  the axis divides it, ``mesh.layer_sharding``, and then its
  pre-activations are gathered before the head), the output delta on the
  replicated output, each hidden delta's ``W^T d`` as partial sums
  all-reduced over the model axis, and this shard's rows updated (BP, or
  BPM with ``alpha``).  The stop test reads the replicated output, so
  every shard takes the same branch without a collective; it is one host
  read an iteration, as in the eager loop.  At k = 1 the epoch is the
  per-sample route itself (``ops.select_train_epoch``: the ``train_epoch``
  kernel on a card), so a clamped run gives the unsharded run's bytes.
* **Ring eval engine** (:func:`tp_eval_batch`, the JAX package's
  overlapped ring): hidden layers' row blocks and a replicated head.  Before each
  partial product the next activation block's transfer is issued (shard m
  sends to m - 1 and receives from m + 1), so the two can overlap.  Hidden
  partials sum in ring order; the head's partials sum in canonical block
  order, so the output is bitwise replicated.  ``HPNN_NO_TP_OVERLAP=1``
  swaps in an all-gather and one product (:func:`tp_overlap_enabled`).
  Every product is one ``fused_linear_act`` call: a row block's full
  layer with its activation, or (the ring's partials) ``act=False`` on a
  contiguous column slice of the row block, cut once when the carry is
  built.  (The JAX package computes these products in XLA.)
* **Hybrid epoch** (:func:`tp_dp_train_epoch`, ``[batch]`` x ``[model]``):
  ``parallel.dp``'s minibatch geometry with every forward product on the
  ring engine's blocks; gradients summed over the data axis (an
  all-reduce across ranks, copies in one process), the backward's
  ``d_blk @ W_l`` over the model axis, BPM momentum held as row blocks
  and zeroed each call.
"""

from __future__ import annotations

import os
import typing

import torch

from ..ops import steps
from ..ops.activations import ann_act, ann_dact, snn_softmax
from .mesh import layer_sharding, pad_topology, unpad_topology


def tp_overlap_enabled() -> bool:
    """``HPNN_NO_TP_OVERLAP=1`` swaps the ring schedule for an all-gather
    then one product a layer (the comparator, and the conservative
    schedule if a backend's point-to-point misbehaves)."""
    return os.environ.get("HPNN_NO_TP_OVERLAP", "") != "1"


class TPCarry(typing.NamedTuple):
    """Resident row-sharded weights of the shards this process runs.

    ``shards[p][l]`` is local shard p's tensor of layer l: its padded row
    block where ``rows[l]``, else the whole (unpadded) layer.  ``cols[p][l]``
    is None or that tensor's k contiguous column slices (the ring's
    operands).  ``orig`` holds the unpadded row dims for the export."""

    shards: tuple
    rows: tuple
    orig: tuple
    cols: tuple


def _bounds(n: int, k: int, i: int) -> tuple[int, int]:
    c = n // k
    return i * c, (i + 1) * c


def _col_slices(w: torch.Tensor, k: int) -> tuple:
    c = w.shape[1] // k
    return tuple(w[:, j * c:(j + 1) * c].contiguous() for j in range(k))


def _carry(weights, mesh, rows, ring: bool) -> TPCarry:
    """Pad ``weights`` to the model axis and place each local shard's
    tensors on its device; ``rows[l]`` says which layers are row blocks."""
    k = mesh.n_model
    padded, orig = pad_topology(tuple(weights), k)
    shards, cols = [], []
    for p, m in enumerate(mesh.local):
        dev = mesh.device_of(p)
        ws = []
        for l, w in enumerate(padded):
            if rows[l]:
                lo, hi = _bounds(w.shape[0], k, m)
                w = w[lo:hi]
            ws.append(w.to(dev).contiguous())
        shards.append(tuple(ws))
        cols.append(tuple(_col_slices(w, k) if (ring and l > 0) else None
                          for l, w in enumerate(ws)))
    return TPCarry(tuple(shards), tuple(rows), tuple(orig), tuple(cols))


def tp_engine_carry(weights, mesh, overlap=None) -> TPCarry:
    """The ring engine's layout: every hidden layer a row block, the head
    always whole on every shard (the output stage contracts every block
    against it), never padded.  The ring's column slices are cut here
    once (``overlap`` None reads ``HPNN_NO_TP_OVERLAP``)."""
    if overlap is None:
        overlap = tp_overlap_enabled()
    n = len(weights)
    rows = tuple(l < n - 1 for l in range(n))
    return _carry(weights, mesh, rows, ring=bool(overlap))


def tp_resident_carry(weights, mesh) -> TPCarry:
    """The per-sample epoch's layout: every layer a row block where the
    axis divides its (padded) rows (``mesh.layer_sharding``), so the
    output layer is row-sharded only when k divides it."""
    k = mesh.n_model
    padded, _ = pad_topology(tuple(weights), k)
    rows = tuple(layer_sharding(w, k) == "rows" and k > 1 for w in padded)
    return _carry(weights, mesh, rows, ring=False)


tp_dp_resident_carry = tp_engine_carry


def tp_export_weights(carry: TPCarry, mesh) -> tuple:
    """The carry's weights gathered (the reference's post-update weight
    all-gather, ``ann.c:1636-1642``) and unpadded: float64 numpy arrays
    on every rank (a collective where a model group spans ranks)."""
    out = []
    for l, is_rows in enumerate(carry.rows):
        parts = [s[l] for s in carry.shards]
        full = mesh.gather_rows(parts) if is_rows else parts[0].to("cpu")
        out.append(full.to(torch.float64))
    return tuple(w.numpy().copy() for w in unpad_topology(out, carry.orig))


def carry_bytes(carry: TPCarry) -> int:
    """The bytes of weights each device holds (the largest shard)."""
    return max(sum(w.numel() * w.element_size() for w in s)
               for s in carry.shards)


# --- the products -----------------------------------------------------------

def _lin(w: torch.Tensor, x: torch.Tensor, act: bool) -> torch.Tensor:
    """act(x @ w.T): one ``fused_linear_act`` call (its plain version on
    the CPU); w is cast to x's dtype where a master differs.  On a card the
    launch selects x's card; the guard restores this thread's device after
    it, so a shard on another card leaves nothing unsharded there."""
    from ..ops.kernels import fused_linear_act

    if w.dtype != x.dtype:
        w = w.to(x.dtype)
    if x.device.type != "cuda":
        return fused_linear_act(w, x.contiguous(), act)
    with torch.cuda.device(x.device):
        return fused_linear_act(w, x.contiguous(), act)


def _head(z: torch.Tensor, kind: str) -> torch.Tensor:
    """The output head on summed pre-activations: ANN ann_act, SNN
    softmax(x-1), LNN linear."""
    if kind == steps.SNN:
        return snn_softmax(z)
    if kind == steps.LNN:
        return z
    return ann_act(z)


def _out_full(w, x, kind):
    """The head layer on a full input in one product (the gather
    schedule): the activation in the kernel for ANN."""
    z = _lin(w, x, kind == steps.ANN)
    return snn_softmax(z) if kind == steps.SNN else z


def _ring(h, cols, mesh, collect: bool, heads=None):
    """One layer through the ring: ``h[p]`` is local shard p's activation
    block, ``cols[p]`` its k column slices of the layer.  Each step issues
    the next block's transfer before its partial product.  Returns, for
    the local positions ``heads`` (all by default), the per-step partials
    (step s of shard m multiplies block (m + s) mod k) and, with
    ``collect``, the full previous activation in block order."""
    k = mesh.n_model
    pos = range(len(h)) if heads is None else heads
    blk = list(h)
    parts = [[] for _ in pos]
    seen = [[None] * k for _ in pos] if collect else None
    for s in range(k):
        pend = mesh.shift(blk) if s < k - 1 else None
        for i, p in enumerate(pos):
            j = (mesh.local[p] + s) % k
            if collect:
                seen[i][j] = blk[p]
            parts[i].append(_lin(cols[p][j], blk[p], False))
        if pend is not None:
            blk = pend.wait()
    fulls = ([torch.cat(sp, dim=-1) for sp in seen] if collect else None)
    return parts, fulls


def _ring_hidden(h, cols, mesh, collect=False):
    """A hidden layer's pre-activation row blocks: partials summed in ring
    order."""
    parts, fulls = _ring(h, cols, mesh, collect)
    zs = []
    for pp in parts:
        acc = pp[0]
        for q in pp[1:]:
            acc = acc + q
        zs.append(acc)
    return zs, fulls


def _ring_out(h, cols, mesh, collect=False, heads=None):
    """The head's pre-activations on the positions ``heads``: partials
    summed in canonical block order (block 0 first), so every shard's
    output has the same bits."""
    k = mesh.n_model
    pos = range(len(h)) if heads is None else heads
    parts, fulls = _ring(h, cols, mesh, collect, heads)
    zs = []
    for i, p in enumerate(pos):
        m = mesh.local[p]
        canon = [parts[i][(j - m) % k] for j in range(k)]
        acc = canon[0]
        for q in canon[1:]:
            acc = acc + q
        zs.append(acc)
    return zs, fulls


def _forward_blocks(ws, cols, xs, kind: str, mesh, overlap: bool,
                    collect: bool = False, heads=None):
    """The engine forward on every local shard: ``ws[p]`` the shard's
    layers (hidden row blocks, head whole), ``xs[p]`` the batch on its
    device.  Returns (outputs on the local positions ``heads``, all by
    default; hidden blocks; full inputs of each layer): the last two only
    with ``collect`` (the training engine's backward reads them).  An
    evaluation in one process needs the replicated output once: it forms
    it on the first shard only, whose ring order is the canonical one."""
    n = len(ws[0])
    pos = range(len(ws)) if heads is None else heads
    if n == 1:
        outs = [_out_full(ws[p][0], xs[p], kind) for p in pos]
        return outs, [], [list(xs)]
    h = [_lin(w[0], x, True) for w, x in zip(ws, xs)]
    blks, fulls = [h], [list(xs)]
    for l in range(1, n - 1):
        if overlap:
            zs, full = _ring_hidden(h, [c[l] for c in cols], mesh, collect)
            h = [ann_act(z) for z in zs]
        else:
            full = mesh.gather(h)
            h = [_lin(w[l], f, True) for w, f in zip(ws, full)]
        fulls.append(full)
        blks.append(h)
    if overlap:
        zs, full = _ring_out(h, [c[-1] for c in cols], mesh, collect, heads)
        outs = [_head(z, kind) for z in zs]
    else:
        full = mesh.gather(h, heads)
        outs = [_out_full(ws[p][-1], f, kind) for p, f in zip(pos, full)]
    fulls.append(full)
    return outs, blks, fulls


# --- the ring eval engine ----------------------------------------------------

def tp_eval_batch(weights, xs: torch.Tensor, kind: str, mesh, overlap=None):
    """Batched row-sharded evaluation: ``run_kernel``'s and the serving
    tier's route for a topology too big to replicate.  ``weights`` are
    the layer tensors or a resident :func:`tp_engine_carry`.  Returns the
    (B, n_out) output on the first local shard's device."""
    if overlap is None:
        overlap = tp_overlap_enabled()
    carry = (weights if isinstance(weights, TPCarry)
             else tp_engine_carry(weights, mesh, overlap))
    cols = carry.cols
    if overlap and len(carry.rows) > 1 and cols[0][-1] is None:
        cols = tuple(tuple(_col_slices(w, mesh.n_model) if l else None
                           for l, w in enumerate(s)) for s in carry.shards)
    if xs.shape[0] == 0:
        return xs.new_empty((0, int(carry.orig[-1])))
    xsp = [xs.to(mesh.device_of(p)) for p in range(len(mesh.local))]
    outs, _, _ = _forward_blocks(carry.shards, cols, xsp, kind, mesh,
                                 bool(overlap), heads=(0,))
    return outs[0]


def tp_run_batch(weights, xs: torch.Tensor, kind: str, mesh):
    """Row-sharded batched evaluation with the all-gather schedule (the
    JAX package's GSPMD route)."""
    return tp_eval_batch(weights, xs, kind, mesh, overlap=False)


# --- the per-sample epoch ----------------------------------------------------

def _row_layer(w, v, act: bool):
    """One shard's row block of a layer for one sample: on a card one
    ``fused_linear_act`` launch; on the CPU the eager loop's
    ``steps.matvec`` (so a row's bits follow the unsharded CPU route)."""
    if v.device.type == "cuda":
        return _lin(w, v[None], act)[0]
    z = steps.matvec(w, v)
    return ann_act(z) if act else z


def _mvt_partial(w, d):
    """This shard's ``W^T d`` partial sum; bfloat16 keeps the float32 sum
    unrounded until the partials are added (``steps.matvec_t``'s rule
    rounds once, at the end)."""
    if d.dtype == torch.bfloat16:
        return torch.mv(w.to(torch.bfloat16).float().T, d.float())
    return torch.mv(w.T, d)


def _ps_forward(ws, x, kind: str, mesh, rows):
    """All activations of one sample on every local shard: full (padded)
    vectors, each gathered from the shards' row blocks.  ``x[p]`` is the
    sample on local shard p's device."""
    n = len(rows)
    acts, v = [], list(x)
    for l in range(n):
        last = l == n - 1
        if rows[l]:
            if last:
                z = mesh.gather([_row_layer(w[l], vi, False)
                                 for w, vi in zip(ws, v)])
                h = [steps._head(zz, kind, True) for zz in z]
            else:
                h = mesh.gather([_row_layer(w[l], vi, True)
                                 for w, vi in zip(ws, v)])
        else:   # a whole (replicated) head
            h = [steps._head(_row_layer(w[l], vi, False), kind, last)
                 for w, vi in zip(ws, v)]
        acts.append(h)
        v = h
    return acts


def _ps_iterate(ws, dws, acts, x, t, kind, lr, alpha, mesh, rows):
    """One BP (``dws`` None) or BPM iteration on the row blocks:
    ``steps.iterate``'s order.  Returns (ws, dws, acts)."""
    n = len(rows)
    k = mesh.n_model
    out = acts[-1]
    if kind in (steps.SNN, steps.LNN):
        d = [tp - o for tp, o in zip(t, out)]
    else:
        d = [(tp - o) * ann_dact(o) for tp, o in zip(t, out)]
    ds = [None] * n
    ds[-1] = d
    for l in range(n - 1, 0, -1):
        if rows[l]:
            part = []
            for m, w, dd in zip(mesh.local, ws, ds[l]):
                lo, hi = _bounds(dd.shape[0], k, m)
                part.append(_mvt_partial(w[l], dd[lo:hi]))
            full = mesh.psum(part)
            full = [f.to(dd.dtype) for f, dd in zip(full, ds[l])]
        else:
            full = [steps.matvec_t(w[l], dd) for w, dd in zip(ws, ds[l])]
        ds[l - 1] = [f * ann_dact(a) for f, a in zip(full, acts[l - 1])]
    new_ws, new_dws = [], []
    for p, m in enumerate(mesh.local):
        hs = [x[p]] + [a[p] for a in acts[:-1]]
        wl, dl = [], []
        for l in range(n):
            dd = ds[l][p]
            if rows[l]:
                lo, hi = _bounds(dd.shape[0], k, m)
                dd = dd[lo:hi]
            g = steps.outer(dd, hs[l])
            if dws is None:
                wl.append(ws[p][l] + lr * g)
            else:
                step = dws[p][l] + lr * g
                wl.append(ws[p][l] + step)
                dl.append(alpha * step)
        new_ws.append(tuple(wl))
        new_dws.append(tuple(dl))
    ws = new_ws
    acts = _ps_forward(ws, x, kind, mesh, rows)
    return ws, (new_dws if dws is not None else None), acts


def _ps_train_sample(ws, x, t, kind, momentum, mesh, rows, lr=None,
                     alpha=0.2, delta=-1.0):
    """``ops.convergence.train_sample`` on row blocks; returns (ws, row).
    ``x[p]``, ``t[p]`` are the sample on local shard p's device."""
    from ..ops.convergence import _p_trg, schedule

    lr, min_iter, max_iter, delta = schedule(kind, momentum, lr, delta)
    acts = _ps_forward(ws, x, kind, mesh, rows)
    ep = steps.error(acts[-1][0], t[0], kind)
    init_err = float(ep)
    p_trg = _p_trg(t[0])
    dws = ([tuple(torch.zeros_like(w) for w in s) for s in ws]
           if momentum else None)
    it, first_ok = 0, False
    while True:
        it += 1
        ws, dws, acts = _ps_iterate(ws, dws, acts, x, t, kind, lr, alpha,
                                    mesh, rows)
        epr = steps.error(acts[-1][0], t[0], kind)
        dep, ep = ep - epr, epr
        # one host read an iteration: dEp and the argmax of the
        # replicated output, the same bits on every shard
        dep_v, guess = torch.stack(
            [dep.double(), torch.argmax(acts[-1][0]).double()]).tolist()
        is_ok = True if kind == steps.LNN else int(guess) == p_trg
        if it == 1:
            first_ok = is_ok
        if not (it <= max_iter
                and (dep_v > delta or not (is_ok and it > min_iter))):
            break
    return ws, (init_err, first_ok, it, dep_v, is_ok and it > min_iter)


@torch.inference_mode()
def tp_train_epoch_resident(carry: TPCarry, xs, ts, kind: str,
                            momentum: bool, mesh, alpha=0.2, lr=None,
                            delta=-1.0):
    """One per-sample epoch on a resident :func:`tp_resident_carry` over
    pre-shuffled rows xs (S, n_in), ts (S, n_out).  Returns ``(carry,
    stats)`` with stats the epoch's (S, 5) float64 record
    (``ops.convergence.stats_record`` reads it), the same on every
    shard.  At k = 1 the epoch is ``ops.select_train_epoch``'s route."""
    if mesh.n_model == 1:
        from .. import ops

        w = carry.shards[0]
        fn, _ = ops.select_train_epoch(xs.dtype, kind=kind,
                                       device=xs.device, defer_stats=True)
        new_w, stats = fn(w, xs, ts, kind, momentum, alpha=alpha,
                          delta=delta, lr=lr)
        return carry._replace(shards=(tuple(new_w),)), stats
    wdt = torch.float32 if xs.dtype == torch.bfloat16 else xs.dtype
    ws = [tuple(w.to(wdt) for w in s) for s in carry.shards]
    # the epoch's rows copied once to each distinct device of the shards
    devs = [mesh.device_of(p) for p in range(len(mesh.local))]
    on = {d: (xs.to(d), ts.to(d)) for d in dict.fromkeys(devs)}
    rows_out = []
    for i in range(xs.shape[0]):
        x = [on[d][0][i] for d in devs]
        t = [on[d][1][i] for d in devs]
        ws, row = _ps_train_sample(ws, x, t, kind, momentum, mesh,
                                   carry.rows, lr=lr, alpha=alpha,
                                   delta=delta)
        rows_out.append([float(v) for v in row])
    stats = torch.tensor(rows_out, dtype=torch.float64).reshape(-1, 5)
    return carry._replace(shards=tuple(ws)), stats


def tp_train_epoch(weights, xs, ts, kind: str, momentum: bool, mesh,
                   **kw):
    """Pad and shard ``weights``, train one per-sample epoch, gather and
    unpad: (float64 numpy weights, SampleStats)."""
    from ..ops.convergence import stats_record

    carry = tp_resident_carry(weights, mesh)
    carry, stats = tp_train_epoch_resident(carry, xs, ts, kind, momentum,
                                           mesh, **kw)
    return tp_export_weights(carry, mesh), stats_record(stats, xs.dtype)


def tp_train_sample(weights, x, t, kind: str, momentum: bool, mesh, **kw):
    """One sample trained to convergence on row blocks: (float64 numpy
    weights, the stats row)."""
    carry = tp_resident_carry(weights, mesh)
    wdt = torch.float32 if x.dtype == torch.bfloat16 else x.dtype
    ws = [tuple(w.to(wdt) for w in s) for s in carry.shards]
    devs = [mesh.device_of(p) for p in range(len(mesh.local))]
    with torch.inference_mode():
        ws, row = _ps_train_sample(ws, [x.to(d) for d in devs],
                                   [t.to(d) for d in devs], kind, momentum,
                                   mesh, carry.rows, **kw)
    return tp_export_weights(carry._replace(shards=tuple(ws)), mesh), row


def tp_forward(weights, x, kind: str, mesh):
    """Every layer's activations of one sample through the row-sharded
    forward, unpadded."""
    carry = tp_resident_carry(weights, mesh)
    xs = [x.to(mesh.device_of(p)) for p in range(len(mesh.local))]
    acts = _ps_forward(list(carry.shards), xs, kind, mesh, carry.rows)
    return tuple(a[0][:n] for a, n in zip(acts, carry.orig))


def tp_forward_explicit(weights, x, kind: str, mesh):
    """The reference's per-layer algorithm, every layer's rows padded to
    the axis: a row-block product, an all-gather of the pre-activations,
    then the activation (or the head) on the whole vector."""
    k = mesh.n_model
    v = [x.to(mesh.device_of(p)) for p in range(len(mesh.local))]
    last = len(weights) - 1
    for i, w in enumerate(weights):
        n = w.shape[0]
        pad = (-n) % k
        if pad:
            w = torch.cat([w, w.new_zeros((pad, w.shape[1]))])
        z = []
        for vi, m in zip(v, mesh.local):
            lo, hi = _bounds(w.shape[0], k, m)
            z.append(steps.matvec(w[lo:hi].to(vi.device), vi))
        z = [zz[:n] for zz in mesh.gather(z)]
        v = [steps._head(zz, kind, i == last) for zz in z]
    return v[0]


def _pad_cols(w0, x, k):
    """Zero-pad the contraction dim (W_0's columns and the inputs' last
    axis) to a multiple of k: a zero feature times a zero column adds
    nothing."""
    pad = (-w0.shape[1]) % k
    if pad:
        w0 = torch.cat([w0, w0.new_zeros((w0.shape[0], pad))], dim=1)
        x = torch.cat([x, x.new_zeros((*x.shape[:-1], pad))], dim=-1)
    return w0, x


def _colsharded_first(w0, x, mesh):
    """The first layer's pre-activation with its contraction sharded: each
    shard's column block times its slice of the inputs, summed over the
    axis."""
    k = mesh.n_model
    w0, x = _pad_cols(w0, x, k)
    parts = []
    for p, m in enumerate(mesh.local):
        lo, hi = _bounds(w0.shape[1], k, m)
        dev = mesh.device_of(p)
        parts.append(x[..., lo:hi].to(dev) @ w0[:, lo:hi].to(dev).T)
    return mesh.psum(parts)[0]


def tp_forward_colsharded(weights, x, kind: str, mesh):
    """The input dimension of the first layer sharded (the sequence-
    parallel analog: XRD's 851-wide input): a sum of partial products over
    the axis, then the other layers whole."""
    z0 = _colsharded_first(weights[0], x, mesh)
    if len(weights) == 1:
        return steps._head(z0, kind, True)
    rest = tuple(w.to(z0.device) for w in weights[1:])
    return steps.forward(rest, ann_act(z0), kind)[-1]


def tp_run_batch_colsharded(weights, xs, kind: str, mesh):
    """:func:`tp_forward_colsharded` over a batch (B, n_in)."""
    z0 = _colsharded_first(weights[0], xs, mesh)
    if len(weights) == 1:
        return steps._head(z0, kind, True)
    rest = tuple(w.to(z0.device) for w in weights[1:])
    return steps.batched_forward(rest, ann_act(z0), kind)


# --- the hybrid [batch] x [model] epoch -------------------------------------

def _acc(dtype):
    return torch.promote_types(dtype, torch.float32)


@torch.inference_mode()
def tp_dp_train_epoch(carry: TPCarry, xb, tb, mb, kind: str, momentum: bool,
                      lr, alpha=0.2, *, mesh, overlap=None):
    """One minibatch epoch on the (data x model) grid over the local data
    shards' slots of pre-batched tensors: xb (n_batches, slots, n_in), tb
    (n_batches, slots, n_out), mb (n_batches, slots) 0/1, each one tensor
    (a rank's data shard, or the one of a 1 x K grid) or a list of one for
    each local data shard of ``mesh`` (an N x K :class:`~.mesh.LocalGrid`).
    ``carry`` is :func:`tp_dp_resident_carry`'s: every local shard holds
    its row blocks, so the data shards of a model index hold the same
    weights and apply the same update.  The BPM momentum starts at zero as
    row blocks.  Returns ``(carry, dw_shards or None, errs
    (n_batches,))``."""
    if overlap is None:
        overlap = tp_overlap_enabled()
    if isinstance(xb, torch.Tensor):
        xb, tb, mb = [xb], [tb], [mb]
    ws = [list(s) for s in carry.shards]
    cdt = torch.promote_types(ws[0][0].dtype, xb[0].dtype)
    dws = ([[torch.zeros_like(w) for w in s] for s in ws]
           if momentum else None)
    errs = []
    for i in range(xb[0].shape[0]):
        grads, err = _hybrid_grads(ws, [x[i].to(cdt) for x in xb],
                                   [t[i].to(cdt) for t in tb],
                                   [m[i] for m in mb], kind, mesh,
                                   bool(overlap))
        for p, g in enumerate(grads):
            if momentum:
                # reference order dw += lr*g; W += dw; dw *= alpha
                # (ann.c:1996-1999), on the row blocks
                st = [b + lr * gl for b, gl in zip(dws[p], g)]
                ws[p] = [w + b for w, b in zip(ws[p], st)]
                dws[p] = [alpha * b for b in st]
            else:
                ws[p] = [w + lr * gl for w, gl in zip(ws[p], g)]
        errs.append(err)
    carry = carry._replace(shards=tuple(tuple(w.contiguous() for w in s)
                                        for s in ws))
    return (carry, (tuple(tuple(s) for s in dws) if momentum else None),
            torch.stack(errs))


def _hybrid_grads(ws, x, t, m, kind, mesh, overlap):
    """One batch's mean gradients on every local shard (its row blocks and
    the whole head) and the batch's mean error: the engine forward, then
    ``dp.batched_grads``' explicit deltas (the mask zeroes a padded row's
    output delta, so its whole backward chain), the hidden deltas from
    ``d @ W`` (the head's product is replicated; a hidden layer's is
    all-reduced over the model axis).  ``x``, ``t``, ``m`` hold one batch
    block for each local data shard; the error and row sums and each
    ``d^T h`` are summed over the data shards."""
    k, n = mesh.n_model, len(ws[0])
    blk = mesh.local_data
    cols = ([[_col_slices(w, k) if l else None for l, w in enumerate(s)]
             for s in ws] if overlap else None)
    xs = [x[blk[p]].to(mesh.device_of(p)) for p in range(len(ws))]
    outs, blks, fulls = _forward_blocks(ws, cols, xs, kind, mesh, overlap,
                                        collect=True)
    sums, ds = [], []
    for p, out in enumerate(outs):
        tt = t[blk[p]].to(out.device)
        mp = m[blk[p]].to(out.device)
        e = steps.error(out, tt, kind)
        acc = _acc(e.dtype)
        mf = mp.to(acc)
        sums.append(torch.stack([torch.sum(e.to(acc) * mf), torch.sum(mf)]))
        d = tt - out if kind in (steps.SNN, steps.LNN) \
            else (tt - out) * ann_dact(out)
        ds.append(d * mp.to(d.dtype)[:, None])
    red = mesh.psum_data(sums)
    dens = [torch.clamp_min(r[1], 1.0) for r in red]
    err = (red[0][0] / dens[0]).to(e.dtype)
    grads = [[None] * n for _ in outs]
    for p, g in enumerate(_grads(ds, fulls[-1], dens, mesh)):
        grads[p][-1] = g
    pres = [d @ ws[p][-1] for p, d in enumerate(ds)]
    for l in range(n - 2, -1, -1):
        d_blks = []
        for p, q in enumerate(mesh.local):
            c = blks[l][p].shape[-1]
            d_blks.append(pres[p][:, q * c:(q + 1) * c]
                          * ann_dact(blks[l][p]))
        for p, g in enumerate(_grads(d_blks, fulls[l], dens, mesh)):
            grads[p][l] = g
        if l > 0:
            pres = mesh.psum([db @ ws[p][l] for p, db in enumerate(d_blks)])
    return grads, err


def _grads(ds, hs, dens, mesh):
    """``dp.batched_grads``' discipline for every local shard: contract in
    the native dtype, sum over the data shards, divide in at least
    float32, cast back."""
    gs = mesh.psum_data([d.T @ h for d, h in zip(ds, hs)])
    return [(g.to(_acc(d.dtype)) / den).to(d.dtype)
            for g, d, den in zip(gs, ds, dens)]


__all__ = ["TPCarry", "carry_bytes", "tp_dp_resident_carry",
           "tp_dp_train_epoch", "tp_engine_carry", "tp_eval_batch",
           "tp_export_weights", "tp_forward", "tp_forward_colsharded",
           "tp_forward_explicit", "tp_overlap_enabled", "tp_resident_carry",
           "tp_run_batch", "tp_run_batch_colsharded", "tp_train_epoch",
           "tp_train_epoch_resident", "tp_train_sample"]
