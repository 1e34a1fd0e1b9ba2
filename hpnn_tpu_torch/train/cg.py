"""Batched nonlinear conjugate-gradient trainer (the reference's missing CG).

The port of the JAX package's ``train/cg.py``.  The reference declares
``NN_TRAIN_CG`` but never implements it (``src/libhpnn.c:1253-1257``).

* The objective is the whole-corpus mean of the per-sample training error
  (``ops.steps.error`` over the batched forward), so one evaluation is a
  chain of (S, M) @ (M, N) products.
* The gradient is ``torch.autograd`` of that same chain (the counterpart
  of ``jax.value_and_grad``: an honest gradient, not the per-sample
  trainers' reference quirks).
* The direction is Polak-Ribiere, ``beta = max(0, <g, g - g_prev> /
  max(<g_prev, g_prev>, TINY))``, restarted to steepest descent whenever
  the new direction is not a descent direction (the restarts are counted
  in the snapshot state).
* The step comes from a bracketing line search: halve until the probe
  improves on the current loss, double while it keeps improving, then a
  fixed ternary refine of the bracket.

The JAX package runs the search as two data-dependent ``lax.while_loop``s
inside one compiled program.  Eager torch would read the host at every
probe, so :func:`line_search` evaluates the probes each loop could visit
in one batched forward -- the halving loop visits exactly t = 2^-k for
k = 0..24, the doubling loop t*2^j for j = 1..25, and products by 0.5 and
2 are exact, so the probe points are the loops' own -- and picks the
loops' exit with ``torch.where``.  The refine is 12 fixed steps of two
probes.  An epoch is then a fixed launch sequence with no host read
between its first launch and the read of E0/E1/|g| at its end;
``HPNN_CG_SYNC_DEBUG=error`` turns any synchronisation inside it into an
error on a card.  :func:`line_search_plain` is the step-by-step
transcription (a host read at every probe), the plain version the
batched search is held against.

One ``train_kernel`` epoch runs ``HPNN_CG_ITERS`` (default 8) iterations.
The direction, the prior gradient and the restart counter live in
``nn.trainer_state`` as unpadded float64 vectors (``cg_d``, ``cg_g``,
``cg_meta = [1, restarts, iters]``), the snapshot payload, so a resume is
bit-exact.  Under ``[batch]`` the flat state is padded to the data axis,
the JAX package's data-parallel layout: each data shard's 1/N slice of
the weights, the direction and the gradient lives on its device, over
the devices of one process or of every rank (:func:`cg_epoch` over a
list of slices and its grid; one device is the one-slice case), and
every rank computes the same loss and gradient on the whole corpus.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..models.kernel import trainer_state_to_numpy, trainer_state_to_torch
from ..ops import steps
from ..ops.activations import TINY
from ..parallel.mesh import flatten_state, unflatten_state
from ..utils.nn_log import nn_dbg, nn_out, nn_warn

# line-search budget: halvings/doublings while bracketing, then the fixed
# ternary refine depth (2 loss evaluations a refine step)
_LS_BRACKET_MAX = 24
_LS_REFINE = 12
# loss evaluations an iteration: the gradient's forward, the halving
# probes, the doubling probes, the refine pairs and the final probe
EVALS_PER_ITER = 1 + 2 * (_LS_BRACKET_MAX + 1) + 2 * _LS_REFINE + 1

_CG_ITERS_DEFAULT = 8
# activation bytes one chunk of probes may take (the probes of a search
# step are evaluated this many at a time)
_PROBE_BYTES = 1 << 30

# per-process CG accounting: epochs, iterations, and on a card each
# epoch's device time (CUDA events around the epoch body)
CG_METRICS = {"epochs": 0, "iters": 0, "device_ms": []}


def cg_iters_per_epoch() -> int:
    raw = os.environ.get("HPNN_CG_ITERS", "")
    try:
        n = int(raw) if raw else _CG_ITERS_DEFAULT
    except ValueError:
        nn_warn(f"HPNN_CG_ITERS={raw!r} is not an integer; "
                f"using {_CG_ITERS_DEFAULT}\n")
        return _CG_ITERS_DEFAULT
    return max(1, n)


def _forward(ws, xs, kind: str):
    """Batched forward; ``ws`` may carry a leading probe dimension
    ((P, N, M) layers give (P, S, n_out) outputs)."""
    v = xs
    last = len(ws) - 1
    for i, w in enumerate(ws):
        v = steps._head(torch.matmul(v, w.transpose(-1, -2)), kind,
                        i == last)
    return v


def _loss(flat, xs, ts, kind: str, shapes):
    """Mean corpus error at the flat weights (a leading probe dimension
    gives one loss a probe)."""
    out = _forward(unflatten_state(flat, shapes), xs, kind)
    return torch.mean(steps.error(out, ts, kind), dim=-1)


def probe_losses(f, d, xs, ts, kind: str, shapes):
    """phi(t) = loss(f + t*d) for a vector of steps t, evaluated a chunk of
    probes at a time in one batched forward each."""
    width = max([xs.shape[1]] + [int(sh[0]) for sh in shapes])
    chunk = max(1, _PROBE_BYTES // max(1, xs.shape[0] * width
                                       * xs.element_size() * 3))

    def phis(tv):
        outs = []
        for lo in range(0, tv.shape[0], chunk):
            t = tv[lo:lo + chunk]
            outs.append(_loss(f[None, :] + t[:, None] * d[None, :], xs, ts,
                              kind, shapes))
        return outs[0] if len(outs) == 1 else torch.cat(outs)

    return phis


def line_search(phis, l0):
    """Bracketing line search with no host read: returns the step t, a
    (1,) tensor (0 when no probe improves on ``l0``).  ``phis`` maps a
    vector of steps to their losses; see the module docstring for why the
    batched probes are the JAX loops' own."""
    dt, dev = l0.dtype, l0.device
    n = _LS_BRACKET_MAX + 1
    ar = torch.arange(n + 1, device=dev)
    cap = torch.full((), _LS_BRACKET_MAX, dtype=ar.dtype, device=dev)
    # shrink: the first k with NOT(phi(2^-k) >= l0), else k = 24
    th = torch.cat([torch.ones(1, dtype=dt, device=dev),
                    torch.full((n - 1,), 0.5, dtype=dt,
                               device=dev).cumprod(0)])
    p = phis(th)
    k = torch.where(~(p >= l0), ar[:n], cap).min().view(1)
    t, ft = th.index_select(0, k), p.index_select(0, k)
    # grow: double while the doubled probe keeps improving (at most 24)
    tq = torch.cat([t, t * torch.full((n,), 2.0, dtype=dt,
                                      device=dev).cumprod(0)])
    fq = torch.cat([ft, phis(tq[1:])])
    fail = ~(fq[1:n] < fq[:n - 1])
    j = torch.where(fail, ar[:n - 1], cap).min().view(1)
    t, ft = tq.index_select(0, j), fq.index_select(0, j)
    t2 = tq.index_select(0, j + 1)
    # ternary refine of [0, t2]
    three = torch.full_like(t, 3.0)
    a, b = torch.zeros_like(t), t2
    for _ in range(_LS_REFINE):
        m1 = a + (b - a) / three
        m2 = b - (b - a) / three
        v = phis(torch.cat([m1, m2]))
        keep_lo = v[:1] <= v[1:]
        a, b = torch.where(keep_lo, a, m1), torch.where(keep_lo, m2, b)
    t_star = 0.5 * (a + b)
    ft_star = phis(t_star)
    t_best = torch.where(ft_star <= ft, t_star, t)
    f_best = torch.minimum(ft_star, ft)
    return torch.where(f_best < l0, t_best, torch.zeros_like(t))


def line_search_plain(phis, l0):
    """The step-by-step transcription of the JAX package's search (its
    while loops as Python loops, a host read at every probe): the plain
    version :func:`line_search` is held against."""
    t = torch.ones(1, dtype=l0.dtype, device=l0.device)
    ft = phis(t)
    k = 0
    while bool(ft >= l0) and k < _LS_BRACKET_MAX:
        t = t * 0.5
        ft = phis(t)
        k += 1
    t2 = t * 2.0
    ft2 = phis(t2)
    k = 0
    while bool(ft2 < ft) and k < _LS_BRACKET_MAX:
        t, ft = t2, ft2
        t2 = t2 * 2.0
        ft2 = phis(t2)
        k += 1
    three = torch.full_like(t, 3.0)
    a, b = torch.zeros_like(t), t2
    for _ in range(_LS_REFINE):
        m1 = a + (b - a) / three
        m2 = b - (b - a) / three
        if bool(phis(m1) <= phis(m2)):
            b = m2
        else:
            a = m1
    t_star = 0.5 * (a + b)
    ft_star = phis(t_star)
    t_best = t_star if bool(ft_star <= ft) else t
    f_best = torch.minimum(ft_star, ft)
    return t_best if bool(f_best < l0) else torch.zeros_like(t)


def _gather(parts, dev, mesh=None):
    """The shards' slices of a flat vector, whole on ``dev`` (one slice on
    ``dev`` is returned as it is); with ``mesh`` the slices of every
    rank's shards (``gather_data``)."""
    if mesh is not None:
        return mesh.gather_data(parts, only=(0,))[0].to(dev)
    if len(parts) == 1 and parts[0].device == dev:
        return parts[0]
    return torch.cat([p.to(dev) for p in parts])


def _split(v, devs, mesh=None):
    """A flat vector as N contiguous slices, slice i on ``devs[i]``; with
    ``mesh`` the slices of this rank's data shards out of the grid's
    ``n_data``."""
    if mesh is None:
        ids, n = range(len(devs)), len(devs)
    else:
        ids, n = mesh.data_ids, mesh.n_data
    c = v.shape[0] // n
    return [v[i * c:(i + 1) * c].to(dev) for i, dev in zip(ids, devs)]


def _dot(a, b, dev, mesh=None):
    """<a, b> of two sharded vectors: the shards' partials added in shard
    order on ``dev`` (with ``mesh`` over every rank's shards)."""
    if mesh is not None:
        return mesh.psum_data([torch.dot(x, y) for x, y in zip(a, b)]
                              )[0].to(dev)
    tot = None
    for x, y in zip(a, b):
        part = torch.dot(x, y).to(dev)
        tot = part if tot is None else tot + part
    return tot


def cg_epoch(flat, d, g_prev, have, restarts, xs, ts, kind: str, shapes,
             n_iters: int, plain: bool = False, mesh=None):
    """``n_iters`` CG iterations from the flat weights ``flat`` with the
    carried direction ``d``, prior gradient ``g_prev``, ``have`` (a bool
    tensor: a prior direction exists) and ``restarts`` (an int32 tensor).
    ``flat``, ``d`` and ``g_prev`` are each a tensor on the corpus's
    device, or a list of N data shards' equal slices, each slice on its
    shard's device; the returned vectors take the same form.  With
    ``mesh`` (an N x 1 grid) the list holds this rank's data shards'
    slices, and the gathers and the dot products take every rank's.  The
    loss, its gradient and the line search's probes run on the corpus's
    device from the gathered vectors; the dot products add the shards'
    partials in shard order, and the direction's update and the step run
    on each slice's device.  Nothing is read back unless ``plain`` (the
    transcribed line search).  Returns (flat, d, g, e0, e1, |g|,
    restarts)."""
    search = line_search_plain if plain else line_search
    whole = torch.is_tensor(flat)
    if whole:
        flat, d, g_prev = [flat], [d], [g_prev]
    devs = [f.device for f in flat]
    home = xs.device
    with torch.no_grad():
        e0 = _loss(_gather(flat, home, mesh), xs, ts, kind, shapes)
    g = g_prev
    for _ in range(n_iters):
        full = _gather(flat, home, mesh)
        with torch.enable_grad():
            fr = full.detach().requires_grad_(True)
            lv = _loss(fr, xs, ts, kind, shapes)
            (gf,) = torch.autograd.grad(lv, fr)
        with torch.no_grad():
            g = _split(gf, devs, mesh)
            lv = lv.detach().view(1)
            gg_prev = _dot(g_prev, g_prev, home, mesh)
            beta = torch.clamp_min(
                _dot(g, [a - b for a, b in zip(g, g_prev)], home, mesh)
                / torch.clamp_min(gg_prev, TINY), 0.0)
            beta = torch.where(have, beta, torch.zeros_like(beta))
            d_new = [-gi + beta.to(gi.device) * di for gi, di in zip(g, d)]
            descent = _dot(d_new, g, home, mesh) < 0.0
            d_new = [torch.where(descent.to(dn.device), dn, -gi)
                     for dn, gi in zip(d_new, g)]
            restarts = restarts + (have & ~descent).to(restarts.dtype)
            step = search(probe_losses(full, _gather(d_new, home, mesh), xs,
                                       ts, kind, shapes), lv)
            flat = [f + step.to(f.device) * dn for f, dn in zip(flat, d_new)]
            d, g_prev = d_new, g
            have = torch.ones_like(have)
    with torch.no_grad():
        e1 = _loss(_gather(flat, home, mesh), xs, ts, kind, shapes)
        gn = torch.sqrt(_dot(g, g, home, mesh))
    if whole:
        flat, d, g = flat[0], d[0], g[0]
    return flat, d, g, e0, e1, gn, restarts


def _load_state(nn, total: int, pad_to: int, dtype, device):
    """nn.trainer_state -> (d, g, have, restarts) as padded flat tensors.
    A size mismatch (the topology changed under the snapshot) warns and
    restarts CG from steepest descent."""
    st = getattr(nn, "trainer_state", None)
    got = trainer_state_to_torch(st, total, pad_to, dtype, device) \
        if st else None
    if got is None:
        if st:
            nn_warn("CG state size mismatch; restarting from steepest "
                    "descent\n")
        zeros = torch.zeros(total + (-total) % max(1, pad_to), dtype=dtype,
                            device=device)
        return zeros, zeros.clone(), False, 0
    return got


def run_cg_epoch(nn, weights, xs, ts, kind: str, dtype, plain=False):
    """One CG training epoch over the staged corpus (``xs``/``ts`` tensors
    in ``dtype`` on the compute device); returns the updated weight tuple.
    Refreshes ``nn.last_epoch_stats`` (the mean corpus error after the
    epoch) and ``nn.trainer_state`` (unpadded float64 direction, prior
    gradient and restart counter: the snapshot payload)."""
    t0 = time.perf_counter()
    dev = xs.device
    shapes = tuple(tuple(int(n) for n in w.shape) for w in weights)
    total = int(sum(int(np.prod(sh)) for sh in shapes))
    n_iters = cg_iters_per_epoch()
    pad_to, mesh = 1, None
    if getattr(nn.conf, "batch", 0) > 0:
        # [batch]: the flat state over the data axis (the api's devices)
        from .. import api

        pad_to = api._dp_device_count(dev)
        mesh = api._dp_mesh(pad_to, 1, dev)
    flat = flatten_state([w.to(dtype) for w in weights], pad_to)
    d, g, have, restarts = _load_state(nn, total, pad_to, dtype, dev)
    devs = list(mesh.data_devices()) if mesh is not None else [dev]
    flat, d, g = (_split(v, devs, mesh) for v in (flat, d, g))
    have_t = torch.tensor(have, device=dev)
    restarts_t = torch.tensor(restarts, dtype=torch.int32, device=dev)
    sync_mode = os.environ.get("HPNN_CG_SYNC_DEBUG", "")
    start = end = None
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        if sync_mode:
            torch.cuda.set_sync_debug_mode(sync_mode)
    try:
        flat, d, g, e0, e1, gn, restarts_t = cg_epoch(
            flat, d, g, have_t, restarts_t, xs, ts, kind, shapes, n_iters,
            plain=plain, mesh=mesh)
        flat, d, g = (_gather(v, dev, mesh) for v in (flat, d, g))
    finally:
        if dev.type == "cuda" and sync_mode:
            torch.cuda.set_sync_debug_mode(0)
    if end is not None:
        end.record()
    head = torch.stack([e0.double(), e1.double(), gn.double(),
                        restarts_t.double()]).cpu()   # the one read
    e0, e1, gn, n_restarts = (float(head[0]), float(head[1]),
                              float(head[2]), int(head[3]))
    if end is not None:
        CG_METRICS["device_ms"].append(start.elapsed_time(end))
    CG_METRICS["epochs"] += 1
    CG_METRICS["iters"] += n_iters
    s = int(xs.shape[0])
    # one line an epoch (deterministic, so the resume byte-parity covers
    # it; the wall time goes to DBG only)
    nn_out(f"TRAINING CG\t samples={s:8d} iters={n_iters:4d} "
           f"E0={e0:15.10f} E1={e1:15.10f} |g|={gn:15.10f} "
           f"restarts={n_restarts:4d}\n")
    nn_dbg(f"CG epoch wall {time.perf_counter() - t0:.3f} s\n")
    nn.trainer_state = trainer_state_to_numpy(d, g, total, n_restarts,
                                              n_iters)
    nn.last_epoch_stats = {"samples": s, "success": 0,
                           "mean_init": e0, "mean_final": e1}
    return unflatten_state(flat[:total], shapes)


__all__ = ["CG_METRICS", "EVALS_PER_ITER", "cg_epoch", "cg_iters_per_epoch",
           "line_search", "line_search_plain", "probe_losses",
           "run_cg_epoch"]
