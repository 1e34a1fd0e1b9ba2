"""Batched-tile convergence epoch: the port of the JAX package's
``ops/convergence_tile.py``.

Semantics -- *group-to-convergence with per-lane masking*:

* the epoch's (pre-shuffled) samples split into consecutive groups of
  ``tile`` rows; groups run strictly in order, the weights carrying from
  group to group as the per-sample chain carries them from sample to sample;
* within a group every lane starts at the group's entry weights and the
  reference's do/while iterations run LOCKSTEP: per iteration each live
  lane's deltas come from the pre-update weights, and each layer takes one
  update summed over the live lanes' rank-1 products (S simultaneous
  per-sample updates, not a 1/S-scaled minibatch mean);
* a lane drops out of the update the moment its own stop test fires --
  ``(dEp <= delta) && argmax-ok && iter > MIN``, bounded by MAX
  (``ann.c:2322-2362``) -- and its stats row freezes at that iteration;
* the group ends when every lane is dead, so its slowest lane holds it;
* momentum is zeroed at group entry and ``first_ok`` is latched at lockstep
  iteration 1.

``tile=1`` is the per-sample semantics.  ``tile>1`` is a documented
divergence from the sequential trajectory (lanes interact through the
shared weights).

Mixed-precision storage (the ``storage=`` axis): weights can be held
between iterations in a narrower dtype than the update math --
``"bf16"`` keeps bfloat16 weights and adds each update in float32;
``"f32"`` keeps float32 weights and adds in float64; ``None`` is the
per-sample rule (float32 masters under bfloat16 activations, the compute
dtype otherwise).

:func:`train_epoch_tiled_plain` is the eager torch counterpart of the JAX
``_group_loop``: the CPU route of ``train_nn --tile`` and what the CUDA
kernel (``ops/convergence_tile_kernel.py``, ``csrc/train_tile.cu``) is
held against on the card.  :func:`train_epoch_tiled` is the public epoch:
call-compatible with ``ops.convergence.train_epoch``, it launches the
kernel wrapper for ``launch_groups`` groups at a time.
:func:`train_epoch_tiled_mesh` is the engine's route over a data mesh of
one process's devices (``[batch]`` + ``[tile]`` on several devices), the
counterpart of the JAX package's meshed XLA route: torch code, each
group's lanes split over the shards, as the JAX package's mesh demotes the
engine from its Pallas kernel to XLA.
"""

from __future__ import annotations

import torch

from .activations import TINY, ann_act, ann_dact
from .convergence import schedule, stats_record
from .steps import LNN, SNN

INT32_MAX = 2**31 - 1
_STORAGE = {"bf16": torch.bfloat16, "f32": torch.float32,
            "f64": torch.float64}


def resolve_hyper(kind: str, momentum: bool, lr, delta, max_iter=None):
    """(lr, delta, min_iter, max_iter) of the family (lr=None and
    delta<=0 take the reference defaults); ``max_iter`` overrides the
    iteration ceiling, a bounded-trajectory knob for rate measurement
    (the autotuner's probes); None keeps the reference semantics."""
    lr, min_iter, family_max, delta = schedule(kind, momentum, lr, delta)
    return (float(lr), float(delta), min_iter,
            int(max_iter) if max_iter else family_max)


def _acc(dtype: torch.dtype) -> torch.dtype:
    """Accumulation dtype of a product: float32 under bfloat16."""
    return torch.float32 if dtype == torch.bfloat16 else dtype


def storage_wdtype(dtype: torch.dtype, storage: str | None) -> torch.dtype:
    """Resident weight dtype for a storage mode: ``None`` keeps the
    per-sample master rule, "bf16"/"f32"/"f64" pin it."""
    if storage in (None, ""):
        return _acc(dtype)
    if storage not in _STORAGE:
        raise ValueError(f"unknown weight storage {storage!r} "
                         "(expected bf16/f32/f64)")
    return _STORAGE[storage]


def _accum_dtype(storage: str | None) -> torch.dtype | None:
    """The dtype an explicit storage mode adds the update in: float32 for
    bfloat16 storage, float64 for float32 storage; None adds in the
    resident dtype (the per-sample rule)."""
    return {"bf16": torch.float32, "f32": torch.float64}.get(storage)


def n_groups(s: int, tile: int) -> int:
    return -(-s // tile)


def _stats_init(stats_prev, s: int, device) -> torch.Tensor:
    """The record a launch starts from: the previous launch's rows, or all
    rows untrained (n_iter = -1)."""
    if stats_prev is not None:
        return stats_prev.clone()
    st = torch.zeros((s, 5), dtype=torch.float64, device=device)
    st[:, 2] = -1.0
    return st


def resident_weights(weights, dtype: torch.dtype, storage):
    """Fresh contiguous copies of the weights in the resident dtype."""
    wdt = storage_wdtype(dtype, storage)
    return tuple(w.to(wdt).clone().contiguous() for w in weights)


# --- the group loop in plain torch ------------------------------------------
# One helper per JAX one (_mv, _mv_t, _upd): operands cast to the
# activation dtype, products summed in the accumulation dtype.

def _mv(v, w):
    """(S, M) x (N, M)^T -> (S, N) in the activation dtype."""
    acc = _acc(v.dtype)
    return (v.to(acc) @ w.to(v.dtype).to(acc).T).to(v.dtype)


def _mv_t(d, w):
    """(S, N) x (N, M) -> (S, M): the transposed product of the hidden
    deltas."""
    acc = _acc(d.dtype)
    return (d.to(acc) @ w.to(d.dtype).to(acc)).to(d.dtype)


def _upd(d, h):
    """(S, N)^T x (S, M) -> (N, M) summed over lanes in the accumulation
    dtype."""
    acc = _acc(d.dtype)
    return d.to(acc).T @ h.to(acc)


def _softmax_head(z, edt):
    """softmax(x-1) per row: exp in the activation dtype, the denominator
    summed in order in the error dtype with TINY added last
    (hpnn_tpu/ops/convergence_tile.py:203-205), the quotient rounded back."""
    e = torch.exp(z - 1.0)
    ef = e.to(edt)
    dv = ef[:, 0]
    for j in range(1, ef.shape[1]):
        dv = dv + ef[:, j]
    dv = dv + TINY
    return (ef / dv[:, None]).to(z.dtype)


def _out_head(z, kind, edt):
    if kind == SNN:
        return _softmax_head(z, edt)
    if kind == LNN:
        return z
    return ann_act(z)


def _forward(weights, x, kind, edt):
    acts, v = [], x
    last = len(weights) - 1
    for l, w in enumerate(weights):
        z = _mv(v, w)
        v = _out_head(z, kind, edt) if l == last else ann_act(z)
        acts.append(v)
    return acts


def _err(o, t, kind, edt):
    """Per-row error in the error dtype (float32 under float32/bfloat16)."""
    of, tf = o.to(edt), t.to(edt)
    if kind == SNN:
        terms = torch.where(of > 0.0, tf * torch.log(of + TINY),
                            torch.zeros_like(of))
        return -torch.sum(terms, dim=1) / o.shape[1]
    d = tf - of
    return 0.5 * torch.sum(d * d, dim=1)


def _group_plain(w, dw, x, t, kind, momentum, lr, alpha, min_iter, max_iter,
                 delta, add_dt):
    """One group of lanes x (S, n_in), t (S, n_out) trained to convergence
    in lockstep; updates ``w`` (and ``dw``) in place.  Returns the group's
    (S, 5) float64 stats rows."""
    edt = torch.float64 if x.dtype == torch.float64 else torch.float32
    s, n_out = t.shape
    col = torch.arange(n_out, device=x.device)
    p_trg = torch.where(t.to(edt) == 1.0, col, torch.zeros_like(col)).amax(1)
    acts = _forward(w, x, kind, edt)
    ep = _err(acts[-1], t, kind, edt)
    init_err = ep
    live = torch.ones(s, dtype=torch.bool, device=x.device)
    n_it = torch.zeros(s, dtype=torch.int64, device=x.device)
    dep = torch.zeros(s, dtype=edt, device=x.device)
    ok_raw = torch.zeros(s, dtype=torch.bool, device=x.device)
    first_ok = torch.zeros_like(ok_raw)
    it = 0
    while bool(live.any()):
        it += 1
        o = acts[-1]
        d = t - o if kind in (SNN, LNN) else (t - o) * ann_dact(o)
        ds = [d]
        for l in range(len(w) - 1, 0, -1):
            ds.insert(0, _mv_t(ds[0], w[l]) * ann_dact(acts[l - 1]))
        hs = (x, *acts[:-1])
        for l in range(len(w)):
            # dead lanes drop out: their delta rows are zero in the sum
            dm = torch.where(live[:, None], ds[l], torch.zeros_like(ds[l]))
            step = lr * _upd(dm, hs[l])
            if momentum:
                # dw += lr*g; W += dw; dw *= alpha (ann.c:1996-1999)
                if add_dt is not None:
                    step = dw[l] + step.to(add_dt)
                    w[l] = (w[l].to(add_dt) + step).to(w[l].dtype)
                else:
                    step = dw[l] + step
                    w[l] = w[l] + step
                dw[l] = alpha * step
            elif add_dt is not None:
                w[l] = (w[l].to(add_dt) + step.to(add_dt)).to(w[l].dtype)
            else:
                w[l] = w[l] + step
        acts = _forward(w, x, kind, edt)
        epr = _err(acts[-1], t, kind, edt)
        dep_new = ep - epr
        if kind == LNN:
            okr = torch.ones_like(live)
        else:
            okr = torch.argmax(acts[-1].to(edt), dim=1) == p_trg
        n_it = torch.where(live, it, n_it)
        dep = torch.where(live, dep_new, dep)
        ok_raw = torch.where(live, okr, ok_raw)
        if it == 1:
            first_ok = torch.where(live, okr, first_ok)
        live = live & (it <= max_iter) & (
            (dep_new > delta) | ~(okr & (it > min_iter)))
        ep = epr
    return torch.stack([init_err.double(), first_ok.double(), n_it.double(),
                        dep.double(), (ok_raw & (n_it > min_iter)).double()],
                       dim=1)


@torch.inference_mode()
def train_epoch_tiled_plain(weights, xs, ts, kind: str, momentum: bool,
                            alpha=0.2, delta=-1.0, lr=None, tile: int = 8,
                            storage: str | None = None, max_iter=None,
                            start_group=0, group_budget=INT32_MAX,
                            stats_prev=None):
    """The kernel's plain version, on any device: groups start_group ..
    start_group + group_budget - 1 of ``tile`` rows each, every group
    trained to convergence in lockstep.  Returns (weights in the resident
    dtype, stats (S, 5) float64: init_err, first_ok, n_iter, final_dep,
    success; rows of groups outside the launch as given, n_iter = -1 when
    none were given)."""
    lr, delta, min_iter, max_iter = resolve_hyper(kind, momentum, lr, delta,
                                                  max_iter)
    w = list(resident_weights(weights, xs.dtype, storage))
    add_dt = _accum_dtype(storage)
    stats = _stats_init(stats_prev, xs.shape[0], xs.device)
    g_end = min(n_groups(xs.shape[0], tile),
                start_group + max(0, int(group_budget)))
    for g in range(start_group, g_end):
        lo, hi = g * tile, min((g + 1) * tile, xs.shape[0])
        # momentum zeroes at group entry (ann_raz_momentum, ann.c:2391)
        dw = ([torch.zeros(v.shape, dtype=add_dt or v.dtype,
                           device=v.device) for v in w]
              if momentum else None)
        stats[lo:hi] = _group_plain(w, dw, xs[lo:hi], ts[lo:hi], kind,
                                    momentum, lr, alpha, min_iter, max_iter,
                                    delta, add_dt)
    return tuple(w), stats


def _group_mesh(w, dw, blocks, home, kind, momentum, lr, alpha, min_iter,
                max_iter, delta, add_dt):
    """One group trained to convergence in lockstep with its lanes split
    over data shards: ``blocks`` holds each shard's real lanes as (x, t)
    on its device (masked lanes are absent: they never train).  Every
    shard forms the forward and the deltas of its lanes against its copy
    of the weights; the per-layer ``d^T h`` partials are added in shard
    order on ``home``, where ``w`` (and ``dw``) update in place, then the
    copies are refreshed; the group runs while a lane of any shard lives.
    A shard whose lanes are all dead drops out (its partials would be
    zero).  Returns the (S, 5) float64 stats rows of the real lanes, in
    lane order, on ``home``."""
    x0 = blocks[0][0]
    edt = torch.float64 if x0.dtype == torch.float64 else torch.float32
    devs = [x.device for x, _ in blocks]
    copies = {d: list(w) if d == home else [v.to(d) for v in w]
              for d in dict.fromkeys(devs)}
    st = []
    for x, t in blocks:
        s, n_out = t.shape
        col = torch.arange(n_out, device=x.device)
        acts = _forward(copies[x.device], x, kind, edt)
        ep = _err(acts[-1], t, kind, edt)
        z = torch.zeros(s, dtype=torch.bool, device=x.device)
        st.append({"p_trg": torch.where(t.to(edt) == 1.0, col,
                                        torch.zeros_like(col)).amax(1),
                   "acts": acts, "ep": ep, "init": ep, "live": ~z,
                   "n_it": torch.zeros(s, dtype=torch.int64,
                                       device=x.device),
                   "dep": torch.zeros(s, dtype=edt, device=x.device),
                   "ok_raw": z, "first_ok": z.clone()})
    it, n = 0, len(w)
    alive = list(range(len(blocks)))      # shards with a live lane
    while alive:
        it += 1
        parts = []
        for i in alive:
            (x, t), b = blocks[i], st[i]
            wb, acts = copies[x.device], b["acts"]
            o = acts[-1]
            d = t - o if kind in (SNN, LNN) else (t - o) * ann_dact(o)
            ds = [d]
            for l in range(n - 1, 0, -1):
                ds.insert(0, _mv_t(ds[0], wb[l]) * ann_dact(acts[l - 1]))
            hs = (x, *acts[:-1])
            live = b["live"][:, None]
            parts.append([_upd(torch.where(live, ds[l],
                                           torch.zeros_like(ds[l])), hs[l])
                          for l in range(n)])
        for l in range(n):
            g = parts[0][l].to(home)
            for p in parts[1:]:
                g = g + p[l].to(home)
            step = lr * g
            if momentum:
                if add_dt is not None:
                    step = dw[l] + step.to(add_dt)
                    w[l] = (w[l].to(add_dt) + step).to(w[l].dtype)
                else:
                    step = dw[l] + step
                    w[l] = w[l] + step
                dw[l] = alpha * step
            elif add_dt is not None:
                w[l] = (w[l].to(add_dt) + step.to(add_dt)).to(w[l].dtype)
            else:
                w[l] = w[l] + step
        copies = {d: list(w) if d == home else [v.to(d) for v in w]
                  for d in dict.fromkeys(blocks[i][0].device for i in alive)}
        flags = []
        for i in alive:
            (x, t), b = blocks[i], st[i]
            acts = _forward(copies[x.device], x, kind, edt)
            epr = _err(acts[-1], t, kind, edt)
            dep_new = b["ep"] - epr
            live = b["live"]
            if kind == LNN:
                okr = torch.ones_like(live)
            else:
                okr = torch.argmax(acts[-1].to(edt), dim=1) == b["p_trg"]
            b["n_it"] = torch.where(live, it, b["n_it"])
            b["dep"] = torch.where(live, dep_new, b["dep"])
            b["ok_raw"] = torch.where(live, okr, b["ok_raw"])
            if it == 1:
                b["first_ok"] = torch.where(live, okr, b["first_ok"])
            b["live"] = live & (it <= max_iter) & (
                (dep_new > delta) | ~(okr & (it > min_iter)))
            b["acts"], b["ep"] = acts, epr
            flags.append(b["live"].any().to(home))
        # the stop test spans every lane: one host read an iteration
        alive = [i for i, f in zip(alive, torch.stack(flags).tolist())
                 if f]
    rows = [torch.stack([b["init"].double(), b["first_ok"].double(),
                         b["n_it"].double(), b["dep"].double(),
                         (b["ok_raw"] & (b["n_it"] > min_iter)).double()],
                        dim=1).to(home) for b in st]
    return torch.cat(rows)


@torch.inference_mode()
def train_epoch_tiled_mesh(weights, xs, ts, kind: str, momentum: bool, mesh,
                           alpha=0.2, delta=-1.0, lr=None, tile: int = 8,
                           storage: str | None = None, max_iter=None):
    """The batched-tile epoch over the N data shards of ``mesh`` (an N x 1
    ``parallel.mesh.LocalGrid``): groups of ``tile`` samples, each padded
    to ``lane_tile = ceil(tile / N) * N`` lanes with masked lanes that
    never train, shard d owning lanes ``[d * lane_tile / N, (d + 1) *
    lane_tile / N)`` (the JAX package's ``dp_tiled_epoch`` under a mesh).
    Each lockstep iteration: every shard the forward and deltas of its own
    lanes against replicated weights, ``d^T h`` summed over the shards,
    the stop test over every lane.  Returns (weights in the resident dtype
    on the first shard's device, stats (S, 5) float64 there)."""
    lr, delta, min_iter, max_iter = resolve_hyper(kind, momentum, lr, delta,
                                                  max_iter)
    devs = mesh.data_devices()
    home = devs[0]
    w = [v.to(home) for v in resident_weights(weights, xs.dtype, storage)]
    add_dt = _accum_dtype(storage)
    s = xs.shape[0]
    rows = {d: (xs.to(d), ts.to(d)) for d in dict.fromkeys(devs)}
    stats = _stats_init(None, s, home)
    lane = -(-tile // len(devs))          # lanes a shard: lane_tile / N
    for g in range(n_groups(s, tile)):
        base, end = g * tile, min((g + 1) * tile, s)
        blocks = []
        for d, dev in enumerate(devs):
            lo, hi = base + d * lane, min(base + (d + 1) * lane, end)
            if lo < hi:
                x, t = rows[dev]
                blocks.append((x[lo:hi], t[lo:hi]))
        dw = ([torch.zeros(v.shape, dtype=add_dt or v.dtype, device=home)
               for v in w] if momentum else None)
        stats[base:end] = _group_mesh(w, dw, blocks, home, kind, momentum,
                                      lr, alpha, min_iter, max_iter, delta,
                                      add_dt)
    return tuple(w), stats


def train_epoch_tiled(weights, xs, ts, kind: str, momentum: bool,
                      alpha=0.2, delta=-1.0, lr=None, tile: int = 8,
                      storage: str | None = None, launch_groups: int = 0,
                      max_iter=None, defer_stats=False):
    """Call-compatible with ``ops.convergence.train_epoch``: groups of
    ``tile`` samples trained to convergence with per-lane masking (module
    docstring).  Returns (weights in the resident dtype, SampleStats), or
    with ``defer_stats`` the (S, 5) float64 record on the tensors' device
    in place of SampleStats (no host synchronisation).

    CUDA tensors run in the hand-written ``train_tile`` kernel, CPU
    tensors in its plain version.  ``launch_groups`` splits the epoch into
    launches of that many groups, the weights carrying from launch to
    launch (the trajectory equals one launch bit for bit); 0 is one
    launch."""
    from .convergence_tile_kernel import train_tile

    tile = max(1, int(tile))
    s = xs.shape[0]
    g = n_groups(s, tile)
    chunk = int(launch_groups) if launch_groups and launch_groups > 0 else g
    w, stats, lo = weights, None, 0
    while lo < g or stats is None:
        w, stats = train_tile(w, xs, ts, kind, momentum, alpha=alpha,
                              delta=delta, lr=lr, tile=tile, storage=storage,
                              max_iter=max_iter, start_group=lo,
                              group_budget=chunk, stats_prev=stats)
        lo += chunk
    return w, stats if defer_stats else stats_record(stats, xs.dtype)
