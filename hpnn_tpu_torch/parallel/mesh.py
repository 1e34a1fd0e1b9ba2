"""The device grids of the data and model axes, and the flat
optimizer-state layout.

The port of the JAX package's ``parallel/mesh.py``.  The JAX package
builds one ``jax.sharding.Mesh`` over ``jax.devices()`` -- every device
of every process, process-major -- (or a thread's pinned slice) and lets
GSPMD place the collectives; the port builds the same (data x model) grid
and makes its collectives explicit.  No GSPMD emulation is built.  One
class, :class:`Grid`, holds it: global shard g is (g // n_model,
g % n_model) over the world's devices in process order, and a rank holds
its own run of them.  Its collectives do the local part in shard order
and cross ranks (gloo or NCCL) only for the groups that span them.  At
world 1 (:data:`LocalGrid`, the same class) a device may repeat, so N
shards can share one card (they then run in turn); :class:`LocalMesh`
(1 x K, the row blocks of the serving tier and of ``[model]``) and
:class:`DataMesh` (N x 1, the ``fast@meshN`` tier and ``[batch]``) are
its two one-axis cases.

:func:`make_mesh` builds the run's grid; :func:`data_mesh` the serving
tier's DataMesh.

The flat layout (arXiv:2004.13336, as in the JAX package): the update
state of a data-parallel run -- BPM momentum, the master weights, the CG
vectors -- is one vector, zero-padded to a multiple of the data shards,
of which each data shard updates a contiguous 1/N slice.  Every
operation on it is value-preserving (concatenate, pad, slice, reshape),
so the flat trajectory equals the per-layer one bit for bit.

The row-sharding half (``[model]``, ``parallel.tp``): the zero padding
that lets k row blocks divide every hidden layer (:func:`pad_topology`)
and the per-layer placement rule (:func:`layer_sharding`).
"""

from __future__ import annotations

import numpy as np
import torch



def flatten_state(tree, pad_to: int = 1) -> torch.Tensor:
    """Per-layer tensors -> one flat vector, zero-padded to a multiple of
    ``pad_to`` so the world divides it evenly."""
    flat = torch.cat([w.reshape(-1) for w in tree])
    pad = (-flat.shape[0]) % max(1, int(pad_to))
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat


def unflatten_state(flat: torch.Tensor, shapes):
    """Flat vector (padding tail ignored) -> per-layer views with the given
    ``shapes``; a leading batch dimension (probes, ``(P, total)``) is
    kept."""
    out, lo = [], 0
    lead = flat.shape[:-1]
    for sh in shapes:
        n = int(np.prod(sh))
        out.append(flat[..., lo:lo + n].reshape(*lead, *sh))
        lo += n
    return tuple(out)


def shard_bounds(n: int, world: int, rank: int) -> tuple[int, int]:
    """This rank's contiguous ``[lo, hi)`` of ``n`` items that the world
    divides: a slice of a flat vector (pad it with :func:`flatten_state`
    first), or a rank's share of a batch's slots (the JAX package's
    ``P(None, "data")`` row sharding)."""
    if n % max(1, world):
        raise ValueError(f"length {n} is not padded to the world ({world})")
    c = n // max(1, world)
    return rank * c, (rank + 1) * c


def per_device_bytes(arrays) -> int:
    """The bytes this process's device holds for ``arrays`` (tensors; a
    rank holds only its own slices, so this is the per-device footprint,
    measured rather than derived from the layout)."""
    return int(sum(a.numel() * a.element_size() for a in arrays
                   if isinstance(a, torch.Tensor)))


# --- row sharding ------------------------------------------------------------

def pad_topology(weights, k: int):
    """Zero-pad hidden layer widths up to multiples of ``k`` so k row
    blocks divide them: zero rows, and the matching zero columns of the
    next layer.  A padded neuron's pre-activation is 0, ``ann_act(0)`` is
    0 and its outbound column is zero, so it adds nothing forward; its
    delta is ``(W_next^T d)[pad] * dact(0) = 0``, so BP and BPM never move
    it: the padding stays zero under training.  The output layer is never
    padded (an SNN softmax would count a padded logit).  Returns
    ``(padded, original_row_dims)``; every value is copied bit for bit."""
    orig = [int(w.shape[0]) for w in weights]
    padded, prev_pad = [], 0
    last = len(weights) - 1
    for i, w in enumerate(weights):
        if prev_pad:
            w = torch.cat([w, w.new_zeros((w.shape[0], prev_pad))], dim=1)
        prev_pad = 0
        if i < last:
            prev_pad = (-w.shape[0]) % k
            if prev_pad:
                w = torch.cat([w, w.new_zeros((prev_pad, w.shape[1]))])
        padded.append(w.contiguous())
    return tuple(padded), orig


def unpad_topology(weights, orig_dims):
    """Undo :func:`pad_topology`: rows to the original widths, columns to
    the previous layer's original width."""
    out = []
    for i, w in enumerate(weights):
        m = w.shape[1] if i == 0 else orig_dims[i - 1]
        out.append(w[:orig_dims[i], :m])
    return tuple(out)


def layer_sharding(w, k: int) -> str:
    """``"rows"`` when the layer's row count divides the model axis (each
    shard holds a row block), else ``"replicated"`` (the unpadded output
    layer, typically)."""
    return "rows" if w.shape[0] % max(1, k) == 0 else "replicated"


def tp_device_count(n_visible: int) -> int:
    """The serving tier's model-axis width: ``HPNN_TP_DEVICES`` capped to
    the visible devices with the JAX package's warning; unset means 1 (no
    row-sharded tier).  Training takes its width from ``[model]``,
    ``--model-parallel`` or ``-S`` instead."""
    from ..utils.env import env_device_cap

    return env_device_cap("HPNN_TP_DEVICES", n_visible, default=1)


class _Done:
    """A finished transfer: ``wait()`` gives its tensors."""

    def __init__(self, parts):
        self.parts = parts

    def wait(self):
        return self.parts


class _Pending:
    """An issued ring step: ``wait()`` completes its point-to-point
    operations and gives every local shard's received tensor (the sent
    ones are held until then)."""

    def __init__(self, reqs, out, recv, devices, sent):
        self.reqs, self.out, self.recv = reqs, out, recv
        self.devices, self._sent = devices, sent

    def wait(self):
        for r in self.reqs:
            r.wait()
        for p, buf in self.recv:
            self.out[p] = buf.to(self.devices[p])
        self._sent = None
        return self.out


class Grid:
    """The (data x model) grid over the devices of every rank: global
    shard g is (g // n_model, g % n_model), the ranks' devices in process
    order (rank r holds ``counts[r]`` consecutive shards from the sum of
    the counts before it), as the JAX package reshapes ``jax.devices()``.
    This rank's shards are on ``devices`` (repeats allowed: N shards may
    share one card, and then run in turn); ``local[p]`` is local shard p's
    model index, ``local_data[p]`` the index of its data shard among this
    rank's (``data_ids``, global).

    A collective takes one tensor for every local shard (all of one shape
    and dtype) and returns one for every local shard: ``gather``, ``psum``
    and ``shift`` act within each model group, ``psum_data`` and
    ``gather_data`` over the data shards of each model index, in shard
    order.  Each first collects its groups' members: this rank's own
    tensors, then, for each set of ranks a group spans, one all-gather of
    those ranks' stacked tensors over their process group (made once a
    layout, at the first collective that needs one; NCCL on cards, on
    this rank's first card, gloo on the CPU).  A sum is then formed in
    shard order on the first summand's device and copied to every shard's,
    so a sum's bits do not depend on how the shards fall over the ranks.
    At world 1 every group is local and nothing crosses a process."""

    def __init__(self, n_data: int, n_model: int, devices, rank: int = 0,
                 counts=None, coll_device=None):
        self.devices = tuple(torch.device(d) for d in devices)
        self.n_data, self.n_model = int(n_data), int(n_model)
        self.counts = ((len(self.devices),) if counts is None
                       else tuple(int(c) for c in counts))
        self.rank = int(rank)
        n = self.n_data * self.n_model
        if self.n_data < 1 or self.n_model < 1 or not self.devices \
                or sum(self.counts) != n \
                or self.counts[self.rank] != len(self.devices):
            raise ValueError(f"a {n_data}x{n_model} grid needs "
                             f"{max(1, int(n_data) * int(n_model))} "
                             f"device(s); {len(self.devices)} given")
        self.base = sum(self.counts[:self.rank])
        self._owner = [r for r, c in enumerate(self.counts)
                       for _ in range(c)]
        self._offset = [sum(self.counts[:r]) for r in range(len(self.counts))]
        self._groups = None       # made at the first cross-rank collective
        self._cdev = coll_device
        k = self.n_model
        mine = range(self.base, self.base + len(self.devices))
        self.local = tuple(g % k for g in mine)
        self.data_ids = tuple(dict.fromkeys(g // k for g in mine))
        self.local_data = tuple(self.data_ids.index(g // k) for g in mine)

    def device_of(self, p: int) -> torch.device:
        """Local shard p's device."""
        return self.devices[p]

    def data_devices(self) -> tuple[torch.device, ...]:
        """Each local data shard's first device (where its rows land)."""
        return tuple(self.devices[self.local_data.index(j)]
                     for j in range(len(self.data_ids)))

    def distinct(self) -> tuple[torch.device, ...]:
        """The shards' devices, each once, in shard order."""
        return tuple(dict.fromkeys(self.devices))

    def _model_members(self, g: int) -> range:
        lo = (g // self.n_model) * self.n_model
        return range(lo, lo + self.n_model)

    def _data_members(self, g: int) -> range:
        return range(g % self.n_model, self.n_data * self.n_model,
                     self.n_model)

    def _is_local(self, g: int) -> bool:
        return self._owner[g] == self.rank

    def _collect(self, parts, members) -> dict:
        """Global shard -> tensor, for every member of each local shard's
        group.  The spans are visited in one global order, so every rank
        meets its peers' all-gathers in the same sequence."""
        have = {self.base + p: t for p, t in enumerate(parts)}
        spans = sorted({tuple(sorted({self._owner[q] for q in members(g)}))
                        for g in have})
        for ranks in spans:
            if len(ranks) == 1:
                continue
            from . import coord

            if self._groups is None:
                self._groups = _rank_groups(self)
            width = max(self.counts[r] for r in ranks)
            rows = [t.to(self._cdev) for t in parts]
            rows += [torch.zeros_like(rows[0])] * (width - len(rows))
            mine = torch.stack(rows)
            got = [torch.empty_like(mine) for _ in ranks]
            coord._dist().all_gather(got, mine, group=self._groups[ranks])
            for r, block in zip(ranks, got):
                if r != self.rank:
                    for q in range(self.counts[r]):
                        have[self._offset[r] + q] = block[q]
        return have

    def gather(self, parts, only=None):
        """Each model group's tensors concatenated along the last dim in
        shard order, on each shard's device (on the local shards ``only``
        names)."""
        return self._concat(parts, self._model_members, only)

    def gather_data(self, parts, only=None):
        """The data shards' tensors of each model index concatenated along
        the last dim in data shard order (a flat vector's slices whole
        again), on each shard's device (on the shards ``only`` names)."""
        return self._concat(parts, self._data_members, only)

    def _concat(self, parts, members, only):
        have = self._collect(parts, members)
        pos = range(len(parts)) if only is None else only
        return [torch.cat([have[q].to(self.devices[p])
                           for q in members(self.base + p)], dim=-1)
                for p in pos]

    def _sum_over(self, parts, members):
        have = self._collect(parts, members)
        out, sums = [], {}
        for p in range(len(parts)):
            g = tuple(members(self.base + p))
            tot = sums.get(g)
            if tot is None:
                tot = have[g[0]]
                for q in g[1:]:
                    tot = tot + have[q].to(tot.device)
                sums[g] = tot
            out.append(tot.to(self.devices[p]))
        return out

    def psum(self, parts):
        """Each model group's tensors summed in shard order, on each
        shard's device."""
        return self._sum_over(parts, self._model_members)

    def psum_data(self, parts):
        """The data shards' tensors of each model index summed in data
        shard order, on each shard's device."""
        return self._sum_over(parts, self._data_members)

    def shift(self, parts):
        """The ring step: within each model group, shard m receives shard
        (m + 1) mod K's tensor: a copy from a local shard, else one
        point-to-point receive, and a send to each remote predecessor, as
        one batch of point-to-point operations."""
        k = self.n_model
        out, recv, ops, sent = [None] * len(parts), [], [], []
        for p, t in enumerate(parts):
            d, m = divmod(self.base + p, k)
            src, dst = d * k + (m + 1) % k, d * k + (m - 1) % k
            if self._is_local(src):
                out[p] = parts[src - self.base].to(self.devices[p],
                                                   non_blocking=True)
            else:
                buf = torch.empty_like(t, device=self._cdev)
                recv.append((p, buf))
                ops.append((False, buf, self._owner[src]))
            if not self._is_local(dst):
                sent.append(t.to(self._cdev).contiguous())
                ops.append((True, sent[-1], self._owner[dst]))
        if not ops:
            return _Done(out)
        from . import coord

        dist = coord._dist()
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend if send else dist.irecv, t, peer)
            for send, t, peer in ops])
        return _Pending(reqs, out, recv, self.devices, sent)

    def gather_rows(self, parts):
        """The row blocks of the first local shard's model group stacked
        in shard order, on the CPU (every group holds the same
        weights)."""
        have = self._collect(parts, self._model_members)
        return torch.cat([have[q].to("cpu")
                          for q in self._model_members(self.base)])


# the world-1 case keeps its name: one process's devices
LocalGrid = Grid


class LocalMesh(Grid):
    """A 1 x K model axis of one process: shard i's row blocks live on
    ``devices[i]`` (the ``tp@K`` serving tier, ``[model] K`` at world
    1)."""

    def __init__(self, devices):
        devices = tuple(devices)
        if not devices:
            raise ValueError("LocalMesh needs at least one device")
        super().__init__(1, len(devices), devices)


class DataMesh(Grid):
    """An N x 1 data axis of one process: shard i's rows run on
    ``devices[i]`` (the ``fast@meshN`` serving tier, ``[batch]`` at world
    1).  Weights are replicated on every shard's device."""

    def __init__(self, devices):
        devices = tuple(devices)
        if not devices:
            raise ValueError("DataMesh needs at least one device")
        super().__init__(len(devices), 1, devices)


def data_mesh(n_devices: int | None = -1, device="cuda") -> DataMesh | None:
    """The serving data mesh, or None when the request cannot shard.

    ``None`` or a negative count takes every visible card; an explicit
    count is capped to them (``torch.cuda.device_count()``, one device on
    the CPU), and 0 or fewer than two devices after the cap is no mesh.
    The count is then floored to a power of two, with the JAX package's
    warning: buckets are powers of two and shard only when the count
    divides them, so a 6-device mesh would never be used."""
    dev = torch.device(device)
    avail = torch.cuda.device_count() if dev.type == "cuda" else 1
    n = (avail if n_devices is None or int(n_devices) < 0
         else min(int(n_devices), avail))
    if n < 2:
        return None
    pow2 = 1 << (n.bit_length() - 1)
    if pow2 != n:
        from ..utils.nn_log import nn_warn

        nn_warn(f"serve: data mesh floored from {n} to {pow2} devices "
                "(power-of-two batch buckets only shard over "
                "power-of-two device counts)\n")
        n = pow2
    return DataMesh([torch.device("cuda", i) for i in range(n)])


_MESHES: dict = {}


def make_mesh(n_data: int | None = None, n_model: int = 1, device=None,
              devices=None):
    """The (data x model) :class:`Grid` of this run over ``devices``, this
    rank's devices in order (``device`` alone by default).

    At world 1 the grid takes the first ``n_data * n_model`` of them
    (``n_data`` defaults to 1).  Across processes it takes the first
    ``n_data * n_model`` of the world's devices, process-major, every rank
    holding as many as this one (which the agreement gates hold);
    ``n_data`` defaults to all of them over ``n_model``.  A grid wider
    than the devices, or one that leaves a rank without a shard, is
    refused (``ValueError``).  Across processes the process groups of the
    sets of ranks that a group spans are made once a layout, on every rank
    in the same order, at the grid's first collective, and reused."""
    from . import coord

    world, rank = coord.world_size(), coord.process_index()
    n_model = max(1, int(n_model))
    devices = [_default_device(device)] if devices is None else list(devices)
    held = len(devices)
    total = world * held
    if n_data is None:
        n_data = max(1, total // n_model) if world > 1 else 1
    n_data = max(1, int(n_data))
    n = n_data * n_model
    if n > total:
        raise ValueError(f"a {n_data}x{n_model} grid needs {n} "
                         f"devices; {total} were named")
    # the shards each rank holds of the first n devices, process-major
    counts = tuple(min(held, max(0, n - r * held)) for r in range(world))
    if 0 in counts:
        raise ValueError(f"a {n_data}x{n_model} grid over the first {n} of "
                         f"{total} devices leaves process "
                         f"{counts.index(0)} without a shard")
    if world == 1:
        return Grid(n_data, n_model, devices[:n])
    return Grid(n_data, n_model, devices[:counts[rank]], rank, counts,
                coord._collective_device())


def _rank_groups(grid) -> dict:
    """The process group of every set of ranks that one of ``grid``'s
    groups spans (made on every rank in one order, once a layout)."""
    from . import coord

    key = (grid.n_data, grid.n_model, grid.counts)
    groups = _MESHES.get(key)
    if groups is None:
        spans = set()
        for g in range(grid.n_data * grid.n_model):
            for members in (grid._model_members(g), grid._data_members(g)):
                ranks = tuple(sorted({grid._owner[q] for q in members}))
                if len(ranks) > 1:
                    spans.add(ranks)
        dist = coord._dist()
        groups = _MESHES[key] = {r: dist.new_group(list(r))
                                 for r in sorted(spans)}
    return groups


def _default_device(device):
    if device is None:
        from ..runtime import lib_runtime

        device = lib_runtime.device or torch.device("cpu")
    return torch.device(device)


def forget_meshes() -> None:
    """Drop the cached meshes (their groups die with the process group)."""
    _MESHES.clear()


__all__ = ["DataMesh", "Grid", "LocalGrid", "LocalMesh", "data_mesh",
           "flatten_state", "unflatten_state", "shard_bounds",
           "per_device_bytes", "pad_topology", "unpad_topology",
           "layer_sharding", "make_mesh", "forget_meshes",
           "tp_device_count"]
