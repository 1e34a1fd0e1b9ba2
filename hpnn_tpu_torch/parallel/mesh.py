"""The device grids of the data and model axes, and the flat
optimizer-state layout.

The port of the JAX package's ``parallel/mesh.py``.  The JAX package
builds one ``jax.sharding.Mesh`` over the devices a process sees (or a
thread's pinned slice) and lets GSPMD place the collectives; the port
builds the same (data x model) grid and makes its collectives explicit.
No GSPMD emulation is built.  Two grids answer one interface:

* :class:`LocalGrid`, the devices of one process (a run at world 1):
  shard (d, m) lives on ``devices[d * n_model + m]``, the model axis
  inner as the JAX package's ``make_mesh`` reshapes its devices.  A
  device may repeat, so N shards can share one card (they then run in
  turn).  Its collectives are copies between the shards' devices.
  :class:`LocalMesh` (1 x K, the row blocks of the serving tier and of
  ``[model]``) and :class:`DataMesh` (N x 1, the ``fast@meshN`` tier and
  ``[batch]``) are its two one-axis cases.
* :class:`RankMesh`, the ``torch.distributed`` world (``HPNN_DISTRIBUTED``),
  one rank a device: rank r is shard (r // n_model, r % n_model).  Its
  collectives are gloo or NCCL calls.

Both hold a tuple of local shards (every shard of a LocalGrid, one of a
RankMesh): ``local[p]`` is local shard p's model index and
:meth:`device_of` its device.  A collective takes one tensor for every
local shard and returns one for every local shard: ``gather``, ``psum``
and ``shift`` act within each model group, ``psum_data`` over the data
shards of each model index, in shard order.

:func:`make_mesh` returns a LocalGrid at world 1 and the RankMesh at
world > 1; :func:`data_mesh` the serving tier's DataMesh.

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


class LocalGrid:
    """The (data x model) grid of one process: shard (d, m) on
    ``devices[d * n_model + m]`` (repeats allowed).  Every shard is local;
    the collectives are copies between the shards' devices, each sum
    formed in shard order on the first summand's device and copied to
    every shard's."""

    def __init__(self, n_data: int, n_model: int, devices):
        self.devices = tuple(torch.device(d) for d in devices)
        self.n_data, self.n_model = int(n_data), int(n_model)
        if self.n_data < 1 or self.n_model < 1 \
                or len(self.devices) != self.n_data * self.n_model:
            raise ValueError(f"a {n_data}x{n_model} grid needs "
                             f"{max(1, int(n_data) * int(n_model))} "
                             f"device(s); {len(self.devices)} given")
        k = self.n_model
        self.local = tuple(p % k for p in range(len(self.devices)))
        self.local_data = tuple(p // k for p in range(len(self.devices)))

    def device_of(self, p: int) -> torch.device:
        """Local shard p's device."""
        return self.devices[p]

    def data_devices(self) -> tuple[torch.device, ...]:
        """Each data shard's first device (where its rows land)."""
        return self.devices[::self.n_model]

    def distinct(self) -> tuple[torch.device, ...]:
        """The shards' devices, each once, in shard order."""
        return tuple(dict.fromkeys(self.devices))

    def _group(self, p: int) -> range:
        lo = (p // self.n_model) * self.n_model
        return range(lo, lo + self.n_model)

    def gather(self, parts, only=None):
        """Each model group's tensors concatenated along the last dim in
        shard order, on each shard's device (on the shards ``only``
        names)."""
        pos = range(len(parts)) if only is None else only
        return [torch.cat([parts[q].to(self.devices[p])
                           for q in self._group(p)], dim=-1) for p in pos]

    def _sum_over(self, parts, groups):
        out = [None] * len(parts)
        for g in groups:
            tot = parts[g[0]]
            for q in g[1:]:
                tot = tot + parts[q].to(tot.device)
            for q in g:
                out[q] = tot.to(self.devices[q])
        return out

    def psum(self, parts):
        """Each model group's tensors summed in shard order, on each
        shard's device."""
        k = self.n_model
        return self._sum_over(parts, [range(d * k, (d + 1) * k)
                                      for d in range(self.n_data)])

    def psum_data(self, parts):
        """The data shards' tensors of each model index summed in data
        shard order, on each shard's device."""
        k = self.n_model
        return self._sum_over(parts, [range(m, len(parts), k)
                                      for m in range(k)])

    def shift(self, parts):
        """The ring step: within each model group, shard m receives shard
        (m + 1) mod K's tensor."""
        k = self.n_model
        return _Done([parts[(p - p % k) + (p % k + 1) % k].to(
            self.devices[p], non_blocking=True) for p in range(len(parts))])

    def gather_rows(self, parts):
        """The first model group's row blocks stacked in shard order, on
        the CPU (every group holds the same weights)."""
        return torch.cat([p.to("cpu") for p in parts[:self.n_model]])


class LocalMesh(LocalGrid):
    """A 1 x K model axis of one process: shard i's row blocks live on
    ``devices[i]`` (the ``tp@K`` serving tier, ``[model] K`` at world
    1)."""

    def __init__(self, devices):
        devices = tuple(devices)
        if not devices:
            raise ValueError("LocalMesh needs at least one device")
        super().__init__(1, len(devices), devices)


class DataMesh(LocalGrid):
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


class RankMesh:
    """The (data x model) grid over the ``torch.distributed`` world, one
    rank a device: rank r is data shard ``r // n_model`` and model shard
    ``r % n_model``.  Built by :func:`make_mesh`, which creates every model
    group and every data group on every rank in the same order."""

    def __init__(self, n_data: int, n_model: int, rank: int, device,
                 model_group=None, data_group=None):
        self.n_data, self.n_model = int(n_data), int(n_model)
        self.rank = int(rank)
        self.data_index = self.rank // self.n_model
        self.model_index = self.rank % self.n_model
        self.local = (self.model_index,)
        self.local_data = (0,)            # one data shard: this rank's
        self.devices = (torch.device(device),)
        self.model_group, self.data_group = model_group, data_group
        base = self.data_index * self.n_model
        self.model_ranks = tuple(base + m for m in range(self.n_model))

    def device_of(self, p: int) -> torch.device:
        return self.devices[0]

    def _dist(self):
        import torch.distributed as dist

        return dist

    def _all_gather(self, t, dim: int):
        """The model group's tensors concatenated along ``dim`` in shard
        order."""
        if self.n_model == 1:
            return t
        src = t.contiguous()
        out = [torch.empty_like(src) for _ in range(self.n_model)]
        self._dist().all_gather(out, src, group=self.model_group)
        return torch.cat(out, dim=dim)

    def gather(self, parts, only=None):
        return [self._all_gather(parts[0], -1)]

    def psum(self, parts):
        (t,) = parts
        if self.n_model == 1:
            return [t]
        t = t.clone()
        self._dist().all_reduce(t, group=self.model_group)
        return [t]

    def psum_data(self, parts):
        (t,) = parts
        if self.n_data == 1:
            return [t]
        t = t.clone()
        self._dist().all_reduce(t, group=self.data_group)
        return [t]

    def shift(self, parts):
        """The ring step: send this shard's tensor to model shard
        (m - 1) mod K and receive shard (m + 1) mod K's, as one batch of
        point-to-point operations (the peers are global ranks)."""
        (t,) = parts
        dist = self._dist()
        k, m = self.n_model, self.model_index
        src = t.contiguous()
        buf = torch.empty_like(src)
        ops = [dist.P2POp(dist.isend, src, self.model_ranks[(m - 1) % k],
                          group=self.model_group),
               dist.P2POp(dist.irecv, buf, self.model_ranks[(m + 1) % k],
                          group=self.model_group)]
        return _Pending(dist.batch_isend_irecv(ops), buf, src)

    def gather_rows(self, parts):
        return self._all_gather(parts[0], 0).to("cpu")


class _Pending:
    """An issued ring step: ``wait()`` completes it and gives the received
    tensor (the sent one is held until then)."""

    def __init__(self, reqs, buf, src):
        self.reqs, self.buf, self._src = reqs, buf, src

    def wait(self):
        for r in self.reqs:
            r.wait()
        self._src = None
        return [self.buf]


_MESHES: dict = {}


def make_mesh(n_data: int | None = None, n_model: int = 1, device=None,
              devices=None):
    """The (data x model) grid of this run.

    At world 1 a :class:`LocalGrid` over the first ``n_data * n_model`` of
    ``devices`` (``n_data`` defaults to 1); a grid of one shard may name
    ``device`` instead.  A grid wider than the devices named is refused
    (``ValueError``): nothing shards onto devices it was not given.

    At world > 1 the :class:`RankMesh` of the world, one rank a device:
    ``n_data`` defaults to the world over ``n_model``, and the grid must
    cover the world (a rank outside it would have nothing to compute).
    Its groups are made once a world and layout and reused."""
    from . import coord

    world, rank = coord.world_size(), coord.process_index()
    n_model = max(1, int(n_model))
    if world == 1:
        n_data = max(1, int(n_data or 1))
        n = n_data * n_model
        if devices is None:
            if n > 1:
                raise ValueError(f"a {n_data}x{n_model} grid needs {n} "
                                 "devices; none were named")
            devices = [_default_device(device)]
        devices = list(devices)
        if len(devices) < n:
            raise ValueError(f"a {n_data}x{n_model} grid needs {n} "
                             f"devices; {len(devices)} were named")
        return LocalGrid(n_data, n_model, devices[:n])
    if n_data is None:
        n_data = max(1, world // n_model)
    if n_data * n_model != world:
        raise ValueError(f"mesh {n_data}x{n_model} does not cover the "
                         f"{world} process(es) of this run")
    device = _default_device(device)
    key = (n_data, n_model, world, rank, str(device))
    mesh = _MESHES.get(key)
    if mesh is not None:
        return mesh
    mg = dg = None
    dist = coord._dist()
    for d in range(n_data):
        g = dist.new_group([d * n_model + m for m in range(n_model)])
        if d == rank // n_model:
            mg = g
    for m in range(n_model):
        g = dist.new_group([d * n_model + m for d in range(n_data)])
        if m == rank % n_model:
            dg = g
    mesh = _MESHES[key] = RankMesh(n_data, n_model, rank, device, mg, dg)
    return mesh


def _default_device(device):
    if device is None:
        from ..runtime import lib_runtime

        device = lib_runtime.device or torch.device("cpu")
    return torch.device(device)


def forget_meshes() -> None:
    """Drop the cached meshes (their groups die with the process group)."""
    _MESHES.clear()


__all__ = ["DataMesh", "LocalGrid", "LocalMesh", "RankMesh", "data_mesh",
           "flatten_state", "unflatten_state", "shard_bounds",
           "per_device_bytes", "pad_topology", "unpad_topology",
           "layer_sharding", "make_mesh", "forget_meshes",
           "tp_device_count"]
