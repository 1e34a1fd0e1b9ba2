"""The data axis and the flat optimizer-state layout.

The port of the parts of the JAX package's ``parallel/mesh.py`` that the
data-parallel and CG trainers use.  The JAX package builds a
``jax.sharding.Mesh`` and lets GSPMD place collectives; the port's data
axis is the ``torch.distributed`` world instead -- one process (rank) per
device -- and the collectives are explicit (``parallel.dp``).  No GSPMD
emulation is built.

The flat layout (arXiv:2004.13336, as in the JAX package): the update
state of a data-parallel run -- BPM momentum, the master weights -- is
one vector, zero-padded to a multiple of the world size, of which each
rank updates a contiguous 1/N slice.  Every operation on it is
value-preserving (concatenate, pad, slice, reshape), so the flat
trajectory equals the per-layer one bit for bit.

The row-sharding half (``[model]``, ``parallel.tp``): the zero padding
that lets k row blocks divide every hidden layer (:func:`pad_topology`),
the per-layer placement rule (:func:`layer_sharding`) and two model axes.
:class:`RankMesh` is the (data x model) grid over the world, one rank a
device, the model axis inner as the JAX package's ``make_mesh`` reshapes
its devices, so a model group is consecutive ranks; :class:`LocalMesh` is
K devices of one process (the serving tier's row blocks; a device may
repeat).  Both answer the same few collectives over the model axis
(``gather``, ``psum``, ``shift``), each taking and returning one tensor
for every shard the process holds: one on a rank, K in a LocalMesh.

The serving data axis (``serve_nn --parity fast --mesh N``):
:func:`data_mesh` builds a :class:`DataMesh`, N devices of one process
over which the ``fast@meshN`` tier splits a padded bucket's rows
(``parallel.dp.dp_eval_batch``); the weights are replicated, so it needs
no collective.
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


class LocalMesh:
    """A 1 x K model axis of one process: shard i's tensors live on
    ``devices[i]`` (repeats allowed, so K row blocks can share one card).
    The collectives are copies between the shards' devices."""

    n_data = 1
    data_index = 0

    def __init__(self, devices):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("LocalMesh needs at least one device")
        self.n_model = len(self.devices)
        self.local = tuple(range(self.n_model))   # the shards held here

    def device_of(self, i: int) -> torch.device:
        return self.devices[i]

    def gather(self, parts, only=None):
        """Every shard's tensor concatenated along the last dim in shard
        order, on each shard's device (on the shards ``only`` names)."""
        devs = (self.devices if only is None
                else [self.devices[i] for i in only])
        return [torch.cat([p.to(d) for p in parts], dim=-1) for d in devs]

    def psum(self, parts):
        """The shards' tensors summed in shard order, on each device."""
        tot = parts[0]
        for p in parts[1:]:
            tot = tot + p.to(tot.device)
        return [tot.to(d) for d in self.devices]

    def psum_data(self, t):
        return t

    def shift(self, parts):
        """The ring step: shard i receives shard (i+1) mod K's tensor."""
        k = self.n_model
        return _Done([parts[(i + 1) % k].to(self.devices[i],
                                            non_blocking=True)
                      for i in range(k)])

    def gather_rows(self, parts):
        """Every shard's row block stacked in shard order, on the CPU."""
        return torch.cat([p.to("cpu") for p in parts])


class DataMesh:
    """An N x 1 data axis of one process: shard i's rows run on
    ``devices[i]`` (repeats allowed, so N shards can share one card, as
    the shards of a :class:`LocalMesh` may).  Weights are replicated on
    every shard's device; nothing is exchanged but the rows."""

    def __init__(self, devices):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("DataMesh needs at least one device")
        self.n_data = len(self.devices)

    def distinct(self) -> tuple[torch.device, ...]:
        """The shards' devices, each once, in shard order."""
        return tuple(dict.fromkeys(self.devices))


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
        self.devices = (torch.device(device),)
        self.model_group, self.data_group = model_group, data_group
        base = self.data_index * self.n_model
        self.model_ranks = tuple(base + m for m in range(self.n_model))

    def device_of(self, i: int) -> torch.device:
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

    def psum_data(self, t):
        if self.n_data == 1:
            return t
        t = t.clone()
        self._dist().all_reduce(t, group=self.data_group)
        return t

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


def make_mesh(n_data: int | None = None, n_model: int = 1, device=None):
    """The (data x model) :class:`RankMesh` of this run's world: ``n_data``
    defaults to the world over ``n_model``; the grid must cover the world
    (a rank outside it would have nothing to compute).  Groups are made
    once a world and layout and reused."""
    from . import coord

    world, rank = coord.world_size(), coord.process_index()
    n_model = max(1, int(n_model))
    if n_data is None:
        n_data = max(1, world // n_model)
    if n_data * n_model != world:
        raise ValueError(f"mesh {n_data}x{n_model} does not cover the "
                         f"{world} process(es) of this run")
    if device is None:
        from ..runtime import lib_runtime

        device = lib_runtime.device or torch.device("cpu")
    key = (n_data, n_model, world, rank, str(device))
    mesh = _MESHES.get(key)
    if mesh is not None:
        return mesh
    mg = dg = None
    if world > 1:
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


def forget_meshes() -> None:
    """Drop the cached meshes (their groups die with the process group)."""
    _MESHES.clear()


__all__ = ["DataMesh", "LocalMesh", "RankMesh", "data_mesh",
           "flatten_state", "unflatten_state", "shard_bounds",
           "per_device_bytes", "pad_topology", "unpad_topology",
           "layer_sharding", "make_mesh", "forget_meshes",
           "tp_device_count"]
