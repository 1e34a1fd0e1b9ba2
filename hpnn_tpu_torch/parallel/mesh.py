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


__all__ = ["flatten_state", "unflatten_state", "shard_bounds",
           "per_device_bytes"]
