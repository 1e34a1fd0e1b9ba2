"""Multi-process agreement: the load-failure bailout over
``torch.distributed``.

The port of the JAX package's ``parallel/coord.py``.  The reference's
only distributed-failure protocol is the kernel-load bailout: rank 0
parses the kernel and sends a bailout flag to every slave before any
collective (``src/ann.c:242-248,549-556``).  Here every process reads the
conf, kernel and samples itself, so a failure is rank-divergent: one
process fails to load while the others go on into a collective and block.
Before any training collective every process contributes (ok,
fingerprint) to one all-gather, and all proceed only if every one loaded,
and loaded the same shapes.  The same gate holds the ranks' device counts
equal: a grid across processes takes every rank to hold as many devices
as this one, and the gate precedes its first collective.

A single process never initialises a process group: without
``HPNN_DISTRIBUTED`` (the opt-in ``runtime.init_all`` reads) every
function here answers locally, with no collective.
"""

from __future__ import annotations

import os

import torch

from ..utils.nn_log import nn_error

# fixed fingerprint width of the training gates (sample count, n_in, n_out,
# the shuffle's crc32 or 0): every gate a rank can reach gathers the same
# number of words, so a rank on another route still meets its peers
FINGERPRINT_WIDTH = 4


def _dist():
    """``torch.distributed`` when this run joined a process group, else
    None."""
    if not os.environ.get("HPNN_DISTRIBUTED"):
        return None
    import torch.distributed as dist

    if not dist.is_available() or not dist.is_initialized():
        return None
    return dist


def world_size() -> int:
    """Process count of this run: 1 without HPNN_DISTRIBUTED."""
    dist = _dist()
    return dist.get_world_size() if dist is not None else 1


def process_index() -> int:
    """This process's 0-based rank: 0 without HPNN_DISTRIBUTED."""
    dist = _dist()
    return dist.get_rank() if dist is not None else 0


def _collective_device() -> torch.device:
    """Where a collective's tensors must live: the rank's card under NCCL,
    the CPU under gloo."""
    dist = _dist()
    if dist is not None and dist.get_backend() == "nccl":
        from ..runtime import lib_runtime

        dev = lib_runtime.device
        return dev if dev is not None and dev.type == "cuda" else \
            torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _allgather_i64(vals) -> torch.Tensor:
    """All-gather one int64 vector (the same length on every rank) ->
    (world, len) on the CPU."""
    dist = _dist()
    dev = _collective_device()
    vec = torch.tensor([int(v) for v in vals], dtype=torch.int64, device=dev)
    parts = [torch.empty_like(vec) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, vec)
    return torch.stack(parts).cpu()


def agree_all(ok: bool, fingerprint=(), devices: int = 0) -> bool:
    """All-process agreement gate (the ann.c:242-248 bailout analog).

    Every process calls it at the same point (it is a collective) with a
    ``fingerprint`` of the same length.  True iff every process reports
    ``ok`` and all fingerprints and ``devices`` (the devices the rank
    trains over, where a grid may span the ranks) are identical.  Single
    process: ``ok`` unchanged, no collective."""
    if world_size() == 1:
        return bool(ok)
    try:
        got = _allgather_i64([1 if ok else 0, int(devices),
                              *map(int, fingerprint)])
    except Exception as exc:  # pragma: no cover - coordination failure
        nn_error(f"process agreement failed: {exc}\n")
        return False
    if not bool((got[:, 0] == 1).all()):
        bad = torch.nonzero(got[:, 0] != 1).flatten().tolist()
        if ok:  # this process was fine; a peer failed
            nn_error("aborting: load failed on process(es) "
                     f"{bad} (coordinated bailout)\n")
        return False
    if not bool((got[:, 1] == got[0, 1]).all()):
        nn_error("aborting: processes hold unequal device counts "
                 f"({got[:, 1].tolist()} by rank)\n")
        return False
    if not bool((got == got[0]).all()):
        fps = torch.cat([got[:, :1], got[:, 2:]], dim=1)
        nn_error("aborting: processes loaded DIFFERENT data "
                 f"(fingerprints {fps.tolist()})\n")
        return False
    return True


def any_flag(flag: bool) -> bool:
    """OR of a local flag over the processes (a collective): one rank's
    SIGTERM latches the stop on every rank at the next epoch boundary.
    Single process: ``flag`` unchanged."""
    if world_size() == 1:
        return bool(flag)
    try:
        got = _allgather_i64([1 if flag else 0])
    except Exception as exc:  # pragma: no cover - coordination failure
        nn_error(f"process flag agreement failed: {exc}\n")
        return True  # fail towards stopping together
    return bool((got != 0).any())


def snapshot_barrier(epoch: int) -> bool:
    """All ranks agree on the epoch being bundled before rank 0 writes the
    snapshot: a barrier (rank 0's write cannot race a rank still finishing
    the epoch), then an epoch all-gather that proves the ranks bundle the
    same epoch.  The wait is bounded by the process group's timeout
    (``HPNN_DIST_TIMEOUT_S``).  Single process: True, no collective."""
    if world_size() == 1:
        return True
    try:
        _dist().barrier()
        got = _allgather_i64([int(epoch)])
    except Exception as exc:  # pragma: no cover - coordination failure
        nn_error(f"snapshot barrier failed: {exc}\n")
        return False
    if not bool((got == int(epoch)).all()):
        nn_error("aborting snapshot: ranks disagree on the bundle epoch "
                 f"(epochs {got.flatten().tolist()})\n")
        return False
    return True


__all__ = ["FINGERPRINT_WIDTH", "agree_all", "any_flag", "process_index",
           "snapshot_barrier", "world_size"]
