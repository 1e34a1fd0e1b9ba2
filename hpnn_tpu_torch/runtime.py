"""Library runtime: device choice, capability report, init/deinit, knobs.

The port of the JAX package's ``runtime.py`` (itself the rebuild of the
reference's runtime singleton, ``src/libhpnn.c:58-539``).  The capability
bits keep the reference's values; the device is a ``torch.device`` chosen
once per process by :func:`init_all`:

* ``"cuda"`` (the default) needs a visible GPU -- when none is visible the
  call fails with a message and the entry point exits non-zero.  Nothing
  ever falls back to the CPU;
* ``"cpu"`` only when the caller asks for it (``--device cpu`` on the
  CLIs, ``device="cpu"`` in the API; the tests do).

``HPNN_DISTRIBUTED=1`` joins a ``torch.distributed`` process group (the
counterpart of the JAX package's ``jax.distributed.initialize``, itself the
reference's ``_NN(init,MPI)``): ``HPNN_COORDINATOR`` (host:port),
``HPNN_NUM_PROCESSES`` and ``HPNN_PROCESS_ID`` name the rendezvous, or,
without a coordinator, torch's own ``MASTER_ADDR``/``MASTER_PORT``/
``WORLD_SIZE``/``RANK``.  The backend is NCCL on ``cuda`` and gloo on
``cpu``; ``HPNN_DIST_TIMEOUT_S`` (default 120) bounds every collective,
so a lost peer ends the run instead of hanging it.  One process never
joins a group.

The cards a rank holds (``NNRuntime.devices``; ``device`` is the first),
as ``jax.distributed`` gives a process its local devices:

* under torchrun (``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE`` set, every rank
  of a host seeing the host's c cards) local rank l of w holds cards
  ``[l*c/w, (l+1)*c/w)``; a c that w does not divide is refused;
* otherwise a rank holds every card it sees: its launcher gives it its
  own, e.g. with ``CUDA_VISIBLE_DEVICES``.

Before the process group forms, the ranks post their host name and their
cards' UUIDs to the rendezvous store, and every rank refuses the run when
two ranks of one host claim a card.  A CPU rank holds the one CPU device
(its several shards are a ``device_slice`` of it repeated).
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import torch

from .utils import nn_log

# capability bits: reference values (include/libhpnn.h:26-35)
NN_CAP_NONE = 0
NN_CAP_OMP = 1 << 0
NN_CAP_MPI = 1 << 1
NN_CAP_CUDA = 1 << 2
NN_CAP_CUBLAS = 1 << 3
NN_CAP_PBLAS = 1 << 5
NN_CAP_SBLAS = 1 << 6
# port additions, disjoint from the reference's
NN_CAP_TORCH = 1 << 8
NN_CAP_X64 = 1 << 10

DEVICES = ("cuda", "cpu")


class DeviceUnavailable(RuntimeError):
    """The requested device is not visible to this process."""


@dataclasses.dataclass
class NNRuntime:
    """The `nn_runtime` singleton state (libhpnn.c:58-90)."""

    capability: int = 0
    device: torch.device | None = None
    devices: tuple = ()   # every card this rank holds (device first)
    initialized: bool = False
    n_streams: int = 1   # -S: the row-sharding degree when [model] is unset


lib_runtime = NNRuntime()


def set_cuda_streams(n: int) -> bool:
    """The reference's stream-pool knob (``libhpnn.c:471-505``, ``-S``):
    its streams split each layer's rows (``cuda_ann.cu:536-537``), so here
    it is the row-sharding degree ``api._model_shards`` reads when the
    conf has no ``[model]``."""
    lib_runtime.n_streams = max(1, int(n))
    return True


def get_cuda_streams() -> int:
    return lib_runtime.n_streams


def return_capabilities() -> int:
    """Capability probe (libhpnn.c:113-134), resolved at run time: torch
    always computes in float64; CUDA when a GPU is visible."""
    cap = NN_CAP_TORCH | NN_CAP_X64
    if torch.cuda.is_available():
        cap |= NN_CAP_CUDA
    return cap


def resolve_device(name: str | None = "cuda") -> torch.device:
    """``torch.device`` for ``name`` ("cuda", "cuda:N" or "cpu"); raises
    :class:`DeviceUnavailable` for a GPU that is not visible."""
    dev = torch.device(name or "cuda")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise DeviceUnavailable(
                "CUDA device requested but no GPU is visible "
                "(torch.cuda.is_available() is False); pass --device cpu "
                "to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise DeviceUnavailable(f"unsupported device {name!r} "
                                f"(one of {', '.join(DEVICES)})")
    return dev


def pin_full_float32() -> None:
    """Float32 matmuls and convolutions in full float32, never TF32: the
    plain versions the kernels are checked against, and the fast tier,
    must compute what they claim.  PyTorch's matmul default is already
    False (cuDNN's is True); setting both states the contract and holds it
    against a caller that flipped them."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def init_all(device: str | None = "cuda", rank: int = 0) -> int:
    """_NN(init,all) (libhpnn.c:326-347): pick the device and set the
    rank output is gated on.  Returns 0 on success, -1 (with an NN(ERR)
    line) when the device is unavailable.  Verbosity is the caller's: the
    CLIs parse their -v flags first, because --device comes from the same
    argument list."""
    global lib_runtime
    lib_runtime = NNRuntime()
    nn_log.set_rank(rank)
    from .obs import trace as obs_trace

    # HPNN_TRACE=1: span tracing and the flight recorder from process
    # start (serve_nn can also enable it later with --trace)
    obs_trace.enable_from_env()
    pin_full_float32()
    try:
        dev = resolve_device(device)
    except DeviceUnavailable as exc:
        nn_log.nn_error(f"{exc}\n")
        return -1
    if os.environ.get("HPNN_DISTRIBUTED"):
        try:
            dev = _init_distributed(dev)
        except (RuntimeError, ValueError) as exc:
            nn_log.nn_error(f"device runtime init failed: {exc}\n")
            return -1
    lib_runtime.device = dev
    if not lib_runtime.devices:
        lib_runtime.devices = (dev,)
    lib_runtime.capability = return_capabilities()
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    nn_log.nn_dbg(f"runtime: device {dev} ({name})\n")
    lib_runtime.initialized = True
    return 0


def _init_distributed(dev: torch.device) -> torch.device:
    """Join the process group ``HPNN_DISTRIBUTED`` asks for; records the
    cards this rank holds, returns the first and gates console output on
    rank 0."""
    import torch.distributed as dist

    from .utils.env import env_float

    if dist.is_initialized():
        rank = dist.get_rank()
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
    else:
        if os.environ.get("HPNN_COORDINATOR"):
            missing = [v for v in ("HPNN_NUM_PROCESSES", "HPNN_PROCESS_ID")
                       if v not in os.environ]
            if missing:
                raise RuntimeError(
                    "HPNN_COORDINATOR requires " + " and ".join(missing)
                    + " to be set (coordinator host:port, total process "
                    "count, this process's 0-based id)")
            url = f"tcp://{os.environ['HPNN_COORDINATOR']}"
            world = int(os.environ["HPNN_NUM_PROCESSES"])
            rank = int(os.environ["HPNN_PROCESS_ID"])
        elif all(v in os.environ for v in ("MASTER_ADDR", "MASTER_PORT",
                                           "WORLD_SIZE", "RANK")):
            url, world, rank = "env://", -1, -1
        else:
            raise RuntimeError(
                "HPNN_DISTRIBUTED needs HPNN_COORDINATOR, "
                "HPNN_NUM_PROCESSES and HPNN_PROCESS_ID (or torch's "
                "MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK)")
        timeout = datetime.timedelta(
            seconds=env_float("HPNN_DIST_TIMEOUT_S", 120.0, lo=1.0))
        store, rank, world = next(dist.rendezvous(url, rank, world,
                                                  timeout=timeout))
        store.set_timeout(timeout)
        kwargs = {}
        if dev.type == "cuda":
            cards = _rank_cards(store, rank, world)
            lib_runtime.devices = tuple(torch.device("cuda", i)
                                        for i in cards)
            dev = lib_runtime.devices[0]
            torch.cuda.set_device(dev)
            kwargs["device_id"] = dev
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=store, rank=rank, world_size=world,
                                timeout=timeout, **kwargs)
    nn_log.set_rank(rank)
    nn_log.nn_dbg(f"runtime: rank {rank} of {dist.get_world_size()} "
                  f"({dist.get_backend()})"
                  + (f", cards {[d.index for d in lib_runtime.devices]}"
                     if dev.type == "cuda" and lib_runtime.devices else "")
                  + "\n")
    return dev


def _rank_cards(store, rank: int, world: int) -> list[int]:
    """The visible card indices this rank holds (the module's rule), after
    every rank has posted its host and its cards' UUIDs to ``store``: two
    ranks of one host that claim a card refuse the run, all of them."""
    import json
    import socket

    c = torch.cuda.device_count()
    cards = list(range(c))
    if os.environ.get("LOCAL_WORLD_SIZE") and os.environ.get("LOCAL_RANK"):
        w, l = int(os.environ["LOCAL_WORLD_SIZE"]), int(
            os.environ["LOCAL_RANK"])
        if c % w:
            raise RuntimeError(f"{c} visible card(s) do not split evenly "
                               f"over the {w} ranks of this host "
                               "(LOCAL_WORLD_SIZE)")
        cards = cards[l * c // w:(l + 1) * c // w]
    # a card's UUID, else its index among the host's cards
    visible = (os.environ.get("CUDA_VISIBLE_DEVICES") or "").split(",")
    ids = [str(getattr(torch.cuda.get_device_properties(i), "uuid", None)
               or (visible[i] if i < len(visible) and visible[i] else i))
           for i in cards]
    store.set(f"hpnn_cards/{rank}", json.dumps([socket.gethostname(), ids]))
    seen = {}
    for r in range(world):
        host, got = json.loads(store.get(f"hpnn_cards/{r}"))
        for u in got:
            other = seen.setdefault((host, u), r)
            if other != r:
                raise RuntimeError(f"ranks {other} and {r} of host {host} "
                                   f"both claim card {u}; give each rank "
                                   "its own cards (CUDA_VISIBLE_DEVICES, "
                                   "or torchrun's LOCAL_RANK and "
                                   "LOCAL_WORLD_SIZE)")
    return cards


def deinit_all() -> int:
    """_NN(deinit,all) (libhpnn.c:395-407): reset the runtime state and
    the verbosity, and leave the process group of a multi-process run."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        from .parallel.mesh import forget_meshes

        forget_meshes()
        dist.destroy_process_group()
        nn_log.set_rank(0)
    global lib_runtime
    lib_runtime = NNRuntime()
    nn_log.set_verbosity(0)
    return 0

