"""Model registry: named kernels, device weights cast once to the conf
dtype, generations with hot reload and A/B pinning, and a bounded cache
of per-bucket forward entry points tiered by an explicit per-registry
**parity policy** (the port of ``hpnn_tpu/serve/registry.py``).

Loading goes through ``api.configure`` -- the same ``.conf`` files
``run_nn`` accepts -- so a kernel that evaluates offline serves unchanged.

Two serving tiers (``ops.select_run_batch``'s two axes):

* ``parity="strict"`` (default) -- evaluation is the exact
  ``api.run_kernel`` batch pipeline: the same cast weights, inputs cast
  from float64 on the device exactly as run_nn casts them, the same
  forward (on CUDA the ``fused_linear_act`` kernel, whose per-element
  reduction order is fixed) -- responses are bit-identical to what
  ``run_nn`` computes for the same input rows, whatever the batching or
  padding.  That holds on CUDA for every dtype and on the CPU for
  float64 (the per-row ``run_batch``); CPU float32/bfloat16 go through
  the kernel's plain version, a batched matmul whose bits may follow the
  batch shape.
* ``parity="fast"`` -- buckets at or above ``fast_threshold`` rows take
  the throughput forward (the GEMM chain for float64); answers are
  dtype-accurate but may differ from the strict tier at the ULP level.
  With a data ``mesh`` (a ``parallel.DataMesh`` of N devices) such a
  bucket that N divides is served ``fast@meshN``: its rows split into N
  blocks, each run by the same fast forward on its shard's device with
  replicated weights (``parallel.dp.dp_eval_batch``), so its answers
  are the ``fast`` tier's.  The copies are placed once a mesh and
  rebuilt on a swap; a pinned dispatch never shards.

A third tier, ``tp@K``, serves a kernel too big for one device: with a
model axis (``tp_mesh``, a ``parallel.LocalMesh`` of K devices) every
bucket of a kernel whose cast weights exceed the per-device budget
(``HPNN_EPOCH_DEVICE_BUDGET_MB``, the knob the trainer's epoch pipeline
budgets against) runs the row-sharded ring engine
(``parallel.tp.tp_eval_batch``) on a per-mesh carry of row blocks, built
once and rebuilt on a swap.  A kernel that fits keeps its parity tier.

The cache is keyed by (model, topology, dtype, bucket, kind, tier,
live/pinned).  Requests are padded to power-of-two row buckets, so a
model holds at most log2(max_batch)+1 entries per tier and variant.

**Generations.**  A model starts at generation 1; every hot reload
(``swap_kernel``) adds one.  The device weights live in a per-topology
holder (a one-element list) that the cached entries capture: a
same-topology swap stores the new weights into it with one reference
store, so the entries are reused as they are; a topology change installs
a fresh holder and purges the model's stale entries.  With an A/B
fraction the outgoing generation is retained (``gen_keep`` of them) for
``X-HPNN-Generation`` pins and ``rollback``, and that fraction of
unpinned traffic keeps going to the previous generation until
``promote``/``rollback``.

**The pipeline on a CUDA device.**  ``dispatch`` pads the rows into a
pinned host buffer, copies it in with ``non_blocking=True``, launches
the forward, enqueues the copy out into a pinned host buffer right after
it and records an event; ``collect`` waits on that event only, never on
the whole device.  A pinned input buffer goes back to its pool only after
its event has completed: recycled earlier, the next batch's rows would
overwrite it while its copy in is still in flight.  Timing events around
the copy in, the forward and the copy out give the ``pad_h2d``,
``device`` and ``d2h`` phases (host walls around an asynchronous launch
would measure only the enqueue).  On the CPU the forward runs inside
``dispatch`` and the phases are host walls.
"""

from __future__ import annotations

import os
import random
import threading
import time

import numpy as np
import torch

from ..api import configure, dtype_of, kernel_kind
from ..models.kernel import MLP
from ..runtime import resolve_device
from ..train import trainer_label
from ..utils.nn_log import nn_dbg, nn_error, nn_out, nn_warn
from .metrics import ServeMetrics

PARITY_MODES = ("strict", "fast")


def bucket_rows(rows: int, max_batch: int) -> int:
    """Power-of-two batch bucket: smallest 2^k >= rows, capped at
    max_batch (the batcher never dispatches more than max_batch rows)."""
    if rows >= max_batch:
        return max_batch
    b = 1
    while b < rows:
        b <<= 1
    return b


class _ScratchPool:
    """Reusable float64 host buffers of one row width, one free-list per
    bucket size; page-locked (pinned) when they feed a CUDA device, so
    the copies in and out are asynchronous.  ``release`` must only be
    called once the device is done with the buffer."""

    _KEEP = 3  # the pipeline's two batches plus a concurrent warmup

    def __init__(self, width: int, pin: bool):
        self.width = width
        self.pin = pin
        self._free: dict[int, list[torch.Tensor]] = {}
        self._lock = threading.Lock()

    def acquire(self, bucket: int) -> torch.Tensor:
        with self._lock:
            free = self._free.get(bucket)
            if free:
                return free.pop()
        return torch.zeros((bucket, self.width), dtype=torch.float64,
                           pin_memory=self.pin)

    def release(self, buf: torch.Tensor) -> None:
        with self._lock:
            free = self._free.setdefault(buf.shape[0], [])
            if len(free) < self._KEEP:
                free.append(buf)


class _InFlight:
    """One dispatched bucket: the result (on a CUDA device, the pinned
    host buffer its copy out lands in, and the batch's timing events),
    the scratch buffers to recycle, the generation that served and, once
    collected, the phase times."""

    __slots__ = ("out", "rows", "bucket", "served_gen", "pad_h2d_s",
                 "device_s", "d2h_s", "span_s", "tier", "_events", "_bufs",
                 "_pools")

    def __init__(self, out, rows: int, bucket: int, served_gen=None,
                 tier: str = "strict"):
        self.out = out
        self.rows = rows
        self.bucket = bucket
        self.tier = tier              # the tier that served the bucket
        self.served_gen = served_gen  # the generation whose weights
        #                               actually launched
        self.pad_h2d_s = 0.0
        self.device_s = 0.0
        self.d2h_s = 0.0
        self.span_s = None            # the batch's device span, once known
        self._events = None
        self._bufs: list = []
        self._pools: list = []

    def recycle(self) -> None:
        for buf, pool in zip(self._bufs, self._pools):
            pool.release(buf)
        self._bufs, self._pools = [], []


def _replicate(weights, mesh) -> tuple:
    """``weights`` copied to every distinct device of a data ``mesh``, one
    tuple a shard (shards of one device share a copy; the weights' own
    device uses them as they are)."""
    home = weights[0].device
    per_dev = {d: (weights if d == home else tuple(w.to(d) for w in weights))
               for d in mesh.distinct()}
    return tuple(per_dev[d] for d in mesh.devices)


class ServedModel:
    """One registered kernel: its conf, the device-resident weights in
    the conf dtype (cast once, at registration and at every reload),
    its retained generations and its scratch pools."""

    def __init__(self, name: str, nn, registry: "ModelRegistry"):
        self.name = name
        self.nn = nn                      # api.NNDef (conf + kernel)
        self.registry = registry
        # default-mode LNN evaluates through the SNN branch exactly like
        # run_kernel (libhpnn.c:1455-1456)
        self.kind = kernel_kind(nn.conf)
        self.trainer = trainer_label(nn.conf)
        self.n_inputs = nn.kernel.n_inputs
        self.n_outputs = nn.kernel.n_outputs
        self._topology = tuple(int(p) for p in nn.kernel.params)
        self.generation = 1               # bumped by every swap_kernel
        self.loaded_at = time.time()
        self.source = nn.conf.f_kernel    # where a bare reload re-reads
        # the weights sit behind one level of indirection per topology:
        # cached entries capture the holder and read holder[0], a
        # (weights, generation) pair, once at each dispatch -- so a reply
        # is labelled with the generation whose weights computed it
        # (see swap_kernel)
        self._holder = [(MLP.from_kernel(nn.kernel, self.dtype,
                                         registry.device, self.kind),
                         self.generation)]
        # retained previous generations (A/B pinning and rollback): the
        # device weights and the host kernels, pruned to gen_keep
        self._gen_weights: dict[int, MLP] = {}
        self._gen_kernels: dict[int, object] = {}
        # mesh -> (row-sharded TPCarry, generation) for the tp@K tier,
        # and mesh -> (a weights tuple a shard, generation) for the
        # fast@meshN tier, each built at its first dispatch and rebuilt
        # by every swap
        self._tp_weights: dict = {}
        self._mesh_weights: dict = {}
        self.ab_window: dict | None = None
        self._pools: tuple[_ScratchPool, _ScratchPool] | None = None
        self._lock = threading.Lock()
        # serializes whole reloads (disk read + swap): a manifest watcher
        # racing a manual reload must not interleave read-old/swap-new/
        # swap-old -- the last reload to start is the one that serves
        self._reload_lock = threading.Lock()

    @property
    def dtype(self) -> torch.dtype:
        return dtype_of(self.nn.conf)

    @property
    def dtype_name(self) -> str:
        return self.nn.conf.dtype

    @property
    def topology(self) -> tuple:
        return self._topology

    @property
    def mlp(self) -> MLP:
        """The live generation's weights."""
        return self._holder[0][0]

    def weights_holder(self) -> list:
        """The current topology's holder: cached entries capture it and
        read ``holder[0]``, the live ``(weights, generation)``, at each
        dispatch."""
        with self._lock:
            return self._holder

    def tp_weights(self, mesh):
        """The live generation as a row-sharded carry on ``mesh`` (the
        tp@K tier): ``(TPCarry, generation)``, padded and placed once a
        mesh and kept resident."""
        from ..parallel.tp import tp_engine_carry

        with self._lock:
            cached = self._tp_weights.get(mesh)
            if cached is None:
                mlp, gen = self._holder[0]
                cached = self._tp_weights[mesh] = (
                    tp_engine_carry(mlp.weights, mesh), gen)
            return cached

    def mesh_weights(self, mesh):
        """The live generation replicated over a data ``mesh`` (the
        fast@meshN tier): ``(copies, generation)``, one weights tuple a
        shard, copied once a distinct device and kept resident."""
        with self._lock:
            cached = self._mesh_weights.get(mesh)
            if cached is None:
                mlp, gen = self._holder[0]
                cached = self._mesh_weights[mesh] = (
                    _replicate(mlp.weights, mesh), gen)
            return cached

    def scratch_pools(self) -> tuple[_ScratchPool, _ScratchPool]:
        """The (input, output) host buffer pools at the current widths."""
        with self._lock:
            if self._pools is None:
                pin = self.registry.device.type == "cuda"
                self._pools = (_ScratchPool(self.n_inputs, pin),
                               _ScratchPool(self.n_outputs, pin))
            return self._pools

    def swap_kernel(self, kernel, source: str | None, ab: bool = True,
                    set_generation: int | None = None) -> dict:
        """Replace the served weights with ``kernel`` under traffic.

        The new device weights are built outside the lock, on the current
        stream, then published with their generation in one reference
        store: a dispatch sees the complete old weights or the complete
        new ones, each with its own generation.  The batcher
        threads launch on the same (default) stream, so every forward
        enqueued after the store runs after the upload.  A launch still
        in flight on the old weights is safe only because the caching
        allocator reuses a freed block in stream order; no side stream
        may touch served weights unless it orders itself with
        ``record_stream`` or events.  A same-topology swap reuses every
        cached entry (no plan or library is rebuilt); a topology change
        installs a fresh holder, drops the retained generations and
        purges the model's stale cache entries.  ``set_generation`` pins
        the post-swap generation instead of the +1 bump.  Raises when the
        upload fails, before anything changed."""
        new_topo = tuple(int(p) for p in kernel.params)
        changed = new_topo != self.topology
        new_w = MLP.from_kernel(kernel, self.dtype, self.registry.device,
                                self.kind)
        with self._lock:
            meshes = list(self._tp_weights)
            data_meshes = list(self._mesh_weights)
        new_tp = {}
        if meshes:
            from ..parallel.tp import tp_engine_carry

            new_tp = {m: tp_engine_carry(new_w.weights, m) for m in meshes}
        new_mesh = {m: _replicate(new_w.weights, m) for m in data_meshes}
        with self._lock:
            old_kernel = self.nn.kernel
            self.nn.kernel = kernel
            gen = (self.generation + 1 if set_generation is None
                   else int(set_generation))
            if changed:
                # callables built for the old topology keep the old
                # holder and finish on shape-consistent old weights; the
                # old-shape carries are dropped
                self._holder = [(new_w, gen)]
                self._tp_weights = {m: (c, gen) for m, c in new_tp.items()}
                self._mesh_weights = {m: (c, gen)
                                      for m, c in new_mesh.items()}
                self._gen_weights.clear()
                self._gen_kernels.clear()
                self.ab_window = None
            else:
                # retain the outgoing generation only when something can
                # consume it (retain_generations): a plain --watch-ckpt
                # server must not hold extra device copies per swap
                old_gen = self.generation
                keep = (self.registry.gen_keep
                        if self.registry.retain_generations else 0)
                if keep > 0:
                    self._gen_weights[old_gen] = self._holder[0][0]
                    self._gen_kernels[old_gen] = old_kernel
                    for g in sorted(self._gen_weights)[:-keep]:
                        del self._gen_weights[g]
                        self._gen_kernels.pop(g, None)
                if ab and self.registry.ab_fraction > 0.0:
                    self.ab_window = {
                        "prev": old_gen,
                        "fraction": float(self.registry.ab_fraction)}
                self._holder[0] = (new_w, gen)
                # a mesh placed between the snapshot above and here still
                # holds the old weights: evict it, its next dispatch
                # builds the carry from the new holder
                for m in [m for m in self._tp_weights if m not in new_tp]:
                    del self._tp_weights[m]
                for m, c in new_tp.items():
                    self._tp_weights[m] = (c, gen)
                for m in [m for m in self._mesh_weights
                          if m not in new_mesh]:
                    del self._mesh_weights[m]
                for m, c in new_mesh.items():
                    self._mesh_weights[m] = (c, gen)
            if changed:
                if (kernel.n_inputs != self.n_inputs
                        or kernel.n_outputs != self.n_outputs):
                    self._pools = None  # buffer widths no longer fit
                self.n_inputs = kernel.n_inputs
                self.n_outputs = kernel.n_outputs
                self._topology = new_topo
            self.generation = gen
            self.loaded_at = time.time()
            if source:
                self.source = source
            ab_win = dict(self.ab_window) if self.ab_window else None
            retained = sorted(self._gen_weights)
        if changed:
            self.registry.purge_cache(self.name, keep_topology=new_topo)
        return {"kernel": self.name, "generation": gen,
                "topology_changed": changed,
                "topology": list(new_topo),
                "source": self.source,
                "ab_window": ab_win,
                "retained_generations": retained}

    # --- A/B generation pinning ----------------------------------------
    def resolve_generation(self, requested: int | None = None
                           ) -> int | None:
        """Which generation a request goes to: an explicit pin is checked
        against the current and retained generations (KeyError when
        unknown: the HTTP layer answers 404); unpinned traffic goes to
        the previous generation with the A/B window's probability (the
        registry's own generator draws), else None (the live weights)."""
        with self._lock:
            if requested is not None:
                req = int(requested)
                if req != self.generation and req not in self._gen_weights:
                    raise KeyError(req)
                return req
            ab = self.ab_window
            if (ab and ab["prev"] in self._gen_weights
                    and self.registry.rng.random() < ab["fraction"]):
                return int(ab["prev"])
            return None

    def weights_for(self, gen: int):
        """``(weights, served_gen)`` for a pinned generation.  A
        generation pruned between admission and dispatch falls back to
        the current weights, and ``served_gen`` says so."""
        with self._lock:
            if gen == self.generation:
                return self._holder[0][0].weights, gen
            w = self._gen_weights.get(gen)
            if w is not None:
                return w.weights, gen
            return self._holder[0][0].weights, self.generation

    def generation_table(self) -> dict:
        """The current generation, the retained pins and the A/B
        window."""
        with self._lock:
            return {"current": self.generation,
                    "retained": sorted(self._gen_weights),
                    "ab_window": (dict(self.ab_window)
                                  if self.ab_window else None)}

    def promote(self) -> dict:
        """Close the A/B window: all unpinned traffic goes to the current
        generation (pins to retained generations keep working)."""
        with self._lock:
            self.ab_window = None
            return {"kernel": self.name, "generation": self.generation,
                    "ab_window": None,
                    "retained": sorted(self._gen_weights)}

    def rollback(self, gen: int | None = None) -> dict:
        """Swap a retained generation's kernel back in (default: the A/B
        window's previous generation, else the newest retained one) as a
        new generation, and close the window."""
        with self._lock:
            if gen is None:
                gen = self.ab_window["prev"] if self.ab_window else None
            if gen is None and self._gen_kernels:
                gen = max(self._gen_kernels)
            kernel = (self._gen_kernels.get(int(gen))
                      if gen is not None else None)
        if kernel is None:
            raise KeyError(
                f"no retained generation to roll back to ({gen})")
        result = self.swap_kernel(kernel, f"rollback:gen{int(gen)}",
                                  ab=False)
        with self._lock:
            self.ab_window = None
        result["ab_window"] = None
        result["rolled_back_to"] = int(gen)
        return result

    def infer(self, xs: np.ndarray) -> np.ndarray:
        """Synchronous forward of (rows, n_inputs) float64 rows."""
        return self.registry.forward(self, np.asarray(xs, np.float64))

    def warmup(self) -> int:
        """Run every bucket once, so the first request of each size finds
        its cache entry and the kernel's library loaded.  Serial: one
        device stream gains nothing from concurrent warmup.  Returns the
        bucket count."""
        buckets = self.registry.buckets()
        for b in buckets:
            self.registry.forward(
                self, np.zeros((b, self.n_inputs), np.float64))
        return len(buckets)


class ModelRegistry:
    """Name -> ServedModel map plus the shared forward-entry cache."""

    def __init__(self, max_batch: int = 64, parity: str = "strict",
                 fast_threshold: int = 256, device="cuda",
                 metrics: ServeMetrics | None = None,
                 ab_fraction: float = 0.0, gen_keep: int = 2,
                 tp_mesh=None, mesh=None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1: {max_batch}")
        if not 0.0 <= float(ab_fraction) <= 1.0:
            raise ValueError(
                f"ab_fraction must be in [0, 1]: {ab_fraction}")
        if parity not in PARITY_MODES:
            raise ValueError(f"parity must be one of {PARITY_MODES}: "
                             f"{parity!r}")
        self.device = resolve_device(device)   # no card: DeviceUnavailable
        self.metrics = metrics or ServeMetrics()
        # buckets are powers of two, so the cap must be one: round a
        # non-power-of-two request (serve_nn -b 48) up to the next bucket
        self.max_batch = 1 << (int(max_batch) - 1).bit_length()
        if self.max_batch != int(max_batch):
            nn_warn(f"serve: max_batch {max_batch} rounded up to the "
                    f"power-of-two bucket {self.max_batch}\n")
        self.parity = parity
        self.fast_threshold = max(1, int(fast_threshold))
        if parity == "fast" and self.fast_threshold > self.max_batch:
            nn_warn(f"serve: parity=fast is inert -- fast_threshold "
                    f"{self.fast_threshold} exceeds the largest batch "
                    f"bucket {self.max_batch}; every bucket will serve "
                    "strict (raise -b/--max-batch or lower "
                    "--fast-threshold)\n")
        # the fast@meshN tier's data axis (a DataMesh), or None
        self.mesh = mesh
        # the tp@K tier's model axis (a LocalMesh), or None
        self.tp_mesh = tp_mesh
        # A/B policy: during a hot swap this fraction of unpinned traffic
        # keeps going to the previous generation; gen_keep bounds the
        # retained generations a model keeps pinnable
        self.ab_fraction = float(ab_fraction)
        self.gen_keep = max(0, int(gen_keep))
        # swaps retain generations only when something consumes them: an
        # A/B fraction, or the jobs service (ServeApp.enable_jobs turns
        # this on for rollback, pins and auto-promote's baseline)
        self.retain_generations = self.ab_fraction > 0.0
        # the A/B draw's own generator, never the module-level random
        self.rng = random.Random()
        self._models: dict[str, ServedModel] = {}
        self._cache: dict[tuple, object] = {}
        self._events: list[list] = []   # collected batches' event sets
        self._lock = threading.Lock()

    # --- registration ---------------------------------------------------
    def register_conf(self, path: str,
                      name: str | None = None) -> ServedModel | None:
        """Load a kernel through api.configure (the run_nn path).  None on
        any parse or load failure, or a name collision."""
        nn = configure(path)
        if nn is None or nn.kernel is None:
            return None
        if name is None:
            name = nn.conf.name or os.path.splitext(
                os.path.basename(path))[0]
        return self.register(name, nn)

    def register(self, name: str, nn) -> ServedModel | None:
        """Register under ``name``; a collision is a failure (None):
        silently replacing a live model would reroute its traffic."""
        model = ServedModel(name, nn, self)
        with self._lock:
            if name in self._models:
                nn_error(f"serve: kernel name '{name}' already "
                         "registered!\n")
                return None
            self._models[name] = model
        route = self.route_for(model)
        self.metrics.set_model_info(name, model.generation,
                                    model.loaded_at, kind=model.kind,
                                    trainer=model.trainer, route=route)
        nn_out(f"serve: registered kernel '{name}' "
               f"({'x'.join(str(p) for p in model.topology)}, "
               f"{model.dtype_name}, {model.kind}, "
               f"parity={self.parity}, route={route})\n")
        return model

    def get(self, name: str) -> ServedModel | None:
        with self._lock:
            return self._models.get(name)

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._models)

    def buckets(self) -> list[int]:
        """Every bucket a request can land in: 1, 2, 4, ... max_batch."""
        out, b = [], 1
        while True:
            out.append(b)
            if b >= self.max_batch:
                return out
            b <<= 1

    # --- hot reload -----------------------------------------------------
    def reload(self, name: str, kernel_path: str | None = None,
               set_generation: int | None = None
               ) -> tuple[dict | None, str]:
        """Re-read a model's weights from disk and swap them in under
        traffic.  ``kernel_path`` defaults to the model's last source.
        Returns ``(result, "")`` or ``(None, reason)``: a failed load or
        upload leaves the served weights untouched."""
        from ..io.kernel_io import load_kernel

        model = self.get(name)
        if model is None:
            return None, f"unknown kernel '{name}'"
        src = kernel_path or model.source
        if not src:
            return None, (f"kernel '{name}' has no weights file to "
                          "reload from (conf used [init] generate); "
                          "pass an explicit kernel path")
        with model._reload_lock:  # see ServedModel.__init__
            kernel = load_kernel(src)
            if kernel is None:
                return None, f"failed to load kernel from {src}"
            try:
                result = model.swap_kernel(kernel, src,
                                           set_generation=set_generation)
            except (RuntimeError, ValueError) as exc:
                # the upload failed before anything was published: a
                # reported error, the old weights keep serving
                return None, (f"failed to upload kernel from {src}: "
                              f"{type(exc).__name__}: {exc}")
        self.metrics.set_model_info(name, model.generation,
                                    model.loaded_at, kind=model.kind,
                                    trainer=model.trainer,
                                    route=self.route_for(model))
        nn_out(f"serve: reloaded kernel '{name}' from {src} "
               f"(generation {result['generation']}"
               f"{', topology changed' if result['topology_changed'] else ''}"
               ")\n")
        return result, ""

    def purge_cache(self, name: str, keep_topology: tuple | None) -> int:
        """Drop a model's entries whose topology no longer matches (after
        a topology-changing reload); returns the count."""
        with self._lock:
            stale = [k for k in self._cache
                     if k[0] == name and k[1] != keep_topology]
            for k in stale:
                del self._cache[k]
        return len(stale)

    # --- tier selection -------------------------------------------------
    def tp_shards(self, model: ServedModel) -> int:
        """The model axis ``model`` serves over, or 0 for the parity
        tiers: the registry has a tp_mesh of K > 1 AND the kernel's cast
        weights exceed the per-device budget
        (``HPNN_EPOCH_DEVICE_BUDGET_MB``).  A kernel that fits replicates:
        the ring's hops would be pure overhead."""
        from ..utils.env import env_int

        if self.tp_mesh is None or self.tp_mesh.n_model <= 1:
            return 0
        budget = env_int("HPNN_EPOCH_DEVICE_BUDGET_MB", 4096) << 20
        itemsize = torch.empty((), dtype=model.dtype).element_size()
        wbytes = sum(int(np.prod(w.shape)) * itemsize
                     for w in model.nn.kernel.weights)
        return self.tp_mesh.n_model if wbytes > budget else 0

    def route_for(self, model: ServedModel) -> str:
        """The /metrics route label: ``tp@K`` where the row-sharded tier
        serves the kernel, else the parity."""
        k = self.tp_shards(model)
        return f"tp@{k}" if k else self.parity

    def tier_for(self, bucket: int) -> str:
        """The tier a bucket takes under the parity policy: ``strict``,
        ``fast``, or ``fast@meshN`` where the data mesh's N > 1 divides
        it."""
        if self.parity != "fast" or bucket < self.fast_threshold:
            return "strict"
        n = self.mesh.n_data if self.mesh is not None else 1
        if n > 1 and bucket % n == 0:
            return f"fast@mesh{n}"
        return "fast"

    # --- the forward path -----------------------------------------------
    def _callable_for(self, model: ServedModel, bucket: int,
                      pinned: bool = False):
        """The forward entry for one (model, topology, dtype, bucket,
        kind, tier, variant) key; creating it is the cache miss.  The
        entry takes the (bucket, n_inputs) float64 rows on the
        registry's device and returns the device-side (bucket, n_outputs)
        result without synchronising.  The live variant reads the
        holder's (weights, generation) at each call and returns ``(out,
        generation)``; the pinned variant takes the weights as its second
        argument.  Returns ``(entry, tier)``."""
        tpk = self.tp_shards(model)
        # the tp@K tier is per model (weights too big for one device), so
        # every bucket of such a kernel takes it, pinned dispatch too
        tier = f"tp@{tpk}" if tpk else self.tier_for(bucket)
        if pinned and tier.startswith("fast@mesh"):
            # retained generations keep no replicated copies, and a pin
            # asks for a generation, not for throughput
            tier = "fast"
        key = (model.name, model.topology, model.dtype_name, bucket,
               model.kind, tier, "pinned" if pinned else "live")
        with self._lock:
            fn = self._cache.get(key)
            if fn is not None:
                self.metrics.count_cache(hit=True)
                return fn, tier
            from .. import ops

            sharded = tier.startswith("fast@mesh")
            run_batch_fn, path = ops.select_run_batch(
                model.dtype, parity=("strict" if tpk
                                     else "fast" if sharded else tier),
                kind=model.kind, device=self.device,
                model_mesh=self.tp_mesh if tpk else None)
            if sharded:
                from ..parallel.dp import dp_eval_batch

                path += "+" + tier.split("@")[1]
                mesh_dict = model._mesh_weights  # captured: see swap_kernel

                def fn(x, _fn=run_batch_fn, _m=self.mesh, _mo=model,
                       _md=mesh_dict, _k=model.kind, _dt=model.dtype):
                    # one read: every shard's copy and their generation
                    copies, gen = _md.get(_m) or _mo.mesh_weights(_m)
                    return dp_eval_batch(copies, x.to(_dt), _k, _m,
                                         _fn), gen
            elif tpk and not pinned:
                tp_dict = model._tp_weights   # captured: see swap_kernel

                def fn(x, _fn=run_batch_fn, _m=self.tp_mesh, _mo=model,
                       _td=tp_dict, _k=model.kind, _dt=model.dtype):
                    # one read: the carry and its generation
                    carry, gen = _td.get(_m) or _mo.tp_weights(_m)
                    return _fn(carry, x.to(_dt), _k), gen
            elif pinned:
                # (on the tp@K tier the pinned generation's weights are
                # sharded a call: retained generations keep no carry)
                def fn(x, w, _fn=run_batch_fn, _k=model.kind,
                       _dt=model.dtype):
                    # float64 -> dtype on the device: run_kernel's cast
                    return _fn(w, x.to(_dt), _k)
            else:
                holder = model.weights_holder()

                def fn(x, _fn=run_batch_fn, _h=holder, _k=model.kind,
                       _dt=model.dtype):
                    mlp, gen = _h[0]  # one read: weights and their label
                    return _fn(mlp.weights, x.to(_dt), _k), gen

            self._cache[key] = fn
            self.metrics.count_cache(hit=False)
            nn_dbg(f"serve: compile-cache miss (model={model.name} "
                   f"bucket={bucket} tier={tier} path={path})\n")
        if sharded:
            # the copies are placed now, not in a batch, and outside the
            # registry's lock, so that the other models' dispatch goes on
            model.mesh_weights(self.mesh)
        return fn, tier

    def dispatch(self, model: ServedModel, xs: np.ndarray,
                 gen: int | None = None) -> _InFlight:
        """Pad rows into a pooled buffer and launch the cached forward
        without waiting for the result (see the module docstring for the
        CUDA pipeline); ``collect`` waits.  ``gen`` pins the batch to one
        generation; None is the live weights."""
        rows = xs.shape[0]
        if not 1 <= rows <= self.max_batch:
            raise ValueError(f"rows {rows} outside [1, {self.max_batch}]")
        bucket = bucket_rows(rows, self.max_batch)
        pinned = gen is not None
        fn, tier = self._callable_for(model, bucket, pinned=pinned)
        args = ()
        served_gen = None
        if pinned:
            w, served_gen = model.weights_for(gen)
            args = (w,)
        t0 = time.monotonic()
        in_pool, out_pool = model.scratch_pools()
        buf = in_pool.acquire(bucket)
        host = buf.numpy()
        host[:rows] = xs
        if rows < bucket:
            host[rows:] = 0.0  # a reused buffer may carry a stale tail
        h = _InFlight(None, rows, bucket, served_gen=served_gen, tier=tier)
        if self.device.type != "cuda":
            t1 = time.monotonic()
            try:
                out = fn(buf, *args)
            finally:
                in_pool.release(buf)  # the CPU forward has read it
            h.out, h.served_gen = out if not pinned else (out, served_gen)
            h.pad_h2d_s = t1 - t0
            h.device_s = time.monotonic() - t1
            return h
        ev = self._event_set()
        # the stream once: record() looks it up again on every call
        stream = torch.cuda.current_stream(self.device)
        pad_s = time.monotonic() - t0
        ev[0].record(stream)
        x = buf.to(self.device, non_blocking=True)
        ev[1].record(stream)
        # from here the copy in may still be reading buf: on a failure
        # the buffer is dropped, never recycled (the host allocator
        # frees a pinned block only after its pending copies)
        out = fn(x, *args)
        if not pinned:
            out, h.served_gen = out
        ev[2].record(stream)
        obuf = out_pool.acquire(bucket)
        obuf.copy_(out.to(torch.float64), non_blocking=True)
        ev[3].record(stream)
        h.out = obuf
        h.pad_h2d_s = pad_s
        h._events = ev
        h._bufs, h._pools = [buf, obuf], [in_pool, out_pool]
        return h

    def collect(self, handle: _InFlight) -> np.ndarray:
        """The dispatched bucket's real rows as float64 host rows.  On a
        CUDA device: wait on the batch's own event (not the device), read
        the phase times from its timing events, then recycle its buffers;
        a failed wait drops them."""
        ev = handle._events
        if ev is None:
            t0 = time.monotonic()
            outs = handle.out.to(dtype=torch.float64).numpy()
            handle.d2h_s = time.monotonic() - t0
            return outs[:handle.rows]
        ev[3].synchronize()
        outs = handle.out.numpy()[:handle.rows].copy()
        h2d_s = ev[0].elapsed_time(ev[1]) / 1e3
        handle.device_s = ev[1].elapsed_time(ev[2]) / 1e3
        handle.d2h_s = ev[2].elapsed_time(ev[3]) / 1e3
        handle.span_s = h2d_s + handle.device_s + handle.d2h_s
        handle.pad_h2d_s += h2d_s
        handle.recycle()
        with self._lock:  # completed: the set can be recorded again
            self._events.append(ev)
        return outs

    def _event_set(self) -> list:
        """Four timing events for one batch, reused once a batch that
        recorded them has been collected (creating and destroying CUDA
        events every batch costs host time on the serving thread)."""
        with self._lock:
            if self._events:
                return self._events.pop()
        return [torch.cuda.Event(enable_timing=True) for _ in range(4)]

    def forward(self, model: ServedModel, xs: np.ndarray) -> np.ndarray:
        return self.collect(self.dispatch(model, xs))

    def cache_stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._cache),
                    "hits": self.metrics.cache_hits,
                    "misses": self.metrics.cache_misses}
