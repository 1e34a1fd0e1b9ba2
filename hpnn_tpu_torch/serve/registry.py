"""Model registry: named kernels, weights cast once to the conf dtype on
the device, and a bounded cache of per-bucket forward entry points tiered
by an explicit per-registry **parity policy**.

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
  Buckets below the threshold keep the strict path.

Requests are padded to power-of-two row buckets, so the cache holds at
most log2(max_batch)+1 entries per model and tier; hits and misses are
counted into ``ServeMetrics``.  Padding reuses per-bucket host buffers.
"""

from __future__ import annotations

import os
import threading

import numpy as np
import torch

from ..api import configure, dtype_of, kernel_kind
from ..models.kernel import MLP
from ..runtime import resolve_device
from ..utils.nn_log import nn_dbg
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
    """Reusable float64 host buffers, one free-list per bucket size: the
    caller writes its real rows, zeroes the tail, and ``release`` returns
    the buffer once the device has consumed it."""

    _KEEP = 3

    def __init__(self, n_inputs: int):
        self.n_inputs = n_inputs
        self._free: dict[int, list[np.ndarray]] = {}
        self._lock = threading.Lock()

    def acquire(self, bucket: int) -> np.ndarray:
        with self._lock:
            free = self._free.get(bucket)
            if free:
                return free.pop()
        return np.zeros((bucket, self.n_inputs), np.float64)

    def release(self, buf: np.ndarray) -> None:
        with self._lock:
            free = self._free.setdefault(buf.shape[0], [])
            if len(free) < self._KEEP:
                free.append(buf)


class _InFlight:
    """One dispatched bucket: the device-side result plus the scratch
    buffer to recycle once the result is collected."""

    __slots__ = ("out", "rows", "bucket", "_buf", "_pool")

    def __init__(self, out, rows: int, bucket: int, buf, pool: _ScratchPool):
        self.out = out
        self.rows = rows
        self.bucket = bucket
        self._buf = buf
        self._pool = pool

    def recycle(self) -> None:
        if self._buf is not None:
            self._pool.release(self._buf)
            self._buf = None


class ServedModel:
    """One registered kernel: its conf, the device-resident weights in
    the conf dtype (cast once, at registration), and its scratch pool."""

    def __init__(self, name: str, nn, registry: "ModelRegistry"):
        self.name = name
        self.nn = nn                      # api.NNDef (conf + kernel)
        self.registry = registry
        # default-mode LNN evaluates through the SNN branch exactly like
        # run_kernel (libhpnn.c:1455-1456)
        self.kind = kernel_kind(nn.conf)
        self.dtype = dtype_of(nn.conf)
        self.dtype_name = nn.conf.dtype
        self.n_inputs = nn.kernel.n_inputs
        self.n_outputs = nn.kernel.n_outputs
        self.topology = tuple(nn.kernel.params)
        self.generation = 1               # no hot reload yet
        self.mlp = MLP.from_kernel(nn.kernel, self.dtype, registry.device,
                                   self.kind)
        self.pool = _ScratchPool(self.n_inputs)

    def infer(self, xs: np.ndarray) -> np.ndarray:
        """Synchronous forward of (rows, n_inputs) float64 rows."""
        return self.registry.forward(self, np.asarray(xs, np.float64))


class ModelRegistry:
    def __init__(self, max_batch: int = 64, parity: str = "strict",
                 fast_threshold: int = 256, device="cuda",
                 metrics: ServeMetrics | None = None):
        if parity not in PARITY_MODES:
            raise ValueError(f"parity must be one of {PARITY_MODES}: "
                             f"{parity!r}")
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1: {max_batch}")
        self.max_batch = int(max_batch)
        self.parity = parity
        self.fast_threshold = int(fast_threshold)
        self.device = resolve_device(device)   # no card: DeviceUnavailable
        self.metrics = metrics or ServeMetrics()
        self._models: dict[str, ServedModel] = {}
        self._cache: dict[tuple, object] = {}
        self._lock = threading.Lock()

    # --- registration ---------------------------------------------------
    def register_conf(self, path: str,
                      name: str | None = None) -> ServedModel | None:
        nn = configure(path)
        if nn is None:
            return None
        if name is None:
            name = nn.conf.name or os.path.splitext(
                os.path.basename(path))[0]
        model = ServedModel(name, nn, self)
        with self._lock:
            self._models[name] = model
        return model

    def get(self, name: str) -> ServedModel | None:
        return self._models.get(name)

    def names(self) -> list[str]:
        return sorted(self._models)

    def buckets(self) -> list[int]:
        """Every bucket a request can land in: powers of two below
        max_batch, then max_batch."""
        out, b = [], 1
        while b < self.max_batch:
            out.append(b)
            b <<= 1
        return out + [self.max_batch]

    # --- the forward path -----------------------------------------------
    def tier_for(self, bucket: int) -> str:
        if self.parity != "fast" or bucket < self.fast_threshold:
            return "strict"
        return "fast"

    def _callable_for(self, model: ServedModel, bucket: int):
        """The forward entry for one (model, topology, dtype, bucket, kind,
        tier) key; creating it is the cache MISS.  The entry takes the
        padded (bucket, n_inputs) float64 host buffer and returns the
        device-side (bucket, n_outputs) result without synchronising."""
        tier = self.tier_for(bucket)
        key = (model.name, model.topology, model.dtype_name, bucket,
               model.kind, tier)
        with self._lock:
            fn = self._cache.get(key)
            if fn is not None:
                self.metrics.count_cache(hit=True)
                return fn
            from .. import ops

            run_batch_fn, path = ops.select_run_batch(
                model.dtype, parity=tier, kind=model.kind,
                device=self.device)

            def fn(buf, _fn=run_batch_fn, _mo=model, _dev=self.device):
                # float64 -> device -> dtype: the cast run_kernel does
                x = torch.from_numpy(buf).to(_dev).to(_mo.dtype)
                return _fn(_mo.mlp.weights, x, _mo.kind)

            self._cache[key] = fn
            self.metrics.count_cache(hit=False)
            nn_dbg(f"serve: cache miss (model={model.name} bucket={bucket} "
                   f"tier={tier} path={path})\n")
            return fn

    def dispatch(self, model: ServedModel, xs: np.ndarray) -> _InFlight:
        """Pad rows into a pooled scratch buffer and launch the cached
        forward without waiting for the result; ``collect`` pays the
        device-to-host copy."""
        rows = xs.shape[0]
        if not 1 <= rows <= self.max_batch:
            raise ValueError(f"rows {rows} outside [1, {self.max_batch}]")
        bucket = bucket_rows(rows, self.max_batch)
        fn = self._callable_for(model, bucket)
        buf = model.pool.acquire(bucket)
        buf[:rows] = xs
        buf[rows:] = 0.0  # a reused buffer may carry a stale tail
        try:
            out = fn(buf)
        except Exception:
            model.pool.release(buf)
            raise
        return _InFlight(out, rows, bucket, buf, model.pool)

    def collect(self, handle: _InFlight) -> np.ndarray:
        """The dispatched bucket's real rows as float64 host rows."""
        try:
            outs = handle.out.to(device="cpu", dtype=torch.float64).numpy()
        finally:
            handle.recycle()
        return outs[:handle.rows]

    def forward(self, model: ServedModel, xs: np.ndarray) -> np.ndarray:
        return self.collect(self.dispatch(model, xs))

    def warmup(self, model: ServedModel) -> None:
        """Run every bucket once, so the first request of each size finds
        its cache entry and the kernel built."""
        for b in self.buckets():
            self.forward(model, np.zeros((b, model.n_inputs), np.float64))
