"""Remote inference backend: the mesh router's side of the worker RPC.

The micro-batcher speaks to ONE interface -- ``dispatch(xs, ...) ->
handle`` / ``collect(handle) -> rows`` -- and never knows whether the
launch is a local device dispatch (``batcher.LocalBackend``, the
in-process registry path every server had before the mesh) or an HTTP
round trip to a worker host (:class:`RemoteBackend` here).  That split
IS the mesh refactor: everything above the backend (queue, lanes, EDF,
deadlines, metrics, tracing) is shared between a single-process server
and the router.

``dispatch`` never blocks on the network: the RPC runs on the worker
pool's executor and ``collect`` joins the future, so the batcher's
pipelined loop keeps up to ``pipeline_depth()`` batches in flight --
one per live worker -- and request fan-out over the fleet happens
without the batcher growing any mesh knowledge.

Failure mapping keeps the client-visible contract of the local path:

* worker 429/504 -> :class:`batcher.QueueFull` / ``DeadlineExceeded``
  (backpressure and deadline outcomes propagate through the router
  verbatim, Retry-After recomputed from the router's own drain rate);
* transport errors (connection refused/reset, timeout: the worker
  died or hung) -> the worker is reported to the pool (immediate
  ejection; health checks readmit) and the batch retries ONCE on a
  different live worker -- inference is idempotent, so a kill -9 under
  load costs a retry, not an error;
* anything else -> :class:`RemoteHTTPError` carrying the worker's
  status + reason for the router's HTTP layer to pass through
  (e.g. a 404 ``unknown_generation`` on a pinned request).

The router's span tree crosses the hop: the request's trace id
rides the RPC as ``X-HPNN-Trace-Id`` and a ``mesh.route`` span (worker
id, bucket, retries) is recorded under the request root -- the worker
records its own parse->queue->device tree under the SAME trace id, so
a merged dump shows route -> worker -> device.
"""

from __future__ import annotations

import json
import time

import numpy as np

from ..batcher import DeadlineExceeded, QueueFull
from ..registry import bucket_rows
from . import transport

# re-exported for the rest of the mesh (router/worker/fleet import it
# from here); the tuple itself lives with the transport layer now
TRANSPORT_ERRORS = transport.TRANSPORT_ERRORS


class RemoteHTTPError(Exception):
    """A worker answered with a non-200 the router should pass through
    (status + machine-readable reason preserved end to end)."""

    def __init__(self, status: int, reason: str, message: str):
        super().__init__(message)
        self.status = int(status)
        self.reason = reason


class NoLiveWorker(Exception):
    """No live worker can take the batch (empty pool, or every
    candidate already failed this dispatch)."""


def _decode_json(raw: bytes) -> dict:
    try:
        decoded = json.loads(raw.decode("utf-8")) if raw else {}
    except (UnicodeDecodeError, json.JSONDecodeError):
        decoded = {}
    return decoded if isinstance(decoded, dict) else {}


def post_json(addr: str, path: str, payload: dict,
              timeout_s: float = 10.0,
              headers: dict | None = None) -> tuple[int, dict, bytes]:
    """One HTTP POST to ``host:port`` through the mesh's keep-alive
    transport (``mesh.transport``: pooled connections, stale-socket
    retry, ``HPNN_FAULT`` chaos); returns (status, decoded body, raw
    bytes).  Transport failures raise (TRANSPORT_ERRORS); any HTTP
    status returns."""
    body = json.dumps(payload).encode("utf-8")
    h = {"Content-Type": "application/json"}
    if headers:
        h.update(headers)
    status, raw, _ = transport.request(addr, "POST", path, body=body,
                                       headers=h, timeout_s=timeout_s)
    return status, _decode_json(raw), raw


def get_json(addr: str, path: str,
             timeout_s: float = 5.0,
             headers: dict | None = None) -> tuple[int, dict]:
    status, raw, _ = transport.request(addr, "GET", path,
                                       headers=headers,
                                       timeout_s=timeout_s)
    return status, _decode_json(raw)


class _RemoteHandle:
    """One batch in flight to a worker.  Duck-typed against the
    registry's ``_InFlight``: the batcher reads bucket/tier/served_gen/
    cache_hit/pad_h2d_s off it for metrics + spans."""

    __slots__ = ("future", "rows", "bucket", "served_gen", "tier",
                 "cache_hit", "pad_h2d_s", "worker_id", "retried",
                 "rpc_trace")

    def __init__(self, future, rows: int, bucket: int,
                 rpc_trace: str | None = None):
        self.future = future
        self.rows = rows
        self.bucket = bucket
        self.served_gen = None   # stamped from the worker's response
        self.tier = "remote"     # refined to remote:<worker> at collect
        self.cache_hit = True    # the router itself compiles nothing
        self.pad_h2d_s = 0.0
        self.worker_id = None
        self.retried = 0
        # the trace id that rode the RPC header (the batch HEAD's): the
        # worker recorded ITS spans under this id, so every member's
        # mesh.route span links to it and the fleet merger can pull the
        # remote half of a coalesced batch into any member's tree
        self.rpc_trace = rpc_trace


class RemoteBackend:
    """Fan one model's batches over the worker pool.  One instance per
    served model on the router; all instances share the pool (and its
    executor + health state)."""

    kind = "remote"

    def __init__(self, pool, model):
        self.pool = pool
        self.model = model
        self.kernel = model.name
        self.max_batch = model.registry.max_batch

    def pipeline_depth(self) -> int:
        """Keep one batch in flight per live worker, clamped to the
        pool's RPC executor width -- depth past the thread count would
        just queue futures, not add concurrency (raise
        HPNN_MESH_RPC_THREADS for fleets past 16 workers).  Floor 1 so
        a momentarily empty pool still lets the loop reach the failure
        path instead of stalling."""
        return max(1, min(self.pool.live_count(),
                          getattr(self.pool, "rpc_threads", 16)))

    # --- the RPC ---------------------------------------------------------
    def dispatch(self, xs: np.ndarray, gen=None, trace=None,
                 deadline: float | None = None, lane: int | None = None):
        rows = int(xs.shape[0])
        bucket = bucket_rows(rows, self.max_batch)
        fut = self.pool.executor.submit(
            self._call, xs, gen, trace, deadline, bucket, lane)
        return _RemoteHandle(fut, rows, bucket,
                             rpc_trace=trace[0] if trace else None)

    def collect(self, handle: _RemoteHandle) -> np.ndarray:
        outs, served_gen, worker_id, retried = handle.future.result()
        handle.served_gen = served_gen
        handle.worker_id = worker_id
        handle.tier = f"remote:{worker_id}"
        handle.retried = retried
        return outs

    def _call(self, xs, gen, trace, deadline, bucket, lane):
        from .qos import LANE_NAMES

        payload = {"inputs": xs.tolist()}
        headers = {}
        token = getattr(self.pool, "router_token", None)
        if token:
            # spill protection: workers started with --require-router
            # only serve infer traffic bearing the router's token, so
            # per-client quotas enforced here cannot be bypassed by
            # hitting a worker directly
            headers["X-HPNN-Router"] = token
        if gen is not None:
            headers["X-HPNN-Generation"] = str(int(gen))
        if trace is not None:
            headers["X-HPNN-Trace-Id"] = trace[0]
        if lane is not None and lane in LANE_NAMES:
            headers["X-HPNN-Priority"] = LANE_NAMES[lane]
        want_gen = getattr(self.model, "generation", None)
        excluded: set = set()
        last_exc: Exception | None = None
        for attempt in (0, 1):  # retry-once-elsewhere on worker loss
            try:
                worker = self.pool.pick(self.kernel, bucket,
                                        exclude=excluded,
                                        want_gen=want_gen)
            except NoLiveWorker:
                if last_exc is not None:
                    raise NoLiveWorker(
                        f"kernel '{self.kernel}': worker failed "
                        f"({last_exc}) and no other live worker can "
                        "retry the batch") from last_exc
                raise
            remaining = (deadline - time.monotonic()
                         if deadline is not None else 30.0)
            if remaining <= 0:
                raise DeadlineExceeded(
                    "deadline expired before the worker RPC")
            payload["timeout_ms"] = remaining * 1e3
            headers["X-HPNN-Deadline-Ms"] = f"{remaining * 1e3:.1f}"
            self.pool.note_dispatch(worker)
            try:
                status, body, _raw = post_json(
                    worker.addr, f"/v1/kernels/{self.kernel}/infer",
                    payload, timeout_s=remaining + 1.0, headers=headers)
            except TRANSPORT_ERRORS as exc:
                # the worker is gone (kill -9, network partition, hang):
                # eject it and try the batch ONCE on another worker --
                # inference is idempotent, so the retry is safe
                from .events import mesh_event

                self.pool.report_failure(worker, exc)
                mesh_event("failover_retry",
                           f"mesh: retrying batch for "
                           f"'{self.kernel}' off {worker.addr} "
                           f"({type(exc).__name__})\n",
                           level="dbg", kernel=self.kernel,
                           worker=worker.addr, bucket=bucket,
                           attempt=attempt,
                           error=type(exc).__name__)
                excluded.add(worker.wid)
                last_exc = exc
                continue
            finally:
                self.pool.note_done(worker)
            self.pool.report_ok(worker)
            # mesh.route spans are recorded by the BATCHER at batch
            # completion, one per traced member (not just the head) --
            # a coalesced batch must leave a route span in EVERY
            # member's tree
            return self._decode(status, body, worker, attempt)
        raise NoLiveWorker(
            f"kernel '{self.kernel}': retry also failed ({last_exc})"
        ) from last_exc

    def _decode(self, status: int, body: dict, worker, retried: int):
        if status == 200:
            outs = np.asarray(body.get("outputs"), dtype=np.float64)
            return outs, body.get("generation"), worker.wid, retried
        reason = body.get("reason", "error")
        msg = (f"worker {worker.wid} ({worker.addr}): "
               f"{body.get('error', f'HTTP {status}')}")
        if status == 429:
            raise QueueFull(msg)
        if status == 504:
            raise DeadlineExceeded(msg)
        raise RemoteHTTPError(status, reason, msg)
