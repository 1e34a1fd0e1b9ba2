"""Micro-batching: a bounded queue coalescing concurrent requests into one
device launch per batch (the port of ``hpnn_tpu/serve/batcher.py``).

* **bounded queue, immediate reject** -- admission is counted in rows
  against ``max_queue_rows``; a full queue raises :class:`QueueFull` at
  submit time (HTTP 429 with Retry-After), so backpressure is visible to
  clients instead of growing latency without bound.
* **coalescing** -- one worker thread per kernel drains whatever is
  queued, up to ``max_batch`` rows (a request is never split across
  launches), concatenates the rows and runs ONE forward through the
  registry.  ``linger_s`` > 0 waits that long after the first queued
  request so concurrent clients can fill the batch.
* **deadlines** -- each request carries an absolute deadline; expired
  requests are dropped before the device and their submitters raise
  :class:`DeadlineExceeded` (HTTP 504).  An already-expired deadline is
  rejected at admission.
* **QoS lanes + EDF** -- the queue dequeues by ``(lane, deadline, seq)``:
  high before normal before low, earliest deadline first within a lane.
  Equal lanes and equal timeouts keep exact FIFO order.  Expiry reaps
  the whole queue, not only its head, and a batch never mixes pinned
  generations (one launch serves one weights tuple).
* **drain-rate Retry-After** -- an EWMA of completed rows/s; a queue-full
  rejection carries ``retry_after_s`` = backlog / drain rate.
* **pipelined dispatch** -- batches launch through a backend
  (:class:`LocalBackend`: the registry's dispatch/collect split).  The
  worker keeps up to ``backend.pipeline_depth()`` batches in flight (1
  for the local device: the pad and copy in of batch N+1 overlap the
  compute of N) and completes them strictly in dispatch order, so
  pipelining never reorders responses.
* **graceful drain** -- ``close(drain=True)`` stops admission
  (:class:`ServeClosed`), answers everything already admitted, then
  joins the worker.

One batcher (and one worker thread) per served model: batches must be
model-homogeneous.
"""

from __future__ import annotations

import bisect
import threading
import time
from collections import deque

import numpy as np

from ..utils.nn_log import nn_dbg, nn_event, nn_warn
from .metrics import ServeMetrics
from .qos import LANE_NAMES
from .registry import ServedModel


class QueueFull(Exception):
    """Admission rejected: the bounded queue is at capacity."""


class DeadlineExceeded(Exception):
    """The request's deadline passed before a result was produced."""


class ServeClosed(Exception):
    """The batcher is shutting down and no longer admits requests."""


class LocalBackend:
    """The in-process launch path: the registry's ``dispatch`` and
    ``collect``."""

    def __init__(self, model):
        self.model = model

    def pipeline_depth(self) -> int:
        return 1  # one device: depth-1 double buffering

    def dispatch(self, xs: np.ndarray, gen=None, deadline=None,
                 lane=None):
        # unpinned batches keep the two-argument call, so registry
        # stand-ins need not know about generation pinning
        if gen is None:
            return self.model.registry.dispatch(self.model, xs)
        return self.model.registry.dispatch(self.model, xs, gen=gen)

    def collect(self, handle):
        return self.model.registry.collect(handle)


class _Pending:
    __slots__ = ("xs", "rows", "deadline", "gen", "served_gen", "t_enq",
                 "t_dispatch", "event", "result", "error", "bucket",
                 "lane", "seq")

    def __init__(self, xs: np.ndarray, deadline: float,
                 gen: int | None = None, lane: int = 1):
        self.xs = xs
        self.rows = xs.shape[0]
        self.deadline = deadline
        self.gen = gen            # pinned model generation (A/B), or None
        self.served_gen = gen     # generation that actually served it
        self.bucket = 0           # batch bucket served (set at dispatch)
        self.lane = lane          # QoS lane (0=high 1=normal 2=low)
        self.seq = 0              # admission order (EDF tie-break)
        self.t_enq = time.monotonic()
        self.t_dispatch = 0.0
        self.event = threading.Event()
        self.result: np.ndarray | None = None
        self.error: Exception | None = None


class MicroBatcher:
    def __init__(self, model: ServedModel,
                 metrics: ServeMetrics | None = None,
                 max_queue_rows: int = 256,
                 max_batch: int | None = None,
                 linger_s: float = 0.0,
                 backend=None):
        self.model = model
        self.metrics = metrics or model.registry.metrics
        self.max_queue_rows = int(max_queue_rows)
        self.max_batch = int(max_batch or model.registry.max_batch)
        if self.max_batch > model.registry.max_batch:
            raise ValueError("batcher max_batch cannot exceed the "
                             "registry bucket cap")
        self.linger_s = float(linger_s)
        self.backend = backend if backend is not None \
            else LocalBackend(model)
        # EDF queue, kept sorted by (lane, deadline, seq): dequeue order
        # is list order
        self._q: list[_Pending] = []
        self._seq = 0
        self._qrows = 0
        self._lane_rows: dict[int, int] = {0: 0, 1: 0, 2: 0}
        # drain-rate EWMA (rows/s over completed batches): the 429's
        # Retry-After
        self._drain_rate = 0.0
        self._t_last_complete: float | None = None
        self._cv = threading.Condition()
        self._closing = False
        self._paused = False
        self._thread = threading.Thread(
            target=self._loop, name=f"hpnn-batcher-{model.name}",
            daemon=True)
        self._thread.start()

    # --- introspection (metrics gauges + tests) ------------------------
    def depth(self) -> int:
        """Queued ROWS (the unit admission is counted in)."""
        return self._qrows

    def lane_depths(self) -> dict[str, int]:
        """Queued rows per QoS lane (the /metrics per-lane gauge)."""
        with self._cv:
            return {LANE_NAMES[k]: v for k, v in
                    sorted(self._lane_rows.items())}

    def drain_rate(self) -> float:
        """EWMA of completed rows/s (0.0 until the first batch)."""
        with self._cv:
            return self._drain_rate

    def retry_after_s(self) -> float:
        """How long the current backlog takes to drain at the measured
        rate, clamped to [1, 60]; 1 when nothing has completed yet."""
        with self._cv:
            return self._retry_after_locked()

    def _retry_after_locked(self) -> float:
        if self._drain_rate <= 0.0:
            return 1.0
        return min(60.0, max(1.0, self._qrows / self._drain_rate))

    def pause(self) -> None:
        """Hold dispatch (the queue keeps admitting until full): an
        operations and test hook that makes queue order deterministic."""
        with self._cv:
            self._paused = True

    def resume(self) -> None:
        with self._cv:
            self._paused = False
            self._cv.notify_all()

    # --- client side ----------------------------------------------------
    def submit(self, xs: np.ndarray, timeout_s: float,
               gen: int | None = None, return_gen: bool = False,
               lane: int = 1):
        """Enqueue (rows, n_inputs) float64 rows and block until the batch
        holding them completes.  Raises QueueFull / DeadlineExceeded /
        ServeClosed; a model exception propagates.  ``gen`` pins the
        request to one generation; ``lane`` is its QoS lane (0 high,
        1 normal, 2 low).  ``return_gen`` returns ``(rows, served_gen)``."""
        rows = xs.shape[0]
        if not 1 <= rows <= self.max_batch:
            raise ValueError(
                f"request rows {rows} outside [1, {self.max_batch}]")
        if timeout_s <= 0.0:
            raise DeadlineExceeded(
                f"deadline already expired at admission "
                f"({timeout_s * 1e3:.1f} ms remaining)")
        p = _Pending(xs, time.monotonic() + timeout_s, gen=gen,
                     lane=int(lane))
        with self._cv:
            if self._closing:
                raise ServeClosed(f"kernel '{self.model.name}' draining")
            if self._qrows + rows > self.max_queue_rows:
                exc = QueueFull(
                    f"queue at {self._qrows}/{self.max_queue_rows} rows")
                exc.retry_after_s = self._retry_after_locked()
                raise exc
            p.seq = self._seq = self._seq + 1
            bisect.insort(self._q, p,
                          key=lambda q: (q.lane, q.deadline, q.seq))
            self._qrows += rows
            self._lane_rows[p.lane] = \
                self._lane_rows.get(p.lane, 0) + rows
            self._cv.notify_all()
        # the grace covers the batch in flight ahead of us: the worker
        # answers or expires this request at its next dispatch
        if not p.event.wait(timeout=timeout_s + 1.0):
            raise DeadlineExceeded(f"no result within {timeout_s:.3f}s")
        if p.error is not None:
            raise p.error
        lat = time.monotonic() - p.t_enq
        self.metrics.latency.observe(lat)
        if p.bucket:
            # slow-request flag: against this kernel+bucket's p99 before
            # this observation joins it
            h = self.metrics.bucket_latency(self.model.name, p.bucket)
            thr = self.metrics.slow_threshold_s(h)
            h.observe(lat)
            if thr is not None and lat > thr:
                nn_event("slow_request", kernel=self.model.name,
                         bucket=p.bucket, latency_ms=round(lat * 1e3, 3),
                         threshold_ms=round(thr * 1e3, 3),
                         generation=p.served_gen, trace="")
        return (p.result, p.served_gen) if return_gen else p.result

    # --- worker ---------------------------------------------------------
    def _reap_expired_locked(self) -> None:
        """Fail and remove every queued request whose deadline passed --
        the whole queue, not just its head: under sustained higher-lane
        load a low-lane entry may never reach the head, and its rows
        would count against max_queue_rows forever.  Caller holds the
        lock."""
        now = time.monotonic()
        if not any(now > p.deadline for p in self._q):
            return
        keep: list[_Pending] = []
        for p in self._q:
            if now > p.deadline:
                self._qrows -= p.rows
                self._lane_rows[p.lane] = \
                    max(0, self._lane_rows.get(p.lane, 0) - p.rows)
                p.error = DeadlineExceeded(
                    f"expired {now - p.deadline:.3f}s before dispatch")
                p.event.set()
            else:
                keep.append(p)
        self._q = keep

    def _pop_locked(self) -> list[_Pending]:
        """Pop up to max_batch rows in EDF order, never splitting a
        request and never mixing pinned generations in one batch (a
        generation change ends the batch; the next pop takes the rest in
        order).  Caller holds the lock."""
        self._reap_expired_locked()
        batch, rows = [], 0
        while self._q and rows + self._q[0].rows <= self.max_batch:
            if batch and self._q[0].gen != batch[0].gen:
                break
            p = self._q.pop(0)
            rows += p.rows
            batch.append(p)
            self._lane_rows[p.lane] = \
                max(0, self._lane_rows.get(p.lane, 0) - p.rows)
        self._qrows -= rows
        return batch

    def _take_batch(self) -> list[_Pending] | None:
        """Blocking pop of up to max_batch rows of requests; None when
        closing with an empty queue."""
        with self._cv:
            while True:
                if self._q and not self._paused:
                    break
                if self._closing and not self._q:
                    return None
                self._cv.wait(timeout=0.05)
            if self.linger_s > 0.0 and not self._closing:
                # give concurrent clients linger_s from the first queued
                # request to fill the bucket
                head = self._q[0]
                while (self._qrows < self.max_batch
                       and not self._closing and not self._paused):
                    remain = head.t_enq + self.linger_s - time.monotonic()
                    if remain <= 0:
                        break
                    self._cv.wait(timeout=remain)
            return self._pop_locked()

    def _take_batch_nowait(self) -> list[_Pending]:
        """Non-blocking pop for the pipelined path (a batch is already in
        flight): whatever is queued now, possibly nothing.  While the
        device is busy, an unfilled linger window defers to the next
        blocking take instead of spinning."""
        with self._cv:
            if not self._q or self._paused:
                return []
            if (self.linger_s > 0.0 and not self._closing
                    and self._qrows < self.max_batch
                    and time.monotonic() <
                    self._q[0].t_enq + self.linger_s):
                return []
            return self._pop_locked()

    def _dispatch(self, batch: list[_Pending]):
        """Expire stale requests, pad and launch the rest asynchronously.
        Returns (live, handle, t0, t_asm1, t_launched), or None when
        nothing was dispatched.  Runs off the queue lock."""
        now = time.monotonic()
        live: list[_Pending] = []
        for p in batch:
            if now > p.deadline:
                p.error = DeadlineExceeded(
                    f"expired {now - p.deadline:.3f}s before dispatch")
                p.event.set()
            else:
                p.t_dispatch = now
                live.append(p)
        if not live:
            return None
        xs = (live[0].xs if len(live) == 1
              else np.concatenate([p.xs for p in live]))
        t_asm1 = time.monotonic()  # expiry + concatenation: assembly
        try:
            # the batch's most generous deadline rides along: a
            # near-expired member must not fail the whole batch
            handle = self.backend.dispatch(
                xs, gen=live[0].gen,
                deadline=max(p.deadline for p in live),
                lane=live[0].lane)
        except Exception as exc:  # fail this batch, keep serving
            nn_warn(f"serve: batch dispatch failed for "
                    f"'{self.model.name}': {exc}\n")
            for p in live:
                p.error = exc
                p.event.set()
            return None
        # the generation the launch read, not whatever is current when
        # the batch completes: a swap landing mid-batch must not
        # mislabel these requests.  The registry's handle names it (read
        # with the weights in one store); a stand-in's falls back to the
        # pin or the model's current generation
        g = getattr(handle, "served_gen", None)
        if g is None:
            g = (getattr(self.model, "generation", 0)
                 if live[0].gen is None else live[0].gen)
        bucket = getattr(handle, "bucket", 0)
        for p in live:
            p.served_gen = g
            p.bucket = bucket
        return live, handle, now, t_asm1, time.monotonic()

    def _complete(self, inflight) -> None:
        """Wait for one in-flight batch and deliver its slices.  This
        runs after the next batch was dispatched: that ordering is the
        pipeline.  The batch's phases feed the histograms once a batch:
        a handle that measured its own (the registry's, on the card from
        timing events) reports them; otherwise host walls."""
        live, handle, t0, t_asm1, t_launched = inflight
        t_c0 = time.monotonic()
        try:
            outs = self.backend.collect(handle)
        except Exception as exc:  # device or model failure at collect
            nn_warn(f"serve: batch failed for "
                    f"'{self.model.name}': {exc}\n")
            for p in live:
                p.error = exc
                p.event.set()
            return
        t_c1 = time.monotonic()
        rows = sum(p.rows for p in live)
        with self._cv:  # drain-rate EWMA
            # under saturation the gap between completions is the honest
            # rate; after an idle period the gap would include the idle
            # wall, so a gap far above the batch's own service time reads
            # the service time instead
            svc = max(t_c1 - t0, 1e-6)
            if self._t_last_complete is not None:
                gap = t_c1 - self._t_last_complete
                dt = svc if gap > 4.0 * svc else max(gap, 1e-6)
                inst = rows / dt
                self._drain_rate = (
                    inst if self._drain_rate <= 0.0
                    else 0.7 * self._drain_rate + 0.3 * inst)
            self._t_last_complete = t_c1
        # batch counters fire on completion: a batch that fails at
        # collect must not count into rows_total or the fill ratio
        self.metrics.count_batch(rows, handle.bucket)
        span = getattr(handle, "span_s", None)
        self.metrics.count_device(rows, handle.bucket,
                                  t_c1 - t0 if span is None else span)
        self.metrics.observe_phase("batch_assembly", t_asm1 - t0)
        self.metrics.observe_phase("pad_h2d",
                                   getattr(handle, "pad_h2d_s", 0.0))
        if hasattr(handle, "device_s"):
            self.metrics.observe_phase("device", handle.device_s)
            self.metrics.observe_phase("d2h", handle.d2h_s)
        else:
            self.metrics.observe_phase("device", t_c0 - t_launched)
            self.metrics.observe_phase("d2h", t_c1 - t_c0)
        off = 0
        for p in live:
            p.result = outs[off:off + p.rows]
            off += p.rows
            # queue_latency doubles as the queue_wait phase
            self.metrics.queue_latency.observe(p.t_dispatch - p.t_enq)
            p.event.set()

    def _loop(self) -> None:
        """Pipelined worker: dispatch the next batch before collecting
        the oldest in-flight one, keeping up to
        ``backend.pipeline_depth()`` batches in flight.  Ordered pops and
        completion in dispatch order mean responses are never
        reordered."""
        inflight: deque = deque()
        while True:
            if not inflight:
                batch = self._take_batch()
                if batch is None:
                    return  # closing, queue drained, nothing in flight
            else:
                batch = self._take_batch_nowait()
            nxt = self._dispatch(batch) if batch else None
            if nxt is not None:
                inflight.append(nxt)
            depth = max(1, int(self.backend.pipeline_depth()))
            if inflight and (nxt is None or len(inflight) > depth):
                self._complete(inflight.popleft())

    # --- lifecycle ------------------------------------------------------
    def close(self, drain: bool = True, timeout_s: float = 30.0) -> None:
        """Stop admission; with ``drain`` answer everything admitted,
        otherwise fail it with ServeClosed.  Joins the worker."""
        with self._cv:
            self._closing = True
            self._paused = False
            if not drain:
                while self._q:
                    p = self._q.pop()
                    p.error = ServeClosed("server shutting down")
                    p.event.set()
                self._qrows = 0
                self._lane_rows = {0: 0, 1: 0, 2: 0}
            self._cv.notify_all()
        self._thread.join(timeout=timeout_s)
        if self._thread.is_alive():  # pragma: no cover - watchdog only
            nn_warn(f"serve: batcher '{self.model.name}' did not drain "
                    f"within {timeout_s}s\n")
        else:
            nn_dbg(f"serve: batcher '{self.model.name}' drained\n")
