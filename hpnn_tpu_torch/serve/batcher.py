"""Micro-batching: a bounded queue coalescing concurrent requests into one
device launch per batch.

* **bounded queue, immediate reject** -- admission is counted in rows
  against ``max_queue_rows``; a full queue raises :class:`QueueFull` at
  submit time (HTTP 429), so backpressure is visible to clients instead
  of growing latency without bound.
* **coalescing** -- one worker thread per kernel drains whatever is
  queued, in arrival order, up to ``max_batch`` rows (a request is never
  split across launches), concatenates the rows and runs ONE forward
  through the registry.  ``linger_s`` > 0 waits that long after the first
  queued request so concurrent clients can fill the batch.
* **deadlines** -- each request carries an absolute deadline; expired
  requests are dropped before the device and their submitters raise
  :class:`DeadlineExceeded` (HTTP 504).
* **graceful drain** -- ``close(drain=True)`` stops admission
  (:class:`ServeClosed`), answers everything already admitted, then joins
  the worker.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from ..utils.nn_log import nn_warn
from .metrics import ServeMetrics
from .registry import ServedModel


class QueueFull(Exception):
    """Admission rejected: the bounded queue is at capacity."""


class DeadlineExceeded(Exception):
    """The request's deadline passed before a result was produced."""


class ServeClosed(Exception):
    """The batcher is shutting down and no longer admits requests."""


class _Pending:
    __slots__ = ("xs", "rows", "deadline", "t_enq", "event", "result",
                 "error")

    def __init__(self, xs: np.ndarray, deadline: float):
        self.xs = xs
        self.rows = xs.shape[0]
        self.deadline = deadline
        self.t_enq = time.monotonic()
        self.event = threading.Event()
        self.result: np.ndarray | None = None
        self.error: Exception | None = None


class MicroBatcher:
    def __init__(self, model: ServedModel,
                 metrics: ServeMetrics | None = None,
                 max_queue_rows: int = 256,
                 max_batch: int | None = None,
                 linger_s: float = 0.0):
        self.model = model
        self.metrics = metrics or model.registry.metrics
        self.max_queue_rows = int(max_queue_rows)
        self.max_batch = int(max_batch or model.registry.max_batch)
        if self.max_batch > model.registry.max_batch:
            raise ValueError("batcher max_batch cannot exceed the "
                             "registry bucket cap")
        self.linger_s = float(linger_s)
        self._q: list[_Pending] = []
        self._qrows = 0
        self._cv = threading.Condition()
        self._closing = False
        self._paused = False
        self._thread = threading.Thread(
            target=self._loop, name=f"hpnn-batcher-{model.name}",
            daemon=True)
        self._thread.start()

    def depth(self) -> int:
        """Queued ROWS (the unit admission is counted in)."""
        return self._qrows

    def pause(self) -> None:
        """Hold dispatch (the queue keeps admitting until full): an
        operations and test hook that makes queue-full deterministic."""
        with self._cv:
            self._paused = True

    def resume(self) -> None:
        with self._cv:
            self._paused = False
            self._cv.notify_all()

    # --- client side ----------------------------------------------------
    def submit(self, xs: np.ndarray, timeout_s: float) -> np.ndarray:
        """Enqueue (rows, n_inputs) float64 rows and block until the batch
        holding them completes.  Raises QueueFull / DeadlineExceeded /
        ServeClosed; a model exception propagates."""
        rows = xs.shape[0]
        if not 1 <= rows <= self.max_batch:
            raise ValueError(
                f"request rows {rows} outside [1, {self.max_batch}]")
        if timeout_s <= 0.0:
            raise DeadlineExceeded("deadline already expired at admission")
        p = _Pending(xs, time.monotonic() + timeout_s)
        with self._cv:
            if self._closing:
                raise ServeClosed(f"kernel '{self.model.name}' draining")
            if self._qrows + rows > self.max_queue_rows:
                raise QueueFull(
                    f"queue at {self._qrows}/{self.max_queue_rows} rows")
            self._q.append(p)
            self._qrows += rows
            self._cv.notify_all()
        # the grace covers the batch in flight ahead of us: the worker
        # answers or expires this request at its next dispatch
        if not p.event.wait(timeout=timeout_s + 1.0):
            raise DeadlineExceeded(f"no result within {timeout_s:.3f}s")
        if p.error is not None:
            raise p.error
        self.metrics.observe_latency(time.monotonic() - p.t_enq)
        return p.result

    # --- worker ---------------------------------------------------------
    def _take_batch(self) -> list[_Pending] | None:
        """Blocking pop of up to max_batch rows of whole requests, in
        arrival order; None when closing with an empty queue."""
        with self._cv:
            while not self._q or self._paused:
                if self._closing and not self._q:
                    return None
                self._cv.wait(timeout=0.05)
            if self.linger_s > 0.0 and not self._closing:
                head = self._q[0]
                while self._qrows < self.max_batch and not self._closing:
                    remain = head.t_enq + self.linger_s - time.monotonic()
                    if remain <= 0:
                        break
                    self._cv.wait(timeout=remain)
            batch, rows = [], 0
            while self._q and rows + self._q[0].rows <= self.max_batch:
                p = self._q.pop(0)
                rows += p.rows
                batch.append(p)
            self._qrows -= rows
            return batch

    def _run(self, batch: list[_Pending]) -> None:
        now = time.monotonic()
        live = []
        for p in batch:
            if now > p.deadline:
                p.error = DeadlineExceeded(
                    f"expired {now - p.deadline:.3f}s before dispatch")
                p.event.set()
            else:
                live.append(p)
        if not live:
            return
        xs = (live[0].xs if len(live) == 1
              else np.concatenate([p.xs for p in live]))
        reg = self.model.registry
        try:
            handle = reg.dispatch(self.model, xs)
            outs = reg.collect(handle)
        except Exception as exc:  # fail this batch, keep serving
            nn_warn(f"serve: batch failed for '{self.model.name}': "
                    f"{exc}\n")
            for p in live:
                p.error = exc
                p.event.set()
            return
        self.metrics.count_batch(rows=handle.rows, bucket=handle.bucket)
        at = 0
        for p in live:
            p.result = outs[at:at + p.rows]
            at += p.rows
            p.event.set()

    def _loop(self) -> None:
        while True:
            batch = self._take_batch()
            if batch is None:
                return
            self._run(batch)

    def close(self, drain: bool = True, timeout_s: float = 30.0) -> None:
        """Stop admission; with ``drain`` answer everything admitted,
        otherwise fail it with ServeClosed.  Joins the worker."""
        with self._cv:
            self._closing = True
            self._paused = False
            if not drain:
                for p in self._q:
                    p.error = ServeClosed("server shutting down")
                    p.event.set()
                self._q.clear()
                self._qrows = 0
            self._cv.notify_all()
        self._thread.join(timeout=timeout_s)
