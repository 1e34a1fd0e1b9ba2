"""Bounded FIFO job queue (the port of ``hpnn_tpu/jobs/queue.py``).

A full queue rejects at submit time (the HTTP layer maps
:class:`JobQueueFull` to 429 + Retry-After) instead of accepting work the
device can never keep up with.  The cap counts jobs, not rows, and the
workers drain the queue strictly in submit order.
"""

from __future__ import annotations

import threading
from collections import deque

from .state import JobState


class JobQueueFull(Exception):
    """Admission rejected: the bounded job queue is at capacity."""


class JobQueue:
    def __init__(self, capacity: int = 8):
        self.capacity = max(1, int(capacity))
        self._q: deque[JobState] = deque()
        self._cv = threading.Condition()
        self._closed = False

    def depth(self) -> int:
        with self._cv:
            return len(self._q)

    def submit(self, job: JobState) -> None:
        with self._cv:
            if self._closed:
                raise JobQueueFull("job queue closed (server draining)")
            if len(self._q) >= self.capacity:
                raise JobQueueFull(
                    f"job queue at {len(self._q)}/{self.capacity}")
            self._q.append(job)
            self._cv.notify_all()

    def take(self, timeout_s: float = 0.2) -> JobState | None:
        """Blocking FIFO pop; None on timeout or when closed and empty."""
        with self._cv:
            if not self._q:
                self._cv.wait(timeout=timeout_s)
            if not self._q:
                return None
            return self._q.popleft()

    def requeue_front(self, job: JobState) -> None:
        """Put an admitted job back at the head (a worker took it while
        paused); never counts against capacity: admission already
        happened."""
        with self._cv:
            self._q.appendleft(job)
            self._cv.notify_all()

    def remove(self, job_id: str) -> bool:
        """Pull a still-queued job out (cancel before it ever runs)."""
        with self._cv:
            for job in self._q:
                if job.job_id == job_id:
                    self._q.remove(job)
                    return True
        return False

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
